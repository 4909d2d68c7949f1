"""Log-density helpers matching tf.contrib.distributions semantics.

The reference builds priors/likelihoods from TF 1.12's Normal and Gamma
distributions (examples/*/main.py). These are the closed-form log-probs those
classes computed, as pure jnp functions.
"""

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln


def resolve_precision(name):
    """Model data-matmul precision by name. On an H100, "high" and
    "default" both run f32 products in TF32 (10-bit mantissa inputs,
    f32 accumulation); "highest" runs them in full f32 outside the
    tensor cores. On the CPU all three are full f32. "high" is the
    default; take "highest" for a reference."""
    return {
        "high": jax.lax.Precision.HIGH,
        "default": jax.lax.Precision.DEFAULT,
        "highest": jax.lax.Precision.HIGHEST,
    }[name]


def normal_log_prob(x, loc, scale):
    """log N(x; loc, scale). Matches tf.distributions.Normal.log_prob."""
    z = (x - loc) / scale
    return -0.5 * z * z - jnp.log(scale) - 0.5 * jnp.log(2.0 * jnp.pi)


def gamma_log_prob(x, concentration, rate):
    """log Gamma(x; concentration alpha, rate beta).

    Matches tf.distributions.Gamma.log_prob:
    alpha*log(beta) - lgamma(alpha) + (alpha-1)*log(x) - beta*x.
    """
    concentration = jnp.asarray(concentration, x.dtype)
    rate = jnp.asarray(rate, x.dtype)
    return (
        concentration * jnp.log(rate)
        - gammaln(concentration)
        + (concentration - 1.0) * jnp.log(x)
        - rate * x
    )
