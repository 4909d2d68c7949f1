"""Hierarchical Bayesian logistic regression.

Same probabilistic model as the reference example
(examples/logistic_regression/main.py:23-49): Gamma(1, 0.01) prior on the
precision alpha = exp(log_alpha), N(0, alpha^-1/2) prior on the weights,
sigmoid cross-entropy likelihood rescaled by n_train/n_batch for
minibatching. As in the reference, the Gamma prior is evaluated at
alpha = exp(log_alpha) with no Jacobian correction for the log
reparameterisation — we reproduce that choice exactly.
"""

import dataclasses

import jax.numpy as jnp

from .distributions import (
    normal_log_prob,
    gamma_log_prob,
    resolve_precision,
)


def sigmoid_cross_entropy_with_logits(labels, logits):
    """Matches tf.nn.sigmoid_cross_entropy_with_logits:
    max(x, 0) - x*z + log(1 + exp(-|x|))."""
    return (
        jnp.maximum(logits, 0.0)
        - logits * labels
        + jnp.log1p(jnp.exp(-jnp.abs(logits)))
    )


@dataclasses.dataclass(frozen=True)
class LogisticRegressionModel:
    n_feats: int
    n_train: int
    n_batch: int
    # Data-matmul precision by name (see distributions.resolve_precision).
    precision: str = "high"

    @property
    def _prec(self):
        return resolve_precision(self.precision)

    def template(self, dtype=jnp.float32):
        return {
            "w": jnp.zeros((self.n_feats, 1), dtype),
            "log_alpha": jnp.zeros((), dtype),
        }

    def logits(self, params, batch):
        return jnp.matmul(batch["X"], params["w"], precision=self._prec)

    def log_p(self, params, batch):
        w = params["w"]
        alpha = jnp.exp(params["log_alpha"])
        logits = jnp.matmul(batch["X"], w, precision=self._prec)
        log_l = -jnp.sum(
            sigmoid_cross_entropy_with_logits(batch["y"], logits)
        )
        w_prior = jnp.sum(
            normal_log_prob(w, 0.0, 1.0 / jnp.sqrt(alpha))
        )
        alpha_prior = gamma_log_prob(alpha, 1.0, 0.01)
        scale = self.n_train / self.n_batch
        return log_l * scale + w_prior + alpha_prior
