"""Pluggable kernel layer — the JAX analogue of the reference's
AbstractKernel / SquaredExponentialKernel hierarchy
(stein/kernels/abstract_kernel.py:17-62, squared_exponential_kernel.py:18-35).

A kernel supplies, from the squared-distance matrix D and the
median-heuristic bandwidth^2:

- ``K``: the kernel matrix (the SVGD attractive weights), and
- ``W``: the repulsive weight matrix such that the repulsive term is
  ``dK_i = sum_j W_ij (theta_i - theta_j) = (rowsum(W) * theta_i - (W @
  theta)_i)``.

For the RBF kernel W = K / h^2 (so the fused single-matmul paths in
ops/rbf.py and ops/pallas_svgd.py apply); for other kernels the generic
two-matrix path below is used. Both reproduce the reference's
``kernel_and_grad`` contract: ``(K, dK)`` with dK equal to
``-0.5 * tf.gradients(K, theta)`` semantics (the closed form; see
baselines/numpy_svgd.py for the derivation).
"""

import dataclasses

import jax
import jax.numpy as jnp

from ..ops import rbf
from ..ops.median import exact_median


@dataclasses.dataclass(frozen=True)
class SquaredExponentialKernel:
    """RBF kernel K = exp(-D / h^2 / 2)
    (squared_exponential_kernel.py:22)."""

    def weights(self, D, h2):
        K = jnp.exp(-D / h2 / 2.0)
        return K, K / h2

    def kernel_and_grad(self, theta, median_fn=exact_median):
        """Reference-compatible surface: (K, dK) for an [n, p] particle
        matrix (squared_exponential_kernel.py:25-35)."""
        K, dK, _ = rbf.rbf_kernel_and_repulse(theta, median_fn=median_fn)
        return K, dK


@dataclasses.dataclass(frozen=True)
class InverseMultiquadricKernel:
    """IMQ kernel k(x, y) = (c^2 + ||x-y||^2 / h^2)^beta with beta < 0 —
    the standard heavy-tailed Stein kernel (Gorham & Mackey's choice for
    KSD); its slowly-decaying repulsion keeps distant particles coupled.

    W_ij = -(2 beta / h^2) (c^2 + D_ij/h^2)^(beta-1) >= 0 for beta < 0.
    """

    c: float = 1.0
    beta: float = -0.5

    def __post_init__(self):
        # Loud construction-time guards (r3 review): beta >= 0 flips
        # W's sign — repulsion becomes attraction and the sampler would
        # silently sample the wrong posterior geometry (the same
        # failure class the exact-type RBF dispatch in api.py prevents);
        # c == 0 puts base 0^beta = inf on the diagonal (D_ii = 0) and
        # every downstream quantity goes NaN with no explanation.
        if not self.beta < 0.0:
            raise ValueError(
                f"InverseMultiquadricKernel needs beta < 0 (got "
                f"{self.beta}): beta >= 0 makes the repulsive weights "
                "W <= 0 — that is a multiquadric, not an IMQ Stein "
                "kernel"
            )
        if self.c == 0.0:
            raise ValueError(
                "InverseMultiquadricKernel needs c != 0: c = 0 makes "
                "k(x, x) = 0^beta = inf on the diagonal"
            )

    def weights(self, D, h2):
        base = self.c ** 2 + D / h2
        K = base ** self.beta
        W = (-2.0 * self.beta / h2) * base ** (self.beta - 1.0)
        return K, W

    def kernel_and_grad(self, theta, median_fn=exact_median):
        n = theta.shape[0]
        D = rbf.pairwise_sq_dists(theta)
        h2 = rbf.bandwidth_sq_from_median(median_fn(D), n)
        K, W = self.weights(D, h2)
        wsum = jnp.sum(W, axis=1, keepdims=True)
        dK = wsum * theta - jnp.matmul(
            W, theta, precision=jax.lax.Precision.HIGH
        )
        return K, dK


def generic_svgd_phi(kernel, theta, grads, median_fn=exact_median):
    """SVGD direction phi = (K @ grads + dK) / n for any weights-kernel.

    Generalises ops/rbf.svgd_phi, as two [n,n]x[n,p] contractions
    (K@grads and W@theta). Unlike the RBF fast path — whose single
    [n,n]x[n,2p] contraction shares ONE lhs K across both rhs
    (rbf.py) — a generic kernel has two DIFFERENT lhs matrices, so the
    only single-contraction form is [K|-W] @ [grads;theta], which costs
    an extra [n,2n] concat buffer in HBM for zero FLOP savings; two
    matmuls are the right call here. The RBF fused path remains the
    fast default in the sampler.
    """
    n, p = theta.shape
    D = rbf.pairwise_sq_dists(theta)
    med = median_fn(D)
    h2 = rbf.bandwidth_sq_from_median(med, n)
    K, W = kernel.weights(D, h2)
    attract = jnp.matmul(K, grads, preferred_element_type=theta.dtype,
                         precision=jax.lax.Precision.HIGH)
    wsum = jnp.sum(W, axis=1, keepdims=True)
    repulse = wsum * theta - jnp.matmul(
        W, theta, preferred_element_type=theta.dtype,
        precision=jax.lax.Precision.HIGH,
    )
    phi = (attract + repulse) / n
    return phi, {"h2": h2, "median": med}
