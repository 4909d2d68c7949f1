"""RBF (squared-exponential) kernel and the fused SVGD direction.

Redesign of the reference's kernel layer
(stein/kernels/abstract_kernel.py, squared_exponential_kernel.py): instead of
per-particle placeholders + autodiff of the kernel matrix, everything is one
closed-form XLA program — a single [n,n] x [n, 2p] matmul computes both the
attractive term K@grads and the K@theta piece of the repulsive term.

Precision: the Gram behind D runs at Precision.HIGHEST (full f32); the
K contractions run at the ambient default precision, which is TF32 on an
H100 (full f32 under ``jax.default_matmul_precision("highest")`` and on
the CPU).

Semantics reproduced exactly (see baselines/numpy_svgd.py for derivations):

- D = r + r^T - 2 T T^T            (abstract_kernel.py:33-35)
- h^2 = median(D) / log(n)         (abstract_kernel.py:38-40) — median over
  all n^2 entries incl. the zero diagonal (compute_median.py:4-16); the
  bandwidth is treated as a constant (stop_gradient analogue: it is computed
  outside any autodiff here).
- K = exp(-D / h^2 / 2)            (squared_exponential_kernel.py:22)
- repulsive dK_i = (sum_j K_ij * theta_i - (K@theta)_i) / h^2, the closed form
  of the reference's -0.5 * tf.gradients(K, theta)
  (squared_exponential_kernel.py:29-35).
- phi = (K @ grads + dK) / n       (abstract_stein_sampler.py:105)
"""

import jax
import jax.numpy as jnp

from .median import exact_median


def pairwise_sq_dists(theta):
    """D = r + r^T - 2 T T^T, the reference's exact algebraic form.

    The Gram matmul runs at Precision.HIGHEST: the default GPU precision
    (TF32) keeps ~3 decimal digits of each input, and D is a
    catastrophic-cancellation-prone quantity — r_i + r_j - 2<t_i, t_j>
    approaches 0 relative to its terms exactly where SVGD operates late in
    convergence (small inter-particle distances), so TF32 Gram entries
    would wipe out D's significant digits."""
    r = jnp.sum(theta * theta, axis=1, keepdims=True)
    return r + r.T - 2.0 * jnp.matmul(
        theta, theta.T, preferred_element_type=theta.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )


def bandwidth_sq_from_median(med, n_particles):
    """h^2 = median / log(n)  (abstract_kernel.py:40, squared)."""
    return med / jnp.log(jnp.asarray(n_particles, med.dtype))


def rbf_kernel_and_repulse(theta, median_fn=exact_median):
    """Return (K, dK, h2) exactly as the oracle's rbf_kernel_and_repulse."""
    n = theta.shape[0]
    D = pairwise_sq_dists(theta)
    h2 = bandwidth_sq_from_median(median_fn(D), n)
    K = jnp.exp(-D / h2 / 2.0)
    ksum = jnp.sum(K, axis=1, keepdims=True)
    dK = (ksum * theta - jnp.matmul(K, theta)) / h2
    return K, dK, h2


def svgd_phi(theta, grads, median_fn=exact_median):
    """Fused SVGD direction phi = (K @ grads + dK) / n.

    The attractive matmul K@grads and the repulsive K@theta are computed as a
    single [n,n] x [n, 2p] contraction so XLA reads K once.

    Returns (phi, aux) with aux = {"h2": bandwidth^2, "median": median(D)}.
    """
    n, p = theta.shape
    D = pairwise_sq_dists(theta)
    med = median_fn(D)
    h2 = bandwidth_sq_from_median(med, n)
    K = jnp.exp(-D / h2 / 2.0)
    ksum = jnp.sum(K, axis=1, keepdims=True)
    # Default precision for the contraction (TF32 on an H100): K is
    # positive and nothing cancels, so it does not need the HIGHEST that
    # the cancellation-prone Gram requires.
    both = jnp.matmul(
        K, jnp.concatenate([grads, theta], axis=1),
        preferred_element_type=theta.dtype,
    )
    attract = both[:, :p]
    ktheta = both[:, p:]
    phi = (attract + (ksum * theta - ktheta) / h2) / n
    return phi, {"h2": h2, "median": med}
