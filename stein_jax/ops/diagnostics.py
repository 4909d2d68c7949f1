"""Convergence diagnostics: kernel Stein discrepancy (KSD).

The reference offers no convergence measure beyond eyeballing posterior
predictions (SURVEY.md §5). KSD is the natural one for SVGD: it measures
how far the particle ensemble is from stationarity of the target using
exactly the quantities the sampler already computes (particles, scores,
kernel). For the RBF kernel k = exp(-||x-y||^2 / (2 h^2)):

    u(x_i, x_j) = k_ij [ s_i . s_j
                         + (s_i - s_j) . (x_i - x_j) / h^2
                         + p / h^2 - D_ij / h^4 ]

with s_i = grad log p(x_i), and KSD^2 = mean_ij u_ij (V-statistic) or the
off-diagonal mean (U-statistic). Everything is a handful of [n, n] / [n, p]
contractions.
"""

import jax
import jax.numpy as jnp

from . import rbf
from .median import bisect_median

# Above this particle count ksd_rbf streams row blocks instead of
# materialising the [n, n] matrices: the dense form holds SIX n^2
# HIGHEST-precision arrays (~1.2 GB of HBM traffic at n=10240 for a
# diagnostic), while the blocked form's peak footprint is
# O(block_rows x n).
KSD_DENSE_MAX_N = 4096


def _ksd_row_block_sum(theta_rows, grads_rows, d_rows, theta, grads, d,
                       rsq_rows, rsq, h2, p):
    """Sum of U over one [b, n] row block of the KSD kernel matrix —
    the dense form's arithmetic restricted to a row block (same HIGHEST
    matmul precision; the cross term cancels like D does)."""
    _hi = jax.lax.Precision.HIGHEST
    D = (rsq_rows[:, None] + rsq[None, :]
         - 2.0 * jnp.matmul(theta_rows, theta.T, precision=_hi))
    K = jnp.exp(-D / h2 / 2.0)
    SS = jnp.matmul(grads_rows, grads.T, precision=_hi)
    ST = jnp.matmul(grads_rows, theta.T, precision=_hi)   # s_i . x_j
    TS = jnp.matmul(theta_rows, grads.T, precision=_hi)   # s_j . x_i
    cross = d_rows[:, None] + d[None, :] - ST - TS
    U = K * (SS + cross / h2 + p / h2 - D / (h2 * h2))
    return jnp.sum(U)


def ksd_rbf(theta, grads, h2=None, u_statistic=False, block_rows=512):
    """KSD^2 of the particle set w.r.t. the target whose scores are
    ``grads`` ([n, p] = grad log p per particle), under the RBF kernel
    with bandwidth^2 ``h2`` (sort-free bisect median heuristic if None —
    the exact median's n^2 sort would cost more than an SVGD step).

    Up to KSD_DENSE_MAX_N particles the [n, n] terms are materialised
    directly; beyond it the sum streams over ``block_rows``-row blocks
    (lax.scan) so peak memory is O(block_rows x n) — the same total at a
    different matmul partitioning (tested equal at small n).

    Returns a scalar; >= 0 up to fp error for the V-statistic.
    """
    n, p = theta.shape
    if h2 is None:
        h2 = rbf.bandwidth_sq_from_median(bisect_median(theta), n)

    # HIGHEST: the cross term cancels like D does (d_i + d_j - ST - ST^T);
    # TF32 contractions (the GPU default) would swamp small KSD values.
    _hi = jax.lax.Precision.HIGHEST

    if n <= KSD_DENSE_MAX_N:
        D = rbf.pairwise_sq_dists(theta)
        K = jnp.exp(-D / h2 / 2.0)
        SS = jnp.matmul(grads, grads.T, precision=_hi)   # s_i . s_j
        ST = jnp.matmul(grads, theta.T, precision=_hi)   # s_i . x_j
        d = jnp.sum(grads * theta, axis=1)         # s_i . x_i
        # (s_i - s_j).(x_i - x_j) = d_i + d_j - ST_ij - ST_ji
        cross = d[:, None] + d[None, :] - ST - ST.T
        U = K * (SS + cross / h2 + p / h2 - D / (h2 * h2))
        if u_statistic:
            total = jnp.sum(U) - jnp.sum(jnp.diagonal(U))
            return total / (n * (n - 1))
        return jnp.mean(U)

    # Streaming form. The diagonal is closed-form (D_ii = 0, K_ii = 1):
    # U_ii = |s_i|^2 + p / h2.
    d = jnp.sum(grads * theta, axis=1)
    rsq = jnp.sum(theta * theta, axis=1)
    b = min(block_rows, n)
    n_blocks = n // b

    def body(acc, start):
        rows = jax.lax.dynamic_slice_in_dim(theta, start, b, axis=0)
        grows = jax.lax.dynamic_slice_in_dim(grads, start, b, axis=0)
        drows = jax.lax.dynamic_slice_in_dim(d, start, b, axis=0)
        rsqr = jax.lax.dynamic_slice_in_dim(rsq, start, b, axis=0)
        return acc + _ksd_row_block_sum(
            rows, grows, drows, theta, grads, d, rsqr, rsq, h2, p
        ), None

    total, _ = jax.lax.scan(
        body, jnp.zeros((), theta.dtype), jnp.arange(n_blocks) * b
    )
    rem = n - n_blocks * b
    if rem > 0:
        total = total + _ksd_row_block_sum(
            theta[-rem:], grads[-rem:], d[-rem:], theta, grads, d,
            rsq[-rem:], rsq, h2, p,
        )
    if u_statistic:
        diag = jnp.sum(grads * grads) + n * p / h2
        return (total - diag) / (n * (n - 1))
    return total / (n * n)
