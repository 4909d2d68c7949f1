"""Streaming SVGD tile: a Pallas kernel through Triton for the GPU.

The hot op of SVGD at large n is the n x n RBF kernel applied to the
gradient and particle matrices. The XLA path (ops/rbf.py) materialises D
and K in device memory: at n=10240 in f32 each is 419 MB, written and
read back every step, for two matrix products XLA cannot fuse across.

This kernel is shaped like flash attention: one program per block of
rows, a loop over column blocks inside the program. Each column block
computes the squared distances D = r_i + r_j - 2 theta_i theta_j^T,
exponentiates them, and immediately contracts K against the regrouped
operand u = grads - theta / h^2 while it accumulates the row sums of K.
Neither D nor K ever reaches device memory.

The bandwidth h^2 is computed beforehand (ops/median.py), since the tile
needs it. The direction is

  phi_i = ( sum_j K_ij u_j + ksum_i theta_i / h^2 ) / n

which is ops/rbf.svgd_phi regrouped into one contraction.

Precision: both in-kernel products run in TF32 (Precision.HIGH), so
the Gram behind D is less precise than the XLA path's HIGHEST Gram; that
is why the tile is an opt-in (kernel_impl="pallas") and not a default.
The particles are centred at their mean before the Gram, so its rounding
error scales with the particle spread and not with the distance of the
cloud from the origin. On an H100 (PERF.md) phi came within 3.2e-4 of a
float64 phi on a unit cloud off the origin (the XLA path: 1.8e-4) and
within 1.7e-5 on a tight cluster where the XLA path's uncentred Gram
loses D (0.17). With its Gram at full f32 the tile ran 3-5x slower than
the XLA step, at every shape measured.
"""

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# exp(-D / (2 h^2)) = 2^(D * (-log2(e) / 2) / h^2)
_NEG_HALF_LOG2E = -0.5 * math.log2(math.e)


def _next_pow2(x, floor=16):
    return max(floor, 1 << (int(x) - 1).bit_length())


# Shared memory one Hopper block may use, and the widest padded parameter
# dimension whose row and column tiles still fit in it.
SMEM_BYTES = 232448
MAX_PARAMS = 1024


def tile_blocks(p_pad):
    """(block_i, block_j, num_warps, num_stages) for a padded parameter
    width.

    The [block_i, p] accumulator lives in registers, so the row block
    shrinks as p grows; the column block halves until the row tile plus
    num_stages column tiles fit the block's shared memory. Blocks stay at
    least 16 wide for the tensor-core product. (32, 64) at p=128 and
    (16, 32) at p=512 were the fastest of the blocks that
    ``python bench.py --tile-sweep`` sweeps, on an H100 (PERF.md)."""
    bi = 32 if p_pad <= 128 else 16
    bj, num_stages = 64, 2
    while bj > 16 and 4 * (bi + num_stages * bj) * p_pad > SMEM_BYTES:
        bj //= 2
    return bi, bj, 4, num_stages


def _gram(rows, cols):
    """rows @ cols^T for one tile of centred particles, in TF32."""
    return pl.dot(rows, cols, trans_b=True, precision=jax.lax.Precision.HIGH)


def _tile_kernel(h2_ref, rows_ref, rsq_i_ref, cols_ref, rsq_j_ref, u_ref,
                 ku_ref, ksum_ref, *, n, block_j):
    """One block of rows against every column block."""
    rows = rows_ref[...]                           # [bi, p]
    rsq_i = rsq_i_ref[...]                         # [bi]
    scale = _NEG_HALF_LOG2E / h2_ref[0]
    bi, p = rows.shape

    def body(jb, carry):
        ku, ksum = carry
        cols_slice = pl.ds(jb * block_j, block_j)
        gram = _gram(rows, cols_ref[cols_slice, :])
        D = rsq_i[:, None] + rsq_j_ref[cols_slice][None, :] - 2.0 * gram
        K = jnp.exp2(D * scale)                    # [bi, bj]
        # Columns at or past n are zero padding, not particles.
        col = jb * block_j + jax.lax.broadcasted_iota(jnp.int32, K.shape, 1)
        K = jnp.where(col < n, K, 0.0)
        ku = ku + pl.dot(K, u_ref[cols_slice, :],
                         precision=jax.lax.Precision.HIGH)
        return ku, ksum + jnp.sum(K, axis=1)

    ku, ksum = jax.lax.fori_loop(
        0, pl.cdiv(n, block_j), body,
        (jnp.zeros((bi, p), jnp.float32), jnp.zeros((bi,), jnp.float32)),
    )
    ku_ref[...] = ku
    ksum_ref[...] = ksum


def _pad(x, rows, cols=0):
    if rows == 0 and cols == 0:
        return x
    return jnp.pad(x, ((0, rows), (0, cols)))


@functools.partial(jax.jit, static_argnames=("interpret",))
def pallas_svgd_both_ksum(theta_rows, theta_cols, grads_cols, h2, center,
                          interpret=False):
    """Streaming accumulators for an [m, p] row block against [n, p]
    column particles and gradients: ``ku = K @ (grads - (theta -
    center) / h^2)`` ([m, p]) and ``ksum`` ([m, 1]).

    phi = (ku + ksum * (theta_rows - center) / h^2) / n_total. Callers
    that accumulate several column blocks (the ring step,
    parallel/sharded.py) sum the partial (ku, ksum) pairs and combine
    once; h^2 and ``center`` must be the same for every block.

    ``center`` ([1, p]) is subtracted before the in-kernel Gram: D does
    not change, but the TF32 Gram's error scales with ||theta||^2, so an
    uncentred cloud far from the origin loses D's significant digits.
    Pass the particle mean of the columns."""
    m, p = theta_rows.shape
    n = theta_cols.shape[0]
    f32 = jnp.float32
    p_pad = _next_pow2(p)
    if p_pad > MAX_PARAMS:
        raise ValueError(
            f"the streaming tile holds at most {MAX_PARAMS} parameters per "
            f"particle (got p={p}); use kernel_impl='xla'"
        )
    bi, bj, num_warps, num_stages = tile_blocks(p_pad)
    m_pad = -(-m // bi) * bi
    n_pad = -(-n // bj) * bj

    h2f = jnp.asarray(h2, f32)
    c = jnp.asarray(center, f32).reshape(1, p)
    rows = _pad(theta_rows.astype(f32) - c, m_pad - m, p_pad - p)
    cols = _pad(theta_cols.astype(f32) - c, n_pad - n, p_pad - p)
    u = _pad(grads_cols.astype(f32), n_pad - n, p_pad - p) - cols / h2f
    rsq_i = jnp.sum(rows * rows, axis=1)
    rsq_j = jnp.sum(cols * cols, axis=1)

    ku, ksum = pl.pallas_call(
        functools.partial(_tile_kernel, n=n, block_j=bj),
        grid=(m_pad // bi,),
        in_specs=[
            pl.BlockSpec((1,), lambda i: (0,)),                 # h2
            pl.BlockSpec((bi, p_pad), lambda i: (i, 0)),        # rows
            pl.BlockSpec((bi,), lambda i: (i,)),                # rsq_i
            pl.BlockSpec((n_pad, p_pad), lambda i: (0, 0)),     # cols
            pl.BlockSpec((n_pad,), lambda i: (0,)),             # rsq_j
            pl.BlockSpec((n_pad, p_pad), lambda i: (0, 0)),     # u
        ],
        out_specs=[
            pl.BlockSpec((bi, p_pad), lambda i: (i, 0)),
            pl.BlockSpec((bi,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((m_pad, p_pad), f32),
            jax.ShapeDtypeStruct((m_pad,), f32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="svgd_tile",
    )(h2f.reshape(1), rows, rsq_i, cols, rsq_j, u)
    return ku[:m, :p], ksum[:m, None]


@functools.partial(jax.jit, static_argnames=("n_total", "interpret"))
def pallas_svgd_phi_rect(theta_rows, theta_cols, grads_cols, h2,
                         n_total=None, interpret=False):
    """phi for an [m, p] row block of particles against [n, p] column
    particles and gradients.

    m == n is the single-device path (``pallas_svgd_phi``); m < n is one
    shard of the all-gather sharded step (parallel/sharded.py), which
    streams its local rows against the gathered columns. ``n_total`` is
    the global particle count dividing phi (reference
    abstract_stein_sampler.py:105); it defaults to n."""
    n = theta_cols.shape[0]
    if n_total is None:
        n_total = n
    f32 = jnp.float32
    # From the columns, so every shard of the sharded step derives the
    # same centre.
    center = jnp.mean(theta_cols.astype(f32), axis=0, keepdims=True)
    ku, ksum = pallas_svgd_both_ksum(
        theta_rows, theta_cols, grads_cols, h2, center, interpret=interpret,
    )
    h2f = jnp.asarray(h2, f32)
    phi = (ku + ksum * (theta_rows.astype(f32) - center) / h2f) / n_total
    return phi.astype(theta_rows.dtype)


def pallas_svgd_phi(theta, grads, h2, interpret=False):
    """SVGD direction phi for [n, p] particles and gradients; ops/rbf.
    svgd_phi with the same h^2, up to TF32 products and their order."""
    return pallas_svgd_phi_rect(theta, theta, grads, h2,
                                interpret=interpret)
