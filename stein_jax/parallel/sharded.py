"""Particle-sharded SVGD step via shard_map.

Replaces the reference's sequential per-particle loop
(stein_sampler.py:59-68) with an SPMD program over a particle-sharded mesh:

- each shard holds a particle block [n_local, p] plus the matching optimizer
  moment blocks;
- per-particle gradients run locally with vmap(value_and_grad);
- the n x n kernel is computed as local-rows x global-cols tiles against an
  all-gathered particle/gradient matrix (SURVEY.md §5's "blockwise tiling");
- the median bandwidth is global: exact via an all-gather of the local
  distance rows (small n), or psum'd histogram refinement (large n);
- the global Frobenius norm for the clip (abstract_stein_sampler.py:125) is
  a psum of local squared sums;
- the optimizer update is elementwise over the local block, with scalar
  state (step count, decayed lr) computed redundantly and identically on
  every shard.
"""

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..api import SVGDState, _make_grad_all
from ..ops.median import binned_median, _row_block_sq_dists
from ..ops.rbf import bandwidth_sq_from_median

# Per-device ceiling for the [n, n] gather median='exact' requires
# (2^28 B = 256 MB -> n <= 8192 in f32); beyond it the sharded step
# refuses and points at the gather-free medians.
EXACT_MEDIAN_GATHER_LIMIT_BYTES = 2 ** 28


def check_exact_median_gather(n_particles, dtype, context, alternatives):
    """Refuse median='exact' when its [n, n] all-gather onto every device
    would exceed EXACT_MEDIAN_GATHER_LIMIT_BYTES — a user scaling up with
    the default would otherwise hit a silent OOM. Shared by the 1-D and
    2-D sharded steps so the limit policy stays in one place."""
    itemsize = jnp.dtype(dtype).itemsize
    gather_bytes = n_particles * n_particles * itemsize
    if gather_bytes > EXACT_MEDIAN_GATHER_LIMIT_BYTES:
        n_max = int((EXACT_MEDIAN_GATHER_LIMIT_BYTES // itemsize) ** 0.5)
        raise ValueError(
            f"median='exact' on a {context} would all-gather the full "
            f"[{n_particles}, {n_particles}] distance matrix onto every "
            f"device ({gather_bytes / 2**20:.0f} MB/device). Use "
            f"{alternatives} for n_particles > {n_max}."
        )


def _place_global(leaf, sharding):
    """Place a host-replicated array onto a (possibly multi-process) mesh.

    Single-controller: plain device_put. Multi-controller (a mesh spanning
    processes after jax.distributed.initialize): device_put cannot address
    remote shards, so build the global array from the local value —
    every process holds the full leaf (deterministic init / restored
    checkpoint) and materialises only its addressable shards."""
    import numpy as np
    mesh = getattr(sharding, "mesh", None)
    if mesh is None or all(d.process_index == jax.process_index()
                           for d in np.asarray(mesh.devices).flat):
        return jax.device_put(leaf, sharding)
    leaf_np = np.asarray(leaf)
    return jax.make_array_from_callback(
        leaf_np.shape, sharding, lambda idx: leaf_np[idx]
    )


def replicate_batch(batch, mesh):
    """Replicate a host batch pytree onto every device of ``mesh`` —
    required for multi-controller meshes (each process passes the same
    host values), harmless single-controller."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda leaf: _place_global(leaf, sharding), batch
    )


def shard_state(state, mesh, axis_name):
    """Place an SVGDState on the mesh: particle-dim arrays sharded along
    ``axis_name``, scalars replicated. Multi-controller-safe (see
    _place_global)."""
    n = state.particles.shape[0]

    def spec_for(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim >= 1 and leaf.shape[0] == n:
            return NamedSharding(
                mesh, P(axis_name, *([None] * (leaf.ndim - 1)))
            )
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(
        lambda leaf: _place_global(leaf, spec_for(leaf)), state
    )


def _ring_generic_pass(theta_loc, grads_loc, rsq_loc, h2, axis, kernel):
    """Ring block circulation for a pluggable weights-kernel
    (stein_jax.kernels): each tile computes D, applies
    ``kernel.weights(D, h2) -> (K, W)``, and accumulates the attractive
    K@grads, the repulsive W@theta, and the W row-sums for the local rows.

    Returns (attract, wtheta, wsum). The RBF path uses the fused
    _ring_kernel_pass below instead (single contraction, division by h^2
    after the matmul) so its fp order matches ops/rbf.svgd_phi exactly."""
    n_dev = jax.lax.axis_size(axis)
    p = theta_loc.shape[1]
    gt_loc = jnp.concatenate([grads_loc, theta_loc], axis=1)

    def body(i, carry):
        acc_attract, acc_wtheta, acc_wsum, block_gt, block_rsq = carry
        block_theta = block_gt[:, p:]
        block_grads = block_gt[:, :p]
        D = _row_block_sq_dists(theta_loc, block_theta, rsq_loc, block_rsq)
        K, W = kernel.weights(D, h2)
        acc_attract = acc_attract + jnp.matmul(
            K, block_grads, preferred_element_type=theta_loc.dtype,
            precision=jax.lax.Precision.HIGH,
        )
        acc_wtheta = acc_wtheta + jnp.matmul(
            W, block_theta, preferred_element_type=theta_loc.dtype,
            precision=jax.lax.Precision.HIGH,
        )
        acc_wsum = acc_wsum + jnp.sum(W, axis=1, keepdims=True)
        perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]
        block_gt = jax.lax.ppermute(block_gt, axis, perm)
        block_rsq = jax.lax.ppermute(block_rsq, axis, perm)
        return acc_attract, acc_wtheta, acc_wsum, block_gt, block_rsq

    n_loc = theta_loc.shape[0]
    z = jnp.zeros((n_loc, p), theta_loc.dtype)
    acc_attract, acc_wtheta, acc_wsum, _, _ = jax.lax.fori_loop(
        0, n_dev, body,
        (z, z, jnp.zeros((n_loc, 1), theta_loc.dtype), gt_loc, rsq_loc),
    )
    return acc_attract, acc_wtheta, acc_wsum


def _ring_kernel_pass(theta_loc, grads_loc, rsq_loc, h2, axis):
    """Ring alternative to the all-gather kernel tiles: each shard's
    [n_loc, p] block of [grads | theta] circulates around the particle
    axis with ppermute while every shard accumulates its local rows'
    K-tile contributions — peak per-device footprint O(n_loc x p) instead
    of O(n x p), and the block transfer overlaps the tile compute
    (SURVEY.md §5 "blocks all-gathered (or ring-passed) from peers").

    Returns (attract, ktheta, ksum) for the local rows."""
    n_dev = jax.lax.axis_size(axis)
    p = theta_loc.shape[1]
    gt_loc = jnp.concatenate([grads_loc, theta_loc], axis=1)

    def tile(carry_block):
        block_gt, block_rsq = carry_block
        block_theta = block_gt[:, p:]
        D = _row_block_sq_dists(theta_loc, block_theta, rsq_loc, block_rsq)
        K = jnp.exp(-D / h2 / 2.0)
        return jnp.matmul(
            K, block_gt, precision=jax.lax.Precision.HIGH
        ), jnp.sum(K, axis=1, keepdims=True)

    def body(i, carry):
        acc_both, acc_ksum, block_gt, block_rsq = carry
        t_both, t_ksum = tile((block_gt, block_rsq))
        perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]
        block_gt = jax.lax.ppermute(block_gt, axis, perm)
        block_rsq = jax.lax.ppermute(block_rsq, axis, perm)
        return acc_both + t_both, acc_ksum + t_ksum, block_gt, block_rsq

    acc_both = jnp.zeros((theta_loc.shape[0], 2 * p), theta_loc.dtype)
    acc_ksum = jnp.zeros((theta_loc.shape[0], 1), theta_loc.dtype)
    acc_both, acc_ksum, _, _ = jax.lax.fori_loop(
        0, n_dev, body, (acc_both, acc_ksum, gt_loc, rsq_loc)
    )
    return acc_both[:, :p], acc_both[:, p:], acc_ksum


def _rbf_phi_rows_xla(theta_loc, theta_all, grads_all, D_rows, h2,
                      n_particles):
    """Fused RBF tile on local rows x gathered global cols (XLA path):
    K, row-sums, and the single [n_loc, n] x [n, 2p] contraction —
    the same fp order as ops/rbf.svgd_phi. Shared by the cold and warm
    sharded steps so their phi semantics cannot drift apart."""
    p = theta_loc.shape[1]
    K_rows = jnp.exp(-D_rows / h2 / 2.0)     # [n_loc, n]
    ksum = jnp.sum(K_rows, axis=1, keepdims=True)
    both = jnp.matmul(
        K_rows, jnp.concatenate([grads_all, theta_all], axis=1),
        preferred_element_type=theta_loc.dtype,
        precision=jax.lax.Precision.HIGH,
    )
    attract = both[:, :p]
    ktheta = both[:, p:]
    return (attract + (ksum * theta_loc - ktheta) / h2) / n_particles


def _clip_update_aux(state, phi, log_p_vals, h2, med, gd, max_phi_norm,
                     axis):
    """Shared tail of every 1-D sharded step: global Frobenius-norm clip
    (abstract_stein_sampler.py:125, psum'd), optimizer update, aux dict.
    Returns (new_state, aux)."""
    theta_loc = state.particles
    norm = jnp.sqrt(jax.lax.psum(jnp.sum(phi * phi), axis))
    c = jnp.asarray(max_phi_norm, theta_loc.dtype)
    phi = phi * (c / jnp.maximum(c, norm))
    delta, opt_state = gd.update(state.opt_state, phi)
    new_state = SVGDState(theta_loc + delta, opt_state, state.step + 1)
    aux = {
        "phi_norm": norm,
        "log_p_mean": jax.lax.pmean(jnp.mean(log_p_vals), axis),
        "h2": h2,
        "median": med,
    }
    return new_state, aux


def make_sharded_step(log_p, unravel_fn, gd, n_particles, state, mesh,
                      particle_axis="particles", median="exact",
                      max_phi_norm=10.0, donate=True,
                      binned_bins=4096, binned_block_rows=256,
                      comm="all_gather", remat=False, median_max_rows=512,
                      median_passes=30, kernel=None, custom_grads=None):
    """Build (step_fn, jitted_step, sharded_state) for the mesh.

    Returns the raw SPMD step (for composition/testing), its jitted form
    with donated state, and the input state placed onto the mesh.

    ``kernel``: optional pluggable kernel from stein_jax.kernels (the
    ``weights(D, h2) -> (K, W)`` contract — reference surface:
    stein/kernels/abstract_kernel.py:45-62). None / SquaredExponentialKernel
    use the fused RBF tile whose fp order matches ops/rbf.svgd_phi exactly;
    other kernels (e.g. InverseMultiquadricKernel) take the generic
    two-matmul tile path.
    """
    if kernel is not None:
        from ..kernels import SquaredExponentialKernel
        # Exact type only: a subclass may override weights(); silently
        # substituting the fused RBF path would sample the wrong geometry.
        if type(kernel) is SquaredExponentialKernel:
            kernel = None    # fused RBF path
    axis = particle_axis
    n_dev = mesh.shape[axis]
    if n_particles % n_dev != 0:
        raise ValueError(
            f"n_particles={n_particles} must divide evenly over the "
            f"{n_dev}-way particle axis {axis!r}"
        )

    # Per-shard gradient stage: vmap-autodiff, or the row-local
    # custom_grads hook (gradients are per-particle, so any valid hook
    # applies to an [n_loc, p] shard block unchanged — 1-D meshes only,
    # api.py guards the 2-D case where params are sharded too).
    grad_all = _make_grad_all(log_p, unravel_fn, remat, custom_grads)

    if comm not in ("all_gather", "ring"):
        raise ValueError(f"unknown comm mode: {comm!r}")
    if median == "exact":
        check_exact_median_gather(
            n_particles, state.particles.dtype, "mesh",
            "median='bisect' (exact to fp-bisection resolution, no "
            "gather) or median='binned' (psum'd histogram)",
        )
    if comm == "ring" and median not in ("binned", "bisect"):
        raise ValueError(
            f"comm='ring' supports median='binned' (per-rotation psum'd "
            f"histogram) or median='bisect' (ring-assembled strided row "
            f"block, bitwise-equal to the all-gather search), got "
            f"{median!r}: the ring never assembles the global column "
            "block the other median modes need"
        )

    def spmd_step(state, batch):
        theta_loc = state.particles                      # [n_loc, p]
        log_p_vals, grads_loc = grad_all(theta_loc, batch)
        rsq_loc = jnp.sum(theta_loc * theta_loc, axis=1)

        if comm == "ring":
            if median == "bisect":
                from ..ops.median import ring_bisect_median
                med = ring_bisect_median(
                    theta_loc, axis, max_rows=median_max_rows,
                    passes=median_passes,
                )
            else:
                from ..ops.median import ring_binned_median
                med = ring_binned_median(
                    theta_loc, axis, n_bins=binned_bins,
                )
            h2 = bandwidth_sq_from_median(
                med.astype(theta_loc.dtype), n_particles
            )
            if kernel is None:
                attract, ktheta, ksum = _ring_kernel_pass(
                    theta_loc, grads_loc, rsq_loc, h2, axis
                )
                phi = (
                    attract + (ksum * theta_loc - ktheta) / h2
                ) / n_particles
            else:
                attract, wtheta, wsum = _ring_generic_pass(
                    theta_loc, grads_loc, rsq_loc, h2, axis, kernel
                )
                phi = (
                    attract + (wsum * theta_loc - wtheta)
                ) / n_particles
        else:
            # Particle block exchange: every shard needs all particles (and
            # gradients) as kernel-matrix columns.
            theta_all = jax.lax.all_gather(theta_loc, axis, tiled=True)
            grads_all = jax.lax.all_gather(grads_loc, axis, tiled=True)

            rsq_all = jnp.sum(theta_all * theta_all, axis=1)
            # Local rows x global cols of D = r + r^T - 2 T T^T
            # (abstract_kernel.py:33-35).
            D_rows = _row_block_sq_dists(
                theta_loc, theta_all, rsq_loc, rsq_all
            )

            # Global median over all n^2 entries (compute_median.py:4-16).
            if median == "exact":
                D_full = jax.lax.all_gather(D_rows, axis, tiled=True)
                med = jnp.median(D_full)
            elif median == "bisect":
                from ..ops.median import sharded_bisect_median
                med = sharded_bisect_median(
                    theta_loc, theta_all, axis, max_rows=median_max_rows,
                    passes=median_passes,
                )
            elif median == "binned":
                med = binned_median(
                    theta_loc, n_bins=binned_bins,
                    block_rows=binned_block_rows,
                    axis_name=axis, theta_cols=theta_all,
                )
            else:
                raise ValueError(
                    f"unknown sharded median mode: {median!r} "
                    "(use 'exact', 'bisect', or 'binned')"
                )
            h2 = bandwidth_sq_from_median(
                med.astype(theta_loc.dtype), n_particles
            )

            if kernel is None:
                phi = _rbf_phi_rows_xla(
                    theta_loc, theta_all, grads_all, D_rows, h2,
                    n_particles,
                )
            else:
                # Generic weights-kernel tile: K and W differ, so the
                # attractive and repulsive contractions cannot share one
                # matmul (same fp order as kernels.generic_svgd_phi).
                K_rows, W_rows = kernel.weights(D_rows, h2)
                wsum = jnp.sum(W_rows, axis=1, keepdims=True)
                attract = jnp.matmul(
                    K_rows, grads_all,
                    preferred_element_type=theta_loc.dtype,
                    precision=jax.lax.Precision.HIGH,
                )
                wtheta = jnp.matmul(
                    W_rows, theta_all,
                    preferred_element_type=theta_loc.dtype,
                    precision=jax.lax.Precision.HIGH,
                )
                phi = (
                    attract + (wsum * theta_loc - wtheta)
                ) / n_particles

        return _clip_update_aux(
            state, phi, log_p_vals, h2, med, gd, max_phi_norm, axis
        )

    state_specs = _state_specs(state, n_particles, axis)
    aux_specs = {"phi_norm": P(), "log_p_mean": P(), "h2": P(), "median": P()}

    step_fn = jax.shard_map(
        spmd_step,
        mesh=mesh,
        in_specs=(state_specs, P()),
        out_specs=(state_specs, aux_specs),
        check_vma=False,
    )
    jitted = jax.jit(step_fn, donate_argnums=(0,) if donate else ())
    return step_fn, jitted, shard_state(state, mesh, axis)


def _state_specs(state, n_particles, axis):
    """PartitionSpecs for an SVGDState on a 1-D particle mesh: particle-dim
    arrays sharded along ``axis``, scalar state replicated."""
    pdim = P(axis, None)
    return SVGDState(
        particles=pdim,
        opt_state=jax.tree_util.tree_map(
            lambda leaf: pdim if leaf.ndim >= 1 and
            leaf.shape[0] == n_particles else P(),
            state.opt_state,
        ),
        step=P(),
    )


def make_sharded_warm_step(log_p, unravel_fn, gd, n_particles, state, mesh,
                           particle_axis="particles", max_phi_norm=10.0,
                           remat=False, median_max_rows=512,
                           median_passes=30, warm_passes=8,
                           comm="all_gather", custom_grads=None):
    """Warm-median variant of the sharded step for the scan loops
    (api.run / train_on_batches): carry is (SVGDState, med_prev), and the
    bandwidth search refines the previous step's median inside a
    count-verified bracket (ops/median.sharded_warm_bisect_median_on_D — the
    same branchless search as single-device, with the counts psum'd: ONE
    batched collective for the bracket pass plus one per quad-ary round,
    vs 1+ceil(median_passes/2) for the cold sharded search).

    Supports the default RBF kernel in both comm modes: comm='all_gather'
    exchanges the global column block and reuses its materialised D rows
    for the warm counts; comm='ring' circulates column blocks with
    ppermute (the warm counts run on the ring-assembled strided row block,
    ops/median.ring_warm_bisect_median — bitwise-equal medians to the
    all-gather search). Returns (warm_step_fn, init_med_fn):
    warm_step_fn is shard_map'd and scan-ready; init_med_fn is a jitted
    cold sharded bisect used to seed the scan carry.
    """
    axis = particle_axis
    n_dev = mesh.shape[axis]
    if n_particles % n_dev != 0:
        raise ValueError(
            f"n_particles={n_particles} must divide evenly over the "
            f"{n_dev}-way particle axis {axis!r}"
        )
    if comm not in ("all_gather", "ring"):
        raise ValueError(f"unknown comm mode: {comm!r}")

    from ..ops.median import (
        ring_bisect_median,
        ring_warm_bisect_median,
        sharded_bisect_median,
        sharded_warm_bisect_median_on_D,
    )

    # Per-shard gradient stage: vmap-autodiff, or the row-local
    # custom_grads hook (gradients are per-particle, so any valid hook
    # applies to an [n_loc, p] shard block unchanged — 1-D meshes only,
    # api.py guards the 2-D case where params are sharded too).
    grad_all = _make_grad_all(log_p, unravel_fn, remat, custom_grads)

    def spmd_warm_ring_step(carry, batch):
        state, med_prev = carry
        theta_loc = state.particles                      # [n_loc, p]
        log_p_vals, grads_loc = grad_all(theta_loc, batch)
        med = ring_warm_bisect_median(
            theta_loc, med_prev, axis, max_rows=median_max_rows,
            warm_passes=warm_passes,
        )
        h2 = bandwidth_sq_from_median(
            med.astype(theta_loc.dtype), n_particles
        )
        rsq_loc = jnp.sum(theta_loc * theta_loc, axis=1)
        attract, ktheta, ksum = _ring_kernel_pass(
            theta_loc, grads_loc, rsq_loc, h2, axis
        )
        phi = (attract + (ksum * theta_loc - ktheta) / h2) / n_particles
        new_state, aux = _clip_update_aux(
            state, phi, log_p_vals, h2, med, gd, max_phi_norm, axis
        )
        return (new_state, med.astype(theta_loc.dtype)), aux

    def spmd_warm_step(carry, batch):
        state, med_prev = carry
        theta_loc = state.particles                      # [n_loc, p]
        log_p_vals, grads_loc = grad_all(theta_loc, batch)
        theta_all = jax.lax.all_gather(theta_loc, axis, tiled=True)
        grads_all = jax.lax.all_gather(grads_loc, axis, tiled=True)

        rsq_loc = jnp.sum(theta_loc * theta_loc, axis=1)
        rsq_all = jnp.sum(theta_all * theta_all, axis=1)
        D_rows = _row_block_sq_dists(theta_loc, theta_all, rsq_loc, rsq_all)
        # Warm counts run on (a strided local-row subsample of) the D the
        # kernel materialises anyway — no second Gram matmul.
        med = sharded_warm_bisect_median_on_D(
            D_rows, med_prev, axis,
            max_rows=median_max_rows, warm_passes=warm_passes,
        )
        h2 = bandwidth_sq_from_median(med.astype(theta_loc.dtype), n_particles)
        phi = _rbf_phi_rows_xla(
            theta_loc, theta_all, grads_all, D_rows, h2, n_particles
        )

        new_state, aux = _clip_update_aux(
            state, phi, log_p_vals, h2, med, gd, max_phi_norm, axis
        )
        return (new_state, med.astype(theta_loc.dtype)), aux

    state_specs = _state_specs(state, n_particles, axis)
    carry_specs = (state_specs, P())
    aux_specs = {"phi_norm": P(), "log_p_mean": P(), "h2": P(), "median": P()}

    warm_step_fn = jax.shard_map(
        spmd_warm_ring_step if comm == "ring" else spmd_warm_step,
        mesh=mesh,
        in_specs=(carry_specs, P()),
        out_specs=(carry_specs, aux_specs),
        check_vma=False,
    )

    def init_spmd(theta_loc):
        # The cold seed honours the comm mode too: ring circulates
        # column blocks (per-device footprint stays O(n_loc x p)) where
        # all_gather materialises the full [n, p] block once.
        if comm == "ring":
            return ring_bisect_median(
                theta_loc, axis,
                max_rows=median_max_rows, passes=median_passes,
            )
        theta_all = jax.lax.all_gather(theta_loc, axis, tiled=True)
        return sharded_bisect_median(
            theta_loc, theta_all, axis,
            max_rows=median_max_rows, passes=median_passes,
        )

    init_med_fn = jax.jit(jax.shard_map(
        init_spmd, mesh=mesh, in_specs=P(axis, None), out_specs=P(),
        check_vma=False,
    ))
    return warm_step_fn, init_med_fn
