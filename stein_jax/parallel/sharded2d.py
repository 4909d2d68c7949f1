"""2-D sharded SVGD step: particles x parameter dimension.

The workload's two scaling axes are n_particles and n_params
(abstract_stein_sampler.py:99-105 — there is no sequence/attention axis, so
this parameter axis is the framework's tensor-parallel analogue). For large
models (p in the millions, e.g. wide Bayesian NNs) a pure particle sharding
leaves each device holding full [n_local, p] rows plus two optimizer moment
copies; sharding p as well cuts per-device state by the model-axis size and
turns the kernel-matrix contraction into a psum over parameter shards:

- theta is sharded [n/dp, p/mp] over a (particles, model) mesh;
- D = r + r^T - 2 theta theta^T needs the *full* inner product over p:
  each shard computes its partial row-block Gram tile against the
  column-all-gathered particle block and the partials psum over the model
  axis — the same contraction pattern as a row-parallel transformer matmul;
- K then exists replicated over the model axis, and K @ [grads | theta]
  proceeds with the p-sharded right-hand side, leaving phi p-sharded — no
  further collective;
- gradients: log_p needs full parameter rows, so rows are all-gathered over
  the model axis for the vmap(grad) and the result is re-sliced to the
  local p shard. (For the models here p-local gradient computation does not
  decompose — log_p is not separable — so this is the honest dataflow; the
  all-gather rides the model axis only.)

The step matches the 1-D and single-device paths to fp tolerance
(tests/test_sharded2d.py).
"""

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..api import SVGDState


def shard_state_2d(state, mesh, particle_axis, model_axis):
    """Place an SVGDState: [n, p] leaves sharded (particles, model),
    scalars replicated. Multi-controller-safe (sharded._place_global)."""
    from .sharded import _place_global

    n, p = state.particles.shape

    def spec_for(leaf):
        if hasattr(leaf, "ndim") and leaf.ndim == 2 and leaf.shape == (n, p):
            return NamedSharding(mesh, P(particle_axis, model_axis))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(
        lambda leaf: _place_global(leaf, spec_for(leaf)), state
    )


def make_sharded2d_step(log_p, unravel_fn, gd, n_particles, n_params, state,
                        mesh, particle_axis="particles", model_axis="model",
                        max_phi_norm=10.0, donate=True, remat=False,
                        median="exact", median_max_rows=512,
                        median_passes=30, kernel=None):
    """Build (step_fn, jitted_step, sharded_state) over a 2-D mesh.

    ``median``: "exact" gathers the full [n, n] D onto every device
    (guarded by the same per-device byte ceiling as the 1-D path);
    "bisect" psums strided-row counts on the already-materialised local
    D rows — gather-free, exact to fp-bisection resolution.

    ``kernel``: optional pluggable kernel from stein_jax.kernels (the
    ``weights(D, h2) -> (K, W)`` contract — reference surface:
    stein/kernels/abstract_kernel.py:45-62). None / SquaredExponentialKernel
    use the fused single-contraction RBF path; other kernels (e.g.
    InverseMultiquadricKernel) take the generic two-matmul path, same fp
    order as kernels.generic_svgd_phi.
    """
    if kernel is not None:
        from ..kernels import SquaredExponentialKernel
        # Exact type only: a subclass may override weights(); silently
        # substituting the fused RBF path would sample the wrong geometry.
        if type(kernel) is SquaredExponentialKernel:
            kernel = None    # fused RBF path
    dp = mesh.shape[particle_axis]
    mp = mesh.shape[model_axis]
    if n_particles % dp != 0:
        raise ValueError(f"n_particles={n_particles} not divisible by "
                         f"{particle_axis}={dp}")
    if n_params % mp != 0:
        raise ValueError(f"n_params={n_params} not divisible by "
                         f"{model_axis}={mp} (pad the template)")
    if median not in ("exact", "bisect"):
        raise ValueError(
            f"unknown 2-D sharded median mode: {median!r} "
            "(use 'exact' or 'bisect')"
        )
    if median == "exact":
        from .sharded import check_exact_median_gather
        check_exact_median_gather(
            n_particles, state.particles.dtype, "2-D mesh",
            "median='bisect' (exact to fp-bisection resolution, no gather)",
        )

    def log_p_flat(theta_row, batch):
        return log_p(unravel_fn(theta_row), batch)

    if remat:
        log_p_flat = jax.checkpoint(log_p_flat)

    grad_all = jax.vmap(jax.value_and_grad(log_p_flat), in_axes=(0, None))

    def compute_med_cold(D_rows, rsq_cen):
        # Global median over all n^2 entries (compute_median.py:4-16):
        # row blocks live on the particle axis.
        if median == "exact":
            D_full = jax.lax.all_gather(D_rows, particle_axis, tiled=True)
            return jnp.median(D_full)
        # "bisect" — counts on the local D rows, psum'd over rows.
        from ..ops.median import sharded_bisect_median_on_D
        return sharded_bisect_median_on_D(
            D_rows, particle_axis, max_rows=median_max_rows,
            passes=median_passes,
        )

    def spmd_step(state, batch):
        return _core_step_2d(
            state, batch, compute_med_cold, grad_all=grad_all, gd=gd,
            kernel=kernel, n_particles=n_particles,
            particle_axis=particle_axis, model_axis=model_axis,
            max_phi_norm=max_phi_norm,
        )

    state_specs = _state_specs_2d(
        state, n_particles, n_params, particle_axis, model_axis
    )
    aux_specs = {"phi_norm": P(), "log_p_mean": P(), "h2": P(), "median": P()}

    step_fn = jax.shard_map(
        spmd_step,
        mesh=mesh,
        in_specs=(state_specs, P()),
        out_specs=(state_specs, aux_specs),
        check_vma=False,
    )
    jitted = jax.jit(step_fn, donate_argnums=(0,) if donate else ())
    return step_fn, jitted, shard_state_2d(
        state, mesh, particle_axis, model_axis
    )


def _state_specs_2d(state, n_particles, n_params, particle_axis,
                    model_axis):
    """PartitionSpecs for an SVGDState on a 2-D (particles x model) mesh."""
    blk = P(particle_axis, model_axis)
    return SVGDState(
        particles=blk,
        opt_state=jax.tree_util.tree_map(
            lambda leaf: blk if leaf.ndim == 2 and
            leaf.shape == (n_particles, n_params) else P(),
            state.opt_state,
        ),
        step=P(),
    )


def _d_rows_2d(theta_blk, theta_cols, model_axis):
    """Exact [n_loc, n] squared-distance rows on a 2-D mesh: partial
    row-norms/Gram over the local parameter shard, psum'd over the model
    axis (abstract_kernel.py:33-35). One copy shared by the step body and
    the warm-median cold seed, so the seed is computed on the identical D
    the step re-verifies against. HIGHEST on the Gram: D cancels
    catastrophically (see ops/rbf.pairwise_sq_dists)."""
    # Column-block particle mean is LOCAL (theta_cols holds all n rows
    # of this shard's columns) — used only for the grid search's
    # fallback range below; D itself stays on the uncentered identity
    # so the 2-D numerics class is unchanged.
    mu = jnp.mean(theta_cols, axis=0, keepdims=True)   # [1, p_loc]
    tc_cen = theta_cols - mu
    n = theta_cols.shape[0]
    partial_gram = jnp.matmul(
        theta_blk, theta_cols.T,
        precision=jax.lax.Precision.HIGHEST,
    )                                             # [n_loc, n]
    # The three norm partials ride ONE concatenated-vector psum (r5
    # review: they were separate all-reduces; jax lowers tuple psums
    # leaf-wise, so packing must be by concatenation) — 2 model-axis
    # collectives per step incl. the Gram, down from 3.
    vec = jax.lax.psum(
        jnp.concatenate([
            jnp.sum(theta_cols * theta_cols, axis=1),   # [n]
            jnp.sum(tc_cen * tc_cen, axis=1),           # [n] centered
            jnp.sum(theta_blk * theta_blk, axis=1),     # [n_loc]
        ]),
        model_axis,
    )
    rsq_all, rsq_cen, rsq_loc = vec[:n], vec[n:2 * n], vec[2 * n:]
    gram = jax.lax.psum(partial_gram, model_axis)
    D = rsq_loc[:, None] + rsq_all[None, :] - 2.0 * gram
    # rsq_cen rides along for the grid warm search's fallback range:
    # |a-b|^2 <= 4 max |x - mean|^2 — CENTERED, so the bound is
    # spread-scale, not ||mean||^2-scale (an off-origin cloud with an
    # uncentered bound could park the no-valid-bracket fallback at an
    # inflated median and stay there; r5 review). Shard-identical: mu
    # and the partial are deterministic per model shard, psum'd.
    return D, rsq_cen


def _core_step_2d(state, batch, compute_med, *, grad_all, gd, kernel,
                  n_particles, particle_axis, model_axis, max_phi_norm):
    """Shared body of the cold and warm 2-D steps: gathers, the psum'd
    Gram/distance rows, ``med = compute_med(D_rows)``, the kernel tiles,
    the two-axis clip, and the optimizer update. One copy, so the warm
    variant cannot drift from the cold semantics."""
    theta_blk = state.particles                   # [n_loc, p_loc]
    n_loc, p_loc = theta_blk.shape

    # Full parameter rows for the model gradient (model-axis gather).
    theta_rows = jax.lax.all_gather(
        theta_blk, model_axis, axis=1, tiled=True
    )                                             # [n_loc, p]
    log_p_vals, grads_rows = grad_all(theta_rows, batch)
    my_m = jax.lax.axis_index(model_axis)
    grads_blk = jax.lax.dynamic_slice_in_dim(
        grads_rows, my_m * p_loc, p_loc, axis=1
    )                                             # [n_loc, p_loc]

    # Column blocks: all particles, local parameter shard.
    theta_cols = jax.lax.all_gather(
        theta_blk, particle_axis, tiled=True
    )                                             # [n, p_loc]
    grads_cols = jax.lax.all_gather(
        grads_blk, particle_axis, tiled=True
    )                                             # [n, p_loc]

    D_rows, rsq_cen = _d_rows_2d(theta_blk, theta_cols, model_axis)

    med = compute_med(D_rows, rsq_cen)
    from ..ops.rbf import bandwidth_sq_from_median
    h2 = bandwidth_sq_from_median(med, n_particles)

    if kernel is None:
        K_rows = jnp.exp(-D_rows / h2 / 2.0)      # [n_loc, n] (replicated
                                                  #  over model axis)
        ksum = jnp.sum(K_rows, axis=1, keepdims=True)
        both = jnp.matmul(
            K_rows, jnp.concatenate([grads_cols, theta_cols], axis=1),
            preferred_element_type=theta_blk.dtype,
            precision=jax.lax.Precision.HIGH,
        )                                         # [n_loc, 2*p_loc]
        attract = both[:, :p_loc]
        ktheta = both[:, p_loc:]
        phi = (attract + (ksum * theta_blk - ktheta) / h2) / n_particles
    else:
        # Generic weights-kernel path: K and W differ, so the
        # attractive and repulsive contractions cannot share one
        # matmul (same fp order as kernels.generic_svgd_phi). Both
        # are [n_loc, n] @ [n, p_loc] — the model axis stays local.
        K_rows, W_rows = kernel.weights(D_rows, h2)
        wsum = jnp.sum(W_rows, axis=1, keepdims=True)
        attract = jnp.matmul(
            K_rows, grads_cols,
            preferred_element_type=theta_blk.dtype,
            precision=jax.lax.Precision.HIGH,
        )
        wtheta = jnp.matmul(
            W_rows, theta_cols,
            preferred_element_type=theta_blk.dtype,
            precision=jax.lax.Precision.HIGH,
        )
        phi = (attract + (wsum * theta_blk - wtheta)) / n_particles

    # Global clip: psum the squared Frobenius norm over BOTH axes.
    sq = jnp.sum(phi * phi)
    norm = jnp.sqrt(
        jax.lax.psum(jax.lax.psum(sq, particle_axis), model_axis)
    )
    c = jnp.asarray(max_phi_norm, theta_blk.dtype)
    phi = phi * (c / jnp.maximum(c, norm))

    delta, opt_state = gd.update(state.opt_state, phi)
    new_state = SVGDState(theta_blk + delta, opt_state, state.step + 1)
    aux = {
        "phi_norm": norm,
        "log_p_mean": jax.lax.pmean(
            jnp.mean(log_p_vals), particle_axis
        ),
        "h2": h2,
        "median": med,
    }
    return new_state, aux


def make_sharded2d_warm_step(log_p, unravel_fn, gd, n_particles, n_params,
                             state, mesh, particle_axis="particles",
                             model_axis="model", max_phi_norm=10.0,
                             remat=False, median_max_rows=512,
                             median_passes=30, warm_passes=8,
                             median_collectives="rounds",
                             median_grid_g1=8):
    """Warm-median variant of the 2-D step for the scan loops (api.run /
    train_on_batches): carry is (SVGDState, med_prev); the warm counts
    run on the already-psum'd local D rows, psum'd over the particle
    axis only — D_rows is replicated over the model axis, so every shard
    refines the same interval. RBF kernel only, mirroring the 1-D warm
    step. Returns (warm_step_fn, init_med_fn).

    ``median_collectives`` (r5): 'rounds' (default) is the quad-ary
    chain (ops/median.sharded_warm_bisect_median_on_D); 'grid' is the
    O(1)-collective search (ops/median.sharded_warm_grid_on_D — the
    fallback range comes free from the psum'd column norms, the grid
    counts are one fused XLA read, TWO batched psums total). Same
    width/2**warm_passes bound; throughput_config picks by particle-
    axis size exactly as on 1-D meshes."""
    from ..ops.median import (
        sharded_bisect_median_on_D,
        sharded_warm_bisect_median_on_D,
        sharded_warm_grid_on_D,
    )
    if median_collectives not in ("grid", "rounds"):
        raise ValueError(
            f"unknown median_collectives mode: {median_collectives!r}"
        )

    def log_p_flat(theta_row, batch):
        return log_p(unravel_fn(theta_row), batch)

    if remat:
        log_p_flat = jax.checkpoint(log_p_flat)

    grad_all = jax.vmap(jax.value_and_grad(log_p_flat), in_axes=(0, None))

    def spmd_warm_step(carry, batch):
        state, med_prev = carry
        if median_collectives == "grid":
            def compute_med(D_rows, rsq_cen):
                hi_bound = 4.0 * jnp.max(rsq_cen) * 1.0001 + 1e-30
                return sharded_warm_grid_on_D(
                    D_rows, med_prev, hi_bound, particle_axis,
                    max_rows=median_max_rows, warm_passes=warm_passes,
                    g1=median_grid_g1,
                )
        else:
            def compute_med(D_rows, rsq_cen):
                return sharded_warm_bisect_median_on_D(
                    D_rows, med_prev, particle_axis,
                    max_rows=median_max_rows, warm_passes=warm_passes,
                )
        new_state, aux = _core_step_2d(
            state, batch, compute_med,
            grad_all=grad_all, gd=gd, kernel=None,
            n_particles=n_particles, particle_axis=particle_axis,
            model_axis=model_axis, max_phi_norm=max_phi_norm,
        )
        med_carry = aux["median"].astype(state.particles.dtype)
        return (new_state, med_carry), aux

    state_specs = _state_specs_2d(
        state, n_particles, n_params, particle_axis, model_axis
    )
    carry_specs = (state_specs, P())
    aux_specs = {"phi_norm": P(), "log_p_mean": P(), "h2": P(), "median": P()}

    warm_step_fn = jax.shard_map(
        spmd_warm_step,
        mesh=mesh,
        in_specs=(carry_specs, P()),
        out_specs=(carry_specs, aux_specs),
        check_vma=False,
    )

    def init_spmd(theta_blk):
        # Cold seed: the same psum'd Gram D rows the step computes.
        theta_cols = jax.lax.all_gather(
            theta_blk, particle_axis, tiled=True
        )
        D_rows, _ = _d_rows_2d(theta_blk, theta_cols, model_axis)
        return sharded_bisect_median_on_D(
            D_rows, particle_axis, max_rows=median_max_rows,
            passes=median_passes,
        )

    init_med_fn = jax.jit(jax.shard_map(
        init_spmd, mesh=mesh,
        in_specs=P(particle_axis, model_axis), out_specs=P(),
        check_vma=False,
    ))
    return warm_step_fn, init_med_fn
