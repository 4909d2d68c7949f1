"""Public SVGD sampler API.

Redesign of the reference's sampler layer
(stein/samplers/abstract_stein_sampler.py, stein_sampler.py): the reference
runs n per-particle session calls plus a host-side NumPy n x n matmul per
step (stein_sampler.py:59-68, abstract_stein_sampler.py:105); here the whole
step — per-particle gradients via vmap(value_and_grad), median bandwidth,
RBF kernel, SVGD direction, global norm clip, optimizer update — is ONE
jitted XLA program with donated state, so particles never leave the device.

Capability parity with the reference's public surface:
  SteinSampler(n_particles, log_p, gd, theta=None)  -> SVGDSampler(...)
  .train_on_batch(batch_feed)                        -> .train_on_batch(batch)
  .function_posterior(func, feed_dict, axis)         -> .function_posterior(...)
  .samples / .theta                                  -> .samples / .theta
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from .ops import rbf
from .ops.median import (
    exact_median,
    subsampled_sq_dist_median,
    binned_median,
    bisect_median,
)
from .utils.ravel import (
    template_unraveler,
    init_particles,
    unravel_particles,
)


from .utils.hostio import host_array, host_scalar  # noqa: E402  (re-export)


# Single-device median='exact' footprint above which the constructor warns
# (the sharded steps REFUSE at parallel/sharded.EXACT_MEDIAN_GATHER_LIMIT_
# BYTES; single-device keeps working — exact is the reference's bitwise
# semantics — but a defaults-user scaling n up should be told about
# median='bisect' / throughput_config). 2^27 B = 128 MB -> n > 5792 in f32.
EXACT_MEDIAN_WARN_BYTES = 2 ** 27


class SVGDState(NamedTuple):
    """Complete mutable state of the sampler — a checkpointable pytree."""

    particles: jnp.ndarray   # [n_particles, n_params]
    opt_state: Any           # optimizer pytree (ops/optimizers.py)
    step: jnp.ndarray        # scalar int32


def make_phi_fn(n_particles, median="exact", kernel_impl="xla",
                median_max_rows=512, binned_bins=4096, binned_block_rows=256,
                pallas_interpret=False, kernel=None, median_passes=30):
    """Build phi_fn(theta, grads) -> (phi, aux) for the requested backend.

    kernel_impl="xla": materialise the [n, n] kernel once; XLA fuses the
    distance/exp elementwise work into surrounding ops and the attractive +
    repulsive products run as one contraction (ops/rbf.py).
    kernel_impl="pallas": the opt-in streaming tile that never
    materialises D or K in device memory (ops/pallas_svgd.py), with its
    Gram in TF32.
    """
    if median == "exact":
        median_fn = lambda theta: exact_median(rbf.pairwise_sq_dists(theta))
    elif median == "subsample":
        median_fn = lambda theta: subsampled_sq_dist_median(
            theta, max_rows=median_max_rows
        )
    elif median == "bisect":
        median_fn = lambda theta: bisect_median(
            theta, max_rows=median_max_rows, passes=median_passes
        )
    elif median == "binned":
        median_fn = lambda theta: binned_median(
            theta, n_bins=binned_bins, block_rows=binned_block_rows
        )
    else:
        raise ValueError(f"unknown median mode: {median!r}")

    # The XLA paths materialise D for the kernel anyway; bisect counts
    # run directly on (a strided row subsample of) that D instead of
    # recomputing a distance block — saving a HIGHEST-precision Gram
    # matmul per step (ops/median.bisect_median_on_D).
    from .ops.median import bisect_median_on_D

    def bisect_on_D(D):
        return bisect_median_on_D(
            D, max_rows=median_max_rows, passes=median_passes
        )

    if kernel is not None:
        # Pluggable non-RBF kernel (stein_jax.kernels): generic two-matrix
        # XLA path.
        from .kernels import SquaredExponentialKernel, generic_svgd_phi
        # Exact-type check: a SquaredExponentialKernel SUBCLASS may
        # override weights(), so only the exact class takes the fused
        # RBF path — anything else would silently sample the wrong
        # posterior geometry.
        if type(kernel) is not SquaredExponentialKernel:
            if kernel_impl != "xla":
                raise ValueError(
                    "kernel_impl='pallas' supports only the RBF kernel; "
                    "use kernel_impl='xla' for custom kernels"
                )
            if median == "bisect":
                return lambda theta, grads: generic_svgd_phi(
                    kernel, theta, grads, median_fn=bisect_on_D
                )

            def phi_fn(theta, grads):
                med = median_fn(theta)
                return generic_svgd_phi(
                    kernel, theta, grads, median_fn=lambda D: med
                )
            return phi_fn

    if kernel_impl == "xla":
        if median == "exact":
            # Reuse the materialised D for the median (no second distance
            # computation).
            return lambda theta, grads: rbf.svgd_phi(
                theta, grads, median_fn=exact_median
            )
        if median == "bisect":
            return lambda theta, grads: rbf.svgd_phi(
                theta, grads, median_fn=bisect_on_D
            )

        def phi_fn(theta, grads):
            med = median_fn(theta)
            return rbf.svgd_phi(theta, grads, median_fn=lambda D: med)
        return phi_fn
    elif kernel_impl == "pallas":
        if median == "exact":
            raise ValueError(
                "kernel_impl='pallas' streams the kernel matrix precisely "
                "to avoid materialising the n^2 distance matrix, but "
                "median='exact' would materialise it anyway — use "
                "median='bisect' (recommended), 'subsample', or 'binned', "
                "or kernel_impl='xla' for the exact median"
            )
        from .ops.pallas_svgd import pallas_svgd_phi

        def phi_fn(theta, grads):
            med = median_fn(theta)
            h2 = rbf.bandwidth_sq_from_median(med, n_particles)
            phi = pallas_svgd_phi(theta, grads, h2,
                                  interpret=pallas_interpret)
            return phi, {"h2": h2, "median": med}

        return phi_fn
    raise ValueError(f"unknown kernel_impl: {kernel_impl!r}")


def make_warm_phi_fn(n_particles, kernel_impl="xla", median_max_rows=512,
                     median_passes=30, warm_passes=8,
                     pallas_interpret=False):
    """phi_fn variant threading the previous step's median through the
    scan: phi_fn(theta, grads, med_prev) -> (phi, aux); aux['median'] is
    the hint for the next step (ops/median.warm_bisect_median, branchless).
    The returned function carries ``init_med(theta)`` — a full cold bisect
    used to seed the scan carry, so the in-scan warm search never runs
    from a cold (full-range) interval."""
    from .ops.median import _strided_rows, _warm_search, warm_bisect_median

    def init_med(theta):
        return bisect_median(
            theta, max_rows=median_max_rows, passes=median_passes
        )

    if kernel_impl == "pallas":
        from .ops.pallas_svgd import pallas_svgd_phi

        def phi_fn(theta, grads, med_prev):
            med = warm_bisect_median(
                theta, med_prev, max_rows=median_max_rows,
                warm_passes=warm_passes,
            )
            h2 = rbf.bandwidth_sq_from_median(med, n_particles)
            phi = pallas_svgd_phi(theta, grads, h2,
                                  interpret=pallas_interpret)
            return phi, {"h2": h2, "median": med}
        phi_fn.init_med = init_med
        return phi_fn

    def phi_fn(theta, grads, med_prev):
        # XLA path: run the warm search on the strided rows of the D the
        # kernel materialises anyway.
        def median_fn(D):
            return _warm_search(
                _strided_rows(D, median_max_rows), med_prev, warm_passes
            )
        return rbf.svgd_phi(theta, grads, median_fn=median_fn)
    phi_fn.init_med = init_med
    return phi_fn


def _make_grad_all(log_p, unravel_fn, remat, custom_grads=None):
    """vmap(value_and_grad) over flat particle rows — THE gradient stage
    shared by every step builder (remat rematerialises the log_p forward
    in the backward, jax.checkpoint). ``custom_grads`` (a callable
    (theta [n, p], batch) -> (logp_vals [n], grads [n, p])) replaces the
    autodiff stage entirely, for models that supply their own
    gradients."""
    if custom_grads is not None:
        if remat:
            raise ValueError(
                "custom_grads= supplies its own gradient computation; "
                "remat=True (checkpointed autodiff) does not apply — "
                "drop one of the two"
            )
        return custom_grads

    def log_p_flat(theta_row, batch):
        return log_p(unravel_fn(theta_row), batch)

    if remat:
        log_p_flat = jax.checkpoint(log_p_flat)

    return jax.vmap(jax.value_and_grad(log_p_flat), in_axes=(0, None))


def make_step_fn(log_p, unravel_fn, gd, phi_fn, max_phi_norm=10.0,
                 remat=False, custom_grads=None):
    """Build the pure SVGD step: (state, batch) -> (state, aux).

    Collapses the reference's stack-3.2 hot path
    (abstract_stein_sampler.py:107-127 + stein_sampler.py:50-71) into one
    traced function. ``remat=True`` rematerialises the log-posterior
    forward pass in the backward (jax.checkpoint) — trades FLOPs for HBM
    when the model's activations x n_particles would not fit.
    """

    grad_all = _make_grad_all(log_p, unravel_fn, remat, custom_grads)

    def step_fn(state, batch):
        theta = state.particles
        log_p_vals, grads = grad_all(theta, batch)
        phi, kaux = phi_fn(theta, grads)
        # Global norm clip: phi *= c / max(c, ||phi||_F)
        # (abstract_stein_sampler.py:125).
        norm = jnp.sqrt(jnp.sum(phi * phi))
        c = jnp.asarray(max_phi_norm, theta.dtype)
        phi = phi * (c / jnp.maximum(c, norm))
        delta, opt_state = gd.update(state.opt_state, phi)
        new_state = SVGDState(theta + delta, opt_state, state.step + 1)
        aux = {
            "phi_norm": norm,
            "log_p_mean": jnp.mean(log_p_vals),
            **kaux,
        }
        return new_state, aux

    return step_fn


def make_warm_step_fn(log_p, unravel_fn, gd, warm_phi_fn,
                      max_phi_norm=10.0, remat=False, custom_grads=None):
    """Scan-carried step for warm-median sampling: carry is
    (SVGDState, med_prev)."""

    grad_all = _make_grad_all(log_p, unravel_fn, remat, custom_grads)

    def step_fn(carry, batch):
        state, med_prev = carry
        theta = state.particles
        log_p_vals, grads = grad_all(theta, batch)
        phi, kaux = warm_phi_fn(theta, grads, med_prev)
        norm = jnp.sqrt(jnp.sum(phi * phi))
        c = jnp.asarray(max_phi_norm, theta.dtype)
        phi = phi * (c / jnp.maximum(c, norm))
        delta, opt_state = gd.update(state.opt_state, phi)
        new_state = SVGDState(theta + delta, opt_state, state.step + 1)
        aux = {
            "phi_norm": norm,
            "log_p_mean": jnp.mean(log_p_vals),
            **kaux,
        }
        return (new_state, kaux["median"]), aux

    return step_fn


def throughput_config(n_particles, n_params, mesh=None, model_axis=None,
                      dtype=jnp.float32):
    """Sampler options for production throughput, chosen from what the
    code can observe — n, p, dtype and mesh — as a kwargs dict to splat
    into SVGDSampler next to the model arguments:

        cfg = throughput_config(n, p)
        sampler = SVGDSampler(n, log_p, template, gd, **cfg)

    Every configuration takes the sort-free bisect median with the
    scan-carried warm search (use the scan APIs: run / train_on_batches /
    train_minibatched). At n >= 4096 the median counts over 128 strided
    rows. Every configuration keeps the XLA phi path, whose Gram runs at
    full f32: the streaming tile (kernel_impl="pallas") is faster at
    large n only with its Gram in TF32, and with a full-f32 Gram it was
    slower at every shape measured (PERF.md), so it stays an opt-in.
    ``model_axis`` selects the 2-D (particles x model) mesh step, whose
    warm median uses the two-collective grid search when the particle
    axis has more than one device."""
    del n_params  # no option depends on it since the tile left the default
    cfg = dict(median="bisect", warm_median=True, dtype=dtype)
    if n_particles >= 4096:
        cfg["median_max_rows"] = 128
    if mesh is None:
        return cfg
    cfg["mesh"] = mesh
    if model_axis is not None:
        cfg["model_axis"] = model_axis
        n_p_dev = 1
        for ax in mesh.axis_names:
            if ax != model_axis:
                n_p_dev *= mesh.shape[ax]
        cfg["median_collectives"] = "rounds" if n_p_dev == 1 else "grid"
    return cfg


class SVGDSampler:
    """Stein variational gradient descent as one jitted device program.

    Parameters
    ----------
    n_particles : number of posterior samples to evolve.
    log_p : callable (params_pytree, batch) -> scalar log-posterior (up to an
        additive constant). Replaces the reference's TF graph contract
        (abstract_stein_sampler.py:32-36).
    param_template : pytree of arrays giving parameter shapes/dtypes — the
        analogue of the reference's "model"-scope variable collection
        (abstract_stein_sampler.py:49-51). Dict keys flatten in sorted order,
        matching converters.py:40's deterministic layout.
    gd : step rule from stein_jax.ops.optimizers (Adam / Adagrad).
    key : PRNG key for particle init (ignored when ``theta`` given).
    theta : optional initial particles — an [n, p] matrix or a pytree of
        [n, *shape] leaves matching ``param_template``.
    dtype : particle/compute dtype (float32 default).
    median : "exact" | "subsample" | "bisect" | "binned" bandwidth median.
        "exact" is the reference semantics (sorts the full D every step);
        "bisect" is the sort-free path (exact to fp resolution on a
        strided row subsample); "binned" is the streaming psum-able
        histogram used distributed.
    kernel_impl : "xla" | "pallas". "pallas" is the streaming tile that
        never materialises D or K (ops/pallas_svgd.py, Pallas through
        Triton), on one device; it requires the RBF kernel and a median
        mode that does not materialise D, i.e. not "exact". Both its
        products run in TF32 (its Gram on centred particles), where the
        XLA path keeps the Gram at full f32.
    pallas_interpret : run the tile in Pallas interpret mode (tests on
        the CPU only).
    custom_grads : optional callable (theta [n, p], batch) ->
        (logp_vals [n], grads [n, p]) REPLACING the vmap-autodiff
        gradient stage, for models that supply their own gradients.
        Incompatible with remat. Runs on 1-D particle meshes too:
        gradients are per-particle, so the hook applies to each shard's
        [n_loc, p] block unchanged. 2-D meshes refuse (the parameter
        dimension is sharded there).
    binned_bins / binned_block_rows : tuning for median="binned".
    mesh / particle_axis : optional jax.sharding.Mesh for particle-sharded
        multi-device execution (stein_jax.parallel), on the XLA phi path
        (kernel_impl="xla"). Custom ``kernel`` objects are supported on
        1-D particle meshes (both comm modes) and 2-D particles x model
        meshes. The 2-D mesh supports
        median="exact" (guarded by the per-device gather ceiling) and
        "bisect", on the XLA path.
    model_axis : optional second mesh axis name to additionally shard the
        parameter dimension (stein_jax.parallel.sharded2d).
    comm : "all_gather" | "ring" block exchange for the 1-D sharded step.
    remat : rematerialise log_p's forward in the backward (jax.checkpoint).
    warm_median / warm_passes : opt-in fast path for the scan loops
        (run / train_on_batches / train_minibatched): carry the previous
        step's median through the scan and refine it inside a
        count-verified tight bracket (ops/median.warm_bisect_median,
        branchless) — a cheaper median with bounded bandwidth error
        (~0.17*med/4^ceil(warm_passes/2) per step, re-verified every
        step so it never accumulates). Requires median='bisect' and the
        default RBF kernel; on meshes the warm counts psum across shards.
        Off by default so run(k) stays bit-equal to k train_on_batch
        calls.
    median_collectives : "grid" (default) | "rounds" — collective
        structure of the 2-D mesh's warm median. 'grid' takes two
        batched psums per median (ops/median.sharded_warm_from_grid);
        'rounds' takes one psum per quad-ary round. Ignored elsewhere.
    median_grid_g1 : power-of-two edges per candidate bracket of the
        grid search's first pass (default 8); g2 = 2**warm_passes / g1.
        Ignored unless median_collectives='grid'.
    """

    def __init__(self, n_particles, log_p, param_template, gd,
                 key=None, theta=None, dtype=jnp.float32,
                 median="exact", kernel_impl="xla", median_max_rows=512,
                 max_phi_norm=10.0, mesh=None, particle_axis="particles",
                 donate=True, pallas_interpret=False,
                 model_axis=None, comm="all_gather", remat=False,
                 kernel=None, binned_bins=4096, binned_block_rows=256,
                 median_passes=30, warm_median=False, warm_passes=8,
                 custom_grads=None, median_collectives="grid",
                 median_grid_g1=8):
        self.n_particles = int(n_particles)
        if self.n_particles < 2:
            # With one particle the median bandwidth is 0/log(1) = 0/0 — the
            # reference would silently produce NaNs; fail loudly instead.
            raise ValueError(
                "SVGD needs n_particles >= 2 (the median-heuristic bandwidth "
                "h^2 = median(D)/log(n) is undefined for n=1)"
            )
        if kernel is not None:
            from .kernels import SquaredExponentialKernel
            # Exact-type normalization: an explicit SquaredExponentialKernel
            # IS the default kernel, so every dispatch (fused RBF paths,
            # warm_median guards) treats it as kernel=None. Subclasses may
            # override weights() and stay on the generic path.
            if type(kernel) is SquaredExponentialKernel:
                kernel = None
        self.log_p = log_p
        self.gd = gd
        self.dtype = dtype
        self.mesh = mesh
        self.particle_axis = particle_axis
        self.n_params, self.unravel_fn = template_unraveler(
            param_template, dtype
        )

        if theta is not None:
            if not isinstance(theta, jnp.ndarray) or theta.ndim != 2:
                from .utils.ravel import ravel_particles
                theta = ravel_particles(
                    jax.tree_util.tree_map(
                        lambda x: jnp.asarray(x, dtype), theta
                    )
                )
            # Copy: the jitted step donates the state buffers, and the
            # caller's array must survive (and may be shared across
            # samplers).
            theta0 = jnp.array(theta, dtype, copy=True)
            if theta0.shape != (self.n_particles, self.n_params):
                raise ValueError(
                    f"theta shape {theta0.shape} != "
                    f"{(self.n_particles, self.n_params)}"
                )
        else:
            if key is None:
                key = jax.random.PRNGKey(0)
            theta0 = init_particles(
                key, self.n_particles, self.n_params, dtype
            )

        opt_state = gd.init(theta0.shape, dtype)
        state = SVGDState(theta0, opt_state, jnp.zeros((), jnp.int32))

        if kernel_impl not in ("xla", "pallas"):
            raise ValueError(f"unknown kernel_impl: {kernel_impl!r}")
        if warm_median and (median != "bisect" or kernel is not None):
            raise ValueError(
                "warm_median=True requires median='bisect' and "
                "the default RBF kernel"
            )
        self._donate = bool(donate)
        self._warm_step_fn = None
        if mesh is None:
            if median == "exact":
                # Mirror of the mesh gather guard (parallel/sharded.py:
                # check_exact_median_gather): the reference-faithful default
                # materialises AND SORTS the full [n, n] distance matrix
                # every step (compute_median.py:4-16 semantics). Warn
                # instead of raise: exact IS the documented bitwise
                # semantics and stays available on purpose.
                import warnings
                itemsize = jnp.dtype(dtype).itemsize
                d_bytes = self.n_particles ** 2 * itemsize
                if d_bytes > EXACT_MEDIAN_WARN_BYTES:
                    warnings.warn(
                        f"median='exact' sorts the full "
                        f"[{self.n_particles}, {self.n_particles}] distance "
                        f"matrix every step ({d_bytes / 2**20:.0f} MB). Use "
                        "median='bisect' (exact to fp-bisection resolution "
                        "on a strided row subsample) or splat "
                        "stein_jax.throughput_config(n, p).",
                        stacklevel=2,
                    )
            phi_fn = make_phi_fn(
                self.n_particles, median=median, kernel_impl=kernel_impl,
                median_max_rows=median_max_rows,
                pallas_interpret=pallas_interpret, kernel=kernel,
                binned_bins=binned_bins, binned_block_rows=binned_block_rows,
                median_passes=median_passes,
            )
            self._step_fn = make_step_fn(
                log_p, self.unravel_fn, gd, phi_fn,
                max_phi_norm=max_phi_norm, remat=remat,
                custom_grads=custom_grads,
            )
            self._jit_step = jax.jit(
                self._step_fn, donate_argnums=(0,) if donate else ()
            )
            self.state = state
            # Opt-in warm-median fast path for the scan-based loops
            # (run / train_on_batches): carries the previous median so
            # each step needs ~warm_passes bisections instead of a cold
            # search. Off by default so run(k) stays bit-equal to k
            # train_on_batch calls.
            if warm_median:
                warm_phi = make_warm_phi_fn(
                    self.n_particles, kernel_impl=kernel_impl,
                    median_max_rows=median_max_rows,
                    median_passes=median_passes,
                    warm_passes=warm_passes,
                    pallas_interpret=pallas_interpret,
                )
                self._warm_step_fn = make_warm_step_fn(
                    log_p, self.unravel_fn, gd, warm_phi,
                    max_phi_norm=max_phi_norm, remat=remat,
                    custom_grads=custom_grads,
                )
                self._warm_init_med = warm_phi.init_med
        elif kernel_impl != "xla":
            raise ValueError(
                "meshes run the XLA phi path: the streaming tile is for "
                "one device; use kernel_impl='xla'"
            )
        elif model_axis is not None:
            # Options the sharded steps cannot honour must fail loudly,
            # not silently fall back (a custom kernel silently replaced
            # by RBF would sample the wrong posterior geometry).
            if custom_grads is not None:
                raise ValueError(
                    "custom_grads= runs on 1-D particle meshes only: "
                    "on a 2-D (particles x model) mesh the parameter "
                    "dimension is sharded too, and the hook's contract "
                    "is full [n, p] rows"
                )
            from .parallel.sharded2d import (
                make_sharded2d_step,
                make_sharded2d_warm_step,
            )
            self._step_fn, self._jit_step, self.state = \
                make_sharded2d_step(
                    log_p=log_p, unravel_fn=self.unravel_fn, gd=gd,
                    n_particles=self.n_particles,
                    n_params=self.n_params,
                    state=state, mesh=mesh, particle_axis=particle_axis,
                    model_axis=model_axis, max_phi_norm=max_phi_norm,
                    donate=donate, remat=remat, median=median,
                    median_max_rows=median_max_rows,
                    median_passes=median_passes, kernel=kernel,
                )
            if warm_median:
                self._warm_step_fn, self._warm_init_med = \
                    make_sharded2d_warm_step(
                        log_p=log_p, unravel_fn=self.unravel_fn,
                        gd=gd, n_particles=self.n_particles,
                        n_params=self.n_params, state=state, mesh=mesh,
                        particle_axis=particle_axis,
                        model_axis=model_axis,
                        max_phi_norm=max_phi_norm, remat=remat,
                        median_max_rows=median_max_rows,
                        median_passes=median_passes,
                        warm_passes=warm_passes,
                        median_collectives=median_collectives,
                        median_grid_g1=median_grid_g1,
                    )
        else:
            from .parallel.sharded import (
                make_sharded_step,
                make_sharded_warm_step,
            )
            self._step_fn, self._jit_step, self.state = make_sharded_step(
                log_p=log_p, unravel_fn=self.unravel_fn, gd=gd,
                n_particles=self.n_particles, state=state, mesh=mesh,
                particle_axis=particle_axis, median=median,
                max_phi_norm=max_phi_norm, donate=donate, comm=comm,
                binned_bins=binned_bins,
                binned_block_rows=binned_block_rows, remat=remat,
                median_max_rows=median_max_rows,
                median_passes=median_passes, kernel=kernel,
                custom_grads=custom_grads,
            )
            if warm_median:
                self._warm_step_fn, self._warm_init_med = \
                    make_sharded_warm_step(
                        log_p=log_p, unravel_fn=self.unravel_fn,
                        gd=gd, n_particles=self.n_particles,
                        state=state, mesh=mesh,
                        particle_axis=particle_axis,
                        max_phi_norm=max_phi_norm, remat=remat,
                        median_max_rows=median_max_rows,
                        median_passes=median_passes,
                        warm_passes=warm_passes,
                        comm=comm,
                        custom_grads=custom_grads,
                    )

        self._posterior_cache = {}
        self._jit_run = None
        self._jit_multi = None
        self._jit_ksd = None

    # ------------------------------------------------------------------ API

    def train_on_batch(self, batch):
        """Run one SVGD step on a batch (pytree of arrays). Returns aux
        diagnostics (device scalars): phi_norm (pre-clip), log_p_mean,
        bandwidth^2, median."""
        self.state, aux = self._jit_step(self.state, batch)
        return aux

    def run(self, batch, n_steps):
        """Run ``n_steps`` full-batch SVGD steps in ONE device dispatch
        (lax.scan over the step), amortising host->device launch latency —
        the replacement for the reference's per-step Python loop
        (examples/linear_regression/main.py:42-48). Returns aux with a
        leading [n_steps] axis."""
        if self._jit_run is None:
            if self._warm_step_fn is not None:
                def multi(state, batch, n):
                    # Seed the carry with a full cold median so the
                    # in-scan warm search starts from a verified bracket.
                    med0 = self._warm_init_med(state.particles).astype(
                        state.particles.dtype
                    )
                    (s, _), aux = jax.lax.scan(
                        lambda c, _: self._warm_step_fn(c, batch),
                        (state, med0), None, length=n,
                    )
                    return s, aux
            else:
                def multi(state, batch, n):
                    return jax.lax.scan(
                        lambda s, _: self._step_fn(s, batch), state, None,
                        length=n,
                    )
            self._jit_run = jax.jit(
                multi, static_argnums=(2,),
                donate_argnums=(0,) if self._donate else (),
            )
        self.state, aux = self._jit_run(self.state, batch, int(n_steps))
        return aux

    def train_on_batches(self, batches):
        """Run one SVGD step per stacked minibatch in ONE device dispatch:
        ``batches`` is a pytree whose leaves have a leading [k] axis (k
        minibatches, e.g. pre-sampled indices of a dataset). Returns aux
        with a leading [k] axis."""
        if self._jit_multi is None:
            if self._warm_step_fn is not None:
                def multi(state, batches):
                    med0 = self._warm_init_med(state.particles).astype(
                        state.particles.dtype
                    )
                    (s, _), aux = jax.lax.scan(
                        self._warm_step_fn, (state, med0), batches
                    )
                    return s, aux
            else:
                def multi(state, batches):
                    return jax.lax.scan(self._step_fn, state, batches)
            self._jit_multi = jax.jit(
                multi, donate_argnums=(0,) if self._donate else ()
            )
        self.state, aux = self._jit_multi(self.state, batches)
        return aux

    def train_minibatched(self, data, n_steps, n_batch, key):
        """Run ``n_steps`` minibatch SVGD steps in ONE device dispatch
        with ON-DEVICE index sampling: ``data`` is the full dataset
        pytree (leaves [n_rows, ...]) resident in HBM; every scanned
        step derives its PRNG key from ``key`` (jax.random.fold_in on
        the step index), draws ``n_batch`` uniform row indices, and
        gathers its minibatch inside the scan — no host RNG, no
        [k, n_batch, ...] staging through host memory, no per-chunk
        re-dispatch. This is the full-scale epoch loop for datasets
        like the real 581k-row Covertype (the reference re-feeds a host
        -sampled batch per session call, logistic_regression/
        main.py:72-79; pre-sampling index MATRICES per chunk —
        train_on_batches — still moves O(k x n_batch x n_feats) through
        the host at that scale).

        Sampling semantics: uniform WITH replacement
        (jax.random.randint). The reference uses np.random.choice(...,
        replace=False); drawing 50 of ~465k rows collides with
        probability ~0.3% per step, statistically invisible — while an
        on-device without-replacement draw costs a full n_rows sort
        (jax.random.choice) per step. Documented trade, pinned by
        tests/test_sampler.py::test_train_minibatched.

        Returns aux with a leading [n_steps] axis."""
        n_rows = jax.tree_util.tree_leaves(data)[0].shape[0]
        cache_key = (int(n_steps), int(n_batch), n_rows)
        if getattr(self, "_jit_mb_key", None) != cache_key:
            n_steps_c, n_batch_c = int(n_steps), int(n_batch)

            def draw(data, key, i):
                idx = jax.random.randint(
                    jax.random.fold_in(key, i), (n_batch_c,), 0, n_rows
                )
                return jax.tree_util.tree_map(lambda l: l[idx], data)

            if self._warm_step_fn is not None:
                def multi(state, data, key):
                    med0 = self._warm_init_med(state.particles).astype(
                        state.particles.dtype
                    )
                    (s, _), aux = jax.lax.scan(
                        lambda c, i: self._warm_step_fn(
                            c, draw(data, key, i)
                        ),
                        (state, med0), jnp.arange(n_steps_c),
                    )
                    return s, aux
            else:
                def multi(state, data, key):
                    return jax.lax.scan(
                        lambda s, i: self._step_fn(s, draw(data, key, i)),
                        state, jnp.arange(n_steps_c),
                    )
            self._jit_mb = jax.jit(
                multi, donate_argnums=(0,) if self._donate else ()
            )
            self._jit_mb_key = cache_key
        self.state, aux = self._jit_mb(self.state, data, key)
        return aux

    @property
    def samples(self):
        """[n_particles, n_params] particle matrix (reference:
        stein_sampler.py:73-78). On a multi-controller mesh the full
        matrix is assembled with a cross-process allgather."""
        return host_array(self.state.particles)

    @property
    def theta(self):
        """Particles as a pytree of [n_particles, *shape] leaves (the
        reference's theta dict, abstract_stein_sampler.py:66-74)."""
        return unravel_particles(self.state.particles, self.unravel_fn)

    def ksd(self, batch, u_statistic=False):
        """Kernel Stein discrepancy of the current particles w.r.t. the
        target defined by log_p on ``batch`` — a quantitative convergence
        diagnostic (smaller = closer to stationarity). One jitted device
        call (scores + KSD matmuls). On sharded samplers the particles
        stay sharded and GSPMD inserts the gather the [n, n] KSD
        matmuls need (an [n, p] all-gather — the same volume as one
        training step's collective; value pinned against the
        single-device ksd by tests/test_sharded.py and
        test_sharded2d.py)."""
        if self._jit_ksd is None:
            from .ops.diagnostics import ksd_rbf

            def compute(theta, b, u):
                def log_p_flat(row, bb):
                    return self.log_p(self.unravel_fn(row), bb)
                grads = jax.vmap(
                    jax.grad(log_p_flat), in_axes=(0, None)
                )(theta, b)
                return ksd_rbf(theta, grads, u_statistic=u)
            self._jit_ksd = jax.jit(compute, static_argnums=(2,))
        return host_scalar(
            self._jit_ksd(self.state.particles, batch, u_statistic)
        )

    def save(self, path):
        """Checkpoint the full sampler state (particles, optimizer moments,
        decayed lr, step count) to ``path``."""
        from .utils.checkpoint import save_checkpoint
        save_checkpoint(path, self.state)

    def restore(self, path):
        """Restore state saved by ``save``; sharding-aware (leaves are
        placed back with the current state's shardings)."""
        from .utils.checkpoint import restore_checkpoint
        self.state = restore_checkpoint(path, self.state)

    def function_posterior(self, func, batch, axis=None):
        """Posterior of ``func(params, batch) -> array`` over the particles
        (reference: abstract_stein_sampler.py:129-168). Returns [n, size]
        samples, or their mean over ``axis`` if given — one device call
        instead of the reference's n session round-trips."""
        fn = self._posterior_cache.get(func)
        if fn is None:
            def per_particle(theta_row, b):
                return jnp.ravel(func(self.unravel_fn(theta_row), b))
            fn = jax.jit(jax.vmap(per_particle, in_axes=(0, None)))
            self._posterior_cache[func] = fn
        dist = fn(self.state.particles, batch)
        if axis is not None:
            return host_array(dist.mean(axis=axis))
        return host_array(dist)


# Reference-compatible alias (stein/samplers/__init__.py:1).
SteinSampler = SVGDSampler
