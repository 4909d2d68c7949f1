"""2-D (particles x model) sharded step vs single-device, on a 4x2 fake-CPU
mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from stein_jax import SVGDSampler, Adam
from stein_jax.api import SVGDState
from stein_jax.models import LinearRegressionModel
from stein_jax.parallel.sharded2d import make_sharded2d_step
from stein_jax.utils.ravel import template_unraveler

requires_8_devices = pytest.mark.usefixtures("eight_devices")


def _setup(n_particles=16, n_feats=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(40, n_feats))
    y = X @ rng.normal(size=(n_feats, 1)) + rng.normal(size=(40, 1)) * 0.3
    theta0 = rng.normal(size=(n_particles, n_feats)) * 0.01
    model = LinearRegressionModel(n_feats)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    return theta0, model, batch


@requires_8_devices
def test_2d_sharded_matches_single_device():
    theta0, model, batch = _setup()
    n, p = theta0.shape
    gd = Adam(learning_rate=1e-1, decay=0.999)
    n_params, unravel = template_unraveler(model.template(jnp.float64))
    assert n_params == p

    single = SVGDSampler(
        n_particles=n, log_p=model.log_p,
        param_template=model.template(jnp.float64), gd=gd,
        theta=jnp.asarray(theta0), dtype=jnp.float64,
    )

    mesh = Mesh(
        np.asarray(jax.devices()[:8]).reshape(4, 2), ("particles", "model")
    )
    state = SVGDState(
        particles=jnp.asarray(theta0),
        opt_state=gd.init((n, p), jnp.float64),
        step=jnp.zeros((), jnp.int32),
    )
    _, jitted, sh_state = make_sharded2d_step(
        log_p=model.log_p, unravel_fn=unravel, gd=gd,
        n_particles=n, n_params=p, state=state, mesh=mesh,
    )
    for t in range(5):
        single.train_on_batch(batch)
        sh_state, aux = jitted(sh_state, batch)
        np.testing.assert_allclose(
            np.asarray(sh_state.particles), single.samples,
            rtol=1e-9, atol=1e-12, err_msg=f"step {t}",
        )
    assert np.isfinite(float(aux["phi_norm"]))


def _mesh_4x2():
    return Mesh(
        np.asarray(jax.devices()[:8]).reshape(4, 2), ("particles", "model")
    )


@requires_8_devices
def test_2d_imq_matches_single_device():
    """Custom weights-kernel (IMQ) on a 2-D particles x model mesh must
    reproduce the single-device generic path (kernels.generic_svgd_phi) —
    the model-axis Gram psum and the two-matmul K/W contraction commute
    with the parameter sharding."""
    from stein_jax.kernels import InverseMultiquadricKernel
    theta0, model, batch = _setup()
    n, p = theta0.shape
    kern = InverseMultiquadricKernel(c=1.0, beta=-0.5)
    common = dict(
        n_particles=n, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64, kernel=kern,
    )
    single = SVGDSampler(gd=Adam(learning_rate=1e-1), **common)
    sharded = SVGDSampler(
        gd=Adam(learning_rate=1e-1), mesh=_mesh_4x2(), model_axis="model",
        **common,
    )
    for t in range(5):
        single.train_on_batch(batch)
        sharded.train_on_batch(batch)
        np.testing.assert_allclose(
            sharded.samples, single.samples, rtol=1e-9, atol=1e-12,
            err_msg=f"step {t}",
        )


@requires_8_devices
def test_2d_bisect_median_matches_single_device():
    """2-D gather-free bisect median (psum'd counts on the local D rows)
    tracks the single-device bisect trajectory."""
    theta0, model, batch = _setup()
    n, p = theta0.shape
    common = dict(
        n_particles=n, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64, median="bisect",
    )
    single = SVGDSampler(gd=Adam(learning_rate=1e-1), **common)
    sharded = SVGDSampler(
        gd=Adam(learning_rate=1e-1), mesh=_mesh_4x2(), model_axis="model",
        **common,
    )
    for _ in range(5):
        single.train_on_batch(batch)
        sharded.train_on_batch(batch)
    np.testing.assert_allclose(
        sharded.samples, single.samples, rtol=1e-6, atol=1e-10,
    )


@requires_8_devices
def test_2d_warm_median_matches_single_warm():
    """warm_median on a 2-D mesh: run()'s scan carries the previous
    median; the warm counts run on the psum'd local D rows
    (sharded_warm_bisect_median_on_D over the particle axis). Tracks the
    single-device warm trajectory to the same tolerance as the cold 2-D
    bisect path (the split-Gram psum reorders the D reduction)."""
    theta0, model, batch = _setup()
    n, p = theta0.shape
    common = dict(
        n_particles=n, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64, median="bisect",
        warm_median=True, warm_passes=8,
    )
    single = SVGDSampler(gd=Adam(learning_rate=1e-1), **common)
    # median_collectives='rounds': the single-device warm search IS the
    # quad-rounds structure, so that arm is the tight comparator; the
    # r5 'grid' arm is pinned against it by test_2d_grid_matches_rounds.
    sharded = SVGDSampler(
        gd=Adam(learning_rate=1e-1), mesh=_mesh_4x2(), model_axis="model",
        median_collectives="rounds", **common,
    )
    aux_s = single.run(batch, 6)
    aux_m = sharded.run(batch, 6)
    np.testing.assert_allclose(
        sharded.samples, single.samples, rtol=1e-6, atol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(aux_m["median"]), np.asarray(aux_s["median"]),
        rtol=1e-9,
    )


@requires_8_devices
def test_2d_exact_median_gather_guard():
    """median='exact' on a 2-D mesh refuses the n^2 all-gather beyond the
    per-device limit, pointing at 'bisect'."""
    rng = np.random.default_rng(0)
    n = 8192     # 8192^2 * 8 B (f64) = 512 MB/device > the 256 MB limit
    model = LinearRegressionModel(8)
    theta0 = rng.normal(size=(n, 8)) * 0.01
    with pytest.raises(ValueError, match="bisect"):
        SVGDSampler(
            n_particles=n, log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(), theta=jnp.asarray(theta0), dtype=jnp.float64,
            mesh=_mesh_4x2(), model_axis="model", median="exact",
        )


@requires_8_devices
def test_2d_unsupported_median_raises():
    theta0, model, batch = _setup()
    with pytest.raises(ValueError, match="2-D sharded median"):
        SVGDSampler(
            n_particles=theta0.shape[0], log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(), theta=jnp.asarray(theta0), dtype=jnp.float64,
            mesh=_mesh_4x2(), model_axis="model", median="binned",
        )


@requires_8_devices
def test_2d_aux_posterior_and_ksd():
    """The diagnostic surfaces (function_posterior, ksd, samples) work on
    a 2-D-sharded sampler — jit re-gathers the parameter shards for the
    per-particle evaluations."""
    theta0, model, batch = _setup()
    sharded = SVGDSampler(
        n_particles=theta0.shape[0], log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
        dtype=jnp.float64, mesh=_mesh_4x2(), model_axis="model",
    )
    aux = sharded.train_on_batch(batch)
    assert np.isfinite(float(aux["phi_norm"]))
    dist = sharded.function_posterior(model.predict, batch)
    assert dist.shape == (theta0.shape[0], batch["X"].shape[0])
    assert np.isfinite(float(sharded.ksd(batch)))
    assert sharded.samples.shape == theta0.shape


@requires_8_devices
def test_2d_sharded_divisibility_errors():
    theta0, model, batch = _setup(n_particles=16, n_feats=7)
    gd = Adam()
    n_params, unravel = template_unraveler(model.template(jnp.float64))
    mesh = Mesh(
        np.asarray(jax.devices()[:8]).reshape(4, 2), ("particles", "model")
    )
    state = SVGDState(
        particles=jnp.asarray(theta0),
        opt_state=gd.init(theta0.shape, jnp.float64),
        step=jnp.zeros((), jnp.int32),
    )
    with pytest.raises(ValueError):
        make_sharded2d_step(
            log_p=model.log_p, unravel_fn=unravel, gd=gd,
            n_particles=16, n_params=7, state=state, mesh=mesh,
        )


@requires_8_devices
def test_2d_grid_matches_rounds():
    """median_collectives='grid' on the 2-D mesh (r5): the O(1)-
    collective search on the psum'd D rows — step-1 medians agree with
    the rounds chain to the width/2**warm_passes bound (identical
    particles), trajectories to the bandwidth-perturbation class; and
    the lowered warm step's all-reduce budget is pinned: the median's
    contribution is TWO psums (grid) vs pmin/pmax + endpoint psum +
    the loop-resident round psum (rounds)."""
    theta0, model, batch = _setup()
    n, p = theta0.shape
    common = dict(
        n_particles=n, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64, median="bisect",
        warm_median=True, warm_passes=8, mesh=_mesh_4x2(),
        model_axis="model",
    )
    g = SVGDSampler(gd=Adam(learning_rate=1e-1),
                    median_collectives="grid", **common)
    aux_g = g.run(batch, 5)
    r = SVGDSampler(gd=Adam(learning_rate=1e-1),
                    median_collectives="rounds", **common)
    aux_r = r.run(batch, 5)
    np.testing.assert_allclose(
        float(np.asarray(aux_g["median"])[0]),
        float(np.asarray(aux_r["median"])[0]), rtol=3e-3,
    )
    np.testing.assert_allclose(g.samples, r.samples, rtol=2e-2,
                               atol=2e-4)

    def n_all_reduce(s):
        med0 = jnp.asarray(0.5, jnp.float64)
        txt = jax.jit(s._warm_step_fn).lower(
            (s.state, med0), batch
        ).as_text()
        return txt.count("all_reduce") + txt.count("all-reduce")

    # The 2-D step's non-median all-reduces: 2 D-row psums (the three
    # norm partials packed into ONE concatenated-vector psum + the
    # partial Gram — model axis; r5 review), the two-axis clip psums
    # (2), and the log_p pmean (1) = 5. Median: grid adds its 2
    # batched psums (7 total, straight-line); rounds adds the batched
    # [-lo,hi] pmax + the endpoint psum + the fori_loop-resident round
    # psum (8 textual, the loop one EXECUTING warm_passes//2 = 4
    # times: 11 executed vs grid's 7).
    assert n_all_reduce(g) == 7, n_all_reduce(g)
    assert n_all_reduce(r) == 8, n_all_reduce(r)


@requires_8_devices
def test_2d_grid_off_origin_bound_is_centered():
    """r5 review fix: the 2-D grid search's fallback range comes from
    CENTERED column norms — an off-origin cloud (||mean|| >> spread)
    must keep the grid arm's medians tracking the rounds arm (an
    uncentered bound is ||mean||^2-scale, parking the no-valid-bracket
    fallback at an inflated median it can never re-verify away from)."""
    theta0, model, batch = _setup()
    theta_off = np.asarray(theta0) + 100.0      # ||mean|| ~ 100x spread
    n, p = theta0.shape
    common = dict(
        n_particles=n, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta_off), dtype=jnp.float64,
        median="bisect", warm_median=True, warm_passes=8,
        mesh=_mesh_4x2(), model_axis="model",
    )
    g = SVGDSampler(gd=Adam(learning_rate=1e-1),
                    median_collectives="grid", **common)
    aux_g = g.run(batch, 5)
    r = SVGDSampler(gd=Adam(learning_rate=1e-1),
                    median_collectives="rounds", **common)
    aux_r = r.run(batch, 5)
    mg = np.asarray(aux_g["median"])
    mr = np.asarray(aux_r["median"])
    assert np.isfinite(mg).all()
    # Every step's grid median stays in the rounds median's class (the
    # uncentered-bound failure mode was orders of magnitude off).
    np.testing.assert_allclose(mg, mr, rtol=5e-2)
    np.testing.assert_allclose(g.samples, r.samples, rtol=2e-2,
                               atol=2e-4)


@requires_8_devices
def test_grid_warm_passes_unroll_guard():
    """r5 review fix: median_collectives='grid' unrolls its g2 pass
    (2**(warm_passes - log2(g1)) - 1 fused counts); an unbounded
    warm_passes must fail with a readable error instead of hanging
    compilation."""
    theta0, model, batch = _setup()
    n, p = theta0.shape
    s = SVGDSampler(
        n_particles=n, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64,
        median="bisect", warm_median=True, warm_passes=25,
        mesh=_mesh_4x2(), model_axis="model",
        median_collectives="grid", gd=Adam(learning_rate=1e-1),
    )
    with pytest.raises(ValueError, match="warm_passes"):
        s.run(batch, 1)
