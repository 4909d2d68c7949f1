"""Sharded-step tests on 8 fake CPU devices: the particle-sharded SPMD step
must reproduce the single-device step (and hence the NumPy oracle) within
floating-point tolerance, per SURVEY.md §4(d)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stein_jax import SVGDSampler, Adam, Adagrad
from stein_jax.models import LinearRegressionModel, BayesianNNModel
from stein_jax.parallel import particle_mesh


requires_8_devices = pytest.mark.usefixtures("eight_devices")


def _linreg(seed=0, n_obs=40, n_feats=3, n_particles=16):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, n_feats))
    y = X @ (rng.normal(size=(n_feats, 1)) * 2.0) + rng.normal(
        size=(n_obs, 1)
    ) * 0.3
    theta0 = rng.normal(size=(n_particles, n_feats)) * 0.01
    model = LinearRegressionModel(n_feats)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    return theta0, model, batch


def _make_pair(theta0, model, gd_factory, mesh, **kwargs):
    common = dict(
        n_particles=theta0.shape[0],
        log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0),
        dtype=jnp.float64,
    )
    single = SVGDSampler(gd=gd_factory(), **common, **kwargs)
    sharded = SVGDSampler(gd=gd_factory(), mesh=mesh, **common, **kwargs)
    return single, sharded


@requires_8_devices
@pytest.mark.parametrize("gd_factory", [
    lambda: Adam(learning_rate=1e-1),
    lambda: Adagrad(learning_rate=1e-1),
])
def test_sharded_matches_single_device(gd_factory):
    theta0, model, batch = _linreg()
    mesh = particle_mesh(jax.devices()[:8])
    single, sharded = _make_pair(theta0, model, gd_factory, mesh)
    for t in range(5):
        single.train_on_batch(batch)
        sharded.train_on_batch(batch)
        np.testing.assert_allclose(
            sharded.samples, single.samples, rtol=1e-9, atol=1e-12,
            err_msg=f"step {t}",
        )


@requires_8_devices
def test_sharded_binned_median_close():
    theta0, model, batch = _linreg(n_particles=64)
    mesh = particle_mesh(jax.devices()[:8])
    single, sharded = _make_pair(
        theta0, model, lambda: Adam(learning_rate=1e-1), mesh,
        median="binned",
    )
    # single uses exact median; binned sharded should track it closely.
    for _ in range(5):
        single.train_on_batch(batch)
        sharded.train_on_batch(batch)
    np.testing.assert_allclose(
        sharded.samples, single.samples, rtol=1e-3, atol=1e-8
    )


@requires_8_devices
def test_sharded_aux_and_function_posterior():
    theta0, model, batch = _linreg()
    mesh = particle_mesh(jax.devices()[:8])
    sharded = SVGDSampler(
        n_particles=theta0.shape[0],
        log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1),
        theta=jnp.asarray(theta0),
        dtype=jnp.float64,
        mesh=mesh,
    )
    aux = sharded.train_on_batch(batch)
    assert np.isfinite(float(aux["phi_norm"]))
    dist = sharded.function_posterior(model.predict, batch)
    assert dist.shape == (theta0.shape[0], batch["X"].shape[0])


@requires_8_devices
def test_sharded_bayesian_nn_matches_single():
    """Pytree-structured particles through the sharded path."""
    rng = np.random.default_rng(2)
    n_particles = 8
    X = rng.uniform(size=(20, 1))
    y = np.cos(10 * X) * (5 * X) + rng.normal(size=(20, 1)) * 0.1
    model = BayesianNNModel(1, 16, 20, 20)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    from stein_jax.utils.ravel import template_unraveler
    n_params, _ = template_unraveler(model.template(jnp.float64))
    theta0 = rng.normal(size=(n_particles, n_params)) * 0.01
    mesh = particle_mesh(jax.devices()[:8])
    single, sharded = _make_pair(
        theta0, model, lambda: Adam(learning_rate=1e-1, decay=0.999), mesh
    )
    for _ in range(5):
        single.train_on_batch(batch)
        sharded.train_on_batch(batch)
    np.testing.assert_allclose(
        sharded.samples, single.samples, rtol=1e-8, atol=1e-11
    )


@requires_8_devices
def test_nondivisible_particles_raises():
    theta0, model, batch = _linreg(n_particles=12)
    mesh = particle_mesh(jax.devices()[:8])
    with pytest.raises(ValueError):
        SVGDSampler(
            n_particles=12,
            log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(),
            theta=jnp.asarray(theta0),
            dtype=jnp.float64,
            mesh=mesh,
        )


@requires_8_devices
def test_ring_comm_matches_all_gather():
    """comm='ring' (ppermute block circulation + ring histogram median)
    tracks the all_gather path with the same binned median."""
    theta0, model, batch = _linreg(n_particles=64)
    mesh = particle_mesh(jax.devices()[:8])
    common = dict(
        n_particles=theta0.shape[0], log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64, mesh=mesh,
        median="binned",
    )
    a = SVGDSampler(gd=Adam(learning_rate=1e-1), comm="all_gather", **common)
    b = SVGDSampler(gd=Adam(learning_rate=1e-1), comm="ring", **common)
    for _ in range(5):
        a.train_on_batch(batch)
        b.train_on_batch(batch)
    np.testing.assert_allclose(b.samples, a.samples, rtol=1e-6, atol=1e-10)


@requires_8_devices
def test_ring_with_exact_median_raises():
    theta0, model, batch = _linreg()
    mesh = particle_mesh(jax.devices()[:8])
    with pytest.raises(ValueError):
        SVGDSampler(
            n_particles=theta0.shape[0], log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(), theta=jnp.asarray(theta0), dtype=jnp.float64,
            mesh=mesh, median="exact", comm="ring",
        )


@requires_8_devices
def test_sharded_imq_matches_single_device():
    """Custom weights-kernel (IMQ) on a 1-D particle mesh must reproduce
    the single-device generic path (kernels.generic_svgd_phi) exactly —
    same exact median, same fp contraction order."""
    from stein_jax.kernels import InverseMultiquadricKernel
    theta0, model, batch = _linreg()
    mesh = particle_mesh(jax.devices()[:8])
    kern = InverseMultiquadricKernel(c=1.0, beta=-0.5)
    single, sharded = _make_pair(
        theta0, model, lambda: Adam(learning_rate=1e-1), mesh, kernel=kern,
    )
    for t in range(5):
        single.train_on_batch(batch)
        sharded.train_on_batch(batch)
        np.testing.assert_allclose(
            sharded.samples, single.samples, rtol=1e-9, atol=1e-12,
            err_msg=f"step {t}",
        )


@requires_8_devices
def test_ring_imq_matches_all_gather():
    """IMQ through the ring generic pass (ppermute circulation) tracks the
    all_gather IMQ path with the same binned median."""
    from stein_jax.kernels import InverseMultiquadricKernel
    theta0, model, batch = _linreg(n_particles=64)
    mesh = particle_mesh(jax.devices()[:8])
    kern = InverseMultiquadricKernel(c=1.0, beta=-0.5)
    common = dict(
        n_particles=theta0.shape[0], log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64, mesh=mesh,
        median="binned", kernel=kern,
    )
    a = SVGDSampler(gd=Adam(learning_rate=1e-1), comm="all_gather", **common)
    b = SVGDSampler(gd=Adam(learning_rate=1e-1), comm="ring", **common)
    for _ in range(5):
        a.train_on_batch(batch)
        b.train_on_batch(batch)
    np.testing.assert_allclose(b.samples, a.samples, rtol=1e-6, atol=1e-10)


@requires_8_devices
def test_sharded_exact_median_gather_guard():
    """median='exact' on a mesh refuses to all-gather an n^2 distance
    matrix beyond the per-device limit, with an actionable message."""
    rng = np.random.default_rng(0)
    n = 8192     # 8192^2 * 8 B (f64) = 512 MB/device > the 256 MB limit
    model = LinearRegressionModel(3)
    theta0 = rng.normal(size=(n, 3)) * 0.01
    mesh = particle_mesh(jax.devices()[:8])
    with pytest.raises(ValueError, match="bisect"):
        SVGDSampler(
            n_particles=n, log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(), theta=jnp.asarray(theta0), dtype=jnp.float64,
            mesh=mesh, median="exact",
        )


@requires_8_devices
def test_sharded_warm_matches_single_warm():
    """warm_median on a 1-D mesh: the scan loops carry the previous
    median and refine it with psum'd counts
    (ops/median.sharded_warm_bisect_median_on_D). With the row subsample
    covering all rows the warm medians are bitwise equal to single-device,
    so run() trajectories match to sharded-vs-single fp tolerance."""
    theta0, model, batch = _linreg()
    mesh = particle_mesh(jax.devices()[:8])
    single, sharded = _make_pair(
        theta0, model, lambda: Adam(learning_rate=1e-1), mesh,
        median="bisect", warm_median=True, warm_passes=8,
    )
    aux_s = single.run(batch, 6)
    aux_m = sharded.run(batch, 6)
    np.testing.assert_allclose(
        sharded.samples, single.samples, rtol=1e-9, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(aux_m["median"]), np.asarray(aux_s["median"]),
        rtol=1e-12,
    )


@requires_8_devices
def test_warm_median_accepts_explicit_rbf_kernel():
    """An explicit SquaredExponentialKernel() IS the default kernel: the
    constructor normalises the exact type to None, so warm_median (and
    every other RBF-only path) accepts it — on a mesh and off."""
    from stein_jax.kernels import SquaredExponentialKernel
    theta0, model, batch = _linreg()
    mesh = particle_mesh(jax.devices()[:8])
    single, sharded = _make_pair(
        theta0, model, lambda: Adam(learning_rate=1e-1), mesh,
        median="bisect", warm_median=True,
        kernel=SquaredExponentialKernel(),
    )
    single.run(batch, 3)
    sharded.run(batch, 3)
    np.testing.assert_allclose(
        sharded.samples, single.samples, rtol=1e-9, atol=1e-12
    )


@requires_8_devices
def test_warm_median_mesh_guards():
    """Still-unsupported warm combinations fail loudly: non-bisect
    median (ring comm is supported since r3 — see
    test_ring_warm_matches_single_warm)."""
    theta0, model, batch = _linreg()
    mesh = particle_mesh(jax.devices()[:8])
    common = dict(
        n_particles=theta0.shape[0], log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(), theta=jnp.asarray(theta0), dtype=jnp.float64,
        warm_median=True,
    )
    with pytest.raises(ValueError, match="bisect"):
        SVGDSampler(**common, mesh=mesh, median="binned")


@requires_8_devices
@pytest.mark.parametrize("layout", ["all_gather", "ring", "2d"])
def test_sharded_pallas_option_guards(layout):
    """Meshes run the XLA phi path: the streaming tile is measured and
    selected on one device only, so kernel_impl='pallas' on any mesh
    layout fails loudly at construction instead of running untimed."""
    from jax.sharding import Mesh
    theta0, model, _ = _linreg()
    devs = np.asarray(jax.devices()[:8])
    if layout == "2d":
        mesh_kw = dict(mesh=Mesh(devs.reshape(4, 2), ("particles", "model")),
                       model_axis="model")
    else:
        mesh_kw = dict(mesh=particle_mesh(devs), comm=layout)
    with pytest.raises(ValueError, match="kernel_impl='xla'"):
        SVGDSampler(
            n_particles=theta0.shape[0], log_p=model.log_p,
            param_template=model.template(jnp.float64), gd=Adam(),
            theta=jnp.asarray(theta0), dtype=jnp.float64,
            kernel_impl="pallas", median="bisect", **mesh_kw,
        )


@requires_8_devices
def test_sharded_bisect_median_matches_exact():
    """Distributed bisect median (psum'd counts): with the subsample
    covering all rows it equals the exact median to fp resolution."""
    theta0, model, batch = _linreg(n_particles=64)
    mesh = particle_mesh(jax.devices()[:8])
    single, sharded = _make_pair(
        theta0, model, lambda: Adam(learning_rate=1e-1), mesh,
        median="bisect",
    )
    # single-device bisect also covers all rows at n=64 -> exact.
    for _ in range(5):
        single.train_on_batch(batch)
        sharded.train_on_batch(batch)
    np.testing.assert_allclose(
        sharded.samples, single.samples, rtol=1e-6, atol=1e-10
    )


@requires_8_devices
def test_ring_bisect_matches_all_gather_bisect():
    """comm='ring' + median='bisect' (r3): the ring-assembled strided row
    block holds exactly the all-gather block's entries, and threshold
    counts are order-invariant sums — medians BITWISE equal; trajectories
    agree to block-accumulation fp tolerance."""
    theta0, model, batch = _linreg(n_particles=64)
    mesh = particle_mesh(jax.devices()[:8])
    common = dict(
        n_particles=theta0.shape[0], log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64, mesh=mesh,
        median="bisect",
    )
    a = SVGDSampler(gd=Adam(learning_rate=1e-1), comm="all_gather",
                    **common)
    b = SVGDSampler(gd=Adam(learning_rate=1e-1), comm="ring", **common)
    aux_a = a.train_on_batch(batch)
    aux_b = b.train_on_batch(batch)
    assert float(aux_b["median"]) == float(aux_a["median"])
    for _ in range(4):
        a.train_on_batch(batch)
        b.train_on_batch(batch)
    np.testing.assert_allclose(b.samples, a.samples, rtol=1e-9, atol=1e-12)


@requires_8_devices
def test_ring_warm_matches_single_warm():
    """The production ring scan config (r2 verdict item #4): warm bisect
    median on comm='ring' — per-step medians bitwise-equal to the
    single-device warm search (same strided rows, same counts), samples
    to sharded-vs-single fp tolerance."""
    theta0, model, batch = _linreg()
    mesh = particle_mesh(jax.devices()[:8])
    single, ring = _make_pair(
        theta0, model, lambda: Adam(learning_rate=1e-1), mesh,
        median="bisect", warm_median=True, warm_passes=8, comm="ring",
    )
    aux_s = single.run(batch, 6)
    aux_r = ring.run(batch, 6)
    np.testing.assert_allclose(
        ring.samples, single.samples, rtol=1e-9, atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(aux_r["median"]), np.asarray(aux_s["median"]),
        rtol=1e-12,
    )


@requires_8_devices
def test_ring_warm_lowers_to_ring_collectives():
    """Regression (r3 review): comm='ring' + warm_median compiled the
    ALL-GATHER body — the bug was invisible to every parity test because
    the two paths are numerically identical, so this pins the DISPATCH
    structurally: the lowered ring warm step must circulate blocks with
    collective_permute (ppermute) and must never all-gather the [n, p]
    particle block; the all_gather variant must show the reverse."""
    theta0, model, batch = _linreg()
    mesh = particle_mesh(jax.devices()[:8])
    samplers = {}
    for comm in ("ring", "all_gather"):
        _, samplers[comm] = _make_pair(
            theta0, model, lambda: Adam(learning_rate=1e-1), mesh,
            median="bisect", warm_median=True, warm_passes=8, comm=comm,
        )

    def lowered(s):
        med0 = jnp.asarray(0.5, s.state.particles.dtype)
        return jax.jit(s._warm_step_fn).lower(
            (s.state, med0), batch
        ).as_text()

    ring_txt = lowered(samplers["ring"])
    ag_txt = lowered(samplers["all_gather"])
    assert "collective_permute" in ring_txt
    assert "all_gather" not in ring_txt
    assert "all_gather" in ag_txt
    assert "collective_permute" not in ag_txt

    # The cold seed honours the comm mode too (r3 review: it
    # all-gathered the full particle block even in ring mode).
    init_ring = samplers["ring"]._warm_init_med.lower(
        samplers["ring"].state.particles
    ).as_text()
    assert "collective_permute" in init_ring
    assert "all_gather" not in init_ring


def _linreg_grads(theta, batch):
    """A model-supplied gradient stage for the linear-regression model:
    the closed-form score X^T (y - X w) - w and log_p per particle."""
    X, y = batch["X"], batch["y"]
    r = y.T - theta @ X.T                              # [n, n_obs]
    grads = r @ X - theta
    logp = (-0.5 * jnp.sum(r * r, axis=1) - 0.5 * jnp.sum(theta ** 2, 1)
            - 0.5 * theta.shape[1] * jnp.log(2.0 * jnp.pi))
    return logp, grads


@requires_8_devices
@pytest.mark.parametrize("comm", ["all_gather", "ring"])
def test_mesh_custom_grads_matches_single(comm):
    """custom_grads on a 1-D particle mesh: gradients are per-particle,
    so a model-supplied gradient stage runs per shard unchanged — the
    mesh trajectory must match the single-device custom_grads run and
    the mesh autodiff run (closed-form and autodiff scores agree to fp
    reassociation)."""
    theta0, model, batch = _linreg()
    mesh = particle_mesh(jax.devices()[:8])
    common = dict(
        n_particles=theta0.shape[0], log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64, median="bisect",
    )
    mc = SVGDSampler(gd=Adam(learning_rate=1e-1), mesh=mesh, comm=comm,
                     custom_grads=_linreg_grads, **common)
    sc = SVGDSampler(gd=Adam(learning_rate=1e-1),
                     custom_grads=_linreg_grads, **common)
    ma = SVGDSampler(gd=Adam(learning_rate=1e-1), mesh=mesh, comm=comm,
                     **common)
    for _ in range(3):
        aux_c = mc.train_on_batch(batch)
        sc.train_on_batch(batch)
        aux_a = ma.train_on_batch(batch)
    np.testing.assert_allclose(mc.samples, sc.samples, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(mc.samples, ma.samples, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(aux_c["log_p_mean"]),
                               float(aux_a["log_p_mean"]), rtol=1e-9)

    # The 2-D mesh refuses: its parameter dimension is sharded.
    from jax.sharding import Mesh
    mesh2d = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                  ("particles", "model"))
    with pytest.raises(ValueError, match="1-D particle"):
        SVGDSampler(gd=Adam(learning_rate=1e-1), mesh=mesh2d,
                    model_axis="model", custom_grads=_linreg_grads,
                    **common)


@requires_8_devices
def test_sharded_ksd_matches_single_device():
    """ksd() on a 1-D particle mesh (r4 verdict #7): the jitted
    scores + [n, n] KSD matmuls run on the sharded particles via GSPMD
    propagation — the value must equal the single-device ksd computed
    on the same (bitwise-identical, test_sharded_matches_single_device)
    particles. Both the V- and U-statistic forms."""
    theta0, model, batch = _linreg()
    mesh = particle_mesh(jax.devices()[:8])
    single, sharded = _make_pair(
        theta0, model, lambda: Adam(learning_rate=1e-1), mesh,
    )
    for _ in range(3):
        single.train_on_batch(batch)
        sharded.train_on_batch(batch)
    for u in (False, True):
        k_m = sharded.ksd(batch, u_statistic=u)
        k_s = single.ksd(batch, u_statistic=u)
        np.testing.assert_allclose(k_m, k_s, rtol=1e-9,
                                   err_msg=f"u_statistic={u}")
        assert np.isfinite(k_m)


MESH_MEDIAN_CASES = {
    # name: (mesh kind, sampler options, rtol on the particles)
    "all_gather_exact": ("1d", dict(median="exact"), 1e-9),
    "all_gather_bisect": ("1d", dict(median="bisect"), 1e-6),
    "all_gather_binned": ("1d", dict(median="binned"), 1e-6),
    "all_gather_warm": ("1d", dict(median="bisect", warm_median=True), 1e-9),
    "ring_bisect": ("1d", dict(median="bisect", comm="ring"), 1e-6),
    "ring_binned": ("1d", dict(median="binned", comm="ring"), 1e-6),
    "ring_warm": ("1d", dict(median="bisect", warm_median=True,
                             comm="ring"), 1e-9),
    "2d_exact": ("2d", dict(median="exact", model_axis="model"), 1e-9),
    "2d_bisect": ("2d", dict(median="bisect", model_axis="model"), 1e-6),
    "2d_warm_rounds": ("2d", dict(median="bisect", warm_median=True,
                                  model_axis="model",
                                  median_collectives="rounds"), 1e-9),
}


@requires_8_devices
@pytest.mark.parametrize("case", sorted(MESH_MEDIAN_CASES))
def test_mesh_step_matches_single_device_per_median(case):
    """Every mesh layout and median mode against the single-device
    sampler with the same median (the single-device binned median counts
    the same histogram the mesh psums; bisect with every row counted is
    the exact median on both sides)."""
    from jax.sharding import Mesh
    kind, kw, rtol = MESH_MEDIAN_CASES[case]
    theta0, model, batch = _linreg(n_particles=32, n_feats=4)
    devs = np.asarray(jax.devices()[:8])
    mesh = (Mesh(devs.reshape(4, 2), ("particles", "model"))
            if kind == "2d" else particle_mesh(jax.devices()[:8]))
    single_kw = {k: v for k, v in kw.items()
                 if k not in ("comm", "model_axis", "median_collectives")}
    common = dict(
        n_particles=theta0.shape[0], log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64,
    )
    single = SVGDSampler(gd=Adam(learning_rate=1e-1), **common, **single_kw)
    sharded = SVGDSampler(gd=Adam(learning_rate=1e-1), mesh=mesh, **common,
                          **kw)
    aux_s = single.run(batch, 4)
    aux_m = sharded.run(batch, 4)
    np.testing.assert_allclose(sharded.samples, single.samples, rtol=rtol,
                               atol=rtol * 1e-2)
    np.testing.assert_allclose(np.asarray(aux_m["h2"]),
                               np.asarray(aux_s["h2"]), rtol=rtol)
