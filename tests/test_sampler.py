"""End-to-end sampler tests: golden trajectories vs the NumPy oracle and
posterior-moment checks against the conjugate closed form."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from baselines.numpy_svgd import NumpySVGD, NumpyAdam, NumpyAdagrad
from stein_jax import SVGDSampler, Adam, Adagrad
from stein_jax.models import LinearRegressionModel


def _linreg_setup(seed=0, n_obs=40, n_feats=3, n_particles=16):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, n_feats))
    w_true = rng.normal(size=(n_feats, 1)) * 2.0
    y = X @ w_true + rng.normal(size=(n_obs, 1)) * 0.3
    theta0 = rng.normal(size=(n_particles, n_feats)) * 0.01
    model = LinearRegressionModel(n_feats)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    return X, y, theta0, model, batch


def _np_grad_log_p(X, y):
    """Closed-form grad of the linear-regression log posterior:
    X^T(y - Xw) - w."""
    def grad(theta_row, batch):
        w = theta_row.reshape(-1, 1)
        return (X.T @ (y - X @ w) - w).ravel()
    return grad


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_golden_trajectory_adam(seed):
    """SVGDSampler (f64) matches the NumPy oracle elementwise for 10 steps."""
    X, y, theta0, model, batch = _linreg_setup(seed=seed)
    oracle = NumpySVGD(
        _np_grad_log_p(X, y), theta0, NumpyAdam(learning_rate=1e-1)
    )
    sampler = SVGDSampler(
        n_particles=theta0.shape[0],
        log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1),
        theta=jnp.asarray(theta0),
        dtype=jnp.float64,
    )
    for t in range(10):
        oracle.train_on_batch(None)
        sampler.train_on_batch(batch)
        np.testing.assert_allclose(
            sampler.samples, oracle.samples, rtol=1e-8, atol=1e-12,
            err_msg=f"step {t}",
        )


def test_golden_trajectory_adagrad():
    X, y, theta0, model, batch = _linreg_setup(seed=3)
    oracle = NumpySVGD(
        _np_grad_log_p(X, y), theta0, NumpyAdagrad(learning_rate=1e-1)
    )
    sampler = SVGDSampler(
        n_particles=theta0.shape[0],
        log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adagrad(learning_rate=1e-1),
        theta=jnp.asarray(theta0),
        dtype=jnp.float64,
    )
    for _ in range(10):
        oracle.train_on_batch(None)
        sampler.train_on_batch(batch)
    np.testing.assert_allclose(
        sampler.samples, oracle.samples, rtol=1e-8, atol=1e-12
    )


def test_posterior_moments_vs_conjugate():
    """Linear regression with unit-noise Gaussian likelihood and N(0, I)
    prior has conjugate posterior N((X'X+I)^-1 X'y, (X'X+I)^-1). SVGD's
    particle mean/variance must land within Monte-Carlo error."""
    X, y, _, model, batch = _linreg_setup(seed=5, n_particles=64)
    n_particles = 64
    key = jax.random.PRNGKey(42)
    sampler = SVGDSampler(
        n_particles=n_particles,
        log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1),
        key=key,
        dtype=jnp.float64,
    )
    for _ in range(600):
        sampler.train_on_batch(batch)

    A = X.T @ X + np.eye(X.shape[1])
    cov = np.linalg.inv(A)
    mean = cov @ X.T @ y

    est_mean = sampler.samples.mean(axis=0)
    est_var = sampler.samples.var(axis=0)
    mc_err = np.sqrt(np.diag(cov) / n_particles)
    np.testing.assert_allclose(est_mean, mean.ravel(), atol=4 * mc_err.max())
    # SVGD with finite particles slightly underestimates variance; allow a
    # generous band.
    np.testing.assert_allclose(est_var, np.diag(cov), rtol=0.6)


def test_theta_and_samples_roundtrip():
    X, y, theta0, model, batch = _linreg_setup()
    sampler = SVGDSampler(
        n_particles=theta0.shape[0],
        log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1),
        theta=jnp.asarray(theta0),
        dtype=jnp.float64,
    )
    theta_tree = sampler.theta
    assert theta_tree["w"].shape == (theta0.shape[0], X.shape[1], 1)
    np.testing.assert_allclose(
        np.asarray(theta_tree["w"]).reshape(theta0.shape), theta0
    )


def test_theta_wrong_shape_raises():
    """A mis-shaped theta raises ValueError (not a strippable assert)."""
    X, y, theta0, model, batch = _linreg_setup()
    with pytest.raises(ValueError, match="theta shape"):
        SVGDSampler(
            n_particles=theta0.shape[0] + 1,
            log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(learning_rate=1e-1),
            theta=jnp.asarray(theta0),
            dtype=jnp.float64,
        )


def test_pytree_theta_init():
    """theta may be supplied as a pytree of [n, *shape] leaves."""
    X, y, theta0, model, batch = _linreg_setup()
    n, k = theta0.shape
    sampler = SVGDSampler(
        n_particles=n,
        log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1),
        theta={"w": theta0.reshape(n, k, 1)},
        dtype=jnp.float64,
    )
    np.testing.assert_allclose(sampler.samples, theta0)


def test_function_posterior():
    X, y, theta0, model, batch = _linreg_setup()
    sampler = SVGDSampler(
        n_particles=theta0.shape[0],
        log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1),
        theta=jnp.asarray(theta0),
        dtype=jnp.float64,
    )
    dist = sampler.function_posterior(model.predict, batch)
    assert dist.shape == (theta0.shape[0], X.shape[0])
    expect = theta0 @ X.T  # w per particle dotted with rows of X
    np.testing.assert_allclose(dist, expect, rtol=1e-10)
    mean = sampler.function_posterior(model.predict, batch, axis=0)
    np.testing.assert_allclose(mean, expect.mean(axis=0), rtol=1e-10)


def test_aux_diagnostics():
    X, y, theta0, model, batch = _linreg_setup()
    sampler = SVGDSampler(
        n_particles=theta0.shape[0],
        log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1),
        theta=jnp.asarray(theta0),
        dtype=jnp.float64,
    )
    aux = sampler.train_on_batch(batch)
    assert set(aux) >= {"phi_norm", "log_p_mean", "h2", "median"}
    assert np.isfinite(float(aux["phi_norm"]))
    assert float(aux["h2"]) > 0


def test_run_matches_iterated_steps():
    """run(batch, k) in one dispatch == k train_on_batch calls."""
    X, y, theta0, model, batch = _linreg_setup(seed=11)
    def make():
        return SVGDSampler(
            n_particles=theta0.shape[0], log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(learning_rate=1e-1, decay=0.999),
            theta=jnp.asarray(theta0), dtype=jnp.float64,
        )
    a, b = make(), make()
    for _ in range(6):
        a.train_on_batch(batch)
    aux = b.run(batch, 6)
    np.testing.assert_array_equal(a.samples, b.samples)
    assert np.asarray(aux["phi_norm"]).shape == (6,)
    assert int(b.state.step) == 6


def test_train_on_batches_matches_iterated_steps():
    X, y, theta0, model, batch = _linreg_setup(seed=12)
    rng = np.random.default_rng(0)
    k, m = 5, 8
    idx = rng.integers(0, X.shape[0], size=(k, m))
    batches = {
        "X": jnp.asarray(X[idx]),          # [k, m, f]
        "y": jnp.asarray(y[idx]),          # [k, m, 1]
    }
    def make():
        return SVGDSampler(
            n_particles=theta0.shape[0], log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(learning_rate=1e-1),
            theta=jnp.asarray(theta0), dtype=jnp.float64,
        )
    a, b = make(), make()
    for t in range(k):
        a.train_on_batch({"X": batches["X"][t], "y": batches["y"][t]})
    aux = b.train_on_batches(batches)
    np.testing.assert_array_equal(a.samples, b.samples)
    assert np.asarray(aux["log_p_mean"]).shape == (k,)


def test_run_sharded():
    import jax as _jax
    if _jax.device_count() < 8:
        return
    from stein_jax.parallel import particle_mesh
    X, y, theta0, model, batch = _linreg_setup(seed=13)
    mesh = particle_mesh(_jax.devices()[:8])
    def make(m=None):
        return SVGDSampler(
            n_particles=theta0.shape[0], log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(learning_rate=1e-1),
            theta=jnp.asarray(theta0), dtype=jnp.float64, mesh=m,
        )
    a, b = make(), make(mesh)
    a.run(batch, 4)
    b.run(batch, 4)
    np.testing.assert_allclose(b.samples, a.samples, rtol=1e-9, atol=1e-12)


def test_remat_matches_plain():
    """jax.checkpoint'd gradients are numerically identical."""
    X, y, theta0, model, batch = _linreg_setup(seed=21)
    def make(remat):
        return SVGDSampler(
            n_particles=theta0.shape[0], log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(learning_rate=1e-1),
            theta=jnp.asarray(theta0), dtype=jnp.float64, remat=remat,
        )
    a, b = make(False), make(True)
    for _ in range(3):
        a.train_on_batch(batch)
        b.train_on_batch(batch)
    np.testing.assert_array_equal(a.samples, b.samples)


# Every option name a throughput_config result may carry.
_CONFIG_KEYS = {"median", "warm_median", "dtype", "median_max_rows",
                "mesh", "model_axis", "median_collectives"}


def _config_mesh(kind):
    from jax.sharding import Mesh
    devs = np.asarray(jax.devices()[:8])
    return {
        None: None,
        "1d": Mesh(devs, ("particles",)),
        "1d1": Mesh(devs[:1], ("particles",)),
        "2d": Mesh(devs.reshape(4, 2), ("particles", "model")),
        "2d12": Mesh(devs[:2].reshape(1, 2), ("particles", "model")),
    }[kind]


@pytest.mark.parametrize("n,p,dtype,mesh_kind,expect", [
    (1000, 128, jnp.float32, None, {}),
    (4096, 128, jnp.float32, None, {"median_max_rows": 128}),
    (10240, 128, jnp.float32, None, {"median_max_rows": 128}),
    (10240, 64, "float32", None, {"dtype": "float32"}),
    (1000, 303, jnp.float32, None, {}),
    (4096, 303, jnp.float32, None, {"median_max_rows": 128}),
    (10240, 128, jnp.float64, None, {"median_max_rows": 128}),
    (10240, 128, "float64", None, {}),
    (4096, 128, jnp.float32, "1d", {"median_max_rows": 128}),
    (1000, 303, jnp.float32, "1d", {}),
    (1000, 128, jnp.float32, "2d", {"model_axis": "model",
                                    "median_collectives": "grid"}),
    (1000, 128, jnp.float32, "2d12", {"model_axis": "model",
                                      "median_collectives": "rounds"}),
])
def test_throughput_config_decision_tree(n, p, dtype, mesh_kind, expect):
    """throughput_config selects from n, p, dtype and mesh, returns only
    options that exist, and every result constructs a sampler: the warm
    bisect median and the XLA phi path everywhere (the streaming tile
    wins only with a TF32 Gram, so it is never a default)."""
    from stein_jax import throughput_config
    mesh = _config_mesh(mesh_kind)
    model_axis = "model" if mesh_kind and mesh_kind.startswith("2d") \
        else None
    cfg = throughput_config(n, p, mesh=mesh, model_axis=model_axis,
                            dtype=dtype)
    assert set(cfg) <= _CONFIG_KEYS
    assert cfg["median"] == "bisect" and cfg["warm_median"] is True
    for k, v in expect.items():
        assert cfg[k] == v, (k, cfg)
    assert "kernel_impl" not in cfg
    assert ("mesh" in cfg) == (mesh is not None)
    # Construction runs the full option-validation chain; jit compiles
    # lazily, so this is cheap at any n.
    tmpl = LinearRegressionModel(p)
    SVGDSampler(n_particles=n, log_p=tmpl.log_p,
                param_template=tmpl.template(cfg["dtype"]),
                gd=Adam(learning_rate=1e-1), **cfg)


@pytest.mark.parametrize("mesh_kind", [None, "1d", "2d"])
def test_throughput_config_runs(mesh_kind):
    """A small config of each layout runs end to end on the CPU."""
    from stein_jax import throughput_config
    mesh = _config_mesh(mesh_kind)
    model_axis = "model" if mesh_kind == "2d" else None
    _, _, theta0, model, batch = _linreg_setup(n_feats=4)
    s = SVGDSampler(
        n_particles=16, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
        **throughput_config(16, 4, mesh=mesh, model_axis=model_axis,
                            dtype=jnp.float64),
    )
    aux = s.run(batch, 3)
    assert np.isfinite(np.asarray(s.samples)).all()
    assert np.asarray(aux["median"]).shape == (3,)


def test_string_dtype_constructs_fused_paths():
    """Regression (r2 advisor): the docstring-advertised splat
    ``SVGDSampler(..., **throughput_config(n, p, dtype='float32'))``
    constructs with the string spelling of the dtype, with the XLA phi
    path and with the opt-in tile."""
    from stein_jax import throughput_config

    model = LinearRegressionModel(4)
    cfg = throughput_config(4096, 4, dtype="float32")
    assert cfg["dtype"] == "float32" and "kernel_impl" not in cfg
    SVGDSampler(
        n_particles=4096, log_p=model.log_p,
        param_template=model.template(), gd=Adam(learning_rate=1e-1),
        **cfg,
    )
    SVGDSampler(
        n_particles=4096, log_p=model.log_p,
        param_template=model.template(), gd=Adam(learning_rate=1e-1),
        kernel_impl="pallas", pallas_interpret=True, **cfg,
    )


def test_exact_median_large_n_warns():
    """Single-device median='exact' above the warn threshold points the
    user at bisect/throughput_config (mirror of the mesh gather guard) —
    without changing behaviour: exact stays available."""
    import warnings
    from stein_jax.api import EXACT_MEDIAN_WARN_BYTES

    model = LinearRegressionModel(2)
    n_warn = int((EXACT_MEDIAN_WARN_BYTES // 4) ** 0.5) + 1
    with pytest.warns(UserWarning, match="median='bisect'"):
        SVGDSampler(
            n_particles=n_warn, log_p=model.log_p,
            param_template=model.template(jnp.float32),
            gd=Adam(learning_rate=1e-1), dtype=jnp.float32,
            median="exact",
        )
    # Under the threshold (or with a fast median): silent.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        SVGDSampler(
            n_particles=64, log_p=model.log_p,
            param_template=model.template(jnp.float32),
            gd=Adam(learning_rate=1e-1), dtype=jnp.float32,
            median="exact",
        )
        SVGDSampler(
            n_particles=n_warn, log_p=model.log_p,
            param_template=model.template(jnp.float32),
            gd=Adam(learning_rate=1e-1), dtype=jnp.float32,
            median="bisect",
        )


def test_train_minibatched():
    """On-device minibatch sampling (train_minibatched): deterministic
    given the key, converges on a logistic problem like host-sampled
    minibatches do, and leaves no NaNs. (Uniform WITH replacement — the
    documented trade vs the reference's np.random.choice
    replace=False.)"""
    from stein_jax.models import LogisticRegressionModel

    rng = np.random.default_rng(0)
    n_rows, d, n, n_batch = 2000, 8, 64, 32
    X = rng.normal(size=(n_rows, d)).astype(np.float32)
    w_true = rng.normal(size=(d, 1))
    y = (X @ w_true > 0).astype(np.float32)
    data = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    model = LogisticRegressionModel(d, n_train=n_rows, n_batch=n_batch)

    def make():
        return SVGDSampler(
            n_particles=n, log_p=model.log_p,
            param_template=model.template(),
            gd=Adam(learning_rate=1e-1), key=jax.random.PRNGKey(1),
            median="bisect", warm_median=True,
        )

    key = jax.random.PRNGKey(3)
    a, b = make(), make()
    a.train_minibatched(data, 300, n_batch, key)
    b.train_minibatched(data, 300, n_batch, key)
    np.testing.assert_array_equal(a.samples, b.samples)
    sa = np.asarray(a.samples)
    assert np.isfinite(sa).all()
    # Converged enough to classify: particle-averaged logits get > 90%
    # of the (noise-free) labels right (ravel layout: log_alpha is
    # column 0 — keys flatten sorted).
    w_mean = a.theta["w"].mean(axis=0)
    acc = np.mean((X @ np.asarray(w_mean) > 0) == (y > 0.5))
    assert acc > 0.9, acc
    # A different key gives a different (but also finite) trajectory.
    c = make()
    c.train_minibatched(data, 300, n_batch, jax.random.PRNGKey(4))
    assert not np.array_equal(np.asarray(c.samples), sa)


def test_throughput_config_mesh_r5_picks():
    """1-D meshes take the warm bisect median on the XLA tile (the tile
    is measured on one device only); the picked config runs with a
    model-supplied gradient stage on 8 devices."""
    from stein_jax import throughput_config

    mesh8 = _config_mesh("1d")
    cfg = throughput_config(16, 4, mesh=mesh8)
    assert cfg == {"median": "bisect", "warm_median": True,
                   "dtype": jnp.float32, "mesh": mesh8}
    assert "median_collectives" not in throughput_config(
        1000, 128, mesh=_config_mesh("1d1"))

    def grads(theta, batch):
        X, y = batch["X"], batch["y"]
        r = y.T - theta @ X.T
        return -0.5 * jnp.sum(r * r, 1), r @ X - theta

    _, _, theta0, model, batch = _linreg_setup(n_feats=4)
    s = SVGDSampler(
        n_particles=16, log_p=model.log_p,
        param_template=model.template(jnp.float32),
        gd=Adam(learning_rate=1e-2), custom_grads=grads,
        theta=jnp.asarray(theta0, jnp.float32), **cfg,
    )
    s.run(jax.tree_util.tree_map(lambda l: jnp.asarray(l, jnp.float32),
                                 batch), 2)
    assert np.isfinite(np.asarray(s.samples)).all()


def test_throughput_config_model_axis_r5_tuning():
    """throughput_config(model_axis=) picks the warm median's collective
    structure by PARTICLE-axis size (the count psums ride that axis):
    the two-psum grid search on a real particle axis, the rounds chain
    when it is degenerate. The config runs on a 4x2 mesh."""
    from stein_jax import throughput_config

    m42 = _config_mesh("2d")
    cfg42 = throughput_config(1000, 128, mesh=m42, model_axis="model")
    assert cfg42["median_collectives"] == "grid"
    assert "kernel_impl" not in cfg42
    m12 = _config_mesh("2d12")
    cfg12 = throughput_config(1000, 128, mesh=m12, model_axis="model")
    assert cfg12["median_collectives"] == "rounds"
    cfgL = throughput_config(8192, 64, mesh=m42, model_axis="model")
    assert cfgL["median_max_rows"] == 128

    _, _, theta0, model, batch = _linreg_setup(n_feats=4)
    s = SVGDSampler(
        n_particles=16, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
        **throughput_config(16, 4, mesh=m42, model_axis="model",
                            dtype=jnp.float64),
    )
    s.run(batch, 3)
    assert np.isfinite(np.asarray(s.samples)).all()
