"""Deployed numerics on the GPU: the f32 step as compiled for the card
against float64 references.

Precision tiers on an H100: the XLA path's Gram behind D runs at HIGHEST
(full f32); its K contractions, the model matmuls at "high" and both
products inside the opt-in streaming tile (its Gram on centred
particles) run in TF32 (10-bit mantissa inputs, f32 accumulation). After one Adam step the optimizer's first moment is the
clipped phi itself, so steps are compared through it (the particles move
by +-lr * 0.316 with the sign of phi, which hides its magnitude, and an
f32 rounding that flips the sign of a near-zero phi coordinate moves that
coordinate by a whole step).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from baselines.numpy_svgd import NumpyAdam, NumpySVGD, compute_phi
from stein_jax import Adam, SVGDSampler, throughput_config
from stein_jax.models import LinearRegressionModel
from stein_jax.api import make_phi_fn
from stein_jax.ops import rbf
from stein_jax.ops.diagnostics import ksd_rbf
from stein_jax.ops.pallas_svgd import pallas_svgd_phi
from stein_jax.utils.ravel import template_unraveler

pytestmark = pytest.mark.gpu


def _linreg(seed=0, n_particles=64, n_feats=16, n_obs=128):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, n_feats))
    y = X @ rng.normal(size=(n_feats, 1)) + rng.normal(size=(n_obs, 1)) * 0.3
    theta0 = rng.normal(size=(n_particles, n_feats)) * 0.01
    return X, y, theta0


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _centred_phi(theta, grads, h2):
    t = np.asarray(theta, np.float64)
    g = np.asarray(grads, np.float64)
    c = t - t.mean(0)
    r = (c * c).sum(1)
    K = np.exp(-(r[:, None] + r[None, :] - 2 * c @ c.T) / h2 / 2)
    return (K @ g + (K.sum(1, keepdims=True) * c - K @ c) / h2) / len(t)


def _mid_run(seed=0):
    """Particles after three f64 oracle steps (a realistic mid-run
    state) and their f64 gradients."""
    from baselines.numpy_svgd import clip_phi
    X, y, theta = _linreg(seed)
    gd = NumpyAdam(learning_rate=1e-1)
    for _ in range(3):
        phi, _ = compute_phi(theta, (y.T - theta @ X.T) @ X - theta)
        theta = theta + gd.update(clip_phi(phi))
    return X, y, theta, (y.T - theta @ X.T) @ X - theta


def test_phi_engine_fidelity():
    """The f32 SVGD engine (median, kernel, direction) on f64-computed
    gradients against the oracle's phi, and the global norm the clip
    uses."""
    X, y, theta, grads = _mid_run()
    phi_fn = make_phi_fn(theta.shape[0], median="exact", kernel_impl="xla")
    got = np.asarray(jax.jit(lambda t, g: phi_fn(t, g)[0])(
        jnp.asarray(theta, jnp.float32), jnp.asarray(grads, jnp.float32)))
    ref, _ = compute_phi(theta, grads)
    assert _rel(got, ref) < 1e-3
    assert abs(np.linalg.norm(got) / np.linalg.norm(ref) - 1) < 1e-4


def test_phi_direction_fidelity():
    """phi including the model gradients computed on the card (the
    shipped models run their data matmuls at "high", TF32)."""
    X, y, theta, grads = _mid_run()
    model = LinearRegressionModel(X.shape[1])
    _, unravel = template_unraveler(model.template())
    phi_fn = make_phi_fn(theta.shape[0], median="exact", kernel_impl="xla")

    def card_phi(th, Xj, yj):
        g = jax.vmap(jax.grad(lambda row, b: model.log_p(unravel(row), b)),
                     in_axes=(0, None))(th, {"X": Xj, "y": yj})
        return phi_fn(th, g)[0]

    got = jax.jit(card_phi)(jnp.asarray(theta, jnp.float32),
                            jnp.asarray(X, jnp.float32),
                            jnp.asarray(y, jnp.float32))
    ref, _ = compute_phi(theta, grads)
    assert _rel(got, ref) < 2e-3


@pytest.mark.parametrize("cfg", [
    dict(median="exact"),
    dict(median="bisect", median_max_rows=64),
    dict(median="subsample", median_max_rows=64, kernel_impl="pallas"),
], ids=["xla_exact", "xla_bisect", "tile"])
def test_f32_step_matches_f64_oracle(cfg):
    """One deployed step's clipped phi against the oracle's (every row in
    the median subsample, so every median is the exact one)."""
    X, y, theta0 = _linreg()
    model = LinearRegressionModel(X.shape[1])
    s = SVGDSampler(
        n_particles=theta0.shape[0], log_p=model.log_p,
        param_template=model.template(), gd=Adam(learning_rate=1e-1),
        theta=jnp.asarray(theta0, jnp.float32), **cfg,
    )
    aux = s.train_on_batch({"X": jnp.asarray(X, jnp.float32),
                            "y": jnp.asarray(y, jnp.float32)})
    oracle = NumpySVGD(
        lambda w, b: ((X.T @ (y - X @ w[:, None])) - w[:, None]).ravel(),
        theta0, NumpyAdam(learning_rate=1e-1))
    oracle.train_on_batch(None)
    assert abs(float(aux["h2"]) / oracle.last_h2 - 1) < 1e-5
    assert _rel(s.state.opt_state.mu, oracle.gd.mu) < 2e-3


@pytest.mark.parametrize("n,p", [(4096, 128), (10240, 128), (1000, 303)])
@pytest.mark.parametrize("shift,spread", [(3.0, 1.0), (1000.0, 1.0),
                                          (0.7, 1e-3)])
def test_tile_matches_f64_at_scale(n, p, shift, spread):
    """The compiled tile against a centred f64 phi with the same h^2:
    a cloud far from the origin (the in-kernel centring) and a tight
    cluster at norm ~8 (D cancels; the full-f32 Gram keeps it)."""
    rng = np.random.default_rng(n + p)
    theta = rng.normal(size=(n, p)) * spread + shift
    grads = rng.normal(size=(n, p))
    c = theta - theta.mean(0)
    h2 = float(np.median(((c[:256, None, :] - c[None]) ** 2).sum(-1))
               / np.log(n))
    got = pallas_svgd_phi(jnp.asarray(theta, jnp.float32),
                          jnp.asarray(grads, jnp.float32), jnp.float32(h2))
    assert _rel(got, _centred_phi(theta, grads, h2)) < 2e-3


def test_gram_cancellation_precision():
    """D at HIGHEST stays in the f32 formula's regime under cancellation:
    separations 1e-3 at norms ~8 make max(D) ~1e-4 against Gram terms
    ~64, so the f32 formula errs by ~0.1 x max(D) and a TF32 Gram by
    ~100 x. Within 4x of the host's f32 formula error."""
    rng = np.random.default_rng(3)
    theta = rng.normal(size=(1, 64)) + rng.normal(size=(128, 64)) * 1e-3
    r = (theta * theta).sum(1)
    ref = r[:, None] + r[None, :] - 2 * theta @ theta.T
    D = np.asarray(jax.jit(rbf.pairwise_sq_dists)(
        jnp.asarray(theta, jnp.float32)))
    err = np.abs(D - ref).max() / ref.max()
    t32 = theta.astype(np.float32)
    r32 = (t32 * t32).sum(1, dtype=np.float32)
    host = r32[:, None] + r32[None, :] - np.float32(2) * (t32 @ t32.T)
    err_host = np.abs(host - ref).max() / ref.max()
    assert err < 1.0
    assert err < 4.0 * err_host + 1e-6


def test_ksd_precision():
    """KSD's cross terms cancel like D does: the f32 KSD on the card
    tracks the f64 value."""
    rng = np.random.default_rng(4)
    theta = rng.normal(size=(128, 32)) * 0.1
    grads = -theta * 25.0      # score of N(0, 0.2^2 I)
    got = float(jax.jit(ksd_rbf)(jnp.asarray(theta, jnp.float32),
                                 jnp.asarray(grads, jnp.float32)))
    r = (theta * theta).sum(1)
    D = r[:, None] + r[None, :] - 2 * theta @ theta.T
    n, p = theta.shape
    h2 = np.median(D) / np.log(n)
    K = np.exp(-D / h2 / 2.0)
    ST = grads @ theta.T
    d = np.sum(grads * theta, axis=1)
    cross = d[:, None] + d[None, :] - ST - ST.T
    ref = float(np.mean(K * (grads @ grads.T + cross / h2 + p / h2
                             - D / (h2 * h2))))
    assert abs(got - ref) < 1e-3 * max(1.0, abs(ref)), (got, ref)


def test_streaming_ksd_at_scale():
    """ksd() at n=10240 runs the streaming row-blocked form on the card:
    finite, and close to the KSD of a strided half of the particles (a
    consistency check: U-statistics of sub-populations differ by
    O(1/sqrt(m)))."""
    rng = np.random.default_rng(9)
    n, p = 10240, 64
    theta = jnp.asarray(rng.normal(size=(n, p)) * 0.1, jnp.float32)
    grads = jnp.asarray(rng.normal(size=(n, p)), jnp.float32)
    h2 = jnp.float32(1.3)
    val = float(ksd_rbf(theta, grads, h2=h2))
    assert np.isfinite(val)
    sub = float(ksd_rbf(theta[::2], grads[::2], h2=h2))
    assert abs(val - sub) < 0.5 * abs(val) + 1e-3


def _conjugate_problem(seed, n_obs=256, p=8, noise=0.5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_obs, p))
    y = X @ rng.normal(size=(p, 1)) + rng.normal(size=(n_obs, 1)) * noise
    A = X.T @ X + np.eye(p)
    cov = np.linalg.inv(A)
    return X, y, (cov @ (X.T @ y)).ravel(), cov


def _assert_posterior(samples, mean, cov):
    """Mean within 6 Monte-Carlo standard errors, variances within the
    SVGD band."""
    mc = np.sqrt(np.diag(cov) / samples.shape[0])
    assert np.abs(samples.mean(0) - mean).max() < 6 * mc.max()
    ratio = samples.var(0) / np.diag(cov)
    assert np.all(ratio > 0.5) and np.all(ratio < 1.6), ratio


@pytest.mark.parametrize("precision", ["high", "default"])
def test_default_precision_posterior_statistics_on_chip(precision):
    """throughput_config at n=512 (XLA phi, warm bisect median) samples
    the conjugate posterior with the model's data matmuls at "high" and
    at "default" precision (both TF32 on an H100)."""
    X, y, mean, cov = _conjugate_problem(13)
    n = 512
    model = LinearRegressionModel(X.shape[1], precision=precision)
    s = SVGDSampler(n_particles=n, log_p=model.log_p,
                    param_template=model.template(),
                    gd=Adam(learning_rate=5e-2), key=jax.random.PRNGKey(0),
                    **throughput_config(n, X.shape[1]))
    s.run({"X": jnp.asarray(X, jnp.float32),
           "y": jnp.asarray(y, jnp.float32)}, 1500)
    _assert_posterior(np.asarray(s.samples, np.float64), mean, cov)


def test_bfloat16_end_to_end_posterior_on_chip():
    """Whole-sampler bfloat16 (particles, moments and phi; the model's
    math in f32): the posterior moments of a correlated Gaussian land in
    the Monte-Carlo band. The CPU twin is tests/test_statistical.py::
    test_bfloat16_end_to_end_posterior."""
    mu = np.array([1.0, -2.0, 0.5])
    cov = np.array([[1.0, 0.7, 0.2], [0.7, 1.5, -0.3], [0.2, -0.3, 0.8]])
    prec = jnp.asarray(np.linalg.inv(cov), jnp.float32)
    muj = jnp.asarray(mu, jnp.float32)

    def log_p(params, batch):
        d = params["x"].astype(jnp.float32) - muj
        return -0.5 * d @ prec @ d

    n = 128
    s = SVGDSampler(n_particles=n, log_p=log_p,
                    param_template={"x": jnp.zeros((3,), jnp.bfloat16)},
                    gd=Adam(learning_rate=5e-2), key=jax.random.PRNGKey(1),
                    dtype=jnp.bfloat16)
    s.run(batch=None, n_steps=1500)
    x = np.asarray(s.samples, np.float64)
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x.mean(0), mu,
                               atol=4 * np.sqrt(np.diag(cov) / n).max())
    est = np.cov(x.T)
    np.testing.assert_allclose(est, cov, atol=0.55)
    assert np.all(np.diag(est) > 0.3)


def test_tile_sampler_posterior_vs_conjugate():
    """The opt-in tile (kernel_impl="pallas") beside throughput_config's
    other options at n=4096 reaches the conjugate posterior mean."""
    rng = np.random.default_rng(1)
    n, p, n_obs = 4096, 16, 256
    X = rng.normal(size=(n_obs, p))
    y = X @ rng.normal(size=(p, 1)) + rng.normal(size=(n_obs, 1))
    model = LinearRegressionModel(p)
    cfg = dict(throughput_config(n, p), kernel_impl="pallas")
    s = SVGDSampler(n_particles=n, log_p=model.log_p,
                    param_template=model.template(),
                    gd=Adam(learning_rate=5e-2, decay=0.995),
                    key=jax.random.PRNGKey(0), **cfg)
    s.run({"X": jnp.asarray(X, jnp.float32),
           "y": jnp.asarray(y, jnp.float32)}, 600)
    A = X.T @ X + np.eye(p)
    mean = np.linalg.solve(A, X.T @ y).ravel()
    sd = np.sqrt(np.diag(np.linalg.inv(A)))
    assert (np.abs(s.samples.mean(0) - mean) / sd).max() < 1.0


def _one_device_mesh(two_d=False):
    from jax.sharding import Mesh
    devs = np.asarray(jax.devices()[:1])
    if two_d:
        return Mesh(devs.reshape(1, 1), ("particles", "model"))
    return Mesh(devs, ("particles",))


def _linreg_sampler_pair(mesh_kw, n_particles=256, n_feats=64, **kw):
    X, y, theta0 = _linreg(seed=6, n_particles=n_particles, n_feats=n_feats)
    model = LinearRegressionModel(X.shape[1])
    batch = {"X": jnp.asarray(X, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}
    common = dict(n_particles=n_particles, log_p=model.log_p,
                  param_template=model.template(),
                  theta=jnp.asarray(theta0, jnp.float32), **kw)
    return (SVGDSampler(gd=Adam(learning_rate=1e-1), **common),
            SVGDSampler(gd=Adam(learning_rate=1e-1), **mesh_kw, **common),
            batch)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_ring_layout_vs_single_chip(warm):
    """comm='ring' compiled for the card on a 1-device mesh against the
    single-device step with the same bisect median: the ring assembles
    the same median rows, and its one rotation computes the same tile in
    another program, so the two agree to f32 rounding (not bitwise: XLA
    fuses the two programs differently)."""
    single, ring, batch = _linreg_sampler_pair(
        dict(mesh=_one_device_mesh(), comm="ring"), median="bisect",
        median_passes=40, warm_median=warm)
    aux_s = single.run(batch, 4)
    aux_r = ring.run(batch, 4)
    np.testing.assert_allclose(np.asarray(aux_r["h2"]),
                               np.asarray(aux_s["h2"]), rtol=1e-5)
    assert _rel(ring.state.opt_state.mu, single.state.opt_state.mu) < 1e-3


def test_mesh_custom_grads_on_chip():
    """A custom_grads hook (the Bayesian NN's gradients by vmap-autodiff,
    handed in as the hook) inside the sharded step's per-shard gradient
    stage on a 1-device mesh reproduces the single-device step."""
    from stein_jax.models import BayesianNNModel
    rng = np.random.default_rng(23)
    n, B = 256, 20
    model = BayesianNNModel(1, 32, n_train=B, n_batch=B, prior_beta=10.0)
    n_params, unravel = template_unraveler(model.template())
    theta0 = jnp.asarray(rng.normal(size=(n, n_params)) * 0.05, jnp.float32)
    X = rng.uniform(size=(B, 1))
    y = np.cos(10 * X) * (5 * X) + rng.normal(size=(B, 1)) * 0.1
    batch = {"X": jnp.asarray(X, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}
    hook = jax.vmap(jax.value_and_grad(
        lambda row, b: model.log_p(unravel(row), b)), in_axes=(0, None))
    common = dict(n_particles=n, log_p=model.log_p,
                  param_template=model.template(), theta=theta0,
                  median="bisect", custom_grads=hook)
    mc = SVGDSampler(gd=Adam(learning_rate=1e-2), mesh=_one_device_mesh(),
                     **common)
    sc = SVGDSampler(gd=Adam(learning_rate=1e-2), **common)
    for _ in range(5):
        aux_m = mc.train_on_batch(batch)
        aux_s = sc.train_on_batch(batch)
    assert _rel(mc.state.opt_state.mu, sc.state.opt_state.mu) < 1e-3
    np.testing.assert_allclose(float(aux_m["log_p_mean"]),
                               float(aux_s["log_p_mean"]), rtol=1e-4)


def test_mesh2d_tuned_config_on_chip():
    """throughput_config(model_axis=) compiled for the card on a (1, 1)
    particles x model mesh tracks the single-device throughput_config
    step (the same warm median over the same rows; D's model-axis psum is
    trivial): the first moment to f32 rounding, posterior moments
    tightly."""
    n, p = 512, 32
    cfg2 = throughput_config(n, p, mesh=_one_device_mesh(True),
                             model_axis="model")
    assert cfg2["median_collectives"] == "rounds"
    cfg1 = throughput_config(n, p)
    mesh_kw = {k: cfg2[k] for k in ("mesh", "model_axis",
                                    "median_collectives")}
    single, mesh2d, batch = _linreg_sampler_pair(
        mesh_kw, n_particles=n, n_feats=p, **cfg1)
    single.run(batch, 5)
    mesh2d.run(batch, 5)
    assert _rel(mesh2d.state.opt_state.mu, single.state.opt_state.mu) < 1e-3
    a, b = np.asarray(mesh2d.samples), np.asarray(single.samples)
    np.testing.assert_allclose(a.mean(0), b.mean(0), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(a.std(0), b.std(0), rtol=5e-3, atol=1e-4)
