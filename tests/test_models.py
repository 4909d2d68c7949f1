"""Model log-posteriors vs independent NumPy computations, and a Bayesian-NN
golden trajectory driven by hand-derived NumPy backprop gradients (fully
independent of JAX autodiff)."""

import numpy as np
import jax
import jax.numpy as jnp
from scipy.special import gammaln as scipy_gammaln

from baselines.numpy_svgd import NumpySVGD, NumpyAdam
from stein_jax import SVGDSampler, Adam
from stein_jax.models import (
    LinearRegressionModel,
    LogisticRegressionModel,
    BayesianNNModel,
)
from stein_jax.utils.ravel import template_unraveler


def _np_normal_logpdf(x, loc, scale):
    z = (x - loc) / scale
    return -0.5 * z ** 2 - np.log(scale) - 0.5 * np.log(2 * np.pi)


def _np_gamma_logpdf(x, a, b):
    return a * np.log(b) - scipy_gammaln(a) + (a - 1) * np.log(x) - b * x


def test_linear_regression_log_p():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(30, 4))
    y = rng.normal(size=(30, 1))
    w = rng.normal(size=(4, 1))
    model = LinearRegressionModel(4)
    got = float(model.log_p(
        {"w": jnp.asarray(w)}, {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    ))
    expect = (
        -0.5 * np.sum((X @ w - y) ** 2)
        + np.sum(_np_normal_logpdf(w, 0.0, 1.0))
    )
    np.testing.assert_allclose(got, expect, rtol=1e-12)


def test_logistic_regression_log_p():
    rng = np.random.default_rng(1)
    n, k = 25, 6
    X = rng.normal(size=(n, k))
    y = (rng.uniform(size=(n, 1)) > 0.5).astype(float)
    w = rng.normal(size=(k, 1))
    log_alpha = 0.3
    model = LogisticRegressionModel(k, n_train=500, n_batch=n)
    got = float(model.log_p(
        {"w": jnp.asarray(w), "log_alpha": jnp.asarray(log_alpha)},
        {"X": jnp.asarray(X), "y": jnp.asarray(y)},
    ))
    alpha = np.exp(log_alpha)
    logits = X @ w
    # tf.nn.sigmoid_cross_entropy_with_logits formula
    ce = np.maximum(logits, 0) - logits * y + np.log1p(np.exp(-np.abs(logits)))
    expect = (
        -np.sum(ce) * (500 / n)
        + np.sum(_np_normal_logpdf(w, 0.0, 1.0 / np.sqrt(alpha)))
        + _np_gamma_logpdf(alpha, 1.0, 0.01)
    )
    np.testing.assert_allclose(got, expect, rtol=1e-12)


def _np_nn_log_p_and_grad(theta_row, batch, model):
    """Independent NumPy forward + hand-derived backprop for BayesianNNModel.

    Parameter layout must match JAX's sorted-dict flattening:
    b_1, b_2, log_gamma, log_lambda, w_1, w_2.
    """
    X, y = batch["X"], batch["y"]
    nf, nh = model.n_feats, model.n_hidden
    i = 0
    b1 = theta_row[i:i + nh]; i += nh
    b2 = theta_row[i]; i += 1
    log_gamma = theta_row[i]; i += 1
    log_lambda = theta_row[i]; i += 1
    w1 = theta_row[i:i + nf * nh].reshape(nf, nh); i += nf * nh
    w2 = theta_row[i:i + nh].reshape(nh, 1); i += nh
    assert i == theta_row.size

    lam, gam = np.exp(log_lambda), np.exp(log_gamma)
    a, b = model.prior_alpha, model.prior_beta
    Z = X @ w1 + b1
    H = np.maximum(Z, 0.0)
    pred = H @ w2 + b2
    resid = y - pred
    n_obs = X.shape[0]

    log_l = np.sum(_np_normal_logpdf(y, pred, 1.0 / np.sqrt(gam)))
    sq_w = np.sum(w1 ** 2) + np.sum(w2 ** 2) + np.sum(b1 ** 2) + b2 ** 2
    n_w = w1.size + w2.size + b1.size + 1
    log_prior = (
        _np_gamma_logpdf(lam, a, b) + _np_gamma_logpdf(gam, a, b)
        - 0.5 * lam * sq_w + 0.5 * n_w * np.log(lam)
        - 0.5 * n_w * np.log(2 * np.pi)
    )
    scale = model.n_train / model.n_batch
    log_p = (log_l * scale + log_prior) / model.n_train

    # Backprop. d log_l/d pred = gam * resid.
    d = gam * resid * scale                      # [n_obs, 1]
    g_w2 = H.T @ d - lam * w2
    g_b2 = np.sum(d) - lam * b2
    dH = d @ w2.T
    dZ = dH * (Z > 0)
    g_w1 = X.T @ dZ - lam * w1
    g_b1 = np.sum(dZ, axis=0) - lam * b1
    g_log_gamma = (
        (-0.5 * np.sum(resid ** 2) * gam + 0.5 * n_obs) * scale
        + (a - 1) - b * gam
    )
    g_log_lambda = -0.5 * lam * sq_w + 0.5 * n_w + (a - 1) - b * lam

    grad = np.concatenate([
        g_b1, [g_b2], [g_log_gamma], [g_log_lambda],
        g_w1.ravel(), g_w2.ravel(),
    ]) / model.n_train
    return log_p, grad


def test_nn_log_p_and_grad_vs_numpy():
    """JAX autodiff gradient == hand-derived backprop, elementwise."""
    rng = np.random.default_rng(2)
    model = BayesianNNModel(2, 8, n_train=100, n_batch=10)
    n_params, unravel = template_unraveler(model.template(jnp.float64))
    theta_row = rng.normal(size=n_params) * 0.5
    X = rng.uniform(size=(10, 2))
    y = rng.normal(size=(10, 1))
    batch = {"X": X, "y": y}
    jbatch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}

    log_p_np, grad_np = _np_nn_log_p_and_grad(theta_row, batch, model)

    def log_p_flat(row):
        return model.log_p(unravel(row), jbatch)

    log_p_jax = float(log_p_flat(jnp.asarray(theta_row)))
    grad_jax = np.asarray(jax.grad(log_p_flat)(jnp.asarray(theta_row)))
    np.testing.assert_allclose(log_p_jax, log_p_np, rtol=1e-10)
    np.testing.assert_allclose(grad_jax, grad_np, rtol=1e-8, atol=1e-12)


def test_nn_golden_trajectory_vs_oracle():
    """Full SVGD trajectory on the Bayesian NN: SVGDSampler (JAX autodiff)
    vs the NumPy oracle driven by the independent backprop gradients."""
    rng = np.random.default_rng(3)
    model = BayesianNNModel(1, 8, n_train=20, n_batch=20)
    n_params, _ = template_unraveler(model.template(jnp.float64))
    n_particles = 8
    theta0 = rng.normal(size=(n_particles, n_params)) * 0.01
    X = rng.uniform(size=(20, 1))
    y = np.cos(10 * X) * (5 * X) + rng.normal(size=(20, 1)) * 0.1
    batch = {"X": X, "y": y}
    jbatch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}

    oracle = NumpySVGD(
        lambda row, b: _np_nn_log_p_and_grad(row, batch, model)[1],
        theta0, NumpyAdam(learning_rate=1e-1, decay=0.999),
    )
    sampler = SVGDSampler(
        n_particles=n_particles,
        log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1, decay=0.999),
        theta=jnp.asarray(theta0),
        dtype=jnp.float64,
    )
    for t in range(10):
        oracle.train_on_batch(None)
        sampler.train_on_batch(jbatch)
        np.testing.assert_allclose(
            sampler.samples, oracle.samples, rtol=1e-7, atol=1e-11,
            err_msg=f"step {t}",
        )


def test_model_precision_option():
    """precision='default'/'high'/'highest' resolve to lax.Precision and
    give identical log_p on CPU (precision only matters on accelerators)."""
    import jax
    import numpy as np
    import jax.numpy as jnp
    from stein_jax.models import LinearRegressionModel

    batch = {"X": jnp.asarray(np.ones((6, 4))),
             "y": jnp.asarray(np.ones((6, 1)))}
    vals = []
    for prec in ("high", "default", "highest"):
        m = LinearRegressionModel(4, precision=prec)
        assert isinstance(m._prec, jax.lax.Precision)
        vals.append(float(m.log_p(m.template(jnp.float64), batch)))
    assert vals[0] == vals[1] == vals[2]
    import pytest
    with pytest.raises(KeyError):
        LinearRegressionModel(4, precision="bf16")._prec


def test_linreg_sufficient_stats_exact():
    """The sufficient-statistics batch form is algebraically identical to
    the full-X likelihood (same log_p up to fp reduction order, same
    gradients) and the SVGD trajectory through it matches the full-X
    trajectory in f64."""
    import jax
    import numpy as np
    import jax.numpy as jnp
    from stein_jax import SVGDSampler, Adam
    from stein_jax.models import LinearRegressionModel

    rng = np.random.default_rng(3)
    p = 5
    X = rng.normal(size=(60, p))
    y = X @ rng.normal(size=(p, 1)) + 0.1 * rng.normal(size=(60, 1))
    model = LinearRegressionModel(p)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    suff = model.sufficient_batch(batch, dtype=jnp.float64)

    params = {"w": jnp.asarray(rng.normal(size=(p, 1)))}
    lp_full = float(model.log_p(params, batch))
    lp_suff = float(model.log_p(params, suff))
    np.testing.assert_allclose(lp_suff, lp_full, rtol=1e-12)
    g_full = jax.grad(model.log_p)(params, batch)["w"]
    g_suff = jax.grad(model.log_p)(params, suff)["w"]
    np.testing.assert_allclose(np.asarray(g_suff), np.asarray(g_full),
                               rtol=1e-10, atol=1e-12)

    def run(b):
        s = SVGDSampler(
            n_particles=32, log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(learning_rate=1e-1), key=jax.random.PRNGKey(0),
            dtype=jnp.float64,
        )
        s.run(b, 50)
        return s.samples

    np.testing.assert_allclose(run(suff), run(batch), rtol=1e-8,
                               atol=1e-10)


def test_custom_grads_sampler_matches_autodiff():
    """A sampler driven by a model-supplied gradient stage (custom_grads=)
    tracks the autodiff sampler over several warm-scan steps, and the
    option surface fails loudly where the hook cannot apply."""
    import pytest
    from jax.sharding import Mesh
    from stein_jax.models import BayesianNNModel
    from stein_jax.utils.ravel import template_unraveler

    rng = np.random.default_rng(1)
    n, B, f, H = 128, 16, 1, 20
    model = BayesianNNModel(f, H, n_train=B, n_batch=B, prior_beta=10.0)
    X = rng.uniform(size=(B, f)).astype(np.float32)
    y = np.cos(10 * X) * (5 * X) + rng.normal(size=(B, 1)) * 0.1
    batch = {"X": jnp.asarray(X, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}
    _, unravel = template_unraveler(model.template())

    @jax.jit
    def hook(theta, batch):
        return jax.vmap(jax.value_and_grad(
            lambda row, b: model.log_p(unravel(row), b)),
            in_axes=(0, None))(theta, batch)

    def make(**kw):
        return SVGDSampler(
            n_particles=n, log_p=model.log_p,
            param_template=model.template(),
            gd=Adam(learning_rate=1e-1), key=jax.random.PRNGKey(2),
            median="bisect", warm_median=True, **kw,
        )

    a = make()
    b = make(custom_grads=hook)
    a.run(batch, 5)
    b.run(batch, 5)
    np.testing.assert_allclose(b.samples, a.samples, rtol=2e-4,
                               atol=1e-6)

    with pytest.raises(ValueError, match="custom_grads"):
        make(custom_grads=hook, remat=True)
    # 1-D meshes accept the hook (it is row-local; parity pinned by
    # tests/test_sharded.py::test_mesh_custom_grads_matches_single);
    # only 2-D meshes refuse.
    m2 = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
              ("particles", "model"))
    with pytest.raises(ValueError, match="1-D particle"):
        make(custom_grads=hook, mesh=m2, model_axis="model")
