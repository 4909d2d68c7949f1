"""Statistical validation on analytically-known targets: SVGD particle
moments must converge to the target's moments within Monte-Carlo error
(BASELINE.json correctness metric)."""

import numpy as np
import jax
import jax.numpy as jnp

from stein_jax import SVGDSampler, Adam, Adagrad


def _gaussian_target(mu, cov):
    prec = jnp.asarray(np.linalg.inv(cov))
    mu = jnp.asarray(mu)

    def log_p(params, batch):
        d = params["x"] - mu
        return -0.5 * d @ prec @ d

    template = {"x": jnp.zeros(mu.shape, jnp.float64)}
    return log_p, template


def test_correlated_gaussian_moments():
    mu = np.array([1.0, -2.0, 0.5])
    cov = np.array([
        [1.0, 0.7, 0.2],
        [0.7, 1.5, -0.3],
        [0.2, -0.3, 0.8],
    ])
    log_p, template = _gaussian_target(mu, cov)
    n = 128
    sampler = SVGDSampler(
        n_particles=n, log_p=log_p, param_template=template,
        gd=Adam(learning_rate=5e-2), key=jax.random.PRNGKey(1),
        dtype=jnp.float64,
    )
    sampler.run(batch=None, n_steps=1500)
    s = sampler.samples
    mc = np.sqrt(np.diag(cov) / n)
    np.testing.assert_allclose(s.mean(axis=0), mu, atol=4 * mc.max())
    # Full covariance within a generous band (SVGD finite-n shrinks
    # variance somewhat).
    est_cov = np.cov(s.T)
    np.testing.assert_allclose(est_cov, cov, atol=0.45)
    corr = est_cov[0, 1] / np.sqrt(est_cov[0, 0] * est_cov[1, 1])
    true_corr = cov[0, 1] / np.sqrt(cov[0, 0] * cov[1, 1])
    assert abs(corr - true_corr) < 0.2


def test_gaussian_adagrad_converges():
    mu = np.array([2.0, -1.0])
    cov = np.eye(2) * 0.5
    log_p, template = _gaussian_target(mu, cov)
    n = 64
    sampler = SVGDSampler(
        n_particles=n, log_p=log_p, param_template=template,
        gd=Adagrad(learning_rate=5e-2), key=jax.random.PRNGKey(2),
        dtype=jnp.float64,
    )
    sampler.run(batch=None, n_steps=1500)
    s = sampler.samples
    np.testing.assert_allclose(
        s.mean(axis=0), mu, atol=4 * np.sqrt(0.5 / n)
    )


def test_bimodal_1d_mass_split():
    """Equal-weight 1-D Gaussian mixture: particles should split mass
    roughly evenly between the modes — the classic SVGD sanity check."""
    def log_p(params, batch):
        x = params["x"][0]
        la = -0.5 * (x - 3.0) ** 2
        lb = -0.5 * (x + 3.0) ** 2
        return jax.scipy.special.logsumexp(jnp.stack([la, lb]))

    template = {"x": jnp.zeros((1,), jnp.float64)}
    n = 100
    sampler = SVGDSampler(
        n_particles=n, log_p=log_p, param_template=template,
        gd=Adam(learning_rate=1e-1), key=jax.random.PRNGKey(3),
        dtype=jnp.float64,
    )
    # Start spread across both basins (default 0.01*N init sits at the
    # saddle; widen it).
    sampler.state = sampler.state._replace(
        particles=jnp.asarray(
            np.random.default_rng(0).normal(size=(n, 1)) * 3.0
        )
    )
    sampler.run(batch=None, n_steps=2000)
    s = sampler.samples.ravel()
    frac_right = np.mean(s > 0)
    assert 0.3 < frac_right < 0.7
    # Modes roughly at +-3.
    assert abs(np.mean(s[s > 0]) - 3.0) < 0.5
    assert abs(np.mean(s[s < 0]) + 3.0) < 0.5


def test_bfloat16_end_to_end_posterior():
    """Whole-sampler bf16 (particles, moments, phi — the XLA path; the
    dtype a user reaches for to halve memory traffic): posterior
    moments land inside the Monte-Carlo band, at a coarser — measured
    and documented — tolerance than f32.

    This is only possible because the optimizer's scalar arithmetic runs
    at >= f32 (ops/optimizers._scalar_dtype): bf16 cannot represent
    beta_2=0.999 (nearest bf16 is exactly 1.0), which made 1 - b2**t == 0
    -> nu_hat = inf -> every Adam step exactly zero before the r4 fix.

    Measured on this target (n=128, 1500 steps): mean err ~0.20 (4x MC
    = 0.43), diag-cov shrink ~20-25% below truth from the bf16
    quantization floor (relative particle resolution 2^-9) — vs f32's
    mean err 0.003. bf16 trades that statistical coarseness for ~2x
    memory."""
    mu = np.array([1.0, -2.0, 0.5])
    cov = np.array([
        [1.0, 0.7, 0.2],
        [0.7, 1.5, -0.3],
        [0.2, -0.3, 0.8],
    ])
    prec = jnp.asarray(np.linalg.inv(cov), jnp.float32)
    muj = jnp.asarray(mu, jnp.float32)

    def log_p(params, batch):
        # The model computes at f32 from bf16 particles (the recommended
        # mixed regime: storage bf16, math f32).
        d = params["x"].astype(jnp.float32) - muj
        return -0.5 * d @ prec @ d

    n = 128
    sampler = SVGDSampler(
        n_particles=n, log_p=log_p,
        param_template={"x": jnp.zeros((3,), jnp.bfloat16)},
        gd=Adam(learning_rate=5e-2), key=jax.random.PRNGKey(1),
        dtype=jnp.bfloat16,
    )
    sampler.run(batch=None, n_steps=1500)
    s = np.asarray(sampler.samples, np.float64)
    assert np.isfinite(s).all()
    mc = np.sqrt(np.diag(cov) / n)
    np.testing.assert_allclose(s.mean(axis=0), mu, atol=4 * mc.max())
    # Covariance within a bf16-width band: shrinkage up to ~35% of scale
    # (measured ~20-25%), far coarser than f32's but structurally right.
    est = np.cov(s.T)
    np.testing.assert_allclose(est, cov, atol=0.55)
    assert np.all(np.diag(est) > 0.3)


def test_warm_median_posterior_statistically_equal():
    """The warm search's per-step bandwidth error (up to the binding-bracket
    bound ~1.1% at warm_passes=6 on fast-drift steps — see
    ops/median.warm_bisect_median) must be STATISTICALLY invisible: warm and cold
    trajectories from the same init converge to the same posterior
    moments, even though the trajectories themselves diverge chaotically."""
    mu = np.array([1.0, -2.0, 0.5])
    cov = np.array([
        [1.0, 0.7, 0.2],
        [0.7, 1.5, -0.3],
        [0.2, -0.3, 0.8],
    ])
    log_p, template = _gaussian_target(mu, cov)
    n = 128

    def run(**kw):
        s = SVGDSampler(
            n_particles=n, log_p=log_p, param_template=template,
            gd=Adam(learning_rate=5e-2), key=jax.random.PRNGKey(1),
            dtype=jnp.float64, median="bisect", **kw,
        )
        s.run(batch=None, n_steps=1500)
        return s.samples

    cold = run()
    warm = run(warm_median=True, warm_passes=6)
    # Identical convergence targets: mean and covariance agree far inside
    # the Monte-Carlo band (they'd match the truth independently anyway;
    # this pins them to each OTHER much tighter).
    np.testing.assert_allclose(
        warm.mean(axis=0), cold.mean(axis=0), atol=0.05
    )
    np.testing.assert_allclose(
        np.cov(warm.T), np.cov(cold.T), atol=0.08
    )
