"""Pluggable kernel layer: reference-compatible kernel_and_grad surface,
IMQ closed form vs autodiff, and the generic phi path vs the fused RBF
path."""

import numpy as np
import jax
import jax.numpy as jnp

from baselines import numpy_svgd
from stein_jax import SVGDSampler, Adam
from stein_jax.kernels import (
    SquaredExponentialKernel,
    InverseMultiquadricKernel,
    generic_svgd_phi,
)
from stein_jax.models import LinearRegressionModel
from stein_jax.ops import rbf


def test_rbf_kernel_and_grad_matches_oracle():
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(20, 5))
    K_np, dK_np, _ = numpy_svgd.rbf_kernel_and_repulse(theta)
    K, dK = SquaredExponentialKernel().kernel_and_grad(jnp.asarray(theta))
    np.testing.assert_allclose(np.asarray(K), K_np, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(dK), dK_np, rtol=1e-8, atol=1e-12)


def test_imq_repulsive_matches_autodiff():
    """dK == -0.5 * grad of sum(K) w.r.t. theta (same double-counting
    convention as the reference's RBF; K symmetric)."""
    rng = np.random.default_rng(1)
    theta = jnp.asarray(rng.normal(size=(12, 4)))
    kern = InverseMultiquadricKernel(c=1.0, beta=-0.5)
    n = theta.shape[0]
    D = rbf.pairwise_sq_dists(theta)
    h2 = rbf.bandwidth_sq_from_median(jnp.median(D), n)

    K, dK = kern.kernel_and_grad(theta)

    def sum_K(th):
        r = jnp.sum(th * th, axis=1, keepdims=True)
        Dm = r + r.T - 2.0 * th @ th.T
        return jnp.sum((kern.c ** 2 + Dm / h2) ** kern.beta)

    autodiff = jax.grad(sum_K)(theta)
    np.testing.assert_allclose(
        np.asarray(dK), -0.5 * np.asarray(autodiff), rtol=1e-8, atol=1e-12
    )


def test_generic_phi_rbf_matches_fused():
    rng = np.random.default_rng(2)
    theta = jnp.asarray(rng.normal(size=(24, 6)))
    grads = jnp.asarray(rng.normal(size=(24, 6)))
    phi_fused, aux_fused = rbf.svgd_phi(theta, grads)
    phi_gen, aux_gen = generic_svgd_phi(
        SquaredExponentialKernel(), theta, grads
    )
    np.testing.assert_allclose(
        np.asarray(phi_gen), np.asarray(phi_fused), rtol=1e-9, atol=1e-13
    )
    np.testing.assert_allclose(
        float(aux_gen["h2"]), float(aux_fused["h2"]), rtol=1e-12
    )


def test_sampler_with_imq_kernel_converges():
    """IMQ-kernel SVGD samples the conjugate linear-regression posterior."""
    rng = np.random.default_rng(3)
    n_obs, n_feats, n_particles = 40, 3, 64
    X = rng.normal(size=(n_obs, n_feats))
    y = X @ (rng.normal(size=(n_feats, 1)) * 2.0) + rng.normal(
        size=(n_obs, 1)
    ) * 0.3
    model = LinearRegressionModel(n_feats)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    sampler = SVGDSampler(
        n_particles=n_particles, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1), key=jax.random.PRNGKey(0),
        dtype=jnp.float64, kernel=InverseMultiquadricKernel(),
    )
    sampler.run(batch, 600)
    A = X.T @ X + np.eye(n_feats)
    cov = np.linalg.inv(A)
    mean = (cov @ X.T @ y).ravel()
    mc = np.sqrt(np.diag(cov) / n_particles)
    np.testing.assert_allclose(
        sampler.samples.mean(axis=0), mean, atol=4 * mc.max()
    )


def test_imq_with_pallas_raises():
    import pytest
    model = LinearRegressionModel(3)
    with pytest.raises(ValueError):
        SVGDSampler(
            n_particles=8, log_p=model.log_p,
            param_template=model.template(jnp.float64),
            gd=Adam(), dtype=jnp.float64,
            kernel=InverseMultiquadricKernel(), kernel_impl="pallas",
        )


def test_rbf_subclass_routes_to_generic_path():
    """A SquaredExponentialKernel SUBCLASS with an overridden weights()
    must NOT be silently rerouted to the fused RBF path (exact-type
    dispatch): its trajectory follows its own weights, matching kernel=
    the equivalent non-subclass kernel."""
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class ImqViaRbfSubclass(SquaredExponentialKernel):
        def weights(self, D, h2):
            return InverseMultiquadricKernel(c=1.0, beta=-0.5).weights(
                D, h2
            )

    rng = np.random.default_rng(3)
    X = rng.normal(size=(20, 3))
    y = X @ rng.normal(size=(3, 1))
    model = LinearRegressionModel(3)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    theta0 = rng.normal(size=(8, 3)) * 0.01
    common = dict(
        n_particles=8, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64,
    )
    sub = SVGDSampler(gd=Adam(learning_rate=1e-1),
                      kernel=ImqViaRbfSubclass(), **common)
    imq = SVGDSampler(gd=Adam(learning_rate=1e-1),
                      kernel=InverseMultiquadricKernel(), **common)
    rbf_s = SVGDSampler(gd=Adam(learning_rate=1e-1),
                        kernel=SquaredExponentialKernel(), **common)
    for _ in range(3):
        sub.train_on_batch(batch)
        imq.train_on_batch(batch)
        rbf_s.train_on_batch(batch)
    np.testing.assert_allclose(sub.samples, imq.samples, rtol=1e-12)
    assert np.abs(sub.samples - rbf_s.samples).max() > 1e-10


def test_imq_invalid_params_raise():
    """Regression (r3 review): beta >= 0 flips the repulsion into
    attraction (silently wrong posterior geometry) and c == 0 puts inf
    on the kernel diagonal — both must fail at construction."""
    import pytest
    from stein_jax.kernels import InverseMultiquadricKernel

    with pytest.raises(ValueError, match="beta < 0"):
        InverseMultiquadricKernel(beta=0.5)
    with pytest.raises(ValueError, match="beta < 0"):
        InverseMultiquadricKernel(beta=0.0)
    with pytest.raises(ValueError, match="c != 0"):
        InverseMultiquadricKernel(c=0.0)
    InverseMultiquadricKernel(c=-1.0)  # c enters as c^2: any nonzero ok
