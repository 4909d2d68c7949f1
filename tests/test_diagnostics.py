"""KSD diagnostic: closed-form vectorised KSD vs a tiny NumPy double loop,
and its behavior as a convergence measure."""

import numpy as np
import jax
import jax.numpy as jnp

from stein_jax import SVGDSampler, Adam
from stein_jax.models import LinearRegressionModel
from stein_jax.ops.diagnostics import ksd_rbf
from baselines.numpy_svgd import pairwise_sq_dists


def _np_ksd(theta, grads, h2, u_statistic=False):
    n, p = theta.shape
    D = pairwise_sq_dists(theta)
    total = 0.0
    for i in range(n):
        for j in range(n):
            if u_statistic and i == j:
                continue
            k = np.exp(-D[i, j] / h2 / 2.0)
            diff = theta[i] - theta[j]
            u = k * (
                grads[i] @ grads[j]
                + (grads[i] - grads[j]) @ diff / h2
                + p / h2
                - D[i, j] / h2 ** 2
            )
            total += u
    return total / (n * (n - 1) if u_statistic else n * n)


def test_ksd_matches_numpy_loop():
    rng = np.random.default_rng(0)
    theta = rng.normal(size=(12, 4))
    grads = rng.normal(size=(12, 4))
    h2 = 1.7
    for u in [False, True]:
        got = float(ksd_rbf(
            jnp.asarray(theta), jnp.asarray(grads), h2=jnp.float64(h2),
            u_statistic=u,
        ))
        expect = _np_ksd(theta, grads, h2, u_statistic=u)
        np.testing.assert_allclose(got, expect, rtol=1e-9)


def test_ksd_decreases_under_svgd():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(40, 3))
    y = X @ rng.normal(size=(3, 1)) + rng.normal(size=(40, 1)) * 0.3
    model = LinearRegressionModel(3)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    sampler = SVGDSampler(
        n_particles=64, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1), key=jax.random.PRNGKey(0),
        dtype=jnp.float64,
    )
    ksd_init = sampler.ksd(batch)
    sampler.run(batch, 400)
    ksd_final = sampler.ksd(batch)
    assert ksd_final < ksd_init / 10
    # V-statistic KSD^2 is nonnegative.
    assert ksd_final >= 0


def test_streaming_ksd_matches_dense(monkeypatch):
    """Above KSD_DENSE_MAX_N ksd_rbf streams row blocks (peak memory
    O(block_rows x n) instead of six [n, n] arrays); the streamed sum
    must equal the dense form — same arithmetic, different matmul
    partitioning. Forced here by lowering the threshold; includes an
    n not divisible by block_rows (remainder path) and both statistics."""
    from stein_jax.ops import diagnostics

    rng = np.random.default_rng(2)
    for n in (64, 71):
        theta = jnp.asarray(rng.normal(size=(n, 5)))
        grads = jnp.asarray(rng.normal(size=(n, 5)))
        for u in (False, True):
            for h2 in (None, jnp.float64(2.3)):
                dense = float(ksd_rbf(theta, grads, h2=h2, u_statistic=u))
                monkeypatch.setattr(diagnostics, "KSD_DENSE_MAX_N", 16)
                blocked = float(ksd_rbf(theta, grads, h2=h2,
                                        u_statistic=u, block_rows=16))
                monkeypatch.undo()
                np.testing.assert_allclose(blocked, dense, rtol=1e-12)
