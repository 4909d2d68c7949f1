"""JAX ops vs the NumPy oracle: distances, kernel, repulsive term, phi,
and the median backends."""

import numpy as np
import jax.numpy as jnp
import pytest

from baselines import numpy_svgd
from stein_jax.ops import rbf
from stein_jax.ops.median import (
    exact_median,
    subsampled_sq_dist_median,
    binned_median,
)


@pytest.fixture
def theta():
    rng = np.random.default_rng(7)
    return rng.normal(size=(32, 11))


def test_pairwise_sq_dists(theta):
    D_np = numpy_svgd.pairwise_sq_dists(theta)
    D_jax = rbf.pairwise_sq_dists(jnp.asarray(theta))
    # atol covers the ~0 diagonal, where matmul reduction-order noise makes
    # a pure-relative comparison meaningless.
    np.testing.assert_allclose(np.asarray(D_jax), D_np, rtol=1e-10, atol=1e-11)


def test_kernel_and_repulse(theta):
    K_np, dK_np, h2_np = numpy_svgd.rbf_kernel_and_repulse(theta)
    K, dK, h2 = rbf.rbf_kernel_and_repulse(jnp.asarray(theta))
    np.testing.assert_allclose(np.asarray(h2), h2_np, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(K), K_np, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(dK), dK_np, rtol=1e-8, atol=1e-12)


def test_svgd_phi(theta):
    rng = np.random.default_rng(8)
    grads = rng.normal(size=theta.shape)
    phi_np, h2_np = numpy_svgd.compute_phi(theta, grads)
    phi, aux = rbf.svgd_phi(jnp.asarray(theta), jnp.asarray(grads))
    np.testing.assert_allclose(np.asarray(phi), phi_np, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(np.asarray(aux["h2"]), h2_np, rtol=1e-10)


def test_exact_median(theta):
    D = numpy_svgd.pairwise_sq_dists(theta)
    assert np.isclose(
        float(exact_median(jnp.asarray(D))), np.median(D.ravel())
    )


def test_subsampled_median_full_rows_is_exact(theta):
    D = numpy_svgd.pairwise_sq_dists(theta)
    med = subsampled_sq_dist_median(jnp.asarray(theta), max_rows=64)
    assert np.isclose(float(med), np.median(D.ravel()))


def test_subsampled_median_is_close():
    rng = np.random.default_rng(9)
    theta = rng.normal(size=(512, 7))
    D = numpy_svgd.pairwise_sq_dists(theta)
    exact = np.median(D.ravel())
    med = float(subsampled_sq_dist_median(jnp.asarray(theta), max_rows=128))
    assert abs(med - exact) / exact < 0.05


def test_binned_median_near_exact():
    rng = np.random.default_rng(10)
    theta = rng.normal(size=(512, 7))
    D = numpy_svgd.pairwise_sq_dists(theta)
    exact = np.median(D.ravel())
    med = float(
        binned_median(jnp.asarray(theta), n_bins=1024, n_levels=2,
                      block_rows=128)
    )
    # Two levels of 1024 bins: interval width ~ range/2^20.
    assert abs(med - exact) / exact < 1e-4


def test_binned_median_nondivisible_blocks():
    rng = np.random.default_rng(11)
    theta = rng.normal(size=(300, 5))  # 300 % 128 != 0
    D = numpy_svgd.pairwise_sq_dists(theta)
    exact = np.median(D.ravel())
    med = float(
        binned_median(jnp.asarray(theta), n_bins=1024, n_levels=2,
                      block_rows=128)
    )
    assert abs(med - exact) / exact < 1e-4


def test_bisect_median_exact_small():
    from stein_jax.ops.median import bisect_median
    rng = np.random.default_rng(12)
    theta = rng.normal(size=(100, 7))
    D = numpy_svgd.pairwise_sq_dists(theta)
    exact = np.median(D.ravel())
    med = float(bisect_median(jnp.asarray(theta), max_rows=128, passes=50))
    # 50 halvings: exact to fp resolution of the full matrix.
    assert abs(med - exact) / exact < 1e-9


def test_bisect_median_subsampled_close():
    from stein_jax.ops.median import bisect_median
    rng = np.random.default_rng(13)
    theta = rng.normal(size=(512, 7))
    D = numpy_svgd.pairwise_sq_dists(theta)
    exact = np.median(D.ravel())
    med = float(bisect_median(jnp.asarray(theta), max_rows=128))
    assert abs(med - exact) / exact < 0.05


def test_sampler_bisect_median_mode():
    """median='bisect' end-to-end tracks the exact-median sampler when the
    subsample covers all rows (medians then agree to fp resolution)."""
    import jax
    from stein_jax import SVGDSampler, Adam
    from stein_jax.models import LinearRegressionModel
    rng = np.random.default_rng(14)
    X = rng.normal(size=(40, 3))
    y = X @ rng.normal(size=(3, 1))
    model = LinearRegressionModel(3)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    theta0 = rng.normal(size=(16, 3)) * 0.01
    common = dict(
        n_particles=16, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64,
    )
    a = SVGDSampler(gd=Adam(learning_rate=1e-1), median="exact", **common)
    b = SVGDSampler(gd=Adam(learning_rate=1e-1), median="bisect", **common)
    for _ in range(5):
        a.train_on_batch(batch)
        b.train_on_batch(batch)
    np.testing.assert_allclose(b.samples, a.samples, rtol=1e-6, atol=1e-9)


def test_binned_median_no_f32_saturation_at_large_n():
    """Regression: boundary bins collect >2^24 entries during level-2
    refinement at n>5793; the per-block int32 scatter must not saturate
    (a direct f32 scatter-add of 1.0 would)."""
    rng = np.random.default_rng(15)
    n = 6000   # n^2 = 36M; level-2 boundary bins hold ~18M > 2^24
    theta = rng.normal(size=(n, 3)).astype(np.float32)
    D = numpy_svgd.pairwise_sq_dists(theta.astype(np.float64))
    exact = np.median(D.ravel())
    med = float(
        binned_median(jnp.asarray(theta), n_bins=1024, n_levels=2,
                      block_rows=512)
    )
    assert abs(med - exact) / exact < 1e-4


def test_warm_bisect_median():
    from stein_jax.ops.median import warm_bisect_median, bisect_median
    rng = np.random.default_rng(20)
    theta = rng.normal(size=(200, 5))
    D = numpy_svgd.pairwise_sq_dists(theta)
    vals = np.sort(D.ravel())
    k_lo = (vals.size + 1) // 2
    # warm_bisect searches the single k_lo-th order statistic (the two
    # middles of np.median differ by < the heuristic's sensitivity).
    exact = vals[k_lo - 1]
    # Warm start from a nearby hint: tight [0.92, 1.09] bracket, error
    # ~0.17*med/4^rounds.
    warm = float(warm_bisect_median(jnp.asarray(theta),
                                    jnp.float64(exact * 1.02),
                                    max_rows=256, warm_passes=12))
    assert abs(warm - exact) / exact < 2e-4
    # A 2.5x-off hint falls through to the wide [0.25, 4] bracket —
    # coarser but still bracketed (error ~3.75*med/4^rounds).
    wide = float(warm_bisect_median(jnp.asarray(theta),
                                    jnp.float64(exact * 2.5),
                                    max_rows=256, warm_passes=8))
    assert abs(wide - exact) / exact < 0.05
    # No hint (0) or a wildly wrong one (>4x): every bracket fails its
    # count check and the search runs branchlessly from the full range —
    # exact given enough passes.
    cold = float(warm_bisect_median(jnp.asarray(theta), jnp.float64(0.0),
                                    max_rows=256, warm_passes=80))
    assert abs(cold - exact) / exact < 1e-9
    bad = float(warm_bisect_median(jnp.asarray(theta),
                                   jnp.float64(exact * 100.0),
                                   max_rows=256, warm_passes=80))
    assert abs(bad - exact) / exact < 1e-9


def test_bisect_on_D_matches_theta_entry():
    """The on-D entry points (used by the XLA phi path to reuse its
    materialised D) must equal the theta-based ones bitwise: the strided
    row subsample selects the same rows and the same-precision Gram gives
    the same values."""
    from stein_jax.ops import rbf
    from stein_jax.ops.median import (
        bisect_median, bisect_median_on_D,
        warm_bisect_median, warm_bisect_median_on_D,
    )
    rng = np.random.default_rng(22)
    for n in (100, 700):     # below and above max_rows
        theta = jnp.asarray(rng.normal(size=(n, 4)))
        D = rbf.pairwise_sq_dists(theta)
        a = float(bisect_median(theta, max_rows=256, passes=40))
        b = float(bisect_median_on_D(D, max_rows=256, passes=40))
        assert a == b, (n, a, b)
        hint = jnp.float64(a * 1.01)
        c = float(warm_bisect_median(theta, hint, max_rows=256))
        d = float(warm_bisect_median_on_D(D, hint, max_rows=256))
        assert c == d, (n, c, d)


def test_warm_median_sampler_tracks_cold():
    import jax
    from stein_jax import SVGDSampler, Adam
    from stein_jax.models import LinearRegressionModel
    rng = np.random.default_rng(21)
    X = rng.normal(size=(40, 3))
    y = X @ rng.normal(size=(3, 1))
    model = LinearRegressionModel(3)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    theta0 = rng.normal(size=(16, 3)) * 0.01
    common = dict(
        n_particles=16, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        theta=jnp.asarray(theta0), dtype=jnp.float64, median="bisect",
    )
    a = SVGDSampler(gd=Adam(learning_rate=1e-1), **common)
    b = SVGDSampler(gd=Adam(learning_rate=1e-1), warm_median=True, **common)
    a.run(batch, 50)
    b.run(batch, 50)
    # Warm medians are ~0.2%-resolution vs the cold search; tiny
    # bandwidth differences compound over 50 steps, so compare at the
    # particle scale (near-zero coordinates have large relative noise).
    np.testing.assert_allclose(b.samples, a.samples, rtol=5e-2, atol=2e-2)
    # And the posterior means coincide much more tightly.
    np.testing.assert_allclose(
        b.samples.mean(axis=0), a.samples.mean(axis=0), rtol=5e-3,
        atol=1e-3,
    )


def test_bisect_quad_branch_accuracy():
    """Single-rank quad-ary branch (total > 100k): vs the exact order
    statistic."""
    from stein_jax.ops.median import bisect_median
    rng = np.random.default_rng(22)
    theta = rng.normal(size=(600, 5))          # total = 512*600 = 307k
    D = numpy_svgd.pairwise_sq_dists(theta)
    rows = np.arange(512) * (600 // 512)
    Dsub = D[rows]                             # matches the strided subsample
    vals = np.sort(Dsub.ravel())
    k_lo = (vals.size + 1) // 2
    exact = vals[k_lo - 1]
    med = float(bisect_median(jnp.asarray(theta), max_rows=512, passes=30))
    assert abs(med - exact) / exact < 1e-6
    med16 = float(bisect_median(jnp.asarray(theta), max_rows=512, passes=16))
    assert abs(med16 - exact) / exact < 1e-3


def test_warm_search_error_bound_property():
    """Property pin for the warm-bracket search: the k-th order statistic
    stays inside the count-verified interval through every quad-ary
    round, so |result - exact_k| <= binding_width / 4^rounds / 2 for the
    TIGHTEST bracket that verified (or the full range). Checked across
    random scales, shapes, and hint regimes — including hints that land
    in each bracket band and invalid hints that must fall through."""
    import numpy as np
    from stein_jax.ops.median import DEFAULT_BRACKETS, _warm_search

    rng = np.random.default_rng(0)
    for trial in range(12):
        m = int(rng.integers(8, 64))
        n = int(rng.integers(32, 256))
        scale = 10.0 ** rng.uniform(-3, 3)
        kind = trial % 3
        if kind == 0:
            block = rng.lognormal(0.0, 1.0, size=(m, n)) * scale
        elif kind == 1:   # bimodal
            block = np.where(rng.random((m, n)) < 0.5,
                             rng.normal(1.0, 0.05, (m, n)),
                             rng.normal(50.0, 1.0, (m, n))) * scale
        else:             # near-constant (tiny range)
            block = (1.0 + rng.normal(0, 1e-4, (m, n))) * scale
        block = np.abs(block).astype(np.float32)
        D = jnp.asarray(block)
        total = m * n
        k = (total + 1) // 2
        exact_k = float(np.partition(block.ravel(), k - 1)[k - 1])
        lo_full = min(float(block.min()), 0.0)
        hi_full = float(block.max())

        for mult in (1.0, 0.8, 1.25, 0.5, 3.9, 100.0, 0.0):
            med_prev = np.float32(mult * exact_k)
            warm_passes = int(rng.choice([4, 6, 8]))
            rounds = (warm_passes + 1) // 2
            got = float(_warm_search(D, jnp.float32(med_prev),
                                     warm_passes))
            # Recompute which bracket verifies (tightest first).
            width = hi_full - lo_full
            if med_prev > 0:
                flat = block.ravel()
                for a_m, b_m in DEFAULT_BRACKETS:
                    a, b = a_m * med_prev, b_m * med_prev
                    if (np.sum(flat <= a) < k) and (np.sum(flat <= b) >= k):
                        width = b - a
                        break
            bound = width / 4.0 ** rounds / 2.0
            err = abs(got - exact_k)
            assert err <= bound * (1 + 1e-5) + 1e-30, (
                trial, mult, warm_passes, err, bound
            )
