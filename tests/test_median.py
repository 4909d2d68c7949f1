"""The XLA bandwidth medians against the exact median of all n^2 squared
distances (np.median, the reference's compute_median.py semantics):
cold and warm bisect, the row subsample, the histogram refinement and
the bisect on a materialised D, across shapes on both sides of the
quad-ary regime (> 100k counted entries)."""

import numpy as np
import jax.numpy as jnp
import pytest

from stein_jax.ops import median as med
from stein_jax.ops.rbf import pairwise_sq_dists

SHAPES = [(16, 3), (64, 8), (100, 7), (320, 5), (640, 16)]


def _theta(n, p, seed=0, shift=0.0):
    rng = np.random.default_rng(seed + n + p)
    return jnp.asarray(rng.normal(size=(n, p)) + shift)


def _exact(theta):
    t = np.asarray(theta, np.float64)
    r = (t * t).sum(1)
    return float(np.median(r[:, None] + r[None, :] - 2.0 * t @ t.T))


@pytest.mark.parametrize("n,p", SHAPES)
def test_cold_bisect_matches_exact(n, p):
    """Every row counted: the bisect median is the exact median to fp
    resolution (one rank in the quad-ary regime, whose neighbour sits
    ~1/total of the distribution away)."""
    theta = _theta(n, p)
    got = float(med.bisect_median(theta, max_rows=n, passes=40))
    np.testing.assert_allclose(got, _exact(theta), rtol=1e-5)


@pytest.mark.parametrize("n,p", SHAPES)
def test_bisect_on_D_matches_bisect_on_theta(n, p):
    """The strided rows of a materialised D count the same values as the
    theta-based block."""
    theta = _theta(n, p, seed=1)
    rows = max(n // 4, 1)
    a = float(med.bisect_median_on_D(pairwise_sq_dists(theta),
                                     max_rows=rows))
    b = float(med.bisect_median(theta, max_rows=rows))
    np.testing.assert_allclose(a, b, rtol=1e-12)


@pytest.mark.parametrize("n,p", SHAPES)
@pytest.mark.parametrize("hint", [1.0, 1.05, 0.5, 3.0, 0.0])
def test_warm_bisect_within_its_bracket_bound(n, p, hint):
    """The warm search refines the tightest verified bracket around the
    previous median to the (total+1)//2-th order statistic; its error is
    bounded by that bracket's width over 4^rounds, whatever the hint
    (0 = no hint: the full range)."""
    theta = _theta(n, p, seed=2, shift=0.5)
    exact = _exact(theta)
    warm_passes = 12
    got = float(med.warm_bisect_median(
        theta, jnp.asarray(hint * exact), max_rows=n,
        warm_passes=warm_passes))
    D = np.sort(np.asarray(pairwise_sq_dists(theta)).ravel())
    target = D[(D.size + 1) // 2 - 1]
    widest = max(D[-1] - min(D[0], 0.0), 3.75 * hint * exact)
    bound = widest / 4 ** ((warm_passes + 1) // 2)
    assert abs(got - target) <= bound, (got, target, bound)


@pytest.mark.parametrize("n,p", SHAPES)
def test_subsample_is_exact_on_its_rows(n, p):
    theta = _theta(n, p, seed=3)
    rows = max(n // 3, 1)
    got = float(med.subsampled_sq_dist_median(theta, max_rows=rows))
    block = np.asarray(med.row_subsample_block(theta, rows))
    np.testing.assert_allclose(got, np.median(block), rtol=1e-12)
    # With every row kept it is the exact median.
    np.testing.assert_allclose(
        float(med.subsampled_sq_dist_median(theta, max_rows=n)),
        _exact(theta), rtol=1e-10)


@pytest.mark.parametrize("n,p", SHAPES)
def test_binned_within_its_bin_width(n, p):
    """Two levels of 4096 bins over [~0, 4 max |x|^2]: the result lies
    within one final bin of the exact median."""
    theta = _theta(n, p, seed=4)
    got = float(med.binned_median(theta, n_bins=4096, n_levels=2,
                                  block_rows=32))
    t = np.asarray(theta)
    width = 4.0 * (t * t).sum(1).max() / 4096 ** 2
    assert abs(got - _exact(theta)) <= 2 * width + 1e-9
