"""The streaming SVGD tile (Pallas through Triton) against the jnp
reference, in interpret mode, plus the wrapper's shapes, padding and
choice of blocks. The compiled kernel runs only on the GPU
(tests_gpu/)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stein_jax.ops import pallas_svgd, rbf
from stein_jax.ops.pallas_svgd import (
    pallas_svgd_both_ksum,
    pallas_svgd_phi,
    pallas_svgd_phi_rect,
    tile_blocks,
)


def _reference_phi(theta, grads, h2, rows=None):
    """float64 phi on centred particles (D is translation-invariant, and
    centring keeps the f64 reference itself free of cancellation)."""
    theta = np.asarray(theta, np.float64)
    grads = np.asarray(grads, np.float64)
    c = theta.mean(axis=0, keepdims=True)
    cols = theta - c
    r = cols if rows is None else np.asarray(rows, np.float64) - c
    D = ((r * r).sum(1)[:, None] + (cols * cols).sum(1)[None, :]
         - 2.0 * r @ cols.T)
    K = np.exp(-D / h2 / 2.0)
    ksum = K.sum(1, keepdims=True)
    return (K @ grads + (ksum * r - K @ cols) / h2) / theta.shape[0]


def _problem(n, p, shift, seed):
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(n, p)) + shift
    grads = rng.normal(size=(n, p))
    c = theta - theta.mean(0)
    D = (c * c).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * c @ c.T
    h2 = float(np.median(D) / np.log(n))
    return theta, grads, h2


@pytest.mark.parametrize("n,p,shift", [
    (64, 16, 0.0),      # several row and column blocks
    (100, 7, 0.0),      # n not a block multiple, p padded to 16
    (32, 130, 0.0),     # p padded to 256
    (16, 3, 0.0),       # fewer particles than one block
    (70, 5, 100.0),     # cloud far from the origin: the centring
    (130, 33, 10.0),    # ragged rows and columns, shifted
    (200, 128, 0.0),    # the p the tile is selected for
    (40, 303, 50.0),    # the Bayesian-NN width, padded to 512
])
def test_pallas_matches_jnp(n, p, shift):
    theta, grads, h2 = _problem(n, p, shift, seed=n * 1000 + p)
    got = pallas_svgd_phi(jnp.asarray(theta, jnp.float32),
                          jnp.asarray(grads, jnp.float32),
                          jnp.float32(h2), interpret=True)
    ref = _reference_phi(theta, grads, h2)
    assert got.shape == (n, p) and got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4,
                               atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("m,n,p", [(8, 64, 4), (37, 100, 12), (64, 64, 20)])
def test_rect_tile_matches_reference(m, n, p):
    """One shard's rows against all columns (the all-gather mesh step)."""
    theta, grads, h2 = _problem(n, p, 3.0, seed=m + n + p)
    got = pallas_svgd_phi_rect(
        jnp.asarray(theta[:m], jnp.float32),
        jnp.asarray(theta, jnp.float32), jnp.asarray(grads, jnp.float32),
        jnp.float32(h2), interpret=True,
    )
    ref = _reference_phi(theta, grads, h2, rows=theta[:m])
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4,
                               atol=2e-5 * np.abs(ref).max())


def test_column_blocks_accumulate():
    """The ring step sums (ku, ksum) over column blocks with one centre:
    two half-column calls must add up to the whole-column call."""
    theta, grads, h2 = _problem(96, 8, 1.0, seed=5)
    t = jnp.asarray(theta, jnp.float32)
    g = jnp.asarray(grads, jnp.float32)
    c = jnp.mean(t, axis=0, keepdims=True)
    ku, ks = pallas_svgd_both_ksum(t, t, g, h2, c, interpret=True)
    ku1, ks1 = pallas_svgd_both_ksum(t, t[:48], g[:48], h2, c,
                                     interpret=True)
    ku2, ks2 = pallas_svgd_both_ksum(t, t[48:], g[48:], h2, c,
                                     interpret=True)
    assert ku.shape == (96, 8) and ks.shape == (96, 1)
    np.testing.assert_allclose(np.asarray(ku1 + ku2), np.asarray(ku),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ks1 + ks2), np.asarray(ks),
                               rtol=1e-5)


def test_pallas_f64_input_roundtrip():
    """float64 inputs (CPU tests) compute in f32 inside but return f64."""
    rng = np.random.default_rng(0)
    theta = jnp.asarray(rng.normal(size=(32, 5)))
    grads = jnp.asarray(rng.normal(size=(32, 5)))
    phi_ref, aux = rbf.svgd_phi(theta, grads)
    phi = pallas_svgd_phi(theta, grads, aux["h2"], interpret=True)
    assert phi.dtype == theta.dtype
    np.testing.assert_allclose(
        np.asarray(phi), np.asarray(phi_ref), rtol=1e-4, atol=1e-6
    )


def test_sampler_with_pallas_kernel_impl():
    """SVGDSampler(kernel_impl='pallas') end-to-end (interpret mode) tracks
    the xla-impl sampler closely (subsampled median == exact at this n)."""
    from stein_jax import SVGDSampler, Adam
    from stein_jax.models import LinearRegressionModel

    rng = np.random.default_rng(4)
    X = rng.normal(size=(40, 3))
    y = X @ rng.normal(size=(3, 1))
    model = LinearRegressionModel(3)
    batch = {"X": jnp.asarray(X, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}
    theta0 = jnp.asarray(rng.normal(size=(16, 3)) * 0.01, jnp.float32)
    common = dict(
        n_particles=16, log_p=model.log_p,
        param_template=model.template(), gd=Adam(learning_rate=1e-1),
        theta=theta0, dtype=jnp.float32,
    )
    a = SVGDSampler(kernel_impl="xla", **common)
    b = SVGDSampler(kernel_impl="pallas", median="subsample",
                    pallas_interpret=True, **common)
    for _ in range(5):
        a.train_on_batch(batch)
        b.train_on_batch(batch)
    np.testing.assert_allclose(b.samples, a.samples, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("p_pad", [16, 32, 64, 128, 256, 512, 1024])
def test_tile_blocks_fit_the_card(p_pad):
    """Blocks are powers of two, at least 16 wide for the tensor-core
    product, and the row tile plus one column tile per pipeline stage
    fit a Hopper block's shared memory."""
    bi, bj, warps, stages = tile_blocks(p_pad)
    for b in (bi, bj, warps):
        assert b & (b - 1) == 0
    assert bi >= 16 and bj >= 16 and stages >= 1
    assert 4 * (bi + stages * bj) * p_pad <= pallas_svgd.SMEM_BYTES


def test_tile_blocks_measured_choices():
    assert tile_blocks(128)[:2] == (32, 64)
    assert tile_blocks(512)[:2] == (16, 32)


def test_tile_refuses_too_wide_particles():
    t = jnp.ones((16, 1025), jnp.float32)
    with pytest.raises(ValueError, match="kernel_impl='xla'"):
        pallas_svgd_phi(t, t, 1.0, interpret=True)


@pytest.mark.parametrize("p,p_pad", [(1, 16), (16, 16), (17, 32),
                                     (128, 128), (303, 512)])
def test_tile_pads_p_to_a_power_of_two(p, p_pad):
    assert pallas_svgd._next_pow2(p) == p_pad


def test_tile_names_the_triton_route():
    """The kernel is compiled through Triton, with its blocks from
    tile_blocks, one program per row block."""
    theta = jnp.ones((200, 5), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda t: pallas_svgd_both_ksum(
        t, t, t, 1.0, jnp.zeros((1, 5))))(theta)
    calls = []

    def walk(jx):
        for e in jx.eqns:
            if e.primitive.name == "pallas_call":
                calls.append(e.params)
            for v in e.params.values():
                if hasattr(v, "jaxpr"):
                    walk(v.jaxpr)
    walk(jaxpr.jaxpr)
    (params,) = calls
    assert params["backend"] == "triton"
    bi, _, warps, stages = tile_blocks(16)
    assert params["compiler_params"]["triton"].num_warps == warps
    assert params["compiler_params"]["triton"].num_stages == stages
    assert params["grid_mapping"].grid == (-(-200 // bi),)
