"""Checkpoint/resume: a restored sampler must continue bit-identically,
including the decayed learning rate and step count (SURVEY.md §5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stein_jax import SVGDSampler, Adam
from stein_jax.models import LinearRegressionModel
from stein_jax.parallel import particle_mesh


def _setup(seed=0, n_particles=16, mesh=None):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(30, 3))
    y = X @ rng.normal(size=(3, 1)) + rng.normal(size=(30, 1)) * 0.3
    model = LinearRegressionModel(3)
    batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
    theta0 = rng.normal(size=(n_particles, 3)) * 0.01
    sampler = SVGDSampler(
        n_particles=n_particles,
        log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1, decay=0.99),
        theta=jnp.asarray(theta0),
        dtype=jnp.float64,
        mesh=mesh,
    )
    return sampler, batch, model, theta0


def test_save_restore_resumes_identically(tmp_path):
    ckpt = str(tmp_path / "state.npz")
    a, batch, model, theta0 = _setup()
    for _ in range(3):
        a.train_on_batch(batch)
    a.save(ckpt)
    for _ in range(4):
        a.train_on_batch(batch)

    b, _, _, _ = _setup()  # fresh sampler, same config
    b.restore(ckpt)
    assert int(b.state.step) == 3
    np.testing.assert_allclose(
        float(b.state.opt_state.learning_rate), 0.1 * 0.99 ** 3
    )
    for _ in range(4):
        b.train_on_batch(batch)
    np.testing.assert_array_equal(a.samples, b.samples)
    assert int(b.state.step) == 7


@pytest.mark.usefixtures("eight_devices")
def test_save_single_restore_sharded(tmp_path):
    """A single-device checkpoint restores onto a mesh-sharded sampler and
    the run continues to match the single-device run."""
    ckpt = str(tmp_path / "state.npz")
    a, batch, model, theta0 = _setup()
    for _ in range(3):
        a.train_on_batch(batch)
    a.save(ckpt)

    mesh = particle_mesh(jax.devices()[:8])
    b, _, _, _ = _setup(mesh=mesh)
    b.restore(ckpt)
    for _ in range(3):
        a.train_on_batch(batch)
        b.train_on_batch(batch)
    np.testing.assert_allclose(b.samples, a.samples, rtol=1e-9, atol=1e-12)


def test_restore_shape_mismatch_raises(tmp_path):
    ckpt = str(tmp_path / "state.npz")
    a, batch, _, _ = _setup(n_particles=16)
    a.save(ckpt)
    b, _, _, _ = _setup(n_particles=8)
    with pytest.raises(ValueError):
        b.restore(ckpt)


def test_restore_leaf_reorder_rejected(tmp_path):
    """A checkpoint whose pytree structure reordered/renamed same-shaped
    leaves (e.g. a refactor swapping mu/nu) is rejected at restore rather
    than restored silently wrong."""
    import collections
    from stein_jax.utils.checkpoint import save_checkpoint, \
        restore_checkpoint

    A = collections.namedtuple("A", ["mu", "nu", "step"])
    B = collections.namedtuple("B", ["nu", "mu", "step"])
    state = A(mu=jnp.ones((4, 2)), nu=jnp.full((4, 2), 2.0),
              step=jnp.zeros((), jnp.int32))
    ckpt = str(tmp_path / "sig.npz")
    save_checkpoint(ckpt, state)
    # Same structure restores fine.
    restored = restore_checkpoint(ckpt, state)
    np.testing.assert_array_equal(np.asarray(restored.nu), 2.0)
    # Field-swapped structure (identical shapes!) is rejected.
    swapped = B(nu=jnp.zeros((4, 2)), mu=jnp.zeros((4, 2)),
                step=jnp.zeros((), jnp.int32))
    with pytest.raises(ValueError, match="structure"):
        restore_checkpoint(ckpt, swapped)


def test_metrics_resume_appends(tmp_path):
    """resume=True appends to the CSV across a crash-restart cycle instead
    of truncating the pre-crash history."""
    from stein_jax.utils.metrics import MetricsLogger
    a, batch, _, _ = _setup()
    csv_path = str(tmp_path / "metrics.csv")
    m1 = MetricsLogger(log_every=0, csv_path=csv_path, resume=True)
    for step in range(3):
        m1.record(step, a.train_on_batch(batch))
    m1.close()    # "crash" after 3 rows
    m2 = MetricsLogger(log_every=0, csv_path=csv_path, resume=True)
    for step in range(3, 5):
        m2.record(step, a.train_on_batch(batch))
    m2.close()
    with open(csv_path) as f:
        lines = f.read().strip().splitlines()
    assert len(lines) == 6  # ONE header + 5 rows: history survived
    assert lines[0].startswith("step")
    assert [ln.split(",")[0] for ln in lines[1:]] == [
        "0", "1", "2", "3", "4"
    ]


def test_metrics_logger(tmp_path):
    from stein_jax.utils.metrics import MetricsLogger
    a, batch, _, _ = _setup()
    csv_path = str(tmp_path / "metrics.csv")
    m = MetricsLogger(log_every=1, csv_path=csv_path)
    for step in range(3):
        aux = a.train_on_batch(batch)
        m.record(step, aux)
    m.close()
    assert len(m.history) == 3
    assert m.history[1]["interval_s"] is not None
    # Per-step average = interval / step delta (r3 review: the old
    # single column was the raw interval mislabeled as a step time).
    assert m.history[1]["avg_step_time_s"] == pytest.approx(
        m.history[1]["interval_s"]
    )
    assert m.history[0]["avg_step_time_s"] is None
    with open(csv_path) as f:
        lines = f.read().strip().splitlines()
    assert len(lines) == 4  # header + 3 rows


def test_train_with_recovery_resumes_after_crash(tmp_path):
    """Kill the loop mid-run; a fresh process-equivalent resumes from the
    checkpoint and finishes with exactly the no-crash trajectory."""
    from stein_jax.utils.recovery import train_with_recovery

    ckpt = str(tmp_path / "recov.npz")
    a, batch, model, theta0 = _setup(seed=9)
    X, y = np.asarray(batch["X"]), np.asarray(batch["y"])

    def make_batches(start, k):
        # Deterministic in start: minibatch = rows selected by step index.
        idx = (np.arange(k)[:, None] * 7 + start + np.arange(10)) % X.shape[0]
        return {"X": jnp.asarray(X[idx]), "y": jnp.asarray(y[idx])}

    # Uninterrupted reference run.
    ref, _, _, _ = _setup(seed=9)
    for s in range(0, 12, 3):
        ref.train_on_batches(make_batches(s, 3))

    # Crash after the second checkpoint chunk.
    calls = {"n": 0}

    def crash_hook(step, aux):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated crash")

    try:
        train_with_recovery(a, 12, make_batches, ckpt, ckpt_every=3,
                            on_checkpoint=crash_hook)
    except RuntimeError:
        pass
    assert int(a.state.step) == 6

    # "Restarted process": fresh sampler, same config, resumes from ckpt.
    b, _, _, _ = _setup(seed=9)
    executed = train_with_recovery(b, 12, make_batches, ckpt, ckpt_every=3)
    assert executed == 6
    assert int(b.state.step) == 12
    np.testing.assert_array_equal(b.samples, ref.samples)


def test_recovery_divergence_detection(tmp_path):
    """NaN state must not overwrite the last good checkpoint."""
    from stein_jax.utils.recovery import train_with_recovery

    ckpt = str(tmp_path / "div.npz")
    a, batch, model, theta0 = _setup(seed=11)
    X, y = np.asarray(batch["X"]), np.asarray(batch["y"])

    def make_batches(start, k):
        if start >= 3:
            # Poison the data after the first checkpointed chunk.
            return {"X": jnp.full((k, 5, 3), jnp.nan),
                    "y": jnp.zeros((k, 5, 1))}
        idx = (np.arange(k)[:, None] + start + np.arange(10)) % X.shape[0]
        return {"X": jnp.asarray(X[idx]), "y": jnp.asarray(y[idx])}

    with pytest.raises(FloatingPointError, match="last good checkpoint"):
        train_with_recovery(a, 9, make_batches, ckpt, ckpt_every=3)
    # The checkpoint holds the last GOOD state (step 3, finite).
    b, _, _, _ = _setup(seed=11)
    b.restore(ckpt)
    assert int(b.state.step) == 3
    assert np.isfinite(b.samples).all()


def test_recovery_first_chunk_divergence_names_no_checkpoint(tmp_path):
    """Regression (r3 review): divergence in the FIRST chunk of a fresh
    run must not claim a 'last good checkpoint' — none was written, and
    an operator restarting against the fictional path would silently
    start a brand-new run that replays the divergence."""
    from stein_jax.utils.recovery import train_with_recovery

    ckpt = str(tmp_path / "fresh.npz")
    a, batch, model, theta0 = _setup(seed=12)

    def make_batches(start, k):
        return {"X": jnp.full((k, 5, 3), jnp.nan),
                "y": jnp.zeros((k, 5, 1))}

    with pytest.raises(FloatingPointError,
                       match="no checkpoint was written yet"):
        train_with_recovery(a, 9, make_batches, ckpt, ckpt_every=3)
    import os
    assert not os.path.exists(ckpt)


def test_restore_rejects_checkpoint_without_meta(tmp_path):
    """Regression (r3 review): an npz with leaf_* keys but no __meta__
    (pre-v2 / truncated / foreign file) must be rejected, not restored
    positionally with only shape checks — same-shaped leaves that
    swapped positions would restore silently wrong."""
    from stein_jax.utils.checkpoint import restore_checkpoint

    a, batch, _, _ = _setup()
    a.train_on_batch(batch)
    leaves, _ = jax.tree_util.tree_flatten(a.state)
    path = str(tmp_path / "nometa.npz")
    np.savez(path, **{f"leaf_{i}": np.asarray(l)
                      for i, l in enumerate(leaves)})
    with pytest.raises(ValueError, match="__meta__"):
        restore_checkpoint(path, a.state)


def _mesh(kind):
    from jax.sharding import Mesh
    devs = np.asarray(jax.devices()[:8])
    if kind == "2d":
        return Mesh(devs.reshape(4, 2), ("particles", "model"))
    return Mesh(devs, ("particles",))


# Every sampler configuration that survives, by the options that reach it.
CHECKPOINT_CONFIGS = {
    "exact": dict(),
    "subsample": dict(median="subsample", median_max_rows=16),
    "binned": dict(median="binned"),
    "warm_bisect": dict(median="bisect", warm_median=True),
    "tile_warm": dict(median="bisect", warm_median=True,
                      kernel_impl="pallas", pallas_interpret=True),
    "mesh_all_gather_warm": dict(median="bisect", warm_median=True,
                                 mesh="1d"),
    "mesh_ring_warm": dict(median="bisect", warm_median=True, mesh="1d",
                           comm="ring"),
    "mesh_ring_binned": dict(median="binned", mesh="1d", comm="ring"),
    "mesh_2d_grid": dict(median="bisect", warm_median=True, mesh="2d",
                         model_axis="model", median_collectives="grid"),
    "mesh_2d_rounds": dict(median="bisect", warm_median=True, mesh="2d",
                           model_axis="model",
                           median_collectives="rounds"),
}


@pytest.mark.parametrize("config", sorted(CHECKPOINT_CONFIGS))
def test_save_restore_each_configuration(tmp_path, config):
    """Checkpoint/resume through every surviving configuration (the same
    SVGDState pytree): a restored sampler continues bit-identically
    through chunked run() calls, each of which re-seeds the warm carry
    from the restored particles."""
    kw = dict(CHECKPOINT_CONFIGS[config])
    if "mesh" in kw:
        if jax.device_count() < 8:
            pytest.skip("needs 8 fake CPU devices")
        kw["mesh"] = _mesh(kw["mesh"])
    rng = np.random.default_rng(2)
    n, p = 48, 4
    X = rng.normal(size=(30, p))
    y = X @ rng.normal(size=(p, 1))
    model = LinearRegressionModel(p)
    batch = {"X": jnp.asarray(X, jnp.float32),
             "y": jnp.asarray(y, jnp.float32)}
    theta0 = jnp.asarray(rng.normal(size=(n, p)) * 0.01, jnp.float32)

    def make():
        return SVGDSampler(
            n_particles=n, log_p=model.log_p,
            param_template=model.template(),
            gd=Adam(learning_rate=1e-1, decay=0.99), theta=theta0,
            warm_passes=6, **kw,
        )

    ckpt = str(tmp_path / f"{config}.npz")
    a = make()
    a.run(batch, 5)
    a.save(ckpt)
    a.run(batch, 5)

    b = make()
    b.restore(ckpt)
    assert int(b.state.step) == 5
    b.run(batch, 5)
    np.testing.assert_array_equal(a.samples, b.samples)
    np.testing.assert_array_equal(
        np.asarray(a.state.opt_state.mu), np.asarray(b.state.opt_state.mu)
    )
