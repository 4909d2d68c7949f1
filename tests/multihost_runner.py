"""Worker script for the 2-process multi-controller integration test
(launched by tests/test_multihost.py, one subprocess per simulated host).

Each process owns 4 fake CPU devices; jax.distributed.initialize joins
them into one 8-device global mesh over localhost gRPC — the same
code path a real multi-host deployment uses (SURVEY.md §5 distributed
backend; BASELINE.json config #5)."""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=pid,
)

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stein_jax import SVGDSampler, Adam
from stein_jax.models import LinearRegressionModel
from stein_jax.parallel import particle_mesh, replicate_batch

assert jax.process_count() == nproc
assert jax.device_count() == 4 * nproc
assert jax.local_device_count() == 4

rng = np.random.default_rng(0)
X = rng.normal(size=(30, 3))
y = X @ rng.normal(size=(3, 1)) + rng.normal(size=(30, 1)) * 0.3
theta0 = rng.normal(size=(16, 3)) * 0.01
model = LinearRegressionModel(3)

mesh = particle_mesh()   # global: spans both processes
sampler = SVGDSampler(
    n_particles=16, log_p=model.log_p,
    param_template=model.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
    dtype=jnp.float64, mesh=mesh,
)
batch = replicate_batch(
    {"X": jnp.asarray(X), "y": jnp.asarray(y)}, mesh
)
for _ in range(5):
    sampler.train_on_batch(batch)
samples = sampler.samples            # cross-process allgather

# Single-device reference trajectory, computed locally in this process.
ref = SVGDSampler(
    n_particles=16, log_p=model.log_p,
    param_template=model.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
    dtype=jnp.float64,
)
ref_batch = {"X": jnp.asarray(X), "y": jnp.asarray(y)}
for _ in range(5):
    ref.train_on_batch(ref_batch)

np.testing.assert_allclose(samples, ref.samples, rtol=1e-9, atol=1e-12)

# Checkpoint round-trip across the multi-controller mesh: the allgather
# in save is collective (all processes call it; only process 0 writes),
# then a fresh sampler on the same mesh restores the global state —
# exercising the cross-process placement path (_place_global) — and must
# continue identically to the uninterrupted reference.
from jax.experimental import multihost_utils

ckpt = sys.argv[4] if len(sys.argv) > 4 else None
if ckpt:
    sampler.save(ckpt)
    multihost_utils.sync_global_devices("ckpt-written")
    resumed = SVGDSampler(
        n_particles=16, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
        dtype=jnp.float64, mesh=mesh,
    )
    resumed.restore(ckpt)
    for _ in range(3):
        resumed.train_on_batch(batch)
        ref.train_on_batch(ref_batch)
    np.testing.assert_allclose(
        resumed.samples, ref.samples, rtol=1e-9, atol=1e-12
    )

# Ring layout across processes: ppermute hops cross the process boundary
# (the DCN path on a real multi-host slice).
ring = SVGDSampler(
    n_particles=16, log_p=model.log_p,
    param_template=model.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
    dtype=jnp.float64, mesh=mesh, comm="ring", median="binned",
)
for _ in range(3):
    ring.train_on_batch(batch)
ring_ref = SVGDSampler(
    n_particles=16, log_p=model.log_p,
    param_template=model.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
    dtype=jnp.float64, median="binned",
)
for _ in range(3):
    ring_ref.train_on_batch(ref_batch)
np.testing.assert_allclose(
    ring.samples, ring_ref.samples, rtol=1e-6, atol=1e-9
)

# 2-D particles x model mesh spanning both processes. Device order is
# proc0's 4 devices then proc1's; reshape(2, 4).T pairs device i with
# device i+4 along the model axis, so every Gram psum genuinely crosses
# the process boundary (a plain reshape(4, 2) would keep model pairs
# intra-process and never exercise the DCN path).
from jax.sharding import Mesh

X8 = rng.normal(size=(30, 8))
y8 = X8 @ rng.normal(size=(8, 1))
model8 = LinearRegressionModel(8)
theta8 = rng.normal(size=(16, 8)) * 0.01
mesh2d = Mesh(np.asarray(jax.devices()).reshape(2, 4).T,
              ("particles", "model"))
s2d = SVGDSampler(
    n_particles=16, log_p=model8.log_p,
    param_template=model8.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta8),
    dtype=jnp.float64, mesh=mesh2d, model_axis="model",
)
batch8 = replicate_batch(
    {"X": jnp.asarray(X8), "y": jnp.asarray(y8)}, mesh2d
)
for _ in range(3):
    s2d.train_on_batch(batch8)
ref2d = SVGDSampler(
    n_particles=16, log_p=model8.log_p,
    param_template=model8.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta8),
    dtype=jnp.float64,
)
ref_batch8 = {"X": jnp.asarray(X8), "y": jnp.asarray(y8)}
for _ in range(3):
    ref2d.train_on_batch(ref_batch8)
np.testing.assert_allclose(
    s2d.samples, ref2d.samples, rtol=1e-9, atol=1e-12
)

# Diagnostics across the multi-controller mesh: aux scalars (replicated,
# not fully addressable) must read back; KSD runs over the global
# particles.
from stein_jax.utils.metrics import MetricsLogger

aux = sampler.train_on_batch(batch)
m = MetricsLogger(log_every=0)
m.record(int(6), aux)
assert np.isfinite(m.history[-1]["phi_norm"])
ksd_val = sampler.ksd(batch)
assert np.isfinite(ksd_val)

print(f"MULTIHOST-OK-{pid}", flush=True)

# Warm median across processes: the warm bracket/round counts psum over
# a particle axis that spans both processes, on the D rows of the
# cross-process gathered column block.
warm_p = SVGDSampler(
    n_particles=16, log_p=model.log_p,
    param_template=model.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
    dtype=jnp.float64, mesh=mesh, median="bisect", warm_median=True,
    warm_passes=8,
)
warm_p.run(batch, 4)
warm_ref = SVGDSampler(
    n_particles=16, log_p=model.log_p,
    param_template=model.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
    dtype=jnp.float64, median="bisect", warm_median=True,
    warm_passes=8,
)
warm_ref.run(ref_batch, 4)
np.testing.assert_allclose(
    warm_p.samples, warm_ref.samples, rtol=1e-6, atol=1e-9
)

# Warm median on the cross-process 2-D mesh: the warm counts run on the
# D rows whose Gram psum already crossed the process boundary.
# median_collectives='rounds' pins the tight comparison — the single-
# device warm search IS the quad-rounds structure (the r5 'grid' arm is
# a different-interval class, pinned in-process by test_sharded2d.py::
# test_2d_grid_matches_rounds; its batched median psums cross THIS
# process boundary via the fs_grid arm below).
s2d_warm = SVGDSampler(
    n_particles=16, log_p=model8.log_p,
    param_template=model8.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta8),
    dtype=jnp.float64, mesh=mesh2d, model_axis="model",
    median="bisect", warm_median=True, warm_passes=8,
    median_collectives="rounds",
)
s2d_warm.run(batch8, 4)
ref2d_warm = SVGDSampler(
    n_particles=16, log_p=model8.log_p,
    param_template=model8.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta8),
    dtype=jnp.float64, median="bisect", warm_median=True, warm_passes=8,
)
ref2d_warm.run(ref_batch8, 4)
np.testing.assert_allclose(
    s2d_warm.samples, ref2d_warm.samples, rtol=1e-6, atol=1e-9
)

# Ring circulation and the 2-D grid median across the process boundary:
# comm='ring' ppermutes particle blocks over gRPC (no gather), and the
# 2-D grid search's two batched psums cross the same boundary. Ring is
# bitwise-equal in its medians to the all-gather search, so it tracks
# the single-device warm run to sharded-vs-single tolerance; grid vs the
# single-device rounds search is the width/2**warm_passes class.
ring = SVGDSampler(
    n_particles=16, log_p=model.log_p,
    param_template=model.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
    dtype=jnp.float64, mesh=mesh, median="bisect", warm_median=True,
    warm_passes=8, comm="ring",
)
ring.run(batch, 4)
ring_ref = SVGDSampler(
    n_particles=16, log_p=model.log_p,
    param_template=model.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
    dtype=jnp.float64, median="bisect", warm_median=True, warm_passes=8,
)
ring_ref.run(ref_batch, 4)
np.testing.assert_allclose(
    ring.samples, ring_ref.samples, rtol=1e-9, atol=1e-12
)
s2d_grid = SVGDSampler(
    n_particles=16, log_p=model8.log_p,
    param_template=model8.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta8),
    dtype=jnp.float64, mesh=mesh2d, model_axis="model",
    median="bisect", warm_median=True, warm_passes=8,
    median_collectives="grid",
)
s2d_grid.run(batch8, 4)
np.testing.assert_allclose(
    s2d_grid.samples, ref2d_warm.samples, rtol=2e-2, atol=2e-4
)
print(f"MULTIHOST-RING-GRID-OK-{pid}", flush=True)
