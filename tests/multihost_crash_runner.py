"""Worker script for the 2-process CRASH DRILL
(tests/test_multihost.py::test_two_process_crash_resume).

Simulates the real multi-host failure story (SURVEY.md §5 "failure
detection / elastic recovery"): a worker process dies mid-run after the
first checkpoint chunk, the job is torn down (on a real slice the
scheduler kills every host when one is lost), and a full relaunch
resumes from the last checkpoint via train_with_recovery's
broadcast-resume path (utils/recovery.py) — the resumed trajectory must
equal an uninterrupted run.

argv: pid nproc port ckpt_path mode('crash'|'resume')
- crash : run with ckpt_every=2 for n_iters=6; at the step-2 checkpoint
  hook, process 1 exits hard (os._exit(17), the simulated worker loss)
  and process 0 follows (simulated job teardown — it would otherwise
  block forever in the next chunk's first collective).
- resume: the relaunch. train_with_recovery broadcasts the
  resume decision from process 0, restores step 2, finishes to step 6,
  and the final particles are asserted equal to an uninterrupted
  single-device reference trajectory.
"""

import os
import sys
import time

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
ckpt = sys.argv[4]
mode = sys.argv[5]

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
from stein_jax.utils.recovery import train_with_recovery

rng = np.random.default_rng(0)
X = rng.normal(size=(40, 3))
y = X @ rng.normal(size=(3, 1)) + rng.normal(size=(40, 1)) * 0.3
theta0 = rng.normal(size=(16, 3)) * 0.01
model = LinearRegressionModel(3)
n_obs, m = X.shape[0], 8
N_ITERS, CKPT_EVERY = 6, 2


def batch_arrays(start, k):
    """Deterministic-in-start minibatch stack (required for bit-identical
    resume, train_with_recovery's contract)."""
    idx = np.stack([(np.arange(m) + s * m) % n_obs
                    for s in range(start, start + k)])
    return {"X": jnp.asarray(X[idx]), "y": jnp.asarray(y[idx])}


mesh = particle_mesh()


def make_sampler():
    return SVGDSampler(
        n_particles=16, log_p=model.log_p,
        param_template=model.template(jnp.float64),
        gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
        dtype=jnp.float64, mesh=mesh,
    )


def make_batches(start, k):
    return replicate_batch(batch_arrays(start, k), mesh)


sampler = make_sampler()

if mode == "crash":
    def die_after_first_chunk(step, aux):
        if step == CKPT_EVERY:
            if pid == 1:
                # The simulated worker loss: process 1 vanishes without
                # cleanup right after the first checkpoint landed.
                os._exit(17)
            # Process 0: the next chunk's first collective would block
    # forever on the dead peer; a real job scheduler tears the
            # job down — simulate it after giving proc 1 time to die.
            time.sleep(1.0)
            os._exit(17)

    train_with_recovery(
        sampler, N_ITERS, make_batches, ckpt,
        ckpt_every=CKPT_EVERY, on_checkpoint=die_after_first_chunk,
    )
    # Unreachable in crash mode.
    print(f"CRASH-MODE-DID-NOT-CRASH-{pid}", flush=True)
    sys.exit(1)

# mode == 'resume': the relaunch. The checkpoint (step 2) must be found
# and broadcast-resumed; executed counts only the remaining steps.
executed = train_with_recovery(
    sampler, N_ITERS, make_batches, ckpt, ckpt_every=CKPT_EVERY,
)
assert executed == N_ITERS - CKPT_EVERY, executed
assert int(sampler.state.step) == N_ITERS

# Uninterrupted single-device reference over the same deterministic
# batches: the resumed multi-controller trajectory must match it to the
# sharded-vs-single fp tolerance (the equality bar of test_sharded.py).
ref = SVGDSampler(
    n_particles=16, log_p=model.log_p,
    param_template=model.template(jnp.float64),
    gd=Adam(learning_rate=1e-1), theta=jnp.asarray(theta0),
    dtype=jnp.float64,
)
ref.train_on_batches(batch_arrays(0, N_ITERS))
np.testing.assert_allclose(
    sampler.samples, ref.samples, rtol=1e-9, atol=1e-12
)
print(f"CRASH-RESUME-OK-{pid}", flush=True)
