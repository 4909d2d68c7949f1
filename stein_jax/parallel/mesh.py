"""Device-mesh construction for particle-sharded SVGD.

The reference is single-process/single-device (SURVEY.md §2: no distributed
backend exists; stein_sampler.py:11-14 documents the sequential design).
Here the particle axis — the workload's data-parallel axis — shards over a
1-D jax.sharding.Mesh; collectives (all_gather of particle blocks, psum of
the clip norm and median histograms) lower through JAX's standard
collectives (NCCL between GPUs). The mesh follows the algorithm: every card
reaches every other at the same rate.
"""

import jax
import numpy as np
from jax.sharding import Mesh


def particle_mesh(devices=None, axis_name="particles"):
    """1-D mesh over all (or the given) devices, named for the particle axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def setup_distributed(coordinator_address=None, num_processes=None,
                      process_id=None):
    """Initialise multi-process JAX (call once per process before building
    a mesh that spans processes). Thin wrapper over
    jax.distributed.initialize: pass coordinator_address, num_processes
    and process_id, or none of them where the cluster environment
    supplies them."""
    if coordinator_address is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()
