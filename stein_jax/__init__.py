"""stein_jax — a Stein Variational Gradient Descent engine in JAX.

A from-scratch JAX/XLA/Pallas framework with the full capability surface
of the reference SVGD library (JamesBrofos/Stein): the entire SVGD step is
one jitted on-device program, the kernel matrix streams through a Pallas
tile for large particle counts, and particles shard across a device mesh
with psum/all-gather collectives.
"""

from .version import __version__
from .api import (
    SVGDSampler,
    SVGDState,
    SteinSampler,
    throughput_config,
)
from .ops.optimizers import (
    Adam,
    Adagrad,
    AdamGradientDescent,
    AdagradGradientDescent,
)
from .kernels import SquaredExponentialKernel, InverseMultiquadricKernel

__all__ = [
    "__version__",
    "SVGDSampler",
    "SVGDState",
    "SteinSampler",
    "throughput_config",
    "Adam",
    "Adagrad",
    "AdamGradientDescent",
    "AdagradGradientDescent",
    "SquaredExponentialKernel",
    "InverseMultiquadricKernel",
]
