"""Reference-compatible import path (stein/samplers/__init__.py:1):

    from stein_jax.samplers import SteinSampler
"""

from .api import SVGDSampler, SVGDState, SteinSampler

__all__ = ["SVGDSampler", "SVGDState", "SteinSampler"]
