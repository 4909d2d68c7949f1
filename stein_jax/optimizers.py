"""Reference-compatible import path (stein/optimizers/__init__.py:1-2):

    from stein_jax.optimizers import AdamGradientDescent,
                                     AdagradGradientDescent
"""

from .ops.optimizers import (
    Adam,
    Adagrad,
    AdamGradientDescent,
    AdagradGradientDescent,
    AdamState,
    AdagradState,
)

__all__ = [
    "Adam",
    "Adagrad",
    "AdamGradientDescent",
    "AdagradGradientDescent",
    "AdamState",
    "AdagradState",
]
