"""Reference-compatible import path (stein/utilities/__init__.py:1-2):

    from stein_jax.utilities import convert_dictionary_to_array,
                                    convert_array_to_dictionary,
                                    compute_median
"""

from .utils.ravel import (
    convert_dictionary_to_array,
    convert_array_to_dictionary,
)
from .ops.median import exact_median as compute_median

__all__ = [
    "convert_dictionary_to_array",
    "convert_array_to_dictionary",
    "compute_median",
]
