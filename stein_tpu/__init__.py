"""Former import name of stein_jax, kept so that existing imports keep
working: every module of stein_jax is importable under this name as the
same module object (``from <this name>.ops import rbf`` is
``stein_jax.ops.rbf``)."""

import importlib
import pkgutil
import sys

import stein_jax

for _info in pkgutil.walk_packages(stein_jax.__path__, "stein_jax."):
    sys.modules[__name__ + _info.name[len("stein_jax"):]] = (
        importlib.import_module(_info.name))
sys.modules[__name__] = stein_jax
