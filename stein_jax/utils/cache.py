"""Persistent XLA compilation cache.

Compiling the step is a large share of a short run; the persistent cache
lets a re-run of an already-compiled program start in seconds. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets no other directory. Otherwise the cache lives at one fixed path
inside the checkout (``.jax_cache/``, listed in ``.gitignore``): the path
is part of the cache key, so a directory that moves never hits."""

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def cache_dir():
    """The directory the compilation cache uses: the environment
    variable's value when set, else the checkout's ``.jax_cache/``."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache(min_compile_secs=1.0):
    """Turn on the persistent cache (safe to call more than once) and
    return its directory."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return path
