"""The compilation-cache rule: JAX_COMPILATION_CACHE_DIR when it is set
(and no other directory set in code), else one fixed, git-ignored
directory inside the checkout."""

import os
import types

import pytest

from stein_jax.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_jax(monkeypatch):
    """Record config updates instead of changing this process's JAX."""
    calls = {}
    fake = types.SimpleNamespace(config=types.SimpleNamespace(
        update=lambda k, v: calls.__setitem__(k, v)))
    monkeypatch.setattr(cache, "jax", fake)
    return calls


def test_env_var_wins_and_nothing_else_is_set(fake_jax, monkeypatch,
                                               tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert cache.cache_dir() == str(tmp_path / "cc")
    assert cache.enable_compilation_cache() == str(tmp_path / "cc")
    assert "jax_compilation_cache_dir" not in fake_jax
    assert fake_jax["jax_persistent_cache_min_compile_time_secs"] == 1.0


@pytest.mark.parametrize("value", [None, ""])
def test_default_is_the_checkouts_cache_dir(fake_jax, monkeypatch, value):
    if value is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", value)
    path = cache.enable_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache") == cache.DEFAULT_DIR
    assert os.path.isdir(path)
    assert fake_jax["jax_compilation_cache_dir"] == path


def test_default_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    assert ".jax_cache/" in ignored
