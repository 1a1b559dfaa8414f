"""Where the persistent compile cache lives (utils/compile_cache.py)."""

from pathlib import Path

import jax
import pytest

from anime_recommendations_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield before
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_used_and_nothing_else_set(monkeypatch, tmp_path,
                                              restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "cache")
    assert jax.config.jax_compilation_cache_dir == restore_cache_dir


def test_unset_env_uses_fixed_repo_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    assert first == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == first
    # Fixed: the same path every call, never a temporary or per-process one.
    assert compile_cache.enable_compile_cache() == first


def test_default_cache_dir_is_gitignored():
    lines = (REPO / ".gitignore").read_text().splitlines()
    assert ".jax_cache/" in lines
