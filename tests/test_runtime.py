"""utils/runtime.py: compile-cache placement and the GPU gate."""

import os

import jax
import pytest

from game_engine_tpu.utils import runtime as R


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert R.compile_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_fixed_ignored_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = R.compile_cache_dir()
    assert path == os.path.join(R.REPO_ROOT, ".jax_cache")
    assert R.compile_cache_dir() == path  # no temp, pid or time component
    with open(os.path.join(R.REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert R.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_cpu():
    assert R.device_info()["platform"] == "cpu"
    with pytest.raises(SystemExit) as e:
        R.require_gpu()
    assert e.value.code == 2
