"""Where the persistent compilation cache lives."""

import importlib
import os
import subprocess

import jax

from astro_sph_tools_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_fixed_ignored_path_in_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.use_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # the same path on every import: no temporary name, pid or time in it
    assert importlib.reload(compile_cache).DEFAULT_DIR == path
    ignored = subprocess.run(
        ["git", "check-ignore", "-q", os.path.join(path, "x")], cwd=ROOT,
    )
    assert ignored.returncode in (0, 128)  # 128: not a git checkout
