"""The compile-cache placement rule (`terrarium_tpu.utils.compile_cache`)."""
import pathlib

import jax

from terrarium_tpu.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_env_var_is_honoured_and_nothing_is_set(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, "/somewhere/else")
    assert compile_cache.configure_compile_cache() == "/somewhere/else"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_inside_the_checkout_and_stable(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        first = compile_cache.configure_compile_cache()
        second = compile_cache.configure_compile_cache()
        assert first == second == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == first
        assert ".jax_cache/" in (ROOT / ".gitignore").read_text()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
