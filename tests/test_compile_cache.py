"""The persistent compilation cache's directory choice."""

import pathlib

from pim_sort_merge_join_tpu.utils import compile_cache


def test_env_var_set_leaves_it_to_jax():
    env = {"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}
    assert compile_cache.compile_cache_dir(env) is None


def test_default_is_fixed_repo_directory():
    path = pathlib.Path(compile_cache.compile_cache_dir({}))
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert path == repo / ".jax_cache"
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()
    assert compile_cache.compile_cache_dir({}) == str(path)  # stable path
