"""Runtime set-up shared by the entry points."""

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it is (JAX
    reads it itself) and nothing is changed.  Otherwise the cache lives
    at ``<repo>/.jax_cache``: the path is part of the cache key, so it
    must not move between runs.  Returns the directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
