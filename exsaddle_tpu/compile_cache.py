"""Where the persistent XLA compilation cache lives.

The flagship solve is one large jitted program; keeping it in JAX's
persistent cache lets later processes on the same checkout skip the
compile. One rule for every entry point (driver, bench, chip smoke run,
tests): an explicit `JAX_COMPILATION_CACHE_DIR` wins and is left to JAX,
otherwise the cache is `.jax_cache` at the root of the checkout."""

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache():
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        # JAX initialises jax_compilation_cache_dir from this variable
        return env
    import jax
    path = os.path.join(CHECKOUT, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
