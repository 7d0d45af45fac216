"""Persistent XLA compilation cache setup (imported for its side effect).

The fused sweep-loop program is large; caching compiled executables across
processes makes repeated CLI invocations and test runs start in seconds
instead of minutes.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory.  Otherwise the cache lives at the fixed path
``<checkout>/.jax_cache``: the directory is part of the cache key, so a path
that moved between runs would never hit.
"""

import os
from pathlib import Path

import jax

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        str(Path(__file__).resolve().parents[1] / ".jax_cache"),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
