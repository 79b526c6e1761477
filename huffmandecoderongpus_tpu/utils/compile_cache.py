"""XLA persistent compilation cache.

Role parity with the reference's OpenCL kernel-binary cache
(loadKernelFromSourceAndSaveAsBinary / getKernelFromBinary,
openclapproach.c:26-225, gated by BUILD_BINARY_KERNELS/USE_BINARY_KERNELS):
compiled device programs survive process restarts, so the first-run compile
cost of each distinct shape is paid once per machine.

The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads
the variable itself, and nothing here overrides it), else
``<checkout>/.cache/jax``.
"""

from __future__ import annotations

import os
import pathlib

from huffmandecoderongpus_tpu.data import CACHE_DIR

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> pathlib.Path:
    """Where compiled programs are kept (see the module docstring)."""
    env = os.environ.get(ENV_VAR)
    return pathlib.Path(env) if env else CACHE_DIR / "jax"


def enable_compile_cache() -> pathlib.Path:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Call before the first compilation to benefit it; later calls still help
    subsequent compiles."""
    import jax

    path = cache_dir()
    if ENV_VAR not in os.environ:
        path.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(path))
    # cache every program, however quick its compile
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
