"""Persistent build cache for the port's compiled libraries.

Counterpart of ``apda_fft_tpu/utils/compilecache.py``.  The JAX package
persists XLA programs; the port's compiled programs are its hand-written
CUDA kernels (``utils/kernels.py``, ``nvcc``) and the native ingest library
(``io/native.py``, ``g++``).  Each is built at first use into a build
directory under a name that hashes its sources and flags, and loaded from
there by every later process.  By default that directory is
``apda_fft_tpu_torch/_build/``; :func:`enable_compilation_cache` points both
builders at ``cache_dir``, so a deployment keeps its builds outside the
package (and a restarted gateway loads them instead of compiling).  Opt-in:
call it before the first kernel loads, or set ``"compilation_cache_dir"`` in
the ``gateway`` section of ``gw_config.json`` and the service enables it at
start.
"""

from __future__ import annotations

import os

from apda_fft_tpu_torch.io import native
from apda_fft_tpu_torch.utils import kernels

_DEFAULT_DIRS = (kernels.BUILD_DIR, native._BUILD_DIR)
_enabled_dir: str | None = None


def _point_builders_at(kernel_dir: str, native_dir: str, min_seconds: float) -> None:
    kernels.BUILD_DIR = kernel_dir
    kernels.MIN_PERSIST_SECS = min_seconds
    native._BUILD_DIR = native_dir
    native.MIN_PERSIST_SECS = min_seconds


def enable_compilation_cache(cache_dir: str, min_compile_time_secs: float = 1.0) -> str:
    """Build and load the port's libraries in ``cache_dir``.

    Idempotent; returns the directory in effect.  A library whose build took
    less than ``min_compile_time_secs`` is loaded but not kept there: it
    rebuilds faster than a cache is worth, as in the JAX package (an
    ``nvcc`` build takes seconds, so the kernels are kept).
    """
    global _enabled_dir
    if _enabled_dir is not None:
        return _enabled_dir
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    _point_builders_at(cache_dir, cache_dir, min_compile_time_secs)
    _enabled_dir = cache_dir
    return cache_dir


def disable_compilation_cache() -> None:
    """Point the builders back at the package's build directory.

    Libraries already loaded stay loaded; later loads build into and load
    from ``apda_fft_tpu_torch/_build/`` again.
    """
    global _enabled_dir
    if _enabled_dir is None:
        return
    _point_builders_at(*_DEFAULT_DIRS, 0.0)
    _enabled_dir = None


def enabled_dir() -> str | None:
    """The cache directory in effect, or None when the cache is disabled."""
    return _enabled_dir
