"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes`` - the
same pattern as the JAX package's native data loader
(``apda_fft_tpu/io/native.py``), without any PyTorch headers, so a build
takes seconds.  Sources may include the shared headers ``csrc/*.cuh``.
Libraries land in ``apda_fft_tpu_torch/_build/`` under a name that carries a
hash of the source, every header and the flags, so an edited source, header
or flag set is rebuilt and never confused with an old build.  Two different
kernels build at the same time when two threads load them.

There is no fallback here: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
#: Where libraries are built and loaded from (``utils/compilecache.py``
#: points it at a cache directory).
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
#: A library whose build took less is loaded and then removed from
#: ``BUILD_DIR`` (``enable_compilation_cache(min_compile_time_secs=)``).
MIN_PERSIST_SECS = 0.0

#: No --use_fast_math: the detector's decisions need IEEE division, sqrt
#: and round-to-nearest-even exactly as the reference computes them.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
_observers: list = []
_counters: list = []
_withheld = threading.local()


def note_launch(name: str, nbytes: int, flops: int) -> None:
    """Report one launch of kernel ``name`` and its work (bytes of its inputs
    and outputs, float32 operations; each kernel module's ``*_work``) to
    every :func:`counts_launches` counter and :func:`observe_launches`
    callback, or, inside :func:`withheld` on this thread, to its list.  The
    wrappers call it after each launch, and ``models/graphs.py`` again for
    each launch a CUDA graph's replay runs."""
    held = getattr(_withheld, "notes", None)
    if held is not None:
        held.append((name, nbytes, flops))
        return
    for count in _counters:
        count(name)
    for callback in tuple(_observers):
        callback(name, nbytes, flops)


def counts_launches(count):
    """Call ``count(name)`` for every launch noted from now on: how each
    kernel module keeps its launch counters, so that they advance alike for
    a wrapper's launch and for its replay from a CUDA graph.  Returns
    ``count``, so it decorates."""
    _counters.append(count)
    return count


@contextlib.contextmanager
def withheld():
    """Collect the launches this thread notes inside in the list it yields,
    instead of reporting them: a CUDA graph's capture queues launches that
    run only when it replays (``models/graphs.py`` notes them then)."""
    outer = getattr(_withheld, "notes", None)
    _withheld.notes = notes = []
    try:
        yield notes
    finally:
        _withheld.notes = outer


@contextlib.contextmanager
def observe_launches(callback):
    """Call ``callback(name, nbytes, flops)`` for every kernel launch inside."""
    _observers.append(callback)
    try:
        yield
    finally:
        _observers.remove(callback)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
    else ``nvcc`` on ``PATH``; raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use"
        )
    return found


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source bytes, the bytes of every ``csrc/*.cuh`` header and the compiler
    flags."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, name + ".cu"),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _build(src: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a private name and rename: another process may have the
    # finished library mapped.
    tmp = f"{out}.tmp.{os.getpid()}"
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, src],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it on first use."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            built_in = None
            if not os.path.exists(path):
                t0 = time.perf_counter()
                _build(os.path.join(CSRC_DIR, name + ".cu"), path)
                built_in = time.perf_counter() - t0
            lib = _libs[name] = ctypes.CDLL(path)
            if built_in is not None and built_in < MIN_PERSIST_SECS:
                os.unlink(path)  # the mapping stays valid
        return lib
