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

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: No --use_fast_math: the detector's decisions need IEEE division, sqrt
#: and round-to-nearest-even exactly as the reference computes them.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}


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
            if not os.path.exists(path):
                _build(os.path.join(CSRC_DIR, name + ".cu"), path)
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
