"""ctypes loader for the native data-loader kernels (``csrc/host/apda_io.cc``).

Host code, not a device kernel: the gateway's per-packet ingest (binary16
decode, ``"%8.6f;"`` render, fused file append, quantize) and the log-file
sample parser.  The port keeps its own copy of the C++ source under
``csrc/host/`` (outside the ``csrc/*.cu`` set the CUDA builder hashes) and
compiles it on first use with ``g++ -O3 -shared -fPIC`` into
``apda_fft_tpu_torch/_build/`` under a name that carries a hash of the
source, so an edited source is rebuilt and never confused with an old
build.  Every entry point has a NumPy fallback, so the package works
without a toolchain; ``APDA_NO_NATIVE=1`` forces the fallbacks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

from apda_fft_tpu_torch.io import halffloat

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "host", "apda_io.cc")
#: Where the library is built and loaded from (``utils/compilecache.py``
#: points it at a cache directory).
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
#: A build that took less is loaded and then removed from ``_BUILD_DIR``.
MIN_PERSIST_SECS = 0.0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


def _library_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libapda_io-{digest}.so")


def _build(out: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # Build to a temp name + atomic rename: writing the .so in place would
    # truncate the inode a concurrently running process may have mapped
    # (executing pages of a truncated mapping segfaults that process).
    tmp = out + f".tmp.{os.getpid()}"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL | None:
    """The native library, building it on first call; None if unavailable.

    ``APDA_NO_NATIVE=1`` forces the NumPy/Python fallbacks everywhere -
    the diagnostic/bisection knob for separating native-code faults from
    the rest of the process.
    """
    global _lib, _load_failed
    if os.environ.get("APDA_NO_NATIVE") == "1":
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            path = _library_path()
            built_in = None
            if not os.path.exists(path):
                t0 = time.perf_counter()
                _build(path)
                built_in = time.perf_counter() - t0
            lib = ctypes.CDLL(path)
            if built_in is not None and built_in < MIN_PERSIST_SECS:
                os.unlink(path)  # the mapping stays valid
            lib.apda_decode_half.restype = ctypes.c_long
            lib.apda_decode_half.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.apda_format_samples.restype = ctypes.c_long
            lib.apda_format_samples.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_long,
                ctypes.c_char_p, ctypes.c_long,
            ]
            lib.apda_parse_samples.restype = ctypes.c_long
            lib.apda_parse_samples.argtypes = [
                ctypes.c_char_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ]
            lib.apda_append_half_payload.restype = ctypes.c_long
            lib.apda_append_half_payload.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_double,
                ctypes.c_char_p,
            ]
            # out param as c_void_p: lets the per-packet hot path pass the
            # raw ndarray.ctypes.data integer (data_as(POINTER(...)) costs
            # ~2 us/call in object churn - measurable at packet rate).
            lib.apda_append_half_payload_q.restype = ctypes.c_long
            lib.apda_append_half_payload_q.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_double,
                ctypes.c_char_p, ctypes.c_void_p,
            ]
            lib.apda_append_half_payload_qfd.restype = ctypes.c_long
            lib.apda_append_half_payload_qfd.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_double,
                ctypes.c_int, ctypes.c_void_p,
            ]
            _lib = lib
        except Exception:  # noqa: BLE001 - fall back to NumPy implementations
            _load_failed = True
    return _lib


def available() -> bool:
    return load() is not None


def decode_payload(raw: bytes, first_value: float = 0.0) -> np.ndarray:
    """Native-accelerated :func:`apda_fft_tpu_torch.io.halffloat.decode_payload`."""
    lib = load()
    if lib is None:
        return halffloat.decode_payload(raw, first_value)
    raw = bytes(raw)
    out = np.empty(len(raw) // 2, np.float64)
    n = lib.apda_decode_half(
        raw, len(raw), first_value,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out[:n]


def format_samples(values: np.ndarray) -> str:
    """';'-joined "%8.6f" token stream (with trailing ';'), natively rendered."""
    values = np.ascontiguousarray(values, np.float64)
    lib = load()
    if lib is None:
        return "".join(s + ";" for s in halffloat.format_samples(values))
    cap = 32 * len(values) + 16
    buf = ctypes.create_string_buffer(cap)
    used = lib.apda_format_samples(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(values), buf, cap
    )
    if used < 0:
        return "".join(s + ";" for s in halffloat.format_samples(values))
    return buf.raw[:used].decode("ascii")


def append_half_payload(path: str | os.PathLike, raw: bytes,
                        first_value: float = 0.0) -> int | None:
    """Fused per-packet ingest: decode + "%8.6f;" render + file append in one
    native call (the gateway's packet hot path).

    Returns the number of samples appended, or ``None`` when the native
    library is unavailable or formatting failed with the file untouched —
    the caller then runs the Python two-step path. An I/O failure AFTER the
    file was opened raises ``OSError`` (a fallback re-append could duplicate
    partially-written samples), matching a failed Python ``write``.
    """
    lib = load()
    if lib is None:
        return None
    n = lib.apda_append_half_payload(
        bytes(raw), len(raw), first_value, os.fspath(path).encode()
    )
    if n == -2:
        raise OSError(f"native sample append failed mid-write on {path}")
    return None if n < 0 else n


def append_half_payload_quantized(
    path: str | os.PathLike, raw: bytes, first_value: float = 0.0
) -> np.ndarray | None:
    """Fused ingest + in-memory analysis feed.

    Decodes the binary16 payload, appends the "%8.6f;" token stream to the
    log file (durability artifact), AND returns the finite samples exactly
    as a re-parse of those tokens would yield them - the gateway's
    memory-fed analysis path (kills the reference's write-then-re-parse
    round-trip, ``GT_FFT_v5.py:627``).

    Returns the quantized sample array, or ``None`` when the native library
    is unavailable / formatting failed with the file untouched (caller runs
    the Python two-step + :func:`quantize_parse` fallback).  Raises
    ``OSError`` on an I/O failure after the file was opened (bytes may be
    partial; the caller must drop its in-memory record for this file).
    """
    lib = load()
    if lib is None:
        return None
    if not isinstance(raw, bytes):
        raw = bytes(raw)
    out = np.empty(max(len(raw) // 2, 1), np.float64)
    n = lib.apda_append_half_payload_q(
        raw, len(raw), first_value, os.fspath(path).encode(),
        out.ctypes.data,
    )
    if n == -2:
        raise OSError(f"native sample append failed mid-write on {path}")
    return None if n < 0 else out[:n]


def append_half_payload_quantized_fd(
    fd: int, raw: bytes, first_value: float = 0.0,
    quantize: bool = True,
) -> np.ndarray | int | None:
    """Fused ingest onto an already-open ``O_APPEND`` fd (the gateway keeps
    one per in-flight acquisition): per-packet fopen/fwrite/fclose - the
    dominant cost of the path-based call - collapses to one write(2).

    Returns the quantized sample array (``quantize=True``) or the appended
    sample count (``quantize=False``); ``None`` when the native library is
    unavailable or formatting failed with the fd untouched (caller falls
    back to the path-based Python two-step).  Raises ``OSError`` on a write
    failure (bytes may be partial).
    """
    lib = load()
    if lib is None:
        return None
    if not isinstance(raw, bytes):
        raw = bytes(raw)
    if quantize:
        out = np.empty(max(len(raw) // 2, 1), np.float64)
        n = lib.apda_append_half_payload_qfd(
            raw, len(raw), first_value, fd, out.ctypes.data)
    else:
        n = lib.apda_append_half_payload_qfd(raw, len(raw), first_value, fd, None)
    if n == -2:
        raise OSError(f"native sample append failed mid-write on fd {fd}")
    if n < 0:
        return None
    return out[:n] if quantize else n


def quantize_parse(values: np.ndarray) -> np.ndarray:
    """Round-trip values through the "%8.6f" token contract, dropping
    non-finite results - the pure-Python twin of the quantized feed (what a
    format + file re-parse of ``values`` would return)."""
    toks = [f"{v:8.6f}" for v in np.asarray(values, np.float64)]
    out = []
    for t in toks:
        v = float(t)
        if np.isfinite(v):
            out.append(v)
    return np.asarray(out, np.float64)


def parse_samples(text: str) -> np.ndarray:
    """Parse log rows 4+ sample tokens (skips markers / non-finite values)."""
    lib = load()
    data = text.encode("utf-8")
    if lib is None:
        out = []
        for tok in text.replace("\n", ";").split(";"):
            tok = tok.strip()
            if not tok:
                continue
            try:
                v = float(tok)
            except ValueError:
                continue
            if np.isfinite(v):
                out.append(v)
        return np.asarray(out, np.float64)
    # Max token count for L bytes is (L+1)//2 (1-char tokens + separators):
    # len//2 alone undersized the buffer and silently dropped the last sample.
    out = np.empty(max(len(data) // 2 + 1, 16), np.float64)
    n = lib.apda_parse_samples(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(out)
    )
    return out[:n]
