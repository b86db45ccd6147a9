"""Vectorized IEEE-754 binary16 sample decoding with reference quirks.

Sensor nodes stream acceleration samples as big-endian binary16 byte pairs.
The reference decodes them one pair at a time in pure Python
(``protocol_decoder.py:116-144``) and formats each as ``"%8.6f"`` after adding
a per-stream baseline offset (``:146-175``).  This module reproduces that
bit-for-bit with NumPy over whole payloads at once.

Two deliberate reference quirks are preserved (divergences from strict IEEE):

* subnormals use the *truncated* constant ``0.00006103515`` instead of
  2**-14 = 0.00006103515625 (``protocol_decoder.py:133``) - the difference can
  flip the 6th printed decimal;
* Inf decodes as **positive** infinity regardless of sign bit
  (``:140-141`` returns ``float('inf')`` unconditionally).
"""

from __future__ import annotations

import numpy as np

#: Reference's truncated subnormal scale (protocol_decoder.py:133).
SUBNORMAL_SCALE = 0.00006103515


def decode_half_words(words: np.ndarray) -> np.ndarray:
    """Decode uint16 half-float words to float64 with reference semantics."""
    words = np.asarray(words, dtype=np.uint16)
    exp = (words >> 10) & 0x1F
    sign = np.where(words & 0x8000, -1.0, 1.0)
    mant = (words & 0x03FF).astype(np.float64) / 1024.0

    normal = sign * np.exp2(exp.astype(np.float64) - 15.0) * (1.0 + mant)
    sub = np.where(mant != 0, sign * SUBNORMAL_SCALE * mant, 0.0)
    special = np.where(mant != 0, np.nan, np.inf)  # +inf even when sign bit set

    out = np.where(exp == 0, sub, normal)
    out = np.where(exp == 31, special, out)
    return out


def decode_payload(raw: bytes | bytearray | list[int], first_value: float = 0.0) -> np.ndarray:
    """Decode a big-endian byte-pair payload to float64 samples (+offset).

    A trailing odd byte is ignored, exactly like the reference's pairwise loop
    (``protocol_decoder.py:170-173``).
    """
    buf = np.frombuffer(bytes(raw), dtype=np.uint8)
    n = (len(buf) // 2) * 2
    words = (buf[:n:2].astype(np.uint16) << 8) | buf[1:n:2].astype(np.uint16)
    return decode_half_words(words) + first_value


def format_samples(values: np.ndarray) -> list[str]:
    """Render samples as the reference's ``"%8.6f"`` strings (``:174``)."""
    return [f"{v:8.6f}" for v in values]


def decode_samples(raw, first_value: float = 0.0) -> list[str]:
    """Drop-in equivalent of ``ProtocolDecoder.decode_samples`` (``:146-175``)."""
    return format_samples(decode_payload(raw, first_value))


def quantize_like_log(values: np.ndarray) -> np.ndarray:
    """Round-trip through the on-disk 6-decimal representation.

    A path that skips writing/parsing log files applies the same 1e-6
    quantization the format round-trip would, so spectra match the
    file-based path bit-for-bit.
    """
    return np.asarray([float(f"{v:8.6f}") for v in np.asarray(values, np.float64)])


def encode_halves(values: np.ndarray) -> bytes:
    """Encode floats as big-endian binary16 byte pairs (sensor-simulator side)."""
    return np.asarray(values, dtype=">f2").tobytes()
