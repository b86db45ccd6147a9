"""The yardstick of the roofline shares, frozen here.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its
700 W power limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside
the tensor cores.  A run prints the card's power limit beside the shares.

The work of a launch is what its inputs need: each input byte read once,
each output byte written once, and the float32 operations of the function
whatever the algorithm.  The formulas are copies of the port's
``ops/latency_cuda.py`` ``lowlat_work`` and ``ops/fft_cuda.py``
``rfft_mag_flops`` as they stand when this benchmark was defined, so that
a later change to the program cannot move the yardstick.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes or operations at peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def rfft_mag_flops(n: int) -> int:
    """|rfft| of one real ``n``-point window: 2.5 n log2 n for the real
    FFT, then 4 operations for each of the n/2 magnitudes."""
    return int(2.5 * n * (n.bit_length() - 1)) + 4 * (n // 2)


def lowlat_bytes(n: int, k: int) -> int:
    """B2/B3 on one ``n``-sample window with ``k`` slots: the window and the
    rate read once, ``k + 3`` int32 and ``6 k`` float32 outputs written."""
    return n * 4 + 4 + 4 * (k + 3 + 6 * k)
