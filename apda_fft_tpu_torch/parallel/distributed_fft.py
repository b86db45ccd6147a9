"""Sequence-parallel FFT: one record's transform sharded over a mesh axis.

Counterpart of ``apda_fft_tpu/parallel/distributed_fft.py``: the four-step
FFT with the record split over ``seq_axis`` (and the batch over
``data_axis``), in the same steps as the JAX code's ``shard_map`` program:

    m1-sharded rows --all_to_all--> m2-sharded columns
      -> local N1-point DFT (two products) + the rank's twiddle slice
    k1-sharded rows  <--all_to_all--
      -> local N2-point DFT (four products)
    all_gather of the k1 chunks -> full half-spectrum magnitudes per window

Each collective is written out as per-shard copies between the mesh's
devices (:mod:`apda_fft_tpu_torch.parallel.mesh`).  Every product runs in
IEEE float32 (``ieee_fp32_matmul``): TF32 would break the 1e-6 spectrum
contract.
"""

from __future__ import annotations

import functools

import torch

from apda_fft_tpu_torch.utils.placement import to_device
from apda_fft_tpu_torch.ops.fft import (
    _dft_tables,
    _twiddle_tables,
    ieee_fp32_matmul,
    is_pow2,
    split_pow2,
)
from apda_fft_tpu_torch.parallel.mesh import Mesh, _as_tensor, _blocks


@functools.lru_cache(maxsize=64)
def _tables(n1: int, n2: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """``c1, s1 [n1, n1]``, ``c2, s2 [n2, n2]`` and the twiddles
    ``twc, tws [n1, n2]`` (``W_N^{k1*m2}``), float32 on ``device``."""
    host = (*_dft_tables(n1, "float32"), *_dft_tables(n2, "float32"),
            *_twiddle_tables(n1, n2, "float32"))
    return tuple(torch.tensor(t, device=device) for t in host)


def shard_windows_2d(x, mesh: Mesh, data_axis: str = "data",
                     seq_axis: str = "seq") -> list[list[torch.Tensor]]:
    """``[B, N]`` windows as the ``(data, seq)`` grid of blocks: block
    ``[i][j]`` holds batch block ``i`` and record chunk ``j``, on the device
    at ``data=i, seq=j``."""
    x = _as_tensor(x, torch.float32)
    pos = [0] * mesh.devices.ndim
    d_ax, s_ax = mesh.axis_names.index(data_axis), mesh.axis_names.index(seq_axis)
    grid = []
    for i, rows in enumerate(_blocks(x, mesh.axis_devices(data_axis))):
        pos[d_ax] = i
        devs = []
        for j in range(mesh.shape[seq_axis]):
            pos[s_ax] = j
            devs.append(mesh.devices[tuple(pos)])
        grid.append(_blocks(rows, devs, dim=1))
    return grid


def distributed_halfspec_magnitudes(x, mesh: Mesh, data_axis: str = "data",
                                    seq_axis: str = "seq") -> torch.Tensor:
    """|FFT| half-spectrum ``[B, N/2]`` of windows ``x``, DC bin zeroed.

    ``x`` is a whole ``[B, N]`` tensor or array, or the grid of
    :func:`shard_windows_2d`.  The result sits on the mesh's first device,
    ready for the peak detectors.
    """
    grid = x if isinstance(x, list) else shard_windows_2d(x, mesh, data_axis, seq_axis)
    ds = mesh.shape[seq_axis]
    n = grid[0][0].shape[-1] * ds
    if not is_pow2(n):
        raise ValueError(f"window length must be a power of two, got {n}")
    n1, n2 = split_pow2(n)
    if n1 % ds or n2 % ds:
        raise ValueError(f"seq axis size {ds} must divide both N1={n1} and N2={n2}")
    r1, r2 = n1 // ds, n2 // ds
    dev0 = mesh.first_device
    out = []
    with ieee_fp32_matmul():
        for row in grid:
            bl = row[0].shape[0]
            devs = [blk.device for blk in row]
            # Local rows are an m1 block (a contiguous chunk of the record).
            local = [blk.reshape(bl, r1, n2) for blk in row]
            # Distributed transpose 1 (all_to_all, split m2, concat m1): rank
            # r receives chunk r of every rank's m2 axis, in rank order.
            cols = [torch.cat([to_device(a[:, :, r * r2:(r + 1) * r2], dev) for a in local],
                              dim=1)
                    for r, dev in enumerate(devs)]
            spec = []
            for r, (a, dev) in enumerate(zip(cols, devs)):
                c1, s1, _, _, twc, tws = _tables(n1, n2, dev)
                # Local N1-point DFT over the full m1 (real input: two products).
                br = torch.matmul(c1, a)
                bi = torch.matmul(s1, a)
                # The twiddle slice of this rank's m2 columns.
                tc, ts = twc[:, r * r2:(r + 1) * r2], tws[:, r * r2:(r + 1) * r2]
                spec.append((br * tc - bi * ts, br * ts + bi * tc))
            # Distributed transpose 2 (all_to_all, split k1, concat m2).
            mags = []
            for r, dev in enumerate(devs):
                cr, ci = (torch.cat([to_device(p[c][:, r * r1:(r + 1) * r1, :], dev)
                                     for p in spec], dim=2) for c in (0, 1))
                _, _, c2, s2, _, _ = _tables(n1, n2, dev)
                # Local N2-point DFT over the full m2.
                dr = torch.matmul(cr, c2) - torch.matmul(ci, s2)
                di = torch.matmul(cr, s2) + torch.matmul(ci, c2)
                mags.append(torch.sqrt(dr * dr + di * di)[:, :, : n2 // 2])  # [bl, r1, n2/2]
            # all_gather, then k = k1 + N1*k2.
            gathered = torch.stack([to_device(m, dev0) for m in mags])  # [ds, bl, r1, n2/2]
            out.append(gathered.permute(1, 3, 0, 2).reshape(bl, n // 2))
    full = torch.cat(out)
    full[:, 0] = 0.0
    return full
