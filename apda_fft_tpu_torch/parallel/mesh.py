"""Device meshes and sharded epoch analysis.

Counterpart of ``apda_fft_tpu/parallel/mesh.py``.  The JAX package runs one
SPMD program over a ``jax.sharding.Mesh``; the port keeps that single
controller: one process holds a :class:`Mesh` (a grid of ``torch.device``
with axis names), launches each shard's work on the shard's device, and
writes each collective of the JAX code out as copies between devices.  A
mesh may name one device more than once: logical shards on one card, or
``["cpu"] * 8`` in the tests, stand in for XLA's virtual host devices.

Copies to a card are queued ``non_blocking`` (copies to the host wait, as
the host reads them next), and every shard's work is launched before any
result is gathered, so distinct cards overlap.  On a
repeated device ``Tensor.to`` returns the tensor itself, so nothing here
writes into a block it received or into a caller's tensor.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from apda_fft_tpu_torch.models import pipeline as _pipeline
from apda_fft_tpu_torch.models.pipeline import _to_device
from apda_fft_tpu_torch.models.results import EpochResult
from apda_fft_tpu_torch.ops import fft as fft_ops
from apda_fft_tpu_torch.ops.stats import div_exact


class Mesh:
    """A grid of devices with one name per axis.

    ``devices`` is the grid (a numpy object array of ``torch.device``) and
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh`` does.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs {grid.ndim} axis names, "
                             f"got {axis_names}")
        self.devices = np.empty(grid.shape, dtype=object)
        for pos, dev in np.ndenumerate(grid):
            self.devices[pos] = torch.device(dev)
        self.axis_names = axis_names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        """Where gathered results sit."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, every other axis at index 0 (its
        other members hold replicas, which the port does not recompute)."""
        pos = [0] * self.devices.ndim
        pos[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(pos)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int | None = None, axis_names: tuple[str, ...] = ("data",),
              shape: tuple[int, ...] | None = None, *, devices=None) -> Mesh:
    """A mesh over ``n_devices`` devices.

    Without ``devices`` it takes the first ``n_devices`` visible CUDA devices
    (all of them by default) and raises without a card or with too few.
    ``devices`` lists ``n_devices`` devices explicitly, repeats allowed (e.g.
    ``["cpu"] * 8``, or ``["cuda:0"] * 4`` for logical shards of one card).
    ``shape`` gives the per-axis sizes (default: all devices on the first
    axis).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a mesh takes the visible cards by default; pass "
                "devices=['cpu'] * n to build one on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is None:
            n_devices = len(devices)
        if n_devices > len(devices):
            raise RuntimeError(f"mesh of {n_devices} devices, but only {len(devices)} "
                               "CUDA devices are visible")
        devices = devices[:n_devices]
    else:
        devices = list(devices)
        if n_devices is None:
            n_devices = len(devices)
        if len(devices) != n_devices:
            raise ValueError(f"devices lists {len(devices)} devices, not n_devices={n_devices}")
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n_devices:
        raise ValueError(f"mesh shape {shape} does not cover {n_devices} devices")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(shape), axis_names)


def _blocks(t: torch.Tensor, devices: list[torch.device], dim: int = 0) -> list[torch.Tensor]:
    """Equal blocks of ``t`` along ``dim``, block ``j`` on ``devices[j]``."""
    d = len(devices)
    if t.shape[dim] % d:
        raise ValueError(f"axis {dim} of size {t.shape[dim]} is not divisible by the {d} shards")
    r = t.shape[dim] // d
    return [_to_device(t.narrow(dim, j * r, r), dev) for j, dev in enumerate(devices)]


def _as_tensor(x, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A tensor where ``x`` lies, or a host tensor for an array or list."""
    if isinstance(x, torch.Tensor):
        return x.detach() if dtype is None else x.detach().to(dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` with its last row along axis 0 repeated ``pad`` more times."""
    if not pad:
        return t
    return torch.cat([t, t[-1:].expand((pad,) + tuple(t.shape[1:]))])


def shard_batch(arr, mesh: Mesh, axis: str = "data") -> list[torch.Tensor]:
    """``arr``'s leading (batch) axis split over ``axis``: one row block a
    member of the axis, in mesh order, each on its device."""
    return _blocks(_as_tensor(arr), mesh.axis_devices(axis))


def _gather(parts: list, dev: torch.device):
    """Per-shard tuples (or named tuples) of tensors, each field
    concatenated in shard order on ``dev``."""
    fields = [torch.cat([_to_device(t, dev) for t in ts]) for ts in zip(*parts)]
    return type(parts[0])(*fields) if hasattr(parts[0], "_fields") else tuple(fields)


def _sharded_pass(shards: list[tuple], dev0: torch.device, *, n_fft: int, mode: str, k: int,
                  backend: str, max_candidates, refine: bool, center: str, taper: str,
                  precision: str) -> EpochResult:
    """One epoch pass: every shard's front end and detector on its device,
    the two-tier split over the whole batch, results gathered on ``dev0``."""
    mags = [_pipeline._epoch_spectra(x, ln, n_fft=n_fft, backend=backend, center=center,
                                     taper=taper, precision=precision)
            for x, _, ln, _ in shards]
    flex = [None] * len(shards)
    if mode != "rigid":
        flex = _pipeline._flex_detect_blocks(mags, [s[1] for s in shards], n_fft=n_fft, k=k,
                                             max_candidates=max_candidates, gather_device=dev0)
    parts = [
        _pipeline._detect_from_mags(m, fs, n_fft=n_fft, mode=mode, k=k,
                                    max_candidates=max_candidates, refine=refine,
                                    half_corr=corr, flex=fl)
        for m, (_, fs, _, corr), fl in zip(mags, shards, flex)
    ]
    return _gather(parts, dev0)


def analyze_epoch_sharded(
    samples,
    fs,
    mesh: Mesh | None = None,
    batch_axis: str = "data",
    lengths=None,
    *,
    n_fft: int | None = None,
    mode: str = "flexible",
    k: int | None = None,
    backend: str = "matmul",
    max_candidates: int | str | None = None,
    refine: bool = False,
    dtype: torch.dtype = torch.float32,
    center: str = "auto",
    selection: str = "auto",
    batch_chunk: int = 0,
    taper: str = "none",
    precision: str = "highest",
) -> EpochResult:
    """Epoch analysis with the window batch sharded over ``batch_axis``.

    ``samples`` is ``[B, N]`` or any leading batch shape; the options are
    :func:`~apda_fft_tpu_torch.models.pipeline.analyze_epoch`'s.  A batch
    that the axis does not divide is padded by replicating its last row
    (``fs`` and ``lengths`` likewise), and the pad is sliced off the result.
    Each shard runs the front end and the detector on its device (on CUDA
    the select+scan kernel on every shard); the dynamic budget is one loop
    over the whole padded batch, so its budget, re-runs and learned tier are
    the single-device epoch's.  Returns an :class:`EpochResult` on the
    mesh's first device.  ``batch_chunk`` must be 0: each shard runs whole.
    """
    if mesh is None:
        mesh = make_mesh()
    if batch_chunk:
        raise ValueError(f"batch_chunk must be 0 on a mesh (each shard runs whole), "
                         f"got {batch_chunk}")
    x = _as_tensor(samples, dtype)
    if x.dim() < 2:
        x = x[None, :]
    if n_fft is None:
        n_fft = fft_ops.next_pow2(x.shape[-1])
    if k is None:
        k = _pipeline.default_k(mode)
    lead = tuple(x.shape[:-1])
    if any(d == 0 for d in lead):
        return _pipeline.analyze_epoch(
            x, fs, n_fft=n_fft, mode=mode, k=k, backend=backend, max_candidates=max_candidates,
            refine=refine, lengths=lengths, dtype=dtype, center=center, selection=selection,
            taper=taper, precision=precision, device=mesh.first_device)
    dynamic, max_candidates = _pipeline._check_options(
        n_fft=n_fft, mode=mode, max_candidates=max_candidates, center=center,
        selection=selection, taper=taper, backend=backend, precision=precision, empty=False,
    )
    devices = mesh.axis_devices(batch_axis)
    dev0 = mesh.first_device
    pad = (-lead[0]) % len(devices)
    padded = (lead[0] + pad,) + lead[1:]
    rows = int(np.prod(padded))

    x = _pad_rows(x, pad).reshape(rows, x.shape[-1])
    fs_rows = _pad_rows(
        fs.detach().broadcast_to(lead) if isinstance(fs, torch.Tensor)
        else torch.from_numpy(np.array(np.broadcast_to(np.asarray(fs, np.float64), lead))),
        pad,
    ).reshape(rows)
    len_rows = None
    if lengths is not None:
        len_rows = _pad_rows(_as_tensor(lengths, torch.int32).broadcast_to(lead), pad)
        len_rows = len_rows.reshape(rows)
    corr = None
    if mode in ("rigid", "adaptive") and rows:
        # The float64 rates, before any cast, for the non-dyadic wipe table.
        corr = _pipeline._rigid_corr_batch(_pipeline._host_rates(fs_rows), (rows,), n_fft)
    shards = list(zip(
        _blocks(x, devices),
        _blocks(fs_rows.to(dtype), devices),
        _blocks(len_rows, devices) if len_rows is not None else [None] * len(devices),
        _blocks(torch.from_numpy(corr), devices) if corr is not None else [None] * len(devices),
    ))

    def run(run_mode: str, mc) -> EpochResult:
        return _sharded_pass(shards, dev0, n_fft=n_fft, mode=run_mode, k=k, backend=backend,
                             max_candidates=mc, refine=refine, center=center, taper=taper,
                             precision=precision)

    res = _pipeline._run_modes(run, mode=mode, dynamic=dynamic, max_candidates=max_candidates,
                               n_fft=n_fft, n_windows=rows)
    return EpochResult(*(t.reshape(padded + t.shape[1:])[:lead[0]] for t in res))


def analyze_welch_sharded(
    records,
    fs,
    window: int,
    hop: int | None = None,
    *,
    mesh: Mesh | None = None,
    batch_axis: str = "data",
    dtype: torch.dtype = torch.float32,
    **kwargs,
) -> EpochResult:
    """Welch-averaged analysis with the channel axis of ``[C, T]`` records
    sharded over ``batch_axis``: each shard runs
    :func:`~apda_fft_tpu_torch.models.streaming.analyze_welch` on its device
    (default ``backend="matmul"``; ``kwargs`` are its options).  Uneven
    channel counts are padded by replicating the last channel and sliced
    off; the result sits on the mesh's first device.
    """
    from apda_fft_tpu_torch.models.streaming import analyze_welch

    if mesh is None:
        mesh = make_mesh()
    kwargs.setdefault("backend", "matmul")
    x = _as_tensor(records, dtype)
    if x.dim() != 2:
        raise ValueError(f"records must be [C, T], got shape {tuple(x.shape)}")
    c = x.shape[0]
    devices = mesh.axis_devices(batch_axis)
    pad = (-c) % len(devices)
    x_blocks = _blocks(_pad_rows(x, pad), devices)
    fs_arr = fs if isinstance(fs, torch.Tensor) else np.asarray(fs, np.float64)
    if fs_arr.ndim == 0:
        fs_blocks = [fs] * len(devices)
    elif isinstance(fs_arr, torch.Tensor):
        fs_blocks = _blocks(_pad_rows(fs_arr.detach().broadcast_to((c,)), pad), devices)
    else:
        # Host rates stay float64 numpy: analyze_welch's rigid wipe table
        # needs the original rates.
        fs_arr = np.pad(np.broadcast_to(fs_arr, (c,)), (0, pad), mode="edge")
        fs_blocks = np.split(fs_arr, len(devices))
    parts = [analyze_welch(xb, fb, window, hop, dtype=dtype, **kwargs)
             for xb, fb in zip(x_blocks, fs_blocks)]
    res = _gather(parts, mesh.first_device)
    return EpochResult(*(t[:c] for t in res))


def correlation_blocks_sharded(
    records,
    n_lags: int,
    mesh: Mesh,
    seq_axis: str = "seq",
    detrend: str = "mean",
    dtype: torch.dtype | None = None,
) -> np.ndarray:
    """SSI correlation blocks with the TIME axis sharded over ``seq_axis``.

    The contract of :func:`apda_fft_tpu_torch.models.ssi.correlation_blocks`
    (``R[l] = (1/T0) sum_{t<T0} y[:, t+l] y[:, t]^T``, ``T0 = T - L + 1``,
    per-channel mean removal, host float64) for ``[S, T]`` records split
    along T.  The global mean is the per-shard sums added in rank order;
    each shard receives the first ``L-1`` columns of its right neighbour
    (the JAX code's ``ppermute`` halo; the last shard's wraparound halo is
    never read, its base positions stopping at ``T0``), forms its per-lag
    products in IEEE float32, and the partials are added in rank order on
    the first device (the ``psum``).  T must be divisible by the axis size.
    """
    x = _as_tensor(records, dtype or torch.float32)
    if x.dim() != 2:
        raise ValueError(f"records must be [S, T], got shape {tuple(x.shape)}")
    s, t = x.shape
    if n_lags < 2:
        raise ValueError(f"n_lags must be >= 2, got {n_lags}")
    if t < 4 * n_lags:
        raise ValueError(
            f"record too short: T={t} < 4*n_lags={4 * n_lags} "
            "(correlation estimates would be meaningless)"
        )
    if detrend not in ("mean", "none"):
        raise ValueError(f"unknown detrend {detrend!r}; expected 'mean' or 'none'")
    d = mesh.shape[seq_axis]
    if t % d:
        raise ValueError(f"T={t} must be divisible by the {seq_axis!r} axis size {d}")
    c = t // d
    if c < n_lags:
        raise ValueError(
            f"per-device chunk {c} shorter than n_lags={n_lags}: "
            "use fewer devices or longer records"
        )
    t0 = t - n_lags + 1
    devices = mesh.axis_devices(seq_axis)
    dev0 = mesh.first_device
    chunks = _blocks(x, devices, dim=1)  # [S, C] a shard
    if detrend == "mean":
        sums = [_to_device(ch.sum(dim=-1), dev0) for ch in chunks]
        total = sums[0]
        for part in sums[1:]:
            total = total + part
        mean = div_exact(total, float(t))
        chunks = [ch - _to_device(mean, ch.device)[:, None] for ch in chunks]
    partials = []
    for rank, ch in enumerate(chunks):
        right = chunks[(rank + 1) % d]
        ext = torch.cat([ch, _to_device(right[:, : n_lags - 1], ch.device)], dim=-1)  # [S, C+L-1]
        base = rank * c + torch.arange(c, device=ch.device)
        y0m_t = (ch * (base < t0).to(ch.dtype)[None, :]).T
        with fft_ops.ieee_fp32_matmul():
            partials.append(torch.stack([torch.matmul(ext[:, lag:lag + c], y0m_t)
                                         for lag in range(n_lags)]))
    total = _to_device(partials[0], dev0)
    for part in partials[1:]:
        total = total + _to_device(part, dev0)
    return div_exact(total, float(t0)).cpu().numpy().astype(np.float64)
