"""Record batching: ragged host-side records -> bucketed epochs.

Counterpart of ``apda_fft_tpu/models/batching.py``.  A list of
variable-length ``(samples, fs)`` records becomes one padded ``[B, n_fft]``
epoch per power-of-two bucket (or one ``[B, T]`` Welch batch per exact
length), analysed in one call each, with results mapped back to the
originating records.  The reference's per-file loop
(``GT_FFT_v5.py:620-679``) becomes one call per bucket.

Each bucket's result comes to the host in one copy per dtype (its int32
fields packed into one buffer, its float fields into another), so the
per-record reads of :class:`RecordPeaks` touch host tensors only.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from apda_fft_tpu_torch.models.pipeline import analyze_epoch
from apda_fft_tpu_torch.models.results import EpochResult
from apda_fft_tpu_torch.ops.fft import next_pow2


@dataclasses.dataclass
class RecordPeaks:
    """Per-record view into a bucket's :class:`EpochResult` (host tensors)."""

    n_fft: int
    fs: float
    result: EpochResult  # the bucket result
    row: int  # this record's row within the bucket

    @property
    def count(self) -> int:
        return int(self.result.count[self.row])

    def peak(self, slot: int) -> dict:
        r, i = self.result, self.row
        return {
            "idx": int(r.idx[i, slot]),
            "freq": float(r.freq[i, slot]),
            "mag": float(r.mag[i, slot]),
            "prominence": float(r.prominence[i, slot]),
            "damping": float(r.damping[i, slot]),
            "q_factor": float(r.q_factor[i, slot]),
            "refined_freq": float(r.refined_freq[i, slot]),
        }

    def exact_freq(self, slot: int, mode: str) -> float:
        """Host-float64 frequency finisher (bit-exact once the index matches).

        Flexible peaks are stored 4-decimal rounded, rigid peaks unrounded
        (reference ``get_peak_prominence.py:188`` vs ``get_peak_resolution.py:105``).
        For ``mode="adaptive"`` the per-window detector is recovered from the
        result itself: windows served by the prominence pass carry a strictly
        positive first-slot prominence (acceptance requires prom > 0.5*std);
        fallback windows have it zeroed by the merge.
        """
        idx = int(self.result.idx[self.row, slot])
        if mode == "adaptive":
            used_flex = (
                int(self.result.count[self.row]) > 0
                and float(self.result.prominence[self.row, 0]) > 0.0
            )
            mode = "flexible" if used_flex else "rigid"
        if mode == "rigid":
            return idx * (self.fs / self.n_fft)
        return round(idx * self.fs / self.n_fft, 4)


def _host_dtype(req) -> type:
    """The host buffers' dtype for a requested compute dtype (a torch or
    numpy dtype, or None): float64 stays float64, anything else is float32."""
    if isinstance(req, torch.dtype):
        f64 = req == torch.float64
    else:
        f64 = req is not None and np.dtype(req) == np.float64
    return np.float64 if f64 else np.float32


def _host_copies(tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``tensors`` on the host in one device-to-host copy per dtype: each
    dtype's tensors are packed into one buffer, copied, and split again."""
    groups: dict[torch.dtype, list[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    out: list[torch.Tensor | None] = [None] * len(tensors)
    for idxs in groups.values():
        host = torch.cat([tensors[i].reshape(-1) for i in idxs]).cpu()
        for i, part in zip(idxs, torch.split(host, [tensors[i].numel() for i in idxs])):
            out[i] = part.reshape(tensors[i].shape)
    return out  # type: ignore[return-value]


def _to_host(result: EpochResult) -> EpochResult:
    """``result`` on the host in one device-to-host copy per dtype."""
    return EpochResult(*_host_copies(result))


def analyze_records(
    records: Sequence[tuple[np.ndarray, float]],
    analyze=analyze_epoch,
    on_bucket=None,
    batch_pad: str | None = "pow2",
    **kwargs,
) -> list[RecordPeaks]:
    """Analyze ragged ``(samples, fs)`` records, one call per bucket.

    Records are grouped by ``next_pow2(len(samples))``, zero-padded with their
    true lengths passed through (so median-centering stays exact: every
    bucket takes the batched path, even one record of full length), and
    results are returned in input order.  ``analyze`` is pluggable (e.g. a
    :class:`~apda_fft_tpu_torch.models.pipeline.SpectralPipeline`);
    ``kwargs`` forward to it (mode, backend, device, ...).
    ``on_bucket(n_fft, record_indices)`` is invoked after each bucket's
    analyze call, so callers can attribute per-run state (e.g. a metric
    snapshot) to the records that run produced.

    ``batch_pad="pow2"`` (default) rounds each bucket's batch up to the next
    power of two with replicate-last pad rows (never referenced by the
    returned views), as the JAX package does; ``None`` runs exact batches.
    """
    buckets: dict[int, list[int]] = {}
    for i, (samples, _) in enumerate(records):
        if len(samples) == 0:
            raise ValueError(f"record {i} is empty")
        buckets.setdefault(next_pow2(len(samples)), []).append(i)

    # Host buffers honor a requested compute dtype: building them as float32
    # under dtype=float64 would truncate the inputs before the high-precision
    # path saw them.  The dtype may arrive as a kwarg or be carried by a
    # SpectralPipeline passed as ``analyze``.
    req = kwargs.get("dtype")
    if req is None:
        req = getattr(getattr(analyze, "config", None), "dtype", None)
    host_dtype = _host_dtype(req)

    out: list[RecordPeaks | None] = [None] * len(records)
    for n_fft, idxs in sorted(buckets.items()):
        b = len(idxs)
        bp = next_pow2(b) if batch_pad == "pow2" else b
        batch = np.zeros((bp, n_fft), host_dtype)
        lengths = np.full((bp,), n_fft, np.int32)
        # fs stays float64 on the host: the rigid detector's non-dyadic
        # wipe-rounding table needs the original float64 rate.
        fs = np.ones((bp,), np.float64)
        for row, i in enumerate(idxs):
            samples, rec_fs = records[i]
            batch[row, : len(samples)] = samples
            lengths[row] = len(samples)
            fs[row] = rec_fs
        # Pad rows REPLICATE the last real record: zero rows have count 0,
        # which would force adaptive mode's rigid fallback on every padded
        # call; replicated rows behave like their source in every detector.
        batch[b:] = batch[b - 1]
        lengths[b:] = lengths[b - 1]
        fs[b:] = fs[b - 1]
        result = _to_host(analyze(batch, fs, n_fft=n_fft, lengths=lengths, **kwargs))
        if on_bucket is not None:
            on_bucket(n_fft, list(idxs))
        for row, i in enumerate(idxs):
            out[i] = RecordPeaks(n_fft=n_fft, fs=records[i][1], result=result, row=row)
    return out  # type: ignore[return-value]


def analyze_records_welch(
    records: Sequence[tuple[np.ndarray, float]],
    *,
    window: int,
    hop: int | None = None,
    taper: str = "hann",
    analyze=None,
    on_bucket=None,
    batch_pad: str | None = "pow2",
    **kwargs,
) -> list[RecordPeaks]:
    """Welch-analyze ragged records, one call per record-length bucket.

    The Welch companion of :func:`analyze_records` for long, noisy
    acquisitions (see
    :func:`~apda_fft_tpu_torch.models.streaming.analyze_welch`).  Records
    are bucketed by their EXACT length: zero-padding a record before
    segmenting would pollute the trailing segments with synthetic silence.
    Records shorter than ``window`` are analyzed as a single clamped segment
    (effective window = record length); ``on_bucket(n_fft, record_indices)``
    reports the effective padded segment length per bucket.  ``batch_pad``
    as in :func:`analyze_records`.
    """
    if analyze is None:
        from apda_fft_tpu_torch.models.streaming import analyze_welch

        analyze = analyze_welch
    if window < 2:
        raise ValueError(f"window must be >= 2, got {window}")
    if hop is not None and hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")

    buckets: dict[int, list[int]] = {}
    for i, (samples, _) in enumerate(records):
        if len(samples) < 2:
            raise ValueError(f"record {i} has fewer than 2 samples")
        buckets.setdefault(len(samples), []).append(i)

    # Same host-dtype contract as analyze_records; a SpectralPipeline's
    # ``welch`` method carries its config on ``__self__``.
    req = kwargs.get("dtype")
    if req is None:
        req = getattr(getattr(analyze, "__self__", None), "config", None)
        req = getattr(req, "dtype", None)
    host_dtype = _host_dtype(req)

    out: list[RecordPeaks | None] = [None] * len(records)
    for t, idxs in sorted(buckets.items()):
        eff_window = min(window, t)
        eff_hop = min(hop, eff_window) if hop is not None else max(eff_window // 2, 1)
        n_fft = next_pow2(eff_window)
        b = len(idxs)
        bp = next_pow2(b) if batch_pad == "pow2" else b
        batch = np.zeros((bp, t), host_dtype)
        fs = np.ones((bp,), np.float64)
        for row, i in enumerate(idxs):
            batch[row] = np.asarray(records[i][0], host_dtype)
            fs[row] = records[i][1]
        batch[b:] = batch[b - 1]  # replicate-last pad (see analyze_records)
        fs[b:] = fs[b - 1]
        result = _to_host(analyze(batch, fs, window=eff_window, hop=eff_hop, taper=taper,
                                  **kwargs))
        if on_bucket is not None:
            on_bucket(n_fft, list(idxs))
        for row, i in enumerate(idxs):
            out[i] = RecordPeaks(n_fft=n_fft, fs=records[i][1], result=result, row=row)
    return out  # type: ignore[return-value]
