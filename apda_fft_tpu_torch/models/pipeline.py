"""The epoch batch pipeline on PyTorch.

Counterpart of ``apda_fft_tpu/models/pipeline.py``.  An epoch of windows
``[..., N]`` runs

    center (mean or median) -> pad -> taper -> |DFT| half-spectrum -> detect -> refine

over the whole batch at once.  A tensor's epoch runs on its device; an array
or list runs on the card unless the caller passes ``device="cpu"``.  On a
CUDA device every flexible-mode detect pass goes through the hand-written
select+scan kernel (``ops/detector_cuda.py``) and ``backend="pallas"`` runs
the fused front-end kernel (``ops/fft_cuda.py``); on the CPU the same
wrappers run their plain torch versions.  An epoch of one full window on a
CUDA device takes the single-window latency route instead
(``ops/latency_cuda.py``): the whole pipeline in one kernel launch.

``mode="flexible"`` selects the prominence detector, ``mode="rigid"`` the
resolution detector and ``mode="adaptive"`` the prominence detector with a
per-window resolution fallback.

The default candidate budget is dynamic: a sticky per-``(n_fft, mode)``
power-of-two budget with an overflow re-run and a learned two-tier split,
so decisions always match the unbounded reference.  That learned state is
this system's only state; :func:`dynamic_state`, :func:`load_dynamic_state`
and :func:`reset_dynamic_state` read, set and clear it (the setter takes the
JAX package's dictionaries as they are).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from apda_fft_tpu_torch.models.results import EpochResult
from apda_fft_tpu_torch.ops import fft as fft_ops
from apda_fft_tpu_torch.ops.detector_cuda import prominence_peaks_fused
from apda_fft_tpu_torch.ops.peaks_prominence import check_selection
from apda_fft_tpu_torch.ops.peaks_resolution import (
    resolution_peaks,
    rigid_half_corrections,
)
from apda_fft_tpu_torch.ops.stats import div_exact
from apda_fft_tpu_torch.utils.profiling import span

MODES = ("flexible", "rigid", "adaptive")


def default_k(mode: str) -> int:
    """Reference defaults: top-4 in flexible/adaptive mode, top-5 in rigid mode."""
    return 5 if mode == "rigid" else 4


def default_max_candidates(n_fft: int) -> int:
    """Static candidate budget scaled to spectrum size: H/64 in [32, 512]."""
    return max(32, min(512, (n_fft // 2) // 64))


#: Sticky per-(n_fft, mode) dynamic candidate budgets (powers of two, floor
#: 2), their high-water marks, and the learned two-tier split
#: ``(m_small, s_cap)`` - the same tables, with the same keys and values, as
#: the JAX package keeps.
_dynamic_budget: dict[tuple[int, str], int] = {}
_dynamic_budget_hwm: dict[tuple[int, str], int] = {}
_dynamic_tier: dict[tuple[int, str], tuple[int, int]] = {}
#: m_small candidates: powers of two plus 1.5x points.
_TIER_GRID = (4, 6, 8, 12, 16, 24, 32, 48, 64)
_DYNAMIC_FLOOR = 2
#: Stats of the most recent dynamic-budget run on this thread.
_dynamic_tls = threading.local()
#: Largest flexible budget the single-window latency route runs.  A window
#: that needs more goes to the batched path.  The JAX package's limit, kept
#: so that both packages route the same windows.
LOWLAT_MAX_BUDGET = 64


def _placed(x, device: torch.device | str | None, dtype: torch.dtype | None = None):
    """``x`` as a tensor on ``device`` when given, else a tensor where it
    lies, else (an array or list) on the card.

    The port runs on CUDA unless the caller asks for the CPU; without a
    CUDA device an array raises instead of carrying on there silently.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=dtype)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass a CPU tensor "
                "(or device='cpu' to analyze_epoch / PipelineConfig) to run on the CPU"
            )
        device = "cuda"
    return _from_host(np.asarray(x), device, dtype)


#: Host arrays up to this many bytes are copied to the card from pageable
#: memory; larger ones go through pinned memory.  On the H100 a pageable
#: ``non_blocking`` copy of up to 1 MiB was the faster one and did not wait
#: for queued card work, while one of 4 MiB waited for it (``chip_smoke.py``
#: phase 18 times both ways across sizes).
_PAGEABLE_MAX_BYTES = 1 << 20


def _from_host(a: np.ndarray, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The host array ``a`` as a tensor on ``device``, cast on the host.

    A copy to the card is queued with ``non_blocking`` (a blocking copy
    would wait for all work queued before it), so a caller can queue the
    next epoch while the card runs this one.
    """
    t = torch.as_tensor(a, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    if t.nbytes > _PAGEABLE_MAX_BYTES:
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``, waiting for the card only where the host reads
    the copy: host memory to the card through :func:`_from_host`, card to
    card by a ``non_blocking`` copy, and anything to the host by a blocking
    one.  No copy at all when ``t`` lies on ``device`` already."""
    if t.device.type == "cpu" and device.type == "cuda":
        return _from_host(t.contiguous().numpy(), device)
    return t.to(device, non_blocking=device.type == "cuda")


def _fs_tensor(fs, dtype: torch.dtype, device) -> torch.Tensor:
    """Sampling rate(s) ``fs`` as a ``dtype`` tensor on ``device``; a scalar
    is filled there, so placing it does not wait for the card either."""
    if isinstance(fs, torch.Tensor):
        return fs.detach().to(device=device, dtype=dtype)
    a = np.asarray(fs)
    if a.ndim == 0:
        return torch.full((), float(a), dtype=dtype, device=device)
    return _from_host(a, device, dtype)


def _lowlat_device(samples: torch.Tensor) -> bool:
    """Whether the latency kernels run on ``samples``' device."""
    return samples.device.type == "cuda"


def last_dynamic_stats() -> dict:
    d = getattr(_dynamic_tls, "stats", None)
    if d is None:
        d = _dynamic_tls.stats = {}
    return d


def dynamic_state() -> dict:
    """Copies of the learned budget tables: ``{"budget", "hwm", "tier"}``."""
    return {
        "budget": dict(_dynamic_budget),
        "hwm": dict(_dynamic_budget_hwm),
        "tier": dict(_dynamic_tier),
    }


def load_dynamic_state(budget: dict, hwm: dict, tier: dict) -> None:
    """Replace the learned tables, e.g. with the JAX package's
    ``_dynamic_budget``, ``_dynamic_budget_hwm`` and ``_dynamic_tier``."""
    reset_dynamic_state()
    _dynamic_budget.update({(int(n), str(m)): int(v) for (n, m), v in budget.items()})
    _dynamic_budget_hwm.update({(int(n), str(m)): int(v) for (n, m), v in hwm.items()})
    _dynamic_tier.update(
        {(int(n), str(m)): (int(a), int(c)) for (n, m), (a, c) in tier.items()}
    )


def reset_dynamic_state() -> None:
    """Forget every learned budget and split."""
    _dynamic_budget.clear()
    _dynamic_budget_hwm.clear()
    _dynamic_tier.clear()


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def _effective_mc(
    budget: int, h: int, n_windows: int, tier: tuple[int, int] | None
) -> int | tuple[int, int, int]:
    """The budget for one dynamic pass: the flat int, or the two-tier
    ``(m_small, m_big, s_cap)`` when a learned split applies.  Never tiers
    at ``budget == h``, where a flat run is unconditionally exact."""
    if (
        tier is not None
        and tier[0] * 2 <= budget
        and budget < h
        and n_windows >= 4 * min(tier[1], n_windows)
    ):
        return (tier[0], budget, tier[1])
    return budget


def steady_state_max_candidates(
    n_fft: int, mode: str, n_windows: int
) -> int | tuple[int, int, int]:
    """What the dynamic budget would run for the next ``n_windows``-window
    epoch on ``(n_fft, mode)``: the flat int budget or the two-tier split."""
    h = max(n_fft // 2, 1)
    key = (n_fft, mode)
    budget = min(_dynamic_budget.get(key, _DYNAMIC_FLOOR), h)
    return _effective_mc(budget, h, n_windows, _dynamic_tier.get(key))


def _tier_capacity(b: int) -> int:
    """Straggler capacity for a ``b``-window epoch: pow2(b/16) in [32, 512]."""
    return max(32, min(512, _pow2_at_least(b // 16)))


def refine_subbin(mags: torch.Tensor, idx: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Sub-bin frequency by parabolic interpolation on the magnitude spectrum.

    ``mags [B, H]``, ``idx [B, k]``, ``ds [B]`` (Hz per bin).  The vertex
    offset ``0.5*(m[-1]-m[+1]) / (m[-1]-2*m[0]+m[+1])`` in bins is clamped to
    +-0.5; empty slots (idx < 0) return 0.
    """
    h = mags.shape[-1]
    safe = torch.clamp(idx.long(), 1, h - 2)
    m0 = torch.gather(mags, -1, safe - 1)
    m1 = torch.gather(mags, -1, safe)
    m2 = torch.gather(mags, -1, safe + 1)
    denom = m0 - 2.0 * m1 + m2
    delta = torch.where(denom.abs() > 1e-30, 0.5 * (m0 - m2) / denom, 0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    refined = (safe.to(mags.dtype) + delta) * ds[:, None]
    return torch.where(idx >= 0, refined, 0.0)


def _flex_detect(
    mags: torch.Tensor,
    fs_flat: torch.Tensor,
    *,
    n_fft: int,
    k: int,
    max_candidates: int | tuple[int, int, int],
) -> Any:
    """Flexible-detector stage over a flat ``[B, H]`` batch: one block of
    :func:`_flex_detect_blocks`."""
    return _flex_detect_blocks([mags], [fs_flat], n_fft=n_fft, k=k,
                               max_candidates=max_candidates)[0]


def _flex_detect_blocks(
    mags: list[torch.Tensor],
    fss: list[torch.Tensor],
    *,
    n_fft: int,
    k: int,
    max_candidates: int | tuple[int, int, int],
    gather_device: torch.device | None = None,
) -> list:
    """Flexible-detector stage over a batch held as row blocks ``mags[j]``
    ``[B_j, H]`` with rates ``fss[j]``, each on its own device (a sharded
    epoch's shards; one device's batch is one block).  Returns one result a
    block.

    ``max_candidates`` is a flat int budget or the two-tier split
    ``(m_small, m_big, s_cap)``: detect every window at ``m_small``, re-detect
    at ``m_big`` only the <= ``s_cap`` windows of the WHOLE batch whose walk
    reports ``n_required > m_small`` (gathered on ``gather_device``, by
    default the first block's, in one call), and merge each block's own
    rows.  A straggler past the capacity reports ``max(n_required, m_big +
    1)``, so the dynamic loop's exactness check fails and re-runs flat.
    """

    def flat_detect(m_b, f_b, budget: int):
        return prominence_peaks_fused(m_b, f_b, n_fft, k=k, max_candidates=budget)

    if not isinstance(max_candidates, tuple):
        return [flat_detect(m, f, max_candidates) for m, f in zip(mags, fss)]

    m_small, m_big, s_cap = max_candidates
    sizes = [m.shape[0] for m in mags]
    b = sum(sizes)
    s_eff = min(s_cap, b)
    if m_small >= m_big or b < 4 * s_eff:
        return [flat_detect(m, f, m_big) for m, f in zip(mags, fss)]

    dev0 = gather_device or mags[0].device
    r1 = [flat_detect(m, f, m_small) for m, f in zip(mags, fss)]
    need_b = [r.n_required > m_small for r in r1]
    need = torch.cat([_to_device(n, dev0) for n in need_b])
    # Stable sort: straggler indices first (ascending), clean windows after;
    # the picks re-sorted by index group each block's rows together.
    order = torch.argsort((~need).to(torch.int8), stable=True)
    sel = torch.sort(order[:s_eff]).values
    use2 = need[sel]
    # The picked rows, gathered block by block without a host sync: each
    # block gathers at every pick (its own row 0 for another block's) and
    # the block that holds the pick wins.
    members, local = [], []
    big_m = big_f = None
    lo = 0
    for m, f, size in zip(mags, fss, sizes):
        mem = (sel >= lo) & (sel < lo + size)
        loc = torch.where(mem, sel - lo, 0)
        loc_b = _to_device(loc, m.device)
        rows, rates = _to_device(m[loc_b], dev0), _to_device(f[loc_b], dev0)
        big_m = rows if big_m is None else torch.where(mem[:, None], rows, big_m)
        big_f = rates if big_f is None else torch.where(mem, rates, big_f)
        members.append(mem)
        # A pick of another block writes to a dummy row past this block's end.
        local.append(torch.where(mem, loc, size))
        lo += size
    r2 = flat_detect(big_m, big_f, m_big)

    out = []
    for r, need_j, mem, idx, size in zip(r1, need_b, members, local, sizes):
        dev = need_j.device
        idx, upd = _to_device(idx, dev), _to_device(mem & use2, dev)

        def merge(a1, a2):
            padded = torch.cat([a1, a1[:1]])
            u = upd.reshape((s_eff,) + (1,) * (a2.dim() - 1))
            padded[idx] = torch.where(u, _to_device(a2, dev), padded[idx])
            return padded[:size]

        merged = type(r)(*(merge(a1, a2) for a1, a2 in zip(r, r2)))
        selmask = torch.zeros(size + 1, dtype=torch.bool, device=dev)
        selmask[idx] = True
        overflowed = need_j & ~selmask[:size]
        n_req = torch.where(overflowed, torch.clamp(merged.n_required, min=m_big + 1),
                            merged.n_required)
        out.append(merged._replace(n_required=n_req))
    return out


def _detect_from_mags(
    mags: torch.Tensor,
    fs_flat: torch.Tensor,
    *,
    n_fft: int,
    mode: str,
    k: int,
    max_candidates: int | tuple[int, int, int],
    refine: bool,
    half_corr: torch.Tensor | None = None,
    flex: Any = None,
) -> EpochResult:
    """Detector + finalize stage on half-spectrum magnitudes ``[B, H]``.

    ``flex`` is the flexible detector's result when the caller already ran
    it (a sharded epoch's two-tier pass); else it runs here."""

    def rigid():
        return resolution_peaks(mags, fs_flat, n_fft, k=k, half_corr=half_corr)

    if flex is None and mode in ("flexible", "adaptive"):
        flex = _flex_detect(mags, fs_flat, n_fft=n_fft, k=k, max_candidates=max_candidates)
    if mode == "flexible":
        det = flex
        prom, damp, qf = det.prominence, det.damping, det.q_factor
        n_cand, n_req = det.n_candidates, det.n_required
    elif mode == "rigid":
        det = rigid()
        zeros = torch.zeros_like(det.freq)
        prom, damp, qf = zeros, zeros, zeros
        n_cand = det.n_candidates
        n_req = torch.zeros_like(n_cand)
    elif mode == "adaptive":
        # The prominence detector's damping band can reject everything on
        # very sharp or very broad spectra; those windows fall back to the
        # resolution detector, per window.
        rig = rigid()
        use_flex = (flex.count > 0)[:, None]
        zeros = torch.zeros_like(flex.freq)
        det = flex._replace(
            count=torch.where(flex.count > 0, flex.count, rig.count),
            idx=torch.where(use_flex, flex.idx, rig.idx),
            freq=torch.where(use_flex, flex.freq, rig.freq),
            mag=torch.where(use_flex, flex.mag, rig.mag),
        )
        prom = torch.where(use_flex, flex.prominence, zeros)
        damp = torch.where(use_flex, flex.damping, zeros)
        qf = torch.where(use_flex, flex.q_factor, zeros)
        n_cand, n_req = flex.n_candidates, flex.n_required
    else:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")

    if refine:
        with span("apda.refine"):
            refined = refine_subbin(mags, det.idx, div_exact(fs_flat, float(n_fft)))
    else:
        refined = torch.zeros_like(det.freq)
    return EpochResult(
        count=det.count, idx=det.idx, freq=det.freq, mag=det.mag,
        prominence=prom, damping=damp, q_factor=qf, refined_freq=refined,
        n_candidates=n_cand, n_required=n_req,
    )


def _analyze_epoch_impl(
    samples: torch.Tensor,
    fs: torch.Tensor,
    lengths: torch.Tensor | None,
    half_corr: torch.Tensor | None = None,
    *,
    n_fft: int,
    mode: str,
    k: int,
    backend: str,
    max_candidates: int | tuple[int, int, int],
    refine: bool,
    center: str = "auto",
    batch_chunk: int = 2048,
    taper: str = "none",
    precision: str = "highest",
) -> EpochResult:
    lead = samples.shape[:-1]
    flat = samples.reshape(-1, samples.shape[-1])
    fs_flat = fs.broadcast_to(lead).reshape(-1).to(flat.dtype)
    len_flat = lengths.reshape(-1) if lengths is not None else None
    corr_flat = half_corr.reshape(-1, half_corr.shape[-1]) if half_corr is not None else None
    kw = dict(n_fft=n_fft, mode=mode, k=k, backend=backend, max_candidates=max_candidates,
              refine=refine, center=center, taper=taper, precision=precision)

    b = flat.shape[0]
    if batch_chunk and b > batch_chunk:
        # Fixed-size chunks bound the working set.  The last chunk is padded
        # to full size (zero windows, fs 1, full length) like the JAX
        # package's, so every chunk sees the same two-tier capacity.
        pad = (-b) % batch_chunk
        if pad:
            flat = torch.nn.functional.pad(flat, (0, 0, 0, pad))
            fs_flat = torch.nn.functional.pad(fs_flat, (0, pad), value=1.0)
            if len_flat is not None:
                len_flat = torch.nn.functional.pad(len_flat, (0, pad), value=n_fft)
            if corr_flat is not None:
                corr_flat = torch.nn.functional.pad(corr_flat, (0, 0, 0, pad))
        parts = []
        for lo in range(0, flat.shape[0], batch_chunk):
            sl = slice(lo, lo + batch_chunk)
            parts.append(_analyze_epoch_impl(
                flat[sl], fs_flat[sl],
                len_flat[sl] if len_flat is not None else None,
                corr_flat[sl] if corr_flat is not None else None,
                batch_chunk=0, **kw,
            ))
        return EpochResult(*(
            torch.cat(xs)[:b].reshape(lead + xs[0].shape[1:]) for xs in zip(*parts)
        ))

    with span("apda.frontend"):
        mags = _epoch_spectra(flat, len_flat, n_fft=n_fft, backend=backend, center=center,
                              taper=taper, precision=precision)
    with span("apda.detect"):
        res = _detect_from_mags(mags, fs_flat, half_corr=corr_flat, **{
            key: kw[key] for key in ("n_fft", "mode", "k", "max_candidates", "refine")
        })
    return EpochResult(*(x.reshape(lead + x.shape[1:]) for x in res))


def _epoch_spectra(
    flat: torch.Tensor,
    len_flat: torch.Tensor | None,
    *,
    n_fft: int,
    backend: str,
    center: str,
    taper: str,
    precision: str,
) -> torch.Tensor:
    """The front end over flat windows ``[B, L]``: centre, pad, taper, then
    the ``[B, n_fft/2]`` magnitude spectrum."""
    if center == "auto" and len_flat is None and flat.shape[-1] == n_fft:
        # Full, unpadded windows: a constant offset only moves the DC bin,
        # which is zeroed anyway, so the median sort is skipped; the mean is
        # still removed so a large raw offset adds no float32 roundoff to
        # the other bins.
        windows = flat - div_exact(flat.sum(dim=-1, keepdim=True), float(flat.shape[-1]))
    else:
        windows = fft_ops.center_and_pad(flat, n_fft, len_flat)
    if taper != "none":
        tlen = len_flat if len_flat is not None else (
            flat.shape[-1] if flat.shape[-1] < n_fft else None
        )
        if isinstance(tlen, int):
            tlen = torch.full((), tlen, device=windows.device)
        windows = windows * fft_ops.taper_window(
            taper, windows.shape[-1], windows.dtype, tlen, device=windows.device
        )
    return fft_ops.halfspec_magnitudes(windows, backend=backend, precision=precision)


def _rigid_corr_batch(fs_host: np.ndarray, lead, n_fft: int) -> np.ndarray | None:
    """Per-window non-dyadic wipe-rounding tables ``[*lead, ceil(H/50)]``
    int8 from the ORIGINAL float64 rates, or None when every table is empty
    (the dyadic case)."""
    h = n_fft // 2
    hq = len(range(25, h, 50))
    if hq == 0:
        return None
    fs_host = np.broadcast_to(np.asarray(fs_host, np.float64), lead).reshape(-1)
    tables: dict[float, Any] = {}
    out = None
    for i, v in enumerate(fs_host):
        key = float(v)
        if key not in tables:
            tables[key] = rigid_half_corrections(key, n_fft)
        c = tables[key]
        if c is not None:
            if out is None:
                out = np.zeros((fs_host.size, hq), np.int8)
            out[i] = c
    return out.reshape(tuple(lead) + (hq,)) if out is not None else None


def detect_from_mags(
    mags,
    fs,
    *,
    n_fft: int,
    mode: str = "flexible",
    k: int | None = None,
    max_candidates: int | str | None = None,
    refine: bool = True,
    selection: str = "auto",
) -> EpochResult:
    """Detector + finalize stage on precomputed half-spectrum magnitudes
    ``[B, H]`` (``|FFT|[:, :n_fft//2]``, DC zeroed), with the same dynamic
    budget as :func:`analyze_epoch` (shared tables); an int pins a static
    budget.  A tensor runs where it lies, an array on the card.
    ``selection`` takes the JAX package's names, all one order
    (``ops.peaks_prominence.SELECTIONS``)."""
    mags = _placed(mags, None)
    if mags.dim() != 2:
        raise ValueError(f"mags must be [B, H], got shape {tuple(mags.shape)}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    check_selection(selection)
    if k is None:
        k = default_k(mode)
    fs_flat = torch.as_tensor(fs, dtype=mags.dtype, device=mags.device).broadcast_to(
        mags.shape[:1]
    )
    dynamic = (
        max_candidates in (None, "dynamic")
        and mode in ("flexible", "adaptive")
        and mags.shape[0] > 0
    )

    def run(mc):
        return _detect_from_mags(mags, fs_flat, n_fft=n_fft, mode=mode, k=k,
                                 max_candidates=mc, refine=refine)

    if not dynamic:
        if not isinstance(max_candidates, int):
            max_candidates = default_max_candidates(n_fft)
        return run(max_candidates)
    return _run_dynamic(run, n_fft=n_fft, mode=mode, n_windows=mags.shape[0])


def analyze_epoch(
    samples,
    fs,
    *,
    n_fft: int | None = None,
    mode: str = "flexible",
    k: int | None = None,
    backend: str = "matmul",
    max_candidates: int | str | None = None,
    refine: bool = False,
    lengths=None,
    dtype: torch.dtype = torch.float32,
    center: str = "auto",
    selection: str = "auto",
    batch_chunk: int = 2048,
    lowlat: str = "auto",
    taper: str = "none",
    precision: str = "highest",
    device: torch.device | str | None = None,
) -> EpochResult:
    """Analyze one epoch of sensor windows.

    Args:
      samples: ``[..., L]`` real acceleration windows (any leading batch
        shape), a tensor or array.  The epoch runs on ``device`` when given,
        else on the device of a tensor, else (an array or list) on CUDA;
        with no CUDA device an array raises ``RuntimeError`` unless
        ``device="cpu"`` is given.
      fs: sampling rate in Hz - scalar or broadcastable to the batch shape.
      n_fft: FFT length (power of two); defaults to ``next_pow2(L)``.
      mode: ``"flexible"`` (prominence detector, k=4), ``"rigid"``
        (resolution detector, k=5) or ``"adaptive"`` (prominence with
        per-window resolution fallback).
      backend: ``"matmul"`` (four-step, default), ``"xla"``
        (``torch.fft.rfft``) or ``"pallas"`` (the fused front-end kernel of
        ``ops.fft_cuda``, N a power of two >= 64; an epoch of one window
        then takes the batched path, as in the JAX package).
      max_candidates: None/``"dynamic"`` (default) sizes the flexible
        candidate budget from the data, one stacked readback per pass; an
        int pins a static budget (check ``n_candidates``).
      refine: also compute sub-bin interpolated peak frequencies.
      lengths: optional integer valid-prefix lengths (batch shape).
      dtype: compute dtype (float32; the CUDA detector kernel takes float32
        only).
      center: "auto" skips the median when it can only affect the zeroed DC
        bin (full windows take a mean detrend); "always" forces it.
      selection: the JAX package's candidate-selection names (``"auto"``,
        ``"auto_spmd"``, ``"argmax"``, ``"topk"``, ``"sort"``); the JAX
        package holds them equal, and the port runs each as its one
        order-exact selection.
      batch_chunk: epochs larger than this run in chunks of this many
        windows (0 disables).
      lowlat: ``"auto"`` routes an epoch of one full float32 window on a
        CUDA device through the single-window kernels
        (``ops.latency_cuda.analyze_window_lowlat``, one launch per pass);
        ``"never"`` always runs the batched path.  Decisions are the same.
      taper: "none" (reference rectangular window), "hann", "hamming" or
        "blackman", amplitude-normalized, applied after centering.
      precision: "highest" (IEEE float32 spectra, the 1e-6 contract) or
        "fast" (matmul backend only: TF32 products on CUDA, normwise error
        within ``ops.fft.FAST_NORMWISE_BOUND``; decisions near thresholds
        may differ; never the single-window route).

    The ``"matmul"`` front end switches PyTorch's process-wide float32
    matmul precision to IEEE (no TF32) while it runs and then restores it
    (``ops.fft.ieee_fp32_matmul``).  Float32 matmuls that other threads run
    at the same time also run in IEEE for that while; a ``"fast"`` epoch
    that overlaps a ``"highest"`` one runs in IEEE.

    Returns:
      :class:`EpochResult` with batch-shaped tensors on the epoch's device.
    """
    with span("apda.epoch"):
        fs_orig = fs  # pre-cast rate: the float64 value the rigid wipe rounding needs
        with span("apda.place"):
            samples = _placed(samples, device, dtype)
            dev = samples.device
            if samples.dim() < 2:
                samples = samples[None, :]
            lead = samples.shape[:-1]
            fs = _fs_tensor(fs, dtype, dev)
            if lengths is not None:
                if not isinstance(lengths, torch.Tensor):
                    lengths = _from_host(np.asarray(lengths), dev)
                lengths = lengths.to(device=dev, dtype=torch.int32).broadcast_to(lead)
        if n_fft is None:
            n_fft = fft_ops.next_pow2(samples.shape[-1])
        if k is None:
            k = default_k(mode)

        if lowlat not in ("auto", "never"):
            raise ValueError(f"unknown lowlat {lowlat!r}; expected 'auto' or 'never'")
        empty = any(d == 0 for d in lead)
        dynamic, max_candidates = _check_options(
            n_fft=n_fft, mode=mode, max_candidates=max_candidates, center=center,
            selection=selection, taper=taper, backend=backend, precision=precision, empty=empty,
        )

        # Non-dyadic sampling rates: the rigid wipe rounding at exact-half
        # boundaries follows the float64 reference via a host-computed table
        # (None for the dyadic rates).
        half_corr = None
        if mode in ("rigid", "adaptive") and not empty:
            table = _rigid_corr_batch(_host_rates(fs_orig), lead, n_fft)
            if table is not None:
                with span("apda.place"):
                    half_corr = _from_host(table, dev)

        # One full window on a CUDA device: the single-window kernels, inside
        # the envelope the JAX package routes.
        if (
            lowlat == "auto"
            and mode in ("flexible", "rigid")
            and half_corr is None  # non-dyadic rigid boundaries need the table
            and precision == "highest"
            and backend == "matmul"
            and center == "auto"
            and selection == "auto"
            and taper == "none"
            and lengths is None
            and dtype == torch.float32
            and samples.shape[-1] == n_fft
            and n_fft >= 64
            and all(d == 1 for d in lead)
            and _lowlat_device(samples)
        ):
            with span("apda.route"):
                res = _analyze_lowlat(samples, fs, n_fft=n_fft, mode=mode, k=k, refine=refine,
                                      dynamic=dynamic, max_candidates=max_candidates)
            if res is not None:
                return res

        kwargs = dict(n_fft=n_fft, k=k, backend=backend, refine=refine, center=center,
                      batch_chunk=batch_chunk, taper=taper, precision=precision)

        def run(run_mode: str, mc) -> EpochResult:
            with span("apda.pass"):
                return _analyze_epoch_impl(samples, fs, lengths, half_corr, mode=run_mode,
                                           max_candidates=mc, **kwargs)

        def prominence_pass() -> EpochResult:
            # Adaptive mode's prominence pass is a flexible epoch of its own, so
            # one full window takes the single-window route here too.
            return analyze_epoch(
                samples, fs, n_fft=n_fft, mode="flexible", k=k, backend=backend,
                max_candidates=max_candidates, refine=refine, lengths=lengths,
                dtype=dtype, center=center, batch_chunk=batch_chunk, lowlat=lowlat,
                taper=taper, precision=precision,
            )

        n_windows = 1
        for d in lead:
            n_windows *= d
        with span("apda.batched"):
            return _run_modes(run, mode=mode, dynamic=dynamic, max_candidates=max_candidates,
                              n_fft=n_fft, n_windows=n_windows, prominence_pass=prominence_pass)


def _check_options(*, n_fft: int, mode: str, max_candidates, center: str, selection: str,
                   taper: str, backend: str, precision: str, empty: bool):
    """Validate an epoch's options; returns ``(dynamic, max_candidates)``:
    whether the dynamic budget runs, and the static budget when not."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if max_candidates not in (None, "dynamic") and not isinstance(max_candidates, int):
        raise ValueError(
            f"max_candidates must be an int, None or 'dynamic', got {max_candidates!r}"
        )
    if center not in ("auto", "always"):
        raise ValueError(f"unknown center {center!r}; expected 'auto' or 'always'")
    check_selection(selection)
    if taper not in fft_ops.TAPERS:
        raise ValueError(f"unknown taper {taper!r}; expected one of {fft_ops.TAPERS}")
    if backend not in fft_ops.BACKENDS:
        raise ValueError(f"unknown FFT backend {backend!r}; expected one of {fft_ops.BACKENDS}")
    if precision not in fft_ops.PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {fft_ops.PRECISIONS}"
        )
    if precision == "fast" and backend != "matmul":
        raise ValueError(
            'precision="fast" applies to the matmul backend only '
            f"(got backend={backend!r})"
        )
    dynamic = (
        max_candidates in (None, "dynamic")
        and mode in ("flexible", "adaptive")
        and not empty
    )
    if not dynamic and not isinstance(max_candidates, int):
        max_candidates = default_max_candidates(n_fft)
    return dynamic, max_candidates


def _host_rates(fs) -> np.ndarray:
    """The rates ``fs`` as host float64, the precision the rigid wipe table needs."""
    if isinstance(fs, torch.Tensor):
        return fs.detach().cpu().double().numpy()
    return np.asarray(fs, np.float64)


def _merge_adaptive(flex: EpochResult, rig: EpochResult) -> EpochResult:
    """Adaptive mode's merge: the prominence pass where it found a peak, the
    resolution pass's decisions where it found none."""
    use = flex.count > 0
    usek = use[..., None]
    return EpochResult(
        count=torch.where(use, flex.count, rig.count),
        idx=torch.where(usek, flex.idx, rig.idx),
        freq=torch.where(usek, flex.freq, rig.freq),
        mag=torch.where(usek, flex.mag, rig.mag),
        prominence=torch.where(usek, flex.prominence, 0.0),
        damping=torch.where(usek, flex.damping, 0.0),
        q_factor=torch.where(usek, flex.q_factor, 0.0),
        refined_freq=torch.where(usek, flex.refined_freq, rig.refined_freq),
        n_candidates=flex.n_candidates,
        n_required=flex.n_required,
    )


def _run_modes(run, *, mode: str, dynamic: bool, max_candidates, n_fft: int,
               n_windows: int, prominence_pass=None) -> EpochResult:
    """An epoch under its budget: ``run(mode, mc)`` is one pass over the
    whole epoch at budget ``mc``.

    A static budget runs once.  The dynamic budget runs the host loop of
    :func:`_run_dynamic`.  Adaptive mode runs the prominence pass alone
    under the dynamic budget (``prominence_pass()`` when given, else
    ``run("flexible", ...)`` in the loop) and pays for the resolution
    fallback only when some window came back empty.
    """
    if not dynamic:
        return run(mode, max_candidates)
    if mode != "adaptive":
        return _run_dynamic(lambda mc: run(mode, mc), n_fft=n_fft, mode=mode,
                            n_windows=n_windows)
    if prominence_pass is None:
        flex = _run_dynamic(lambda mc: run("flexible", mc), n_fft=n_fft, mode="flexible",
                            n_windows=n_windows)
    else:
        flex = prominence_pass()
    if not bool((flex.count == 0).any()):
        return flex
    return _merge_adaptive(flex, run("rigid", _DYNAMIC_FLOOR))


def _analyze_lowlat(samples, fs, *, n_fft: int, mode: str, k: int, refine: bool,
                    dynamic: bool, max_candidates) -> EpochResult | None:
    """The single-window route: one kernel launch per pass, or None when
    the window belongs to the batched path.

    Windows longer than the kernel's ``LOWLAT_MAX_N`` take the batched
    path.  Rigid runs once.  Flexible shares the batched path's sticky budget
    table and overflow re-run, capped at ``LOWLAT_MAX_BUDGET``: a sticky
    budget already past the cap skips the kernel, and a window that needs
    more than the cap is handed to the batched path.
    """
    from apda_fft_tpu_torch.ops import latency_cuda

    if n_fft > latency_cuda.LOWLAT_MAX_N:
        return None
    lead = samples.shape[:-1]
    flat = samples.reshape(-1)
    fs_scalar = fs.broadcast_to(lead).reshape(())

    def run(budget: int) -> EpochResult:
        with span("apda.route.pass"):
            return latency_cuda.analyze_window_lowlat(
                flat, fs_scalar, n_fft=n_fft, mode=mode, k=k, max_candidates=budget,
                refine=refine,
            )

    cap = LOWLAT_MAX_BUDGET
    key = (n_fft, mode)
    res = None
    if mode == "rigid":
        res = run(_DYNAMIC_FLOOR)  # budget unused by rigid
    elif dynamic and _dynamic_budget.get(key, 0) <= cap:
        budget = min(_dynamic_budget.get(key, _DYNAMIC_FLOOR), cap)
        passes = 0
        while True:
            passes += 1
            res = run(budget)
            # One readback per pass: both are [1], so this is their max.
            with span("apda.route.readback"):
                n_req, n_max = torch.cat([res.n_required, res.n_candidates]).tolist()
            if n_req <= budget:
                break
            if n_req > cap:
                return None  # the batched path re-runs it
            budget = min(
                max(_pow2_at_least(n_req), _dynamic_budget_hwm.get(key, 0), _DYNAMIC_FLOOR),
                cap,
            )
        _dynamic_budget[key] = min(max(_pow2_at_least(n_req), _DYNAMIC_FLOOR), n_fft // 2)
        _dynamic_budget_hwm[key] = max(_dynamic_budget_hwm.get(key, 0), budget)
        stats = last_dynamic_stats()
        stats.clear()
        stats.update(
            candidate_budget=budget, n_candidates_max=n_max,
            n_required_max=n_req, budget_passes=passes,
        )
    elif isinstance(max_candidates, int) and max_candidates <= cap:
        res = run(max_candidates)
    if res is None:
        return None
    return EpochResult(*(x.reshape(lead + x.shape[1:]) for x in res))


def _run_dynamic(run_pass, *, n_fft: int, mode: str, n_windows: int) -> EpochResult:
    """The dynamic-budget host loop around one epoch pass.

    ``run_pass(mc)`` runs the epoch at budget ``mc`` (a flat int or the
    two-tier tuple) and returns an :class:`EpochResult` whose ``n_required``
    reports past the budget whenever a window's decisions are not
    reference-exact.  One stacked readback per pass carries the maxima and
    the per-grid straggler counts that the split is learned from.
    """
    h = n_fft // 2
    key = (n_fft, mode)
    budget = min(_dynamic_budget.get(key, _DYNAMIC_FLOOR), max(h, 1))
    s_cap = _tier_capacity(n_windows)
    tier = _dynamic_tier.get(key)
    passes = 0
    while True:
        passes += 1
        mc = _effective_mc(budget, h, n_windows, tier)
        res = run_pass(mc)
        nr = res.n_required.reshape(-1)
        grid = torch.tensor(_TIER_GRID, dtype=nr.dtype, device=nr.device)
        with span("apda.readback"):
            scalars = torch.cat([
                torch.stack([nr.max(), res.n_candidates.max()]).long(),
                (nr[:, None] > grid).sum(dim=0),
            ]).tolist()
        n_req, n_max = scalars[0], scalars[1]
        grid_counts = scalars[2:]
        if n_req <= budget or budget >= h:
            break
        # Any failure (budget too small, or tier capacity overflowed) falls
        # back to a flat re-run at the grown budget; the tier is re-learned
        # from the exact epoch's counts afterwards.
        tier = None
        budget = min(
            max(_pow2_at_least(n_req), _dynamic_budget_hwm.get(key, 0), _DYNAMIC_FLOOR), h
        )
    _dynamic_budget[key] = min(max(_pow2_at_least(n_req), _DYNAMIC_FLOOR), h)
    _dynamic_budget_hwm[key] = max(_dynamic_budget_hwm.get(key, 0), budget)
    # Learn the split: the smallest grid budget that leaves at most half the
    # straggler capacity needing the big pass, provided it halves the budget.
    new_tier = None
    if n_windows >= 4 * s_cap:
        for g, c in zip(_TIER_GRID, grid_counts):
            if g * 2 <= _dynamic_budget[key] and c <= s_cap // 2:
                new_tier = (g, s_cap)
                break
    if new_tier is None:
        _dynamic_tier.pop(key, None)
    else:
        _dynamic_tier[key] = new_tier
    stats = last_dynamic_stats()
    stats.clear()
    stats.update(
        candidate_budget=budget, n_candidates_max=n_max,
        n_required_max=n_req, budget_passes=passes,
        tier=(mc if isinstance(mc, tuple) else None),
    )
    return res


@dataclasses.dataclass
class PipelineConfig:
    """Static configuration for a :class:`SpectralPipeline`."""

    mode: str = "flexible"
    k: int | None = None
    backend: str = "matmul"
    max_candidates: int | str | None = None  # None = dynamic (data-sized) budget
    refine: bool = False
    dtype: Any = torch.float32
    center: str = "auto"
    #: None = "auto"; the JAX package's selection names are all one order.
    selection: str | None = None
    #: "auto" (one full window on a CUDA device takes the latency kernels)
    #: or "never".
    lowlat: str = "auto"
    taper: str = "none"
    precision: str = "highest"
    #: Where an array epoch runs (as ``analyze_epoch``'s ``device``): None
    #: is the card; a tensor's epoch runs on its device.
    device: Any = None

    @classmethod
    def from_gateway_flag(cls, is_flexibile_structure: bool, **kw) -> "PipelineConfig":
        """Map the reference's (typo'd, load-bearing) config flag
        ``is_flexibile_structure`` to a mode."""
        return cls(mode="flexible" if is_flexibile_structure else "rigid", **kw)


class SpectralPipeline:
    """Stateful wrapper: epoch analysis plus per-call process/wall/RSS metrics.

    With a ``mesh`` (:class:`apda_fft_tpu_torch.parallel.mesh.Mesh`) every
    epoch runs data-parallel through
    :func:`~apda_fft_tpu_torch.parallel.mesh.analyze_epoch_sharded`; the
    config's ``device`` and ``lowlat`` then do not apply (the mesh names the
    devices, and no shard takes the single-window route).
    """

    def __init__(self, config: PipelineConfig | None = None, mesh=None):
        from apda_fft_tpu_torch.utils.profiling import EpochMetrics

        self.config = config or PipelineConfig()
        self.mesh = mesh
        self._metrics = EpochMetrics()
        self.last_metrics: dict[str, float] = {}

    def __call__(self, samples, fs, *, n_fft: int | None = None, lengths=None) -> EpochResult:
        cfg = self.config
        last_dynamic_stats().clear()  # don't inherit a previous call's stats
        with self._metrics.measure():
            if self.mesh is not None:
                from apda_fft_tpu_torch.parallel.mesh import analyze_epoch_sharded

                result = analyze_epoch_sharded(
                    samples, fs, mesh=self.mesh, lengths=lengths, n_fft=n_fft,
                    mode=cfg.mode, k=cfg.k, backend=cfg.backend,
                    max_candidates=cfg.max_candidates, refine=cfg.refine, dtype=cfg.dtype,
                    center=cfg.center, selection=cfg.selection or "auto", taper=cfg.taper,
                    precision=cfg.precision,
                )
            else:
                result = analyze_epoch(
                    samples, fs, n_fft=n_fft, mode=cfg.mode, k=cfg.k, backend=cfg.backend,
                    max_candidates=cfg.max_candidates, refine=cfg.refine, lengths=lengths,
                    dtype=cfg.dtype, center=cfg.center, selection=cfg.selection or "auto",
                    lowlat=cfg.lowlat, taper=cfg.taper, precision=cfg.precision,
                    device=cfg.device,
                )
        self.last_metrics = {**self._metrics.last, **last_dynamic_stats()}
        return result

    def welch(self, samples, fs, *, window: int, hop: int | None = None,
              taper: str = "hann") -> EpochResult:
        """Welch-averaged analysis under this pipeline's config and metrics.

        The ``analyze`` hook of
        :func:`~apda_fft_tpu_torch.models.batching.analyze_records_welch`:
        mode, k, refine, backend, dtype and device come from the config, and
        ``last_metrics`` is filled as by ``__call__``.  Only an int
        ``max_candidates`` carries over; otherwise Welch takes its static
        default (it has no overflow readback).
        """
        from apda_fft_tpu_torch.models.streaming import analyze_welch

        cfg = self.config
        last_dynamic_stats().clear()
        with self._metrics.measure():
            result = analyze_welch(
                samples, fs, window=window, hop=hop, taper=taper, mode=cfg.mode, k=cfg.k,
                backend=cfg.backend, refine=cfg.refine, dtype=cfg.dtype,
                selection=cfg.selection or "auto", precision=cfg.precision,
                max_candidates=(cfg.max_candidates if isinstance(cfg.max_candidates, int)
                                else None),
                device=cfg.device,
            )
        self.last_metrics = {**self._metrics.last, **last_dynamic_stats()}
        return result
