"""Batched order statistics and moments with reference-stdlib semantics.

Counterpart of ``apda_fft_tpu/ops/stats.py``: ``statistics.median`` (sort,
average the two middle elements for even counts) and ``statistics.mean`` +
``statistics.stdev`` (ddof=1) for the detectors' noise threshold, over the
last axis of a tensor.
"""

from __future__ import annotations

import torch


def div_exact(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a correctly rounded IEEE division.

    PyTorch's CUDA kernels turn a division by a Python scalar into a
    multiplication by its reciprocal, which can land one ulp away from the
    reference's division; a 0-dim tensor on ``x``'s device keeps the true
    division on every device.
    """
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _float_order(x: torch.Tensor) -> torch.Tensor:
    """Monotone map of float32 to int64 in [0, 2**32): ``u(a) < u(b)`` iff
    ``a < b`` for finite inputs (the JAX package's uint32 order key; torch
    has no full uint32 arithmetic, so the key lives in int64)."""
    b = x.view(torch.int32).to(torch.int64)
    return torch.where(b < 0, ~b, b + (1 << 31))


def _from_float_order(u: torch.Tensor) -> torch.Tensor:
    b = torch.where(u >= (1 << 31), u - (1 << 31), ~u)
    return b.to(torch.int32).view(torch.float32)


def _radix_kth_smallest(u: torch.Tensor, valid: torch.Tensor, k0: torch.Tensor) -> torch.Tensor:
    """Exact 0-indexed ``k0``-th smallest of each row's valid entries of the
    order keys ``u [B, N]``, by 32 masked count passes (no sort)."""
    prefix = torch.zeros(u.shape[:-1], dtype=torch.int64, device=u.device)
    for i in range(32):
        cand = prefix | (1 << (31 - i))
        cnt = (valid & (u < cand[:, None])).sum(dim=-1)
        prefix = torch.where(cnt <= k0, cand, prefix)
    return prefix


def _median_select_f32(x: torch.Tensor, length: torch.Tensor | None) -> torch.Tensor:
    """:func:`median_lastaxis` by radix selection: the same values as the
    sort for finite float32 rows, in 32 count passes over each row."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    u = _float_order(x.reshape(-1, n))
    if length is None:
        valid = torch.ones(u.shape, dtype=torch.bool, device=x.device)
        cnt = torch.full(u.shape[:1], n, dtype=torch.int64, device=x.device)
    else:
        cnt = torch.as_tensor(length, device=x.device).broadcast_to(lead).reshape(-1).long()
        valid = torch.arange(n, device=x.device) < cnt[:, None]
        u = torch.where(valid, u, (1 << 32) - 1)
    lo = _from_float_order(_radix_kth_smallest(u, valid, (cnt - 1) // 2))
    hi = _from_float_order(_radix_kth_smallest(u, valid, cnt // 2))
    return ((lo + hi) * torch.full((), 0.5, dtype=x.dtype, device=x.device)).reshape(lead)


def median_lastaxis(
    x: torch.Tensor,
    length: torch.Tensor | None = None,
    method: str = "auto",
) -> torch.Tensor:
    """Median over the last axis, optionally masked to a per-row valid prefix.

    Matches ``statistics.median``: for even counts, the mean of the two
    middle order statistics (``torch.median`` returns the lower one, so it is
    not used).  ``length`` (integer tensor broadcastable to ``x.shape[:-1]``)
    restricts each row to its first ``length`` entries.

    ``method``: ``"auto"``/``"sort"`` (a sort, the path every caller takes)
    or ``"select"`` (radix order-statistic selection by 32 masked count
    passes, float32 only), an independent implementation kept as a
    cross-check of the sort, as in the JAX package.
    """
    n = x.shape[-1]
    if method not in ("auto", "sort", "select"):
        raise ValueError(f"unknown method {method!r}")
    if method == "select":
        if x.dtype != torch.float32:
            raise ValueError("method='select' supports float32 only")
        return _median_select_f32(x, length)
    half = torch.full((), 0.5, dtype=x.dtype, device=x.device)
    if length is None:
        s = torch.sort(x, dim=-1).values
        return (s[..., (n - 1) // 2] + s[..., n // 2]) * half
    length = torch.as_tensor(length, device=x.device).broadcast_to(x.shape[:-1])
    big = torch.finfo(x.dtype).max
    idx = torch.arange(n, device=x.device)
    s = torch.sort(torch.where(idx < length[..., None], x, big), dim=-1).values
    lo = torch.gather(s, -1, ((length - 1) // 2)[..., None].long())[..., 0]
    hi = torch.gather(s, -1, (length // 2)[..., None].long())[..., 0]
    return (lo + hi) * half


def mean_std_ddof1(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and sample standard deviation (ddof=1) over the last axis."""
    n = x.shape[-1]
    mean = div_exact(x.sum(dim=-1, keepdim=True), float(n))
    var = div_exact(((x - mean) ** 2).sum(dim=-1), float(n - 1))
    return mean[..., 0], torch.sqrt(var)


def noise_threshold(mags: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``mean + 2*stdev`` dynamic threshold over the last axis; returns (threshold, std)."""
    mean, std = mean_std_ddof1(mags)
    return mean + 2.0 * std, std


#: The select+scan kernel's summation order (``csrc/detector_common.cuh``):
#: lanes a block (or cluster CTA), rows kept in one block's shared memory,
#: and CTAs of the cluster that takes a longer row.
THRESHOLD_LANES = 128
THRESHOLD_SHARED_MAX_H = 57856
THRESHOLD_CLUSTER = 8


def threshold_segment(h: int) -> int:
    """Bins of each cluster CTA's segment of a row of ``h`` bins past
    :data:`THRESHOLD_SHARED_MAX_H`: ``h`` split into
    :data:`THRESHOLD_CLUSTER` contiguous segments of a whole number of lane
    strides (the last one shorter), a function of ``h`` alone."""
    stride = THRESHOLD_CLUSTER * THRESHOLD_LANES
    return (h + stride - 1) // stride * THRESHOLD_LANES


def _lane_sums(terms: torch.Tensor, compensated: bool) -> torch.Tensor:
    """``terms [..., K, 128]`` -> per-lane sums ``[..., 128]``, each lane
    adding its K terms in increasing index (Kahan-compensated when asked),
    one rounded elementwise operation at a time."""
    s = torch.zeros_like(terms[..., 0, :])
    c = torch.zeros_like(s)
    for k in range(terms.shape[-2]):
        if compensated:
            y = terms[..., k, :] - c
            t = s + y
            c = (t - s) - y
            s = t
        else:
            s = s + terms[..., k, :]
    return s


def _lane_tree(s: torch.Tensor) -> torch.Tensor:
    """The block reduction (``detector_common.cuh`` ``block_reduce``) of the
    lane sums ``[..., lanes]`` of a block of ``lanes`` threads (128 in the
    select+scan kernel's order): an xor butterfly within each warp of 32
    lanes, then the warp sums in order."""
    lanes = torch.arange(s.shape[-1], device=s.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lanes ^ o]
    total = s[..., 0]
    for w in range(1, s.shape[-1] // 32):
        total = total + s[..., 32 * w]
    return total


def _ordered_sum(terms: torch.Tensor, h: int) -> torch.Tensor:
    """Sum over the last axis (``h`` terms, zero-padded to whole lane
    strides) in the kernel's order, see :func:`ordered_mean_std`."""
    lead = terms.shape[:-1]
    if h <= THRESHOLD_SHARED_MAX_H:
        lanes = terms.reshape(*lead, terms.shape[-1] // THRESHOLD_LANES, THRESHOLD_LANES)
        return _lane_tree(_lane_sums(lanes, compensated=False))
    seg = threshold_segment(h)
    lanes = terms.reshape(*lead, THRESHOLD_CLUSTER, seg // THRESHOLD_LANES, THRESHOLD_LANES)
    part = _lane_tree(_lane_sums(lanes, compensated=True))
    total = part[..., 0]
    for r in range(1, THRESHOLD_CLUSTER):
        total = total + part[..., r]
    return total


def ordered_mean_std(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and sample standard deviation (ddof=1) over the last axis, each
    sum taken in the one order of the select+scan kernel, so that its
    results are the kernel's bits:

    * ``h <= THRESHOLD_SHARED_MAX_H``: 128 lanes, lane ``l`` adding
      ``x[l], x[l+128], ...`` with plain rounded adds, then the lane tree
      (:func:`_lane_tree`);
    * longer rows: :data:`THRESHOLD_CLUSTER` segments of
      :func:`threshold_segment` bins, each summed like a short row but with
      Kahan-compensated lanes over whole lane strides (the last segment's
      missing bins are zero terms), then the segments' partials in order.

    The squared deviations about the rounded mean are summed the same way.
    One rounded operation at a time on any device: ``H/128`` elementwise
    adds of ``[..., 128]`` a pass.
    """
    h = x.shape[-1]
    seg = threshold_segment(h) if h > THRESHOLD_SHARED_MAX_H else THRESHOLD_LANES
    span = THRESHOLD_CLUSTER * seg if h > THRESHOLD_SHARED_MAX_H else -(-h // seg) * seg
    padded = torch.nn.functional.pad(x, (0, span - h))
    mean = div_exact(_ordered_sum(padded, h), float(h))
    d = padded - mean[..., None]
    sq = torch.where(torch.arange(span, device=x.device) < h, d * d, 0.0)
    var = div_exact(_ordered_sum(sq, h), float(h - 1))
    return mean, torch.sqrt(var)


def ordered_noise_threshold(mags: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`noise_threshold` with the sums of :func:`ordered_mean_std`,
    the select+scan kernel's threshold bit for bit; returns (threshold, std)."""
    mean, std = ordered_mean_std(mags)
    return mean + 2.0 * std, std
