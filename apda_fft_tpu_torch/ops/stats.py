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


def median_lastaxis(x: torch.Tensor, length: torch.Tensor | None = None) -> torch.Tensor:
    """Median over the last axis, optionally masked to a per-row valid prefix.

    Matches ``statistics.median``: for even counts, the mean of the two
    middle order statistics (``torch.median`` returns the lower one, so it is
    not used).  ``length`` (integer tensor broadcastable to ``x.shape[:-1]``)
    restricts each row to its first ``length`` entries.
    """
    n = x.shape[-1]
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
