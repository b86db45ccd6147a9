"""Result containers for epoch analysis - named tuples of fixed-shape tensors."""

from __future__ import annotations

from typing import NamedTuple

import torch


class EpochResult(NamedTuple):
    """Per-window top-k peak results for one acquisition epoch.

    All tensors share the leading window-batch shape and ``[..., k]`` peak
    slots; ``count`` says how many slots are valid per window.  Unused slots
    hold ``idx = -1`` and zeros elsewhere.  Field for field the counterpart
    of ``apda_fft_tpu.models.results.EpochResult``.
    """

    count: torch.Tensor  # [...] int32
    idx: torch.Tensor  # [..., k] int32 bin index, -1 = empty
    freq: torch.Tensor  # [..., k] Hz (rounded to 4 decimals in flexible mode)
    mag: torch.Tensor  # [..., k] (rounded to 4 decimals in flexible mode)
    prominence: torch.Tensor  # [..., k] (flexible mode; zeros in rigid mode)
    damping: torch.Tensor  # [..., k] percent (flexible mode; zeros in rigid)
    q_factor: torch.Tensor  # [..., k] (flexible mode; zeros in rigid)
    refined_freq: torch.Tensor  # [..., k] Hz, sub-bin interpolated (zeros if off)
    n_candidates: torch.Tensor  # [...] int32: threshold-crossing local maxima
    #: per window, before the flexible detector's max_candidates budget.
    n_required: torch.Tensor  # [...] int32: smallest flexible candidate budget
    #: that reproduces this window's decisions exactly (zeros in rigid mode).

    @property
    def k(self) -> int:
        return self.idx.shape[-1]

    def top_peak_freq(self) -> torch.Tensor:
        """First-slot frequency per window, -1 where no peak (``peak_freq`` parity)."""
        return torch.where(self.count > 0, self.freq[..., 0], -1.0)

    def top_peak_mag(self) -> torch.Tensor:
        return torch.where(self.count > 0, self.mag[..., 0], -1.0)
