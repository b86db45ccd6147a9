"""The port's one policy for placing host data on a device: the card by
default, ``non_blocking`` copies, pinned past :data:`PAGEABLE_MAX_BYTES`,
one cached 0-dim tensor per scalar rate."""

from __future__ import annotations

import functools

import numpy as np
import torch


def placed(x, device: torch.device | str | None, dtype: torch.dtype | None = None):
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
    return from_host(np.asarray(x), device, dtype)


#: Host arrays up to this many bytes are copied to the card from pageable
#: memory; larger ones go through pinned memory.  On the H100 a pageable
#: ``non_blocking`` copy of up to 1 MiB was the faster one and did not wait
#: for queued card work, while one of 4 MiB waited for it (``chip_smoke.py``
#: phase 18 times both ways across sizes).
PAGEABLE_MAX_BYTES = 1 << 20


def from_host(a: np.ndarray, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The host array ``a`` as a tensor on ``device``, cast on the host.

    A copy to the card is queued with ``non_blocking`` (a blocking copy
    would wait for all work queued before it), so a caller can queue the
    next epoch while the card runs this one.
    """
    t = torch.as_tensor(a, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    if t.nbytes > PAGEABLE_MAX_BYTES:
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``, waiting for the card only where the host reads
    the copy: host memory to the card through :func:`from_host`, card to
    card by a ``non_blocking`` copy, and anything to the host by a blocking
    one.  No copy at all when ``t`` lies on ``device`` already."""
    if t.device.type == "cpu" and device.type == "cuda":
        return from_host(t.contiguous().numpy(), device)
    return t.to(device, non_blocking=device.type == "cuda")


def fs_tensor(fs, dtype: torch.dtype, device) -> torch.Tensor:
    """Sampling rate(s) ``fs`` as a ``dtype`` tensor on ``device``; a scalar
    is filled there, so placing it does not wait for the card either, once
    per value (:func:`_rate_scalar`).  Callers never write to the result."""
    if isinstance(fs, torch.Tensor):
        return fs.detach().to(device=device, dtype=dtype)
    a = np.asarray(fs)
    if a.ndim == 0:
        v = float(a)
        if v:  # 0.0 and -0.0 would share a cache entry
            return _rate_scalar(v, dtype, device)
        return torch.full((), v, dtype=dtype, device=device)
    return from_host(a, device, dtype)


@functools.lru_cache(maxsize=64)
def _rate_scalar(value: float, dtype: torch.dtype, device) -> torch.Tensor:
    """The 0-dim ``dtype`` tensor ``value`` on ``device``, shared by every
    call with the same arguments; filled on the stream current at its first
    use (the port queues its work on one stream)."""
    return torch.full((), value, dtype=dtype, device=device)
