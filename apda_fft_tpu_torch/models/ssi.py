"""Covariance-driven Stochastic Subspace Identification (SSI-COV).

Counterpart of ``apda_fft_tpu/models/ssi.py``, the time-domain companion
of :mod:`apda_fft_tpu_torch.models.modal` (FDD): a discrete stochastic
state-space model fitted to the output correlation sequence gives
eigenfrequencies free of FFT bin quantization, damping ratios from pole
locations, complex mode shapes and a stabilization diagram.

The split of the work is the JAX package's:

* the data-heavy part, the output correlation blocks ``R_l = E[y_{t+l}
  y_t^T]`` over ``L = 2i`` lags, runs on the device: one ``[S, T0] @ [T0,
  S]`` product a lag in IEEE float32 (``ops.fft.ieee_fp32_matmul``), the
  only O(T) stage (:func:`correlation_blocks`);
* the small dense linear algebra - SVD of the ``[i*S, i*S]`` block Hankel,
  per-order shift-invariance least squares and ``[n, n]`` non-symmetric
  eigendecompositions - and the stabilization run on the host in float64
  numpy, re-stated from the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from apda_fft_tpu_torch.models.modal import modal_assurance
from apda_fft_tpu_torch.models.pipeline import _placed
from apda_fft_tpu_torch.ops.fft import ieee_fp32_matmul
from apda_fft_tpu_torch.ops.stats import div_exact

__all__ = [
    "SSIMode",
    "SSIResult",
    "correlation_blocks",
    "modal_phase_collinearity",
    "ssi",
]


class SSIMode(NamedTuple):
    """One identified structural mode (a stabilized pole cluster)."""

    freq: float  #: eigenfrequency, Hz (cluster median)
    damping: float  #: damping ratio, percent of critical (cluster median)
    shape: np.ndarray  #: complex [S] mode shape, unit-norm, phase-fixed
    order: int  #: model order the reported shape was taken from
    n_orders: int  #: number of distinct orders the pole stabilized across
    freq_std: float  #: cluster spread, Hz
    damping_std: float  #: cluster spread, percent
    mpc: float  #: modal phase collinearity in [0, 1] (1 = physically real)


def modal_phase_collinearity(shape) -> float:
    """Modal phase collinearity (MPC) of a complex mode shape, in [0, 1]:
    ``((Sxx - Syy)^2 + 4 Sxy^2) / (Sxx + Syy)^2`` from the second moments of
    its real and imaginary parts (Pappa/Elliott/Schenk 1993)."""
    phi = np.asarray(shape, np.complex128).ravel()
    re, im = phi.real, phi.imag
    sxx = float(re @ re)
    syy = float(im @ im)
    sxy = float(re @ im)
    den = (sxx + syy) ** 2
    if den <= 0:
        return 0.0
    return ((sxx - syy) ** 2 + 4.0 * sxy * sxy) / den


class SSIResult(NamedTuple):
    """SSI-COV identification result: modes + the stabilization diagram.

    ``diagram`` holds one dict per model order with keys ``order``,
    ``freq``, ``damping`` and ``stable``; ``hankel_sv`` is the singular-value
    spectrum of the block-Hankel matrix.
    """

    modes: list  #: list[SSIMode], sorted by frequency
    diagram: list  #: list[dict], one per model order (ascending)
    orders: np.ndarray  #: [n_orders] int - model orders evaluated
    hankel_sv: np.ndarray  #: [i*S] float64 - Hankel singular values
    n_sensors: int  #: S - channel count of the input records

    @property
    def count(self) -> int:
        return len(self.modes)

    def freqs(self) -> np.ndarray:
        return np.asarray([m.freq for m in self.modes], np.float64)

    def dampings(self) -> np.ndarray:
        return np.asarray([m.damping for m in self.modes], np.float64)

    def shapes(self) -> np.ndarray:
        """Complex [count, S] mode-shape matrix (shape [0, S] when empty)."""
        if not self.modes:
            return np.zeros((0, self.n_sensors), np.complex128)
        return np.stack([m.shape for m in self.modes])


def _correlation_impl(records: torch.Tensor, *, n_lags: int, detrend: str) -> torch.Tensor:
    """``[n_lags, S, S]``: one ``[S, T0] @ [T0, S]`` product a lag, scaled by
    ``1/T0`` (a float32 constant, as in the JAX package)."""
    t0 = records.shape[-1] - n_lags + 1
    if detrend == "mean":
        records = records - div_exact(records.sum(dim=-1, keepdim=True),
                                      float(records.shape[-1]))
    y0t = records[:, :t0].T
    inv = torch.full((), 1.0 / t0, dtype=records.dtype, device=records.device)
    with ieee_fp32_matmul():
        r = torch.stack([torch.matmul(records[:, lag : lag + t0], y0t)
                         for lag in range(n_lags)])
    return r * inv


def correlation_blocks(records, n_lags: int, *, detrend: str = "mean",
                       dtype: torch.dtype = torch.float32,
                       device: torch.device | str | None = None) -> np.ndarray:
    """Output correlation blocks ``R[l] = E[y_{t+l} y_t^T]``, ``[L, S, S]``.

    ``records`` is ``[S, T]``.  Every lag is estimated over the same window
    of ``T0 = T - L + 1`` products, normalized by ``1/T0``, with per-channel
    mean removal by default (``detrend="none"`` to skip).  Returns host
    float64.
    """
    records = _placed(records, device, dtype)
    if records.dim() != 2:
        raise ValueError(f"records must be [S, T], got shape {tuple(records.shape)}")
    s, t = records.shape
    if s < 1:
        raise ValueError("need at least one sensor channel")
    if n_lags < 2:
        raise ValueError(f"n_lags must be >= 2, got {n_lags}")
    if t < 4 * n_lags:
        raise ValueError(
            f"record too short: T={t} < 4*n_lags={4 * n_lags} "
            "(correlation estimates would be meaningless)"
        )
    if detrend not in ("mean", "none"):
        raise ValueError(f"unknown detrend {detrend!r}; expected 'mean' or 'none'")
    r = _correlation_impl(records, n_lags=n_lags, detrend=detrend)
    return r.cpu().numpy().astype(np.float64)


def _block_hankel(r: np.ndarray, i: int) -> np.ndarray:
    """``[i*S, i*S]`` block-Hankel of correlations, ``H[p, q] = R[1+p+q]``."""
    s = r.shape[-1]
    h = np.empty((i * s, i * s), np.float64)
    for p in range(i):
        for q in range(i):
            h[p * s : (p + 1) * s, q * s : (q + 1) * s] = r[1 + p + q]
    return h


def _phase_fix_host(phi: np.ndarray) -> np.ndarray:
    """Unit-norm + rotate so the largest-|.| component is real positive."""
    n = np.linalg.norm(phi)
    if n > 0:
        phi = phi / n
    j = int(np.argmax(np.abs(phi)))
    p = phi[j]
    if np.abs(p) > 0:
        phi = phi * (np.conj(p) / np.abs(p))
    return phi


def _poles_at_order(u: np.ndarray, sv: np.ndarray, s: int, order: int,
                    fs: float, zeta_max: float):
    """Poles + shapes from the order-``n`` truncated observability matrix.

    ``O = U_n diag(sqrt(sv_n))``; ``C = O[:S]``; ``A`` solves ``O_up A =
    O_down`` in least squares; its eigenpairs are the discrete poles.  Keeps
    one pole of each conjugate pair, maps to ``mu = fs * log(lambda)`` and
    keeps ``0 < zeta < zeta_max``, ``0 < f < fs/2``.  Returns ``(freq [p],
    zeta_pct [p], shapes [p, S] complex)``.
    """
    o = u[:, :order] * np.sqrt(sv[:order])[None, :]
    a, *_ = np.linalg.lstsq(o[:-s], o[s:], rcond=None)
    lam, psi = np.linalg.eig(a)
    with np.errstate(invalid="ignore", divide="ignore"):
        # Zero eigenvalues (a dead channel) give inf/NaN poles that the keep
        # mask drops.
        mu = fs * np.log(lam.astype(np.complex128))
        wn = np.abs(mu)
        zeta = np.where(wn > 0, -mu.real / np.where(wn > 0, wn, 1.0), np.inf)
    freq = wn / (2.0 * np.pi)
    keep = (mu.imag > 0) & (zeta > 0) & (zeta < zeta_max) & (freq > 0) & (freq < 0.5 * fs)
    if not np.any(keep):
        return (np.zeros(0), np.zeros(0), np.zeros((0, s), np.complex128))
    c = o[:s]
    shapes = (c @ psi[:, keep]).T  # [p, S]
    shapes = np.stack([_phase_fix_host(v) for v in shapes])
    order_ix = np.argsort(freq[keep])
    return freq[keep][order_ix], 100.0 * zeta[keep][order_ix], shapes[order_ix]


def _merge_close_modes(modes: list, tol_freq: float, mac_min: float) -> list:
    """Merge duplicate modes from split pole clusters (frequency-sorted in):
    adjacent modes within ``2*tol_freq`` whose shapes match (MAC >=
    ``mac_min``) are one mode, and the more broadly stabilized one wins."""
    merged: list = []
    for m in modes:
        if merged:
            prev = merged[-1]
            close = abs(m.freq - prev.freq) / prev.freq < 2 * tol_freq
            if close and modal_assurance(prev.shape, m.shape)[0, 0] >= mac_min:
                merged[-1] = max(prev, m, key=lambda mm: mm.n_orders)
                continue
        merged.append(m)
    return merged


def ssi(
    records,
    fs,
    *,
    i: int = 20,
    orders=None,
    tol_freq: float = 0.01,
    tol_damping: float = 0.10,
    mac_min: float = 0.95,
    min_orders: int = 5,
    mpc_min: float = 0.90,
    zeta_max: float = 0.20,
    detrend: str = "mean",
    dtype: torch.dtype = torch.float32,
    blocks=None,
    device: torch.device | str | None = None,
) -> SSIResult:
    """SSI-COV modal identification over ``[S, T]`` multi-sensor records.

    Device correlation blocks over ``2i`` lags -> block Hankel ``[i*S,
    i*S]`` -> one SVD -> poles at every model order in ``orders`` -> a pole
    is *stable* at order ``n`` if a pole at the previous order matches
    within ``tol_freq``, ``tol_damping`` (relative) and ``mac_min`` (shape
    MAC) -> stable poles clustered by frequency and shape; clusters spanning
    >= ``min_orders`` orders with MPC >= ``mpc_min`` become modes.

    ``i`` bounds the model order at ``(i-1)*S``; ``orders`` defaults to
    every even order ``2..min((i-1)*S, 60)``.  ``blocks`` injects
    correlation blocks ``[2i, S, S]`` computed elsewhere in place of the
    device stage.
    """
    fs = float(fs)
    if fs <= 0:
        raise ValueError(f"fs must be positive, got {fs}")
    if i < 2:
        raise ValueError(f"need i >= 2 block rows, got {i}")
    shape = tuple(records.shape) if hasattr(records, "shape") else np.shape(records)
    if len(shape) != 2:
        raise ValueError(f"records must be [S, T], got shape {shape}")
    s = shape[0]
    # The shift-invariance least squares drops one block row, so (i-1)*S is
    # the highest determined model order.
    max_order = (i - 1) * s
    if orders is None:
        orders = range(2, min(max_order, 60) + 1, 2)
    orders = sorted(set(int(n) for n in orders))
    if not orders:
        raise ValueError(
            "orders is empty (with the default sweep this means "
            f"(i-1)*S = {max_order} < 2; raise i)"
        )
    if orders[0] < 2:
        raise ValueError(f"model orders must be >= 2, got {orders[0]}")
    if orders[-1] > max_order:
        raise ValueError(
            f"max order {orders[-1]} exceeds (i-1)*S = {max_order} "
            "(the shift-invariance fit is underdetermined past it); raise i"
        )
    if min_orders < 1:
        raise ValueError(f"min_orders must be >= 1, got {min_orders}")
    if not 0.0 <= mpc_min <= 1.0:
        raise ValueError(f"mpc_min must be in [0, 1], got {mpc_min}")

    if blocks is None:
        r = correlation_blocks(records, 2 * i, detrend=detrend, dtype=dtype, device=device)
    else:
        r = np.asarray(blocks, np.float64)
        if r.shape != (2 * i, s, s):
            raise ValueError(f"blocks must be [2i, S, S] = {(2 * i, s, s)}, got {r.shape}")
    h = _block_hankel(r, i)
    u, sv, _ = np.linalg.svd(h)

    # Poles per order + previous-order stability flags.
    diagram = []
    prev = None
    for n in orders:
        freq, zeta, shapes = _poles_at_order(u, sv, s, n, fs, zeta_max)
        stable = np.zeros(freq.shape, bool)
        if prev is not None and prev[0].size and freq.size:
            pf, pz, pshape = prev
            for j in range(freq.size):
                df = np.abs(pf - freq[j]) / freq[j]
                for c in np.flatnonzero(df < tol_freq):
                    dz_ok = abs(pz[c] - zeta[j]) <= tol_damping * max(zeta[j], 1e-12)
                    if dz_ok and modal_assurance(pshape[c], shapes[j])[0, 0] >= mac_min:
                        stable[j] = True
                        break
        diagram.append({"order": n, "freq": freq, "damping": zeta, "stable": stable,
                        "shapes": shapes})
        prev = (freq, zeta, shapes)

    # Cluster stable poles across orders: greedy by frequency + shape MAC.
    pool = []  # (freq, zeta, shape, order)
    for d in diagram:
        for j in np.flatnonzero(d["stable"]):
            pool.append((d["freq"][j], d["damping"][j], d["shapes"][j], d["order"]))
    pool.sort(key=lambda p: p[0])
    clusters = []
    for f0, z0, phi0, n0 in pool:
        for cl in clusters:
            fm = float(np.median([p[0] for p in cl]))
            if abs(f0 - fm) / fm < tol_freq and modal_assurance(cl[-1][2], phi0)[0, 0] >= mac_min:
                cl.append((f0, z0, phi0, n0))
                break
        else:
            clusters.append([(f0, z0, phi0, n0)])

    modes = []
    for cl in clusters:
        cl_orders = sorted(set(p[3] for p in cl))
        if len(cl_orders) < min_orders:
            continue
        fvals = np.asarray([p[0] for p in cl])
        zvals = np.asarray([p[1] for p in cl])
        best = max(cl, key=lambda p: p[3])  # shape from the highest order
        phase_col = modal_phase_collinearity(best[2])
        if phase_col < mpc_min:
            continue
        modes.append(SSIMode(
            freq=float(np.median(fvals)),
            damping=float(np.median(zvals)),
            shape=best[2],
            order=int(best[3]),
            n_orders=len(cl_orders),
            freq_std=float(np.std(fvals)),
            damping_std=float(np.std(zvals)),
            mpc=phase_col,
        ))
    modes.sort(key=lambda m: m.freq)
    modes = _merge_close_modes(modes, tol_freq, mac_min)

    # Plot-friendly diagram (shapes dropped: large and only needed above).
    slim = [{k: d[k] for k in ("order", "freq", "damping", "stable")} for d in diagram]
    return SSIResult(modes=modes, diagram=slim, orders=np.asarray(orders, np.int64),
                     hankel_sv=sv, n_sensors=s)
