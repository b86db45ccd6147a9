"""Modal peak tracking across acquisition epochs (beyond-reference).

The reference stops at per-epoch peak lists; structural-health monitoring's
actual signal is how those modal frequencies DRIFT over time (stiffness
loss shifts modes down, temperature swings move them seasonally).  This
module matches each epoch's detected peaks to persistent tracks so drift
is a first-class output:

    tracker = PeakTracker(rel_tol=0.02)
    for res in epoch_results:              # EpochResult per epoch
        tracker.update(res, t=epoch_time)  # or update_freqs([...], t)
    for tr in tracker.tracks():
        print(tr.track_id, tr.mean_freq, tr.drift_hz, tr.freqs)

Matching is greedy nearest-frequency within a relative tolerance (modal
frequencies move slowly per epoch; a 2% default window comfortably covers
environmental drift while separating distinct modes resolved by the
detectors' own separation rules).  Host-side NumPy by design: k <= 5 peaks
per epoch is not device work; :meth:`PeakTracker.update` brings an
epoch's result tensors to the host from whatever device they lie on.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np


def _host(x) -> np.ndarray:
    """``x`` (a tensor on any device, an array or a list) as a host array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


@dataclasses.dataclass
class Track:
    """One persistent modal peak over time."""

    track_id: int
    times: list = dataclasses.field(default_factory=list)
    freqs: list = dataclasses.field(default_factory=list)
    mags: list = dataclasses.field(default_factory=list)
    missed: int = 0  # consecutive epochs without a match
    observed: int = 0  # total observations ever (>= len() once capped)
    #: per-observation sensor temperature (deg C; NaN when unknown) - the
    #: environmental covariate for temperature-compensated drift
    temps: list = dataclasses.field(default_factory=list)

    @property
    def last_freq(self) -> float:
        return self.freqs[-1]

    @property
    def mean_freq(self) -> float:
        return float(np.mean(self.freqs))

    @property
    def drift_hz(self) -> float:
        """Latest frequency minus the track's first observation."""
        return self.freqs[-1] - self.freqs[0]

    @property
    def drift_relative(self) -> float:
        return self.drift_hz / self.freqs[0] if self.freqs[0] else 0.0

    def sustained_drift_relative(self, k: int = 3) -> float:
        """Median of the last ``k`` observations vs the first ``k``, relative.

        Robust to a single noisy epoch (``drift_relative`` compares one
        first and one last sample, so one outlier can fake a drift).
        """
        if len(self.freqs) < 2:
            return 0.0
        k = max(1, min(k, len(self.freqs) // 2 or 1))
        start = float(np.median(self.freqs[:k]))
        end = float(np.median(self.freqs[-k:]))
        return (end - start) / start if start else 0.0

    #: identifiability guards for :meth:`temperature_model`
    TEMP_MODEL_MIN_OBS = 8
    TEMP_MODEL_MIN_SPAN_C = 2.0

    def temperature_model(self):
        """Baseline linear model ``freq ~ a + b * temp``; None if unfit.

        Modal frequencies move with temperature (stiffness of asphalt,
        bearings, cables - the classic environmental confounder: on the
        Z24 benchmark the daily thermal swing moves eigenfrequencies more
        than early structural damage does).  The slope is fitted on the
        BASELINE portion of the track - the first half of the
        observations, at least :attr:`TEMP_MODEL_MIN_OBS` - never on the
        whole history, so a late damage drift cannot be absorbed into the
        "environmental" model it is supposed to be separated from.
        Returns ``(intercept_hz, slope_hz_per_c)`` or ``None`` when there
        are too few finite temperatures or their span is below
        :attr:`TEMP_MODEL_MIN_SPAN_C` (slope unidentifiable).
        """
        n = len(self.freqs)
        if len(self.temps) != n or n < self.TEMP_MODEL_MIN_OBS:
            return None
        base = max(self.TEMP_MODEL_MIN_OBS, n // 2)
        t = np.asarray(self.temps[:base], np.float64)
        f = np.asarray(self.freqs[:base], np.float64)
        fin = np.isfinite(t) & np.isfinite(f)
        if fin.sum() < self.TEMP_MODEL_MIN_OBS:
            return None
        t, f = t[fin], f[fin]
        if t.max() - t.min() < self.TEMP_MODEL_MIN_SPAN_C:
            return None
        slope, intercept = np.polyfit(t, f, 1)
        return float(intercept), float(slope)

    def compensated_drift_relative(self, k: int = 3):
        """Temperature-adjusted :meth:`sustained_drift_relative`.

        Removes the baseline-fitted thermal component before comparing the
        recent median against the early median, so a cold snap does not
        read as stiffness loss (and a warm spell does not mask one).
        Returns ``None`` when no temperature model is identifiable -
        callers fall back to the raw drift.
        """
        model = self.temperature_model()
        if model is None:
            return None
        _, slope = model
        n = len(self.freqs)
        k = max(1, min(k, n // 2 or 1))
        t = np.asarray(self.temps, np.float64)
        f = np.asarray(self.freqs, np.float64)
        # Residual vs the thermal model, anchored at the track's mean temp
        # (only differences matter for drift).
        t_ref = np.nanmean(t)
        resid = f - slope * (np.where(np.isfinite(t), t, t_ref) - t_ref)
        start = float(np.median(resid[:k]))
        end = float(np.median(resid[-k:]))
        return (end - start) / start if start else 0.0

    def to_dict(self) -> dict:
        """JSON-serializable summary (for egress/telemetry payloads)."""

        def _t(v):
            try:
                return float(v)
            except (TypeError, ValueError):
                return str(v)  # e.g. datetime timestamps

        return {
            "track_id": self.track_id,
            "epochs": max(self.observed, len(self)),
            "times": [_t(v) for v in self.times],
            "freqs": [float(f) for f in self.freqs],
            "mags": [float(m) for m in self.mags],
            "mean_freq": self.mean_freq,
            "drift_hz": float(self.drift_hz),
            "drift_relative": float(self.drift_relative),
        }

    def __len__(self) -> int:
        return len(self.freqs)


def match_peaks(
    track_freqs: Sequence[float],
    new_freqs: Sequence[float],
    rel_tol: float = 0.02,
) -> list[tuple[int, int]]:
    """Greedy nearest-frequency matching: ``[(track_idx, new_idx), ...]``.

    Pairs are taken closest-first; each side is used at most once; a pair
    is accepted iff ``|f_new - f_track| <= rel_tol * f_track``.
    """
    if not len(track_freqs) or not len(new_freqs):
        return []
    tf = np.asarray(track_freqs, np.float64)
    nf = np.asarray(new_freqs, np.float64)
    dist = np.abs(nf[None, :] - tf[:, None])  # [T, N]
    order = np.argsort(dist, axis=None, kind="stable")
    used_t: set[int] = set()
    used_n: set[int] = set()
    pairs: list[tuple[int, int]] = []
    for flat in order:
        ti, ni = divmod(int(flat), len(nf))
        if ti in used_t or ni in used_n:
            continue
        if dist[ti, ni] > rel_tol * tf[ti]:
            # The tolerance is RELATIVE to each track while the ordering is
            # absolute, so a too-far low-frequency pair can sort before a
            # valid high-frequency one - keep scanning (k <= 5, O(T*N) is
            # free), never break.
            continue
        used_t.add(ti)
        used_n.add(ni)
        pairs.append((ti, ni))
    return pairs


class PeakTracker:
    """Accumulate per-epoch peak lists into persistent modal tracks.

    Args:
      rel_tol: relative matching window vs each track's last frequency.
      max_missed: a track is retired after this many consecutive unmatched
        epochs (it stays in :meth:`tracks` history; it just can't match).
    """

    #: per-archived-track observation cap (head 8 + recent tail)
    ARCHIVE_OBS_KEEP = 64

    def __init__(
        self,
        rel_tol: float = 0.02,
        max_missed: int = 5,
        history_cap: int = 2048,
    ):
        self.rel_tol = rel_tol
        self.max_missed = max_missed
        #: per-track observation cap: beyond it the MIDDLE of the history is
        #: trimmed, preserving the first observations (the drift baseline
        #: ``drift_relative``/``sustained_drift_relative`` compare against)
        #: and the recent tail - bounds memory and serialized state for
        #: months-long tracks.  0 disables.
        self.history_cap = history_cap
        self._tracks: list[Track] = []   # live (matchable) tracks
        self._archive: list[Track] = []  # retired tracks, kept for history
        self._next_id = 0
        self._epoch = 0

    def update_freqs(
        self,
        freqs: Iterable[float],
        mags: Iterable[float] | None = None,
        t=None,
        temp: float | None = None,
    ) -> list[Track]:
        """Match one epoch's peak frequencies; returns tracks matched/born.

        ``temp`` is the epoch's sensor temperature (deg C) when known -
        recorded per observation so :meth:`Track.temperature_model` can
        separate thermal frequency swings from structural drift.
        """
        t = self._epoch if t is None else t
        self._epoch += 1
        temp_v = float(temp) if temp is not None else float("nan")
        fl_all = [float(f) for f in freqs]
        ml_all = (
            [float(m) for m in mags] if mags is not None else [0.0] * len(fl_all)
        )
        # Drop invalid (padded) slots from freqs and mags TOGETHER so the
        # magnitudes stay aligned with their peaks.
        kept = [(f, m) for f, m in zip(fl_all, ml_all) if f > 0]
        fl = [f for f, _ in kept]
        ml = [m for _, m in kept]

        # Retire long-silent tracks into the archive so the live list (and
        # per-update matching) stays bounded in a months-long deployment.
        # Retired tracks can never grow again, so their history is trimmed
        # hard (baseline head + recent tail) - bounds archive memory and
        # serialized state.
        still_live = []
        for tr in self._tracks:
            if tr.missed < self.max_missed:
                still_live.append(tr)
            else:
                if len(tr.freqs) > self.ARCHIVE_OBS_KEEP:
                    head, tail = 8, self.ARCHIVE_OBS_KEEP - 8
                    cut = slice(head, len(tr.freqs) - tail)
                    del tr.times[cut], tr.freqs[cut], tr.mags[cut]
                    del tr.temps[cut]
                self._archive.append(tr)
        self._tracks = still_live
        active = self._tracks
        pairs = match_peaks([tr.last_freq for tr in active], fl, self.rel_tol)
        matched_tracks: list[Track] = []
        matched_new = set()
        keep_head = min(8, max(self.history_cap - 1, 0)) if self.history_cap else 8
        for ti, ni in pairs:
            tr = active[ti]
            tr.times.append(t)
            tr.freqs.append(fl[ni])
            tr.mags.append(ml[ni])
            tr.temps.append(temp_v)
            tr.missed = 0
            tr.observed += 1
            if self.history_cap and len(tr.freqs) > self.history_cap:
                cut = slice(keep_head, keep_head + 1)
                del tr.times[cut], tr.freqs[cut], tr.mags[cut]
                del tr.temps[cut]
            matched_tracks.append(tr)
            matched_new.add(ni)
        for tr in active:
            if tr not in matched_tracks:
                tr.missed += 1
        for ni, f in enumerate(fl):
            if ni not in matched_new:
                tr = Track(self._next_id, [t], [f], [ml[ni]], observed=1,
                           temps=[temp_v])
                self._next_id += 1
                self._tracks.append(tr)
                matched_tracks.append(tr)
        return matched_tracks

    def update(
        self, result, window: int = 0, t=None, use_refined: bool = True
    ) -> list[Track]:
        """Match one window of an :class:`EpochResult` (batch index 0 or
        ``window``; flatten multi-axis batches yourself for other layouts).

        With ``use_refined`` (default) the sub-bin interpolated frequencies
        are used when the epoch was analyzed with ``refine=True`` — drift
        well below one bin (the typical early damage signal) is invisible
        in the bin-rounded ``freq``.
        """
        count = int(_host(result.count).reshape(-1)[window])
        k = result.freq.shape[-1]
        freqs = _host(result.freq).reshape(-1, k)[window][:count]
        if use_refined:
            refined = _host(result.refined_freq).reshape(-1, k)[window][:count]
            freqs = np.where(refined > 0, refined, freqs)
        mags = _host(result.mag).reshape(-1, k)[window][:count]
        return self.update_freqs(freqs, mags, t=t)

    def tracks(self, min_length: int = 1) -> list[Track]:
        """All tracks (live + retired), longest-lived first."""
        return sorted(
            (tr for tr in self._tracks + self._archive if len(tr) >= min_length),
            key=len,
            reverse=True,
        )

    def alerts(self, rel_drift: float = 0.02, min_length: int = 5,
               compensate_temperature: bool = False) -> list[Track]:
        """LIVE tracks whose sustained relative drift exceeds ``rel_drift``.

        The SHM "so what": a sustained downward modal-frequency shift is
        the classic stiffness-loss signal.  Only tracks observed at least
        ``min_length`` epochs qualify (short tracks are noise births), the
        drift metric is median-vs-median (:meth:`Track.
        sustained_drift_relative`) so one noisy epoch cannot fake it, and
        retired tracks - which can't receive new data - are not re-scanned.

        With ``compensate_temperature`` the drift is measured on the
        residual of each track's baseline thermal model
        (:meth:`Track.compensated_drift_relative`) whenever one is
        identifiable - the daily/seasonal temperature swing moves modal
        frequencies more than early damage does, so raw-drift alerting in
        the field either cries wolf every cold snap or needs a threshold
        too loose to catch damage.  Tracks without an identifiable model
        fall back to the raw metric.
        """

        def metric(tr: Track) -> float:
            if compensate_temperature:
                comp = tr.compensated_drift_relative()
                if comp is not None:
                    return comp
            return tr.sustained_drift_relative()

        return [
            tr
            for tr in self._tracks
            if len(tr) >= min_length and abs(metric(tr)) >= rel_drift
        ]

    def to_dict(self) -> dict:
        """Full serializable state (tracks + archive + counters).

        Lean schema: only what :meth:`from_dict` reads (no derived fields -
        they recompute from the arrays).  Non-numeric times (datetimes)
        stringify; numeric times round-trip as floats.
        """

        def _t(v):
            try:
                return float(v)
            except (TypeError, ValueError):
                return str(v)

        def tr_state(tr: Track) -> dict:
            return {
                "track_id": tr.track_id,
                "times": [_t(v) for v in tr.times],
                "freqs": [float(f) for f in tr.freqs],
                "mags": [float(m) for m in tr.mags],
                "missed": tr.missed,
                "observed": tr.observed,
                # Omitted when all-unknown: keeps pre-temperature state
                # files byte-stable and small.
                **({"temps": [float(v) for v in tr.temps]}
                   if any(v == v for v in tr.temps) else {}),
            }

        return {
            "rel_tol": self.rel_tol,
            "max_missed": self.max_missed,
            "history_cap": self.history_cap,
            "next_id": self._next_id,
            "epoch": self._epoch,
            "tracks": [tr_state(t) for t in self._tracks],
            "archive": [tr_state(t) for t in self._archive],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PeakTracker":
        """Rebuild a tracker saved with :meth:`to_dict` (restart resume)."""
        self = cls(
            rel_tol=d.get("rel_tol", 0.02),
            max_missed=d.get("max_missed", 5),
            history_cap=int(d.get("history_cap", 2048)),
        )
        self._next_id = int(d.get("next_id", 0))
        self._epoch = int(d.get("epoch", 0))

        def mk(s: dict) -> Track:
            tr = Track(
                int(s["track_id"]),
                list(s.get("times", [])),
                [float(f) for f in s.get("freqs", [])],
                [float(m) for m in s.get("mags", [])],
            )
            tr.missed = int(s.get("missed", 0))
            tr.observed = int(s.get("observed", len(tr.freqs)))
            temps = s.get("temps")
            tr.temps = ([float(v) for v in temps] if temps
                        else [float("nan")] * len(tr.freqs))
            return tr

        self._tracks = [mk(s) for s in d.get("tracks", [])]
        self._archive = [mk(s) for s in d.get("archive", [])]
        return self

    def prune_archive(self, min_length: int = 2) -> int:
        """Drop short retired tracks (noise births); returns how many."""
        before = len(self._archive)
        self._archive = [tr for tr in self._archive if len(tr) >= min_length]
        return before - len(self._archive)
