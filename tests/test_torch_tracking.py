"""The port's ``models/tracking.py`` against the JAX package's.

``PeakTracker``, ``Track`` and ``match_peaks`` are host numpy in both
packages.  Seeded peak sequences (slow drifts, temperature swings, noise
births, vanishing modes, padded slots) go through both trackers: the
matches, tracks, births, alerts (raw and temperature-compensated) and
``to_dict`` output are equal, and a round trip through ``from_dict``
continues exactly where the original would.  ``update`` from an epoch
result reads the refined frequencies of the port's CPU epoch; those are
float32 results of two implementations, so they are held within 2e-5
relative of the JAX package's.
"""

import json

import numpy as np
import pytest
import torch

from apda_fft_tpu.models import tracking as jtr
from apda_fft_tpu_torch.models import tracking as ttr


@pytest.mark.parametrize("seed", range(6))
def test_match_peaks_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        tracks = list(rng.uniform(1.0, 200.0, int(rng.integers(0, 8))))
        new = [f * (1 + rng.normal(0, 0.015)) for f in tracks if rng.random() < 0.8]
        new += list(rng.uniform(1.0, 200.0, int(rng.integers(0, 3))))
        rng.shuffle(new)
        tol = float(rng.choice([0.005, 0.02, 0.05]))
        assert ttr.match_peaks(tracks, new, tol) == jtr.match_peaks(tracks, new, tol)


def _sequence(seed: int, epochs: int = 80):
    """Per epoch: (freqs with padded zero slots, mags, time, temperature)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(5.0, 120.0, 4)
    out = []
    for e in range(epochs):
        temp = 20.0 + 8.0 * np.sin(2 * np.pi * e / 30.0) + rng.normal(0, 0.3)
        freqs = []
        for m, f0 in enumerate(base):
            if rng.random() < 0.1:  # the mode is missed this epoch
                continue
            loss = 0.0008 * e if m == 0 else 0.0  # mode 0 loses stiffness
            freqs.append(f0 * (1 - loss) * (1 - 0.0005 * (temp - 20.0))
                         * (1 + rng.normal(0, 2e-4)))
        if rng.random() < 0.2:
            freqs.append(rng.uniform(1.0, 200.0))  # a one-epoch noise birth
        freqs += [0.0] * int(rng.integers(0, 3))  # padded slots
        mags = list(rng.uniform(0.1, 10.0, len(freqs)))
        out.append((freqs, mags, float(e), float(temp)))
    return out


def _alerts(tracker, **kw):
    return [(t.track_id, t.to_dict()) for t in tracker.alerts(**kw)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kw", [{}, dict(rel_tol=0.01, max_missed=2, history_cap=16)])
def test_tracker_equal_on_seeded_sequences(seed, kw):
    want, got = jtr.PeakTracker(**kw), ttr.PeakTracker(**kw)
    for freqs, mags, t, temp in _sequence(seed):
        a = want.update_freqs(freqs, mags, t=t, temp=temp)
        b = got.update_freqs(freqs, mags, t=t, temp=temp)
        assert [x.track_id for x in a] == [x.track_id for x in b]
    assert got.to_dict() == want.to_dict()
    assert [t.to_dict() for t in got.tracks(min_length=2)] == \
        [t.to_dict() for t in want.tracks(min_length=2)]
    for comp in (False, True):
        assert _alerts(got, rel_drift=0.02, compensate_temperature=comp) == \
            _alerts(want, rel_drift=0.02, compensate_temperature=comp)
    for a, b in zip(got.tracks(), want.tracks()):
        assert a.sustained_drift_relative() == b.sustained_drift_relative()
        assert a.compensated_drift_relative() == b.compensated_drift_relative()
        assert a.temperature_model() == b.temperature_model()
    assert got.prune_archive(min_length=2) == want.prune_archive(min_length=2)
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("seed", range(3))
def test_state_round_trip_continues_like_the_original(seed):
    seq = _sequence(seed, epochs=60)
    want, got = jtr.PeakTracker(), ttr.PeakTracker()
    for freqs, mags, t, temp in seq[:40]:
        want.update_freqs(freqs, mags, t=t, temp=temp)
        got.update_freqs(freqs, mags, t=t, temp=temp)
    state = json.loads(json.dumps(got.to_dict()))  # the gateway's drift_tracks.json
    assert state == json.loads(json.dumps(want.to_dict()))
    back = ttr.PeakTracker.from_dict(state)
    assert back.to_dict() == got.to_dict()
    jback = jtr.PeakTracker.from_dict(state)
    for freqs, mags, t, temp in seq[40:]:
        back.update_freqs(freqs, mags, t=t, temp=temp)
        jback.update_freqs(freqs, mags, t=t, temp=temp)
        got.update_freqs(freqs, mags, t=t, temp=temp)
    assert back.to_dict() == jback.to_dict() == got.to_dict()


def test_update_from_epoch_results_matches_jax():
    """``update`` on the port's CPU epochs (refined frequencies, sub-bin
    drift) against ``update`` on the JAX package's."""
    from apda_fft_tpu.models.pipeline import analyze_epoch as janalyze
    from apda_fft_tpu_torch.models.pipeline import analyze_epoch as tanalyze

    fs, n = 500.0, 4096
    t = np.arange(n) / fs
    want, got = jtr.PeakTracker(), ttr.PeakTracker()
    want_bin, got_bin = jtr.PeakTracker(), ttr.PeakTracker()
    for e in range(6):
        x = (np.sin(2 * np.pi * (12.3 + 0.04 * e) * t)
             + 0.6 * np.sin(2 * np.pi * 47.7 * t)).astype(np.float32)
        jres = janalyze(x[None], fs, mode="flexible", refine=True)
        tres = tanalyze(x[None], fs, mode="flexible", refine=True, device="cpu")
        assert isinstance(tres.freq, torch.Tensor)
        want.update(jres, t=e)
        got.update(tres, t=e)
        want_bin.update(jres, t=e, use_refined=False)
        got_bin.update(tres, t=e, use_refined=False)
    for (a, b), exact in (((got_bin, want_bin), True), ((got, want), False)):
        a, b = a.to_dict(), b.to_dict()
        assert len(a["tracks"]) == len(b["tracks"]) == 2
        for ta, tb in zip(a["tracks"], b["tracks"]):
            assert ta["track_id"] == tb["track_id"] and ta["times"] == tb["times"]
            if exact:  # bin frequencies: the same index, the same host finisher
                assert ta["freqs"] == tb["freqs"]
            np.testing.assert_allclose(ta["freqs"], tb["freqs"], rtol=2e-5)
            np.testing.assert_allclose(ta["mags"], tb["mags"], rtol=2e-5)
    drift = [min(tk.tracks(), key=lambda tr: tr.mean_freq).drift_hz for tk in (got, want)]
    assert drift[0] == pytest.approx(drift[1], abs=1e-4)
    assert 0.1 < drift[0] < 0.25  # sub-bin drift seen (0.2 Hz true, one bin 0.122)


def test_exported_from_the_package():
    import apda_fft_tpu_torch as apda

    assert apda.PeakTracker is ttr.PeakTracker and apda.Track is ttr.Track
    assert apda.match_peaks is ttr.match_peaks
