"""Command-line interface: batch-analyze sensor log files on the card.

Counterpart of ``apda_fft_tpu/__main__.py``: the same subcommands,
arguments, defaults and output (text and ``--json`` lines field for field).

Usage:
    python -m apda_fft_tpu_torch analyze FILE [FILE...] [--mode flexible|rigid|adaptive]
                                   [--backend xla|matmul|pallas] [--refine]
                                   [--taper none|hann|hamming|blackman] [--json]
                                   [--device cpu]
    python -m apda_fft_tpu_torch oracle-check FILE [FILE...]   # vs float64 oracle
    python -m apda_fft_tpu_torch track FILE [FILE...] [--rel-drift R]  # modal drift
                                   # (exit 2 when a drift alert fires)

``analyze`` loads gateway-format acquisition logs (``io/logfile.py``), buckets
them by padded FFT length, and runs each bucket as one batched epoch - the
CLI equivalent of the gateway's analysis stage.  ``oracle-check`` is the
validation harness: it re-runs each file through the pure-Python float64
reference oracle (``tests/oracle.py`` of the repository checkout, loaded by
path) and reports decision agreement.

Every analysing subcommand takes ``--device`` (the gateway CLI's flag): the
analysis runs on the CUDA card by default, raises without one, and runs on
the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load(paths):
    from apda_fft_tpu_torch.io.logfile import load_sensor_log

    loaded = []
    for path in paths:
        rec = load_sensor_log(path)
        # < 2 samples has no spectrum (next_pow2(1) = 1 -> zero bins) and
        # cannot be Welch-segmented; skip like the gateway does.
        if rec is None or len(rec.samples) < 2:
            print(f"# skipping {path}: corrupt or too short", file=sys.stderr)
            continue
        loaded.append((path, rec))
    return loaded


def _host(t) -> np.ndarray:
    """A result tensor as a host array."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _fuse_rates(loaded, allow_decimate: bool, allow_resample: bool = False, device=None):
    """One time base for multi-sensor analysis: ``(fs, samples_list, err)``.

    Equal rates pass through.  With ``allow_decimate`` a faster channel is
    anti-alias decimated (``ops/resample.py``) onto the slowest rate when
    the ratio is integer - the hardware ODR grid is dyadic
    (``protocol_decoder.py:5-8``), so deployed mixes always divide evenly.
    ``allow_resample`` additionally covers rational ratios (e.g. a 100 Hz
    guest channel against the 62.5 Hz grid) via polyphase up/down
    resampling onto the slowest rate.  Anything else returns a clear
    error string.  The resampling runs on ``device`` (default the card).
    """
    rates = {rec.fs for _, rec in loaded}
    if len(rates) == 1:
        return (loaded[0][1].fs,
                [np.asarray(rec.samples, np.float64) for _, rec in loaded],
                None)
    if not (allow_decimate or allow_resample):
        return None, None, (
            f"sampling rates differ across files: {sorted(rates)} "
            "(pass --decimate to fuse onto the slowest rate)"
        )
    from apda_fft_tpu_torch.ops.resample import (
        decimate,
        decimation_factor,
        rational_factors,
        resample_rational,
    )

    fs = min(rates)
    recs = []
    for path, rec in loaded:
        x = np.asarray(rec.samples, np.float64)
        q = decimation_factor(rec.fs, fs)
        try:
            if q is not None:
                recs.append(decimate(x, q, device=device))
                continue
            if allow_resample:
                ud = rational_factors(rec.fs, fs)
                if ud is not None:
                    recs.append(resample_rational(x, *ud, device=device))
                    continue
                return None, None, (
                    f"{path}: fs={rec.fs} has no small rational ratio to "
                    f"the base rate {fs} - cannot resample"
                )
            return None, None, (
                f"{path}: fs={rec.fs} is not an integer multiple of the "
                f"base rate {fs} - cannot decimate (try --resample)"
            )
        except ValueError as exc:
            return None, None, f"{path}: {exc}"
    return fs, recs, None


def _format_peaks(rp, mode: str, refine: bool) -> list[dict]:
    """Per-record peak dicts with the host-float64 exact frequency finisher.

    ``exact_freq`` recovers the per-window detector in adaptive mode
    (rigid-fallback windows are unrounded, prominence-served ones 4-dp
    rounded); rigid mode drops the fields its detector never computes.
    """
    peaks = []
    for slot in range(rp.count):
        p = rp.peak(slot)
        p["freq"] = rp.exact_freq(slot, mode)
        if mode == "rigid":
            for drop in ("damping", "q_factor", "prominence"):
                p.pop(drop)
        if not refine:
            p.pop("refined_freq")
        peaks.append(p)
    return peaks


def _print_peaks_text(peaks: list[dict]) -> None:
    if not peaks:
        print("  no peaks above threshold")
    for p in peaks:
        line = f"  f={p['freq']:.4f} Hz  mag={p['mag']:.4f}"
        if "damping" in p:
            line += f"  damping={p['damping']:.2f}%  q={p['q_factor']:.2f}"
        if "refined_freq" in p:
            line += f"  refined={p['refined_freq']:.4f} Hz"
        print(line)


def cmd_analyze(args) -> int:
    from apda_fft_tpu_torch.models.batching import analyze_records

    loaded = _load(args.files)
    if not loaded:
        print("no analyzable files", file=sys.stderr)
        return 1

    records = [(np.asarray(rec.samples, np.float32), rec.fs) for _, rec in loaded]
    per_record = analyze_records(
        records, mode=args.mode, backend=args.backend, refine=args.refine,
        taper=args.taper, device=args.device,
    )
    for (path, rec), rp in zip(loaded, per_record):
        peaks = _format_peaks(rp, args.mode, args.refine)
        if args.json:
            print(json.dumps({"file": path, "fs": rec.fs, "axis": rec.axis,
                              "n_fft": rp.n_fft, "peaks": peaks}))
        else:
            print(f"{path} (fs={rec.fs} Hz, axis={rec.axis}, N={rp.n_fft}):")
            _print_peaks_text(peaks)
    return 0


def cmd_welch(args) -> int:
    """Welch-averaged peak detection over acquisition files.

    The noise-robust companion of ``analyze``: each record is segmented
    (``--window``/``--hop``), segment power spectra are averaged, and the
    detector runs once per file on the averaged spectrum - weak modes that
    drown in a single-shot spectrum's noise floor become clean peaks.
    """
    from apda_fft_tpu_torch.models.batching import analyze_records_welch

    loaded = _load(args.files)
    if not loaded:
        print("no analyzable files", file=sys.stderr)
        return 1

    records = [(np.asarray(rec.samples, np.float32), rec.fs) for _, rec in loaded]
    per_record = analyze_records_welch(
        records, window=args.window, hop=args.hop, taper=args.taper,
        mode=args.mode, refine=args.refine, device=args.device,
    )
    for (path, rec), rp in zip(loaded, per_record):
        peaks = _format_peaks(rp, args.mode, args.refine)
        if args.json:
            print(json.dumps({"file": path, "fs": rec.fs, "axis": rec.axis,
                              "n_fft": rp.n_fft, "window": args.window,
                              "peaks": peaks}))
        else:
            print(f"{path} (fs={rec.fs} Hz, axis={rec.axis}, "
                  f"welch window={args.window}, N={rp.n_fft}):")
            _print_peaks_text(peaks)
    return 0


def cmd_spectrogram(args) -> int:
    """Time-frequency view of one or more acquisition files."""
    from apda_fft_tpu_torch.models.streaming import spectrogram

    loaded = _load(args.files)
    if not loaded:
        print("no analyzable files", file=sys.stderr)
        return 1

    out = {}
    for path, rec in loaded:
        samples = np.asarray(rec.samples, np.float32)
        if len(samples) < args.window:
            print(f"# skipping {path}: {len(samples)} samples < window "
                  f"{args.window}", file=sys.stderr)
            continue
        freqs, mags = spectrogram(
            samples, rec.fs, args.window, args.hop, taper=args.taper, device=args.device,
        )
        freqs, mags = _host(freqs), _host(mags)
        out[path] = {"freqs": freqs, "mags": mags}
        dom = np.argmax(mags, axis=-1)  # [W] dominant bin per frame
        if args.json:
            print(json.dumps({
                "file": path, "fs": rec.fs, "axis": rec.axis,
                "frames": int(mags.shape[0]), "bins": int(mags.shape[1]),
                "dominant_freq": [float(freqs[i]) for i in dom],
                "dominant_mag": [float(m) for m in mags[np.arange(len(dom)), dom]],
            }))
        else:
            print(f"{path} (fs={rec.fs} Hz, axis={rec.axis}): "
                  f"{mags.shape[0]} frames x {mags.shape[1]} bins")
            for w, i in enumerate(dom):
                print(f"  frame {w:3d}: dominant {freqs[i]:9.4f} Hz  "
                      f"mag={mags[w, i]:.4f}")
    if args.out and out:
        _save_npz(args.out, out)
    return 0 if out else 1


def _os_basename_noext(path: str) -> str:
    import os as _os

    return _os.path.splitext(_os.path.basename(path))[0]


def _save_npz(out_path: str, per_file: dict) -> None:
    """Save ``{path: {suffix: array}}`` keyed by de-duplicated basename stems.

    Final names are checked against every name already taken (not just the
    original stem), so a generated ``stem.N`` can never clobber a real file
    literally named ``stem.N``.
    """
    arrays = {}
    taken: set[str] = set()
    for path, d in per_file.items():
        stem = base = _os_basename_noext(path)
        n = 1
        while stem in taken:
            stem = f"{base}.{n}"
            n += 1
        taken.add(stem)
        for suffix, arr in d.items():
            arrays[f"{stem}__{suffix}"] = arr
    np.savez(out_path, **arrays)
    print(f"# wrote {out_path}", file=sys.stderr)


def cmd_psd(args) -> int:
    """Welch power spectral density in engineering units (units^2/Hz)."""
    from apda_fft_tpu_torch.models.streaming import welch_psd

    loaded = _load(args.files)
    if not loaded:
        print("no analyzable files", file=sys.stderr)
        return 1

    out = {}
    for path, rec in loaded:
        samples = np.asarray(rec.samples, np.float32)
        if len(samples) < args.window:
            print(f"# skipping {path}: {len(samples)} samples < window "
                  f"{args.window}", file=sys.stderr)
            continue
        freqs, psd = welch_psd(
            samples, rec.fs, args.window, args.hop, taper=args.taper, device=args.device,
        )
        freqs, psd = _host(freqs), _host(psd)
        out[path] = {"freqs": freqs, "psd": psd}
        top = np.argsort(-psd)[: args.top]
        top.sort()
        if args.json:
            print(json.dumps({
                "file": path, "fs": rec.fs, "axis": rec.axis,
                "window": args.window, "bins": int(len(psd)),
                "top_bins": [{"freq": float(freqs[i]), "psd": float(psd[i])}
                             for i in top],
            }))
        else:
            print(f"{path} (fs={rec.fs} Hz, axis={rec.axis}, "
                  f"window={args.window}): {len(psd)} bins")
            for i in top:
                print(f"  f={freqs[i]:9.4f} Hz  psd={psd[i]:.6e}")
    if args.out and out:
        _save_npz(args.out, out)
    return 0 if out else 1


def cmd_srs(args) -> int:
    """Shock Response Spectrum of transient records (damage potential).

    The standard characterization of a 0xC1 shock event: each record drives
    a bank of Q=10 single-degree-of-freedom oscillators (1/6-octave natural
    frequencies) and the maximax absolute response is reported per
    oscillator, with the pseudo-velocity damage proxy.  The reference
    uploads shock records raw and never analyzes them
    (``GT_FFT_v5.py:514-554``).
    """
    from apda_fft_tpu_torch.ops.srs import shock_response_spectrum

    if args.per_octave < 1:
        print(f"--per-octave must be >= 1, got {args.per_octave}",
              file=sys.stderr)
        return 1
    loaded = _load(args.files)
    if not loaded:
        print("no analyzable files", file=sys.stderr)
        return 1

    out = {}
    for path, rec in loaded:
        samples = np.asarray(rec.samples, np.float32)
        if len(samples) < 3:
            print(f"# skipping {path}: {len(samples)} samples < 3",
                  file=sys.stderr)
            continue
        f_max = args.fmax if args.fmax > 0 else rec.fs / 4.0
        f_min = args.fmin if args.fmin > 0 else rec.fs / 100.0
        if not f_min < f_max < rec.fs / 2:
            print(f"# skipping {path}: bank ({f_min}, {f_max}) Hz invalid "
                  f"for fs={rec.fs}", file=sys.stderr)
            continue
        res = shock_response_spectrum(
            samples, rec.fs, q=args.q, f_min=f_min, f_max=f_max,
            points_per_octave=args.per_octave,
            residual=not args.no_residual, device=args.device,
        )
        pv = res.pseudo_velocity
        out[path] = {"freqs": res.freqs, "maximax": res.maximax,
                     "positive": res.positive, "negative": res.negative,
                     "pseudo_velocity": pv}
        f_pk, a_pk = res.peak()
        if args.json:
            print(json.dumps({
                "file": path, "fs": rec.fs, "axis": rec.axis,
                "q": args.q, "bank": len(res.freqs),
                "peak_freq": f_pk, "peak_maximax": a_pk,
                "peak_pseudo_velocity": float(np.max(pv)),
                "srs": [{"freq": float(res.freqs[i]),
                         "maximax": float(res.maximax[i]),
                         "pv": float(pv[i])}
                        for i in range(len(res.freqs))],
            }))
        else:
            print(f"{path} (fs={rec.fs} Hz, axis={rec.axis}, Q={args.q}): "
                  f"peak {a_pk:.4f} @ {f_pk:.2f} Hz")
            for i in range(len(res.freqs)):
                print(f"  fn={res.freqs[i]:9.3f} Hz  maximax="
                      f"{res.maximax[i]:.5f}  pv={pv[i]:.6f}")
    if args.out and out:
        _save_npz(args.out, out)
    return 0 if out else 1


def cmd_severity(args) -> int:
    """ISO 10816/20816 vibration severity: band-limited velocity RMS.

    One number per record - the serviceability quantity a maintenance
    standard acts on.  Computed from the omega-scaled spectrum via
    Parseval (``ops/integrate.py:velocity_rms``), converted from the
    sensors' g units to ISO mm/s.  The reference uploads raw traces and
    leaves this to the server side.
    """
    from apda_fft_tpu_torch.ops.integrate import G_TO_MMS2, velocity_rms

    if args.flo >= args.fhi:
        print(f"--flo must be < --fhi, got ({args.flo:g}, {args.fhi:g})",
              file=sys.stderr)
        return 1
    loaded = _load(args.files)
    if not loaded:
        print("no analyzable files", file=sys.stderr)
        return 1

    any_ok = False
    for path, rec in loaded:
        samples = np.asarray(rec.samples, np.float32)
        if len(samples) < 8:
            print(f"# skipping {path}: {len(samples)} samples < 8",
                  file=sys.stderr)
            continue
        if args.flo >= rec.fs / 2:
            print(f"# skipping {path}: band ({args.flo}, {args.fhi}) Hz "
                  f"empty at fs={rec.fs}", file=sys.stderr)
            continue
        mms = float(velocity_rms(samples, rec.fs, band=(args.flo, args.fhi),
                                 device=args.device)) * G_TO_MMS2
        any_ok = True
        over = args.limit > 0 and mms >= args.limit
        if args.json:
            out = {"file": path, "fs": rec.fs, "axis": rec.axis,
                   "band_hz": [args.flo, min(args.fhi, rec.fs / 2)],
                   "velocity_rms_mms": round(mms, 4)}
            if args.limit > 0:
                out["limit_mms"] = args.limit
                out["over_limit"] = over
            print(json.dumps(out))
        else:
            tag = "  ** OVER LIMIT **" if over else ""
            print(f"{path} (fs={rec.fs} Hz, axis={rec.axis}): "
                  f"{mms:.3f} mm/s RMS ({args.flo:g}-"
                  f"{min(args.fhi, rec.fs / 2):g} Hz){tag}")
    return 0 if any_ok else 1


def cmd_integrate(args) -> int:
    """Frequency-domain integration: velocity / displacement traces.

    Omega-arithmetic with Tukey edge taper + soft high-pass
    (``ops/integrate.py``); read results from the flat middle of the
    record.  Units: input g -> g*s (velocity) or g*s^2 (displacement);
    --mms converts to mm/s / mm.

    Default high-pass is 8 analysis bins (``8*fs/T``) with a one-octave
    raised-cosine roll-off, so the accurate passband starts near
    ``2.5x`` that (~20 bins).  Long-record low-mode displacement whose
    modes sit below that edge needs an explicit lower ``--highpass``
    (accepting more 1/w^2 noise amplification in exchange).
    """
    from apda_fft_tpu_torch.ops.integrate import G_TO_MMS2, integrate_acceleration

    order = {"velocity": 1, "displacement": 2}[args.quantity]
    loaded = _load(args.files)
    if not loaded:
        print("no analyzable files", file=sys.stderr)
        return 1

    out = {}
    for path, rec in loaded:
        samples = np.asarray(rec.samples, np.float32)
        if len(samples) < 8:
            print(f"# skipping {path}: {len(samples)} samples < 8",
                  file=sys.stderr)
            continue
        y = _host(integrate_acceleration(
            samples, rec.fs, order=order,
            f_highpass=args.highpass if args.highpass > 0 else None, device=args.device))
        if args.mms:
            y = y * G_TO_MMS2
        out[path] = {args.quantity: y}
        mid = slice(len(y) // 4, 3 * len(y) // 4)
        peak = float(np.max(np.abs(y[mid])))
        rms = float(np.sqrt(np.mean(np.square(y[mid]))))
        unit = ("mm/s" if order == 1 else "mm") if args.mms \
            else ("g*s" if order == 1 else "g*s^2")
        if args.json:
            print(json.dumps({
                "file": path, "fs": rec.fs, "axis": rec.axis,
                "quantity": args.quantity, "unit": unit,
                "mid_peak": peak, "mid_rms": rms,
            }))
        else:
            print(f"{path} (fs={rec.fs} Hz, axis={rec.axis}): "
                  f"{args.quantity} mid-peak {peak:.6g} {unit}, "
                  f"mid-RMS {rms:.6g} {unit}")
    if args.out and out:
        _save_npz(args.out, out)
    return 0 if out else 1


def cmd_coherence(args) -> int:
    """Two-sensor magnitude-squared coherence report.

    "Is this the same structural mode?" across two simultaneously recorded
    channels: bands with coherence near 1 are linearly related (one mode
    seen by both sensors); independent noise sits near 0.  Also reports the
    cross-spectral phase at each coherent peak (mode-shape sign/lag).
    """
    from apda_fft_tpu_torch.models.streaming import coherence_with_phase

    loaded = _load([args.file_x, args.file_y])
    if len(loaded) != 2:
        print("coherence needs two analyzable files", file=sys.stderr)
        return 1
    fs, samples, err = _fuse_rates(loaded, args.decimate, args.resample, args.device)
    if err:
        print(err, file=sys.stderr)
        return 1
    path_x, path_y = loaded[0][0], loaded[1][0]
    x = np.asarray(samples[0], np.float32)
    y = np.asarray(samples[1], np.float32)
    t = min(len(x), len(y))
    if t < 2 * args.window:
        print(f"need >= 2 overlapping segments ({t} common samples < "
              f"2*window={2 * args.window})", file=sys.stderr)
        return 1
    x, y = x[:t], y[:t]
    freqs, cxy, phase = coherence_with_phase(x, y, fs, args.window, args.hop,
                                             device=args.device)
    freqs, cxy, phase = _host(freqs), _host(cxy), _host(phase)

    # Coherent peaks: local maxima of coherence above the threshold.
    above = cxy >= args.threshold
    rows = []
    for i in range(1, len(cxy) - 1):
        if above[i] and cxy[i] >= cxy[i - 1] and cxy[i] > cxy[i + 1]:
            rows.append(i)
    rows.sort(key=lambda i: -cxy[i])
    rows = rows[: args.top]
    rows.sort()
    if args.json:
        print(json.dumps({
            "file_x": path_x, "file_y": path_y, "fs": fs,
            "window": args.window, "threshold": args.threshold,
            "coherent_peaks": [
                {"freq": float(freqs[i]), "coherence": float(cxy[i]),
                 "phase_deg": float(phase[i])} for i in rows
            ],
        }))
    else:
        print(f"{path_x} vs {path_y} (fs={fs} Hz, window={args.window}):")
        if not rows:
            print(f"  no coherent bands above {args.threshold}")
        for i in rows:
            print(f"  f={freqs[i]:9.4f} Hz  coherence={cxy[i]:.3f}  "
                  f"phase={phase[i]:+7.1f} deg")
    return 0


def cmd_fdd(args) -> int:
    """Multi-sensor operational modal analysis (FDD).

    Takes simultaneously recorded acquisition files (one per sensor),
    builds the cross-spectral density matrix, and reports each identified
    structural mode with its frequency, damping, mode-separation ratio
    (s2/s1), and mode shape across the input sensors - the cross-sensor
    picture the per-file ``analyze``/``welch`` commands cannot see.
    """
    from apda_fft_tpu_torch.models.modal import fdd

    loaded = _load(args.files)
    if len(loaded) < 1:
        print("no analyzable files", file=sys.stderr)
        return 1
    fs, samples, err = _fuse_rates(loaded, args.decimate, args.resample, args.device)
    if err:
        print(err, file=sys.stderr)
        return 1
    t = min(len(s) for s in samples)
    from apda_fft_tpu_torch.models.modal import fdd_segments

    if args.hop is not None and args.hop < 1:
        print(f"--hop must be >= 1, got {args.hop}", file=sys.stderr)
        return 1
    # Pre-check with the SAME framing arithmetic fdd() uses (incl. --hop).
    if fdd_segments(t, args.window, args.hop) < 2:
        print(f"need >= 2 segments: {t} common samples with "
              f"window={args.window}, hop={args.hop or args.window // 2}",
              file=sys.stderr)
        return 1
    records = np.stack([s[:t] for s in samples]).astype(np.float32)
    try:
        res = fdd(records, fs, args.window, args.hop, k=args.top,
                  efdd=args.efdd, harmonics=args.harmonics, device=args.device)
    except ValueError as exc:
        print(f"fdd failed: {exc}", file=sys.stderr)
        return 1

    n = int(res.count)
    hmask = res.harmonic_mask()
    modes = []
    for i in range(n):
        shape = [
            {"re": round(float(r), 4), "im": round(float(m), 4)}
            for r, m in zip(res.shape_re[i], res.shape_im[i])
        ]
        mode = {
            "freq": float(res.freq[i]),
            "damping_pct": float(res.damping[i]),
            "sv_ratio": round(float(res.sv_ratio[i]), 4),
            "shape": shape,
        }
        if args.efdd and np.isfinite(res.damping_efdd[i]):
            mode["damping_efdd_pct"] = round(float(res.damping_efdd[i]), 3)
        if args.harmonics and np.isfinite(res.kurtosis[i]):
            mode["kurtosis"] = round(float(res.kurtosis[i]), 3)
            mode["harmonic"] = bool(hmask[i])
        modes.append(mode)
    if args.json:
        print(json.dumps({
            "files": [p for p, _ in loaded], "fs": fs, "window": args.window,
            "modes": modes,
        }))
    else:
        print(f"FDD over {len(loaded)} sensors (fs={fs} Hz, window={args.window}):")
        if not modes:
            print("  no modes above threshold")
        for m in modes:
            comps = "  ".join(
                f"{c['re']:+.3f}{c['im']:+.3f}j" for c in m["shape"]
            )
            line = (f"  f={m['freq']:9.4f} Hz  damping={m['damping_pct']:.2f}%  "
                    f"s2/s1={m['sv_ratio']:.3f}  shape=[{comps}]")
            if "damping_efdd_pct" in m:
                line += f"  efdd={m['damping_efdd_pct']:.3f}%"
            if "kurtosis" in m:
                line += f"  kurt={m['kurtosis']:.2f}"
                if m["harmonic"]:
                    line += "  HARMONIC"
            print(line)
    return 0


def cmd_ssi(args) -> int:
    """Time-domain modal identification (SSI-COV) with stabilization.

    Takes simultaneously recorded acquisition files (one per sensor) and
    fits a stochastic state-space model to the output correlations: poles
    give off-grid eigenfrequencies and reliable damping ratios, shapes
    come with phase-collinearity physicality scores, and the
    stabilization diagram separates structure from noise — the
    time-domain complement to the ``fdd`` command.
    """
    from apda_fft_tpu_torch.models.ssi import ssi

    loaded = _load(args.files)
    if len(loaded) < 1:
        print("no analyzable files", file=sys.stderr)
        return 1
    fs, samples, err = _fuse_rates(loaded, args.decimate, args.resample, args.device)
    if err:
        print(err, file=sys.stderr)
        return 1
    t = min(len(s) for s in samples)
    if t < 8 * args.block_rows:
        print(f"records too short: {t} common samples for --block-rows "
              f"{args.block_rows} (need >= {8 * args.block_rows})", file=sys.stderr)
        return 1
    records = np.stack([s[:t] for s in samples]).astype(np.float32)
    max_order = (args.block_rows - 1) * records.shape[0]
    orders = range(2, min(max_order, args.max_order) + 1, 2)
    if not len(orders):
        print(f"--block-rows {args.block_rows} with {records.shape[0]} "
              f"sensor(s) supports no model order >= 2; raise --block-rows",
              file=sys.stderr)
        return 1
    try:
        res = ssi(records, fs, i=args.block_rows, orders=orders,
                  min_orders=args.min_orders, device=args.device)
    except ValueError as exc:
        print(f"ssi failed: {exc}", file=sys.stderr)
        return 1

    if args.out:
        # Stabilization diagram for offline plotting: per-pole rows
        # (order, freq, damping, stable) + Hankel singular values + the
        # final mode table.  Ragged per-order pole lists flatten into
        # parallel columns.
        order_col, f_col, z_col, s_col = [], [], [], []
        for d in res.diagram:
            order_col.extend([d["order"]] * len(d["freq"]))
            f_col.extend(d["freq"])
            z_col.extend(d["damping"])
            s_col.extend(d["stable"])
        np.savez(
            args.out,
            pole_order=np.asarray(order_col, np.int64),
            pole_freq=np.asarray(f_col, np.float64),
            pole_damping=np.asarray(z_col, np.float64),
            pole_stable=np.asarray(s_col, bool),
            hankel_sv=res.hankel_sv,
            mode_freq=res.freqs(),
            mode_damping=res.dampings(),
            mode_shapes=res.shapes(),
        )
        print(f"# wrote {args.out}", file=sys.stderr)

    kap = None
    if args.harmonics and res.modes:
        from apda_fft_tpu_torch.models.modal import harmonic_indicator

        try:
            kap = harmonic_indicator(
                records, fs, [m.freq for m in res.modes],
                window=min(1024, int(2 ** np.floor(np.log2(t)))), device=args.device,
            )
        except ValueError as exc:
            print(f"# harmonic check skipped: {exc}", file=sys.stderr)

    modes = []
    for j, m in enumerate(res.modes):
        modes.append({
            "freq": round(m.freq, 4),
            "damping_pct": round(m.damping, 3),
            "freq_std": round(m.freq_std, 4),
            "damping_std_pct": round(m.damping_std, 3),
            "n_orders": m.n_orders,
            "mpc": round(m.mpc, 4),
            "shape": [
                {"re": round(float(c.real), 4), "im": round(float(c.imag), 4)}
                for c in m.shape
            ],
        })
        if kap is not None and np.isfinite(kap[j]):
            modes[-1]["kurtosis"] = round(float(kap[j]), 3)
            modes[-1]["harmonic"] = bool(kap[j] < 2.2)
    if args.json:
        print(json.dumps({
            "files": [p for p, _ in loaded], "fs": fs,
            "block_rows": args.block_rows, "orders": [int(n) for n in res.orders],
            "modes": modes,
        }))
    else:
        print(f"SSI-COV over {len(loaded)} sensors (fs={fs} Hz, "
              f"i={args.block_rows}, orders {res.orders[0]}..{res.orders[-1]}):")
        if not modes:
            print("  no stabilized physical modes")
        for m in modes:
            comps = "  ".join(
                f"{c['re']:+.3f}{c['im']:+.3f}j" for c in m["shape"]
            )
            line = (f"  f={m['freq']:9.4f} Hz (±{m['freq_std']:.4f})  "
                    f"damping={m['damping_pct']:.3f}% (±{m['damping_std_pct']:.3f})  "
                    f"stable over {m['n_orders']} orders  mpc={m['mpc']:.3f}  "
                    f"shape=[{comps}]")
            if "kurtosis" in m:
                line += f"  kurt={m['kurtosis']:.2f}"
                if m["harmonic"]:
                    line += "  HARMONIC"
            print(line)
    return 0


def _load_oracle():
    """``tests/oracle.py`` of the repository checkout, loaded by path (another
    installed package may be named ``tests``); None outside a checkout."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "tests", "oracle.py")
    if not os.path.isfile(path):
        return None
    spec = importlib.util.spec_from_file_location("apda_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cmd_oracle_check(args) -> int:
    from apda_fft_tpu_torch import analyze_epoch
    from apda_fft_tpu_torch.ops.fft import next_pow2

    oracle = _load_oracle()
    if oracle is None:
        print("oracle-check needs the repo checkout (tests/oracle.py); "
              "run it from the repository root", file=sys.stderr)
        return 2

    loaded = _load(args.files)
    mismatches = 0
    for path, rec in loaded:
        n_fft = next_pow2(len(rec.samples))
        for mode in ("flexible", "rigid"):
            ref = oracle.oracle_analyze(rec.samples, rec.fs, mode=mode)
            samples = np.zeros((1, n_fft), np.float32)
            samples[0, : len(rec.samples)] = rec.samples
            res = analyze_epoch(
                samples, rec.fs, n_fft=n_fft, mode=mode,
                lengths=np.array([len(rec.samples)]), device=args.device,
            )
            got = [int(i) for i in _host(res.idx[0])[: int(res.count[0])]]
            want = [p["idx"] for p in ref]
            ok = got == want
            mismatches += 0 if ok else 1
            print(f"{path} [{mode}]: {'MATCH' if ok else f'MISMATCH got={got} want={want}'}")
    return 1 if mismatches else 0


def _numerics_checks() -> list[tuple[str, bool, str]]:
    """``doctor``'s numerics on the card: the N=256 magnitude spectrum
    against float64 numpy, and two on-bin tones through both detectors."""
    import torch

    from apda_fft_tpu_torch import analyze_epoch
    from apda_fft_tpu_torch.ops import fft as fft_ops

    checks = []
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    mags = _host(fft_ops.halfspec_magnitudes(
        torch.from_numpy(x - x.mean(-1, keepdims=True)).cuda(), backend="matmul"))
    xc = x.astype(np.float64) - x.astype(np.float64).mean(-1, keepdims=True)
    want = np.abs(np.fft.fft(xc, axis=-1))[:, :128]
    want[:, 0] = 0
    err = float(np.linalg.norm(mags - want) / np.linalg.norm(want))
    checks.append(("fft_accuracy", err <= 1e-6, f"normwise err {err:.2e} (<= 1e-6)"))

    # Detector end to end: two on-bin tones at fs=512/N=1024 -> exactly 2
    # peaks at 16.0 and 64.0 Hz in both modes.
    fs = 512.0
    t = np.arange(1024) / fs
    tone = (np.sin(2 * np.pi * 16.0 * t) + 0.5 * np.sin(2 * np.pi * 64.0 * t))
    for mode in ("flexible", "rigid"):
        res = analyze_epoch(tone[None].astype(np.float32), fs, mode=mode, max_candidates=8)
        got = sorted(_host(res.freq[0])[: int(res.count[0])].tolist())
        ok = got == [16.0, 64.0]
        checks.append((f"detector_{mode}", ok, f"peaks {got} (want [16.0, 64.0])"))
    return checks


def cmd_doctor(args) -> int:
    """Deployment diagnostics: device, kernels, native codec, numerics sanity.

    The operational analog of the reference's runtime self-checks
    (``GT_FFT_v5.py:663-676``): one command that verifies the stack a
    production gateway depends on, with the JAX package's check names and
    JSON shape.  Exit 0 iff every check passes.  Differences from the JAX
    package's ``doctor``:

    * ``device`` reports the CUDA device count and the first card's name;
    * ``kernels`` (new) builds or loads the five hand-written kernels (four
      libraries) through ``utils/kernels.py`` and names the build
      directory; a failed build is a failed check;
    * ``x64`` is "not applicable": the port has no global float64 switch;
    * ``compile_cache`` names the build cache in effect
      (``utils/compilecache.py``), or the package's build directory;
    * the numerics checks run on the card, and fail (with the reason) when
      there is none: the port does not fall back to the CPU.
    """
    import os

    import torch

    from apda_fft_tpu_torch.io import native
    from apda_fft_tpu_torch.ops import detector_cuda, fft_cuda, latency_cuda
    from apda_fft_tpu_torch.utils import compilecache, kernels

    checks: list[tuple[str, bool, str]] = []

    card = torch.cuda.is_available()
    n_dev = torch.cuda.device_count() if card else 0
    checks.append(("device", card,
                   f"{n_dev}x cuda ({torch.cuda.get_device_name(0)})" if card else
                   f"no CUDA device (torch {torch.__version__}, CUDA {torch.version.cuda})"))
    checks.append(("x64", True, "not applicable: the port computes in the dtype asked for"))

    if not card:
        checks.append(("kernels", False, "no CUDA device: kernels not built"))
    else:
        try:
            for build in (detector_cuda._kernel_fn, detector_cuda._scans_kernel_fn,
                          latency_cuda._kernel_fn, fft_cuda._kernel_fn):
                build()
            checks.append(("kernels", True, f"5 kernels (4 libraries) built or loaded in "
                                            f"{kernels.BUILD_DIR}"))
        except (RuntimeError, OSError) as exc:
            checks.append(("kernels", False, f"build failed in {kernels.BUILD_DIR}: {exc}"))

    if os.environ.get("APDA_NO_NATIVE") == "1":
        checks.append(("native_codec", True, "disabled via APDA_NO_NATIVE=1 "
                                             "(NumPy fallbacks active)"))
    else:
        lib = native.load()
        checks.append(("native_codec", True,
                       "loaded" if lib is not None else
                       "unavailable - NumPy fallbacks active (slower ingest)"))

    cache_dir = compilecache.enabled_dir()
    checks.append(("compile_cache", True,
                   cache_dir or f"not enabled: builds in {kernels.BUILD_DIR} (opt-in: gateway "
                                "compilation_cache_dir / enable_compilation_cache)"))

    if not card:
        for name in ("fft_accuracy", "detector_flexible", "detector_rigid"):
            checks.append((name, False, "no CUDA device: not run"))
    else:
        checks.extend(_numerics_checks())

    failed = [c for c in checks if not c[1]]
    if args.json:
        print(json.dumps({
            "ok": not failed,
            "checks": [{"name": n, "ok": ok, "detail": d} for n, ok, d in checks],
        }))
    else:
        for name, ok, detail in checks:
            print(f"[{'ok' if ok else 'FAIL'}] {name}: {detail}")
        print("all checks passed" if not failed else
              f"{len(failed)} check(s) FAILED")
    return 1 if failed else 0


def cmd_track(args) -> int:
    """Track modal peaks across a time-series of acquisition files."""
    import os as _os

    from apda_fft_tpu_torch.gateway.egress import timestamp_from_filename
    from apda_fft_tpu_torch.models.batching import analyze_records
    from apda_fft_tpu_torch.models.tracking import PeakTracker

    loaded = _load(args.files)
    if not loaded:
        print("no analyzable files", file=sys.stderr)
        return 1
    # Chronological order via the embedded filename timestamp (gateway
    # format {mac}_{axis}axis_{d_m_Y_H_M_S}.log); undated files sort first
    # in their argv order (stable sort).
    def _when(pr):
        ts = timestamp_from_filename(_os.path.basename(pr[0]))
        return ts.timestamp() if ts else 0.0

    loaded.sort(key=_when)
    records = [(np.asarray(rec.samples, np.float32), rec.fs) for _, rec in loaded]
    if args.welch:
        from apda_fft_tpu_torch.models.batching import analyze_records_welch

        per_record = analyze_records_welch(
            records, window=args.window, mode=args.mode, refine=True, device=args.device,
        )
    else:
        per_record = analyze_records(records, mode=args.mode, refine=True,
                                     device=args.device)

    trackers: dict[str, PeakTracker] = {}
    for (path, rec), rp in zip(loaded, per_record):
        key = f"{_os.path.basename(path).split('_')[0]}/{rec.axis}"
        tracker = trackers.setdefault(key, PeakTracker())
        ts = timestamp_from_filename(_os.path.basename(path))
        freqs, mags = [], []
        for slot in range(rp.count):
            refined = float(rp.result.refined_freq[rp.row, slot])
            freqs.append(refined if refined > 0 else rp.exact_freq(slot, args.mode))
            mags.append(float(rp.result.mag[rp.row, slot]))
        tracker.update_freqs(freqs, mags, t=ts.timestamp() if ts else None,
                             temp=rec.temperature)

    rc = 0
    for key, tracker in sorted(trackers.items()):
        print(f"{key}:")
        for tr in tracker.tracks(min_length=2):
            print(f"  track {tr.track_id}: {len(tr)} acquisitions, "
                  f"mean {tr.mean_freq:.3f} Hz, "
                  f"drift {tr.sustained_drift_relative() * 100:+.2f}%")
        for tr in tracker.alerts(rel_drift=args.rel_drift,
                                 min_length=args.min_epochs,
                                 compensate_temperature=args.temp_compensate):
            comp = (tr.compensated_drift_relative()
                    if args.temp_compensate else None)
            drift = comp if comp is not None else tr.sustained_drift_relative()
            qual = " (temp-adjusted)" if comp is not None else ""
            print(f"  ALERT: mode near {tr.mean_freq:.3f} Hz drifted "
                  f"{drift * 100:+.2f}%{qual} "
                  f"({tr.freqs[0]:.4f} -> {tr.freqs[-1]:.4f} Hz)")
            rc = 2
    return rc


def _device_arg(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="where the analysis runs (default: the CUDA card; 'cpu' "
                             "runs it on the CPU)")


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # The gateway daemon (the reference's primary entry point,
    # ``python GT_FFT_v5.py``) has its own argument parser in
    # ``apda_fft_tpu_torch.gateway.__main__``; forward to it verbatim so
    # ``python -m apda_fft_tpu_torch gateway --simulate`` works alongside
    # ``python -m apda_fft_tpu_torch.gateway --simulate``.  The subparser stub
    # below only provides --help discoverability.
    if argv and argv[0] == "gateway":
        from apda_fft_tpu_torch.gateway.__main__ import main as gateway_main

        gateway_main(argv[1:])
        return 0

    ap = argparse.ArgumentParser(prog="apda_fft_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    gw = sub.add_parser(
        "gateway",
        help="run the gateway daemon (real XBee hardware, or --simulate); "
             "see 'gateway --help' for its options",
    )
    gw.set_defaults(fn=None)

    a = sub.add_parser("analyze", help="batch-analyze acquisition log files")
    a.add_argument("files", nargs="+")
    a.add_argument("--mode", default="flexible", choices=["flexible", "rigid", "adaptive"])
    a.add_argument("--backend", default="matmul", choices=["xla", "matmul", "pallas"])
    a.add_argument("--refine", action="store_true")
    a.add_argument("--taper", default="none",
                   choices=["none", "hann", "hamming", "blackman"])
    a.add_argument("--json", action="store_true")
    _device_arg(a)
    a.set_defaults(fn=cmd_analyze)

    w = sub.add_parser("welch", help="Welch-averaged peak detection (noise-robust)")
    w.add_argument("files", nargs="+")
    w.add_argument("--window", type=int, default=1024,
                   help="segment length in samples (padded to next pow2)")
    w.add_argument("--hop", type=int, default=None,
                   help="segment hop (default: 50%% overlap)")
    w.add_argument("--taper", default="hann",
                   choices=["none", "hann", "hamming", "blackman"])
    w.add_argument("--mode", default="flexible", choices=["flexible", "rigid", "adaptive"])
    w.add_argument("--refine", action="store_true")
    w.add_argument("--json", action="store_true")
    _device_arg(w)
    w.set_defaults(fn=cmd_welch)

    sg = sub.add_parser("spectrogram", help="time-frequency magnitude spectrogram")
    sg.add_argument("files", nargs="+")
    sg.add_argument("--window", type=int, default=1024)
    sg.add_argument("--hop", type=int, default=None,
                    help="frame hop (default: non-overlapping)")
    sg.add_argument("--taper", default="hann",
                    choices=["none", "hann", "hamming", "blackman"])
    sg.add_argument("--out", default="",
                    help="also save freqs/mags arrays to this .npz file")
    sg.add_argument("--json", action="store_true")
    _device_arg(sg)
    sg.set_defaults(fn=cmd_spectrogram)

    co = sub.add_parser("coherence", help="two-sensor coherence report")
    co.add_argument("file_x")
    co.add_argument("file_y")
    co.add_argument("--window", type=int, default=1024)
    co.add_argument("--hop", type=int, default=None,
                    help="segment hop (default: 50%% overlap)")
    co.add_argument("--threshold", type=float, default=0.8,
                    help="minimum coherence for a reported band")
    co.add_argument("--top", type=int, default=8,
                    help="max coherent peaks reported")
    co.add_argument("--decimate", action="store_true",
                    help="anti-alias decimate the faster channel onto the "
                         "slower rate (integer ratios only)")
    co.add_argument("--resample", action="store_true",
                    help="like --decimate but also fuses rational rate "
                         "ratios via polyphase up/down resampling")
    co.add_argument("--json", action="store_true")
    _device_arg(co)
    co.set_defaults(fn=cmd_coherence)

    fd = sub.add_parser("fdd", help="multi-sensor modal analysis (FDD: modes + shapes)")
    fd.add_argument("files", nargs="+",
                    help="one simultaneously recorded log file per sensor")
    fd.add_argument("--window", type=int, default=1024,
                    help="CSD segment length (padded to next pow2)")
    fd.add_argument("--hop", type=int, default=None,
                    help="segment hop (default: 50%% overlap)")
    fd.add_argument("--top", type=int, default=4,
                    help="max modes reported")
    fd.add_argument("--efdd", action="store_true",
                    help="enhanced-FDD damping (autocorrelation log decrement)")
    fd.add_argument("--harmonics", action="store_true",
                    help="narrowband-kurtosis harmonic check per mode "
                         "(~1.5 = machinery harmonic, ~3 = structural mode)")
    fd.add_argument("--decimate", action="store_true",
                    help="anti-alias decimate faster channels onto the "
                         "slowest rate (integer ratios only)")
    fd.add_argument("--resample", action="store_true",
                    help="like --decimate but also fuses rational rate "
                         "ratios via polyphase up/down resampling")
    fd.add_argument("--json", action="store_true")
    _device_arg(fd)
    fd.set_defaults(fn=cmd_fdd)

    ss = sub.add_parser("ssi", help="time-domain modal identification "
                                    "(SSI-COV: poles, damping, stabilization)")
    ss.add_argument("files", nargs="+",
                    help="one simultaneously recorded log file per sensor")
    ss.add_argument("--block-rows", type=int, default=20, metavar="I",
                    help="Hankel block rows; correlation horizon = 2I/fs s")
    ss.add_argument("--max-order", type=int, default=60,
                    help="highest model order in the stabilization sweep")
    ss.add_argument("--min-orders", type=int, default=5,
                    help="orders a pole must stabilize across to be a mode")
    ss.add_argument("--out", default="",
                    help="also save the stabilization diagram (per-pole "
                         "order/freq/damping/stable columns), Hankel "
                         "singular values, and mode table to this .npz")
    ss.add_argument("--harmonics", action="store_true",
                    help="narrowband-kurtosis harmonic check per mode "
                         "(~1.5 = machinery harmonic, ~3 = structural mode)")
    ss.add_argument("--decimate", action="store_true",
                    help="anti-alias decimate faster channels onto the "
                         "slowest rate (integer ratios only)")
    ss.add_argument("--resample", action="store_true",
                    help="like --decimate but also fuses rational rate "
                         "ratios via polyphase up/down resampling")
    ss.add_argument("--json", action="store_true")
    _device_arg(ss)
    ss.set_defaults(fn=cmd_ssi)

    o = sub.add_parser("oracle-check", help="validate device decisions vs float64 oracle")
    o.add_argument("files", nargs="+")
    _device_arg(o)
    o.set_defaults(fn=cmd_oracle_check)

    dc = sub.add_parser("doctor", help="deployment diagnostics: device, kernels, "
                                       "native codec, numerics sanity")
    dc.add_argument("--json", action="store_true")
    dc.set_defaults(fn=cmd_doctor)

    tr = sub.add_parser("track", help="track modal drift across acquisition files")
    tr.add_argument("files", nargs="+")
    tr.add_argument("--mode", default="flexible", choices=["flexible", "rigid", "adaptive"])
    tr.add_argument("--rel-drift", type=float, default=0.02,
                    help="alert threshold (relative sustained drift)")
    tr.add_argument("--min-epochs", type=int, default=5)
    tr.add_argument("--welch", action="store_true",
                    help="Welch-average each acquisition before peak pick "
                         "(noise-robust tracking)")
    tr.add_argument("--window", type=int, default=1024,
                    help="Welch segment length (with --welch)")
    tr.add_argument("--temp-compensate", action="store_true",
                    help="alert on the temperature-model residual (the "
                         "acquisition files carry the sensor temperature); "
                         "tracks without an identifiable model use raw drift")
    _device_arg(tr)
    tr.set_defaults(fn=cmd_track)

    ps = sub.add_parser("psd", help="Welch power spectral density (units^2/Hz)")
    ps.add_argument("files", nargs="+")
    ps.add_argument("--window", type=int, default=1024)
    ps.add_argument("--hop", type=int, default=None,
                    help="segment hop (default: 50%% overlap)")
    ps.add_argument("--taper", default="hann",
                    choices=["none", "hann", "hamming", "blackman"])
    ps.add_argument("--top", type=int, default=8,
                    help="strongest bins printed")
    ps.add_argument("--out", default="",
                    help="also save freqs/psd arrays to this .npz file")
    ps.add_argument("--json", action="store_true")
    _device_arg(ps)
    ps.set_defaults(fn=cmd_psd)

    sr = sub.add_parser("srs", help="shock response spectrum of transient "
                        "records (maximax SDOF bank, damage potential)")
    sr.add_argument("files", nargs="+")
    sr.add_argument("--q", type=float, default=10.0,
                    help="oscillator quality factor (default 10)")
    sr.add_argument("--per-octave", type=int, default=6,
                    help="bank points per octave (default 6)")
    sr.add_argument("--fmin", type=float, default=0.0,
                    help="lowest natural frequency (default fs/100)")
    sr.add_argument("--fmax", type=float, default=0.0,
                    help="highest natural frequency (default fs/4)")
    sr.add_argument("--no-residual", action="store_true",
                    help="exclude the post-record free-decay phase")
    sr.add_argument("--out", default="",
                    help="save freqs/maximax/positive/negative/pv to .npz")
    sr.add_argument("--json", action="store_true")
    _device_arg(sr)
    sr.set_defaults(fn=cmd_srs)

    sv = sub.add_parser("severity", help="ISO 10816/20816 vibration severity "
                        "(band-limited velocity RMS, mm/s)")
    sv.add_argument("files", nargs="+")
    sv.add_argument("--flo", type=float, default=10.0,
                    help="band low edge in Hz (ISO default 10)")
    sv.add_argument("--fhi", type=float, default=1000.0,
                    help="band high edge in Hz (clamped to Nyquist)")
    sv.add_argument("--limit", type=float, default=0.0,
                    help="flag records at/above this mm/s (0 = report only)")
    sv.add_argument("--json", action="store_true")
    _device_arg(sv)
    sv.set_defaults(fn=cmd_severity)

    ig = sub.add_parser("integrate", help="frequency-domain integration: "
                        "velocity or displacement traces")
    ig.add_argument("files", nargs="+")
    ig.add_argument("--quantity", choices=("velocity", "displacement"),
                    default="velocity")
    ig.add_argument("--highpass", type=float, default=0.0,
                    help="high-pass cut in Hz (0 = default 8 bins)")
    ig.add_argument("--mms", action="store_true",
                    help="convert g-based units to mm/s (or mm)")
    ig.add_argument("--out", default="",
                    help="save integrated traces to .npz")
    ig.add_argument("--json", action="store_true")
    _device_arg(ig)
    ig.set_defaults(fn=cmd_integrate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
