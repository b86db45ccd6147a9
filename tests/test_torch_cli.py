"""The port's command line (``python -m apda_fft_tpu_torch``) against the JAX
package's, on the CPU.

Every analysing subcommand runs with the same arguments on the same log
files (written with the port's ``io/logfile.py``) through
``apda_fft_tpu.__main__.main`` and through the port's ``main`` with
``--device cpu``; exit codes and output lines are compared.  JSON lines:
keys, strings, integers and booleans equal; every float within 2e-5
relative plus 1e-5 absolute (float32 results of two implementations), plus
one rounding step where the CLI (mode shapes, ratios, kurtosis, SSI
statistics, severity) or the reference's detector (frequencies,
magnitudes, damping, Q) rounds it; SSI dampings under the rule of
``tests/test_torch_ssi.py`` (rtol 1e-2 plus the cluster's spread).  Text
lines: the same words and integers, every other printed number within one
step of its last printed digit plus 2e-5 relative (the rule of
``tests/test_torch_gateway_parity.py``'s ``lines_close``, here also for
numbers in e-notation).
Then the port analogues of ``tests/test_cli_and_transport.py``.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from apda_fft_tpu.__main__ import main as jax_main
from apda_fft_tpu_torch.__main__ import main as port_main
from apda_fft_tpu_torch.io import logfile
from tests.signals import two_mode_signal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 500.0
#: Floats rounded before printing, by JSON key: by the CLIs (``__main__.py``)
#: or by the reference's detector (4-dp frequencies and magnitudes, 2-dp
#: damping and Q; float32 may land on either side of a tie).
ROUND_STEP = {"re": 1e-4, "im": 1e-4, "sv_ratio": 1e-4, "damping_efdd_pct": 1e-3,
              "kurtosis": 1e-3, "freq_std": 1e-4, "damping_std_pct": 1e-3, "mpc": 1e-4,
              "velocity_rms_mms": 1e-4, "freq": 1e-4, "mag": 1e-4, "damping": 1e-2,
              "q_factor": 1e-2, "damping_pct": 1e-2}


def _write_log(path, x, fs=FS):
    logfile.write_acquisition_header(
        path, "10:20:30", "2g", f"{fs:g} Hz", "X axis", "Synced",
        means=["22.0", "0.01", "0.01", "0.98"], humidity=50.0, baselines=(0.0, 0.0, 0.0),
    )
    logfile.append_samples(path, [f"{v:8.6f}" for v in x])
    return str(path)


def _resonator(f, zeta, n, rng):
    """White noise through a two-pole resonator at ``f`` Hz (a randomly
    excited structural mode)."""
    w = 2 * np.pi * f / FS
    r = np.exp(-zeta * w)
    y = np.zeros(n + 2)
    e = rng.standard_normal(n)
    for t in range(n):
        y[t + 2] = (1 - r) * e[t] + 2 * r * np.cos(w) * y[t + 1] - r * r * y[t]
    y = y[2:]
    return y / y.std()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four simultaneous sensors (three randomly excited modes with known
    shapes, 8192 samples), a shock transient, and six dated acquisitions
    of a drifting mode."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(7)
    n = 8192
    shapes = np.array([[1.0, 0.8, 0.5, 0.2], [1.0, -0.3, -0.9, 0.6], [0.4, 1.0, -0.7, 0.9]])
    drives = [_resonator(f, 0.01, n, rng) for f in (12.3, 33.8, 71.4)]
    sensors = []
    for s in range(4):
        x = sum(shapes[m, s] * drives[m] for m in range(3)) + 0.1 * rng.standard_normal(n)
        sensors.append(_write_log(d / f"0013a20041e7f6b{s}_Xaxis_16_08_2026_10_20_3{s}.log", x))
    t = np.arange(2048) / FS
    shock = _write_log(d / "0013a20041e7f6c0_Xaxis_16_08_2026_10_21_00.log",
                       np.exp(-3.0 * t) * np.sin(2 * np.pi * 40.0 * t) * 5.0)
    track = []
    t = np.arange(1024) / FS
    for e in range(6):
        f1 = 25.0 * (1 - 0.01 * e)  # 1 %/acquisition drift
        x = np.sin(2 * np.pi * f1 * t) + 0.6 * np.sin(2 * np.pi * 47.7 * t)
        track.append(_write_log(d / f"0013a20041e7f6b7_Xaxis_1{e}_08_2026_10_20_30.log", x))
    return {"sensors": sensors, "shock": shock, "track": track}


_NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _lines_close(a: str, b: str) -> bool:
    """Two text lines equal up to their printed precision (module docstring)."""
    na, nb = _NUM.findall(a), _NUM.findall(b)
    if _NUM.sub("#", a) != _NUM.sub("#", b) or len(na) != len(nb):
        return False
    for x, y in zip(na, nb):
        if x == y:
            continue
        mant, _, exp = x.partition("e")
        if "." not in mant or "." not in y:
            return False
        step = 10.0 ** (int(exp or 0) - len(mant.split(".")[1]))
        if abs(float(x) - float(y)) > 1.01 * step + 2e-5 * abs(float(y)):
            return False
    return True


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


def _assert_json_close(a, b, where="", key="", ssi=False):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, sorted(a), sorted(b))
        spread = {"freq": b.get("freq_std", 0.0), "damping_pct": b.get("damping_std_pct", 0.0)}
        for k in a:
            if ssi and k in spread and isinstance(a[k], float):
                rtol = 2e-5 if k == "freq" else 1e-2
                assert abs(a[k] - b[k]) <= rtol * abs(b[k]) + spread[k] + 1.01e-4, (where, k)
            else:
                _assert_json_close(a[k], b[k], f"{where}/{k}", k, ssi)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_json_close(x, y, f"{where}[{i}]", key, ssi)
    elif isinstance(a, float) or isinstance(b, float):
        assert not isinstance(a, bool) and not isinstance(b, bool), (where, a, b)
        tol = 1.01 * ROUND_STEP.get(key, 0.0) + 2e-5 * abs(b) + 1e-5
        assert a == b or abs(a - b) <= tol, (where, a, b)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _json_cases(c):
    s, sh = c["sensors"], c["shock"]
    return {
        "analyze": ["analyze", *s, "--json", "--refine"],
        "analyze-rigid": ["analyze", *s, "--json", "--mode", "rigid"],
        "analyze-adaptive-hann": ["analyze", *s, "--json", "--mode", "adaptive", "--taper",
                                  "hann"],
        "welch": ["welch", *s, "--json", "--refine", "--window", "512"],
        "spectrogram": ["spectrogram", s[0], "--json"],
        "psd": ["psd", *s[:2], "--json", "--window", "512"],
        "coherence": ["coherence", s[0], s[1], "--json"],
        "fdd": ["fdd", *s, "--json", "--efdd", "--harmonics"],
        "ssi": ["ssi", *s, "--json", "--block-rows", "12", "--harmonics"],
        "srs": ["srs", sh, "--json"],
        "severity": ["severity", *s, sh, "--json", "--limit", "20"],
        "integrate": ["integrate", s[0], "--json", "--mms"],
    }


@pytest.mark.parametrize("case", list(_json_cases({"sensors": [""] * 4, "shock": ""})))
def test_json_lines_match_the_jax_cli(corpus, case):
    argv = _json_cases(corpus)[case]
    rc_j, out_j = _run(jax_main, argv)
    rc_p, out_p = _run(port_main, argv + ["--device", "cpu"])
    assert rc_p == rc_j == 0
    assert len(out_p) == len(out_j) > 0
    for a, b in zip(out_p, out_j):
        _assert_json_close(json.loads(a), json.loads(b), case, ssi=case == "ssi")


def _text_cases(c):
    s = c["sensors"]
    return {
        "analyze": ["analyze", *s, "--refine"],
        "oracle-check": ["oracle-check", *s[:2], c["shock"]],
        "track": ["track", *c["track"], "--rel-drift", "0.02"],
        "track-welch": ["track", *c["track"], "--welch", "--window", "512", "--mode", "adaptive"],
        "fdd": ["fdd", *s, "--efdd"],
        "coherence-decimated": ["coherence", s[0], s[1], "--decimate"],
        "psd": ["psd", s[0]],
        "integrate": ["integrate", s[0], "--quantity", "displacement"],
    }


@pytest.mark.parametrize("case", list(_text_cases({"sensors": [""] * 4, "shock": "",
                                                   "track": []})))
def test_text_lines_match_the_jax_cli(corpus, case):
    argv = _text_cases(corpus)[case]
    rc_j, out_j = _run(jax_main, argv)
    rc_p, out_p = _run(port_main, argv + ["--device", "cpu"])
    assert rc_p == rc_j
    assert len(out_p) == len(out_j) > 0
    bad = [(a, b) for a, b in zip(out_p, out_j) if not _lines_close(a, b)]
    assert not bad, bad[:3]


def test_analysis_runs_on_the_card_by_default(corpus, monkeypatch):
    """Without ``--device`` the analysis goes to the card, and without one
    it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["analyze", corpus["sensors"][0]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["severity", corpus["sensors"][0]])


def test_module_entry_point(corpus):
    proc = subprocess.run(
        [sys.executable, "-m", "apda_fft_tpu_torch", "analyze", corpus["sensors"][0], "--json",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["n_fft"] == 8192 and len(out["peaks"]) >= 3


# ---------------------------------------------- tests/test_cli_and_transport.py


@pytest.fixture
def log_file(tmp_path):
    return _write_log(tmp_path / "0013a20041e7f6b7_Xaxis_16_08_2026_10_20_30.log",
                      two_mode_signal(1024, 500.0))


def test_cli_analyze_json(log_file, capsys):
    assert port_main(["analyze", log_file, "--json", "--refine", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["fs"] == 500.0 and out["n_fft"] == 1024
    freqs = [p["freq"] for p in out["peaks"]]
    assert any(abs(f - 12.207) < 0.3 for f in freqs)
    assert all("refined_freq" in p for p in out["peaks"])


def test_cli_analyze_text_and_modes(log_file, capsys):
    assert port_main(["analyze", log_file, "--mode", "rigid", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "f=" in text and "mag=" in text
    assert port_main(["analyze", log_file, "--taper", "hann", "--device", "cpu"]) == 0
    assert "f=" in capsys.readouterr().out


def test_cli_track_reports_drift(tmp_path, capsys):
    fs, n = 500.0, 1024
    t = np.arange(n) / fs
    paths = []
    for e in range(6):
        f1 = 25.0 * (1 - 0.01 * e)
        x = np.sin(2 * np.pi * f1 * t) + 0.6 * np.sin(2 * np.pi * 47.7 * t)
        paths.append(_write_log(tmp_path / f"0013a20041e7f6b7_Xaxis_1{e}_08_2026_10_20_30.log",
                                x))
    rc = port_main(["track", *paths, "--rel-drift", "0.02", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 2  # alert fired
    assert "ALERT" in out and "drifted" in out
    assert "0013a20041e7f6b7/X" in out


def test_cli_oracle_check(log_file, capsys):
    assert port_main(["oracle-check", log_file, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("MATCH") == 2 and "MISMATCH" not in out


def test_cli_skips_corrupt(tmp_path, capsys):
    bad = tmp_path / "bad.log"
    bad.write_text("x\n")
    assert port_main(["analyze", str(bad), "--device", "cpu"]) == 1


class _FakeRemote:
    def get_64bit_addr(self):
        return "0013A20041E7F6B7"


class _FakeMessage:
    def __init__(self, data):
        self.data = data
        self.remote_device = _FakeRemote()


class _FakeDevice:
    def __init__(self):
        self.inbox = [_FakeMessage(b"\xa1\x01\x02")]
        self.sent = []
        self._open = False

    def open(self):
        self._open = True

    def is_open(self):
        return self._open

    def close(self):
        self._open = False

    def read_data(self, timeout=None):
        return self.inbox.pop(0) if self.inbox else None

    def send_data(self, remote, payload):
        self.sent.append((remote, payload))


def test_xbee_transport_with_mocked_vendor_stack(monkeypatch):
    """The port's XBeeTransport against a fake ``digidevice`` module."""
    fake_dev = _FakeDevice()
    fake_xbee = types.SimpleNamespace(get_device=lambda: fake_dev)
    monkeypatch.setitem(sys.modules, "digidevice", types.SimpleNamespace(xbee=fake_xbee))

    from apda_fft_tpu_torch.gateway.transport import XBeeTransport

    logs = []
    t = XBeeTransport(timeout=1)
    t.start(logs.append)
    assert fake_dev.is_open()
    payload, addr = t.receive(logs.append)
    assert payload == b"\xa1\x01\x02"
    assert addr == "0013a20041e7f6b7"  # lowercased 64-bit MAC
    assert t.send(addr, "a1ff", logs.append) is True
    assert fake_dev.sent[0][1] == bytes.fromhex("a1ff")
    assert t.send("feedfacefeedface", "a1", logs.append) is False
    assert any("unknown device" in s for s in logs)
    assert t.receive(logs.append) == (None, None)
    t.stop(logs.append)
    assert not fake_dev.is_open()


def test_gateway_simulate_smoke(tmp_path, capsys):
    from apda_fft_tpu_torch.gateway.__main__ import _simulate

    _simulate(2, str(tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "processed" in out and "2 sensors" in out
    assert "Peaks: X f1:" in out and "Peaks: Y f1:" in out
    assert "[FTP:sim] would upload" in out


def _doctor(capsys):
    rc = port_main(["doctor", "--json"])
    return rc, json.loads(capsys.readouterr().out.strip())


def test_doctor_reports_every_check(capsys):
    """``doctor --json`` keeps the JAX package's check names and JSON shape.
    On a card every check passes; without one the device, kernel and
    numerics checks fail with the reason and the exit code is 1 (the port
    does not fall back to the CPU)."""
    rc, rep = _doctor(capsys)
    names = [c["name"] for c in rep["checks"]]
    assert names == ["device", "x64", "kernels", "native_codec", "compile_cache",
                     "fft_accuracy", "detector_flexible", "detector_rigid"]
    assert set(rep) == {"ok", "checks"}
    failed = {c["name"] for c in rep["checks"] if not c["ok"]}
    if torch.cuda.is_available():
        assert rc == 0 and rep["ok"] is True and not failed
    else:
        assert rc == 1 and rep["ok"] is False
        assert failed == {"device", "kernels", "fft_accuracy", "detector_flexible",
                          "detector_rigid"}
        assert all("no CUDA device" in c["detail"] for c in rep["checks"]
                   if c["name"] in failed)
    assert "not applicable" in next(c for c in rep["checks"] if c["name"] == "x64")["detail"]


def test_doctor_reports_a_failed_kernel_build(capsys, monkeypatch):
    """A kernel that does not build is a failed check (exit 1), not skipped."""
    from apda_fft_tpu_torch.ops import detector_cuda

    def broken():
        raise RuntimeError("nvcc failed on prominence_select_scan.cu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "a test card")
    monkeypatch.setattr(detector_cuda, "_kernel_fn", broken)
    monkeypatch.setattr("apda_fft_tpu_torch.__main__._numerics_checks", lambda: [])
    rc, rep = _doctor(capsys)
    kern = next(c for c in rep["checks"] if c["name"] == "kernels")
    assert rc == 1 and rep["ok"] is False
    assert not kern["ok"] and "nvcc failed" in kern["detail"]


def test_doctor_respects_no_native(capsys, monkeypatch):
    monkeypatch.setenv("APDA_NO_NATIVE", "1")
    _, rep = _doctor(capsys)
    native = next(c for c in rep["checks"] if c["name"] == "native_codec")
    assert native["ok"] and "APDA_NO_NATIVE" in native["detail"]


def test_top_level_gateway_passthrough(monkeypatch):
    """``python -m apda_fft_tpu_torch gateway ...`` forwards verbatim to the
    gateway CLI."""
    import apda_fft_tpu_torch.__main__ as top
    import apda_fft_tpu_torch.gateway.__main__ as gw

    calls = []
    monkeypatch.setattr(gw, "main", lambda argv=None: calls.append(argv))
    assert top.main(["gateway", "--simulate", "--sensors", "3", "--device", "cpu"]) == 0
    assert calls == [["--simulate", "--sensors", "3", "--device", "cpu"]]
    with pytest.raises(SystemExit):
        top.main(["--help"])


def test_cli_severity(log_file, capsys):
    rc = port_main(["severity", log_file, "--json", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["velocity_rms_mms"] > 0
    assert out["band_hz"] == [10.0, 250.0]  # fhi clamped to Nyquist
    assert port_main(["severity", log_file, "--limit", "0.001", "--device", "cpu"]) == 0
    assert "** OVER LIMIT **" in capsys.readouterr().out
    assert port_main(["severity", log_file, "--flo", "400", "--device", "cpu"]) == 1


def test_cli_integrate(log_file, tmp_path, capsys):
    out_npz = str(tmp_path / "vel.npz")
    rc = port_main(["integrate", log_file, "--json", "--mms", "--out", out_npz,
                    "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["quantity"] == "velocity" and out["unit"] == "mm/s"
    assert out["mid_peak"] > 0
    data = np.load(out_npz)
    key = [k for k in data.files if k.endswith("velocity")][0]
    assert data[key].shape == (1024,)
    assert port_main(["integrate", log_file, "--quantity", "displacement",
                      "--device", "cpu"]) == 0
    assert "displacement mid-peak" in capsys.readouterr().out


def test_cli_srs_rejects_bad_per_octave(log_file, capsys):
    assert port_main(["srs", log_file, "--per-octave", "0", "--device", "cpu"]) == 1
    assert "per-octave" in capsys.readouterr().err
