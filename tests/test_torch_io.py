"""The port's ``io/*`` against the JAX package's.

The checks of ``tests/test_io.py`` and ``tests/test_native.py``, each held
against the JAX package on the same inputs (made from a numpy seed): half
floats, every packet encoder and parser, the log-file writer, loader and
in-memory builder, and the native ingest (decode, format, parse, fused
append on a path and on a kept fd, quantize).  Bytes written to files are
equal, and decoded and quantized samples bit-equal, on the native route
and on the ``APDA_NO_NATIVE=1`` route.
"""

import filecmp
import os
from datetime import datetime, timezone

import numpy as np
import pytest

from apda_fft_tpu.io import halffloat as jhalf
from apda_fft_tpu.io import logfile as jlog
from apda_fft_tpu.io import native as jnat
from apda_fft_tpu.io import packets as jpk
from apda_fft_tpu_torch.io import halffloat as thalf
from apda_fft_tpu_torch.io import logfile as tlog
from apda_fft_tpu_torch.io import native as tnat
from apda_fft_tpu_torch.io import packets as tpk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_WORDS = np.arange(65536, dtype=np.uint32).astype(np.uint16)
SPECIALS = np.array([0x7C00, 0xFC00, 0x7C01, 0x0001, 0x8001, 0x8000], np.uint16)
NOW = datetime(2026, 8, 16, 22, 45, 39, 123000, tzinfo=timezone.utc)


def _bits_equal(a, b) -> None:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64))


@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    """The native codec, or the NumPy fallback forced by APDA_NO_NATIVE=1."""
    if request.param == "python":
        monkeypatch.setenv("APDA_NO_NATIVE", "1")
        assert not tnat.available() and not jnat.available()
    else:
        monkeypatch.delenv("APDA_NO_NATIVE", raising=False)
        if not (tnat.available() and jnat.available()):
            pytest.fail("native codec did not build (g++ missing?)")
    return request.param


def test_host_source_is_the_reference_copy():
    """The port ships its own copy of the C++ ingest, byte-equal to
    ``csrc/apda_io.cc``."""
    assert filecmp.cmp(os.path.join(ROOT, "apda_fft_tpu_torch", "csrc", "host", "apda_io.cc"),
                       os.path.join(ROOT, "csrc", "apda_io.cc"), shallow=False)


def test_native_library_builds_in_the_port(monkeypatch):
    monkeypatch.delenv("APDA_NO_NATIVE", raising=False)
    assert tnat.available()
    path = tnat._library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(ROOT, "apda_fft_tpu_torch", "_build")


# ---------------------------------------------------------------- half floats


def test_half_words_bit_equal():
    _bits_equal(thalf.decode_half_words(ALL_WORDS), jhalf.decode_half_words(ALL_WORDS))


@pytest.mark.parametrize("first", [0.0, 0.5, 0.1234567])
def test_half_payloads_and_formatting_equal(first):
    rng = np.random.default_rng(1)
    vals = rng.uniform(-4, 4, 257)
    raw = jhalf.encode_halves(vals) + SPECIALS.astype(">u2").tobytes() + b"\x01"
    assert thalf.encode_halves(vals) == jhalf.encode_halves(vals)
    _bits_equal(thalf.decode_payload(raw, first), jhalf.decode_payload(raw, first))
    assert thalf.decode_samples(raw, first) == jhalf.decode_samples(raw, first)
    dec = jhalf.decode_payload(raw, first)
    assert thalf.format_samples(dec) == jhalf.format_samples(dec)
    finite = dec[np.isfinite(dec)]
    _bits_equal(thalf.quantize_like_log(finite), jhalf.quantize_like_log(finite))


# ---------------------------------------------------------------- packets


def _sync_kw(rng):
    return dict(battery_v=float(rng.uniform(2.5, 4.2)), rssi_db=int(rng.integers(30, 100)),
                temp_c=float(rng.uniform(-20, 60)), humidity=float(rng.uniform(0, 100)),
                gps_status=int(rng.integers(0, 2)),
                errors={"362": int(rng.integers(0, 3)), "mem": int(rng.integers(0, 3))},
                reset_bit=int(rng.integers(0, 4)), now=NOW)


@pytest.mark.parametrize("seed", range(4))
def test_encoders_byte_equal(seed):
    rng = np.random.default_rng(seed)
    kw = _sync_kw(rng)
    assert tpk.encode_sync_request(**kw) == jpk.encode_sync_request(**kw)
    x = rng.normal(0, 0.5, 200)
    for fs in (31.25, 62.5, 125.0, 250.0, 500.0):
        for axis in "XYZ":
            skw = dict(fs=fs, axis=axis, range_g=str(rng.choice(["2g", "4g", "8g"])),
                       sync_state=int(rng.integers(0, 3)),
                       baselines=tuple(rng.normal(0, 1, 3)), now=NOW)
            assert tpk.encode_start_stream(x, **skw) == jpk.encode_start_stream(x, **skw)
            assert tpk.encode_reduced(x, fs=fs, axis=axis) == jpk.encode_reduced(x, fs=fs,
                                                                                  axis=axis)
    for number in (2, 3, 513, 65535):
        assert tpk.encode_mid_stream(x, number) == jpk.encode_mid_stream(x, number)
        assert tpk.encode_end_stream(x, number) == jpk.encode_end_stream(x, number)
    assert tpk.encode_shock(x, now=NOW) == jpk.encode_shock(x, now=NOW)
    for delay in (0, 2, 4, 250):
        for legacy in (True, False):
            assert tpk.build_sync_packet(delay, now=NOW, legacy_minute55=legacy) == \
                jpk.build_sync_packet(delay, now=NOW, legacy_minute55=legacy)
    for cfg in ("2g 500Hz XY 8k 2h SYNC1 4g 250Hz Z 2k 10 1500 4 8g 50Hz ODR2 N",
                "8g 31_25Hz YZ 16k 6h SYNC1 2g 125Hz X 4k 3 200 2 2g 12_5Hz ODR2 L",
                "2g 500Hz"):
        assert tpk.build_config_packet(cfg, delay=2, now=NOW) == \
            jpk.build_config_packet(cfg, delay=2, now=NOW)


def _outcome(fn, payload):
    try:
        return "ok", fn(payload)
    except Exception as exc:  # noqa: BLE001 - the same failure on both sides
        return "raised", type(exc).__name__


def _same_outcome(a, b) -> None:
    assert a[0] == b[0], (a, b)
    if a[0] == "raised":
        assert a[1] == b[1]
    elif isinstance(a[1], np.ndarray):
        _bits_equal(a[1], b[1])
    elif hasattr(a[1], "__dataclass_fields__"):
        assert vars(a[1]) == vars(b[1])
    else:
        assert a[1] == b[1]


@pytest.mark.parametrize("seed", range(3))
def test_parsers_equal_on_packets_and_garbage(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, 120)
    good = [jpk.encode_sync_request(**_sync_kw(rng)),
            jpk.encode_start_stream(x, fs=250.0, axis="Y", baselines=(0.1, -0.5, 1.0), now=NOW),
            jpk.encode_mid_stream(x, 7), jpk.encode_end_stream(x, 9),
            jpk.encode_reduced(x, fs=125.0, axis="Z"), jpk.encode_shock(x, now=NOW)]
    payloads = list(good)
    for p in good:  # radio-truncated copies
        payloads += [p[:cut] for cut in (1, 3, 7, 12, 18, 31, 35, 37) if cut < len(p)]
    payloads += [bytes([lead]) + rng.bytes(int(rng.integers(0, 40)))
                 for lead in (0xA1, 0xD1, 0xD2, 0xD3, 0xD4, 0xC1, 0x00, 0xFF) for _ in range(4)]
    parsers = ("parse_sync_info", "parse_start_header", "parse_reduced_header",
               "parse_shock_header", "packet_number")
    for p in payloads:
        for name in parsers:  # the service hands them list(payload)
            _same_outcome(_outcome(getattr(tpk, name), list(p)),
                          _outcome(getattr(jpk, name), list(p)))
        for offset in (3, 4, 11, 23, 31):
            _same_outcome(_outcome(lambda q: tpk.decode_stream_samples(q, offset, 0.25), p),
                          _outcome(lambda q: jpk.decode_stream_samples(q, offset, 0.25), p))


# ---------------------------------------------------------------- log files


def _write_log(mod, path, rng_seed: int) -> None:
    rng = np.random.default_rng(rng_seed)
    mod.write_acquisition_header(path, "10:20:30", "2g", "500 Hz", "X axis", "Synced",
                                 means=["22.010000", "0.012000", "0.013000", "0.980000"],
                                 humidity=45.5, baselines=(0.1, 0.2, 0.3))
    mod.append_samples(path, ["0.500000", "-0.250000", "nan", "0.750000"])
    mod.append_marker(path, "* MISSING PACKETS FROM 3 TO 4 *;")
    mod.append_sample_values(path, rng.normal(0, 1, 300))
    mod.append_marker(path, "* INCOMPLETE TRANSMISSION *;")
    mod.append_sample_values(path, np.array([1e300, -1e25, 1.25]))


def test_logfile_bytes_and_loader_equal(tmp_path, route):
    paths = {}
    for name, mod in (("jax", jlog), ("torch", tlog)):
        paths[name] = tmp_path / f"{name}_0013a20041e7f6b7_Xaxis_16_08_2026_10_20_30.log"
        _write_log(mod, paths[name], 5)
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()
    got, want = tlog.load_sensor_log(paths["torch"]), jlog.load_sensor_log(paths["jax"])
    assert got.as_dict()["metadata"] == want.as_dict()["metadata"]
    assert got.as_dict()["summary"] == want.as_dict()["summary"]
    assert isinstance(got.samples, list) and got.samples == want.samples
    _bits_equal(tlog.samples_array(got), jlog.samples_array(want))
    short = tmp_path / "short.log"
    short.write_text("a;\nb;\n")
    assert tlog.load_sensor_log(short) is None and jlog.load_sensor_log(short) is None


def test_builder_matches_the_jax_builder_and_the_file(tmp_path, route):
    """The in-memory record (memory feed) equals the JAX package's and the
    file re-parse, bit for bit, including special values."""
    rng = np.random.default_rng(3)
    lines = tlog.acquisition_header_lines(
        "16/08/2026, 09:00:00", "2g", "250 Hz", "X axis", "Synced",
        means=["21.500000", "0.010000", "0.010000", "0.980000"],
        humidity=0.5, baselines=(0.125, 0.0, 0.0))
    assert lines == jlog.acquisition_header_lines(
        "16/08/2026, 09:00:00", "2g", "250 Hz", "X axis", "Synced",
        means=["21.500000", "0.010000", "0.010000", "0.980000"],
        humidity=0.5, baselines=(0.125, 0.0, 0.0))
    builders = {"jax": jlog.SensorLogBuilder(lines), "torch": tlog.SensorLogBuilder(lines)}
    nat = {"jax": jnat, "torch": tnat}
    for name in builders:
        with open(tmp_path / f"{name}.log", "w") as fh:
            fh.writelines(lines)
    for k in range(4):
        raw = jhalf.encode_halves(rng.normal(0, 0.1, 97)) + (
            SPECIALS.astype(">u2").tobytes() if k == 2 else b"")
        for name, b in builders.items():
            q = nat[name].append_half_payload_quantized(str(tmp_path / f"{name}.log"), raw, 0.125)
            if q is None:  # the fallback two-step
                vals = (jhalf if name == "jax" else thalf).decode_payload(raw, 0.125)
                (jlog if name == "jax" else tlog).append_sample_values(tmp_path / f"{name}.log",
                                                                       vals)
                q = nat[name].quantize_parse(vals)
            b.append(q)
    assert (tmp_path / "jax.log").read_bytes() == (tmp_path / "torch.log").read_bytes()
    got, want = builders["torch"].finish(), builders["jax"].finish()
    _bits_equal(got.samples, want.samples)
    _bits_equal(got.samples, tlog.load_sensor_log(tmp_path / "torch.log").samples)
    assert len(got.samples) == 4 * 97 + 3  # inf, -inf (read +inf) and nan dropped
    assert got.as_dict()["metadata"] == want.as_dict()["metadata"]
    assert tlog.SensorLogBuilder(lines).finish() is None


# ---------------------------------------------------------------- native ingest


def test_decode_format_parse_equal(route):
    raw = ALL_WORDS.astype(">u2").tobytes()
    for first in (0.0, 0.25):
        _bits_equal(tnat.decode_payload(raw, first), jnat.decode_payload(raw, first))
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.uniform(-10, 10, 500), [0.0, -0.0000005, 1e-7, 1e300, -1e25]])
    assert tnat.format_samples(vals) == jnat.format_samples(vals)
    text = ("0.500000;-0.250000;nan;* MISSING PACKETS FROM 2 TO 3 *;0.750000;\n"
            "inf;1.250000;bad1.5;  2.5  ;;" + ";".join(["1"] * 40) + ";" + "1" * 64
            + ";0x1A;" + "1" * 62 + "e10;" + tnat.format_samples(vals))
    _bits_equal(tnat.parse_samples(text), jnat.parse_samples(text))
    _bits_equal(tnat.quantize_parse(vals), jnat.quantize_parse(vals))


def test_fused_appends_equal(tmp_path, route):
    rng = np.random.default_rng(9)
    raw = bytes(jhalf.encode_halves(rng.normal(0.0, 0.4, 150))) + SPECIALS.astype(
        ">u2").tobytes() + b"\x7f"
    out = {}
    for name, nat in (("jax", jnat), ("torch", tnat)):
        p_path, p_q, p_fd = (tmp_path / f"{name}_{k}.log" for k in ("path", "q", "fd"))
        for p in (p_path, p_q, p_fd):
            p.write_text("hdr;\n")
        n = nat.append_half_payload(p_path, raw, 0.1234567)
        q = nat.append_half_payload_quantized(str(p_q), raw, 0.1234567)
        fd = os.open(p_fd, os.O_WRONLY | os.O_APPEND)
        try:
            qfd = nat.append_half_payload_quantized_fd(fd, raw, 0.1234567)
            nfd = nat.append_half_payload_quantized_fd(fd, raw, 0.1234567, quantize=False)
        finally:
            os.close(fd)
        out[name] = (n, q, qfd, nfd, p_path.read_bytes(), p_q.read_bytes(), p_fd.read_bytes())
    (tn, tq, tqfd, tnfd, *tbytes), (jn, jq, jqfd, jnfd, *jbytes) = out["torch"], out["jax"]
    assert (tn, tnfd) == (jn, jnfd) and tbytes == jbytes
    if route == "python":
        assert tn is tq is tqfd is None  # the caller runs the two-step
    else:
        assert tn == 156 and tnfd == 156
        _bits_equal(tq, jq)
        _bits_equal(tqfd, jqfd)
        _bits_equal(tq, tqfd)
        assert tbytes[1] == tbytes[0]


def test_fd_write_failure_raises(tmp_path):
    if not tnat.available():
        pytest.fail("native codec did not build")
    p = tmp_path / "ro.log"
    p.touch()
    fd = os.open(p, os.O_RDONLY)
    try:
        with pytest.raises(OSError):
            tnat.append_half_payload_quantized_fd(fd, jhalf.encode_halves([1.0, 2.0]), 0.0)
    finally:
        os.close(fd)
