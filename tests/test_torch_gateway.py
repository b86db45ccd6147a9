"""The port's gateway against the JAX package's, on the CPU.

Port analogues of ``tests/test_gateway.py``: the same packets (made once,
see ``tests/test_torch_gateway_parity.py``) go through the JAX ``GatewayService`` and
the port's (``device="cpu"``), each with the fake FTP session, fake HTTP
opener and ``TickingClock`` of that file, and everything a user of the
gateway sees is compared: the history text (data directory normalised,
self-metric lines stripped), the FTP uploads, the API payloads, the
``fft_results`` snapshot (self-metric keys stripped), the queues, the
acquisition files byte for byte, the webhook and Influx posts, and
``drift_tracks.json`` / ``modal_tracks.json``.  Tolerances are those of
``tests/test_torch_gateway_parity.py``: decisions equal, rounded floats equal or one
rounding step apart, other floats within 2e-5 relative.  The ``[SSI]``
lines of these corpora are compared at their printed precision: the
corpora were checked to be stable (no pole at a tolerance's edge), and the
persisted SSI tracks under the rule of ``tests/test_torch_ssi.py``.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tests import test_torch_gateway_parity as gp
from tests.signals import two_mode_signal

JAX, PORT = "apda_fft_tpu", "apda_fft_tpu_torch"
MAC = "0013a20041e7f6b7"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(tmp_path, **kw):
    return (gp.Side(JAX, tmp_path / "jax", **kw),
            gp.Side(PORT, tmp_path / "torch", device="cpu", **kw))


def _feed(pair, fn) -> None:
    pkts = gp.capture(PORT, fn)
    for side in pair:
        side.feed(pkts)


def _files(side) -> dict[str, bytes]:
    d = side.config.data_dir
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))
            if f.endswith(".log") and f != "history.log"}


def _same(pair, where: str = "", ordered: bool = True) -> dict:
    """Both sides' surfaces and acquisition files agree; returns the port's.
    ``ordered=False`` compares the history lines as a sorted list: an upload
    worker thread logs at times of its own, between the main loop's lines."""
    a, b = (side.surface() for side in pair)
    if not ordered:
        a["history"], b["history"] = sorted(a["history"]), sorted(b["history"])
    gp.assert_same_surface(a, b, where)
    assert _files(pair[0]) == _files(pair[1]), where
    return b


def _webhooks(pair, posted=None) -> list[list[dict]]:
    """An ``AlertWebhook`` with a capturing opener on each side (appending
    to ``posted``'s lists when given, e.g. after a restart)."""
    posted = posted if posted is not None else [[] for _ in pair]
    for side, got in zip(pair, posted):
        egress = gp.module(side.package, "gateway.egress")

        def opener(req, timeout=None, got=got):
            got.append(json.loads(req.data.decode()))
            return gp.FakeResponse(200)

        side.svc.alert_webhook = egress.AlertWebhook("http://alerts.example/hook", opener=opener)
    return posted


def test_full_acquisition_and_sync_flow(tmp_path):
    pair = _pair(tmp_path)
    x = two_mode_signal(1024, 500.0)
    _feed(pair, lambda t: gp.module(PORT, "gateway.transport").SensorSimulator(
        MAC, fs=500.0, axis="X", chunk=100).stream_acquisition(t, x, baseline=0.25))
    s = _same(pair, "after the stream")
    assert s["fft_results"][MAC]["X"]["peak_freq"] > 0
    assert s["queues"][0][MAC] == s["queues"][1][MAC] and len(s["queues"][0][MAC]) == 1
    _feed(pair, lambda t: gp.module(PORT, "gateway.transport").SensorSimulator(
        MAC).heartbeat(t, humidity=61.5))
    s = _same(pair, "after the sync")
    assert len(s["ftp"]) == 1 and len(s["api"]) == 1 and s["api"][0]["mac"] == MAC
    assert s["sent"][-1][1] == "a1" and MAC not in s["fft_results"]


def test_on_sync_batches(tmp_path):
    pair = _pair(tmp_path, flush_mode="on_sync")
    sim = gp.module(PORT, "gateway.transport").SensorSimulator
    x = two_mode_signal(1024, 500.0)
    _feed(pair, lambda t: [sim(MAC, fs=500.0, axis=a, chunk=100).stream_acquisition(t, x)
                           for a in "XYZ"])
    assert _same(pair, "pending")["pending"] and len(pair[1].svc.pending_analysis) == 3
    _feed(pair, lambda t: sim(MAC).heartbeat(t))
    hist = "\n".join(_same(pair, "after the sync")["history"])
    assert "X f1:" in hist and "Y f1:" in hist and "Z f1:" in hist


@pytest.mark.parametrize("drop", [3, 10])
def test_missing_packet_marker(tmp_path, drop):
    """A mid-stream gap (API queue kept) and a gap revealed by the 0xD3 (API
    queue skipped), as ``test_gateway.py`` checks them."""
    pair = _pair(tmp_path)
    sim = gp.module(PORT, "gateway.transport").SensorSimulator
    _feed(pair, lambda t: sim(MAC, fs=500.0, axis="X", chunk=100).stream_acquisition(
        t, two_mode_signal(1024, 500.0), drop_packets={drop}))
    s = _same(pair)
    (raw,) = _files(pair[1]).values()
    assert f"* MISSING PACKETS FROM {drop} TO {drop} *".encode() in raw
    assert bool(s["queues"][1].get(MAC)) == (drop == 3)


def test_anomalous_closure_recovery(tmp_path):
    pair = _pair(tmp_path)
    pk = gp.module(PORT, "io.packets")
    sim = gp.module(PORT, "gateway.transport").SensorSimulator(MAC, fs=500.0, axis="X",
                                                               chunk=100)
    x = two_mode_signal(1024, 500.0)
    for side in pair:
        side.svc.ftp_queue[MAC] = ["previously_queued.log"]
    _feed(pair, lambda t: sim.stream_acquisition(t, x, truncate_after=4))
    _feed(pair, lambda t: sim.stream_acquisition(t, x))  # force-closes the first
    _feed(pair, lambda t: sim.stream_acquisition(t, x, truncate_after=3))
    _feed(pair, lambda t: t.push(pk.encode_mid_stream(np.zeros(4), 5), MAC))  # gap
    _feed(pair, lambda t: t.push(pk.encode_mid_stream(np.zeros(4), 1), MAC))  # reset
    s = _same(pair)
    hist = "\n".join(s["history"])
    assert "Anomalous closure" in hist and "previously_queued.log" in s["queues"][0][MAC]
    assert any(b"* INCOMPLETE TRANSMISSION *" in v for v in _files(pair[1]).values())
    assert any("UnknownAxis" in f for f in _files(pair[1]))
    assert s["fft_results"][MAC]["X"]["peak_freq"] > 0


def test_shock_ringdown_srs_and_webhook(tmp_path):
    pair = _pair(tmp_path, gateway_extra={"analyze_shock": True, "shock_srs": True})
    posted = _webhooks(pair)
    t = np.arange(256) / 100.0
    ring_down = (np.exp(-1.5 * t) * np.sin(2 * np.pi * 20.0 * t)).astype(np.float32)
    _feed(pair, lambda tr: gp.module(PORT, "gateway.transport").SensorSimulator(
        MAC).shock_event(tr, ring_down))
    s = _same(pair)
    gp.assert_close_tree(posted[0], posted[1], "webhook")
    entry = s["fft_results"][MAC]["Unknown_axis"]
    assert entry["peak_freq"] == pytest.approx(20.0, abs=0.5)
    assert entry["ringdown_damping_pct"] == pytest.approx(1.19, rel=0.15)
    assert entry["srs_peak_freq"] == pytest.approx(20.0, rel=0.12)
    assert [e["kind"] for e in posted[1]] == ["shock", "shock_srs"]
    assert s["ftp"] and s["ftp"][0].endswith("_shock.log")


def test_reduced_data_with_influx(tmp_path):
    pair = _pair(tmp_path)
    lines = []
    for side in pair:
        egress = gp.module(side.package, "gateway.egress")
        got: list[str] = []

        def opener(req, timeout=None, got=got):
            got.append(req.data.decode("utf-8"))
            return gp.FakeResponse(204)

        side.svc.influx_sink = egress.InfluxSink(
            "http://influx.test/write", "tok", side.config.data_dir, opener=opener)
        lines.append(got)
    sim = gp.module(PORT, "gateway.transport").SensorSimulator(MAC, fs=250.0, axis="Y")
    _feed(pair, lambda t: sim.reduced_data(t, np.sin(np.arange(300) * 0.1)))
    s = _same(pair, "after the reduced packet")
    assert s["queues"][2][MAC] and s["queues"][0][MAC]
    _feed(pair, lambda t: sim.shock_event(t, np.sin(np.arange(200) * 0.3)))
    _feed(pair, lambda t: sim.heartbeat(t))
    _same(pair, "after the sync")
    assert lines[0] == lines[1] and len(lines[1]) >= 2
    assert all("WS_Summary" in p and "WS_Samples" in p for p in lines[1])


def test_drift_alert_and_restart_resume(tmp_path):
    """A 1 %/acquisition stiffness loss through the real pipeline (refined
    frequencies): one [ALERT], the same drift state on both sides, and a
    restart that resumes the tracks without a second alert."""
    pair = _pair(tmp_path)
    posted = _webhooks(pair)
    sim_cls = gp.module(PORT, "gateway.transport").SensorSimulator
    fs, n = 500.0, 1024
    t = np.arange(n) / fs

    def acquisition(e):
        f1 = 25.0 * (1 - 0.01 * e)
        x = np.sin(2 * np.pi * f1 * t) + 0.5 * np.sin(2 * np.pi * 47.7 * t)
        return lambda tr: sim_cls(MAC, fs=fs, axis="X", chunk=100).stream_acquisition(tr, x)

    for e in range(5):
        _feed(pair, acquisition(e))
    _same(pair, "before the restart")
    for side in pair:
        side.restart()
    _webhooks(pair, posted)
    assert pair[1].svc.trackers.keys() == pair[0].svc.trackers.keys() != set()
    for e in range(5, 9):
        _feed(pair, acquisition(e))
    s = _same(pair, "after the restart")
    hist = "\n".join(s["history"])
    assert hist.count("[ALERT]") == 1 and "drifted" in hist
    gp.assert_close_tree(posted[0], posted[1], "webhook")
    tracks = s["drift"]["trackers"][f"{MAC}/X"]
    assert max(len(tr["freqs"]) for tr in tracks["tracks"]) == 9


def test_schema_corrupt_drift_state_starts_fresh(tmp_path):
    pair = _pair(tmp_path)
    for side in pair:
        with open(os.path.join(side.config.data_dir, "drift_tracks.json"), "w") as fh:
            fh.write('{"trackers": {"aa/X": {"tracks": [{"freqs": [1.0]}]}}}')
        side.restart()
        assert side.svc.trackers == {}
    assert "[WARN] drift state unreadable" in "\n".join(_same(pair)["history"])


def test_severity_latch_and_restart(tmp_path):
    extra = {"vibration_severity": True, "severity_band_hz": [10.0, 200.0],
             "severity_alert_mms": 10.0}
    pair = _pair(tmp_path, gateway_extra=extra)
    posted = _webhooks(pair)
    sim = gp.module(PORT, "gateway.transport").SensorSimulator(MAC, fs=500.0, axis="X",
                                                               chunk=100)
    t = np.arange(1024) / 500.0
    loud = (0.5 * np.sin(2 * np.pi * 25.0 * t)).astype(np.float32)
    quiet = (0.01 * np.sin(2 * np.pi * 25.0 * t)).astype(np.float32)
    _feed(pair, lambda tr: sim.stream_acquisition(tr, loud))
    s = _same(pair, "loud")
    expect_mms = 0.5 / (2 * np.pi * 25.0) / np.sqrt(2) * 9806.65
    assert s["fft_results"][MAC]["X"]["velocity_rms_mms"] == pytest.approx(expect_mms, rel=0.02)
    _feed(pair, lambda tr: sim.heartbeat(tr))
    _feed(pair, lambda tr: sim.stream_acquisition(tr, loud))  # latched: no second alert
    _same(pair, "latched")
    for side in pair:
        side.restart()
    _webhooks(pair, posted)
    assert (MAC, "X") in pair[1].svc._severity_over
    for x in (loud, quiet, loud):  # latch survives; quiet re-arms; loud alerts again
        _feed(pair, lambda tr, x=x: sim.stream_acquisition(tr, x))
    s = _same(pair, "after the restart")
    alerts = [line for line in s["history"] if "[ALERT]" in line and "severity" in line]
    assert len(alerts) == 2
    gp.assert_close_tree(posted[0], posted[1], "webhook")


def test_async_uploads_and_timeout(tmp_path):
    """Background egress on both sides: a slow sink prunes when done; a hung
    sink is abandoned after the timeout and its files stay queued."""
    pair = _pair(tmp_path)
    sim = gp.module(PORT, "gateway.transport").SensorSimulator(MAC, fs=500.0, axis="X",
                                                               chunk=100)
    x = two_mode_signal(1024, 500.0)
    release = threading.Event()

    class HungFtp:
        def upload(self, addr, files, log):
            release.wait(5.0)
            return list(files)

    class SlowFtp:
        def __init__(self, store):
            self.store = store

        def upload(self, addr, files, log):
            time.sleep(0.05)
            self.store.extend(files)
            return list(files)

    for side in pair:
        upload = gp.module(side.package, "gateway.async_upload")
        side.svc.uploader = upload.AsyncUploadManager(timeout=10.0)
        side.svc.ftp_sink = SlowFtp(side.ftp_uploads)
    _feed(pair, lambda tr: sim.stream_acquisition(tr, x))
    _feed(pair, lambda tr: sim.heartbeat(tr))
    for side in pair:
        side.svc.uploader.drain(timeout=5.0)
    s = _same(pair, "slow sink", ordered=False)
    assert s["ftp"] and s["queues"][0][MAC] == []

    for side in pair:
        upload = gp.module(side.package, "gateway.async_upload")
        side.svc.uploader.shutdown()
        side.svc.uploader = upload.AsyncUploadManager(timeout=0.05)
        side.svc.ftp_sink = HungFtp()
    _feed(pair, lambda tr: sim.stream_acquisition(tr, x))
    _feed(pair, lambda tr: sim.heartbeat(tr))
    time.sleep(0.1)
    for side in pair:
        side.svc.uploader.poll(side.svc.history)
    release.set()
    s = _same(pair, "hung sink", ordered=False)
    assert any("abandoned" in line for line in s["history"])
    assert len(s["queues"][0][MAC]) == 1
    for side in pair:
        assert side.svc._uploads_inflight.get(MAC, 0) == 0
        side.svc.uploader.shutdown()


def test_orphan_recovery(tmp_path):
    pair = _pair(tmp_path)
    sim = gp.module(PORT, "gateway.transport").SensorSimulator(MAC, fs=500.0, axis="X",
                                                               chunk=100)
    _feed(pair, lambda tr: sim.stream_acquisition(tr, two_mode_signal(1024, 500.0)))
    for side in pair:
        side.restart()  # a crashed run's files come back on the FTP queue
    s = _same(pair, "requeued")
    assert len(s["queues"][0][MAC]) == 1
    _feed(pair, lambda tr: sim.heartbeat(tr))
    s = _same(pair, "uploaded")
    assert len(s["ftp"]) == 1 and s["queues"][0][MAC] == []
    assert "[RECOVERY] requeued 1" in "\n".join(s["history"])


def test_malformed_packets(tmp_path):
    pair = _pair(tmp_path)
    rng = np.random.default_rng(99)

    def garbage(tr):
        for lead in (0xA1, 0xD1, 0xD2, 0xD3, 0xD4, 0xC1, 0x00, 0xFF):
            for size in (1, 2, 5, 17):
                tr.push(bytes([lead]) + rng.bytes(size - 1), MAC)
        tr.push(b"", MAC)
        for _ in range(64):
            tr.push(rng.bytes(int(rng.integers(1, 60))), MAC)

    _feed(pair, garbage)
    _feed(pair, lambda tr: gp.module(PORT, "gateway.transport").SensorSimulator(
        MAC, fs=500.0, axis="X", chunk=100).stream_acquisition(tr, two_mode_signal(1024, 500.0)))
    s = _same(pair)
    assert abs(s["fft_results"][MAC]["X"]["peak_freq"] - 12.207) < 0.01
    assert any("Unexpected data transmission" in line for line in s["history"])


def test_epoch_batch_32_sensors_mixed_buckets(tmp_path):
    """32 sensors x 3 axes of mixed lengths, on-sync: one pipeline call per
    pow2 bucket on the port, decisions equal to the JAX package's and to the
    port's own per-file (immediate) run."""

    class CountingPipeline:
        def __init__(self, inner):
            self.inner, self.calls = inner, []

        def __call__(self, samples, fs, **kw):
            self.calls.append((kw.get("n_fft"), samples.shape[0]))
            return self.inner(samples, fs, **kw)

        @property
        def last_metrics(self):
            return self.inner.last_metrics

        @property
        def config(self):
            return self.inner.config

    macs = [f"0013a20041e7{i:04x}" for i in range(32)]
    lengths = {"X": 1000, "Y": 2048, "Z": 3500}
    sim = gp.module(PORT, "gateway.transport").SensorSimulator
    pkts = gp.capture(PORT, lambda tr: [
        sim(mac, fs=500.0, axis=a, chunk=250).stream_acquisition(
            tr, two_mode_signal(lengths[a], 500.0)) for mac in macs for a in "XYZ"])
    beat = gp.capture(PORT, lambda tr: sim("0013a20041e7ffff").heartbeat(tr))

    pair = _pair(tmp_path / "on_sync", flush_mode="on_sync")
    counter = pair[1].svc.pipeline = CountingPipeline(pair[1].svc.pipeline)
    for side in pair:
        side.feed(pkts)
    assert len(pair[1].svc.pending_analysis) == 96 and counter.calls == []
    for side in pair:
        side.feed(beat)
    assert counter.calls == [(1024, 32), (2048, 32), (4096, 32)]
    batched = _same(pair)["fft_results"]

    single = gp.Side(PORT, tmp_path / "immediate", device="cpu")
    single.svc.pipeline = counter = CountingPipeline(single.svc.pipeline)
    single.feed(pkts)
    assert len(counter.calls) == 96
    gp.assert_close_tree(single.surface()["fft_results"], batched, "immediate vs on-sync")


def test_full_feature_gateway_matches_jax(tmp_path):
    """The full-feature configuration of ``benchmarks/endurance.py`` (shock,
    SRS, drift with temperature compensation, FDD, SSI, harmonic check,
    modal decimation, severity) over its traffic mix, 12 sensors, 3 epochs."""
    pair = _pair(tmp_path, flush_mode="on_sync", gateway_extra=gp.FULL_FEATURE)
    macs = [f"0013a20041e7{i:04x}" for i in range(12)]
    rng = np.random.default_rng(0)
    counts: dict = {}
    for epoch in range(3):
        pkts = gp.full_feature_epoch(PORT, macs, epoch, rng, counts=counts)
        beat = gp.heartbeats(PORT, macs)
        for side in pair:
            side.feed(pkts)
            side.feed(beat)
    s = _same(pair)
    hist = "\n".join(s["history"])
    assert "[FDD]" in hist and "[SSI]" in hist and "Vibration severity" in hist
    assert "decimated" in hist and counts.get("clean", 0) > 10


def test_gateway_without_card_raises(tmp_path, monkeypatch):
    """``device=None`` is the card: without one the service refuses to start
    instead of carrying on on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    side = gp.Side(PORT, tmp_path / "cpu", device="cpu")
    assert side.svc.device.type == "cpu"
    assert side.svc.pipeline.config.device == side.svc.device
    service = gp.module(PORT, "gateway.service")
    transport = gp.module(PORT, "gateway.transport")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        service.GatewayService(side.config, transport.LoopbackTransport())


def _simulate(package: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", f"{package}.gateway", "--simulate", "--sensors", "4", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"},
    )


def test_simulate_cli_finds_the_modes_of_the_jax_cli(tmp_path):
    port = _simulate(PORT, "--device", "cpu", "--workdir", str(tmp_path / "torch"))
    assert port.returncode == 0, port.stderr
    jax = _simulate(JAX, "--workdir", str(tmp_path / "jax"))
    assert jax.returncode == 0, jax.stderr
    peaks = [[ln for ln in p.stdout.splitlines() if "Peaks:" in ln] for p in (jax, port)]
    assert len(peaks[1]) == 4 and all("f2:" in ln for ln in peaks[1])
    for a, b in zip(*peaks):
        assert gp.lines_close(a, b), (a, b)
    for i, line in enumerate(peaks[1]):
        f1 = float(line.split("f1: ")[1].split("Hz")[0])
        f2 = float(line.split("f2: ")[1].split("Hz")[0])
        assert sorted([f1, f2]) == pytest.approx(sorted([8.0 + 3.1 * i, 40.0 + 2.7 * i]), abs=0.2)


def test_simulate_cli_runs_on_the_card_by_default():
    """Without ``--device`` the CLI runs on the card, and refuses to start
    where there is none."""
    import torch

    proc = _simulate(PORT, "--sensors", "1")
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr
    else:
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_sync_grammar_config_rows_and_registry(tmp_path):
    """Reconfiguration packets from config rows, TDMA delays from the device
    registry, truncated heartbeats and unknown packets, on both sides."""
    row = MAC + " 2g 500Hz XY 8k 2h SYNC1 4g 250Hz Z 2k 10 1500 4 8g 50Hz ODR2 N\n"
    pair = _pair(tmp_path, config_rows=(row,))
    pk = gp.module(PORT, "io.packets")
    sim = gp.module(PORT, "gateway.transport").SensorSimulator
    full = pk.encode_sync_request()

    def traffic(tr):
        for mac in (MAC, "a" * 16, "b" * 16, "c" * 16):
            sim(mac).heartbeat(tr)
        for cut in (37, 35, 18, 12):
            tr.push(full[:cut], "b" * 16)
        tr.push(bytes([0xA1, 1, 2]), "c" * 16)
        tr.push(bytes([0xA1]), "c" * 16)
        tr.push(b"\xff\x01\x02", MAC)

    _feed(pair, traffic)
    s = _same(pair)
    hist = "\n".join(s["history"])
    assert "Sent reconfiguration" in hist and "ff0102" in hist
    assert hist.count("Synchronization request") == hist.count("Sync sent") + 1 == 10
    assert [h for _, h in s["sent"]][0] == "a2" and "[CRITICAL]" not in hist
    for side in pair:
        assert [side.svc.devices.delay_for(m) for m in ("a" * 16, "b" * 16, "c" * 16)] == \
            [2, 4, 6]
    assert open(pair[0].config.device_file).read() == open(pair[1].config.device_file).read()


@pytest.mark.parametrize("ftp_ok", [False, True])
def test_failed_uploads_keep_queues_and_files(tmp_path, ftp_ok):
    """The API fails (HTTP 500); FTP fails too or succeeds: nothing the API
    still needs is pruned or deleted."""
    pair = _pair(tmp_path, http_status=500)
    if not ftp_ok:
        for side in pair:
            egress = gp.module(side.package, "gateway.egress")

            def boom():
                raise ConnectionError("no route to host")

            side.svc.ftp_sink = egress.FtpSink(side.config.ftp, side.config.data_dir,
                                               connect_factory=boom)
    sim = gp.module(PORT, "gateway.transport").SensorSimulator(MAC, fs=500.0, axis="X",
                                                               chunk=100)
    _feed(pair, lambda tr: sim.stream_acquisition(tr, two_mode_signal(1024, 500.0)))
    _feed(pair, lambda tr: sim.heartbeat(tr))
    s = _same(pair)
    assert len(s["queues"][1][MAC]) == 1 and len(_files(pair[1])) == 1
    assert bool(s["ftp"]) == ftp_ok and bool(s["queues"][0][MAC]) != ftp_ok


def test_bad_header_file_does_not_abort_the_epoch(tmp_path):
    pair = _pair(tmp_path, flush_mode="on_sync")
    sim = gp.module(PORT, "gateway.transport").SensorSimulator
    _feed(pair, lambda tr: sim(MAC, fs=500.0, axis="X", chunk=100).stream_acquisition(
        tr, two_mode_signal(1024, 500.0)))
    for side in pair:
        bad = os.path.join(side.config.data_dir, MAC + "_Yaxis_01_01_2026_00_00_00.log")
        with open(bad, "w") as fh:
            fh.write("0:0:0;2g;bad ODR;Y axis;\nSynced;\n1;2;3;4;5;\n0;0;0;\n0.1;0.2;0.3;\n")
        side.svc.pending_analysis.append((MAC, bad))
    _feed(pair, lambda tr: sim(MAC).heartbeat(tr))
    hist = "\n".join(_same(pair)["history"])
    assert "unparseable" in hist and "X f1:" in hist


def test_mid_acquisition_sync_and_shock_keep_the_stream(tmp_path, monkeypatch):
    """A heartbeat and a shock (one of them raising inside its handler)
    between 0xD1 and 0xD3 keep the open stream, its baseline and its file;
    the finished stream then analyses cleanly."""
    pair = _pair(tmp_path)
    pk = gp.module(PORT, "io.packets")
    sim = gp.module(PORT, "gateway.transport").SensorSimulator(MAC, fs=500.0, axis="X",
                                                               chunk=100)
    x = two_mode_signal(1024, 500.0)
    _feed(pair, lambda tr: sim.stream_acquisition(tr, x, baseline=0.25, truncate_after=4))
    _feed(pair, lambda tr: sim.heartbeat(tr))
    _feed(pair, lambda tr: sim.shock_event(tr, np.sin(np.arange(100) * 0.2)))

    def boom(p):
        raise RuntimeError("simulated handler crash")

    for package in (JAX, PORT):
        monkeypatch.setattr(gp.module(package, "gateway.service").packets,
                            "parse_shock_header", boom)
    _feed(pair, lambda tr: sim.shock_event(tr, np.sin(np.arange(50) * 0.3)))
    monkeypatch.undo()
    for side in pair:
        assert side.svc.baseline.get(MAC) == 0.25
        assert "shock" not in os.path.basename(side.svc.open_file[MAC])
    rest = x[400:] - 0.25

    def finish(tr):
        n_chunks = (len(rest) + 99) // 100
        for i in range(n_chunks):
            enc = pk.encode_end_stream if i == n_chunks - 1 else pk.encode_mid_stream
            tr.push(enc(rest[i * 100:(i + 1) * 100], 5 + i), MAC)

    _feed(pair, finish)
    s = _same(pair)
    assert abs(s["fft_results"][MAC]["X"]["peak_freq"] - 12.207) < 0.01
    assert "simulated handler crash" in "\n".join(s["history"])


def test_severity_skips_shock_and_empty_band(tmp_path):
    pair = _pair(tmp_path, gateway_extra={"vibration_severity": True, "shock_srs": True,
                                          "severity_band_hz": [80.0, 1000.0]})
    sim = gp.module(PORT, "gateway.transport").SensorSimulator
    t = np.arange(256) / 100.0
    ring_down = (np.exp(-1.5 * t) * np.sin(2 * np.pi * 20.0 * t)).astype(np.float32)
    _feed(pair, lambda tr: sim(MAC).shock_event(tr, ring_down))
    _feed(pair, lambda tr: sim(MAC, fs=125.0, axis="X", chunk=100).stream_acquisition(
        tr, two_mode_signal(512, 125.0)))
    s = _same(pair)
    assert "velocity_rms_mms" not in s["fft_results"][MAC]["X"]
    assert "srs_peak_pv_mms" in s["fft_results"][MAC]["Unknown_axis"]
    assert any("[WARN] severity band" in line for line in s["history"])


def test_async_egress_edges(tmp_path):
    """Influx queue drained without a sink, a FastAPI failure beside an FTP
    success (the file stays for the API retry), and ``stop`` sweeping the
    files async uploads finished after the last sync."""
    pair = _pair(tmp_path, http_status=500)
    sim = gp.module(PORT, "gateway.transport").SensorSimulator(MAC, fs=250.0, axis="Y",
                                                               chunk=100)
    for side in pair:
        side.svc.uploader = gp.module(side.package, "gateway.async_upload").AsyncUploadManager(
            timeout=10.0)
    _feed(pair, lambda tr: sim.reduced_data(tr, np.sin(np.arange(300) * 0.1)))
    _feed(pair, lambda tr: sim.stream_acquisition(tr, two_mode_signal(1024, 250.0)))
    _feed(pair, lambda tr: sim.heartbeat(tr))
    for side in pair:
        side.svc.uploader.drain(timeout=5.0)
    s = _same(pair, "API failed", ordered=False)
    assert s["queues"][2].get(MAC) is None and len(s["queues"][1][MAC]) == 1
    assert any("_Yaxis_" in f for f in _files(pair[1]))  # kept for the API retry
    for side in pair:
        side.http_status = 200
    _feed(pair, lambda tr: sim.heartbeat(tr))
    for side in pair:
        side.svc.stop()  # drains the worker, then the final cleanup sweep
    s = _same(pair, "after stop", ordered=False)
    assert s["queues"][1][MAC] == [] and _files(pair[1]) == {}


def test_egress_units_match(tmp_path):
    """``FtpSink`` closes its session on a failed STOR, ``AlertWebhook``
    retries in order, ``HistoryLog`` rotates, and the taper reaches the
    pipeline, on both sides alike."""
    outcome = {}
    for package in (JAX, PORT):
        egress = gp.module(package, "gateway.egress")
        config = gp.module(package, "gateway.config")
        closed = []

        class FailingSession:
            def storbinary(self, cmd, fh):
                raise OSError("permission denied")

            def close(self):
                closed.append(True)

        (tmp_path / "f.log").write_text("x")
        sink = egress.FtpSink(config.FtpSettings(), str(tmp_path), connect_factory=FailingSession)
        ftp = (sink.upload(MAC, ["f.log"], lambda m: None), closed)
        posted, fail, logs = [], [True], []

        def opener(req, timeout=None):
            if fail[0]:
                raise OSError("endpoint down")
            posted.append(json.loads(req.data.decode()))
            return gp.FakeResponse(200)

        hook = egress.AlertWebhook("http://alerts.example/hook", opener=opener)
        hook.notify({"kind": "drift", "seq": 1}, logs.append)
        hook.notify({"kind": "ssi_damping", "seq": 2}, logs.append)
        pending = len(hook.pending)
        fail[0] = False
        flushed = hook.flush(logs.append)
        hist_path = tmp_path / f"{package}_history.log"
        log = gp.module(package, "gateway.history").HistoryLog(hist_path, max_kb=1)
        for i in range(200):
            log.append(f"{i:04d}" + "x" * 28 + "\n")
        rotated = (os.path.exists(str(hist_path) + ".old"),
                   "LOG ROTATION" in hist_path.read_text())
        side = gp.Side(package, tmp_path / package, gateway_extra={"taper": "hann"},
                       **({"device": "cpu"} if package == PORT else {}))
        outcome[package] = (ftp, pending, flushed, posted, logs, rotated,
                            side.svc.pipeline.config.taper)
    assert outcome[PORT] == outcome[JAX]
    assert outcome[PORT][0] == ([], [True]) and outcome[PORT][2] == 2
    assert outcome[PORT][5] == (True, True) and outcome[PORT][6] == "hann"


def test_multi_sensor_soak_with_faults(tmp_path):
    """``test_gateway.py``'s soak: 4 sensors x 3 epochs of interleaved
    streams with a dropped packet, a truncation, a shock and reduced data,
    a sync round after each epoch and a final one; every queue drains, every
    clean acquisition finds the 12.207 Hz mode, on both sides alike."""
    pair = _pair(tmp_path)
    sim_cls = gp.module(PORT, "gateway.transport").SensorSimulator
    macs = [f"00{i}3a20041e7f6b{i}" for i in range(4)]
    sims = {m: sim_cls(m, fs=500.0, axis="XYZ"[i % 3], chunk=100, seed=i)
            for i, m in enumerate(macs)}
    x = two_mode_signal(1024, 500.0)
    for epoch in range(3):
        def traffic(tr, epoch=epoch):
            for i, m in enumerate(macs):
                if epoch == 1 and i == 1:
                    sims[m].stream_acquisition(tr, x, drop_packets={4})
                elif epoch == 1 and i == 2:
                    sims[m].stream_acquisition(tr, x, truncate_after=3)
                else:
                    sims[m].stream_acquisition(tr, x)
                if epoch == 2 and i == 0:
                    sims[m].shock_event(tr, np.sin(np.arange(150) * 0.2))
                if epoch == 2 and i == 3:
                    sims[m].reduced_data(tr, np.sin(np.arange(120) * 0.1))

        _feed(pair, traffic)
        s = _same(pair, f"epoch {epoch}")
        for i, m in enumerate(macs):
            entry = s["fft_results"].get(m, {}).get("XYZ"[i % 3])
            if not (epoch == 1 and i in (1, 2)):  # the faulted acquisitions
                assert abs(entry["peak_freq"] - 12.207) < 0.01, (m, entry)
        _feed(pair, lambda tr: [sims[m].heartbeat(tr) for m in macs])
    _feed(pair, lambda tr: [sims[m].heartbeat(tr) for m in macs])
    s = _same(pair, "final")
    for queue in s["queues"]:
        assert all(pending == [] for pending in queue.values()), queue
    assert len(s["ftp"]) >= 12 and "Anomalous closure" in "\n".join(s["history"])
