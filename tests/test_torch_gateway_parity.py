"""Parity harness for the gateway: one packet stream through two services,
and the tests of its comparison rules.

Plain Python and numpy (no JAX, no torch at import), so the JAX-free
``chip_smoke.py`` loads it by path as it loads ``oracle.py``.  A
:class:`Side` is one ``GatewayService`` built from a package
(``"apda_fft_tpu"`` or ``"apda_fft_tpu_torch"``) over its own work directory,
with the fake FTP session, fake HTTP opener and ticking clock of
``tests/test_gateway.py``.  Packets are made once (:func:`capture`) and
pushed into every side, so wall-clock fields in the wire headers are the
same on each.  :meth:`Side.surface` is what a user of the gateway sees: the
history text (data directory normalised, self-metrics masked), the
``fft_results`` snapshot (self-metric keys stripped), the uploads, the API
payloads, the queues and the persisted drift and modal state.

Tolerances of :func:`assert_same_surface`:

* every string, integer, boolean and decision is equal;
* a float the gateway rounds (to 2 to 5 decimals) is equal after that
  rounding or one rounding step apart, where two float32 results land on
  either side of a tie; other floats (magnitudes, refined frequencies,
  shape components) within 2e-5 relative plus 1e-5 absolute;
* a number printed in the history within one step of its last printed
  digit plus 2e-5 relative (magnitudes of ~1e3 are printed to 4
  decimals, finer than float32 resolves them);
* the persisted SSI mode tracks (``modal_tracks.json``'s ``"ssi"``) within
  1e-3 relative plus 1e-4 absolute: SSI identifies in float64 on the
  host from float32 correlation blocks that differ in their last bits, and
  its shapes and dampings move by up to 2e-5 absolute and 1e-4 relative
  (measured, 32 sensors, JAX package against the port on the CPU) - inside
  the rule of ``tests/test_torch_ssi.py`` (dampings within 1e-2, shapes at
  MAC >= 0.9999).
"""

from __future__ import annotations

import copy
import importlib
import json
import math
import os
import re
from datetime import datetime, timedelta

import numpy as np

#: runtime self-metrics, not decisions (reference parity fields,
#: GT_FFT_v5.py:663-676): they differ between any two runs.
METRIC_KEYS = {"process_time", "wall_time", "percentage_cpu", "memrss"}

#: The full-feature gateway of ``benchmarks/endurance.py:257-279``.
FULL_FEATURE = {
    "analysis": "epoch",
    "analyze_shock": True,
    "drift_alert_rel": 0.02,
    "drift_temp_compensate": True,
    "fdd_report": True,
    "fdd_window": 256,
    "fdd_min_sensors": 2,
    "ssi_report": True,
    "ssi_block_rows": 12,
    "ssi_damping_alert": 0.8,
    "harmonic_check": True,
    "modal_decimate": True,
    "shock_srs": True,
    "vibration_severity": True,
    "severity_band_hz": [5.0, 100.0],
    "severity_alert_mms": 50.0,
}

#: Rounding step of each float the gateway rounds before it stores or
#: sends it (``gateway/service.py``).
ROUND_STEP = {
    "velocity_rms_mms": 1e-4,
    "ringdown_damping_pct": 1e-3,
    "srs_peak_freq": 1e-4,
    "srs_peak_g": 1e-5,
    "srs_peak_pv_mms": 1e-3,
    "drift_pct": 1e-2,
    "freq": 1e-4,
    "mac": 1e-3,
}
RTOL, ATOL = 2e-5, 1e-5
SSI_RTOL, SSI_ATOL = 1e-3, 1e-4

WIRE_T0 = datetime(2026, 8, 16, 9, 0, 0)


class FakeFtpSession:
    def __init__(self, store):
        self.store = store

    def storbinary(self, cmd, fh):
        self.store.append(cmd.split(" ", 1)[1])

    def close(self):
        pass


class FakeResponse:
    def __init__(self, status):
        self.status = status

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class TickingClock:
    """Deterministic clock advancing 1 s per reading."""

    def __init__(self):
        self._t = datetime(2026, 8, 16, 10, 0, 0)

    def __call__(self):
        self._t += timedelta(seconds=1)
        return self._t


def module(package: str, name: str):
    """``package.name`` (e.g. ``module("apda_fft_tpu_torch", "gateway.service")``)."""
    return importlib.import_module(f"{package}.{name}")


def capture(package: str, fn) -> list[tuple[bytes, str]]:
    """The packets ``fn(transport)`` pushes into a loopback transport."""
    transport = module(package, "gateway.transport").LoopbackTransport()
    fn(transport)
    return list(transport.inbound.queue)


class Side:
    """One gateway service over ``root`` with captured egress."""

    def __init__(self, package: str, root, flush_mode: str = "immediate", config_rows=(),
                 http_status: int = 200, gateway_extra: dict | None = None, **service_kw):
        config_mod = module(package, "gateway.config")
        self.package = package
        self.root = str(root)
        data_dir = os.path.join(self.root, "SHM_Data") + os.sep
        os.makedirs(data_dir, exist_ok=True)
        cfg_file = os.path.join(self.root, "config.txt")
        with open(cfg_file, "w") as fh:
            fh.write("".join(config_rows))
        gw_json = {
            "ftp": {"server": "ftp.example", "user": "u", "pwd": "p", "path": "/x"},
            "fastapi": {"url": "http://api.example/upload"},
            "gateway": {
                "logger_file": data_dir + "history.log",
                "device_file": data_dir + "devices.txt",
                "config_file": cfg_file,
                "data_dir": data_dir,
                "is_flexibile_structure": True,
                **(gateway_extra or {}),
            },
        }
        cfg_path = os.path.join(self.root, "gw_config.json")
        with open(cfg_path, "w") as fh:
            json.dump(gw_json, fh)
        self.config = config_mod.GatewayConfig.load(cfg_path)
        self.flush_mode = flush_mode
        self.ftp_uploads: list[str] = []
        self.api_posts: list[dict] = []
        self.http_status = http_status
        self.service_kw = service_kw
        self.clock = TickingClock()
        self.restart()

    def restart(self) -> None:
        """A fresh service (and transport) on the same work directory and
        egress, as a gateway restart makes."""
        egress = module(self.package, "gateway.egress")
        transport = module(self.package, "gateway.transport").LoopbackTransport()

        def opener(req, timeout=None):
            self.api_posts.append(json.loads(req.data.decode()))
            return FakeResponse(self.http_status)

        svc = module(self.package, "gateway.service").GatewayService(
            self.config, transport, flush_mode=self.flush_mode, clock=self.clock,
            ftp_sink=egress.FtpSink(self.config.ftp, self.config.data_dir,
                                    connect_factory=lambda: FakeFtpSession(self.ftp_uploads)),
            http_sink=egress.HttpSink(self.config.fastapi_url, opener=opener),
            **self.service_kw,
        )
        svc.start()
        self.svc, self.transport = svc, transport

    def feed(self, pkts) -> int:
        """Push ``pkts`` and process them; returns the packets processed."""
        for payload, addr in pkts:
            self.transport.push(payload, addr)
        return self.svc.drain()

    def history(self) -> list[str]:
        with open(self.config.logger_file) as fh:
            return normalized_history(fh.read(), self.config.data_dir)

    def _state(self, name: str):
        path = os.path.join(self.config.data_dir, name)
        if not os.path.exists(path):
            return None
        with open(path) as fh:
            return json.load(fh)

    def surface(self) -> dict:
        svc = self.svc
        return {
            "history": self.history(),
            "fft_results": strip_metrics(svc.fft_results),
            "ftp": list(self.ftp_uploads),
            "api": copy.deepcopy(self.api_posts),
            "queues": copy.deepcopy([svc.ftp_queue, svc.api_queue, svc.influx_queue]),
            "pending": [os.path.basename(p) for _, p in svc.pending_analysis],
            "open": sorted(os.path.basename(p) for p in svc.open_file.values()),
            "sent": [(a, h[:2]) for a, h in self.transport.sent],
            "drift": self._state("drift_tracks.json"),
            "modal": self._state("modal_tracks.json"),
        }


_METRICS = re.compile(r"Process time: .*?RAM: [-0-9.]+")


def normalized_history(text: str, data_dir: str) -> list[str]:
    """History lines with the data directory replaced, the "Datetime:"
    lines stripped (``tests/test_memfeed.py``: they echo the heartbeat's
    clock) and the self-metrics masked ("Process time: ... RAM: ...", the
    run's own cost; the sync status after them on the line is kept)."""
    text = _METRICS.sub("METRICS", text.replace(str(data_dir), "DATA_DIR/"))
    return [ln for ln in text.splitlines() if not ln.lstrip().startswith("Datetime:")]


def strip_metrics(fft_results: dict) -> dict:
    return {mac: {ax: {k: v for k, v in entry.items() if k not in METRIC_KEYS}
                  for ax, entry in by_axis.items()}
            for mac, by_axis in copy.deepcopy(fft_results).items()}


def floats_close(a: float, b: float, step: float = 0.0, rtol: float = RTOL,
                 atol: float = ATOL) -> bool:
    """Equal, both NaN, one rounding ``step`` apart for a rounded value, or
    within ``rtol``/``atol`` for an unrounded one."""
    if a == b or (math.isnan(a) and math.isnan(b)):
        return True
    return abs(a - b) <= (1.01 * step if step else rtol * abs(b) + atol)


def assert_close_tree(a, b, where: str = "", key: str = "", rtol: float = RTOL,
                      atol: float = ATOL) -> None:
    """``a`` and ``b`` (JSON-like) equal up to :func:`floats_close` on floats."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, sorted(a), sorted(b))
        for k in a:
            assert_close_tree(a[k], b[k], f"{where}/{k}", str(k), rtol, atol)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close_tree(x, y, f"{where}[{i}]", key, rtol, atol)
    elif isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), (where, a, b)
        assert floats_close(float(a), float(b), ROUND_STEP.get(key, 0.0), rtol, atol), \
            (where, a, b)
    else:
        assert a == b, (where, a, b)


_NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def lines_close(a: str, b: str) -> bool:
    """Two history lines equal up to the printed precision: the same text
    around the numbers, integers equal, and each decimal within one step of
    its last printed digit plus float32 noise."""
    if a == b:
        return True
    na, nb = _NUM.findall(a), _NUM.findall(b)
    if _NUM.sub("#", a) != _NUM.sub("#", b) or len(na) != len(nb):
        return False
    for x, y in zip(na, nb):
        if x == y:
            continue
        if "." not in x or "." not in y or "e" in x or "e" in y:
            return False
        d = len(x.split(".")[1])
        if d != len(y.split(".")[1]) or \
                abs(float(x) - float(y)) > 1.01 * 10.0 ** -d + RTOL * abs(float(y)):
            return False
    return True


#: An SSI mode line of the history (``gateway/service.py`` ``_ssi_run``).
SSI_MODE_LINE = "\t[SSI]   f="


def ssi_lines_close(a: str, b: str) -> bool:
    """Two SSI mode lines under the rule of ``tests/test_torch_ssi.py``,
    whose numbers the caller holds on the ``SSIResult`` objects behind
    them: the same text around the numbers and the same shape length,
    ``orders`` within 1."""
    if _NUM.sub("#", a) != _NUM.sub("#", b):
        return False
    oa, ob = (int(x.split("orders=")[1].split()[0]) for x in (a, b))
    return abs(oa - ob) <= 1


def assert_same_history(a: list[str], b: list[str], where: str = "history",
                        ssi_rule: bool = False) -> None:
    assert len(a) == len(b), (where, len(a), len(b), _first_diff(a, b))
    bad = [(i, x, y) for i, (x, y) in enumerate(zip(a, b))
           if not (ssi_lines_close(x, y) if ssi_rule and x.startswith(SSI_MODE_LINE)
                   else lines_close(x, y))]
    assert not bad, (where, bad[:5])


def _first_diff(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    return min(len(a), len(b)), None, None


def assert_same_surface(a: dict, b: dict, where: str = "", ssi_rule: bool = False) -> None:
    """Two surfaces of :meth:`Side.surface` hold the same decisions.

    With ``ssi_rule`` the SSI mode lines and the persisted SSI tracks are
    held to the rule of ``tests/test_torch_ssi.py`` only (a pole at a
    tolerance's edge may join or leave a cluster and move its medians by up
    to the cluster's spread; shapes at MAC >= 0.9999): lines by
    :func:`ssi_lines_close`, tracks within 1e-2 relative plus 1e-2
    absolute.  The caller then holds the ``SSIResult`` objects to that
    rule."""
    assert_same_history(a["history"], b["history"], f"{where} history", ssi_rule)
    for key in ("fft_results", "ftp", "api", "queues", "pending", "open", "sent", "drift"):
        assert_close_tree(a[key], b[key], f"{where} {key}")
    ma, mb = a["modal"], b["modal"]
    assert (ma is None) == (mb is None), (where, "modal state")
    if ma is not None:
        assert ma.keys() == mb.keys(), (where, sorted(ma), sorted(mb))
        for k in ma:
            tol = ((1e-2, 1e-2) if ssi_rule else (SSI_RTOL, SSI_ATOL)) if k == "ssi" \
                else (RTOL, ATOL)
            assert_close_tree(ma[k], mb[k], f"{where} modal/{k}", k, *tol)


# ---------------------------------------------------------------- traffic


def full_feature_epoch(package: str, macs: list[str], epoch: int, rng: np.random.Generator,
                       seed: int = 0, counts: dict | None = None) -> list[tuple[bytes, str]]:
    """One epoch of ``benchmarks/endurance.py:298-340``'s traffic: 15 % of
    sensors skip, sensors alternate 250 / 125 Hz, records of 1000 or 2048
    samples in packets of 200, 72 % clean, 10 % dropped packet, 8 %
    truncated, 6 % shock, 4 % reduced; returns the packets."""
    sim_cls = module(package, "gateway.transport").SensorSimulator
    counts = counts if counts is not None else {}

    def traffic(transport):
        for i, mac in enumerate(macs):
            if rng.random() < 0.15:
                counts["skipped"] = counts.get("skipped", 0) + 1
                continue
            axis = "XYZ"[i % 3]
            fs_i = 125.0 if i % 2 else 250.0
            temp_i = 20.0 + 8.0 * np.sin(2 * np.pi * epoch / 50.0) + float(rng.normal(0, 0.5))
            sim = sim_cls(mac, fs=fs_i, axis=axis, chunk=200,
                          seed=seed * 7919 + epoch * 131 + i, temperature=temp_i)
            n = int(rng.choice([1000, 2048]))
            t = np.arange(n) / fs_i
            x = (np.sin(2 * np.pi * 12.3 * t)
                 + 0.5 * np.sin(2 * np.pi * (47.7 if fs_i > 200 else 31.4) * t)
                 + 0.3 * rng.standard_normal(n))
            total_pkts = 1 + max(1, -(-(n - 200) // 200))
            kind = rng.random()
            if kind < 0.72:
                sim.stream_acquisition(transport, x, now=WIRE_T0)
                name = "clean"
            elif kind < 0.82 and total_pkts >= 4:
                sim.stream_acquisition(transport, x, now=WIRE_T0,
                                       drop_packets={int(rng.integers(2, total_pkts))})
                name = "dropped"
            elif kind < 0.90 and total_pkts >= 4:
                sim.stream_acquisition(transport, x, now=WIRE_T0,
                                       truncate_after=int(rng.integers(2, total_pkts)))
                name = "truncated"
            elif kind < 0.96:
                td = np.arange(256) / 250.0
                sim.shock_event(transport, np.exp(-2.0 * td) * np.sin(2 * np.pi * 20.0 * td))
                name = "shock"
            else:
                sim.reduced_data(transport, x[:500])
                name = "reduced"
            counts[name] = counts.get(name, 0) + 1

    return capture(package, traffic)


def heartbeats(package: str, macs: list[str]) -> list[tuple[bytes, str]]:
    """One heartbeat from every sensor (the epoch's sync boundary)."""
    sim_cls = module(package, "gateway.transport").SensorSimulator
    return capture(package, lambda t: [sim_cls(mac).heartbeat(t) for mac in macs])


#: Byte offset of the first sample in each data packet type.
SAMPLE_OFFSET = {0xD1: 31, 0xD2: 3, 0xD3: 3, 0xD4: 11, 0xC1: 4}


def samples_carried(pkts) -> int:
    """Samples the data packets of ``pkts`` carry (two bytes each)."""
    return sum(max(len(p) - SAMPLE_OFFSET[p[0]], 0) // 2
               for p, _ in pkts if p and p[0] in SAMPLE_OFFSET)


# ---------------------------------------------------------------- the rules


def test_lines_close_allows_one_printed_step():
    assert lines_close("\tf=12.3456 Hz (mag: 1702.2578)", "\tf=12.3457 Hz (mag: 1702.2578)")
    assert lines_close("zeta=1.23%", "zeta=1.24%")
    assert not lines_close("zeta=1.23%", "zeta=1.25%")
    # float32 noise on a large printed value, within 2e-5 relative
    assert lines_close("mag: 1702.2578", "mag: 1702.2600")
    assert not lines_close("mag: 1702.2578", "mag: 1702.3578")
    assert not lines_close("3 mode(s)", "4 mode(s)")  # integers are decisions
    assert not lines_close("X f1: 1.0000Hz", "Y f1: 1.0000Hz")
    assert not lines_close("f=1.000", "f=1.0000")


def test_close_tree_rounding_steps_and_decisions():
    assert_close_tree({"velocity_rms_mms": 12.3456}, {"velocity_rms_mms": 12.3457})
    assert_close_tree({"srs_peak_pv_mms": 101.234}, {"srs_peak_pv_mms": 101.235})
    for a, b in (({"velocity_rms_mms": 12.3456}, {"velocity_rms_mms": 12.3459}),
                 ({"peak_freq_1": 12.2070}, {"peak_freq_1": 12.2075}),
                 ({"count": 3}, {"count": 4}), ({"a": [1.0]}, {"a": [1.0, 2.0]}),
                 ({"a": 1.0}, {"b": 1.0})):
        try:
            assert_close_tree(a, b)
        except AssertionError:
            continue
        raise AssertionError(f"{a} and {b} compared equal")


def test_ssi_mode_lines_under_the_ssi_rule():
    a = "\t[SSI]   f=12.3352 Hz damping=0.860% orders=28 mpc=0.999 shape=[+1.000+0.000j]"
    b = "\t[SSI]   f=12.3391 Hz damping=0.902% orders=27 mpc=0.998 shape=[+0.999+0.010j]"
    assert ssi_lines_close(a, b) and not lines_close(a, b)
    assert not ssi_lines_close(a, b.replace("orders=27", "orders=25"))
    assert not ssi_lines_close(a, b + " HARMONIC")
    assert_same_history([a], [b], ssi_rule=True)


def test_history_masks_self_metrics_only():
    text = ("DATA/x.log written\n\tDatetime: 26-8-16 9:0:0\n"
            "\tProcess time: 0.16, Wall time: 0.16, %CPU: 99.63, RAM: 248596.00\tSync sent\n")
    assert normalized_history(text, "DATA/") == ["DATA_DIR/x.log written",
                                                 "\tMETRICS\tSync sent"]


def test_samples_carried_counts_every_data_packet():
    pk = module("apda_fft_tpu_torch", "io.packets")
    x = np.zeros(100)
    pkts = [(pk.encode_start_stream(x[:50]), "a"), (pk.encode_mid_stream(x[:40], 2), "a"),
            (pk.encode_end_stream(x[:30], 3), "a"), (pk.encode_reduced(x[:20]), "a"),
            (pk.encode_shock(x[:10]), "a"), (pk.encode_sync_request(), "a")]
    assert samples_carried(pkts) == 50 + 40 + 30 + 20 + 10
