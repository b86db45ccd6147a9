"""Egress sinks: FTP, HTTP (FastAPI), and InfluxDB line protocol.

Re-implementations of the reference's three upload paths with the network
boundary injected for testability:

* FTP (``utils/ftp_manager.py:30-66``): connect/login/cwd per flush, STOR each
  queued file, return the successfully uploaded names (caller prunes queues
  and deletes local files).  Any failure returns [] so nothing is pruned and
  the queue retries at the sensor's next sync - the reference's recovery
  contract.
* FastAPI (``utils/fastapi_manager.py:15-98``): full JSON per file - metadata,
  temperature/humidity, tilt angles phi=atan2(rms_y,rms_x) and
  theta=acos(rms_z/||rms||) in degrees, top-4 peak freqs/mags, raw samples;
  POST with 120 s timeout.
* InfluxDB (``utils/influxdb_manager.py:41-115``; disabled in the reference
  deployment but kept at parity): one ``WS_Summary`` point + per-sample
  ``WS_Samples`` points timestamped ``base + i/fs``, 500-line batches,
  token auth.
"""

from __future__ import annotations

import json
import os
import re
import time
import urllib.error
import urllib.request
from datetime import datetime
from ftplib import FTP
from math import acos, atan2, degrees

from apda_fft_tpu_torch.gateway.config import FtpSettings
from apda_fft_tpu_torch.io.logfile import SensorLog, load_sensor_log

_TS_RE = re.compile(r"(\d{2}_\d{2}_\d{4}_\d{2}_\d{2}_\d{2})")


def tilt_angles(rms_x: float, rms_y: float, rms_z: float) -> tuple[float, float, float]:
    """(accrms, phi_deg, theta_deg) - the reference's physics
    (``fastapi_manager.py:37-40``, ``influxdb_manager.py:69-72``)."""
    accrms = (rms_x**2 + rms_y**2 + rms_z**2) ** 0.5
    phi = degrees(atan2(rms_y, rms_x))
    theta = degrees(acos(rms_z / accrms)) if accrms != 0 else 0.0
    return accrms, phi, theta


def timestamp_from_filename(filename: str) -> datetime | None:
    m = _TS_RE.search(filename)
    return datetime.strptime(m.group(1), "%d_%m_%Y_%H_%M_%S") if m else None


class FtpSink:
    """FTP egress; ``connect_factory`` is injected for tests."""

    def __init__(self, settings: FtpSettings, local_dir: str, connect_factory=None):
        self.settings = settings
        self.local_dir = local_dir
        self._connect = connect_factory or self._default_connect

    def _default_connect(self):
        session = FTP()
        session.connect(self.settings.server, 21, 60.0)
        session.login(self.settings.user, self.settings.pwd)
        session.cwd(self.settings.path)
        return session

    def upload(self, addr: str, files_to_send: list[str], log) -> list[str]:
        if not files_to_send:
            return []
        uploaded: list[str] = []
        log(f"\t[FTP] connecting to {self.settings.server}...\n")
        session = None
        try:
            session = self._connect()
            for filename in list(files_to_send):
                try:
                    with open(os.path.join(self.local_dir, filename), "rb") as fh:
                        session.storbinary(f"STOR {filename}", fh)
                    uploaded.append(filename)
                    log(f"\t[FTP] uploaded {filename}\n")
                except Exception as exc:  # noqa: BLE001 - partial failure aborts flush
                    log(f"[FTP] error on {filename}: {exc}\n")
                    return []
        except Exception as exc:  # noqa: BLE001
            log(f"\t[FTP] upload error for {addr}: {exc}")
            return []
        finally:
            # Close on every path: a per-file failure returning [] each sync
            # would otherwise leak one socket per retry until fd exhaustion.
            if session is not None:
                try:
                    session.close()
                except Exception:  # noqa: BLE001
                    pass
        return uploaded


def prepare_api_payload(
    addr: str, filename: str, local_dir: str, fft_result: dict
) -> dict | str | None:
    """Build the FastAPI JSON body (``fastapi_manager.py:15-66``).

    ``fft_result`` is the per-axis dict of ``peak_freq_i``/``max_mag_i``
    entries the analysis stage produces.  Returns "FILE NOT FOUND" / None on
    the same conditions as the reference.
    """
    path = os.path.join(local_dir, filename)
    if not os.path.exists(path):
        return "FILE NOT FOUND"
    log = load_sensor_log(path)
    if log is None:
        return None

    axis = log.axis.replace("_axis", "").replace("axis", "").strip()
    ts = timestamp_from_filename(filename) or datetime.now()
    _, phi, theta = tilt_angles(log.rms_x, log.rms_y, log.rms_z)
    current_rms = {"X": log.rms_x, "Y": log.rms_y, "Z": log.rms_z}.get(axis, 0.0)

    current_fft = fft_result.get(log.axis, {})
    metriche = {
        "temp": log.temperature,
        "humidity": log.humidity,
        "phi": phi,
        "theta": theta,
        "rms_asse": current_rms,
        "fft_freqs": [current_fft.get(f"peak_freq_{i}", 0.0) for i in range(1, 5)],
        "fft_mags": [current_fft.get(f"max_mag_{i}", 0.0) for i in range(1, 5)],
    }
    if "velocity_rms_mms" in current_fft:
        # Beyond-reference, additive: the gateway's vibration_severity
        # option computed the ISO serviceability number; ship it with the
        # summary instead of making the server re-derive it from samples.
        metriche["velocity_rms_mms"] = current_fft["velocity_rms_mms"]
    return {
        "mac": addr,
        "timestamp": ts.isoformat(),
        "asse": axis,
        "fs": log.fs,
        "sensitivity": log.sensitivity,
        "metriche": metriche,
        "samples": log.samples,
    }


class HttpSink:
    """FastAPI egress; ``opener`` (urlopen-like) is injected for tests."""

    def __init__(self, url: str, opener=None, timeout: float = 120.0):
        self.url = url
        self.timeout = timeout
        self._open = opener or urllib.request.urlopen

    def upload(self, addr, files_to_send, local_dir, fft_result, log) -> list[str]:
        if not files_to_send:
            return []
        uploaded: list[str] = []
        for filename in list(files_to_send):
            payload = prepare_api_payload(addr, filename, local_dir, fft_result)
            if payload == "FILE NOT FOUND":
                log(f"\t[FastAPI][WARN] file {filename} missing\n")
                continue
            if not payload:
                continue
            try:
                req = urllib.request.Request(
                    url=self.url,
                    data=json.dumps(payload).encode("utf-8"),
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                with self._open(req, timeout=self.timeout) as response:
                    if response.status == 200:
                        log(f"\t[FastAPI] OK {filename} ({addr})\n")
                        uploaded.append(filename)
            except Exception as exc:  # noqa: BLE001 - abort flush, keep queue
                log(f"\t[FastAPI][ERROR] {exc}")
                return []
        return uploaded


class InfluxSink:
    """InfluxDB line-protocol egress; ``opener`` injected for tests."""

    def __init__(self, url: str, token: str, local_dir: str, opener=None,
                 batch_size: int = 500, timeout: float = 20.0):
        self.url = url
        self.token = token
        self.local_dir = local_dir
        self.batch_size = batch_size
        self.timeout = timeout
        self._open = opener or urllib.request.urlopen

    def _lines_for(self, addr: str, log_rec: SensorLog, fft_axis: dict, filename: str) -> list[str]:
        ts = timestamp_from_filename(filename)
        if ts is None:
            today = datetime.now().strftime("%d_%m_%Y")
            ts = datetime.strptime(f"{today} {log_rec.timestamp}", "%d_%m_%Y %H:%M:%S")
        base_ms = int(time.mktime(ts.timetuple()) * 1000)
        _, phi, theta = tilt_angles(log_rec.rms_x, log_rec.rms_y, log_rec.rms_z)

        summary = (
            "WS_Summary,id={addr},axis={axis} "
            "temp={temp},rms_x={rx},rms_y={ry},rms_z={rz},phi={phi},theta={theta},"
            'pf={pf},mm={mm},range="{ar}",sync={sync} {utime}'
        ).format(
            addr=addr, axis=log_rec.axis, temp=log_rec.temperature,
            rx=log_rec.rms_x, ry=log_rec.rms_y, rz=log_rec.rms_z,
            phi=phi, theta=theta,
            pf=fft_axis.get("peak_freq", -1), mm=fft_axis.get("max_mag", -1),
            ar=log_rec.sensitivity, sync=log_rec.is_synced, utime=base_ms,
        )
        lines = [summary]
        for i, d in enumerate(log_rec.samples):
            utime = base_ms + int((i / log_rec.fs) * 1000)
            lines.append(f"WS_Samples,id={addr},axis={log_rec.axis} data={d} {utime}")
        return lines

    def upload(self, addr: str, files_to_send: list[str], fft_result: dict, log) -> None:
        for filename in list(files_to_send):
            status = self._send_one(addr, filename, fft_result)
            log(f"\t[Influx] {status}\n")
            files_to_send.remove(filename)

    def _send_one(self, addr: str, filename: str, fft_result: dict) -> str:
        try:
            rec = load_sensor_log(os.path.join(self.local_dir, filename))
            if rec is None:
                return f"error: file {filename} invalid or missing"
            lines = self._lines_for(addr, rec, fft_result.get(rec.axis, {}), filename)
            headers = {
                "Authorization": f"Token {self.token}",
                "Content-Type": "text/plain; charset=utf-8",
            }
            for i in range(0, len(lines), self.batch_size):
                batch = "\n".join(lines[i : i + self.batch_size])
                req = urllib.request.Request(
                    self.url, data=batch.encode("utf-8"), headers=headers, method="POST"
                )
                try:
                    with self._open(req, timeout=self.timeout) as response:
                        if response.status != 204:
                            return f"HTTP error {response.status}"
                except urllib.error.HTTPError as exc:
                    return f"HTTP 400 detail: {exc.read().decode('utf-8')}"
            return f"OK: {filename} ({len(rec.samples)} samples)"
        except Exception as exc:  # noqa: BLE001
            return f"error: {exc}"


class AlertWebhook:
    """Push [ALERT] events to an HTTP endpoint, queue-and-retry on failure.

    Beyond-reference operational surface: the reference's only "alert" is a
    line in history.log on the gateway's own filesystem
    (``GT_FFT_v5.py:810-837``) - invisible until someone logs in.  Damage
    indicators (drift, mode-shape change, damping rise) are exactly the
    events a monitoring deployment must push.  Same failure philosophy as
    the file queues: a failed POST keeps the event pending and retries at
    the next sync boundary (``GatewayService._on_sync``), so a flaky uplink
    delays an alert rather than losing it.  ``opener`` is injected for
    tests (urlopen-like).
    """

    def __init__(self, url: str, opener=None, timeout: float = 10.0,
                 max_pending: int = 256):
        self.url = url
        self.timeout = timeout
        self.max_pending = max_pending
        self.pending: list[dict] = []
        self._open = opener or urllib.request.urlopen

    def notify(self, event: dict, log) -> None:
        """Queue one alert event and attempt delivery immediately."""
        self.pending.append(event)
        if len(self.pending) > self.max_pending:
            # Drop oldest (they are also in history.log); alerts are rare,
            # so hitting this cap means the endpoint has been down for ages.
            del self.pending[: len(self.pending) - self.max_pending]
        self.flush(log)

    def flush(self, log) -> int:
        """Deliver pending events in order; stop at the first failure.

        Returns the number delivered.  In-order delivery matters: a
        shape-change alert arriving before the drift alert that preceded
        it would misrepresent the damage timeline.
        """
        sent = 0
        while self.pending:
            event = self.pending[0]
            try:
                req = urllib.request.Request(
                    url=self.url,
                    data=json.dumps(event).encode("utf-8"),
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                with self._open(req, timeout=self.timeout) as response:
                    if response.status != 200:
                        log(f"\t[AlertWebhook][WARN] HTTP {response.status}; "
                            f"{len(self.pending)} alert(s) pending\n")
                        break
            except Exception as exc:  # noqa: BLE001 - keep pending, retry at sync
                log(f"\t[AlertWebhook][WARN] {exc}; "
                    f"{len(self.pending)} alert(s) pending\n")
                break
            self.pending.pop(0)
            sent += 1
            log(f"\t[AlertWebhook] delivered {event.get('kind')} alert\n")
        return sent
