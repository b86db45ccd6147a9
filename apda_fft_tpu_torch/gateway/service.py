"""Gateway orchestrator: packet dispatch, file lifecycle, analysis, egress.

Counterpart of ``apda_fft_tpu/gateway/service.py``: the reference's
``Gateway`` class (``GT_FFT_v5.py:34-864``) on the port's ops.  The
behavioral contract is preserved - packet
grammar, file naming/format, sequence validation with inline markers, upload
queues that retry at the sensor's next sync, cleanup rules, history log - but
the numerical path is the batched :class:`SpectralPipeline` and the radio is
an injectable :class:`Transport` (so the whole machine is testable; the
reference had no simulator).

Known reference defects are fixed, not replicated (SURVEY.md section 2,
"Known defects"): peak results are stored per-axis and read per-axis
everywhere (defect 1); the Influx queue exists and its handlers are wired
(defect 2); 0xD4 registers its file before writing samples (defect 3);
failed/empty loads skip analysis instead of raising (defect 4).

Analysis batching: ``flush_mode="immediate"`` analyzes each completed file at
once (per-file parity with ``work_flow_fft``); ``flush_mode="on_sync"``
accumulates completed acquisitions and runs them as one batched call per
bucket when any sensor syncs - the "epoch batch boundary" the reference only
had implicitly (uploads already flush at sync, ``GT_FFT_v5.py:264-360``).

Device legs: the epoch analysis (``analyze_records`` /
``analyze_records_welch``; every flexible detect pass is the select+scan
CUDA kernel on the card), shock ring-down and SRS, vibration severity,
modal decimation, FDD (one select+scan kernel call each), SSI and the
harmonic check all run on ``device``: the card unless ``device="cpu"`` is
given.  Without a CUDA device, ``device=None`` raises ``RuntimeError``
rather than carrying on on the CPU.  Everything else (packets, files,
queues, trackers, egress) is host code, as in the JAX package.

Kept as the JAX gateway has them, for parity: the kept-fd generation
advances on every sync from any sensor (``_reap_idle_fds``), and the
severity batch is padded to a power-of-two row count (``_vibration_severity``).
``GatewayConfig.compilation_cache_dir`` enables the port's build cache
(``utils/compilecache.py``): the kernels and the native ingest are built
into and loaded from that directory.
"""

from __future__ import annotations

import json
import os
from datetime import datetime

import numpy as np
import torch

from apda_fft_tpu_torch.gateway.async_upload import AsyncUploadManager
from apda_fft_tpu_torch.gateway.config import DeviceRegistry, GatewayConfig, SensorConfigFile
from apda_fft_tpu_torch.gateway.egress import FtpSink, HttpSink, InfluxSink
from apda_fft_tpu_torch.gateway.history import HistoryLog
from apda_fft_tpu_torch.gateway.telemetry import device_status_report
from apda_fft_tpu_torch.gateway.transport import Transport
from apda_fft_tpu_torch.io import native, packets
from apda_fft_tpu_torch.io.halffloat import decode_payload, format_samples
from apda_fft_tpu_torch.io.logfile import (
    SensorLogBuilder,
    acquisition_header_lines,
    append_marker,
    append_sample_values,
    load_sensor_log,
)
from apda_fft_tpu_torch.models.batching import analyze_records, analyze_records_welch
from apda_fft_tpu_torch.models.pipeline import PipelineConfig, SpectralPipeline
from apda_fft_tpu_torch.models.tracking import PeakTracker


class GatewayService:
    def __init__(
        self,
        config: GatewayConfig,
        transport: Transport,
        pipeline: SpectralPipeline | None = None,
        flush_mode: str = "immediate",
        clock=datetime.now,
        ftp_sink: FtpSink | None = None,
        http_sink: HttpSink | None = None,
        influx_sink: InfluxSink | None = None,
        async_uploads: bool = False,
        upload_timeout: float = 120.0,
        alert_webhook=None,
        device: torch.device | str | None = None,
    ):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device: the port's gateway runs on the card by default; "
                    "pass device='cpu' to run it on the CPU"
                )
            device = "cuda"
        #: where every device leg runs (epoch analysis, shock, severity,
        #: decimation, FDD, SSI, harmonic check)
        self.device = torch.device(device)
        self.config = config
        self.transport = transport
        self.clock = clock
        self.flush_mode = flush_mode
        self.history = HistoryLog(config.logger_file)
        self.devices = DeviceRegistry(config.device_file)
        self.sensor_configs = SensorConfigFile(config.config_file)
        self.pipeline = pipeline or SpectralPipeline(
            PipelineConfig.from_gateway_flag(
                config.is_flexible_structure, taper=config.taper,
                # refine gives the drift tracker sub-bin frequencies (one
                # cheap parabolic interpolation per epoch); without it,
                # sub-bin drift is invisible and low-frequency bin jumps
                # break tracks.  Egress payloads are unaffected.
                refine=config.drift_alert_rel > 0,
                device=self.device,
            )
        )

        self.ftp_sink = ftp_sink or FtpSink(config.ftp, config.data_dir)
        self.http_sink = http_sink or HttpSink(config.fastapi_url)
        # Push surface for damage alerts (drift / shape change / damping
        # rise): the history line stays authoritative; the webhook queues
        # and retries at sync like every other egress (gateway/egress.py).
        self.alert_webhook = alert_webhook
        if alert_webhook is None and config.alert_webhook_url:
            from apda_fft_tpu_torch.gateway.egress import AlertWebhook

            self.alert_webhook = AlertWebhook(
                config.alert_webhook_url, timeout=config.alert_webhook_timeout
            )
        self.influx_sink = influx_sink
        if influx_sink is None and config.influx_url:
            self.influx_sink = InfluxSink(config.influx_url, config.influx_token, config.data_dir)

        # Per-sensor state (reference GT_FFT_v5.py:42-62).
        self.fft_results: dict[str, dict[str, dict]] = {}
        self.last_humidity: dict[str, float] = {}
        self.ftp_queue: dict[str, list[str]] = {}
        self.api_queue: dict[str, list[str]] = {}
        self.influx_queue: dict[str, list[str]] = {}
        self.open_file: dict[str, str] = {}
        self.expected_packet: dict[str, int] = {}
        self.baseline: dict[str, float] = {}
        # Pending epoch batch: (addr, path) of completed, unanalyzed files.
        self.pending_analysis: list[tuple[str, str]] = []
        # In-memory analysis feed (analysis_feed="memory"): per-open-file
        # record builders keyed by PATH, fed the quantized samples as each
        # packet lands, consumed (popped) by _analyze_files.  The log file
        # is still written - durability + upload artifact - but the analysis
        # hot path no longer re-parses it (the reference's write-then-
        # re-parse round-trip, GT_FFT_v5.py:627 -> load_data.py:29-82, was
        # pure overhead: host ingest ~1 Msamp/s vs device ~12 Gsamp/s).
        self._mem_records: dict[str, "object"] = {}
        # Per-in-flight-acquisition O_APPEND fds for the native ingest path:
        # the per-packet fopen/fwrite/fclose was the dominant host ingest
        # cost (~3 syscalls + stream setup per packet); one kept fd turns it
        # into a single write(2).  Closed when the file completes (or on
        # fault paths), and reaped at the sync boundary once idle across
        # two generations; the endurance fd-growth gate guards leaks.
        self._sample_fds: dict[str, int] = {}
        self._fd_generation = 0
        self._fd_last_write: dict[str, int] = {}
        # Modal drift monitoring (beyond-reference): per-(sensor, axis)
        # peak tracks; a sustained relative drift past the configured
        # threshold writes one [ALERT] history line per track.  Tracker
        # state persists to disk so months-long drift histories survive
        # gateway restarts (same durability model as the acquisition
        # files; the reference had nothing to persist).
        self.trackers: dict[tuple[str, str], PeakTracker] = {}
        self._alerted: set[tuple[str, str, int]] = set()
        # Vibration-severity alert latch: (addr, axis) currently above the
        # severity_alert_mms threshold.  Edge-triggered (one alert per
        # excursion, re-armed when the sensor drops back below) so a
        # persistently severe machine doesn't flood the webhook every epoch.
        self._severity_over: set[tuple[str, str]] = set()
        self._drift_state_path = os.path.join(config.data_dir, "drift_tracks.json")
        self._drift_state_dirty = False
        self._load_drift_state()
        # Array-level FDD report (beyond-reference): per-(axis, fs) records
        # accumulated across the epoch's analyses, flushed at sync.  The age
        # map retires groups that never reach fdd_min_sensors so a lone
        # sensor's records cannot accumulate unboundedly.
        self._fdd_pending: dict[tuple[str, float], dict[str, np.ndarray]] = {}
        self._fdd_pending_age: dict[tuple[str, float], int] = {}
        # Mode tracking across array reports: per-(axis, fs, roster)
        # MAC-based trackers; shape/damping alerts dedup on the track
        # itself.  Persisted like the drift state: the birth shapes and
        # birth dampings ARE the damage baselines, so a restart must not
        # silently re-baseline a degraded structure as healthy.
        self._modal_trackers: dict = {}
        self._ssi_trackers: dict = {}
        #: modal/SSI roster-tracker LRU drops (see _lru_tracker)
        self.tracker_evictions = 0
        self._modal_state_path = os.path.join(config.data_dir, "modal_tracks.json")
        self._load_modal_state()
        # Background egress (the capability GT_FFT_v5.py:109-113 stubbed).
        self.uploader = AsyncUploadManager(upload_timeout) if async_uploads else None
        self._uploads_inflight: dict[str, int] = {}

        os.makedirs(config.data_dir, exist_ok=True)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.config.compilation_cache_dir:
            from apda_fft_tpu_torch.utils.compilecache import enable_compilation_cache

            path = enable_compilation_cache(self.config.compilation_cache_dir)
            self.history(f"\t[build] persistent kernel build cache at {path}\n")
        self.transport.start(self.history)
        self.history(f"--- Gateway Start: {self.clock()} ---\n\n")
        self.devices.reset()
        self.recover_orphans()

    def recover_orphans(self) -> int:
        """Re-enqueue acquisition files stranded by a previous run.

        The reference keeps upload queues in memory only, so a restart orphans
        pending files - and its sync-time cleanup then *deletes* them unsent
        (``GT_FFT_v5.py:346-355``: any on-disk file not in the rebuilt-empty
        queue is removed).  Durability here means the files on disk ARE the
        checkpoint: at startup every leftover ``<mac>_*.log`` goes back on its
        sensor's FTP queue so it uploads at the next sync instead of being
        destroyed.
        """
        n = 0
        try:
            names = sorted(os.listdir(self.config.data_dir))
        except OSError:
            return 0
        for name in names:
            if not name.endswith(".log") or len(name) < 17 or "_" not in name:
                continue
            addr = name.split("_", 1)[0]
            if len(addr) != 16:
                continue
            if name not in self.ftp_queue.get(addr, []):
                self.ftp_queue.setdefault(addr, []).append(name)
                n += 1
        if n:
            self.history(f"\t[RECOVERY] requeued {n} stranded acquisition file(s)\n")
        return n

    def stop(self) -> None:
        if self.uploader is not None:
            self.uploader.drain(log=self.history)
            self.uploader.shutdown()
            # Final cleanup sweep: async completions that landed after a
            # sensor's last sync left uploaded files on disk - a restart
            # would requeue them as orphans and upload DUPLICATES.  With the
            # uploader drained (nothing reads files anymore), the sync-time
            # cleanup rule applies to every known sensor.
            for addr in set(self.ftp_queue) | set(self.api_queue) | set(self.influx_queue):
                self._cleanup_files(addr)
        for path in list(self._sample_fds):
            self._close_sample_fd(path)
        self.transport.stop(self.history)

    def run_forever(self) -> None:
        self.start()
        try:
            while True:
                self.step()
        except Exception as exc:  # noqa: BLE001 - fatal-path parity (:103-104)
            self.history(f"CRITICAL EXECUTION ERROR: {exc}\n")
        finally:
            self.stop()

    def step(self) -> bool:
        """One receive->dispatch iteration; False when the receive timed out."""
        try:
            if self.uploader is not None:
                self.uploader.poll(self.history)
            payload, addr = self.transport.receive(self.history)
            if payload is None or addr is None:
                return False
            self.process(payload, addr)
            return True
        except Exception as exc:  # noqa: BLE001 - loop survives handler crashes (:858)
            self.history(f"\tError in main loop: {exc}\n")
            return True

    def drain(self, max_steps: int = 100000) -> int:
        """Process until the transport runs dry (simulator/test harness)."""
        n = 0
        while n < max_steps and self.step():
            n += 1
        return n

    # -- dispatch ------------------------------------------------------------

    def process(self, payload: bytes, addr: str) -> None:
        handlers = {
            packets.PACKET_SYNC: self._on_sync,
            packets.PACKET_START: self._on_start,
            packets.PACKET_MID: self._on_mid,
            packets.PACKET_END: self._on_end,
            packets.PACKET_REDUCED: self._on_reduced,
            packets.PACKET_SHOCK: self._on_shock,
        }
        handlers.get(payload[0], self._on_unknown)(payload, addr)

    # -- stream sequence validation (reference check_files, :706-739) --------

    def _validate_sequence(self, addr: str, n_pack: int) -> str:
        status = ""
        if addr in self.open_file:
            expected = self.expected_packet[addr] + 1
            if n_pack < expected:
                status = f"\tAnomalous closure for data stream - {self.open_file[addr]}\n"
                append_marker(self.open_file[addr], "* INCOMPLETE TRANSMISSION *;")
                self.ftp_queue.setdefault(addr, []).append(
                    os.path.basename(self.open_file[addr])
                )
                # Force-closed files upload as-is and are never analyzed:
                # their in-memory record has no consumer.
                self._mem_records.pop(self.open_file[addr], None)
                self._close_sample_fd(self.open_file[addr])
                self.open_file.pop(addr)
                self.baseline.pop(addr, None)
            elif n_pack > expected:
                status = f"\tMissing packets from {expected} to {n_pack - 1} - {addr}\n"
                append_marker(
                    self.open_file[addr],
                    f"* MISSING PACKETS FROM {expected} TO {n_pack - 1} *;",
                )
        elif n_pack > 1:
            status = f"\tAnomalous closure - missing data from device: {addr}\n"
            self.baseline.pop(addr, None)
        self.expected_packet[addr] = n_pack
        return status

    def _append_stream_samples(self, payload: bytes, offset: int, addr: str,
                               first_value: float) -> None:
        if not (addr in self.open_file and os.path.exists(self.open_file[addr])):
            self.history(f"\t[WARN] write attempted on closed file for sensor {addr}\n")
            return
        path = self.open_file[addr]
        raw = payload[offset:]
        builder = self._mem_records.get(path)
        try:
            # Fused ingest (+ memory feed when a builder is live): one
            # native call decodes, renders the "%8.6f;" tokens, appends
            # them through the acquisition's kept O_APPEND fd, and (memory
            # feed) returns the finite quantized samples the analysis will
            # consume - no re-parse later.  The Python two-step is the
            # parity-tested fallback.
            q = None
            if native.available():
                q = native.append_half_payload_quantized_fd(
                    self._sample_fd(path), raw, first_value,
                    quantize=builder is not None,
                )
            if q is None:
                vals = decode_payload(raw, first_value)
                append_sample_values(path, vals)
                if builder is not None:
                    q = native.quantize_parse(vals)
            if builder is not None:
                builder.append(q)
        except OSError:
            # Bytes may be partially on disk; the in-memory record can no
            # longer be trusted to mirror the file. Drop it - analysis (if
            # the stream still completes) re-parses the file instead.
            self._mem_records.pop(path, None)
            self._close_sample_fd(path)
            raise

    # -- handlers ------------------------------------------------------------

    def _on_start(self, payload: bytes, addr: str) -> None:
        t = self.clock()
        self.history(f"{t.strftime('%d/%m/%Y, %H:%M:%S')}, {addr} - Start data transmission\n")
        status = self._validate_sequence(addr, 1)
        if status:
            self.history("\t" + status)

        header = packets.parse_start_header(list(payload))
        axis_slot = {"Xaxis": 0, "Yaxis": 1, "Zaxis": 2}.get(header.axis_label, 0)
        self.baseline[addr] = header.baselines[axis_slot]

        means = packets.decode_stream_samples(payload[:31], 23)
        filename = os.path.join(
            self.config.data_dir,
            f"{addr}_{header.axis_label}_{t.strftime('%d_%m_%Y_%H_%M_%S')}.log",
        )
        # Same-second filename collision: "w+" below truncates; a stale fd
        # must not keep appending past the truncation point.
        self._close_sample_fd(filename)
        self.open_file[addr] = filename
        self.expected_packet[addr] = 1
        header_lines = acquisition_header_lines(
            header.time,
            header.range,
            header.odr,
            header.axis_file,
            header.sync,
            means=format_samples(means),
            humidity=self.last_humidity.get(addr, 0.0),
            baselines=header.baselines,
        )
        with open(filename, "w+") as fh:
            fh.writelines(header_lines)
        if self.config.analysis_feed == "memory":
            self._register_mem_record(filename, header_lines)
        self._append_stream_samples(payload, 31, addr, first_value=0.0)

    def _on_mid(self, payload: bytes, addr: str) -> None:
        n_pck = packets.packet_number(payload)
        status = self._validate_sequence(addr, n_pck)
        if status:
            self.history("\t" + status)
            if "Anomalous closure" in status:
                self._open_recovery_file(addr, n_pck)
        self._append_stream_samples(payload, 3, addr, self.baseline.get(addr, 0.0))

    def _on_end(self, payload: bytes, addr: str) -> None:
        t = self.clock()
        self.history(f"{t.strftime('%d/%m/%Y, %H:%M:%S')}, {addr} - End data transmission\n")
        n_pck = packets.packet_number(payload)
        status = self._validate_sequence(addr, n_pck)
        if status:
            self.history("\t" + status)
            if "Anomalous closure" in status:
                self._open_recovery_file(addr, n_pck)
        self._append_stream_samples(payload, 3, addr, self.baseline.get(addr, 0.0))

        if self.open_file.get(addr):
            path = self.open_file[addr]
            name = os.path.basename(path)
            # Acquisition complete: release its kept fd before anything
            # reads the file (analysis fallback, egress).
            self._close_sample_fd(path)
            self.ftp_queue.setdefault(addr, []).append(name)
            if self.flush_mode == "immediate":
                self._analyze_files([(addr, path)])
            else:
                self.pending_analysis.append((addr, path))
            if status == "":
                self.api_queue.setdefault(addr, []).append(name)
        else:
            self.history(f"\t[WARN] no open file for {addr}\n")

        self.open_file.pop(addr, None)
        self.baseline.pop(addr, None)
        self.expected_packet[addr] = 0

    _MEM_RECORDS_CAP = 256  # stranded-builder backstop (dead mid-stream sensors)

    def _sample_fd(self, path: str) -> int:
        """The kept O_APPEND fd for ``path``, opened lazily.

        Bounded two ways: oldest-first past the cap (like the builders),
        and reaped at the sync boundary once idle across two generations
        (:meth:`_reap_idle_fds`) - at array scale stranded mid-stream
        acquisitions otherwise accumulate hundreds of open fds until the
        cap (measured 24->51 over a 28-epoch 256-sensor soak; the
        endurance fd gate allows growth <= 4).  A reaped acquisition that
        resumes just reopens.
        """
        fd = self._sample_fds.get(path)
        if fd is None:
            fd = os.open(path, os.O_WRONLY | os.O_APPEND)
            self._sample_fds[path] = fd
            while len(self._sample_fds) > self._MEM_RECORDS_CAP:
                self._close_sample_fd(next(iter(self._sample_fds)))
        self._fd_last_write[path] = self._fd_generation
        return fd

    def _close_sample_fd(self, path: str) -> None:
        self._fd_last_write.pop(path, None)
        fd = self._sample_fds.pop(path, None)
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass

    def _reap_idle_fds(self) -> None:
        """Close kept ingest fds with no write across two sync boundaries.

        A streaming acquisition writes packets continuously, so a fd idle
        for two whole sync generations belongs to a stalled/dead stream;
        closing it costs one lazy reopen if the stream ever resumes.
        Keeps the steady-state open-fd count at "currently bursting
        acquisitions" instead of "every stranded stream since startup".
        """
        self._fd_generation += 1
        cutoff = self._fd_generation - 2
        for path in [p for p, g in self._fd_last_write.items() if g <= cutoff]:
            self._close_sample_fd(path)

    def _register_mem_record(self, path: str, header_lines: list[str]) -> None:
        """Start the in-memory twin of a just-created acquisition file.

        Bounded: a sensor that dies mid-stream leaves its builder with no
        consumer; past the cap the oldest stranded builder is dropped
        (its acquisition, if it ever completes, falls back to the file
        re-parse - correctness is unaffected).
        """
        self._mem_records[path] = SensorLogBuilder(header_lines)
        while len(self._mem_records) > self._MEM_RECORDS_CAP:
            self._mem_records.pop(next(iter(self._mem_records)))

    def _open_recovery_file(self, addr: str, n_pck: int) -> None:
        """Anomalous-closure recovery file with inline gap marker (:421-426)."""
        t = self.clock()
        filename = os.path.join(
            self.config.data_dir,
            f"{addr}_UnknownAxis_{t.strftime('%d_%m_%Y_%H_%M_%S')}.log",
        )
        # Append, never replace: the reference clobbered the whole queue here
        # (GT_FFT_v5.py:423), silently dropping files still awaiting upload -
        # which the sync-time cleanup would then delete unsent (defect-5 fix).
        self.ftp_queue.setdefault(addr, []).append(os.path.basename(filename))
        self.open_file[addr] = filename
        with open(filename, "w+") as fh:
            fh.write(f"* MISSING PACKETS FROM 1 TO {n_pck - 1} *;")

    def _on_reduced(self, payload: bytes, addr: str) -> None:
        t = self.clock()
        self.history(f"{t.strftime('%d/%m/%Y, %H:%M:%S')}, {addr} - Reduced data transmission\n")
        # 0xD4/0xC1 are asynchronous events that can land mid-acquisition;
        # the reference clobbered open_file_dict/first_data_dict and lost
        # the in-progress stream (defect-8 fix: save/restore around the
        # self-contained fast-path file).
        prev_open = self.open_file.get(addr)
        filename = None
        try:
            header = packets.parse_reduced_header(list(payload))
            filename = os.path.join(
                self.config.data_dir, f"{addr}_{t.strftime('%d_%m_%Y_%H_%M_%S')}_reduced.log"
            )
            with open(filename, "w+") as fh:
                fh.write(f"{header.time};{header.range};{header.odr};{header.axis_file};\n")
                fh.write(f"{header.sync};\n")
                # Stub summary/first-value rows so the file meets the parser's
                # 5-line contract.  The reference wrote only the 2 header rows
                # (GT_FFT_v5.py:496-501), leaving reduced files unparseable by
                # its own load_sensor - with Influx actually wired here, the
                # stub rows make the reduced fast-path data servable
                # (documented divergence, docs/PARITY.md).
                fh.write("0;0;0;0;0;\n")
                fh.write("0;0;0;\n")
            self.open_file[addr] = filename  # register before writing (defect-3 fix)
            self._append_stream_samples(payload, 11, addr, first_value=0.0)
            name = os.path.basename(filename)
            self.influx_queue.setdefault(addr, []).append(name)
            self.ftp_queue.setdefault(addr, []).append(name)
        finally:
            # Restore even if the handler raised (step()'s catch-all would
            # otherwise leave the stream pointing at the fast-path file).
            if filename is not None:
                self._close_sample_fd(filename)
            if prev_open is not None:
                self.open_file[addr] = prev_open
            else:
                self.open_file.pop(addr, None)

    def _on_shock(self, payload: bytes, addr: str) -> None:
        t = self.clock()
        self.history(f"{t.strftime('%d/%m/%Y, %H:%M:%S')}, {addr} - Shock data transmission\n")
        # Mid-acquisition shock: preserve the open stream + baseline the
        # reference destroyed (defect-8 fix, see _on_reduced).
        prev_open = self.open_file.get(addr)
        prev_baseline = self.baseline.get(addr)
        filename = None
        try:
            header = packets.parse_shock_header(list(payload))
            filename = os.path.join(
                self.config.data_dir, f"{addr}_{t.strftime('%d_%m_%Y_%H_%M_%S')}_shock.log"
            )
            shock_header_lines = [
                # "100 Hz" with the standard spacing: the reference wrote
                # "100Hz", which its parser's strip(" Hz") cannot convert.
                f"{header.time};2g;100 Hz;Unknown_axis; \n",
                # 5-token summary row: the reference wrote "0;0;0;0;" whose
                # missing humidity token made float(summary[4]) raise inside
                # its own load_sensor, so shock files could never be served
                # (GT_FFT_v5.py:531-535 + utils/load_data.py:58).  Divergence
                # documented in docs/PARITY.md.
                "Asynced;\n", "0;0;0;0;0;\n", "0;0;0;\n",
            ]
            with open(filename, "w+") as fh:
                fh.writelines(shock_header_lines)
            self.open_file[addr] = filename
            if self.config.analysis_feed == "memory" and (
                self.config.analyze_shock or self.config.shock_srs
            ):
                # Only analyzed files need the in-memory twin; raw-upload
                # shock files would strand their builders.
                self._register_mem_record(filename, shock_header_lines)
            self._append_stream_samples(payload, 4, addr, first_value=0.0)

            name = os.path.basename(filename)
            self.ftp_queue.setdefault(addr, []).append(name)
            self.influx_queue.setdefault(addr, []).append(name)
            self._flush_influx(addr)
            uploaded = self._flush_ftp(addr)
            self._prune(self.ftp_queue, addr, uploaded)
            if self.alert_webhook is not None:
                # A shock event IS the sensor's own alarm (threshold
                # exceeded on-device; the reference's one immediate-upload
                # path, GT_FFT_v5.py:514-554) - push it like the other
                # damage indicators.  History keeps the reference wording,
                # so this adds no [ALERT] line.
                self.alert_webhook.notify(
                    {"ts": t.isoformat(), "kind": "shock", "addr": addr,
                     "sensor_time": header.time, "file": name,
                     "message": f"shock event from {addr} at {header.time}"},
                    self.history,
                )
            if self.config.analyze_shock or self.config.shock_srs:
                # Beyond-reference: a shock transient is free-decay
                # ring-down - prime modal/damping data the reference only
                # uploads raw.  Peaks land in fft_results under the shock
                # file's axis and in the sync report like any acquisition.
                # shock_srs rides the same analysis batch (SRS needs the
                # parsed record, not a detected peak).
                if self.flush_mode == "immediate":
                    self._analyze_files([(addr, filename)])
                else:
                    self.pending_analysis.append((addr, filename))
        finally:
            # Restore even if the handler raised (see _on_reduced).
            if filename is not None:
                self._close_sample_fd(filename)
            if prev_open is not None:
                self.open_file[addr] = prev_open
            else:
                self.open_file.pop(addr, None)
            if prev_baseline is not None:
                self.baseline[addr] = prev_baseline
            else:
                self.baseline.pop(addr, None)

    def _on_unknown(self, payload: bytes, addr: str) -> None:
        t = self.clock()
        self.history(f"{t.strftime('%d/%m/%Y, %H:%M:%S')}, {addr} - Unexpected data transmission\n")
        self.history("\t" + bytes(payload).hex() + "\n")

    def _on_sync(self, payload: bytes, addr: str) -> None:
        t = self.clock()
        self.history(f"{t.strftime('%d/%m/%Y, %H:%M:%S')}, {addr} - Synchronization request\n")
        if not self.devices.known(addr):
            self.devices.register(addr)

        info = packets.parse_sync_info(list(payload))
        self.last_humidity[addr] = info.humidity if info.humidity is not None else 0.0
        device_status = device_status_report(info)
        config_status = self._send_config(addr)

        # Alert webhook retry rides the same sync boundary as the file
        # queues: anything a flaky endpoint left pending goes out now.
        if self.alert_webhook is not None and self.alert_webhook.pending:
            self.alert_webhook.flush(self.history)

        # Reap kept ingest fds idle across two sync boundaries (stranded
        # mid-stream acquisitions; see _reap_idle_fds).
        self._reap_idle_fds()

        # Batch boundary: run any pending epoch analysis before reporting.
        if self.pending_analysis:
            batch, self.pending_analysis = self.pending_analysis, []
            self._analyze_files(batch)
        if (self.config.fdd_report or self.config.ssi_report) and self._fdd_pending:
            self._fdd_flush()

        peaks_text = self._peaks_report(addr)
        metrics = self._metrics_report(addr)

        # Upload flush (reference :311-344): queues keep entries on failure.
        if self.uploader is not None:
            self._submit_async_uploads(addr)
        else:
            pending_api = self.api_queue.get(addr, [])
            try:
                ok_api = self.http_sink.upload(
                    addr, pending_api, self.config.data_dir,
                    self._merged_axis_results(addr), self.history,
                ) or []
            except Exception as exc:  # noqa: BLE001
                self.history(f"\t[CRITICAL][FastAPI] error: {exc}\n")
                ok_api = []
            try:
                ok_ftp = self._flush_ftp(addr) or []
            except Exception as exc:  # noqa: BLE001
                self.history(f"\t[CRITICAL][FTP] error: {exc}\n")
                ok_ftp = []
            self._prune(self.api_queue, addr, ok_api)
            self._prune(self.ftp_queue, addr, ok_ftp)
            self._flush_influx(addr)

        # Cleanup: delete local files no longer pending anywhere (:346-355).
        # Unlike the reference, "anywhere" includes the API queue (the
        # reference only checked FTP, so a transient FastAPI failure paired
        # with an FTP success deleted the file while still queued for the
        # API - defect-6 fix) AND files still open mid-acquisition (a
        # heartbeat between 0xD1 and 0xD3 would otherwise delete the
        # in-progress acquisition the reference silently lost).  With async
        # uploads in flight the cleanup is deferred entirely: an in-flight
        # job may still be reading a file no queue mentions.
        if self._uploads_inflight.get(addr, 0) == 0:
            self._cleanup_files(addr)

        self.history(
            f"\t{device_status.strip()}\n\t{peaks_text}\t{metrics}\t{config_status.strip()}\n"
        )
        self.fft_results.pop(addr, None)

    def _alert(self, kind: str, message: str, **fields) -> None:
        """One damage alert: history line (authoritative) + webhook push."""
        self.history(message)
        if self.alert_webhook is not None:
            event = {
                "ts": self.clock().isoformat(),
                "kind": kind,
                "message": message.strip(),
                **fields,
            }
            self.alert_webhook.notify(event, self.history)

    def _cleanup_files(self, addr: str) -> None:
        """Delete this sensor's files no longer pending anywhere (:346-355)."""
        still_pending = (
            set(self.ftp_queue.get(addr, []))
            | set(self.api_queue.get(addr, []))
            | set(self.influx_queue.get(addr, []))
            | {os.path.basename(p) for p in self.open_file.values()}
        )
        try:
            names = os.listdir(self.config.data_dir)
        except OSError:
            return
        for filename in names:
            if filename.startswith(addr) and filename.endswith(".log"):
                if filename not in still_pending:
                    path = os.path.join(self.config.data_dir, filename)
                    self._close_sample_fd(path)  # never hold a deleted inode
                    try:
                        os.remove(path)
                    except OSError as exc:
                        self.history(f"\t[ERROR] cleanup failed for {filename}: {exc}")

    # -- analysis ------------------------------------------------------------

    def _analyze_files(self, batch: list[tuple[str, str]]) -> None:
        """Run the spectral pipeline over completed acquisition files.

        Files are bucketed by padded FFT length so each bucket is one
        pipeline call over a ``[B, N]`` batch - the epoch-batch replacement for the
        reference's one-file-at-a-time ``work_flow_fft`` (:620-679).
        """
        loaded = []
        for addr, path in batch:
            try:
                # Memory feed first: the record accumulated while packets
                # streamed in (already "%8.6f"-quantized).  Files without a
                # live builder - recovery files, feed="file" mode, builders
                # dropped after a mid-write fault - re-parse from disk, the
                # reference's original (and now cold) path.
                builder = self._mem_records.pop(path, None)
                rec = builder.finish() if builder is not None else None
                if rec is None:
                    rec = load_sensor_log(path)
            except Exception as exc:  # noqa: BLE001 - malformed header fields
                self.history(f"\t[WARN] file {path} unparseable ({exc}), skipping FFT\n")
                continue
            if rec is None or len(rec.samples) < 2:
                # < 2 samples: no spectrum exists (next_pow2(1) = 1 -> zero
                # half-spectrum bins); a truncated file that parsed to a
                # single sample must not crash the batch on either path.
                self.history(f"\t[WARN] file {path} corrupt or too short, skipping FFT\n")
                continue
            loaded.append((addr, path, rec))
        if not loaded:
            return

        records = [(np.asarray(rec.samples, np.float32), rec.fs) for _, _, rec in loaded]
        # Each pow2 bucket is its own pipeline run; snapshot that run's
        # metrics for exactly its records (a single post-hoc read would
        # stamp every record with the LAST bucket's numbers).
        bucket_metrics: dict[int, dict] = {}

        def grab(_n_fft, idxs):
            snap = dict(self.pipeline.last_metrics)
            for i in idxs:
                bucket_metrics[i] = snap

        if self.config.analysis == "welch":
            # Welch-averaged analysis for long noisy acquisitions; shock
            # transients stay on the epoch path (averaging segments of a
            # decaying transient smears the ring-down), analyzed in a
            # second pass below.  (Records here always have >= 2 samples:
            # shorter ones were skipped with a [WARN] above.)
            shock = [i for i, (_, p, _) in enumerate(loaded)
                     if p.endswith("_shock.log")]
            regular = [i for i in range(len(loaded)) if i not in set(shock)]
            per_record: list = [None] * len(loaded)

            def grab_sub(idxs_map):
                def _grab(_n_fft, sub_idxs):
                    grab(_n_fft, [idxs_map[j] for j in sub_idxs])
                return _grab

            if regular:
                for j, rp in enumerate(
                    analyze_records_welch(
                        [records[i] for i in regular],
                        window=self.config.welch_window,
                        hop=self.config.welch_hop or None,
                        taper=self.config.welch_taper,
                        analyze=self.pipeline.welch,
                        on_bucket=grab_sub(regular),
                    )
                ):
                    per_record[regular[j]] = rp
            if shock:
                for j, rp in enumerate(
                    analyze_records(
                        [records[i] for i in shock],
                        analyze=self.pipeline,
                        on_bucket=grab_sub(shock),
                    )
                ):
                    per_record[shock[j]] = rp
        else:
            per_record = analyze_records(records, analyze=self.pipeline, on_bucket=grab)
        for i, ((addr, path, rec), rp) in enumerate(zip(loaded, per_record)):
            self._store_result(addr, rec.axis, rp, bucket_metrics.get(i, {}),
                               temperature=rec.temperature)
            if path.endswith("_shock.log") and rp.count:
                self._shock_ringdown(addr, rec.axis, records[i][0], rec.fs)
            if path.endswith("_shock.log") and self.config.shock_srs:
                self._shock_srs(addr, rec.axis, records[i][0], rec.fs)
        if self.config.vibration_severity:
            # ISO vibration severity is a steady-state quantity: regular
            # acquisitions only (shock transients report SRS pseudo-velocity
            # instead, _shock_srs above).
            self._vibration_severity(
                [(addr, rec.axis, records[i][0], float(rec.fs))
                 for i, (addr, path, rec) in enumerate(loaded)
                 if not path.endswith("_shock.log")])
        if self.config.fdd_report or self.config.ssi_report:
            # Accumulate for the sync-boundary array reports (FDD and/or
            # SSI — both consume the same aligned multi-sensor groups; the
            # analysis batch is per-file in immediate mode; the array epoch
            # closes at the next 0xA1, the same boundary uploads flush on).
            # Only sync-disciplined records qualify: cross-sensor phases and
            # cross-correlations (hence mode shapes) assume simultaneous
            # sampling, which the
            # sensor network provides via its GPS/PPS sync - an "Asynced"
            # record's sample clock is free-running and its phases are
            # meaningless across sensors.
            from apda_fft_tpu_torch.gateway.egress import timestamp_from_filename

            for addr, path, rec in loaded:
                if path.endswith("_shock.log"):
                    continue
                if not rec.is_synced:
                    tag = "FDD" if self.config.fdd_report else "SSI"
                    self.history(
                        f"\t[{tag}] skipping unsynced record from {addr} "
                        f"({rec.axis}): cross-sensor phases/correlations "
                        "undefined\n"
                    )
                    continue
                key = (rec.axis, float(rec.fs))
                best = self._fdd_pending.setdefault(key, {})
                ts = timestamp_from_filename(os.path.basename(path))
                if addr not in best or len(rec.samples) > len(best[addr][0]):
                    best[addr] = (np.asarray(rec.samples, np.float32), ts)
        # One durability flush per analysis batch (not per record: the JSON
        # covers every tracked sensor, so per-record writes would be O(B)
        # redundant IO; alerts flush immediately in _track_drift).
        if self._drift_state_dirty:
            self._save_drift_state()
            self._drift_state_dirty = False

    def _shock_ringdown(self, addr: str, axis: str, samples: np.ndarray, fs) -> None:
        """Free-decay damping for an analyzed shock transient.

        Log-decrement on the band-selected envelope (ops/ringdown.py) - the
        right damping estimator for free decay, where the detectors'
        spectral half-power width is biased by the decay itself.
        """
        from apda_fft_tpu_torch.ops.ringdown import ringdown_damping

        entry = self.fft_results.get(addr, {}).get(axis)
        f0 = entry.get("peak_freq", -1) if entry else -1
        if not entry or f0 <= 0:
            return
        zeta = float(ringdown_damping(samples, fs, f0, device=self.device))
        if np.isnan(zeta):
            return
        entry["ringdown_damping_pct"] = round(zeta * 100.0, 3)
        self.history(
            f"\tShock ring-down: f={f0:.3f} Hz, zeta={zeta * 100.0:.2f}%\n"
        )

    def _shock_srs(self, addr: str, axis: str, samples: np.ndarray, fs) -> None:
        """Shock Response Spectrum for an analyzed 0xC1 transient.

        Maximax Q=10 SDOF bank (``ops/srs.py``) - the standard
        damage-potential characterization the reference's raw upload left
        to the downstream engineer.  Sensor samples are in g, so the
        pseudo-velocity proxy is converted to mm/s (x 9806.65 mm/s^2 per g).
        """
        from apda_fft_tpu_torch.ops.srs import shock_response_spectrum

        fs = float(fs)
        if len(samples) < 3 or fs <= 0:
            return
        res = shock_response_spectrum(np.asarray(samples, np.float32), fs,
                                      device=self.device)
        f_pk, a_pk = res.peak()
        pv_mms = float(np.max(res.pseudo_velocity)) * 9806.65
        entry = self.fft_results.get(addr, {}).get(axis)
        if entry is not None:
            entry["srs_peak_freq"] = round(f_pk, 4)
            entry["srs_peak_g"] = round(a_pk, 5)
            entry["srs_peak_pv_mms"] = round(pv_mms, 3)
        self.history(
            f"\tShock SRS: peak {a_pk:.4f} g @ {f_pk:.2f} Hz, "
            f"PV {pv_mms:.1f} mm/s (Q={res.q:g})\n"
        )
        if self.alert_webhook is not None:
            # The quantified follow-up to the raw shock notification:
            # pseudo-velocity is the severity number a structural engineer
            # acts on (the shock event itself already notified in _on_shock).
            self.alert_webhook.notify(
                {"ts": self.clock().isoformat(), "kind": "shock_srs",
                 "addr": addr, "axis": axis,
                 "srs_peak_freq": round(f_pk, 4),
                 "srs_peak_g": round(a_pk, 5),
                 "srs_peak_pv_mms": round(pv_mms, 3),
                 "message": (f"shock SRS from {addr}: {a_pk:.3f} g @ "
                             f"{f_pk:.2f} Hz, PV {pv_mms:.1f} mm/s")},
                self.history,
            )

    def _vibration_severity(
        self, items: list[tuple[str, str, np.ndarray, float]]
    ) -> None:
        """ISO 10816/20816 vibration severity for analyzed acquisitions.

        Band-limited velocity RMS (``ops/integrate.py:velocity_rms``,
        Parseval on the omega-scaled spectrum - one rfft per record, no
        inverse transform) converted to ISO mm/s (sensor samples are g).
        Records sharing a length and rate evaluate as one batched call,
        mirroring the epoch-batch analysis itself.  The value
        lands in ``fft_results`` (-> history line, FastAPI summary) and a
        crossing of ``severity_alert_mms`` raises one edge-triggered
        [ALERT] + webhook event per excursion.

        Beyond-reference: the reference uploads raw traces and leaves the
        serviceability number to the server (``GT_FFT_v5.py:620-679``
        stops at spectra + peaks).
        """
        from apda_fft_tpu_torch.ops.integrate import G_TO_MMS2, velocity_rms

        f_lo, f_hi = self.config.severity_band_hz
        by_shape: dict[tuple[int, float], list[tuple[str, str, np.ndarray]]] = {}
        for addr, axis, samples, fs in items:
            if len(samples) < 8:
                continue
            if f_lo >= fs / 2.0:
                self.history(
                    f"\t[WARN] severity band ({f_lo}, {f_hi}) Hz empty at "
                    f"fs={fs:g} for {addr}; skipping\n")
                continue
            # Quantize the record length DOWN to a coarse grid, as the JAX
            # gateway does (there it bounds the compiled-program count; here
            # it keeps the values equal to the reference's): an RMS over
            # >=256 samples loses nothing measurable to dropping < 256
            # trailing ones.
            n = len(samples)
            if n >= 256:
                n -= n % 256
                samples = samples[:n]
            by_shape.setdefault((n, fs), []).append(
                (addr, axis, samples))
        for (_, fs), group in sorted(by_shape.items()):
            x = np.stack([s for _, _, s in group])
            # Pow2 row padding (replicate-last, rows are independent), kept
            # from the JAX gateway, where it bounds the compiled-program
            # count; the port has no compile cache to bound, so the pad
            # rows are pure parity cost (a later change may drop them).
            b = x.shape[0]
            bp = 1 << max(b - 1, 0).bit_length()
            if bp != b:
                x = np.concatenate([x, np.repeat(x[-1:], bp - b, axis=0)])
            mms = velocity_rms(x, fs, band=(f_lo, f_hi), device=self.device
                               ).cpu().numpy()[:b] * G_TO_MMS2
            for (addr, axis, _), val in zip(group, mms):
                self._store_severity(addr, axis, float(val))

    def _store_severity(self, addr: str, axis: str, mms: float) -> None:
        entry = self.fft_results.get(addr, {}).get(axis)
        if entry is not None:
            entry["velocity_rms_mms"] = round(mms, 4)
        self.history(
            f"\tVibration severity ({axis}): {mms:.3f} mm/s RMS "
            f"({self.config.severity_band_hz[0]:g}-"
            f"{self.config.severity_band_hz[1]:g} Hz)\n")
        limit = self.config.severity_alert_mms
        if limit <= 0:
            return
        key = (addr, axis)
        if mms >= limit and key not in self._severity_over:
            self._severity_over.add(key)
            self._drift_state_dirty = True  # latch persists with drift state
            self._alert(
                "severity",
                f"\t[ALERT] {addr} {axis}-axis: vibration severity "
                f"{mms:.3f} mm/s exceeds {limit:g} mm/s\n",
                addr=addr, axis=axis,
                velocity_rms_mms=round(mms, 4),
                limit_mms=limit,
            )
        elif mms < limit and key in self._severity_over:
            self._severity_over.discard(key)
            self._drift_state_dirty = True  # re-armed: persist the edge

    def _fdd_flush(self) -> None:
        """Array-level modal reports (FDD and/or SSI) at the sync boundary.

        Groups pending same-axis multi-sensor records, aligns each group to
        its common length, and dispatches to ``_fdd_run`` (frequency-domain,
        ``fdd_report``) and/or ``_ssi_run`` (time-domain, ``ssi_report``).

        Beyond-reference capability at the gateway level: the reference (and
        the per-file analysis above) sees each sensor alone; when the epoch's
        accumulated analyses carry the same axis from
        ``fdd_min_sensors``-or-more sensors at one sampling rate, the records
        are aligned to their common length and decomposed into modes + mode
        shapes (``models/modal.py``), appended to the history log as
        ``[FDD]`` lines at the sync boundary (the same epoch boundary uploads
        flush on).  Sensors are ordered by address so shape components are
        attributable; a sensor with several acquisitions in the epoch
        contributes its longest record.  Failures only warn - the per-sensor
        results are already stored.  Groups below the sensor minimum stay
        pending (their remaining sensors may deliver before the next sync).

        Alignment guard: cross-spectral phases assume the records cover the
        SAME acquisition.  Pending entries carry their filename timestamp;
        records older than ``_FDD_ALIGN_TOL_S`` relative to the group's
        newest are dropped (a stale record left pending from an earlier
        epoch must not be mixed into a later acquisition's CSD).
        """
        if self.config.modal_decimate:
            self._decimate_merge_pending()
        for (axis, fs), by_addr in sorted(self._fdd_pending.items()):
            # Drop stale entries first so they can neither satisfy the
            # sensor minimum nor pollute the CSD.
            stamps = [ts for _, ts in by_addr.values() if ts is not None]
            if stamps:
                newest = max(stamps)
                for a in [a for a, (_, ts) in by_addr.items()
                          if ts is not None
                          and (newest - ts).total_seconds() > self._FDD_ALIGN_TOL_S]:
                    self.history(
                        f"\t[FDD] dropping stale {axis} record from {a} "
                        f"({(newest - by_addr[a][1]).total_seconds():.0f}s older "
                        f"than the epoch's newest)\n"
                    )
                    del by_addr[a]
            if len(by_addr) < self.config.fdd_min_sensors:
                # Stays pending a few epochs (its remaining sensors may still
                # deliver), then retires so it cannot accumulate unboundedly.
                age = self._fdd_pending_age.get((axis, fs), 0) + 1
                if age > self._FDD_PENDING_MAX_AGE or not by_addr:
                    del self._fdd_pending[(axis, fs)]
                    self._fdd_pending_age.pop((axis, fs), None)
                else:
                    self._fdd_pending_age[(axis, fs)] = age
                continue
            del self._fdd_pending[(axis, fs)]
            self._fdd_pending_age.pop((axis, fs), None)

            def aligned(min_len: int):
                """Roster + aligned records for a consumer needing at least
                ``min_len`` common samples.

                Records shorter than the consumer's own minimum are dropped
                from ITS roster instead of dragging the whole group's common
                length below the threshold - at array scale one truncated or
                rate-decimated record otherwise silently kills every FDD
                report (observed: 0 decompositions in a 256-sensor soak).
                The common length is then quantized DOWN to the 256 grid, as
                the JAX gateway does to bound its compiled programs (kept
                here for equal reports).  Losing < 256 trailing samples is
                statistically negligible for Welch/correlation estimates.
                """
                sel = sorted(a for a in by_addr
                             if len(by_addr[a][0]) >= min_len)
                if len(sel) < self.config.fdd_min_sensors:
                    return None, None
                t = min(len(by_addr[a][0]) for a in sel)
                t = max(t - (t % 256), min(t, 256))
                return sel, np.stack([by_addr[a][0][:t] for a in sel])

            n_group = len(by_addr)
            if self.config.fdd_report:
                sel, records = aligned(2 * self.config.fdd_window)
                if sel is None:
                    self.history(
                        f"\t[FDD] {axis}: {n_group} sensors but fewer than "
                        f"{self.config.fdd_min_sensors} carry the "
                        f"{2 * self.config.fdd_window} common samples "
                        f"(2*window) a decomposition needs, skipping\n"
                    )
                else:
                    if len(sel) < n_group:
                        self.history(
                            f"\t[FDD] {axis}: {n_group - len(sel)} record(s) "
                            f"shorter than 2*window={2 * self.config.fdd_window} "
                            f"dropped from the decomposition roster\n"
                        )
                    self._fdd_run(axis, fs, sel, records)
            if self.config.ssi_report:
                sel, records = aligned(8 * self.config.ssi_block_rows)
                if sel is None:
                    self.history(
                        f"\t[SSI] {axis}: {n_group} sensors but fewer than "
                        f"{self.config.fdd_min_sensors} carry the "
                        f"{8 * self.config.ssi_block_rows} common samples "
                        f"(8*block_rows) identification needs, skipping\n"
                    )
                else:
                    if len(sel) < n_group:
                        self.history(
                            f"\t[SSI] {axis}: {n_group - len(sel)} record(s) "
                            f"shorter than 8*block_rows="
                            f"{8 * self.config.ssi_block_rows} dropped from "
                            f"the identification roster\n"
                        )
                    self._ssi_run(axis, fs, sel, records)
        if self._modal_trackers or self._ssi_trackers:
            # One durability flush per sync boundary (same policy as the
            # drift state): the trackers' birth baselines must survive a
            # process restart.
            self._save_modal_state()

    def _decimate_merge_pending(self) -> None:
        """Fuse pending same-axis modal groups across ODRs (modal_decimate).

        A mixed-rate array (the ODR grid is dyadic, so deployed mixes
        divide evenly) would otherwise split into per-rate groups that
        each miss ``fdd_min_sensors``; faster groups are anti-alias
        decimated (``ops/resample.py`` - time-aligned with natively slow
        channels by construction) and merged onto the axis's slowest
        rate.  Non-integer ratios keep their separate groups; a sensor
        already present at the base rate is never overwritten.
        """
        from apda_fft_tpu_torch.ops.resample import decimate, decimation_factor

        by_axis: dict[str, list[float]] = {}
        for axis, fs in self._fdd_pending:
            by_axis.setdefault(axis, []).append(fs)
        for axis, rates in by_axis.items():
            if len(rates) < 2:
                continue
            fs_base = min(rates)
            for fs in sorted(r for r in rates if r != fs_base):
                q = decimation_factor(fs, fs_base)
                if q is None:
                    continue  # non-integer ratio: stays its own group
                src = self._fdd_pending.pop((axis, fs))
                self._fdd_pending_age.pop((axis, fs), None)
                dst = self._fdd_pending.setdefault((axis, fs_base), {})
                for addr, (samples, ts) in src.items():
                    if addr in dst:
                        continue
                    try:
                        dec = decimate(
                            np.asarray(samples, np.float64), q, device=self.device
                        ).astype(np.float32)
                    except ValueError as exc:
                        self.history(
                            f"\t[WARN] cannot decimate {axis} record from "
                            f"{addr} ({fs} -> {fs_base} Hz): {exc}\n"
                        )
                        continue
                    dst[addr] = (dec, ts)
                    self.history(
                        f"\t[FDD] decimated {axis} record from {addr} "
                        f"{fs:g} -> {fs_base:g} Hz for the array report\n"
                    )

    def _fdd_run(self, axis: str, fs: float, addrs: list,
                 records: np.ndarray) -> None:
        """FDD + EFDD + mode-shape tracking over one aligned record group."""
        t = records.shape[1]
        window = self.config.fdd_window
        if t < 2 * window:
            self.history(
                f"\t[FDD] {axis}: {len(addrs)} sensors but only {t} common "
                f"samples (< 2*window={2 * window}), skipping\n"
            )
            return
        try:
            from apda_fft_tpu_torch.models.modal import fdd

            res = fdd(records, fs, window, efdd=True,
                      harmonics=self.config.harmonic_check, device=self.device)
        except Exception as exc:  # noqa: BLE001 - report-only path
            self.history(f"\t[WARN] FDD failed for axis {axis}: {exc}\n")
            return
        hmask = res.harmonic_mask()
        n = int(res.count)
        self.history(
            f"\t[FDD] {axis}: {len(addrs)} sensors "
            f"({', '.join(addrs)}), window {window}, {n} mode(s)\n"
        )
        for i in range(n):
            comps = " ".join(
                f"{re:+.3f}{im:+.3f}j"
                for re, im in zip(res.shape_re[i], res.shape_im[i])
            )
            line = (f"\t[FDD]   f={res.freq[i]:.4f} Hz "
                    f"damping={res.damping[i]:.2f}% "
                    f"s2/s1={res.sv_ratio[i]:.3f} shape=[{comps}]")
            if np.isfinite(res.damping_efdd[i]):
                line += f" efdd={res.damping_efdd[i]:.3f}%"
            if self.config.harmonic_check and np.isfinite(res.kurtosis[i]):
                line += f" kurt={res.kurtosis[i]:.2f}"
                if hmask[i]:
                    line += " HARMONIC"
            self.history(line + "\n")
        if self.config.fdd_mac_alert > 0:
            # Tracker keyed by the sensor ROSTER, not just (axis, fs):
            # shapes from different sensor sets have different lengths
            # and orderings, so comparing them is meaningless (and a
            # length change would raise out of modal_assurance).  A
            # roster change simply starts a fresh tracker/baseline.
            try:
                from apda_fft_tpu_torch.models.modal import ModalTracker

                mt = self._lru_tracker(
                    self._modal_trackers, (axis, fs, tuple(addrs)),
                    lambda: ModalTracker(mac_alert=self.config.fdd_mac_alert),
                )
                mt.update(res, t=self.clock().timestamp())
                for tr in mt.shape_alerts():
                    if tr.alerted:
                        continue
                    tr.alerted = True
                    self._alert(
                        "fdd_shape",
                        f"\t[ALERT] FDD mode-shape change: {axis} "
                        f"f={tr.last_freq:.4f} Hz MAC={tr.sustained_mac():.3f} "
                        f"vs baseline (track {tr.track_id})\n",
                        axis=axis, freq=round(float(tr.last_freq), 4),
                        mac=round(float(tr.sustained_mac()), 3),
                        track=tr.track_id,
                    )
            except Exception as exc:  # noqa: BLE001 - report-only path
                self.history(f"\t[WARN] FDD tracking failed: {exc}\n")

    def _ssi_run(self, axis: str, fs: float, addrs: list,
                 records: np.ndarray) -> None:
        """SSI-COV time-domain modal report over one aligned record group.

        Beyond-reference capability (`models/ssi.py`): stabilized state-space
        poles give off-grid eigenfrequencies and pole damping — the damping
        number the FDD half-power estimate can only bound.  Report-only like
        the FDD path: failures warn and move on.
        """
        t = records.shape[1]
        i_rows = self.config.ssi_block_rows
        if t < 8 * i_rows:
            self.history(
                f"\t[SSI] {axis}: {len(addrs)} sensors but only {t} common "
                f"samples (< 8*block_rows={8 * i_rows}), skipping\n"
            )
            return
        try:
            from apda_fft_tpu_torch.models.ssi import ssi

            res = ssi(records, fs, i=i_rows, device=self.device)
        except Exception as exc:  # noqa: BLE001 - report-only path
            self.history(f"\t[WARN] SSI failed for axis {axis}: {exc}\n")
            return
        self.history(
            f"\t[SSI] {axis}: {len(addrs)} sensors "
            f"({', '.join(addrs)}), block rows {i_rows}, "
            f"{res.count} stabilized mode(s)\n"
        )
        kap = None
        if self.config.harmonic_check and res.modes:
            try:
                from apda_fft_tpu_torch.models.modal import harmonic_indicator

                kap = harmonic_indicator(
                    records, fs, [m.freq for m in res.modes],
                    window=min(1024, 2 ** int(np.log2(records.shape[-1]))),
                    device=self.device,
                )
            except Exception as exc:  # noqa: BLE001 - report-only path
                self.history(f"\t[WARN] SSI harmonic check failed: {exc}\n")
        for j, m in enumerate(res.modes):
            comps = " ".join(
                f"{c.real:+.3f}{c.imag:+.3f}j" for c in m.shape
            )
            line = (
                f"\t[SSI]   f={m.freq:.4f} Hz damping={m.damping:.3f}% "
                f"orders={m.n_orders} mpc={m.mpc:.3f} shape=[{comps}]"
            )
            if kap is not None and np.isfinite(kap[j]):
                line += f" kurt={kap[j]:.2f}"
                if kap[j] < 2.2:
                    line += " HARMONIC"
            self.history(line + "\n")
        if self.config.ssi_damping_alert > 0:
            # Damping-trend tracking on SSI poles (roster-keyed like the
            # FDD shape trackers): sustained damping rise vs the track's
            # birth value is the early cracking/loosening indicator, and
            # pole damping - unlike the half-power width - is stable
            # enough to trend.  One [ALERT] per track.
            try:
                from apda_fft_tpu_torch.models.modal import ModalTracker

                mt = self._lru_tracker(
                    self._ssi_trackers, (axis, fs, tuple(addrs)), ModalTracker
                )
                mt.update(res, t=self.clock().timestamp())
                for tr in mt.damping_alerts(
                    rel_increase=self.config.ssi_damping_alert
                ):
                    if tr.damping_alerted:
                        continue
                    tr.damping_alerted = True
                    # Window aggregates: the alert fired on these (the rise
                    # cleared 2 combined standard errors - single-epoch SSI
                    # damping is ~15% CoV noise, docs/DESIGN.md), so the
                    # event carries the resolved numbers, not single draws.
                    (mb, sb, _), (mr, sr, _) = tr.damping_windows()
                    self._alert(
                        "ssi_damping",
                        f"\t[ALERT] SSI damping increase: {axis} "
                        f"f={tr.last_freq:.4f} Hz "
                        f"damping {mb:.3f}%(+-{sb:.3f}) -> "
                        f"{mr:.3f}%(+-{sr:.3f}) "
                        f"(track {tr.track_id})\n",
                        axis=axis, freq=round(float(tr.last_freq), 4),
                        damping_birth_pct=round(float(tr.birth_damping), 3),
                        damping_base_pct=round(mb, 3),
                        damping_base_sem=round(sb, 3),
                        damping_now_pct=round(mr, 3),
                        damping_now_sem=round(sr, 3),
                        track=tr.track_id,
                    )
            except Exception as exc:  # noqa: BLE001 - report-only path
                self.history(f"\t[WARN] SSI tracking failed: {exc}\n")

    _FDD_PENDING_MAX_AGE = 4  # sync flushes an under-min group survives
    _FDD_ALIGN_TOL_S = 300.0  # max filename-timestamp spread within one run

    _DRIFT_TRACK_KEEP = 512  # archived-track cap per (sensor, axis)

    def _lru_tracker(self, trackers: dict, key, factory, cap: int = 64):
        """Fetch-or-create ``trackers[key]``, bounding the dict LRU-style.

        Re-inserts the touched key at the end (dicts preserve insertion
        order) BEFORE evicting, so the tracker being updated this sync can
        never be the one dropped — a plain ``setdefault`` + pop-oldest
        would evict a long-lived active roster whose key happened to be
        insertion-oldest, silently destroying its damage baseline.
        ``tracker_evictions`` counts drops (observability: at array scale
        roster churn past the cap is expected and must stay bounded, not
        silent - benchmarks/scale_soak.py gates on it).
        """
        mt = trackers.pop(key, None)
        if mt is None:
            mt = factory()
        trackers[key] = mt
        while len(trackers) > cap:
            trackers.pop(next(iter(trackers)))
            self.tracker_evictions += 1
        return mt

    @staticmethod
    def _modal_key_str(key: tuple) -> str:
        axis, fs, addrs = key
        return f"{axis}|{fs}|{','.join(addrs)}"

    @staticmethod
    def _modal_key_tuple(s: str) -> tuple:
        axis, fs, addrs = s.split("|", 2)
        return (axis, float(fs), tuple(a for a in addrs.split(",") if a))

    def _load_modal_state(self) -> None:
        from apda_fft_tpu_torch.models.modal import ModalTracker

        try:
            with open(self._modal_state_path) as fh:
                state = json.load(fh)
            modal = {
                self._modal_key_tuple(k): ModalTracker.from_dict(d)
                for k, d in state.get("fdd", {}).items()
            }
            ssi = {
                self._modal_key_tuple(k): ModalTracker.from_dict(d)
                for k, d in state.get("ssi", {}).items()
            }
        except FileNotFoundError:
            return
        except Exception as exc:  # noqa: BLE001 - corrupt state starts fresh
            self.history(f"\t[WARN] modal state unreadable ({exc}), starting fresh\n")
            return
        self._modal_trackers = modal
        self._ssi_trackers = ssi

    def _save_modal_state(self) -> None:
        state = {
            "fdd": {self._modal_key_str(k): mt.to_dict()
                    for k, mt in self._modal_trackers.items()},
            "ssi": {self._modal_key_str(k): mt.to_dict()
                    for k, mt in self._ssi_trackers.items()},
        }
        tmp = self._modal_state_path + ".tmp"
        try:
            with open(tmp, "w") as fh:
                json.dump(state, fh)
                fh.flush()
                os.fsync(fh.fileno())  # durable before the atomic rename
            os.replace(tmp, self._modal_state_path)
        except OSError as exc:
            self.history(f"\t[WARN] modal state not saved ({exc})\n")
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _load_drift_state(self) -> None:
        try:
            with open(self._drift_state_path) as fh:
                state = json.load(fh)
            # Schema errors (truncated write, hand-edited file) must start
            # fresh exactly like parse errors - never block gateway startup.
            trackers = {}
            for key, tr_d in state.get("trackers", {}).items():
                addr, _, axis = key.partition("/")
                trackers[(addr, axis)] = PeakTracker.from_dict(tr_d)
            alerted = {(a, x, int(tid)) for a, x, tid in state.get("alerted", [])}
            severity_over = {(a, x) for a, x in state.get("severity_over", [])}
        except FileNotFoundError:
            return
        except Exception as exc:  # noqa: BLE001 - corrupt state starts fresh
            self.history(f"\t[WARN] drift state unreadable ({exc}), starting fresh\n")
            return
        self.trackers = trackers
        self._alerted = alerted
        # The severity latch persists with the other alert-dedup state:
        # without it, a persistently-over sensor re-fires one duplicate
        # severity alert per gateway restart (edge-trigger re-armed).
        self._severity_over = severity_over

    def _save_drift_state(self) -> None:
        # Drop alert markers whose tracks no longer exist anywhere (pruned
        # past the archive cap) - keeps the dedup set and the state file
        # bounded under long-term track churn.
        live_ids = {
            (addr, axis, tr.track_id)
            for (addr, axis), tk in self.trackers.items()
            for tr in tk._tracks + tk._archive
        }
        self._alerted &= live_ids
        state = {
            "trackers": {
                f"{addr}/{axis}": tr.to_dict()
                for (addr, axis), tr in self.trackers.items()
            },
            "alerted": [[a, x, tid] for a, x, tid in sorted(self._alerted)],
            "severity_over": [[a, x] for a, x in sorted(self._severity_over)],
        }
        tmp = self._drift_state_path + ".tmp"
        try:
            with open(tmp, "w") as fh:
                json.dump(state, fh)
                fh.flush()
                os.fsync(fh.fileno())  # durable before the atomic rename
            os.replace(tmp, self._drift_state_path)
        except OSError as exc:
            self.history(f"\t[WARN] drift state not saved ({exc})\n")
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _store_result(self, addr, axis, rp, metrics,
                      temperature: float | None = None) -> None:
        """Fill the per-axis peak dict (reference fft_dict shape, :648-659)."""
        entry = {
            "peak_freq": -1, "max_mag": -1,
            "process_time": metrics.get("process_time", -1),
            "wall_time": metrics.get("wall_time", -1),
            "percentage_cpu": metrics.get("percentage_cpu", -1),
            "memrss": metrics.get("memrss", -1),
        }
        mode = self.pipeline.config.mode
        for slot in range(rp.count):
            # Host-side float64 finisher (shared with the batching API):
            # frequencies are exact once the peak index is known.
            entry[f"peak_freq_{slot + 1}"] = rp.exact_freq(slot, mode)
            entry[f"max_mag_{slot + 1}"] = float(rp.result.mag[rp.row, slot])
        if rp.count:
            entry["peak_freq"] = entry["peak_freq_1"]
            entry["max_mag"] = entry["max_mag_1"]
        self.fft_results.setdefault(addr, {})[axis] = entry
        self._track_drift(addr, axis, rp, entry, rp.count, temperature)

    def _track_drift(self, addr: str, axis: str, rp, entry: dict, count: int,
                     temperature: float | None = None) -> None:
        rel = self.config.drift_alert_rel
        if rel <= 0:
            return
        tracker = self.trackers.setdefault((addr, axis), PeakTracker())
        # Sub-bin refined frequencies when the pipeline computed them: drift
        # below one bin (the early damage signal) is invisible in the
        # bin-quantized entry freqs, and at low frequencies a single bin
        # jump can exceed the tracker's match window and break the track.
        freqs = []
        for s in range(count):
            refined = float(getattr(rp.result, "refined_freq")[rp.row, s]) \
                if getattr(rp.result, "refined_freq", None) is not None else 0.0
            freqs.append(refined if refined > 0 else entry[f"peak_freq_{s + 1}"])
        mags = [entry[f"max_mag_{s + 1}"] for s in range(count)]
        tracker.update_freqs(freqs, mags, temp=temperature)
        tracker.prune_archive(min_length=2)  # drop 1-epoch noise births
        if len(tracker._archive) > self._DRIFT_TRACK_KEEP:
            tracker._archive = tracker._archive[-self._DRIFT_TRACK_KEEP:]
        self._drift_state_dirty = True
        compensate = self.config.drift_temp_compensate
        for tr in tracker.alerts(rel_drift=rel, min_length=5,
                                 compensate_temperature=compensate):
            key = (addr, axis, tr.track_id)
            if key in self._alerted:
                continue
            self._alerted.add(key)
            comp = tr.compensated_drift_relative() if compensate else None
            drift = comp if comp is not None else tr.sustained_drift_relative()
            qual = " (temp-adjusted)" if comp is not None else ""
            self._alert(
                "drift",
                f"\t[ALERT] {addr} {axis}-axis: mode near {tr.mean_freq:.3f} Hz "
                f"drifted {drift * 100:+.2f}%{qual} over "
                f"{max(tr.observed, len(tr))} acquisitions "
                f"({tr.freqs[0]:.4f} -> {tr.freqs[-1]:.4f} Hz)\n",
                addr=addr, axis=axis,
                freq=round(float(tr.mean_freq), 4),
                drift_pct=round(float(drift * 100), 2),
                temp_compensated=qual != "",
            )
            # An alert is the state worth surviving a crash: flush now so
            # the dedup marker and the track behind it are durable.
            self._save_drift_state()
            self._drift_state_dirty = False

    def _merged_axis_results(self, addr: str) -> dict:
        return self.fft_results.get(addr, {})

    def _peaks_report(self, addr: str) -> str:
        """Per-axis peak listing for the history log.

        The reference's sync-time report could never print peaks because it
        read flat keys from a nested dict (defect 1); reading per-axis here
        restores the intended output.
        """
        parts = []
        for axis, entry in self.fft_results.get(addr, {}).items():
            i = 1
            while f"peak_freq_{i}" in entry:
                parts.append(
                    f"{axis} f{i}: {entry[f'peak_freq_{i}']:.4f}Hz "
                    f"(mag: {entry[f'max_mag_{i}']:.4f})"
                )
                i += 1
        if parts:
            return "Peaks: " + " | ".join(parts) + "\n"
        return "Peaks: None or FFT not run\n"

    def _metrics_report(self, addr: str) -> str:
        entries = self.fft_results.get(addr, {})
        m = next(iter(entries.values()), {})
        return (
            f"Process time: {m.get('process_time', -1):.2f}, "
            f"Wall time: {m.get('wall_time', -1):.2f}, "
            f"%CPU: {m.get('percentage_cpu', -1):.2f}, "
            f"RAM: {m.get('memrss', -1):.2f}"
        )

    # -- egress helpers ------------------------------------------------------

    def _submit_async_uploads(self, addr: str) -> None:
        """Schedule this sensor's egress on the worker thread (at most one
        batch in flight per sensor; late/timed-out results never prune, so
        files simply retry at the next sync)."""
        if self._uploads_inflight.get(addr, 0) > 0:
            self.history(f"\t[ASYNC] uploads for {addr} still in flight, deferring\n")
            return
        api_files = list(self.api_queue.get(addr, []))
        ftp_files = list(self.ftp_queue.get(addr, []))
        fft_snapshot = dict(self._merged_axis_results(addr))
        jobs = 0

        if api_files:
            jobs += 1
            self.uploader.submit(
                lambda: self.http_sink.upload(
                    addr, api_files, self.config.data_dir, fft_snapshot, self.history
                ) or [],
                lambda ok: self._async_done(addr, self.api_queue, ok),
                label=f"fastapi:{addr}",
            )
        if ftp_files:
            jobs += 1
            self.uploader.submit(
                lambda: self.ftp_sink.upload(addr, ftp_files, self.history) or [],
                lambda ok: self._async_done(addr, self.ftp_queue, ok),
                label=f"ftp:{addr}",
            )
        if self.influx_sink is None:
            self.influx_queue.pop(addr, None)
        influx_files = list(self.influx_queue.get(addr, []))
        if self.influx_sink is not None and influx_files:
            jobs += 1
            self.influx_queue[addr] = []  # influx drains unconditionally (parity)
            self.uploader.submit(
                lambda: self.influx_sink.upload(addr, influx_files, fft_snapshot, self.history),
                lambda _: self._async_done(addr, None, []),
                label=f"influx:{addr}",
            )
        if jobs:
            self._uploads_inflight[addr] = jobs

    def _async_done(self, addr: str, queue: dict | None, uploaded: list[str]) -> None:
        # Prune only - NEVER delete files here.  A callback that deleted
        # checked just the FTP queue, so an uploaded-by-FTP file still
        # pending in the API queue (or being read by the in-flight influx
        # job) was removed, poisoning those paths with permanent
        # FILE-NOT-FOUND retries.  Deletion is the sync-time cleanup's job
        # (which checks every queue and defers while uploads are in flight),
        # matching the reference's delete-at-sync lifecycle.
        if queue is not None:
            self._prune(queue, addr, uploaded)
        self._uploads_inflight[addr] = max(self._uploads_inflight.get(addr, 1) - 1, 0)

    def _send_config(self, addr: str) -> str:
        delay = self.devices.delay_for(addr)
        row = self.sensor_configs.lookup(addr)
        if row is not None:
            hexstr = packets.build_config_packet(row, delay)
            status = "Sent reconfiguration\n"
        else:
            hexstr = packets.build_sync_packet(delay)
            status = "Sync sent\n"
        self.transport.send(addr, hexstr, self.history)
        return status

    def _flush_ftp(self, addr: str) -> list[str]:
        files = self.ftp_queue.get(addr, [])
        if not files:
            return []
        return self.ftp_sink.upload(addr, files, self.history)

    def _flush_influx(self, addr: str) -> None:
        if self.influx_sink is None:
            self.influx_queue.pop(addr, None)
            return
        files = self.influx_queue.get(addr, [])
        if files:
            self.influx_sink.upload(addr, files, self._merged_axis_results(addr), self.history)

    @staticmethod
    def _prune(queue: dict[str, list[str]], addr: str, uploaded: list[str]) -> None:
        pending = queue.get(addr, [])
        for name in uploaded:
            if name in pending:
                pending.remove(name)
