"""Gateway configuration: gw_config.json, per-sensor config.txt, devices.txt.

Three config surfaces, mirroring the reference (``GT_FFT_v5.py:114-144,
224-234, 567-575`` and README.md):

* ``gw_config.json`` - egress credentials/URLs, file paths, and the one
  behavioral flag ``is_flexibile_structure`` (typo preserved: it is the
  load-bearing key name in deployed configs; the correctly spelled
  ``is_flexible_structure`` is also accepted).
* ``config.txt`` - one row per sensor: 16-char MAC + 17 space-separated
  hardware tokens, compiled into the 0xA2 packet.  The reference re-reads
  this on every packet (hot reload); we cache on mtime instead.
* ``devices.txt`` - append-only runtime registry MAC -> TDMA delay.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path


class GatewayConfigError(RuntimeError):
    """Fatal configuration problem (the reference's only fatal path, ``:141-144``)."""


@dataclasses.dataclass
class FtpSettings:
    server: str = ""
    user: str = ""
    pwd: str = ""
    path: str = ""


@dataclasses.dataclass
class GatewayConfig:
    ftp: FtpSettings
    fastapi_url: str
    influx_url: str
    influx_token: str
    logger_file: str
    device_file: str
    config_file: str
    data_dir: str
    is_flexible_structure: bool = True
    #: accepted for config-file compatibility with the JAX gateway, where
    #: it names an on-disk compilation cache; the port has no such cache
    #: and ignores it
    compilation_cache_dir: str = ""
    #: optional spectral-leakage taper for the analysis pipeline
    #: ("none" = reference-parity rectangular; "hann"/"hamming"/"blackman")
    taper: str = "none"
    #: modal-drift alert threshold (relative frequency drift per tracked
    #: mode; 0 disables drift tracking)
    drift_alert_rel: float = 0.02
    #: also run spectral analysis on 0xC1 shock transients (the reference
    #: only uploads them raw; free-decay ring-down is prime damping data)
    analyze_shock: bool = False
    #: compute a Shock Response Spectrum for every 0xC1 transient (Q=10
    #: maximax SDOF bank, ``ops/srs.py``) - the standard damage-potential
    #: characterization; peak SRS + pseudo-velocity land in the history
    #: log, fft_results, and the alert webhook.  Implies shock analysis.
    shock_srs: bool = False
    #: acquisition analysis strategy: "epoch" (reference parity: one
    #: spectrum per file, ``GT_FFT_v5.py:620-679``) or "welch" (segment the
    #: record, average segment power spectra, detect once on the averaged
    #: spectrum - the noise-robust choice for long noisy acquisitions).
    #: Shock transients always use the epoch path: Welch-averaging a
    #: decaying transient smears the ring-down.
    analysis: str = "epoch"
    #: what feeds the analysis batch: "memory" (default) hands the pipeline
    #: the in-memory decoded record, quantized through the same "%8.6f"
    #: contract the on-disk format imposes, as packets stream in - the log
    #: file is still written (durability + upload artifact) but never
    #: re-parsed on the analysis hot path; "file" restores the reference's
    #: write-then-re-parse round-trip (``GT_FFT_v5.py:627``), kept as the
    #: parity/diagnostic mode.  Recovery paths (files without a live
    #: in-memory record, e.g. after a mid-acquisition fault) re-parse the
    #: file in both modes; decisions are bit-identical (tests/test_memfeed).
    analysis_feed: str = "memory"
    #: Welch segment length in samples (padded to the next power of two)
    welch_window: int = 1024
    #: Welch hop in samples; 0 = 50% overlap (the standard Welch choice)
    welch_hop: int = 0
    #: Welch segment taper (independent of ``taper``, which stays
    #: reference-parity rectangular by default for the epoch path)
    welch_taper: str = "hann"
    #: array-level modal report: when >= fdd_min_sensors sensors deliver
    #: same-axis acquisitions at one sampling rate in an analysis batch,
    #: run FDD (cross-spectral SVD) over the aligned records and append
    #: the identified modes + mode shapes to the history log
    fdd_report: bool = False
    #: FDD CSD segment length in samples (padded to the next power of two)
    fdd_window: int = 1024
    #: minimum simultaneously delivered same-axis sensors for an FDD run
    fdd_min_sensors: int = 2
    #: sustained-MAC alert threshold for tracked FDD mode shapes (a mode
    #: whose median-of-3 MAC vs its birth shape drops below this writes one
    #: [ALERT] history line - the shape-based damage indicator); 0 disables
    fdd_mac_alert: float = 0.9
    #: array-level time-domain modal report: run SSI-COV (stochastic
    #: subspace identification, models/ssi.py) over the same aligned
    #: multi-sensor record groups the FDD report uses, appending
    #: stabilized modes (off-grid frequency + pole damping + shape) as
    #: [SSI] history lines at the sync boundary.  Independent of
    #: ``fdd_report`` (either enables the group accumulation).
    ssi_report: bool = False
    #: SSI Hankel block rows; correlation horizon = 2*block_rows/fs seconds
    ssi_block_rows: int = 20
    #: temperature-compensate drift alerts: fit each track's baseline
    #: freq-vs-temperature slope (acquisition summaries carry the sensor
    #: temperature) and alert on the thermal-model residual, so daily and
    #: seasonal swings neither fake stiffness loss nor mask it; tracks
    #: without an identifiable model fall back to raw drift
    drift_temp_compensate: bool = False
    #: fuse pending same-axis modal groups recorded at different ODRs onto
    #: the slowest rate (anti-aliased decimation, ops/resample.py) so a
    #: mixed-rate array still yields ONE cross-sensor FDD/SSI report;
    #: non-integer rate ratios keep their separate groups
    modal_decimate: bool = False
    #: narrowband-kurtosis harmonic check on reported FDD/SSI modes:
    #: machinery harmonics (kurtosis ~1.5, vs ~3 for stochastic structural
    #: response) get a HARMONIC tag in the report lines - the classic OMA
    #: false-mode source on instrumented structures with HVAC/generators
    harmonic_check: bool = False
    #: sustained-damping alert threshold for tracked SSI modes, as a
    #: RELATIVE increase vs the track's birth damping (0.5 = +50%): rising
    #: modal damping is the classic early cracking/loosening indicator,
    #: and SSI pole damping is reliable enough to trend; 0 disables
    ssi_damping_alert: float = 0.0
    #: per-acquisition ISO 10816/20816 vibration severity: band-limited
    #: velocity RMS (ops/integrate.py velocity_rms, Parseval on the
    #: omega-scaled spectrum) in mm/s for every analyzed regular
    #: acquisition, appended to the history line and fft_results (shock
    #: transients keep their SRS pseudo-velocity instead - severity is a
    #: steady-state quantity)
    vibration_severity: bool = False
    #: severity band (f_lo, f_hi) in Hz; f_hi clamps to Nyquist (ISO
    #: 10816 default 10-1000 Hz)
    severity_band_hz: tuple = (10.0, 1000.0)
    #: severity alert threshold in mm/s (0 disables): crossing it writes
    #: one [ALERT] line + webhook event per excursion (re-arms when the
    #: sensor drops back below; ISO zone C/D boundaries are the natural
    #: values, e.g. 4.5 / 7.1 mm/s for class II machines)
    severity_alert_mms: float = 0.0
    #: optional HTTP endpoint for [ALERT] events (drift, FDD shape change,
    #: SSI damping rise): each alert POSTs one JSON event; failures queue
    #: and retry at the next sync, so a flaky link cannot lose an alert
    #: that matters.  Empty = history-log only (the reference had no alert
    #: surface at all).
    alert_webhook_url: str = ""
    #: webhook POST timeout in seconds
    alert_webhook_timeout: float = 10.0

    @classmethod
    def load(cls, config_path: str | os.PathLike) -> "GatewayConfig":
        try:
            with open(config_path, "r") as fh:
                cfg = json.load(fh)
            gw = cfg["gateway"]
            flexible = gw.get(
                "is_flexibile_structure", gw.get("is_flexible_structure", True)
            )
            taper = gw.get("taper", "none")
            # lazy: keeps config torch-free until needed
            from apda_fft_tpu_torch.ops.fft import TAPERS

            if taper not in TAPERS:
                # Fail at load like every other config mistake, not at the
                # first epoch analysis in the running gateway.
                raise GatewayConfigError(
                    f"unknown taper {taper!r} in {config_path}; expected one of {TAPERS}"
                )
            analysis = gw.get("analysis", "epoch")
            if analysis not in ("epoch", "welch"):
                raise GatewayConfigError(
                    f"unknown analysis {analysis!r} in {config_path}; "
                    "expected 'epoch' or 'welch'"
                )
            analysis_feed = gw.get("analysis_feed", "memory")
            if analysis_feed not in ("memory", "file"):
                raise GatewayConfigError(
                    f"unknown analysis_feed {analysis_feed!r} in {config_path}; "
                    "expected 'memory' or 'file'"
                )
            welch_window = int(gw.get("welch_window", 1024))
            welch_hop = int(gw.get("welch_hop", 0))
            welch_taper = gw.get("welch_taper", "hann")
            if welch_window < 2:
                raise GatewayConfigError(
                    f"welch_window must be >= 2, got {welch_window} in {config_path}"
                )
            if welch_hop < 0:
                raise GatewayConfigError(
                    f"welch_hop must be >= 0 (0 = 50% overlap), got {welch_hop}"
                )
            if welch_taper not in TAPERS:
                raise GatewayConfigError(
                    f"unknown welch_taper {welch_taper!r} in {config_path}; "
                    f"expected one of {TAPERS}"
                )
            fdd_window = int(gw.get("fdd_window", 1024))
            fdd_min_sensors = int(gw.get("fdd_min_sensors", 2))
            if fdd_window < 4:
                raise GatewayConfigError(
                    f"fdd_window must be >= 4, got {fdd_window} in {config_path}"
                )
            if fdd_min_sensors < 1:
                raise GatewayConfigError(
                    f"fdd_min_sensors must be >= 1, got {fdd_min_sensors}"
                )
            fdd_mac_alert = float(gw.get("fdd_mac_alert", 0.9))
            if not 0.0 <= fdd_mac_alert <= 1.0:
                raise GatewayConfigError(
                    f"fdd_mac_alert must be in [0, 1] (0 disables), got {fdd_mac_alert}"
                )
            ssi_block_rows = int(gw.get("ssi_block_rows", 20))
            if ssi_block_rows < 2:
                raise GatewayConfigError(
                    f"ssi_block_rows must be >= 2, got {ssi_block_rows} in {config_path}"
                )
            ssi_damping_alert = float(gw.get("ssi_damping_alert", 0.0))
            if ssi_damping_alert < 0:
                raise GatewayConfigError(
                    f"ssi_damping_alert must be >= 0 (0 disables), "
                    f"got {ssi_damping_alert}"
                )
            band = gw.get("severity_band_hz", (10.0, 1000.0))
            try:
                severity_band = (float(band[0]), float(band[1]))
            except (TypeError, ValueError, IndexError) as exc:
                raise GatewayConfigError(
                    f"severity_band_hz must be [f_lo, f_hi] in Hz, got {band!r}"
                ) from exc
            if not 0.0 < severity_band[0] < severity_band[1]:
                raise GatewayConfigError(
                    f"severity_band_hz needs 0 < f_lo < f_hi, got {severity_band}"
                )
            severity_alert_mms = float(gw.get("severity_alert_mms", 0.0))
            if severity_alert_mms < 0:
                raise GatewayConfigError(
                    f"severity_alert_mms must be >= 0 (0 disables), "
                    f"got {severity_alert_mms}"
                )
            return cls(
                ftp=FtpSettings(**cfg.get("ftp", {})),
                fastapi_url=cfg.get("fastapi", {}).get("url", ""),
                influx_url=cfg.get("influxdb", {}).get("url", ""),
                influx_token=cfg.get("influxdb", {}).get("token", ""),
                logger_file=gw["logger_file"],
                device_file=gw["device_file"],
                config_file=gw["config_file"],
                data_dir=gw.get(
                    "data_dir", str(Path(gw["logger_file"]).parent) + os.sep
                ),
                is_flexible_structure=bool(flexible),
                compilation_cache_dir=gw.get("compilation_cache_dir", ""),
                taper=taper,
                drift_alert_rel=float(gw.get("drift_alert_rel", 0.02)),
                analyze_shock=bool(gw.get("analyze_shock", False)),
                shock_srs=bool(gw.get("shock_srs", False)),
                analysis=analysis,
                analysis_feed=analysis_feed,
                welch_window=welch_window,
                welch_hop=welch_hop,
                welch_taper=welch_taper,
                fdd_report=bool(gw.get("fdd_report", False)),
                fdd_window=fdd_window,
                fdd_min_sensors=fdd_min_sensors,
                fdd_mac_alert=fdd_mac_alert,
                ssi_report=bool(gw.get("ssi_report", False)),
                ssi_block_rows=ssi_block_rows,
                harmonic_check=bool(gw.get("harmonic_check", False)),
                modal_decimate=bool(gw.get("modal_decimate", False)),
                drift_temp_compensate=bool(
                    gw.get("drift_temp_compensate", False)
                ),
                ssi_damping_alert=ssi_damping_alert,
                vibration_severity=bool(gw.get("vibration_severity", False)),
                severity_band_hz=severity_band,
                severity_alert_mms=severity_alert_mms,
                alert_webhook_url=str(gw.get("alert_webhook_url", "")),
                alert_webhook_timeout=float(gw.get("alert_webhook_timeout", 10.0)),
            )
        except GatewayConfigError:
            raise
        except Exception as exc:  # noqa: BLE001 - any malformed config is fatal
            raise GatewayConfigError(f"cannot load gateway config {config_path}: {exc}") from exc


class SensorConfigFile:
    """mtime-cached view of config.txt: MAC -> 17-token parameter string."""

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._mtime: float | None = None
        self._table: dict[str, str] = {}

    def lookup(self, addr: str) -> str | None:
        self._refresh()
        return self._table.get(addr)

    def _refresh(self) -> None:
        try:
            mtime = os.path.getmtime(self.path)
        except OSError:
            self._table = {}
            self._mtime = None
            return
        if mtime == self._mtime:
            return
        table: dict[str, str] = {}
        with open(self.path, "r") as fh:
            for line in fh:
                # Row layout (GT_FFT_v5.py:230-234): 16-char MAC, space, params.
                if len(line) > 17:
                    table[line[:16]] = line[17:].strip()
        self._table = table
        self._mtime = mtime


class DeviceRegistry:
    """MAC -> TDMA send delay, persisted append-only to devices.txt.

    New devices get ``delay += step`` (2 s in the reference,
    ``GT_FFT_v5.py:567-575``) so sensors transmit staggered.  The file is
    truncated at every gateway start (``:96-97``), resetting assignments.
    """

    def __init__(self, path: str | os.PathLike, step: int = 2):
        self.path = str(path)
        self.step = step
        self._delays: dict[str, int] = {}
        self._next = 0

    def reset(self) -> None:
        self._delays.clear()
        self._next = 0
        with open(self.path, "w+"):
            pass

    def delay_for(self, addr: str) -> int:
        return self._delays.get(addr, 0)

    def known(self, addr: str) -> bool:
        return addr in self._delays

    def register(self, addr: str) -> int:
        delay = self._next
        self._delays[addr] = delay
        self._next += self.step
        with open(self.path, "a") as fh:
            fh.write(addr + " %02d \n" % delay)
        return delay
