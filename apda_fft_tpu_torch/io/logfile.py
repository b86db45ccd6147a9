"""Sensor acquisition log files: the gateway's durable on-disk format.

Format (written by the reference's 0xD1 handler, ``GT_FFT_v5.py:402-406``, and
parsed back by ``utils/load_data.py:29-82``):

* row 0: ``time;range;odr;axis_file;``       (header)
* row 1: ``sync;``                            (sync state)
* row 2: ``temp;rms_x;rms_y;rms_z;humidity;`` (summary - four decoded
  half-float means plus last-known humidity)
* row 3: ``first_x;first_y;first_z;``         (acceleration baselines)
* rows 4+: ``v1;v2;v3;...``                   ("%8.6f" samples, appended
  incrementally as stream packets arrive; error markers like
  ``* MISSING PACKETS FROM a TO b *`` may be interleaved)

Files survive gateway restarts and remain until successfully uploaded - this
is the system's only durability mechanism (SURVEY.md section 5).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class SensorLog:
    """Parsed acquisition record (parity with ``load_sensor``'s dict)."""

    timestamp: str
    sensitivity: str
    fs: float
    axis: str
    sync_type: str
    is_synced: float
    temperature: float
    rms_x: float
    rms_y: float
    rms_z: float
    humidity: float
    first_x: float
    first_y: float
    first_z: float
    #: list[float] from the file loader; float64 ndarray from the in-memory
    #: builder (identical values either way - both sides of the "%8.6f"
    #: quantization contract).
    samples: list[float] | np.ndarray

    def as_dict(self) -> dict:
        """Reference-shaped {"metadata", "summary", "samples"} dict."""
        return {
            "metadata": {
                "timestamp": self.timestamp,
                "sensitivity": self.sensitivity,
                "fs": self.fs,
                "axis": self.axis,
                "sync_type": self.sync_type,
                "is_synced": self.is_synced,
            },
            "summary": {
                "temperature": self.temperature,
                "rms_x": self.rms_x,
                "rms_y": self.rms_y,
                "rms_z": self.rms_z,
                "humidity": self.humidity,
                "first_x": self.first_x,
                "first_y": self.first_y,
                "first_z": self.first_z,
            },
            "samples": self.samples,
        }


def _from_header_lines(lines: list[str], samples) -> SensorLog:
    """Build a SensorLog from the 4 header rows + parsed samples.

    The one place the header-field derivation lives: the file loader and the
    in-memory builder both call it, so the memory-fed analysis path cannot
    drift from ``utils/load_data.py:40-64`` semantics (``" Hz"`` strip on fs,
    ``" axis"`` strip + space->underscore on the axis label, ...).
    """
    header = lines[0].strip().split(";")
    sync_raw = lines[1].strip().replace(";", "")
    summary = lines[2].strip().split(";")
    firsts = lines[3].strip().split(";")
    return SensorLog(
        timestamp=header[0],
        sensitivity=header[1].replace(" ", ""),
        fs=float(header[2].replace(" Hz", "")),
        axis=header[3].replace(" axis", "").replace(" ", "_"),
        sync_type=sync_raw,
        is_synced=1.0 if sync_raw in ("Synced", "Synced2") else 0.0,
        temperature=float(summary[0]),
        rms_x=float(summary[1]),
        rms_y=float(summary[2]),
        rms_z=float(summary[3]),
        humidity=float(summary[4]),
        first_x=float(firsts[0]),
        first_y=float(firsts[1]),
        first_z=float(firsts[2]),
        samples=samples,
    )


def load_sensor_log(filepath: str | os.PathLike) -> SensorLog | None:
    """Parse a gateway log file; None if under 5 lines (integrity check).

    Parity with ``utils/load_data.py:29-82`` including: ``" Hz"`` strip on fs,
    ``" axis"`` strip + space->underscore on the axis label, non-numeric
    tokens skipped, non-finite samples dropped.
    """
    with open(filepath, "r", encoding="utf-8") as fh:
        lines = fh.readlines()
    if len(lines) < 5:
        return None

    # Sample region (rows 4+): hot path, natively parsed when the C++
    # data-loader is available (csrc/apda_io.cc); parse_samples itself
    # carries the NumPy fallback, so the token rules live in exactly two
    # places (C and the fallback), not three.
    from apda_fft_tpu_torch.io import native

    samples = native.parse_samples("".join(lines[4:])).tolist()
    return _from_header_lines(lines, samples)


class SensorLogBuilder:
    """In-memory twin of an acquisition log file being written.

    The reference analyzes by re-parsing the file it just wrote from
    already-decoded samples (``work_flow_fft`` -> ``load_sensor``,
    ``GT_FFT_v5.py:627`` -> ``utils/load_data.py:29-82``) - pure overhead on
    the analysis critical path.  The builder accumulates the SAME record in
    memory while packets stream in: it holds the exact header LINES the file
    got and the samples quantized through the on-disk ``"%8.6f"`` contract
    (``io/native.py:append_half_payload_quantized``), so :meth:`finish`
    returns a SensorLog bit-identical to what ``load_sensor_log(path)``
    would parse back.  The file stays on disk as the durability/upload
    artifact only; re-parse happens only on recovery paths.
    """

    __slots__ = ("_header_lines", "_chunks", "_n")

    def __init__(self, header_lines: list[str]):
        self._header_lines = list(header_lines)
        self._chunks: list[np.ndarray] = []
        self._n = 0

    def append(self, quantized: np.ndarray) -> None:
        """Add one packet's quantized finite samples (may be empty)."""
        if len(quantized):
            self._chunks.append(np.asarray(quantized, np.float64))
            self._n += len(quantized)

    def __len__(self) -> int:
        return self._n

    def finish(self) -> SensorLog | None:
        """The record a file re-parse would return; None when no sample
        bytes were ever appended (mirror of the loader's 5-line integrity
        check - a header-only file has 4 lines and loads as None)."""
        if not self._chunks:
            return None
        samples = (
            np.concatenate(self._chunks)
            if len(self._chunks) > 1 else self._chunks[0]
        )
        return _from_header_lines(self._header_lines, samples)


def acquisition_header_lines(
    time_str: str,
    range_str: str,
    odr_str: str,
    axis_file: str,
    sync: str,
    means: list[str],
    humidity: float,
    baselines: tuple[float, float, float],
) -> list[str]:
    """The 4 header rows as written to disk (``GT_FFT_v5.py:402-406``) -
    shared by the file writer and the in-memory :class:`SensorLogBuilder`
    so both sides of the memory-fed analysis parity hold by construction."""
    return [
        f"{time_str};{range_str};{odr_str};{axis_file};\n",
        f"{sync};\n",
        f"{';'.join(means)};{humidity};\n",
        f"{baselines[0]};{baselines[1]};{baselines[2]};\n",
    ]


def write_acquisition_header(
    filepath: str | os.PathLike,
    time_str: str,
    range_str: str,
    odr_str: str,
    axis_file: str,
    sync: str,
    means: list[str],
    humidity: float,
    baselines: tuple[float, float, float],
) -> None:
    """Create a log file with the 4 header rows (``GT_FFT_v5.py:402-406``)."""
    with open(filepath, "w+") as fh:
        fh.writelines(acquisition_header_lines(
            time_str, range_str, odr_str, axis_file, sync,
            means, humidity, baselines,
        ))


def append_samples(filepath: str | os.PathLike, formatted: list[str]) -> None:
    """Append ``"%8.6f"``-formatted samples, ';'-joined (``GT_FFT_v5.py:177-179``)."""
    with open(filepath, "a") as fh:
        for s in formatted:
            fh.write(s + ";")


def append_sample_values(filepath: str | os.PathLike, values: np.ndarray) -> None:
    """Append raw sample values, rendering "%8.6f;" tokens natively when possible."""
    from apda_fft_tpu_torch.io import native

    with open(filepath, "a") as fh:
        fh.write(native.format_samples(np.asarray(values, np.float64)))


def append_marker(filepath: str | os.PathLike, marker: str) -> None:
    """Append an inline error marker (``GT_FFT_v5.py:723,734``)."""
    with open(filepath, "a") as fh:
        fh.write(marker)


def samples_array(log: SensorLog) -> np.ndarray:
    return np.asarray(log.samples, dtype=np.float64)
