"""Device-health telemetry: decoded 0xA1 heartbeats -> status report.

Parity with ``check_device`` (``GT_FFT_v5.py:579-616``): battery, RSSI,
temperature/humidity, reset bit, GPS/PPS state, ADXL362/ADXL355/memory error
flags, radio error code, and config-bit sanity flags.
"""

from __future__ import annotations

from apda_fft_tpu_torch.io.packets import SyncInfo

GPS_STATES = {0: "no signal", 1: "connected, pps ok"}

CONFIG_BIT_MESSAGES = (
    (0x01, "Config bits on range high"),
    (0x02, "Config bits on ODR high"),
    (0x04, "Config bits on axis all set to zero"),
    (0x08, "Config bits on samples high"),
)


def device_status_report(info: SyncInfo) -> str:
    """Human-readable health summary, one line per signal."""
    out = [f"Datetime: {info.datetime}"]
    if info.battery is not None:
        out.append(f"Battery: {info.battery:.3f} V")
    if info.rssi is not None:
        out.append(f"RSSI: {info.rssi} dB")
    if info.temp is not None:
        out.append(f"Temperature: {info.temp:.2f} C")
    if info.humidity is not None:
        out.append(f"Humidity: {info.humidity:.2f}")
    if info.reset_bit is not None:
        out.append(f"Reset bit: {info.reset_bit}")
    out.append(f"GPS: {GPS_STATES.get(info.gps_status, 'connected no pps')}")

    for key, name in (("362", "ADXL362"), ("355", "ADXL355"), ("mem", "Memory")):
        code = info.errors[key]
        if code == 1:
            out.append(f"{name}: Error")
        elif code != 0:
            out.append(f"{name} bit error: {code:x}")
    if info.errors["radio"] != 0:
        out.append(f"Radio error code: {info.errors['radio']}")
    for bit, msg in CONFIG_BIT_MESSAGES:
        if info.errors["config"] & bit:
            out.append(msg)
    return "\n\t".join(out) + "\n"


def has_hardware_fault(info: SyncInfo) -> bool:
    """True when any hardware error flag is raised - failure-detection hook."""
    return any(v != 0 for v in info.errors.values())
