"""Wire-protocol codec: sensor packets <-> structured records.

Framed binary packets from battery-powered accelerometer nodes, dispatched on
the first payload byte (reference ``GT_FFT_v5.py:244-260``):

=======  =============================================  ======================
type     meaning                                        reference parser
=======  =============================================  ======================
0xA1     sync request / heartbeat + health telemetry    protocol_decoder.py:177
0xD1     start of acquisition stream                    :191
0xD2     stream continuation (pkt# = p[1]<<8|p[2])      :230
0xD3     end of stream (triggers analysis)              :230
0xD4     reduced data (sensor memory error)             :207
0xC1     shock event                                    :223
=======  =============================================  ======================

Outbound (gateway -> sensor): 0xA1 sync reply and 0xA2 reconfiguration hex
strings (``protocol_decoder.py:35-114``).  The reference hardcodes the minute
field to 55 (``:42-45``, original ``t.minute`` left commented at ``:48-51``);
``legacy_minute55`` preserves that behavior and can be switched off.

This module also *encodes* inbound-style packets (``encode_*``), which the
reference never needed (its sensors are physical); the simulator and tests use
them to exercise the full grammar.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime, timezone

import numpy as np

from apda_fft_tpu_torch.io.halffloat import decode_payload, encode_halves

# Inbound read maps (protocol_decoder.py:5-8).
RANGE_LABELS = {0x01: "2g", 0x02: "4g", 0x03: "8g"}
ODR_LABELS = {0x07: "31.25 Hz", 0x06: "62.5 Hz", 0x05: "125 Hz", 0x04: "250 Hz", 0x03: "500 Hz"}
AXIS_LABELS = {0x01: ("Xaxis", "X axis"), 0x02: ("Yaxis", "Y axis"), 0x03: ("Zaxis", "Z axis")}
SYNC_LABELS = {0: "Asynced", 1: "Synced", 2: "Synced2"}

# Outbound 0xA2 bitmask maps (protocol_decoder.py:16-30).
RANGE_MASK = {"2g": 0x01, "4g": 0x02, "8g": 0x04}
ODR_MASK = {"31_25Hz": 0x08, "62_5Hz": 0x10, "125Hz": 0x20, "250Hz": 0x40, "500Hz": 0x80}
AXIS_MASK = {"X": 0x100, "Y": 0x200, "Z": 0x400, "XY": 0x300, "XZ": 0x500, "YZ": 0x600}
DATAKB_MASK = {"2k": 0x800, "4k": 0x1000, "8k": 0x2000, "16k": 0x4000}
SEND_FREQ_MASK = {"1h": 0x0, "2h": 0x01, "3h": 0x02, "4h": 0x03, "6h": 0x04}
SYNC_TYPE_MASK = {"SYNC1": 0x00}
SCK_FREQ_MASK = {"12_5Hz": 0x08, "25Hz": 0x10, "50Hz": 0x20, "100Hz": 0x40}
SCK_BW_MASK = {"ODR2": 0x100}
SCK_PW_MASK = {"N": 0x400, "L": 0x800}

PACKET_SYNC = 0xA1
PACKET_START = 0xD1
PACKET_MID = 0xD2
PACKET_END = 0xD3
PACKET_REDUCED = 0xD4
PACKET_SHOCK = 0xC1


@dataclasses.dataclass
class SyncInfo:
    """Decoded 0xA1 heartbeat (reference ``parse_sync_info``, ``:177-189``)."""

    datetime: str
    battery: float | None
    rssi: int | None
    temp: float | None
    humidity: float | None
    reset_bit: int | None
    gps_status: int
    errors: dict[str, int]


@dataclasses.dataclass
class StartHeader:
    """Decoded 0xD1 header (reference ``parse_start_header``, ``:191-205``)."""

    time: str
    range: str
    odr: str
    axis_label: str
    axis_file: str
    sync: str
    baselines: tuple[float, float, float]

    @property
    def fs(self) -> float:
        """Sampling rate in Hz parsed from the ODR label."""
        return float(self.odr.replace(" Hz", ""))


@dataclasses.dataclass
class ReducedHeader:
    time: str
    range: str
    odr: str
    axis_file: str
    sync: str


@dataclasses.dataclass
class ShockHeader:
    time: str


def _i32_from_be(b3: int, b2: int, b1: int, b0: int) -> int:
    """Big-endian 4-byte two's-complement int (``protocol_decoder.py:196-198``)."""
    v = (b3 << 24) | (b2 << 16) | (b1 << 8) | b0
    return v - (1 << 32) if v & 0x80000000 else v


def packet_number(p) -> int:
    """0xD2/0xD3 sequence number (``protocol_decoder.py:230-232``)."""
    return (p[1] << 8) | p[2]


def parse_sync_info(p) -> SyncInfo:
    # Every field is length-guarded (not just the tail ones the reference
    # guarded): a radio-truncated heartbeat must degrade to None fields, not
    # IndexError out of the sync handler and cost the sensor its sync reply.
    return SyncInfo(
        datetime=(
            f"{p[1]:x}-{p[2]:x}-{p[3]:x} {p[4]:x}:{p[5]:x}:{p[6]:x}"
            if len(p) > 6 else "truncated"
        ),
        battery=((p[32] + (p[33] << 8)) * 0.001) if len(p) > 33 else None,
        rssi=-p[34] if len(p) > 34 else None,
        temp=((p[35] + (p[36] << 8)) * 0.01) if len(p) > 36 else None,
        humidity=((p[37] + (p[38] << 8)) * 0.01) if len(p) > 38 else None,
        reset_bit=(p[39] + (p[40] << 8)) if len(p) > 40 else None,
        gps_status=p[17] if len(p) > 17 else 0,
        errors={
            "362": p[7] if len(p) > 7 else 0,
            "355": p[8] if len(p) > 8 else 0,
            "mem": p[9] if len(p) > 9 else 0,
            "radio": p[10] if len(p) > 10 else 0,
            "config": p[11] if len(p) > 11 else 0,
        },
    )


def parse_start_header(p) -> StartHeader:
    baselines = (
        _i32_from_be(p[11], p[12], p[13], p[14]) / 1e7,
        _i32_from_be(p[15], p[16], p[17], p[18]) / 1e7,
        _i32_from_be(p[19], p[20], p[21], p[22]) / 1e7,
    )
    axis = AXIS_LABELS.get(p[8], ("UnknownAxis", "bad axis value"))
    return StartHeader(
        time=f"{p[3]:x}:{p[4]:x}:{p[5]:x}",
        range=RANGE_LABELS.get(p[6], "bad range"),
        odr=ODR_LABELS.get(p[7], "bad ODR"),
        axis_label=axis[0],
        axis_file=axis[1],
        sync=SYNC_LABELS.get(p[9], "Unknown"),
        baselines=baselines,
    )


def parse_reduced_header(p) -> ReducedHeader:
    axis = AXIS_LABELS.get(p[8], ("UnknownAxis", "bad axis value"))
    return ReducedHeader(
        time=f"{p[3]:x}:{p[4]:x}:{p[5]:x}",
        range=RANGE_LABELS.get(p[6], "bad range"),
        odr=ODR_LABELS.get(p[7], "bad ODR"),
        axis_file=axis[1],
        sync=SYNC_LABELS.get(p[9], "Unknown"),
    )


def parse_shock_header(p) -> ShockHeader:
    return ShockHeader(time=f"{p[1]:x}:{p[2]:x}:{p[3]:x}")


# ---------------------------------------------------------------------------
# Outbound builders (gateway -> sensor)
# ---------------------------------------------------------------------------


def _timestamp_hex(delay: int, now: datetime | None, legacy_minute55: bool) -> str:
    """yy mm dd hh mm ss + ms(2B) + delay(1B) hex (``protocol_decoder.py:40-53``)."""
    t = now or datetime.now(timezone.utc)
    minute = 55 if legacy_minute55 else t.minute
    return "%02d%02d%02d%02d%02d%02d%04x%02x" % (
        int(str(t.year)[-2:]),
        t.month,
        t.day,
        t.hour,
        minute,
        t.second,
        int(t.microsecond / 1000),
        delay,
    )


def build_sync_packet(delay: int, now: datetime | None = None, legacy_minute55: bool = True) -> str:
    """0xA1 sync reply hex (``protocol_decoder.py:35-53``)."""
    return "a1" + _timestamp_hex(delay, now, legacy_minute55)


def build_config_packet(
    config_str: str,
    delay: int,
    now: datetime | None = None,
    legacy_minute55: bool = True,
) -> str:
    """0xA2 reconfiguration hex from a 17-token config row (``:55-114``).

    Falls back to a plain 0xA1 sync when fewer than 17 tokens are present
    (``:76-77``), like the reference.
    """
    ts = _timestamp_hex(delay, now, legacy_minute55)
    param = config_str.split(" ")
    if len(param) < 17:
        return "a1" + ts

    acc = RANGE_MASK.get(param[0], 0x04)
    odr = ODR_MASK.get(param[1], 0x80)
    ax = AXIS_MASK.get(param[2], 0x700)
    datakb = DATAKB_MASK.get(param[3], 0x8000)
    sending_f = SEND_FREQ_MASK.get(param[4], 0x05)
    sync_f = SYNC_TYPE_MASK.get(param[5], 0x08)
    range_sck = RANGE_MASK.get(param[6], 0x04)
    acq_sck_odr = ODR_MASK.get(param[7], 0x80)
    sck_ax = AXIS_MASK.get(param[8], 0x700)
    sck_datakb = DATAKB_MASK.get(param[9], 0x8000)
    sck_t = int(param[10], 10)
    thresh_acq = max(0x4B0, min(int(param[11], 10), 0x1F40))
    sample_activity = max(0x0001, min(int(param[12], 10), 0x0010))
    sck_g = RANGE_MASK.get(param[13], 0x04)
    sck_freq = SCK_FREQ_MASK.get(param[14], 0x80)
    sck_bw = SCK_BW_MASK.get(param[15], 0x200)
    sck_pw = SCK_PW_MASK.get(param[16], 0x1000)

    config_shm = acc | odr | ax | datakb
    send_frequency = sending_f | sync_f
    config_shm_sck = range_sck | acq_sck_odr | sck_ax | sck_datakb
    config_sck = sck_g | sck_freq | sck_bw | sck_pw

    return "a2" + ts + "%04x%02x%04x%04x%04x%04x%04x" % (
        config_shm,
        send_frequency,
        config_shm_sck,
        config_sck,
        sck_t,
        thresh_acq,
        sample_activity,
    )


# ---------------------------------------------------------------------------
# Inbound-style encoders (sensor simulator / tests)
# ---------------------------------------------------------------------------


def encode_sync_request(
    battery_v: float = 3.6,
    rssi_db: int = 60,
    temp_c: float = 22.5,
    humidity: float = 45.0,
    gps_status: int = 1,
    errors: dict[str, int] | None = None,
    reset_bit: int = 0,
    now: datetime | None = None,
) -> bytes:
    """Build an 0xA1 heartbeat payload matching ``parse_sync_info``'s offsets."""
    t = now or datetime.now(timezone.utc)
    e = errors or {}
    p = bytearray(41)
    p[0] = PACKET_SYNC
    p[1:7] = bytes(
        _bcd(v) for v in (int(str(t.year)[-2:]), t.month, t.day, t.hour, t.minute, t.second)
    )
    p[7] = e.get("362", 0)
    p[8] = e.get("355", 0)
    p[9] = e.get("mem", 0)
    p[10] = e.get("radio", 0)
    p[11] = e.get("config", 0)
    p[17] = gps_status
    mv = int(battery_v * 1000)
    p[32], p[33] = mv & 0xFF, (mv >> 8) & 0xFF
    p[34] = rssi_db
    tc = int(temp_c * 100)
    p[35], p[36] = tc & 0xFF, (tc >> 8) & 0xFF
    hm = int(humidity * 100)
    p[37], p[38] = hm & 0xFF, (hm >> 8) & 0xFF
    p[39], p[40] = reset_bit & 0xFF, (reset_bit >> 8) & 0xFF
    return bytes(p)


def _bcd(value: int) -> int:
    """Pack a 0-99 decimal as BCD: the parsers render time fields with
    ``f"{byte:x}"`` (``parse_sync_info`` etc.), i.e. the sensors transmit
    binary-coded decimal; encoders must match for faithful round trips."""
    return ((value // 10) << 4) | (value % 10)


_ODR_CODE = {31.25: 0x07, 62.5: 0x06, 125.0: 0x05, 250.0: 0x04, 500.0: 0x03}
_AXIS_CODE = {"X": 0x01, "Y": 0x02, "Z": 0x03}
_RANGE_CODE = {"2g": 0x01, "4g": 0x02, "8g": 0x03}


def encode_start_stream(
    samples: np.ndarray,
    fs: float = 500.0,
    axis: str = "X",
    range_g: str = "2g",
    sync_state: int = 1,
    baselines: tuple[float, float, float] = (0.0, 0.0, 0.0),
    means: tuple[float, float, float, float] = (22.0, 0.01, 0.01, 0.98),
    now: datetime | None = None,
) -> bytes:
    """Build an 0xD1 payload: header + 3 i32 baselines + 4 half means + samples."""
    t = now or datetime.now(timezone.utc)
    p = bytearray(31)
    p[0] = PACKET_START
    p[1], p[2] = 0, 1  # packet number 1
    p[3], p[4], p[5] = _bcd(t.hour), _bcd(t.minute), _bcd(t.second)
    p[6] = _RANGE_CODE[range_g]
    p[7] = _ODR_CODE[fs]
    p[8] = _AXIS_CODE[axis]
    p[9] = sync_state
    for i, b in enumerate(baselines):
        v = int(round(b * 1e7)) & 0xFFFFFFFF
        p[11 + 4 * i : 15 + 4 * i] = v.to_bytes(4, "big")
    p[23:31] = encode_halves(np.asarray(means))
    return bytes(p) + encode_halves(samples)


def encode_mid_stream(samples: np.ndarray, number: int) -> bytes:
    return bytes([PACKET_MID, (number >> 8) & 0xFF, number & 0xFF]) + encode_halves(samples)


def encode_end_stream(samples: np.ndarray, number: int) -> bytes:
    return bytes([PACKET_END, (number >> 8) & 0xFF, number & 0xFF]) + encode_halves(samples)


def encode_shock(samples: np.ndarray, now: datetime | None = None) -> bytes:
    t = now or datetime.now(timezone.utc)
    return bytes(
        [PACKET_SHOCK, _bcd(t.hour), _bcd(t.minute), _bcd(t.second)]
    ) + encode_halves(samples)


def encode_reduced(
    samples: np.ndarray,
    fs: float = 500.0,
    axis: str = "X",
    range_g: str = "2g",
    sync_state: int = 0,
    now: datetime | None = None,
) -> bytes:
    t = now or datetime.now(timezone.utc)
    p = bytearray(11)
    p[0] = PACKET_REDUCED
    p[3], p[4], p[5] = _bcd(t.hour), _bcd(t.minute), _bcd(t.second)
    p[6] = _RANGE_CODE[range_g]
    p[7] = _ODR_CODE[fs]
    p[8] = _AXIS_CODE[axis]
    p[9] = sync_state
    return bytes(p) + encode_halves(samples)


def decode_stream_samples(payload: bytes, offset: int, first_value: float = 0.0) -> np.ndarray:
    """Decode the sample section of a stream packet starting at byte ``offset``."""
    return decode_payload(payload[offset:], first_value)
