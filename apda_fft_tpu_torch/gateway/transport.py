"""Radio transports: the boundary the reference wraps around ``digidevice.xbee``.

``Transport`` is the abstract seam (reference ``XBeeManager``,
``protocol_radio.py:3-108``): blocking timeout receive of
``(payload_bytes, mac_str)``, unicast hex send, address book implicit.

``LoopbackTransport`` is the in-process implementation used by tests, the
simulator, and benchmarks - the reference has no radio simulator at all
(SURVEY.md section 4), which is why its multi-sensor behavior was only ever
"tested" in production.  ``SensorSimulator`` drives the full packet grammar
(0xA1 heartbeats, 0xD1/D2/D3 streams, 0xD4 reduced, 0xC1 shock) against any
transport, including fault injection (dropped packets, truncated streams).
"""

from __future__ import annotations

import abc
import queue
from datetime import datetime, timezone

import numpy as np

from apda_fft_tpu_torch.io import packets


class Transport(abc.ABC):
    """Physical/virtual radio seam."""

    @abc.abstractmethod
    def start(self, log) -> None: ...

    @abc.abstractmethod
    def stop(self, log) -> None: ...

    @abc.abstractmethod
    def receive(self, log) -> tuple[bytes | None, str | None]:
        """Blocking (<= timeout) receive -> (payload, mac) or (None, None)."""

    @abc.abstractmethod
    def send(self, addr: str, hex_payload: str, log) -> bool:
        """Unicast a hex payload to a sensor; True on success."""


class LoopbackTransport(Transport):
    """Queue-backed transport: push inbound packets, capture outbound sends."""

    def __init__(self, timeout: float = 0.0):
        self.timeout = timeout
        self.inbound: queue.Queue[tuple[bytes, str]] = queue.Queue()
        self.sent: list[tuple[str, str]] = []
        self.started = False

    def start(self, log) -> None:
        self.started = True

    def stop(self, log) -> None:
        self.started = False

    def push(self, payload: bytes, addr: str) -> None:
        self.inbound.put((payload, addr))

    def receive(self, log) -> tuple[bytes | None, str | None]:
        try:
            return self.inbound.get(block=self.timeout > 0, timeout=self.timeout or None)
        except queue.Empty:
            return None, None

    def send(self, addr: str, hex_payload: str, log) -> bool:
        self.sent.append((addr, hex_payload))
        return True


class XBeeTransport(Transport):
    """Hardware transport over the vendor ``digidevice.xbee`` stack.

    Only importable on a Digi gateway; kept as a thin optional adapter so the
    same service runs against real radios (parity with ``protocol_radio.py``).
    """

    def __init__(self, timeout: float = 5.0):
        self.timeout = timeout
        self._device = None
        self._known: dict[str, object] = {}

    def start(self, log) -> None:
        from digidevice import xbee  # type: ignore[import-not-found]

        self._device = xbee.get_device()
        self._device.open()
        log("\t[Radio] XBee module opened\n")

    def stop(self, log) -> None:
        if self._device is not None and self._device.is_open():
            self._device.close()

    def receive(self, log) -> tuple[bytes | None, str | None]:
        try:
            msg = self._device.read_data(timeout=self.timeout)
            if msg is None:
                return None, None
            remote = msg.remote_device
            if hasattr(remote, "get_64bit_addr"):
                addr = str(remote.get_64bit_addr()).lower()
            else:
                addr = str(remote).lower().replace(" -", "").strip()
            self._known[addr] = remote
            return bytes(msg.data), addr
        except Exception as exc:  # noqa: BLE001
            if "timeout" not in str(exc).lower():
                log(f"[Radio-ERROR] receive failed: {exc}")
            return None, None

    def send(self, addr: str, hex_payload: str, log) -> bool:
        remote = self._known.get(addr)
        if remote is None:
            log(f"\t[Radio-WARN] unknown device: {addr}\n")
            return False
        try:
            self._device.send_data(remote, bytes.fromhex(hex_payload))
            return True
        except Exception as exc:  # noqa: BLE001
            log(f"\t[Radio-ERROR] send to {addr} failed: {exc}\n")
            return False


class SensorSimulator:
    """Synthetic sensor node exercising the full wire grammar."""

    def __init__(
        self,
        addr: str,
        fs: float = 500.0,
        axis: str = "X",
        range_g: str = "2g",
        chunk: int = 120,
        seed: int = 0,
        temperature: float = 22.0,
    ):
        self.addr = addr
        self.fs = fs
        self.axis = axis
        self.range_g = range_g
        self.chunk = chunk  # samples per radio packet
        self.rng = np.random.default_rng(seed)
        #: reported in the 0xD1 means slot 0 (acquisition summary row);
        #: mutable so multi-epoch scenarios can simulate weather
        self.temperature = temperature

    def heartbeat(self, transport: LoopbackTransport, **kw) -> None:
        transport.push(packets.encode_sync_request(**kw), self.addr)

    def stream_acquisition(
        self,
        transport: LoopbackTransport,
        samples: np.ndarray,
        baseline: float = 0.0,
        drop_packets: set[int] | None = None,
        truncate_after: int | None = None,
        now: datetime | None = None,
    ) -> int:
        """Send a 0xD1 / 0xD2... / 0xD3 sequence carrying ``samples``.

        ``drop_packets`` simulates radio loss of given mid-stream packet
        numbers; ``truncate_after`` stops mid-stream without an 0xD3 (the
        "anomalous closure" scenario, ``GT_FFT_v5.py:706-739``).  Returns the
        number of packets actually pushed.
        """
        drop = drop_packets or set()
        now = now or datetime.now(timezone.utc)
        samples = np.asarray(samples, np.float64)
        # Wire convention implied by the reference decoders: the 0xD1 packet
        # carries absolute samples (decoded with first_value=0,
        # GT_FFT_v5.py:409) while 0xD2/0xD3 carry baseline-relative samples
        # that the gateway re-offsets from the 0xD1 header (:428-429).
        axis_slot = {"X": 0, "Y": 1, "Z": 2}[self.axis]
        base3 = [0.0, 0.0, 0.0]
        base3[axis_slot] = baseline

        first, rest = samples[: self.chunk], samples[self.chunk :] - baseline
        pushed = 0
        transport.push(
            packets.encode_start_stream(
                first,
                fs=self.fs,
                axis=self.axis,
                range_g=self.range_g,
                baselines=tuple(base3),
                means=(self.temperature, 0.01, 0.01, 0.98),
                now=now,
            ),
            self.addr,
        )
        pushed += 1

        chunks = [rest[i : i + self.chunk] for i in range(0, len(rest), self.chunk)]
        if not chunks:  # stream must still be closed by an 0xD3
            chunks = [rest[:0]]
        total = len(chunks)
        for i, part in enumerate(chunks):
            number = i + 2  # 0xD1 was packet 1
            last = i == total - 1
            if truncate_after is not None and number > truncate_after:
                return pushed
            if number in drop:
                continue
            enc = packets.encode_end_stream if last else packets.encode_mid_stream
            transport.push(enc(part, number), self.addr)
            pushed += 1
        return pushed

    def shock_event(self, transport: LoopbackTransport, samples: np.ndarray) -> None:
        transport.push(packets.encode_shock(np.asarray(samples)), self.addr)

    def reduced_data(self, transport: LoopbackTransport, samples: np.ndarray) -> None:
        transport.push(
            packets.encode_reduced(np.asarray(samples), fs=self.fs, axis=self.axis),
            self.addr,
        )
