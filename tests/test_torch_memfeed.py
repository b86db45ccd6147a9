"""The port's memory feed: decisions bit-identical to its file feed, and the
same as the JAX package's.

``tests/test_memfeed.py``'s fault corpus (``CORPUS_EXTRA``: clean, dropped
packet, truncated, shock and reduced acquisitions of 4 sensors, with shock
analysis and SRS, temperature-compensated drift, severity, FDD and SSI)
runs through the port's gateway (``device="cpu"``) for 3 epochs.  The
memory feed and the file feed give bit-identical decisions (peaks,
severity, SRS, drift state, every history line), with the native codec and
with ``APDA_NO_NATIVE=1``; and the port's memory feed makes the decisions
of the JAX package's under the tolerances of
``tests/test_torch_gateway_parity.py``.
"""

import copy

import numpy as np
import pytest

from apda_fft_tpu_torch.io import native
from tests import test_torch_gateway_parity as gp
from tests.test_memfeed import CORPUS_EXTRA, WIRE_T0

JAX, PORT = "apda_fft_tpu", "apda_fft_tpu_torch"
MACS = [f"0013a20041e7{i:04x}" for i in range(4)]


def _corpus(epochs: int) -> list[tuple[list, list, list]]:
    """Per epoch: the traffic, the first heartbeat, the others' heartbeats
    (``tests/test_memfeed.py``'s corpus, made once)."""
    sim = gp.module(PORT, "gateway.transport").SensorSimulator
    rng = np.random.default_rng(7)
    fs = 250.0
    out = []
    for epoch in range(epochs):
        def traffic(transport, epoch=epoch):
            for i, mac in enumerate(MACS):
                s = sim(mac, fs=fs, axis="X", chunk=100, seed=1000 * epoch + i,
                        temperature=20.0 + i + 0.5 * epoch)
                n = 1000
                t = np.arange(n) / fs
                x = (np.sin(2 * np.pi * 12.3 * t) + 0.5 * np.sin(2 * np.pi * 31.4 * t)
                     + 0.3 * rng.standard_normal(n))
                k = (epoch * len(MACS) + i) % 5
                if k in (0, 3):
                    s.stream_acquisition(transport, x, now=WIRE_T0)
                elif k == 1:
                    s.stream_acquisition(transport, x, drop_packets={3}, now=WIRE_T0)
                elif k == 2:
                    s.stream_acquisition(transport, x, truncate_after=4, now=WIRE_T0)
                else:
                    td = np.arange(256) / fs
                    s.shock_event(transport, np.exp(-2.0 * td) * np.sin(2 * np.pi * 20 * td))
                if k == 4:
                    s.reduced_data(transport, x[:400])

        out.append((gp.capture(PORT, traffic), gp.heartbeats(PORT, MACS[:1]),
                    gp.heartbeats(PORT, MACS[1:])))
    return out


def _run(package: str, root, feed: str, corpus, **kw) -> tuple[list, dict]:
    """Drive one gateway over the corpus: the pre-sync ``fft_results``
    snapshot of each epoch, and the final surface."""
    side = gp.Side(package, root, flush_mode="on_sync",
                   gateway_extra={"analysis_feed": feed, **CORPUS_EXTRA}, **kw)
    snapshots = []
    for traffic, first, others in corpus:
        side.feed(traffic)
        side.feed(first)  # closes the epoch batch; snapshot before the others sync
        snapshots.append(gp.strip_metrics(copy.deepcopy(side.svc.fft_results)))
        side.feed(others)
    surface = side.surface()
    side.svc.stop()
    return snapshots, surface


@pytest.mark.parametrize("no_native", [False, True])
def test_memory_and_file_feeds_bit_identical(tmp_path, monkeypatch, no_native):
    if no_native:
        monkeypatch.setenv("APDA_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("APDA_NO_NATIVE", raising=False)
    assert native.available() is not no_native
    corpus = _corpus(3)
    mem = _run(PORT, tmp_path / "memory", "memory", corpus, device="cpu")
    fil = _run(PORT, tmp_path / "file", "file", corpus, device="cpu")
    assert mem[0] == fil[0]  # peaks, severity, SRS: exact float equality
    assert mem[1]["drift"] == fil[1]["drift"]
    assert mem[1]["modal"] == fil[1]["modal"]
    assert mem[1]["history"] == fil[1]["history"]
    hist = "\n".join(mem[1]["history"])
    for needle in ("Peaks: X f1:", "Missing packets", "Anomalous closure", "Shock SRS:",
                   "Vibration severity", "[FDD]", "[SSI]"):
        assert needle in hist, needle


def test_memory_feed_matches_jax(tmp_path):
    corpus = _corpus(3)
    want = _run(JAX, tmp_path / "jax", "memory", corpus)
    got = _run(PORT, tmp_path / "torch", "memory", corpus, device="cpu")
    gp.assert_close_tree(got[0], want[0], "pre-sync snapshots")
    gp.assert_same_surface(got[1], want[1], "memory feed")
