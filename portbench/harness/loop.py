"""The one request loop: set-up, warm-up, the measured window, the check.

A closed loop with one request in flight: each request hands
``windows_per_request`` consecutive rows of the cell's pool to the cell's
entry point (``portbench/entries/<entry>.py``, named by the
configuration) and waits for its results on the host.  The pool comes
from the generator the traffic mix names
(``portbench/generators/<generator>.py``); a request starts where
``order`` puts it:

* ``"shuffle"``: the pool's blocks of that many rows in a new seeded
  permutation each pass;
* ``"offset"``: any row, drawn from the seed, so that every request is
  another mix of the pool's windows.

:func:`execute` is one run of a cell.  ``run.py`` calls it on the card;
the tests call it on the CPU, and may put another request function in the
program's place (``call=``) to see a broken path fail the check, and
count the window's requests (``requests=``) instead of its seconds.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

ORDERS = ("shuffle", "offset")
#: Request starts are drawn ahead for at most this many requests a window.
MAX_REQUESTS = 1_000_000


@dataclasses.dataclass
class Run:
    """What the metric readers read (``portbench/metrics/*.py``)."""

    config: dict
    setup_s: float
    window_s: float
    latencies_s: np.ndarray
    windows: np.ndarray  # windows a request whose results reached the host
    trace: object = None  # trace.TraceSlice of a traced run
    counters: list = dataclasses.field(default_factory=list)  # per request, traced run
    setup_marks: dict = dataclasses.field(default_factory=dict)  # seconds from t0


def request_starts(order: str, count: int, rows: int, width: int, seed: int,
                   stream: int) -> np.ndarray:
    """The first rows of ``count`` requests of ``width`` rows over a pool of
    ``rows``; ``stream`` keeps the warm-up's draws apart from the window's."""
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}; expected one of {ORDERS}")
    rng = np.random.default_rng([seed, stream])
    if order == "shuffle":
        blocks = rows // width
        passes = -(-count // blocks)
        return np.concatenate([rng.permutation(blocks) for _ in range(passes)])[:count] * width
    return rng.integers(0, rows - width + 1, size=count)


def execute(cell, seed: int, seconds: float, trace: bool, *, t0: float,
            device=None, precision: str | None = None, call=None,
            sync=None, log=print, requests: int | None = None) -> dict:
    """One run: returns ``{"run", "pool", "width", "kept", "attempted",
    "failed"}``; ``kept`` holds ``(first pool row, host results)`` of a
    seeded sample of the window's requests (a traced run keeps all).

    ``t0`` is the process's start on ``time.perf_counter``; ``sync`` waits
    for the device (``torch.cuda.synchronize`` on the card).  A traced run
    measures ``traffic["trace_requests"]`` requests under the profiler
    instead of ``seconds``.  ``requests`` makes the window exactly that
    many requests, whatever the clock (the CPU tests, where a request may
    take any time); a measured or traced run never passes it.
    """
    from portbench.harness import trace as tracing

    cfg, traffic = cell.config, cell.traffic
    seed = int(seed) % (1 << 64)
    width = int(traffic["windows_per_request"])
    order = traffic["order"]
    marks = {"loop": time.perf_counter() - t0}
    pool = cell.generator.make_pool(traffic["signal"], rows=int(traffic["pool_windows"]),
                                    n=cfg["n_fft"], fs=cfg["fs"], seed=seed)
    marks["pool"] = time.perf_counter() - t0
    call = call or cell.entry.make_call(cfg, device=device, precision=precision)
    sync = sync or (lambda: None)

    # Warm-up: ``warmup_requests`` requests drawn as the window draws them,
    # so the dynamic budget, its two-tier split and every shape reach their
    # steady state, as in a long-running gateway.
    for j, s in enumerate(request_starts(order, int(traffic["warmup_requests"]), len(pool),
                                         width, seed, stream=4)):
        call(pool[s:s + width])
        if j == 0:
            sync()
            marks["first request"] = time.perf_counter() - t0
    sync()

    cap = int(traffic["trace_requests"]) if trace else MAX_REQUESTS
    if requests is not None:
        cap = int(requests)
    starts = request_starts(order, cap, len(pool), width, seed, stream=1)
    keep_every = 1 if trace else int(traffic.get("keep_every", 1))
    keep = np.random.default_rng([seed, 3]).integers(0, keep_every, size=cap) == 0
    keep[0] = True

    kept: list[tuple[int, dict]] = []
    latencies, windows, counters = [], [], []
    failed = 0
    setup_s = time.perf_counter() - t0
    marks["warm-up"] = setup_s
    profiler = tracing.start() if trace else None
    start = time.perf_counter()
    end = start
    i = 0
    while i < cap and (trace or requests is not None or end - start < seconds):
        s = int(starts[i])
        if trace:
            before = cell.entry.counters()
        began = time.perf_counter()
        try:
            with tracing.span("portbench.request", profiler):
                out = call(pool[s:s + width])
        except Exception as err:  # a failed request is counted, not fatal
            failed += 1
            out = None
            if failed <= 3:
                log(f"portbench: request {i} failed: {type(err).__name__}: {err}")
        end = time.perf_counter()
        latencies.append(end - began)
        windows.append(0 if out is None else width)
        if trace:
            counters.append({"before": before, "after": cell.entry.counters()})
        if out is not None and keep[i]:
            kept.append((s, out))
        i += 1
    slice_ = tracing.stop(profiler) if trace else None
    run = Run(config=cfg, setup_s=setup_s, window_s=end - start,
              latencies_s=np.asarray(latencies), windows=np.asarray(windows), trace=slice_,
              counters=counters, setup_marks=marks)
    return {"run": run, "pool": pool, "width": width, "kept": kept,
            "attempted": i, "failed": failed}


def check(cell, result: dict) -> dict:
    """The comparison with the reference, once the window has closed."""
    return cell.entry.check(cell, result["pool"], result["width"], result["kept"])
