"""The traced slice of a ``--trace 1`` run, read in memory.

``torch.profiler`` records host operations and device activity over a
bounded slice of requests; nothing is written to disk.  :func:`stop` turns
its events into a :class:`TraceSlice` of plain tuples that the metric
readers (``portbench/metrics/*.py``) and :func:`breakdown` read:

* ``device``: ``(name, start_us, end_us)`` of every kernel, copy and
  memset on the card;
* ``host``: ``(name, start_us, end_us)`` of the host operations on the
  thread that ran the requests;
* ``requests``: the ``portbench.request`` spans, one a request.

Device and host times are on the profiler's one clock.
"""

from __future__ import annotations

import contextlib
import dataclasses

#: Name prefixes of device activity that is not a kernel.
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass
class TraceSlice:
    device: list
    host: list
    requests: list

    @property
    def wall_us(self) -> float:
        """From the first request's start to the last one's end."""
        if not self.requests:
            return 0.0
        return self.requests[-1][2] - self.requests[0][1]

    def kernels(self) -> list:
        return [e for e in self.device if not e[0].startswith(_NOT_KERNELS)]

    def kernel_time_us(self, *needles: str) -> tuple[float, int]:
        """Summed time and count of the kernels whose name holds a needle."""
        sel = [e for e in self.kernels() if any(n in e[0] for n in needles)]
        return sum(e[2] - e[1] for e in sel), len(sel)

    def busy_intervals(self) -> list:
        """The union of device activity inside the slice, merged."""
        if not self.requests:
            return []
        lo, hi = self.requests[0][1], self.requests[-1][2]
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        merged: list = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())


def start():
    """A running profiler: host operations, and the card's activity where
    there is one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    return prof


@contextlib.contextmanager
def span(name: str, profiler):
    """A host span of ``name`` in the trace (nothing when not tracing)."""
    if profiler is None:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


def stop(prof) -> TraceSlice:
    import torch
    from torch.autograd import DeviceType

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    device, host, requests = [], [], []
    request_thread = None
    events = prof.events()
    # A host span (``record_function``) also shows as a range on the device's
    # timeline; it is no device activity.
    spans = {"portbench.request"}
    for evt in events:
        if evt.device_type == DeviceType.CPU and getattr(evt, "is_user_annotation", False):
            spans.add(evt.name)
        if evt.name == "portbench.request" and evt.device_type == DeviceType.CPU:
            request_thread = evt.thread
    for evt in events:
        rng = (evt.name, float(evt.time_range.start), float(evt.time_range.end))
        if evt.device_type == DeviceType.CUDA:
            if not (getattr(evt, "is_user_annotation", False) or evt.name in spans):
                device.append(rng)
        elif evt.thread == request_thread:
            if evt.name == "portbench.request":
                requests.append(rng)
            else:
                host.append(rng)
    requests.sort(key=lambda e: e[1])
    device.sort(key=lambda e: e[1])
    host.sort(key=lambda e: (e[1], -e[2]))
    return TraceSlice(device=device, host=host, requests=requests)


def breakdown(slice_: TraceSlice, top: int = 10) -> dict:
    """``{"device_ops", "idle_gaps"}``: the device operations that took the
    most time, summed by name, and the card's idle time summed by the
    innermost host operation running at each gap's middle (the request
    span's own Python where no operation runs), each in seconds."""
    ops: dict[str, float] = {}
    for name, s, e in slice_.device:
        key = name[:160]
        ops[key] = ops.get(key, 0.0) + (e - s) / 1e6
    busy = slice_.busy_intervals()
    gaps = []
    if slice_.requests:
        edges = [slice_.requests[0][1]] + [v for iv in busy for v in iv] + [slice_.requests[-1][2]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
    idle: dict[str, float] = {}
    host = slice_.host
    stack: list = []
    j = 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + e) / 2
        while j < len(host) and host[j][1] <= mid:
            while stack and stack[-1][2] < host[j][1]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        name = stack[-1][0] if stack else "python (no host operation)"
        idle[name[:160]] = idle.get(name[:160], 0.0) + (e - s) / 1e6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}
