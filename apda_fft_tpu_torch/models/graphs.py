"""The batched path's flexible pass, captured as a CUDA graph and replayed.

At one shape and budget a flexible pass over an epoch
(``models/pipeline.py`` ``_analyze_epoch_impl``: the four-step front end,
the select+scan kernel, the torch finalize, the refine) is a fixed chain
of about 170 kernels that reads nothing back to the host.  Dispatched one
by one, most of them take the host longer to queue than the card takes to
run.  :func:`run_pass` captures the pass once and replays it:

* only where the code can see that capture is safe (:func:`eligible`):
  samples on a CUDA device, the flexible mode (a rigid pass reads its done
  flags back every few rounds), a batch that is not empty, and no
  ``TorchDispatchMode`` (a flop counter) watching the operations a replay
  would hide from it;
* once a key (:func:`graph_key`: everything that fixes the pass's shapes
  and kernels) has been seen before: its first pass runs eagerly, which
  also fills the table caches; the second captures and replays; later ones
  replay.  A key seen once never pays for a capture;
* at most :data:`MAX_GRAPHS` graphs a device; the least recently used is
  dropped first, and its key runs eagerly from then on, so that traffic
  cycling through more keys than that pays one capture a key, not one a
  pass.

A replay copies the epoch's tensors into the graph's static inputs,
launches the graph and clones its one packed output, so a result that the
caller holds never aliases graph memory.  The same kernels run in the same
order as eagerly, so the results are the eager pass's.  A graph that
another thread is replaying, a capture already under way elsewhere, and a
key whose capture failed (paid once: the key is marked) run eagerly.

A graph reads the device tables of ``ops/fft.py`` and ``ops/fft_cuda.py``
at the addresses it was captured with; their caches never drop an entry.

The kernel wrappers note their launches (``utils.kernels.note_launch``),
and the launch counters follow the notes.  A capture withholds its notes,
and each replay, the capture pass's own included, notes them again, so the
counters read as after eager passes.  :data:`passes` counts the eligible
passes by how they ran, and the span ``apda.replay`` wraps the copies, the
replay and the clone.
"""

from __future__ import annotations

import collections
import threading
import warnings

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from apda_fft_tpu_torch.utils import kernels
from apda_fft_tpu_torch.utils.profiling import span

#: Graphs kept a device.  Each holds its pass's intermediates in a private
#: memory pool, and a copy of its inputs: a few hundred MB at B = 2048,
#: N = 4096 (``PERF.md`` section 6), against the card's 80 GB.
MAX_GRAPHS = 4
#: Keys remembered in all: graphs, and keys seen once or run eagerly (the
#: least recently used of these are forgotten first).
MAX_KEYS = 256

#: Eligible passes so far, by how they ran.
passes = {"eager": 0, "captured": 0, "replayed": 0}

#: A key's state besides its graph: seen once, or eager from now on (its
#: capture failed, or its graph was dropped).
_SEEN, _EAGER = "seen", "eager"
#: What :func:`_claim` returns for a pass that captures.
_CAPTURE = "capture"

_lock = threading.Lock()
#: key -> _SEEN, _EAGER or a _Graph; least recently used first.
_entries: collections.OrderedDict = collections.OrderedDict()
_capturing = False
_streams: dict = {}


class _Graph:
    """One captured pass: the graph, its static inputs (None where the pass
    takes none), its output packed into one byte buffer with each field's
    ``(dtype, shape, nbytes)``, and the launches its capture noted."""

    def __init__(self, graph, inputs, packed, layout, kind, notes, done):
        self.graph, self.inputs, self.packed = graph, inputs, packed
        self.layout, self.kind, self.notes = layout, kind, notes
        self.done = done  # recorded after each replay's clone
        self.lock = threading.Lock()

    def result(self, own: torch.Tensor):
        """The pass's result as views of ``own``, a copy of ``packed``."""
        fields, lo = [], 0
        for dtype, shape, nbytes in self.layout:
            fields.append(own[lo:lo + nbytes].view(dtype).view(shape))
            lo += nbytes
        return self.kind(*fields)


def eligible(samples, mode: str) -> bool:
    """Whether the pass may run from a graph."""
    return (samples.device.type == "cuda" and mode == "flexible" and samples.numel() > 0
            and _get_current_dispatch_mode() is None)


def graph_key(samples, fs, lengths, half_corr, *, mode: str, max_candidates, **kw) -> tuple:
    """Everything that fixes a pass's shapes and kernels: the device first,
    each input's shape and dtype (None when absent), the mode, the budget
    (a flat int or the two-tier tuple) and the other options of
    ``_analyze_epoch_impl`` (``n_fft``, ``k``, ``backend``, ``refine``,
    ``center``, ``batch_chunk``, ``taper``, ``precision``)."""

    def spec(t):
        return None if t is None else (tuple(t.shape), t.dtype)

    return (samples.device, spec(samples), spec(fs), spec(lengths), spec(half_corr), mode,
            max_candidates, tuple(sorted(kw.items())))


def run_pass(impl, samples, fs, lengths, half_corr, **kw):
    """``impl(samples, fs, lengths, half_corr, **kw)``, one pass of
    ``_analyze_epoch_impl``, run from a graph where it can be."""
    args = (samples, fs, lengths, half_corr)
    if not eligible(samples, kw["mode"]):
        return impl(*args, **kw)
    key = graph_key(*args, **kw)
    entry = _claim(key)
    if entry == _CAPTURE:
        entry = _capture_once(key, impl, args, kw)
        if entry is not None:
            passes["captured"] += 1
            return _replay(entry, args)
    elif entry is not None:
        passes["replayed"] += 1
        return _replay(entry, args)
    passes["eager"] += 1
    return impl(*args, **kw)


def reset() -> None:
    """Forget every key and graph, and free the graphs' memory; results
    already handed out own theirs."""
    with _lock:
        _entries.clear()


def _claim(key):
    """What this pass does at ``key``: ``_CAPTURE``, a locked ``_Graph`` to
    replay, or None to run eagerly."""
    global _capturing
    with _lock:
        entry = _entries.get(key)
        if entry is None:
            _entries[key] = _SEEN
            _trim()
            return None
        _entries.move_to_end(key)
        if entry == _SEEN and not _capturing:
            _capturing = True
            return _CAPTURE
        if isinstance(entry, _Graph) and entry.lock.acquire(blocking=False):
            return entry
        return None


def _trim() -> None:
    """Under ``_lock``: drop the least recently used graphs of each device
    past ``MAX_GRAPHS`` (their keys run eagerly from now on), then the least
    recently used keys without a graph past ``MAX_KEYS``."""
    per_device = collections.Counter()
    for key in reversed(_entries):
        if isinstance(_entries[key], _Graph):
            per_device[key[0]] += 1
            if per_device[key[0]] > MAX_GRAPHS:
                _entries[key] = _EAGER
    excess = len(_entries) - MAX_KEYS
    for key in [k for k, v in _entries.items() if not isinstance(v, _Graph)][:max(excess, 0)]:
        del _entries[key]


def _store(key, entry) -> None:
    global _capturing
    with _lock:
        _capturing = False
        _entries[key] = entry
        _entries.move_to_end(key)
        _trim()


def _capture_once(key, impl, args, kw):
    """Capture the pass at ``key``; returns its graph, locked, or None
    after marking the key to run eagerly."""
    entry = _EAGER
    try:
        entry = _capture(impl, args, kw)
        entry.lock.acquire()
    except Exception as err:  # noqa: BLE001 - any failure runs the pass eagerly
        warnings.warn(f"CUDA graph capture of a flexible pass failed ({type(err).__name__}: "
                      f"{err}); passes of this shape run eagerly", RuntimeWarning, stacklevel=3)
    finally:
        _store(key, entry)
    return entry if isinstance(entry, _Graph) else None


def _pack(res):
    """``(packed, layout)``: the result's fields as one byte buffer, with
    each field's ``(dtype, shape, nbytes)``."""
    packed = torch.cat([f.reshape(-1).view(torch.uint8) for f in res])
    return packed, [(f.dtype, tuple(f.shape), f.numel() * f.element_size()) for f in res]


def _capture(impl, args, kw) -> _Graph:
    """Record one pass on the device's capture stream.  The launches it
    notes on this thread are withheld: its replays note them."""
    dev = args[0].device
    inputs = tuple(None if t is None
                   else torch.empty_like(t, memory_format=torch.contiguous_format).copy_(t)
                   for t in args)
    with _lock:
        stream = _streams.get(dev)
        if stream is None:
            stream = _streams[dev] = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev):
        # cuBLAS makes a stream's workspace at its first call there; made
        # inside the capture, it would come from the graph's pool.
        with torch.cuda.stream(stream):
            one = torch.ones((1, 1), device=dev)
            torch.mm(one, one)
        with kernels.withheld() as notes, torch.cuda.graph(
                graph, stream=stream, capture_error_mode="thread_local"):
            res = impl(*inputs, **kw)
            packed, layout = _pack(res)
    return _Graph(graph, inputs, packed, layout, type(res), notes, torch.cuda.Event())


def _launch(entry: _Graph, args) -> torch.Tensor:
    """Queue one replay on the current stream: the inputs in, the graph,
    and a copy of the packed output that the caller owns."""
    dev = args[0].device
    stream = torch.cuda.current_stream(dev)
    stream.wait_event(entry.done)  # a replay queued on another stream
    for static, t in zip(entry.inputs, args):
        if static is not None:
            static.copy_(t)
    with torch.cuda.device(dev):
        entry.graph.replay()
    own = entry.packed.clone()
    entry.done.record(stream)
    return own


def _replay(entry: _Graph, args):
    try:
        with span("apda.replay"):
            own = _launch(entry, args)
    finally:
        entry.lock.release()
    for note in entry.notes:
        kernels.note_launch(*note)
    return entry.result(own)
