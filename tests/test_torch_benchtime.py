"""The port's timers (``utils/benchtime.py``), on the CPU: the three cases of
``tests/test_benchtime.py`` (explicit and adaptive call counts, pipelined
wall time), and the JAX package's return keys."""

import torch

from apda_fft_tpu_torch.utils.benchtime import (
    per_iteration_seconds,
    per_iteration_stats,
    pipelined_wall_seconds,
)


def test_explicit_iters_path():
    x = torch.ones((64, 64), dtype=torch.float32)
    sec = per_iteration_seconds(lambda a: a @ a, x, iters=8, reps=2)
    assert sec > 0
    stats = per_iteration_stats(lambda a: a @ a, x, iters=8, reps=2)
    assert set(stats) == {"per_iter_s", "dispatch_s", "iters"} and stats["iters"] == 8
    assert stats["dispatch_s"] >= 0


def test_adaptive_path_terminates_and_is_positive():
    x = torch.ones((32, 32), dtype=torch.float32)
    # A tiny op forces the escalation loop; a small min_delta keeps it short.
    sec = per_iteration_seconds(lambda a: a + 1.0, x, min_delta=0.005, max_iters=4096)
    assert sec > 0


def test_pipelined_wall_seconds_smoke():
    x = torch.ones((16, 64), dtype=torch.float32)
    calls = []

    def fn(a):
        calls.append(a)
        return a @ a.T

    sec = pipelined_wall_seconds(fn, x, depth=4, reps=1)
    assert sec > 0
    # One warm-up call, then `depth` calls, each on a perturbed copy.
    assert len(calls) == 5 and all(c is not x for c in calls[1:])
