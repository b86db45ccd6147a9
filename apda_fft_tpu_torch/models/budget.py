"""The dynamic candidate budget's tables, as the JAX package keeps them: a
sticky per-``(n_fft, mode)`` power-of-two budget, its high-water mark and a
learned two-tier split ``(m_small, s_cap)``.  Every loop that runs the
budget starts, grows and writes it back through this module."""

from __future__ import annotations

import threading

_dynamic_budget: dict[tuple[int, str], int] = {}
_dynamic_budget_hwm: dict[tuple[int, str], int] = {}
_dynamic_tier: dict[tuple[int, str], tuple[int, int]] = {}
#: m_small candidates: powers of two plus 1.5x points.
TIER_GRID = (4, 6, 8, 12, 16, 24, 32, 48, 64)
FLOOR = 2
#: Stats of the most recent dynamic-budget run on this thread.
_dynamic_tls = threading.local()


def last_dynamic_stats() -> dict:
    d = getattr(_dynamic_tls, "stats", None)
    if d is None:
        d = _dynamic_tls.stats = {}
    return d


def record_stats(**stats) -> None:
    """Replace this thread's :func:`last_dynamic_stats` with ``stats``."""
    d = last_dynamic_stats()
    d.clear()
    d.update(stats)


def dynamic_state() -> dict:
    """Copies of the learned budget tables: ``{"budget", "hwm", "tier"}``."""
    return {
        "budget": dict(_dynamic_budget),
        "hwm": dict(_dynamic_budget_hwm),
        "tier": dict(_dynamic_tier),
    }


def load_dynamic_state(budget: dict, hwm: dict, tier: dict) -> None:
    """Replace the learned tables, e.g. with the JAX package's
    ``_dynamic_budget``, ``_dynamic_budget_hwm`` and ``_dynamic_tier``."""
    reset_dynamic_state()
    _dynamic_budget.update({(int(n), str(m)): int(v) for (n, m), v in budget.items()})
    _dynamic_budget_hwm.update({(int(n), str(m)): int(v) for (n, m), v in hwm.items()})
    _dynamic_tier.update({(int(n), str(m)): (int(a), int(c))
                          for (n, m), (a, c) in tier.items()})


def reset_dynamic_state() -> None:
    """Forget every learned budget and split."""
    _dynamic_budget.clear()
    _dynamic_budget_hwm.clear()
    _dynamic_tier.clear()


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def sticky(key: tuple[int, str]) -> int:
    """The budget the next epoch of ``key`` starts at: the last one's need
    rounded up to a power of two, the floor before any."""
    return _dynamic_budget.get(key, FLOOR)


def grow(key: tuple[int, str], n_req: int, limit: int) -> int:
    """The budget to re-run at after a pass reported ``n_req``: its power of
    two, at least the high-water mark and the floor, at most ``limit``."""
    return min(max(_pow2_at_least(n_req), _dynamic_budget_hwm.get(key, 0), FLOOR), limit)


def settle(key: tuple[int, str], n_req: int, budget: int, limit: int) -> None:
    """Write back an exact epoch of ``key``: the next one starts at its need
    ``n_req`` rounded up (at most ``limit``), and the high-water mark keeps
    the largest ``budget`` an epoch ran at."""
    _dynamic_budget[key] = min(max(_pow2_at_least(n_req), FLOOR), limit)
    _dynamic_budget_hwm[key] = max(_dynamic_budget_hwm.get(key, 0), budget)


def learned_tier(key: tuple[int, str]) -> tuple[int, int] | None:
    """The learned split of ``key``, or None."""
    return _dynamic_tier.get(key)


def learn_tier(key: tuple[int, str], n_windows: int, s_cap: int, grid_counts) -> None:
    """Learn the split from a settled epoch's straggler counts per
    :data:`TIER_GRID` budget: the smallest that leaves at most half the
    capacity ``s_cap`` to the big pass and halves the budget, else none."""
    if n_windows >= 4 * s_cap:
        for g, c in zip(TIER_GRID, grid_counts):
            if g * 2 <= _dynamic_budget[key] and c <= s_cap // 2:
                _dynamic_tier[key] = (g, s_cap)
                return
    _dynamic_tier.pop(key, None)


def effective_mc(budget: int, h: int, n_windows: int,
                 tier: tuple[int, int] | None) -> int | tuple[int, int, int]:
    """The budget for one dynamic pass: the flat int, or the two-tier
    ``(m_small, m_big, s_cap)`` when a learned split applies.  Never tiers
    at ``budget == h``, where a flat run is unconditionally exact."""
    if (
        tier is not None
        and tier[0] * 2 <= budget
        and budget < h
        and n_windows >= 4 * min(tier[1], n_windows)
    ):
        return (tier[0], budget, tier[1])
    return budget


def steady_state_max_candidates(n_fft: int, mode: str,
                                n_windows: int) -> int | tuple[int, int, int]:
    """What the dynamic budget would run for the next ``n_windows``-window
    epoch on ``(n_fft, mode)``: the flat int budget or the two-tier split."""
    h = max(n_fft // 2, 1)
    key = (n_fft, mode)
    return effective_mc(min(sticky(key), h), h, n_windows, learned_tier(key))


def tier_capacity(b: int) -> int:
    """Straggler capacity for a ``b``-window epoch: pow2(b/16) in [32, 512]."""
    return max(32, min(512, _pow2_at_least(b // 16)))
