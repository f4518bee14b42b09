"""The "clean run" contract, in one place — the port's copy of
``repro/testing/clean.py``.

A conservative engine must never silently drop or reorder an event; every
such condition is counted in ``Stats``, and a run with any of these counters
nonzero has dropped or misordered events: its results and its timings are
meaningless.  Dependency-free: works on any mapping of counter name → int,
e.g. ``ParsirEngine.totals()``.
"""
from __future__ import annotations

from typing import Mapping

#: every Stats counter that must be zero after a healthy run.  ``processed``
#: / ``stolen`` / ``rebalances`` / ``migrated`` are activity meters, not
#: error counters, and are deliberately absent.
CLEAN_COUNTERS: tuple[str, ...] = (
    "cal_overflow",          # calendar bucket capacity exceeded
    "fb_overflow",           # fallback spill — events counted then DROPPED
    "route_overflow",        # route buffer misses (events recirculate)
    "late_events",           # causality violations (already-closed epoch)
    "lookahead_violations",  # model emitted ts < ts_in + L
    "oob_events",            # dst outside [0, n_objects) — events dropped
)


def unclean_counters(totals: Mapping[str, int]) -> dict[str, int]:
    """The nonzero must-be-zero counters of ``totals`` (empty == clean)."""
    return {k: int(totals[k]) for k in CLEAN_COUNTERS if int(totals[k]) != 0}


def assert_clean(totals: Mapping[str, int], context: str = "") -> None:
    """Raise AssertionError naming every dirty counter; no-op when clean.

    ``context`` (e.g. ``"simulate"`` or a conformance axis string) prefixes
    the message so sweep failures name their point.
    """
    bad = unclean_counters(totals)
    if bad:
        prefix = f"{context} " if context else ""
        raise AssertionError(
            f"{prefix}UNCLEAN RUN — events were dropped or misordered: "
            f"{bad} (every overflow/causality counter must be 0; resize "
            f"bucket/route/fallback caps or fix the model)")
