"""The per-device epoch step: pure wiring of the pipeline stages.

    extract → process → route → deliver  (+ stats)

Port of ``repro/core/pipeline/step.py`` for a single device without
stealing or rebalancing (those stages come with the multi-device slice).
:func:`make_step` resolves the configured Scheduler and Router once, runs
their fail-fast validation and returns the step function.

Out-of-range destinations are triaged at the producer: counted in
``stats.oob_events`` and excluded from routing and the fallback.

``gated=True`` builds the step of the fused drain: it counts the events in
flight (calendar + fallback) before the epoch and advances ``epoch`` by
``pending > 0`` instead of by 1.  A drained state's calendar, object state
and counters are already a fixpoint (an empty bucket processes, routes and
delivers nothing); its fallback holds no event, but a step rewrites the
fields of its empty slots, so the gated step keeps the old fallback when
nothing was in flight.  A drained state is then a bit-exact fixpoint, and
k gated epochs past the drain equal stopping at it, as the JAX engine's
``while_loop`` does.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..api import SimModel
from ..calendar import Fallback, extract_sorted
from ..events import EventBatch, compact_mask, concat_batches, truncate
from ..placement import Placement
from . import routers, schedulers  # noqa: F401  (registration imports)
from .base import EngineState, epoch_of, resolve_router, resolve_scheduler
from .config import EngineConfig
from .deliver import deliver


def in_flight(state: EngineState):
    """Events parked in the calendar and the fallback (a 0-dim tensor)."""
    return state.cal.cnt.sum() + state.fb.events.valid.sum()


def make_step(model: SimModel, cfg: EngineConfig, placement: Placement,
              gated: bool = False) -> Callable[[EngineState], EngineState]:
    N = cfg.n_buckets
    O = placement.n_objects
    dev = 0

    scheduler = resolve_scheduler(cfg)
    router = resolve_router(cfg.route)
    scheduler.validate(model, cfg)
    router.validate(cfg, placement)

    def step(state: EngineState) -> EngineState:
        advance = (in_flight(state) > 0).to(torch.int32) if gated else 1
        cur = state.epoch[0]
        pl = placement.with_boundaries(state.bounds[0])

        # 1. extract — drain the calendar bucket of the current epoch.
        cal, ts_s, seed_s, pay_s, cnt_b = extract_sorted(state.cal, cur)

        # 2.+3. process (no stealing on one device).
        obj, out_flat, lv = scheduler.process(model, cfg, state.obj, ts_s,
                                              seed_s, pay_s, cnt_b)
        proc_count = cnt_b.sum()

        # 4. route — producer-side triage (fresh events + fallback entries),
        # selection against the route capacity, then the exchange.
        prod = concat_batches(out_flat, state.fb.events)
        epochs = epoch_of(prod.ts, cfg.epoch_len)
        oob = prod.valid & ((prod.dst < 0) | (prod.dst >= O))
        n_oob = oob.sum()
        eligible = prod.valid & ~oob & (epochs >= cur + 1) \
            & (epochs <= cur + N)
        late_prod = prod.valid & ~oob & (epochs <= cur)
        n_late_prod = late_prod.sum()

        route_buf, send, route_ovf = router.select_send(prod, eligible, pl,
                                                        cfg)

        keep = prod.valid & ~send & ~late_prod & ~oob
        kept = compact_mask(prod, keep)
        fb = Fallback(truncate(kept, cfg.fallback_cap))
        fb_ovf = kept.valid[cfg.fallback_cap:].sum()

        routed = router.exchange(route_buf, pl, cfg)

        # 5. deliver — the owner inserts into calendar buckets / fallback.
        cal, fb, cal_ovf, fb_ovf2, late2, oob2 = deliver(
            cal, fb, routed, cur, dev, pl, cfg, init=False)

        st = state.stats
        stats = st._replace(
            processed=st.processed + proc_count,
            cal_overflow=st.cal_overflow + cal_ovf,
            fb_overflow=st.fb_overflow + fb_ovf + fb_ovf2,
            route_overflow=st.route_overflow + route_ovf,
            late_events=st.late_events + n_late_prod + late2,
            lookahead_violations=st.lookahead_violations + lv,
            oob_events=st.oob_events + n_oob + oob2,
        )
        if gated:
            fb = Fallback(EventBatch(*(
                torch.where(advance > 0, new, old)
                for new, old in zip(fb.events, state.fb.events))))
        return EngineState(cal, fb, obj, state.epoch + advance, stats,
                           state.bounds, state.load)

    return step
