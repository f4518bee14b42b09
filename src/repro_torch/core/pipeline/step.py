"""The per-device epoch step: pure wiring of the pipeline stages.

    extract → steal → process → rebalance → route → deliver  (+ stats)

Port of ``repro/core/pipeline/step.py``.  :func:`make_step` resolves the
configured Scheduler, Router, StealPolicy and RebalancePolicy once, runs
their fail-fast validation and returns the step function of one device:
rank ``comm.rank`` of the engine's :class:`~repro_torch.core.dist.Comm`
(the reference's ``axis_index(AXIS)``; one device without a group).

Placement boundaries are state: every step rebuilds the live
:class:`~repro_torch.core.placement.Placement` from ``state.bounds``, so
the adaptive rebalance can move the cuts; it runs between process and
route, so the epoch's emissions are routed against the new boundaries.

Out-of-range destinations are triaged at the producer: counted in
``stats.oob_events`` and excluded from routing and the fallback.

Stacked replications (``replicated=True``, the port of the reference's
``jax.vmap`` of the step over R): every leaf of the state leads with R
(:class:`~.base.EngineState`).  The per-row stages (extract, process) take
the ``[R * M, ...]`` views of the calendar and the object state, each row
at its replication's epoch, so the scheduler runs once for all R (one
``event_apply`` launch under ``batch-model``); the per-simulation stages
(route triage and selection, the fallback, deliver, the counters) work
along dim 1 of ``[R, E]`` event batches, so each replication keeps its own
caps, counts and event order.  The classic step is the same code on a
stack of one.  Across devices the step takes one simulation (R = 1):
stacking replications over several devices comes with the rep-sharded
slice and is refused by name.

``gated=True`` builds the step of the fused drain: it counts the events in
flight (calendar + fallback) before the epoch, per replication (summed
over the devices), and advances that replication's ``epoch`` by ``pending
> 0`` instead of by 1; a rebalance fires only where it advances.
A drained state's calendar, object state and counters are already a
fixpoint (an empty bucket processes, routes and delivers nothing); its
fallback holds no event, but a step rewrites the fields of its empty
slots, so the gated step keeps the old fallback when nothing was in
flight.  A drained state (or a drained replication of a stack) is then a
bit-exact fixpoint, and k gated epochs past the drain equal stopping at
it, as the JAX engine's ``while_loop`` does, or the freeze of its
replicated drain (``_freeze_replications``, ``placement="equal"``).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..api import SimModel
from ..calendar import Calendar, Fallback, extract_sorted
from ..dist import Comm
from ..events import EventBatch, compact_mask, concat_batches, truncate
from ..placement import Placement
from . import rebalance, routers, schedulers, steal  # noqa: F401  (registration)
from .base import (EngineState, epoch_of, replica, resolve_rebalance,
                   resolve_router, resolve_scheduler, resolve_steal,
                   stack_of_one)
from .config import EngineConfig
from .deliver import deliver


def in_flight(state: EngineState):
    """Events parked in the calendar and the fallback (a 0-dim tensor;
    summed over the replications of a stacked state)."""
    return state.cal.cnt.sum() + state.fb.events.valid.sum()


def pending_per_replication(state: EngineState) -> torch.Tensor:
    """Events in flight per replication of a stacked state, i64 [R]."""
    return (state.cal.cnt.flatten(1).sum(1)
            + state.fb.events.valid.flatten(1).sum(1))


def refuse_reps_across_devices(R: int, D: int) -> None:
    """Raise, naming the slice that brings it, for R > 1 stacked
    replications on D > 1 devices."""
    if R > 1 and D > 1:
        raise NotImplementedError(
            f"R={R} stacked replications over D={D} devices is not in the "
            f"PyTorch port yet: it comes with the rep-sharded slice "
            f"(rep_shards, and campaigns over devices > 1); run the "
            f"replications on one device, or one simulation over D devices")


def step_host_syncs(cfg: EngineConfig, n_devices: int) -> int:
    """Host reads of device values one step makes (the scheduler's loop
    bound, the adaptive rebalance's firing test across devices)."""
    return (resolve_scheduler(cfg).host_syncs
            + resolve_rebalance(cfg).host_syncs(n_devices))


def make_step(model: SimModel, cfg: EngineConfig, placement: Placement,
              gated: bool = False, replicated: bool = False,
              comm: Comm | None = None
              ) -> Callable[[EngineState], EngineState]:
    """The epoch step: of one simulation, or with ``replicated`` of a
    stacked state of any number of replications (on one device)."""
    comm = comm or Comm()
    N = cfg.n_buckets
    O = placement.n_objects
    M = placement.n_local_max
    D = placement.n_devices
    if comm.size != D:
        raise ValueError(f"placement over {D} devices, comm of {comm.size}")
    dev = comm.rank

    scheduler = resolve_scheduler(cfg)
    router = resolve_router(cfg.route)
    policy = resolve_steal(cfg, D)
    rebalancer = resolve_rebalance(cfg)
    adaptive = cfg.placement == "adaptive"
    scheduler.validate(model, cfg)
    router.validate(cfg, placement)

    def stacked(state: EngineState) -> EngineState:
        R = state.epoch.shape[0]
        refuse_reps_across_devices(R, D)
        cur = state.epoch[:, 0]
        advance = None
        if gated:
            advance = comm.all_sum(pending_per_replication(state)) > 0
        pl = placement.with_boundaries(state.bounds[0, 0])

        # 1. extract — drain each row's bucket of its replication's epoch.
        flat = Calendar(*(x.flatten(0, 1) for x in state.cal))
        cal, ts_s, seed_s, pay_s, cnt_b = extract_sorted(
            flat, cur.repeat_interleave(M))

        # 2.+3. steal + process — the policy runs the scheduler (on
        # loan-augmented rows under ``loan``).
        obj = {k: v.flatten(0, 1) for k, v in state.obj.items()}
        obj, out, lv, stolen, proc_count = policy.process(
            model, scheduler, cfg, pl, comm, obj, ts_s, seed_s, pay_s,
            cnt_b, R)

        # 3b. rebalance — adaptive placement moves the boundaries and
        # migrates rows; routing and delivery see the new cuts.
        bounds, load = state.bounds, state.load
        if adaptive:
            b, load, cal, obj, migrated, fired = rebalancer.rebalance(
                cfg, placement, comm, cur, bounds[:, 0],
                load + cnt_b.view(R, M), cal, obj, advance)
            pl = placement.with_boundaries(b[0])
            bounds = b[:, None, :]
        else:
            migrated = fired = torch.zeros_like(proc_count)

        # 4. route — producer-side triage (fresh events + fallback entries),
        # selection against the route capacity, then the exchange.
        prod = concat_batches(out, state.fb.events)
        epochs = epoch_of(prod.ts, cfg.epoch_len)
        c = cur[:, None]
        oob = prod.valid & ((prod.dst < 0) | (prod.dst >= O))
        n_oob = oob.sum(-1)
        eligible = prod.valid & ~oob & (epochs >= c + 1) & (epochs <= c + N)
        late_prod = prod.valid & ~oob & (epochs <= c)
        n_late_prod = late_prod.sum(-1)

        route_buf, send, route_ovf = router.select_send(prod, eligible, pl,
                                                        cfg)

        keep = prod.valid & ~send & ~late_prod & ~oob
        kept = compact_mask(prod, keep)
        fb = Fallback(truncate(kept, cfg.fallback_cap))
        fb_ovf = kept.valid[..., cfg.fallback_cap:].sum(-1)

        routed = router.exchange(route_buf, pl, cfg, comm)

        # 5. deliver — owners insert into calendar buckets / fallback; a
        # broadcast batch counts its oob events once, an a2a slice where
        # it lands.
        cal, fb, cal_ovf, fb_ovf2, late2, oob2 = deliver(
            cal, fb, routed, cur, dev, pl, cfg, init=False,
            replicated=router.replicated)

        def add(counter, n):
            return counter + n[:, None]

        st = state.stats
        stats = st._replace(
            processed=add(st.processed, proc_count),
            cal_overflow=add(st.cal_overflow, cal_ovf),
            fb_overflow=add(st.fb_overflow, fb_ovf + fb_ovf2),
            route_overflow=add(st.route_overflow, route_ovf),
            late_events=add(st.late_events, n_late_prod + late2),
            lookahead_violations=add(st.lookahead_violations, lv),
            stolen=add(st.stolen, stolen),
            oob_events=add(st.oob_events, n_oob + oob2),
            rebalances=add(st.rebalances, fired),
            migrated=add(st.migrated, migrated),
        )
        if gated:
            fb = Fallback(EventBatch(*(
                torch.where(advance[:, None], new, old)
                for new, old in zip(fb.events, state.fb.events))))
            epoch = state.epoch + advance[:, None].to(state.epoch.dtype)
        else:
            epoch = state.epoch + 1
        cal = Calendar(*(x.unflatten(0, (R, M)) for x in cal))
        obj = {k: v.unflatten(0, (R, M)) for k, v in obj.items()}
        return EngineState(cal, fb, obj, epoch, stats, bounds, load)

    if replicated:
        return stacked

    def step(state: EngineState) -> EngineState:
        return replica(stacked(stack_of_one(state)), 0)

    return step
