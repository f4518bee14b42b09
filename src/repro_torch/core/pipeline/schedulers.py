"""Scheduler stage implementations (paper §II-A).

Port of ``repro/core/pipeline/schedulers.py``:

``batch``        — PARSIR's per-object batch rounds: round r applies the r-th
                   (ts, seed)-ordered event of every object at once through
                   the model's batched ``process_events``.
``batch-packed`` — the same schedule width-packed: the occupied slots of the
                   epoch slice are compacted round-major into a dense work
                   list (:mod:`.packing`) and processed in ``pack_tile``-wide
                   tiles with a per-tile state gather and scatter-back.
                   Same bits, different schedule.
``batch-model``  — same schedule, but the whole per-object batch goes through
                   the model's own ``process_batch`` kernel (PHOLD: the
                   hand-written CUDA ``event_apply``).
``ltf``          — strict lowest-timestamp-first interleaving across objects,
                   one event at a time; same results, no batch locality.

All honor the emission contract: each processed event may emit
0..``model.max_out`` events, flagged by ``valid``.  The rounds, packed and
ltf loops are bounded by one value read on the host per epoch (the round
count, the tile count, the event total): their ``host_syncs`` is 1.

Stacked replications (``reps > 1``): ``batch`` and ``batch-model`` take the
rows of R replications at once and hand back each replication's emissions
in its own order.  ``batch-packed`` and ``ltf`` order their emissions
across all rows (tiles of the round-major work list, global time), which
the stack would mix, so they take one replication only (``stacks =
False``) and the engine refuses R > 1 under them with a
``NotImplementedError`` naming the missing per-replication order.
"""
from __future__ import annotations

from typing import Any

import torch

from ..api import SimModel
from ..events import EventBatch, to_f32
from .base import Scheduler, register_scheduler
from .packing import pack_slice


def refuse_stacking(scheduler: Scheduler, reps: int) -> None:
    """Raise, naming the scheduler, if it cannot take ``reps`` stacked
    replications."""
    if reps > 1 and not scheduler.stacks:
        what = ("batch_impl='packed'" if scheduler.name == "batch-packed"
                else f"scheduler={scheduler.name!r}")
        raise NotImplementedError(
            f"{what} with R={reps} stacked replications is not in the "
            f"PyTorch port yet: its emission order spans every row of the "
            f"stack, so it comes with a per-replication emission order for "
            f"packed/ltf (the replication slice's leftover); run the seeds "
            f"one by one, or under batch_impl='rounds' or 'model'")


def _emission_buffer(lead: tuple, mo: int, dev) -> EventBatch:
    """An all-invalid ``lead + (mo,)`` emission buffer."""
    shape = lead + (mo,)
    return EventBatch(
        dst=torch.zeros(shape, dtype=torch.int32, device=dev),
        ts=torch.full(shape, float("inf"), dtype=torch.float32, device=dev),
        seed=torch.zeros(shape, dtype=torch.int64, device=dev),
        payload=torch.zeros(shape, dtype=torch.float32, device=dev),
        valid=torch.zeros(shape, dtype=torch.bool, device=dev),
    )


def process_batch_rounds(model: SimModel, obj: Any, ts_s, seed_s, pay_s,
                         cnt_b, lookahead: float, reps: int = 1):
    """Round r applies the r-th (ts,seed)-ordered event of every object.

    The round count ``max(cnt_b)`` is read on the host (one device sync per
    call) and bounds the Python loop.  Each replication's emissions are
    flattened (round, row, slot), as its own run flattens them; a round past
    a replication's own deepest row leaves its slots as the emission buffer
    holds them, as its own run (which stops there) does.
    """
    n_rows, C = ts_s.shape
    M, mo = n_rows // reps, model.max_out
    dev = ts_s.device
    out = _emission_buffer((reps, C, M), mo, dev)
    lv = torch.zeros((n_rows,), dtype=torch.int64, device=dev)
    max_r = int(cnt_b.max()) if n_rows else 0
    own_max = cnt_b.view(reps, M).amax(1) if reps > 1 and M else None
    L = to_f32(lookahead)
    for r in range(max_r):
        ets, eseed, epay = ts_s[:, r], seed_s[:, r], pay_s[:, r]
        m = r < cnt_b
        new_obj, emitted = model.process_events(obj, ets, eseed, epay)
        obj = {k: torch.where(m.view((-1,) + (1,) * (v.ndim - 1)),
                              new_obj[k], v) for k, v in obj.items()}
        ev_valid = emitted.valid & m[:, None]
        lv = lv + (ev_valid & (emitted.ts < ets[:, None] + L)).sum(1)
        dst, seed, pay = emitted.dst, emitted.seed, emitted.payload
        if own_max is not None:
            live = (r < own_max).repeat_interleave(M)[:, None]
            dst, seed = torch.where(live, dst, 0), torch.where(live, seed, 0)
            pay = torch.where(live, pay, 0.0)
        out.dst[:, r] = dst.view(reps, M, mo)
        out.ts[:, r] = torch.where(ev_valid, emitted.ts,
                                   float("inf")).view(reps, M, mo)
        out.seed[:, r] = seed.view(reps, M, mo)
        out.payload[:, r] = pay.view(reps, M, mo)
        out.valid[:, r] = ev_valid.view(reps, M, mo)
    flat = EventBatch(*(x.reshape(reps, -1) for x in out))
    return obj, flat, lv.view(reps, M).sum(1)


def process_batch_packed(model: SimModel, obj: Any, ts_s, seed_s, pay_s,
                         cnt_b, lookahead: float, tile: int):
    """Width-packed batch rounds: dense tiles over the occupied slots.

    The slice is packed round-major (:mod:`.packing`): a tile holds at most
    one event per object, so the per-tile gather → ``process_events`` →
    scatter-back is conflict-free, and an object's rounds land in strictly
    increasing tiles.  Identical per-event inputs in identical intra-object
    order give bit-identical results to ``batch``.  The tile count is read
    on the host (one device sync per call) and bounds the Python loop; dead
    lanes scatter their state to a sentinel row that is sliced off.
    """
    n_rows, C = ts_s.shape
    dev = ts_s.device
    packed = pack_slice(ts_s, seed_s, pay_s, cnt_b, tile)
    k_pad, T = packed.ts.shape[0], packed.tile
    out = _emission_buffer((k_pad,), model.max_out, dev)
    lv = torch.zeros((), dtype=torch.int64, device=dev)
    if k_pad == 0:
        return obj, EventBatch(*(x.reshape(1, -1) for x in out)), lv.view(1)
    L = to_f32(lookahead)
    # one extra row per leaf: the sentinel the dead lanes write to.
    work = {k: torch.cat([v, v[:1]]) for k, v in obj.items()}
    n_tiles = int(packed.n_tiles)
    for t in range(n_tiles):
        sl = slice(t * T, (t + 1) * T)
        vvalid, vts = packed.valid[sl], packed.ts[sl]
        rows = packed.row[sl].long()
        gather = rows.clamp(max=n_rows - 1)
        st = {k: v[gather] for k, v in work.items()}
        new_st, emitted = model.process_events(st, vts, packed.seed[sl],
                                               packed.payload[sl])
        scat = torch.where(vvalid, rows, n_rows)
        for k, v in work.items():
            v[scat] = new_st[k]
        ev_valid = emitted.valid & vvalid[:, None]
        lv = lv + (ev_valid & (emitted.ts < vts[:, None] + L)).sum()
        out.dst[sl] = emitted.dst
        out.ts[sl] = torch.where(ev_valid, emitted.ts, float("inf"))
        out.seed[sl] = emitted.seed
        out.payload[sl] = emitted.payload
        out.valid[sl] = ev_valid
    obj = {k: v[:n_rows] for k, v in work.items()}
    return obj, EventBatch(*(x.reshape(1, -1) for x in out)), lv.view(1)


@register_scheduler("batch")
class BatchRoundsScheduler(Scheduler):
    """PARSIR per-object batch processing via the rounds loop."""

    host_syncs = 1   # the round count

    def process(self, model, cfg, obj, ts_s, seed_s, pay_s, cnt_b, reps=1):
        return process_batch_rounds(model, obj, ts_s, seed_s, pay_s, cnt_b,
                                    cfg.lookahead, reps)


@register_scheduler("batch-model")
class ModelKernelScheduler(Scheduler):
    """Whole per-object batches through the model's own kernel
    (``batch_impl='model'``, e.g. the CUDA event_apply)."""

    def validate(self, model, cfg):
        if not hasattr(model, "process_batch"):
            raise ValueError("batch_impl='model' needs model.process_batch")

    def process(self, model, cfg, obj, ts_s, seed_s, pay_s, cnt_b, reps=1):
        # the kernel is row-local: R * M rows are one launch, and each row's
        # emissions are (row, slot)-ordered, so a replication's are its
        # own run's.
        obj, out, lv = model.process_batch(obj, ts_s, seed_s, pay_s, cnt_b,
                                           cfg.lookahead)
        return (obj, EventBatch(*(x.view(reps, -1) for x in out)),
                lv.view(reps, -1).sum(1))


@register_scheduler("batch-packed")
class PackedBatchScheduler(Scheduler):
    """Width-packed batch rounds (``batch_impl='packed'``): process only the
    occupied event slots, in ``pack_tile``-wide tiles."""

    host_syncs = 1   # the tile count
    stacks = False   # tiles span every row of the stack

    def process(self, model, cfg, obj, ts_s, seed_s, pay_s, cnt_b, reps=1):
        refuse_stacking(self, reps)
        return process_batch_packed(model, obj, ts_s, seed_s, pay_s, cnt_b,
                                    cfg.lookahead, cfg.pack_tile)


@register_scheduler("ltf")
class LtfScheduler(Scheduler):
    """Strict lowest-timestamp-first interleaving across objects.

    The epoch's events are put in global ``(ts, seed)`` order by two stable
    sorts (seed, then ts) and applied one at a time, each to its object's
    state row.  The event total is read on the host (one device sync per
    call) and bounds the Python loop.
    """

    host_syncs = 1   # the event total
    stacks = False   # one global time order over every row of the stack

    def process(self, model, cfg, obj, ts_s, seed_s, pay_s, cnt_b, reps=1):
        refuse_stacking(self, reps)
        n_rows, C = ts_s.shape
        dev = ts_s.device
        rows = torch.arange(n_rows, device=dev).repeat_interleave(C)
        live = (torch.arange(C, device=dev)[None, :]
                < cnt_b[:, None]).reshape(-1)
        ts_f = torch.where(live, ts_s.reshape(-1), float("inf"))
        seed_f, pay_f = seed_s.reshape(-1), pay_s.reshape(-1)

        p1 = torch.sort(seed_f, stable=True).indices
        p2 = torch.sort(ts_f[p1], stable=True).indices
        order = p1[p2]
        ts_f, seed_f, pay_f = ts_f[order], seed_f[order], pay_f[order]
        rows = rows[order]

        out = _emission_buffer((n_rows * C,), model.max_out, dev)
        lv = torch.zeros((), dtype=torch.int64, device=dev)
        L = to_f32(cfg.lookahead)
        obj = {k: v.clone() for k, v in obj.items()}
        total = int(cnt_b.sum())
        for i in range(total):
            row, ets = rows[i:i + 1], ts_f[i:i + 1]
            st = {k: v[row] for k, v in obj.items()}
            new_st, emitted = model.process_events(st, ets, seed_f[i:i + 1],
                                                   pay_f[i:i + 1])
            for k, v in obj.items():
                v[row] = new_st[k]
            lv = lv + (emitted.valid & (emitted.ts < ets[:, None] + L)).sum()
            out.dst[i] = emitted.dst[0]
            out.ts[i] = torch.where(emitted.valid[0], emitted.ts[0],
                                    float("inf"))
            out.seed[i] = emitted.seed[0]
            out.payload[i] = emitted.payload[0]
            out.valid[i] = emitted.valid[0]
        return obj, EventBatch(*(x.reshape(1, -1) for x in out)), lv.view(1)
