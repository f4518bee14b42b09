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

Stacked replications (``reps > 1``, the port of the reference's ``vmap``
of the scheduler): every scheduler takes the rows of R replications at
once and hands back each replication's emissions in the order its own run
gives them.  ``batch`` and ``batch-model`` are row-local.  ``batch-packed``
packs each replication on its own (its own rounds, tiles and tile count)
and processes tile t of every replication together; ``ltf`` sorts each
replication's events on their own (a stable sort per row of an ``[R, M *
C]`` view) and applies event i of every replication together.  A tile or
an event past a replication's own count leaves its state and its slots
as they are, as its own run, which stops there, leaves them; the loop
bound read on the host is the largest count.
"""
from __future__ import annotations

from typing import Any

import torch

from ..api import SimModel
from ..events import EventBatch, to_f32
from .base import Scheduler, register_scheduler
from .packing import pack_slice


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
                         cnt_b, lookahead: float, tile: int, reps: int = 1):
    """Width-packed batch rounds: dense tiles over the occupied slots.

    The slice is packed round-major (:mod:`.packing`), per replication: a
    tile holds at most one event per object, so the per-tile gather →
    ``process_events`` → scatter-back is conflict-free, and an object's
    rounds land in strictly increasing tiles.  Identical per-event inputs
    in identical intra-object order give bit-identical results to
    ``batch``.  The largest tile count is read on the host (one device
    sync per call) and bounds the Python loop; tile t of every replication
    runs at once.  Dead lanes scatter their state to a sentinel row that
    is sliced off; a tile past a replication's own count writes none of
    its slots.
    """
    n_rows, C = ts_s.shape
    M = n_rows // reps
    dev = ts_s.device
    packed = pack_slice(ts_s, seed_s, pay_s, cnt_b, tile, reps)
    if reps == 1:
        packed = packed._replace(**{f: getattr(packed, f)[None] for f in (
            "ts", "seed", "payload", "row", "rnd", "valid", "n_tiles")})
    k_pad, T, mo = packed.ts.shape[1], packed.tile, model.max_out
    out = _emission_buffer((reps, k_pad), mo, dev)
    lv = torch.zeros((reps,), dtype=torch.int64, device=dev)
    if k_pad == 0:
        return obj, EventBatch(*(x.reshape(reps, -1) for x in out)), lv
    L = to_f32(lookahead)
    row0 = M * torch.arange(reps, device=dev)[:, None]
    # one extra row per leaf: the sentinel the dead lanes write to.
    work = {k: torch.cat([v, v[:1]]) for k, v in obj.items()}
    n_tiles = int(packed.n_tiles.max())
    for t in range(n_tiles):
        sl = slice(t * T, (t + 1) * T)
        vvalid, vts = packed.valid[:, sl], packed.ts[:, sl]
        rows = packed.row[:, sl].long()
        gather = (rows.clamp(max=M - 1) + row0).reshape(-1)
        st = {k: v[gather] for k, v in work.items()}
        new_st, emitted = model.process_events(
            st, vts.reshape(-1), packed.seed[:, sl].reshape(-1),
            packed.payload[:, sl].reshape(-1))
        scat = torch.where(vvalid, rows + row0, n_rows).reshape(-1)
        for k, v in work.items():
            v[scat] = new_st[k]
        em = EventBatch(*(x.view(reps, T, mo) for x in emitted))
        ev_valid = em.valid & vvalid[..., None]
        lv = lv + (ev_valid & (em.ts < vts[..., None] + L)).sum((1, 2))
        live = (t < packed.n_tiles)[:, None, None]
        out.dst[:, sl] = torch.where(live, em.dst, 0)
        out.ts[:, sl] = torch.where(ev_valid, em.ts, float("inf"))
        out.seed[:, sl] = torch.where(live, em.seed, 0)
        out.payload[:, sl] = torch.where(live, em.payload, 0.0)
        out.valid[:, sl] = ev_valid
    obj = {k: v[:n_rows] for k, v in work.items()}
    return obj, EventBatch(*(x.reshape(reps, -1) for x in out)), lv


def process_ltf(model: SimModel, obj: Any, ts_s, seed_s, pay_s, cnt_b,
                lookahead: float, reps: int = 1):
    """Strict lowest-timestamp-first order, one event at a time.

    Each replication's events are put in its own global ``(ts, seed)``
    order by two stable sorts (seed, then ts) along the rows of an ``[R, M
    * C]`` view; step i applies event i of every replication that has one
    (its state row through a sentinel row elsewhere).  The largest event
    total is read on the host (one device sync per call) and bounds the
    Python loop.
    """
    n_rows, C = ts_s.shape
    M = n_rows // reps
    dev = ts_s.device
    local = torch.arange(M, device=dev).repeat_interleave(C)
    live = (torch.arange(C, device=dev)[None, :]
            < cnt_b[:, None]).view(reps, M * C)
    ts_f = torch.where(live, ts_s.view(reps, M * C), float("inf"))
    seed_f, pay_f = seed_s.view(reps, M * C), pay_s.view(reps, M * C)

    p1 = torch.sort(seed_f, dim=-1, stable=True).indices
    p2 = torch.sort(torch.gather(ts_f, -1, p1), dim=-1, stable=True).indices
    order = torch.gather(p1, -1, p2)
    ts_f, seed_f, pay_f = (torch.gather(x, -1, order)
                           for x in (ts_f, seed_f, pay_f))
    rows = local[order] + M * torch.arange(reps, device=dev)[:, None]

    out = _emission_buffer((reps, M * C), model.max_out, dev)
    lv = torch.zeros((reps,), dtype=torch.int64, device=dev)
    L = to_f32(lookahead)
    work = {k: torch.cat([v, v[:1]]) for k, v in obj.items()}
    totals = cnt_b.view(reps, M).sum(1)
    for i in range(int(totals.max()) if n_rows else 0):
        act = i < totals                                       # [R]
        row, ets = rows[:, i], ts_f[:, i]
        st = {k: v[row] for k, v in work.items()}
        new_st, emitted = model.process_events(st, ets, seed_f[:, i],
                                               pay_f[:, i])
        scat = torch.where(act, row, n_rows)
        for k, v in work.items():
            v[scat] = new_st[k]
        a = act[:, None]
        valid = emitted.valid & a
        lv = lv + (valid & (emitted.ts < ets[:, None] + L)).sum(1)
        out.dst[:, i] = torch.where(a, emitted.dst, 0)
        out.ts[:, i] = torch.where(valid, emitted.ts, float("inf"))
        out.seed[:, i] = torch.where(a, emitted.seed, 0)
        out.payload[:, i] = torch.where(a, emitted.payload, 0.0)
        out.valid[:, i] = valid
    obj = {k: v[:n_rows] for k, v in work.items()}
    return obj, EventBatch(*(x.reshape(reps, -1) for x in out)), lv


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

    def process(self, model, cfg, obj, ts_s, seed_s, pay_s, cnt_b, reps=1):
        return process_batch_packed(model, obj, ts_s, seed_s, pay_s, cnt_b,
                                    cfg.lookahead, cfg.pack_tile, reps)


@register_scheduler("ltf")
class LtfScheduler(Scheduler):
    """Strict lowest-timestamp-first interleaving across objects."""

    host_syncs = 1   # the event total

    def process(self, model, cfg, obj, ts_s, seed_s, pay_s, cnt_b, reps=1):
        return process_ltf(model, obj, ts_s, seed_s, pay_s, cnt_b,
                           cfg.lookahead, reps)
