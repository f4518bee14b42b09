"""Delivery stage: insertion at the owner (paper §II-B, pipeline stage 5).

Port of ``repro/core/pipeline/deliver.py``.  Owners insert routed
in-horizon events into calendar buckets (conflict-free scatter) and park
beyond-horizon events in the fallback buffer.  Capacity overflow, late
(already-closed-epoch) arrivals and out-of-range destinations are counted,
never silent.  The per-epoch step and the initial ingest share this code
(``init=True`` widens the window to include the current epoch).

Out-of-range ``dst`` are excluded from ``mine`` (the owner searchsorted
would land them on an edge device's wrong row) and counted with the
reference's replication-aware rule: a batch that is the same on every
device (the initial ingest, an ``allgather`` exchange) counts them once,
on device 0, since the per-device Stats are summed; a per-device slice
(``a2a``) counts them where they land.

The stage works on stacked replications: R batches ``[R, E]``, each with
its own epoch, delivered into the ``[R * M, ...]`` view of R calendars
(replication r's object ``i`` is row ``r * M + i``) and into R fallback
buffers, with every count per replication.
"""
from __future__ import annotations

import torch

from ..calendar import Calendar, Fallback, fallback_put, insert
from ..events import EventBatch
from ..placement import Placement
from .base import epoch_of


def deliver(cal: Calendar, fb: Fallback, batch: EventBatch, cur, dev: int,
            placement: Placement, cfg, init: bool, replicated: bool = True):
    """Insert my in-horizon events; park my beyond-horizon events in fallback.

    ``cal`` is the [R * M, N, C] view of R calendars, ``fb`` R fallback
    buffers [R, F], ``batch`` R event batches [R, E], ``cur`` the R current
    epochs [R], ``dev`` this device's index.  ``replicated`` says whether
    ``batch`` is the same on every device (out-of-bounds events counted on
    device 0 only) or this device's own slice.  Returns (cal, fb,
    n_cal_overflow, n_fb_overflow, n_late, n_oob), each count [R].
    """
    N = cfg.n_buckets
    R = batch.dst.shape[0]
    M = cal.n_local // R
    cur = cur[:, None]
    epochs = epoch_of(batch.ts, cfg.epoch_len)
    oob = batch.valid & ((batch.dst < 0)
                         | (batch.dst >= placement.n_objects))
    n_oob = oob.sum(-1)
    if replicated and dev != 0:
        n_oob = torch.zeros_like(n_oob)
    owner = placement.owner(batch.dst)
    mine = batch.valid & ~oob & (owner == dev)
    lo = torch.zeros_like(cur) if init else cur + 1
    hi = cur + (N - 1 if init else N)
    insertable = mine & (epochs >= lo) & (epochs <= hi)
    beyond = mine & (epochs > hi)
    late = (mine & (epochs < lo)).sum(-1)

    local_idx = torch.clamp(batch.dst - placement.start(dev, cur.device),
                            0, M - 1)
    row = local_idx + M * torch.arange(R, dtype=local_idx.dtype,
                                       device=local_idx.device)[:, None]
    new, _ = insert(cal, row.reshape(-1), epochs.reshape(-1),
                    batch.ts.reshape(-1), batch.seed.reshape(-1),
                    batch.payload.reshape(-1), insertable.reshape(-1))
    # per replication: what it offered minus what its rows took.
    cal_ovf = insertable.sum(-1) - (new.cnt - cal.cnt).view(R, -1).sum(1)
    cal = new
    fb, fb_ovf = fallback_put(fb, EventBatch(batch.dst, batch.ts, batch.seed,
                                             batch.payload, beyond))
    return cal, fb, cal_ovf, fb_ovf, late, n_oob
