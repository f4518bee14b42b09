"""Scheduler stage implementations (paper §II-A).

Port of the ``batch`` and ``batch-model`` schedulers of
``repro/core/pipeline/schedulers.py``:

``batch``        — PARSIR's per-object batch rounds: round r applies the r-th
                   (ts, seed)-ordered event of every object at once through
                   the model's batched ``process_events``.
``batch-model``  — same schedule, but the whole per-object batch goes through
                   the model's own ``process_batch`` kernel (PHOLD: the
                   hand-written CUDA ``event_apply``).

Both honor the emission contract: each processed event may emit
0..``model.max_out`` events, flagged by ``valid``.
"""
from __future__ import annotations

from typing import Any

import torch

from ..api import SimModel
from ..events import EventBatch, to_f32
from .base import Scheduler, register_scheduler


def process_batch_rounds(model: SimModel, obj: Any, ts_s, seed_s, pay_s,
                         cnt_b, lookahead: float):
    """Round r applies the r-th (ts,seed)-ordered event of every object.

    The round count ``max(cnt_b)`` is read on the host (one device sync per
    call) and bounds the Python loop.
    """
    n_rows, C = ts_s.shape
    mo = model.max_out
    dev = ts_s.device
    out = EventBatch(
        dst=torch.zeros((C, n_rows, mo), dtype=torch.int32, device=dev),
        ts=torch.full((C, n_rows, mo), float("inf"), dtype=torch.float32,
                      device=dev),
        seed=torch.zeros((C, n_rows, mo), dtype=torch.int64, device=dev),
        payload=torch.zeros((C, n_rows, mo), dtype=torch.float32, device=dev),
        valid=torch.zeros((C, n_rows, mo), dtype=torch.bool, device=dev),
    )
    lv = torch.zeros((), dtype=torch.int64, device=dev)
    max_r = int(cnt_b.max()) if n_rows else 0
    L = to_f32(lookahead)
    for r in range(max_r):
        ets, eseed, epay = ts_s[:, r], seed_s[:, r], pay_s[:, r]
        m = r < cnt_b
        new_obj, emitted = model.process_events(obj, ets, eseed, epay)
        obj = {k: torch.where(m.view((-1,) + (1,) * (v.ndim - 1)),
                              new_obj[k], v) for k, v in obj.items()}
        ev_valid = emitted.valid & m[:, None]
        lv = lv + (ev_valid & (emitted.ts < ets[:, None] + L)).sum()
        out.dst[r] = emitted.dst
        out.ts[r] = torch.where(ev_valid, emitted.ts, float("inf"))
        out.seed[r] = emitted.seed
        out.payload[r] = emitted.payload
        out.valid[r] = ev_valid
    flat = EventBatch(*(x.reshape(-1) for x in out))
    return obj, flat, lv


@register_scheduler("batch")
class BatchRoundsScheduler(Scheduler):
    """PARSIR per-object batch processing via the rounds loop."""

    host_syncs = 1   # the round count

    def process(self, model, cfg, obj, ts_s, seed_s, pay_s, cnt_b):
        return process_batch_rounds(model, obj, ts_s, seed_s, pay_s, cnt_b,
                                    cfg.lookahead)


@register_scheduler("batch-model")
class ModelKernelScheduler(Scheduler):
    """Whole per-object batches through the model's own kernel
    (``batch_impl='model'``, e.g. the CUDA event_apply)."""

    def validate(self, model, cfg):
        if not hasattr(model, "process_batch"):
            raise ValueError("batch_impl='model' needs model.process_batch")

    def process(self, model, cfg, obj, ts_s, seed_s, pay_s, cnt_b):
        return model.process_batch(obj, ts_s, seed_s, pay_s, cnt_b,
                                   cfg.lookahead)
