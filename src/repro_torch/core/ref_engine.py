"""Sequential discrete-event oracle (numpy, heap-based) — the port's copy.

Port of ``repro/core/ref_engine.py``.  Processes events one at a time in
global ``(ts, seed)`` order.  Because all model randomness is counter-based,
the parallel engine must produce the identical multiset of processed events
and, with the dyadic increment distribution, bit-identical object state.

``process_event_np`` may return one event dict, a list of 0..``max_out``
event dicts, or nothing (absorption); entries with ``valid: False`` are
skipped.
"""
from __future__ import annotations

import heapq
from typing import Any

import numpy as np


class SequentialResult:
    def __init__(self, n_objects: int):
        self.processed_per_object = np.zeros(n_objects, np.int64)
        self.pending_records: list[tuple] = []    # (dst, seed) still in the heap
        self.obj_state: list[dict] | None = None

    @property
    def total_processed(self) -> int:
        return int(self.processed_per_object.sum())

    def pending_sorted(self) -> np.ndarray:
        """The multiset of un-processed events at the horizon, sorted."""
        rec = np.array(sorted(self.pending_records), dtype=np.uint64)
        return rec.reshape(-1, 2) if rec.size else rec.reshape(0, 2)


def as_emitted(out: Any) -> list[dict]:
    """Normalize a model's emitted events to a list of valid event dicts."""
    if out is None:
        return []
    if isinstance(out, dict):
        out = [out]
    return [e for e in out if e.get("valid", True)]


def run_sequential(model: Any, n_epochs: int, epoch_len: float,
                   seed: int | None = None) -> SequentialResult:
    """Run until simulation time ``n_epochs * epoch_len`` (exclusive)."""
    horizon = np.float32(n_epochs) * np.float32(epoch_len)
    max_out = getattr(model, "max_out", 1)
    res = SequentialResult(model.n_objects)
    state = model.init_object_state_np(np.arange(model.n_objects))

    init = (model.initial_events() if seed is None
            else model.initial_events(seed))
    heap: list[tuple] = []
    for dst, ts, seed, payload in zip(init["dst"], init["ts"], init["seed"],
                                      init["payload"]):
        heapq.heappush(heap, (np.float32(ts), int(seed), int(dst),
                              np.float32(payload)))

    while heap and heap[0][0] < horizon:
        ts, seed, dst, payload = heapq.heappop(heap)
        res.processed_per_object[dst] += 1
        out = model.process_event_np(state[dst], np.float32(ts),
                                     np.uint32(seed), np.float32(payload))
        emitted = as_emitted(out)
        if len(emitted) > max_out:
            raise ValueError(
                f"model emitted {len(emitted)} events > max_out={max_out}")
        for e in emitted:
            heapq.heappush(heap, (np.float32(e["ts"]), int(e["seed"]),
                                  int(e["dst"]), np.float32(e["payload"])))

    res.pending_records = [(int(dst), int(seed)) for _, seed, dst, _ in heap]
    res.obj_state = state
    return res
