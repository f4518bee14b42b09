"""Closed queueing network — DESP-C++'s reference validation scenario.

Port of ``repro/workloads/queueing.py``.  ``n_jobs`` jobs circulate among
``n_stations`` single-server FIFO stations.  An event is "job arrives at
station at ``ts``": the server starts it at ``max(ts, busy_until)``, holds it
for ``lookahead + draw(dist)`` and forwards it to a uniformly random station
at the departure time.  Each event emits exactly one successor, so the job
population is conserved; with ``dist='dyadic'`` every timestamp and
accumulator stays on the 1/1024 grid and the engine and the numpy oracle
agree bit for bit.  The FIFO coupling through ``busy_until`` makes an
out-of-order arrival a different departure schedule, not a reordered one.

The batched ``process_events`` and the numpy mirror keep the reference's
f32 op order.  There is no ``process_batch``: the ``batch`` rounds
scheduler runs it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import events as ev
from ..core.api import EmittedEvents, SimModel

_Q_INIT = np.uint32(0x5E12F00D)


@dataclasses.dataclass(frozen=True)
class QueueingParams:
    n_stations: int = 64
    n_jobs: int = 256              # closed population (jobs never leave)
    lookahead: float = 0.5         # L — min service time, engine lookahead
    service_mean: float = 1.0      # scale for non-dyadic service draws
    dist: str = "dyadic"           # dyadic | uniform24 | exponential
    seed: int = 0                  # replication seed (bootstrap stream salt)


class ClosedQueueingNetwork(SimModel):
    max_out = 1

    def __init__(self, params: QueueingParams):
        self.params = params

    @property
    def n_objects(self) -> int:
        return self.params.n_stations

    # -- state ---------------------------------------------------------------

    def init_object_state(self, global_ids: np.ndarray,
                          device) -> dict[str, torch.Tensor]:
        n = len(global_ids)
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "busy_until": torch.zeros((n,), **f32),
            "served": torch.zeros((n,), dtype=torch.int32, device=device),
            "busy_time": torch.zeros((n,), **f32),
            "wait_time": torch.zeros((n,), **f32),
        }

    def initial_events(self, seed: int | None = None) -> dict[str, np.ndarray]:
        p = self.params
        c = _Q_INIT ^ ev.seed_salt_np(p.seed if seed is None else seed)
        j = np.arange(p.n_jobs, dtype=np.uint32)
        s0 = ev._mix_np(j ^ c)
        ts0 = ev.draw_np(ev.fold_np(s0, 2), p.dist, p.service_mean)
        return {
            "dst": (j % np.uint32(p.n_stations)).astype(np.int32),
            "ts": ts0.astype(np.float32),
            "seed": s0,
            "payload": j.astype(np.float32),    # the job id rides the payload
        }

    # -- ProcessEvent, one event per station row ---------------------------------

    def process_events(self, state, ts, seed, payload):
        p = self.params
        seed = seed.to(torch.int64) & ev.M32
        service = ev.to_f32(p.lookahead) + ev.draw(
            ev.fold(seed, 0), p.dist, p.service_mean)
        begin = torch.maximum(ts, state["busy_until"])
        depart = begin + service                 # >= ts + lookahead
        new_state = {
            "busy_until": depart,
            "served": state["served"] + 1,
            "busy_time": state["busy_time"] + service,
            "wait_time": state["wait_time"] + (begin - ts),
        }
        dst = (ev.fold(seed, 1) % p.n_stations).to(torch.int32)
        out = EmittedEvents(
            dst=dst[:, None],
            ts=depart[:, None],
            seed=ev.fold(seed, 3)[:, None],
            payload=payload[:, None],            # job identity is conserved
            valid=torch.ones((ts.shape[0], 1), dtype=torch.bool,
                             device=ts.device),
        )
        return new_state, out

    # -- numpy mirror (sequential oracle) --------------------------------------

    def init_object_state_np(self, global_ids: np.ndarray) -> list[dict]:
        return [{
            "busy_until": np.float32(0.0),
            "served": np.int32(0),
            "busy_time": np.float32(0.0),
            "wait_time": np.float32(0.0),
        } for _ in global_ids]

    def process_event_np(self, st: dict, ts, seed, payload):
        p = self.params
        seed = np.uint32(seed)
        service = np.float32(np.float32(p.lookahead)
                             + ev.draw_np(ev.fold_np(seed, 0), p.dist,
                                          p.service_mean))
        begin = np.float32(max(np.float32(ts), st["busy_until"]))
        depart = np.float32(begin + service)
        st["busy_until"] = depart
        st["served"] = np.int32(st["served"] + 1)
        st["busy_time"] = np.float32(st["busy_time"] + service)
        st["wait_time"] = np.float32(st["wait_time"] + (begin - np.float32(ts)))
        return {
            "dst": np.int32(ev.fold_np(seed, 1) % np.uint32(p.n_stations)),
            "ts": depart,
            "seed": ev.fold_np(seed, 3),
            "payload": np.float32(payload),
        }


def make(**overrides) -> ClosedQueueingNetwork:
    if "n_objects" in overrides:                 # workload-agnostic drivers
        overrides["n_stations"] = overrides.pop("n_objects")
    overrides.pop("initial_events", None)
    return ClosedQueueingNetwork(QueueingParams(**overrides))


CONFORMANCE = dict(
    model_kw=dict(n_stations=16, n_jobs=64, lookahead=0.5, dist="dyadic"),
    n_epochs=24,
    engine_kw=dict(n_buckets=8, bucket_cap=96, route_cap=512,
                   fallback_cap=512),
    dyadic=True,
    supports_batch_impl=False,
)
