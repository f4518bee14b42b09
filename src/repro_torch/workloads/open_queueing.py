"""Open queueing network — sources, forks and absorbing sinks.

Port of ``repro/workloads/open_queueing.py``: the first workload of the zoo
with ``max_out = 2`` whose emission arity varies per event (fan-out and
absorption).  Topology, by contiguous global-id ranges::

    sources → stage-1 queues → forks → stage-2 queues → sinks
    [0, S)    [S, S+Q1)        ...                       [.., n_objects)

  * **source** — a self-clocked arrival generator.  Each firing emits TWO
    events: its own next firing and a fresh job to a random stage-1 queue.
    With ``max_jobs > 0`` the self-loop goes invalid after that many jobs and
    the network drains to empty.
  * **queue** (both stages) — single-server FIFO as in the closed network:
    start at ``max(ts, busy_until)``, hold ``lookahead + draw``, forward at
    departure.  Emits ONE event (second lane invalid).
  * **fork** — splits each job into two copies headed to two random stage-2
    queues.
  * **sink** — absorbs: counts the arrival, accumulates the job's sojourn
    time (the payload carries its birth timestamp) and emits nothing.

The batched ``process_events`` and the numpy mirror keep the reference's
f32 op order, so with ``dist='dyadic'`` the engine and the oracle agree bit
for bit; the mirror returns lists of event dicts (empty for sinks, ``valid:
False`` for an exhausted source's self-loop).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import events as ev
from ..core.api import EmittedEvents, SimModel

_OQ_INIT = np.uint32(0x0BE9F10D)

#: state["kind"] codes, in global-id order.
SOURCE, STAGE1, FORK, STAGE2, SINK = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class OpenQueueingParams:
    n_sources: int = 8
    n_stage1: int = 16
    n_forks: int = 8
    n_stage2: int = 16
    n_sinks: int = 8
    lookahead: float = 0.5         # L — min gap/service time
    service_mean: float = 1.0      # scale for non-dyadic draws
    dist: str = "dyadic"           # dyadic | uniform24 | exponential
    max_jobs: int = 0              # per-source job budget; 0 = unbounded
    seed: int = 0                  # replication seed (bootstrap stream salt)

    def __post_init__(self):
        for role in ("n_sources", "n_stage1", "n_forks", "n_stage2",
                     "n_sinks"):
            if getattr(self, role) < 1:
                raise ValueError(f"{role} must be >= 1 (every role's routing "
                                 f"is modulo its count), got "
                                 f"{getattr(self, role)}")

    @property
    def n_objects(self) -> int:
        return (self.n_sources + self.n_stage1 + self.n_forks
                + self.n_stage2 + self.n_sinks)

    @property
    def offsets(self) -> tuple[int, int, int, int]:
        """(stage1, fork, stage2, sink) first global ids."""
        o1 = self.n_sources
        o2 = o1 + self.n_stage1
        o3 = o2 + self.n_forks
        o4 = o3 + self.n_stage2
        return o1, o2, o3, o4


class OpenQueueingNetwork(SimModel):
    max_out = 2

    def __init__(self, params: OpenQueueingParams):
        self.params = params

    @property
    def n_objects(self) -> int:
        return self.params.n_objects

    def _kind_of(self, gids: np.ndarray) -> np.ndarray:
        return np.searchsorted(np.asarray(self.params.offsets),
                               np.asarray(gids), side="right").astype(np.int32)

    # -- state ---------------------------------------------------------------

    def init_object_state(self, global_ids: np.ndarray,
                          device) -> dict[str, torch.Tensor]:
        n = len(global_ids)
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        return {
            "kind": torch.as_tensor(self._kind_of(global_ids), **i32),
            "gid": torch.as_tensor(np.asarray(global_ids, np.int32), **i32),
            "count": torch.zeros((n,), **i32),
            "busy_until": torch.zeros((n,), **f32),
            "busy_time": torch.zeros((n,), **f32),
            "wait_time": torch.zeros((n,), **f32),
            "sojourn": torch.zeros((n,), **f32),
        }

    def initial_events(self, seed: int | None = None) -> dict[str, np.ndarray]:
        p = self.params
        c = _OQ_INIT ^ ev.seed_salt_np(p.seed if seed is None else seed)
        i = np.arange(p.n_sources, dtype=np.uint32)
        s0 = ev._mix_np(i ^ c)
        ts0 = ev.draw_np(ev.fold_np(s0, 2), p.dist, p.service_mean)
        return {
            "dst": i.astype(np.int32),
            "ts": ts0.astype(np.float32),
            "seed": s0,
            "payload": np.zeros(p.n_sources, np.float32),
        }

    # -- ProcessEvent, one event per object row ----------------------------------

    def process_events(self, state, ts, seed, payload):
        p = self.params
        o_q1, o_fork, o_q2, o_sink = p.offsets
        la = ev.to_f32(p.lookahead)
        seed = seed.to(torch.int64) & ev.M32
        kind = state["kind"]
        is_source = kind == SOURCE
        is_queue = (kind == STAGE1) | (kind == STAGE2)
        is_sink = kind == SINK

        draw_a = ev.draw(ev.fold(seed, 0), p.dist, p.service_mean)
        draw_b = ev.draw(ev.fold(seed, 2), p.dist, p.service_mean)
        route_a = ev.fold(seed, 1)
        route_b = ev.fold(seed, 6)

        # queue dynamics (selected only where is_queue)
        service = la + draw_a
        begin = torch.maximum(ts, state["busy_until"])
        depart = begin + service

        count = state["count"] + 1
        new_state = {
            "kind": kind,
            "gid": state["gid"],
            "count": count,
            "busy_until": torch.where(is_queue, depart, state["busy_until"]),
            "busy_time": state["busy_time"]
            + torch.where(is_queue, service, 0.0),
            "wait_time": state["wait_time"]
            + torch.where(is_queue, begin - ts, 0.0),
            "sojourn": state["sojourn"]
            + torch.where(is_sink, ts - payload, 0.0),
        }

        def pick(u, n, off):
            # u holds u32 bits in int64, so ``%`` is the u32 remainder.
            return off + (u % n).to(torch.int32)

        # lane 0: source self-loop | queue departure | fork first copy.
        hop_q = torch.where(kind == STAGE1, pick(route_a, p.n_forks, o_fork),
                            pick(route_a, p.n_sinks, o_sink))
        dst0 = torch.where(is_source, state["gid"],
                           torch.where(is_queue, hop_q,
                                       pick(route_a, p.n_stage2, o_q2)))
        ts0 = torch.where(is_queue, depart, ts + (la + draw_a))
        valid0 = ~is_sink
        if p.max_jobs:
            valid0 = valid0 & (~is_source | (count < p.max_jobs))
        pay0 = torch.where(is_source, 0.0, payload)

        # lane 1: source's fresh job | fork second copy (else invalid).
        valid1 = is_source | (kind == FORK)
        dst1 = torch.where(is_source, pick(route_a, p.n_stage1, o_q1),
                           pick(route_b, p.n_stage2, o_q2))
        ts1 = ts + (la + draw_b)
        pay1 = torch.where(is_source, ts1, payload)  # a new job's birth stamp

        out = EmittedEvents(
            dst=torch.stack([dst0, dst1], 1),
            ts=torch.stack([ts0, ts1], 1),
            seed=torch.stack([ev.fold(seed, 4), ev.fold(seed, 5)], 1),
            payload=torch.stack([pay0, pay1], 1),
            valid=torch.stack([valid0, valid1], 1),
        )
        return new_state, out

    # -- numpy mirror (sequential oracle) --------------------------------------

    def init_object_state_np(self, global_ids: np.ndarray) -> list[dict]:
        kinds = self._kind_of(global_ids)
        return [{
            "kind": np.int32(k),
            "gid": np.int32(g),
            "count": np.int32(0),
            "busy_until": np.float32(0.0),
            "busy_time": np.float32(0.0),
            "wait_time": np.float32(0.0),
            "sojourn": np.float32(0.0),
        } for g, k in zip(global_ids, kinds)]

    def process_event_np(self, st: dict, ts, seed, payload) -> list[dict]:
        p = self.params
        o_q1, o_fork, o_q2, o_sink = p.offsets
        la = np.float32(p.lookahead)
        seed = np.uint32(seed)
        kind = int(st["kind"])
        draw_a = ev.draw_np(ev.fold_np(seed, 0), p.dist, p.service_mean)
        st["count"] = np.int32(st["count"] + 1)

        def pick(u, n, off):
            return np.int32(off + int(np.uint32(u) % np.uint32(n)))

        if kind == SINK:
            st["sojourn"] = np.float32(st["sojourn"]
                                       + (np.float32(ts) - np.float32(payload)))
            return []

        if kind == SOURCE:
            draw_b = ev.draw_np(ev.fold_np(seed, 2), p.dist, p.service_mean)
            ts_self = np.float32(np.float32(ts) + np.float32(la + draw_a))
            ts_job = np.float32(np.float32(ts) + np.float32(la + draw_b))
            more = p.max_jobs == 0 or int(st["count"]) < p.max_jobs
            return [
                {"dst": np.int32(st["gid"]), "ts": ts_self,
                 "seed": ev.fold_np(seed, 4), "payload": np.float32(0.0),
                 "valid": more},
                {"dst": pick(ev.fold_np(seed, 1), p.n_stage1, o_q1),
                 "ts": ts_job, "seed": ev.fold_np(seed, 5),
                 "payload": ts_job},
            ]

        if kind == FORK:
            draw_b = ev.draw_np(ev.fold_np(seed, 2), p.dist, p.service_mean)
            return [
                {"dst": pick(ev.fold_np(seed, 1), p.n_stage2, o_q2),
                 "ts": np.float32(np.float32(ts) + np.float32(la + draw_a)),
                 "seed": ev.fold_np(seed, 4), "payload": np.float32(payload)},
                {"dst": pick(ev.fold_np(seed, 6), p.n_stage2, o_q2),
                 "ts": np.float32(np.float32(ts) + np.float32(la + draw_b)),
                 "seed": ev.fold_np(seed, 5), "payload": np.float32(payload)},
            ]

        # FIFO queue (stage 1 or 2)
        service = np.float32(la + draw_a)
        begin = np.float32(max(np.float32(ts), st["busy_until"]))
        depart = np.float32(begin + service)
        st["busy_until"] = depart
        st["busy_time"] = np.float32(st["busy_time"] + service)
        st["wait_time"] = np.float32(st["wait_time"]
                                     + (begin - np.float32(ts)))
        if kind == STAGE1:
            dst = pick(ev.fold_np(seed, 1), p.n_forks, o_fork)
        else:
            dst = pick(ev.fold_np(seed, 1), p.n_sinks, o_sink)
        return [{"dst": dst, "ts": depart, "seed": ev.fold_np(seed, 4),
                 "payload": np.float32(payload)}]


def make(**overrides) -> OpenQueueingNetwork:
    if "n_objects" in overrides:                 # workload-agnostic callers
        n = overrides.pop("n_objects")
        if n < 5:
            raise ValueError(f"open-queueing needs n_objects >= 5 (one per "
                             f"role), got {n}")
        roles = ("n_sources", "n_stage1", "n_forks", "n_stage2", "n_sinks")
        clash = [r for r in roles if r in overrides]
        if clash:
            # honoring both silently would build a network whose total size
            # differs from the n_objects the caller asked for.
            raise ValueError(f"pass either n_objects or explicit role counts, "
                             f"not both (got n_objects and {clash})")
        q = n // 5
        overrides.update(n_sources=q, n_stage1=q, n_forks=q, n_stage2=q,
                         n_sinks=n - 4 * q)
    overrides.pop("initial_events", None)
    return OpenQueueingNetwork(OpenQueueingParams(**overrides))


CONFORMANCE = dict(
    model_kw=dict(n_sources=4, n_stage1=4, n_forks=4, n_stage2=4, n_sinks=4,
                  lookahead=0.5, dist="dyadic"),
    n_epochs=24,
    engine_kw=dict(n_buckets=8, bucket_cap=64, route_cap=512,
                   fallback_cap=512),
    dyadic=True,
    supports_batch_impl=False,
)
