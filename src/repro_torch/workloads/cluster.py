"""Cluster token-ring model (``n_nodes`` workers, ``n_rings`` tokens).

Port of ``repro/workloads/cluster.py``.  The workers run synchronous
data-parallel training as a token ring; each hop costs ``lookahead +
step_time * draw(dist)``, and with probability ``fail_ppm / 1e6`` it also
pays a failure and restart delay.  Routing is deterministic (the next node
on the ring, carried in the payload), the opposite communication profile
from the uniform-random workloads.  With ``dist='dyadic'`` and the default
dyadic ``step_time`` and ``restart_time`` the numpy oracle is bit-exact.

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

_C_INIT = np.uint32(0xC1A07E57)


@dataclasses.dataclass(frozen=True)
class ClusterParams:
    n_nodes: int = 64
    n_rings: int = 8
    step_time: float = 1.0         # dyadic-representable for bit-exact runs
    fail_ppm: int = 20000          # failures per million hops
    restart_time: float = 25.0     # dyadic-representable
    lookahead: float = 0.5
    dist: str = "dyadic"           # dyadic | uniform24 | exponential
    seed: int = 0                  # replication seed (bootstrap stream salt)


class ClusterModel(SimModel):
    """Objects = worker nodes in a ring; one token event per ring."""

    max_out = 1

    def __init__(self, params: ClusterParams):
        self.params = params

    @property
    def n_objects(self) -> int:
        return self.params.n_nodes

    # -- state ---------------------------------------------------------------

    def init_object_state(self, global_ids: np.ndarray,
                          device) -> dict[str, torch.Tensor]:
        n = len(global_ids)
        return {
            "hops": torch.zeros((n,), dtype=torch.int32, device=device),
            "failures": torch.zeros((n,), dtype=torch.int32, device=device),
            "busy_time": torch.zeros((n,), dtype=torch.float32,
                                     device=device),
        }

    def initial_events(self, seed: int | None = None) -> dict[str, np.ndarray]:
        p = self.params
        c = _C_INIT ^ ev.seed_salt_np(p.seed if seed is None else seed)
        # n_rings tokens start at evenly spaced nodes; the payload carries
        # the holder's node id (the handler has no identity input).
        starts = (np.arange(p.n_rings) * (p.n_nodes // p.n_rings)) % p.n_nodes
        s0 = ev._mix_np(np.arange(p.n_rings).astype(np.uint32) ^ c)
        return {
            "dst": starts.astype(np.int32),
            "ts": np.zeros(p.n_rings, np.float32),
            "seed": s0,
            "payload": starts.astype(np.float32),
        }

    # -- ProcessEvent, one event per node row ------------------------------------

    def process_events(self, state, ts, seed, payload):
        p = self.params
        seed = seed.to(torch.int64) & ev.M32
        u = ev.draw(ev.fold(seed, 0), p.dist)
        fail = (ev.fold(seed, 1) % 1_000_000) < p.fail_ppm
        hop = ev.to_f32(p.lookahead) + ev.to_f32(p.step_time) * u
        delay = torch.where(fail, hop + ev.to_f32(p.restart_time), hop)
        new_state = {
            "hops": state["hops"] + 1,
            "failures": state["failures"] + fail.to(torch.int32),
            "busy_time": state["busy_time"] + delay,
        }
        nxt = (payload.to(torch.int32) + 1) % p.n_nodes
        out = EmittedEvents(
            dst=nxt[:, None],
            ts=(ts + delay)[:, None],
            seed=ev.fold(seed, 3)[:, None],
            payload=nxt.to(torch.float32)[:, None],
            valid=torch.ones((ts.shape[0], 1), dtype=torch.bool,
                             device=ts.device),
        )
        return new_state, out

    # -- numpy mirror (sequential oracle) --------------------------------------

    def init_object_state_np(self, global_ids: np.ndarray) -> list[dict]:
        return [{
            "hops": np.int32(0),
            "failures": np.int32(0),
            "busy_time": np.float32(0.0),
        } for _ in global_ids]

    def process_event_np(self, st: dict, ts, seed, payload):
        p = self.params
        seed = np.uint32(seed)
        u = ev.draw_np(ev.fold_np(seed, 0), p.dist)
        fail = (ev.fold_np(seed, 1) % np.uint32(1_000_000)) \
            < np.uint32(p.fail_ppm)
        hop = np.float32(np.float32(p.lookahead) + np.float32(p.step_time) * u)
        delay = np.float32(hop + np.float32(p.restart_time)) if fail else hop

        st["hops"] = np.int32(st["hops"] + 1)
        st["failures"] = np.int32(st["failures"] + (1 if fail else 0))
        st["busy_time"] = np.float32(st["busy_time"] + delay)
        me = np.int32(np.float32(payload))
        nxt = np.int32((me + 1) % p.n_nodes)
        return {
            "dst": nxt,
            "ts": np.float32(np.float32(ts) + delay),
            "seed": ev.fold_np(seed, 3),
            "payload": np.float32(nxt),
        }


def make(**overrides) -> ClusterModel:
    if "n_objects" in overrides:                 # workload-agnostic drivers
        overrides["n_nodes"] = overrides.pop("n_objects")
    overrides.pop("initial_events", None)
    return ClusterModel(ClusterParams(**overrides))


CONFORMANCE = dict(
    # high failure rate + short restart so the failure branch is exercised
    # without stalling tokens for most of the short differential horizon.
    model_kw=dict(n_nodes=16, n_rings=4, fail_ppm=150_000, restart_time=4.0,
                  lookahead=0.5, dist="dyadic"),
    n_epochs=40,
    engine_kw=dict(n_buckets=64, bucket_cap=32, route_cap=512,
                   fallback_cap=512),
    dyadic=True,
    supports_batch_impl=False,
)
