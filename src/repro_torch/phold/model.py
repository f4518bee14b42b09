"""PHOLD benchmark model (paper §IV-A, Table II), in PyTorch.

Port of ``repro/phold/model.py``.  State of each object is a node arena
``payload[S, LANES]`` plus the stack allocator of :mod:`.arena`.  An event

  * touches ``S/32`` contiguous nodes (read + write),
  * reallocates ``ceil(P*S)`` nodes through free/alloc pairs of the stack
    allocator,
  * emits exactly one event with a uniformly random destination (or, with
    ``hot_objects``/``hot_prob``, a skewed one) and a timestamp increment
    ``lookahead + draw(dist)``.

Every step exists as a batched torch function (the engine) and as a numpy
mirror with the same op order (the sequential oracle).  With
``dist='dyadic'`` the two agree bit-for-bit.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import events as ev
from ..core.api import EmittedEvents, SimModel
from ..core.events import EventBatch
from . import arena as ar

_INIT_C = np.uint32(0xA511E9B3)


@dataclasses.dataclass(frozen=True)
class PholdParams:
    n_objects: int = 1024          # O
    initial_events: int = 10       # M
    state_nodes: int = 4000        # S (list nodes per object)
    realloc_fraction: float = 0.001  # P
    lookahead: float = 0.5         # L (simulation-time units)
    mean_increment: float = 1.0    # TA scale for the draw
    dist: str = "dyadic"           # dyadic | uniform24 | exponential
    lanes: int = 6                 # payload lanes per node (~32B chunks)
    # non-uniform routing: with probability hot_prob/256 the new event
    # targets one of the first hot_objects ids.
    hot_objects: int = 0
    hot_prob: int = 0              # out of 256
    # replication seed: salts the bootstrap event stream only.
    seed: int = 0

    @property
    def touch(self) -> int:
        return max(1, self.state_nodes // 32)

    @property
    def realloc_k(self) -> int:
        return max(1, int(math.ceil(self.realloc_fraction * self.state_nodes)))


def _draw_np(bits, params: PholdParams):
    """The timestamp increment's numpy draw under ``params``."""
    return ev.draw_np(bits, params.dist, params.mean_increment)


class Phold(SimModel):
    max_out = 1

    def __init__(self, params: PholdParams):
        self.params = params

    @property
    def n_objects(self) -> int:
        return self.params.n_objects

    # -- state ---------------------------------------------------------------

    def init_object_state(self, global_ids: np.ndarray,
                          device) -> dict[str, torch.Tensor]:
        n = len(global_ids)
        S, LN = self.params.state_nodes, self.params.lanes
        g = np.asarray(global_ids, np.uint32)
        base = ev.dyadic10_np(ev.fold_np(ev._mix_np(g ^ _INIT_C), 7))  # [n]
        base = torch.as_tensor(np.asarray(base, np.float32), device=device)
        a = ar.arena_init(n, S, device)
        return {
            "payload": base[:, None, None].expand(n, S, LN).contiguous(),
            "addresses": a.addresses,
            "top": a.top,
        }

    def object_weights(self) -> np.ndarray | None:
        """Expected steady-state event share per object (placement hint).

        With non-uniform routing, every emission lands on one of the first
        ``hot_objects`` ids with probability ``hot_prob/256``, so in steady
        state that mass concentrates there.  Uniform routing carries no
        skew: None (equal split).
        """
        p = self.params
        if not (p.hot_objects and p.hot_prob):
            return None
        h = p.hot_prob / 256.0
        w = np.full(p.n_objects, (1.0 - h) / p.n_objects, np.float64)
        w[:p.hot_objects] += h / p.hot_objects
        return w

    def initial_events(self, seed: int | None = None) -> dict[str, np.ndarray]:
        p = self.params
        c = _INIT_C ^ ev.seed_salt_np(p.seed if seed is None else seed)
        o = np.repeat(np.arange(p.n_objects, dtype=np.uint32), p.initial_events)
        m = np.tile(np.arange(p.initial_events, dtype=np.uint32), p.n_objects)
        with np.errstate(over="ignore"):
            s0 = ev._mix_np(ev._mix_np(o ^ c) + m * np.uint32(0x9E3779B9))
        ts0 = _draw_np(ev.fold_np(s0, 2), p).astype(np.float32)
        return {
            "dst": o.astype(np.int32),
            "ts": ts0,
            "seed": s0,
            "payload": ev.dyadic10_np(ev.fold_np(s0, 4)).astype(np.float32),
        }

    # -- ProcessEvent, one event per object row ---------------------------------

    def _dst(self, seed: torch.Tensor) -> torch.Tensor:
        p = self.params
        dst = ev.fold(seed, 1) % p.n_objects
        if p.hot_objects and p.hot_prob:
            hot = (ev.fold(seed, 8) & 255) < p.hot_prob
            dst = torch.where(hot, ev.fold(seed, 9) % p.hot_objects, dst)
        return dst.to(torch.int32)

    def process_events(self, state, ts, seed, payload):
        p = self.params
        S, K, KR = p.state_nodes, p.touch, p.realloc_k
        n = ts.shape[0]
        dev = ts.device
        seed = seed.to(torch.int64) & ev.M32
        del payload  # PHOLD's handler keys everything off the event seed

        # contiguous touch window (no wraparound).
        start = ev.fold(seed, 0) % (S - K + 1)
        idx = start[:, None] + torch.arange(K, device=dev)          # [n, K]
        rows = torch.arange(n, device=dev)[:, None]
        delta = ev.dyadic10(ev.fold(seed, 5))
        pay = state["payload"].clone()
        pay[rows, idx] = state["payload"][rows, idx] * 0.5 \
            + delta[:, None, None]

        a = ar.Arena(state["addresses"], state["top"])
        a = ar.free_k(a, idx[:, :KR])
        a, got = ar.alloc_k(a, KR)
        pay[rows, got.to(torch.int64)] = ev.dyadic10(
            ev.fold(seed, 6))[:, None, None]

        ts_out = ts + ev.to_f32(p.lookahead) + ev.draw(
            ev.fold(seed, 2), p.dist, p.mean_increment)
        out = EmittedEvents(
            dst=self._dst(seed)[:, None],
            ts=ts_out[:, None],
            seed=ev.fold(seed, 3)[:, None],
            payload=ev.dyadic10(ev.fold(seed, 4))[:, None],
            valid=torch.ones((n, 1), dtype=torch.bool, device=dev),
        )
        return {"payload": pay, "addresses": a.addresses, "top": a.top}, out

    # -- whole-batch ProcessEvent through the event_apply kernel ---------------

    def process_batch(self, state, ts_s, seed_s, pay_s, cnt_b, lookahead):
        """Apply each object's sorted epoch batch in one kernel call
        (:mod:`repro_torch.kernels.event_apply`).  Updates the object state
        in place.  Drop-in for the engine's rounds loop.  The rows may be
        several stacked replications: nothing here depends on a row's
        index.  Returns the lookahead violations per row."""
        from ..kernels import ops
        p = self.params
        (pay2, addr2, top2, odst, ots, oseed, opay, ovalid) = ops.event_apply(
            state["payload"], state["addresses"], state["top"], ts_s, seed_s,
            cnt_b, n_objects=p.n_objects, lookahead=p.lookahead, K=p.touch,
            KR=p.realloc_k, dist=p.dist, mean=p.mean_increment,
            hot_objects=p.hot_objects, hot_prob=p.hot_prob)
        new_state = {"payload": pay2, "addresses": addr2, "top": top2}
        valid = ovalid.to(torch.bool)
        out = EventBatch(dst=odst.reshape(-1), ts=ots.reshape(-1),
                         seed=oseed.reshape(-1), payload=opay.reshape(-1),
                         valid=valid.reshape(-1))
        lv = (valid & (ots < ts_s + ev.to_f32(lookahead))).sum(1)
        return new_state, out, lv

    # -- numpy mirror (sequential oracle) --------------------------------------

    def process_event_np(self, st: dict, ts, seed, payload):
        p = self.params
        S, K, KR = p.state_nodes, p.touch, p.realloc_k
        seed = np.uint32(seed)

        start = np.int32(ev.fold_np(seed, 0) % np.uint32(S - K + 1))
        idx = start + np.arange(K, dtype=np.int32)
        delta = ev.dyadic10_np(ev.fold_np(seed, 5))
        st["payload"][idx] = st["payload"][idx] * np.float32(0.5) + delta

        st["addresses"], st["top"] = ar.free_k_np(st["addresses"], st["top"],
                                                  idx[:KR])
        st["addresses"], st["top"], got = ar.alloc_k_np(st["addresses"],
                                                        st["top"], KR)
        st["payload"][got] = ev.dyadic10_np(ev.fold_np(seed, 6))

        dst = np.int32(ev.fold_np(seed, 1) % np.uint32(p.n_objects))
        if p.hot_objects and p.hot_prob:
            if (ev.fold_np(seed, 8) & np.uint32(255)) < np.uint32(p.hot_prob):
                dst = np.int32(ev.fold_np(seed, 9) % np.uint32(p.hot_objects))
        ts_out = np.float32(np.float32(ts) + np.float32(p.lookahead)
                            + _draw_np(ev.fold_np(seed, 2), p))
        return {
            "dst": dst,
            "ts": ts_out,
            "seed": ev.fold_np(seed, 3),
            "payload": ev.dyadic10_np(ev.fold_np(seed, 4)),
        }

    def init_object_state_np(self, global_ids: np.ndarray) -> list[dict]:
        S, LN = self.params.state_nodes, self.params.lanes
        out = []
        for g in np.asarray(global_ids, np.uint32):
            base = ev.dyadic10_np(ev.fold_np(ev._mix_np(g ^ _INIT_C), 7))
            addresses, top = ar.arena_init_np(S)
            out.append({
                "payload": np.full((S, LN), base, np.float32),
                "addresses": addresses,
                "top": top,
            })
        return out
