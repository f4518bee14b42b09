"""Epidemic patch model — metapopulation SEIR on a ring of patches.

Port of ``repro/workloads/epidemic.py``.  Each simulation object is a
population *patch* holding integer S/E/I/R counters.  Two event types ride
the payload lane (``0.0`` = local progression step, ``1.0`` = travel
infection):

  * **local step** — promote exposed → infectious, expose susceptibles,
    recover infectious, each with its own counter draw; while the patch stays
    active (``E + I > 0``) the step re-emits itself, and once it is not the
    chain stops (absorption driven by state);
  * **travel infection** — with probability ``trans_p/256`` a local step
    with infectious members left also seeds a ring neighbor: one susceptible
    there becomes exposed.  A travel event on a patch with no susceptibles
    is absorbed; one on an inactive patch (re)ignites its chain.

The same event emits 2, 1 or 0 events as a function of patch state
(``max_out = 2``).  The batched ``process_events`` and the numpy mirror keep
the reference's op order: the counters are int32 and, with
``dist='dyadic'``, every timestamp is exact, so the oracle agrees bit for
bit.  The reference's u32 remainders (``% 3``, ``% 4``, ``% 2``, ``% 256``)
and the ``>> 8 & 1`` neighbor bit act on u32 bits carried in int64, where
they give the same values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import events as ev
from ..core.api import EmittedEvents, SimModel
from ..core.events import ring_neighbor

_EPI_INIT = np.uint32(0xEF1DE31C)

#: payload codes — the event "type" rides the one f32 payload lane.
LOCAL_STEP, TRAVEL = 0.0, 1.0


@dataclasses.dataclass(frozen=True)
class EpidemicParams:
    n_patches: int = 32
    pop: int = 20                  # initial susceptibles per patch
    n_seeds: int = 2               # patches hit by a bootstrap travel event
    trans_p: int = 96              # travel-emission probability, out of 256
    lookahead: float = 0.5         # L — min event-time increment
    service_mean: float = 1.0      # scale for non-dyadic draws
    dist: str = "dyadic"           # dyadic | uniform24 | exponential
    seed: int = 0                  # replication seed (bootstrap stream salt)

    def __post_init__(self):
        if self.n_patches < 2:
            raise ValueError(f"n_patches must be >= 2 (ring neighbors), "
                             f"got {self.n_patches}")
        if not 1 <= self.n_seeds <= self.n_patches:
            raise ValueError(f"n_seeds must be in [1, n_patches], "
                             f"got {self.n_seeds}")
        if not 0 <= self.trans_p <= 256:
            raise ValueError(f"trans_p is out of 256, got {self.trans_p}")


class EpidemicModel(SimModel):
    max_out = 2

    def __init__(self, params: EpidemicParams):
        self.params = params

    @property
    def n_objects(self) -> int:
        return self.params.n_patches

    def _seed_gids(self) -> np.ndarray:
        p = self.params
        return (np.arange(p.n_seeds) * (p.n_patches // p.n_seeds)) \
            % p.n_patches

    def object_weights(self) -> np.ndarray | None:
        """Placement hint: seeded patches (and so their neighborhoods) carry
        the early-epidemic event mass before travel spreads it out."""
        p = self.params
        w = np.ones(p.n_patches, np.float64)
        w[self._seed_gids()] += 3.0
        return w

    # -- state ---------------------------------------------------------------

    def init_object_state(self, global_ids: np.ndarray,
                          device) -> dict[str, torch.Tensor]:
        n = len(global_ids)
        p = self.params
        i32 = dict(dtype=torch.int32, device=device)
        return {
            "gid": torch.as_tensor(np.asarray(global_ids, np.int32), **i32),
            "s": torch.full((n,), p.pop, **i32),
            "e": torch.zeros((n,), **i32),
            "i": torch.zeros((n,), **i32),
            "r": torch.zeros((n,), **i32),
            "imports": torch.zeros((n,), **i32),
            "count": torch.zeros((n,), **i32),
            "last_ts": torch.zeros((n,), dtype=torch.float32, device=device),
        }

    def initial_events(self, seed: int | None = None) -> dict[str, np.ndarray]:
        p = self.params
        c = _EPI_INIT ^ ev.seed_salt_np(p.seed if seed is None else seed)
        gids = self._seed_gids()
        s0 = ev._mix_np(gids.astype(np.uint32) ^ c)
        ts0 = ev.draw_np(ev.fold_np(s0, 2), p.dist, p.service_mean)
        return {
            "dst": gids.astype(np.int32),
            "ts": ts0.astype(np.float32),
            "seed": s0,
            "payload": np.full(p.n_seeds, TRAVEL, np.float32),
        }

    # -- ProcessEvent, one event per patch row -----------------------------------

    def process_events(self, state, ts, seed, payload):
        p = self.params
        la = ev.to_f32(p.lookahead)
        seed = seed.to(torch.int64) & ev.M32
        s, e, i, r = state["s"], state["e"], state["i"], state["r"]
        is_travel = payload > 0.5

        # travel branch: seed one S → E if any susceptibles remain.
        seeded = is_travel & (s > 0)
        was_active = (e + i) > 0

        # local branch: promote E → I, expose S → E, recover I → R — in that
        # order, with independent counter draws.
        def draw_mod(k, n):
            return (ev.fold(seed, k) % n).to(torch.int32)

        promote = torch.minimum(e, draw_mod(0, 3))
        i_loc1 = i + promote
        expose = torch.where(i_loc1 > 0, torch.minimum(s, draw_mod(1, 4)), 0)
        recover = torch.minimum(i_loc1, draw_mod(2, 2))
        local = ~is_travel

        one = seeded.to(torch.int32)
        new_state = {
            "gid": state["gid"],
            "s": torch.where(is_travel, s - one, s - expose),
            "e": torch.where(is_travel, e + one, e - promote + expose),
            "i": torch.where(is_travel, i, i_loc1 - recover),
            "r": torch.where(is_travel, r, r + recover),
            "imports": state["imports"] + one,
            "count": state["count"] + 1,
            "last_ts": ts,
        }
        active_after = (new_state["e"] + new_state["i"]) > 0

        # lane 0: the patch's own progression chain.  A local step continues
        # while active; a travel event only starts a chain on a previously
        # inactive patch (so each patch runs at most one chain at a time).
        valid0 = torch.where(is_travel, seeded & ~was_active, active_after)
        d0 = ev.draw(ev.fold(seed, 3), p.dist, p.service_mean)
        ts0 = ts + (la + d0)

        # lane 1: travel infection to a ring neighbor (local steps only,
        # requires infectious members surviving the step).
        route = ev.fold(seed, 5)
        valid1 = local & (new_state["i"] > 0) & ((route % 256) < p.trans_p)
        dst1 = ring_neighbor(state["gid"], ((route >> 8) & 1) == 1,
                             p.n_patches).to(torch.int32)
        d1 = ev.draw(ev.fold(seed, 4), p.dist, p.service_mean)
        ts1 = ts + (la + d1)

        out = EmittedEvents(
            dst=torch.stack([state["gid"], dst1], 1),
            ts=torch.stack([ts0, ts1], 1),
            seed=torch.stack([ev.fold(seed, 6), ev.fold(seed, 7)], 1),
            payload=torch.stack([torch.full_like(ts, LOCAL_STEP),
                                 torch.full_like(ts, TRAVEL)], 1),
            valid=torch.stack([valid0, valid1], 1),
        )
        return new_state, out

    # -- numpy mirror (sequential oracle) --------------------------------------

    def init_object_state_np(self, global_ids: np.ndarray) -> list[dict]:
        p = self.params
        return [{
            "gid": np.int32(g),
            "s": np.int32(p.pop),
            "e": np.int32(0),
            "i": np.int32(0),
            "r": np.int32(0),
            "imports": np.int32(0),
            "count": np.int32(0),
            "last_ts": np.float32(0.0),
        } for g in global_ids]

    def process_event_np(self, st: dict, ts, seed, payload) -> list[dict]:
        p = self.params
        la = np.float32(p.lookahead)
        seed = np.uint32(seed)
        st["count"] = np.int32(st["count"] + 1)
        st["last_ts"] = np.float32(ts)

        if float(payload) > 0.5:                       # travel infection
            seeded = int(st["s"]) > 0
            was_active = int(st["e"]) + int(st["i"]) > 0
            if seeded:
                st["s"] = np.int32(st["s"] - 1)
                st["e"] = np.int32(st["e"] + 1)
                st["imports"] = np.int32(st["imports"] + 1)
            if not (seeded and not was_active):
                return []                              # absorbed
            d0 = ev.draw_np(ev.fold_np(seed, 3), p.dist, p.service_mean)
            return [{"dst": np.int32(st["gid"]),
                     "ts": np.float32(np.float32(ts) + np.float32(la + d0)),
                     "seed": ev.fold_np(seed, 6),
                     "payload": np.float32(LOCAL_STEP)}]

        # local progression step — promote, expose, recover (same draw order
        # as the batched branch).
        promote = min(int(st["e"]), int(ev.fold_np(seed, 0) % np.uint32(3)))
        i1 = int(st["i"]) + promote
        expose = min(int(st["s"]),
                     int(ev.fold_np(seed, 1) % np.uint32(4))) if i1 > 0 else 0
        recover = min(i1, int(ev.fold_np(seed, 2) % np.uint32(2)))
        st["s"] = np.int32(int(st["s"]) - expose)
        st["e"] = np.int32(int(st["e"]) - promote + expose)
        st["i"] = np.int32(i1 - recover)
        st["r"] = np.int32(int(st["r"]) + recover)

        out = []
        if int(st["e"]) + int(st["i"]) > 0:            # chain continues
            d0 = ev.draw_np(ev.fold_np(seed, 3), p.dist, p.service_mean)
            out.append({"dst": np.int32(st["gid"]),
                        "ts": np.float32(np.float32(ts)
                                         + np.float32(la + d0)),
                        "seed": ev.fold_np(seed, 6),
                        "payload": np.float32(LOCAL_STEP)})
        route = ev.fold_np(seed, 5)
        if int(st["i"]) > 0 and int(route % np.uint32(256)) < p.trans_p:
            d1 = ev.draw_np(ev.fold_np(seed, 4), p.dist, p.service_mean)
            out.append({"dst": ring_neighbor(np.int32(st["gid"]),
                                             int((route >> np.uint32(8))
                                                 & np.uint32(1)),
                                             p.n_patches),
                        "ts": np.float32(np.float32(ts)
                                         + np.float32(la + d1)),
                        "seed": ev.fold_np(seed, 7),
                        "payload": np.float32(TRAVEL)})
        return out


def make(**overrides) -> EpidemicModel:
    if "n_objects" in overrides:                 # workload-agnostic callers
        overrides["n_patches"] = overrides.pop("n_objects")
    overrides.pop("initial_events", None)
    return EpidemicModel(EpidemicParams(**overrides))


CONFORMANCE = dict(
    # enough susceptibles + seeds that the epidemic stays active over the
    # short differential horizon, high trans_p so travel (fan-out) traffic
    # and chain reignition are both exercised.
    model_kw=dict(n_patches=16, pop=12, n_seeds=3, trans_p=128,
                  lookahead=0.5, dist="dyadic"),
    n_epochs=24,
    engine_kw=dict(n_buckets=8, bucket_cap=64, route_cap=512,
                   fallback_cap=512),
    dyadic=True,
    supports_batch_impl=False,
)
