"""Wireless cellular channel model — GSM-style call/handoff over a ring of
cells (the PARSIR paper's experimental lineage, §IV, ref [28]).

Port of ``repro/workloads/wireless.py``.  Each simulation object is a *cell*
with a fixed bank of radio channels; its channel state is the occupancy
vector ``free_at[n_channels]`` (the f32 time each channel next becomes
free), a sum of dyadic timestamps and holding times, so it stays exact.
Two event types ride the payload lane (``0.0`` = call arrival from the
cell's own generator, ``1.0`` = handoff from a neighbor):

  * **arrival** — the cell admits the call onto its lowest-indexed free
    channel (``free_at[c] <= ts``) for a dyadic holding time and re-emits its
    own next arrival (hot cells draw the gap on a ``2**hot_shift``-finer grid
    and start extra generator streams).  With no free channel the call is
    blocked and absorbed.
  * **handoff** — with probability ``handoff_p/256`` an admitted call moves
    to a ring neighbor at the end of its holding time, where it re-runs
    admission; a full neighbor drops it.

Arity depends on state (``max_out = 2``): a blocked handoff emits nothing,
and a cell whose arrival budget (``max_calls``, shared by its streams) is
spent stops generating and drains.  The batched ``process_events`` keeps the
reference's f32 op order; the lowest free channel is the smallest index
whose ``free_at <= ts`` (the reference's ``argmax`` over the bool vector,
first index on ties, as in the numpy mirror).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import events as ev
from ..core.api import EmittedEvents, SimModel
from ..core.events import ring_neighbor

_WL_INIT = np.uint32(0x3E11C411)

#: payload codes — the event "type" rides the one f32 payload lane.
ARRIVAL, HANDOFF = 0.0, 1.0


@dataclasses.dataclass(frozen=True)
class WirelessParams:
    n_cells: int = 32
    n_channels: int = 4            # channels per cell (occupancy vector width)
    hot_cells: int = 0             # leading cells with boosted traffic
    hot_shift: int = 2             # hot arrival gaps drawn on a 2**k-finer grid
    hot_streams: int = 1           # extra bootstrap generators per hot cell
    handoff_p: int = 96            # per-call handoff probability, out of 256
    max_calls: int = 0             # per-CELL arrival budget shared by all of
    #                                a cell's generator streams; 0 = unbounded
    lookahead: float = 0.5         # L — min gap/holding-time increment
    service_mean: float = 1.0      # scale for non-dyadic draws
    dist: str = "dyadic"           # dyadic | uniform24 | exponential
    seed: int = 0                  # replication seed (bootstrap stream salt)

    def __post_init__(self):
        if self.n_cells < 2:
            raise ValueError(f"n_cells must be >= 2 (ring neighbors), "
                             f"got {self.n_cells}")
        if self.n_channels < 1:
            raise ValueError(f"n_channels must be >= 1, got {self.n_channels}")
        if not 0 <= self.hot_cells <= self.n_cells:
            raise ValueError(f"hot_cells must be in [0, n_cells], "
                             f"got {self.hot_cells}")
        if not 0 <= self.handoff_p <= 256:
            raise ValueError(f"handoff_p is out of 256, got {self.handoff_p}")


class WirelessModel(SimModel):
    max_out = 2

    def __init__(self, params: WirelessParams):
        self.params = params

    @property
    def n_objects(self) -> int:
        return self.params.n_cells

    def object_weights(self) -> np.ndarray | None:
        """Placement hint: a hot cell carries ``(1 + hot_streams)`` generator
        streams, each firing ~``(L + ½)/(L + ½·2**-hot_shift)`` times as
        often as a cold cell's single stream."""
        p = self.params
        if p.hot_cells == 0:
            return None
        rate = (p.lookahead + 0.5) / (p.lookahead + 0.5 * 2.0 ** -p.hot_shift)
        w = np.ones(p.n_cells, np.float64)
        w[:p.hot_cells] = (1.0 + p.hot_streams) * rate
        return w

    # -- state ---------------------------------------------------------------

    def init_object_state(self, global_ids: np.ndarray,
                          device) -> dict[str, torch.Tensor]:
        n, C = len(global_ids), self.params.n_channels
        i32 = dict(dtype=torch.int32, device=device)
        return {
            "gid": torch.as_tensor(np.asarray(global_ids, np.int32), **i32),
            "free_at": torch.zeros((n, C), dtype=torch.float32,
                                   device=device),
            "arrivals": torch.zeros((n,), **i32),
            "calls": torch.zeros((n,), **i32),
            "handoffs_in": torch.zeros((n,), **i32),
            "blocked": torch.zeros((n,), **i32),
            "dropped": torch.zeros((n,), **i32),
            "count": torch.zeros((n,), **i32),
        }

    def initial_events(self, seed: int | None = None) -> dict[str, np.ndarray]:
        p = self.params
        c = _WL_INIT ^ ev.seed_salt_np(p.seed if seed is None else seed)
        # one generator per cell, (1 + hot_streams) for hot cells.
        counts = np.ones(p.n_cells, np.int64)
        counts[:p.hot_cells] += p.hot_streams
        o = np.repeat(np.arange(p.n_cells, dtype=np.uint32), counts)
        m = np.concatenate([np.arange(n, dtype=np.uint32) for n in counts])
        with np.errstate(over="ignore"):
            s0 = ev._mix_np(ev._mix_np(o ^ c)
                            + m * np.uint32(0x9E3779B9))
        ts0 = ev.draw_np(ev.fold_np(s0, 2), p.dist, p.service_mean)
        return {
            "dst": o.astype(np.int32),
            "ts": ts0.astype(np.float32),
            "seed": s0,
            "payload": np.full(len(o), ARRIVAL, np.float32),
        }

    # -- ProcessEvent, one event per cell row ------------------------------------

    def process_events(self, state, ts, seed, payload):
        p = self.params
        C = p.n_channels
        la = ev.to_f32(p.lookahead)
        seed = seed.to(torch.int64) & ev.M32
        gid = state["gid"]
        is_handoff = payload > 0.5
        is_hot = gid < p.hot_cells

        # admission onto the lowest-indexed free channel.
        chan = torch.arange(C, device=ts.device)
        free = state["free_at"] <= ts[:, None]
        ok = free.any(1)
        idx = torch.where(free, chan, C).amin(1)
        hold = la + ev.draw(ev.fold(seed, 0), p.dist, p.service_mean)
        depart = ts + hold
        free_at = torch.where((chan == idx[:, None]) & ok[:, None],
                              depart[:, None], state["free_at"])

        admitted = ok.to(torch.int32)
        rejected = 1 - admitted
        arrivals = state["arrivals"] + (~is_handoff).to(torch.int32)
        new_state = {
            "gid": gid,
            "free_at": free_at,
            "arrivals": arrivals,
            "calls": state["calls"] + torch.where(is_handoff, 0, admitted),
            "handoffs_in": state["handoffs_in"]
            + torch.where(is_handoff, admitted, 0),
            "blocked": state["blocked"] + torch.where(is_handoff, 0, rejected),
            "dropped": state["dropped"] + torch.where(is_handoff, rejected, 0),
            "count": state["count"] + 1,
        }

        # lane 0: the generator self-loop (arrivals only; hot cells draw the
        # gap on a finer dyadic grid, exactly representable).
        gap_hot = ev.draw_scaled(ev.fold(seed, 1), p.dist, p.hot_shift,
                                 p.service_mean)
        gap_cold = ev.draw(ev.fold(seed, 1), p.dist, p.service_mean)
        ts0 = ts + (la + torch.where(is_hot, gap_hot, gap_cold))
        valid0 = ~is_handoff
        if p.max_calls:
            valid0 = valid0 & (arrivals < p.max_calls)

        # lane 1: the admitted call's handoff to a ring neighbor at the end
        # of its holding time (blocked/dropped calls emit nothing).
        h = ev.fold(seed, 3)
        valid1 = ok & ((h % 256) < p.handoff_p)
        dst1 = ring_neighbor(gid, ((h >> 8) & 1) == 1,
                             p.n_cells).to(torch.int32)

        out = EmittedEvents(
            dst=torch.stack([gid, dst1], 1),
            ts=torch.stack([ts0, depart], 1),
            seed=torch.stack([ev.fold(seed, 4), ev.fold(seed, 5)], 1),
            payload=torch.stack([torch.full_like(ts, ARRIVAL),
                                 torch.full_like(ts, HANDOFF)], 1),
            valid=torch.stack([valid0, valid1], 1),
        )
        return new_state, out

    # -- numpy mirror (sequential oracle) --------------------------------------

    def init_object_state_np(self, global_ids: np.ndarray) -> list[dict]:
        C = self.params.n_channels
        return [{
            "gid": np.int32(g),
            "free_at": np.zeros(C, np.float32),
            "arrivals": np.int32(0),
            "calls": np.int32(0),
            "handoffs_in": np.int32(0),
            "blocked": np.int32(0),
            "dropped": np.int32(0),
            "count": np.int32(0),
        } for g in global_ids]

    def process_event_np(self, st: dict, ts, seed, payload) -> list[dict]:
        p = self.params
        la = np.float32(p.lookahead)
        seed = np.uint32(seed)
        is_handoff = float(payload) > 0.5
        st["count"] = np.int32(st["count"] + 1)

        free = st["free_at"] <= np.float32(ts)
        ok = bool(np.any(free))
        idx = int(np.argmax(free))
        hold = np.float32(la + ev.draw_np(ev.fold_np(seed, 0), p.dist,
                                          p.service_mean))
        depart = np.float32(np.float32(ts) + hold)
        if ok:
            st["free_at"][idx] = depart
            key = "handoffs_in" if is_handoff else "calls"
        else:
            key = "dropped" if is_handoff else "blocked"
        st[key] = np.int32(st[key] + 1)
        if not is_handoff:
            st["arrivals"] = np.int32(st["arrivals"] + 1)

        out = []
        if not is_handoff:                          # generator self-loop
            if st["gid"] < p.hot_cells:
                gap = ev.draw_scaled_np(ev.fold_np(seed, 1), p.dist,
                                        p.hot_shift, p.service_mean)
            else:
                gap = ev.draw_np(ev.fold_np(seed, 1), p.dist, p.service_mean)
            more = p.max_calls == 0 or int(st["arrivals"]) < p.max_calls
            out.append({"dst": np.int32(st["gid"]),
                        "ts": np.float32(np.float32(ts)
                                         + np.float32(la + gap)),
                        "seed": ev.fold_np(seed, 4),
                        "payload": np.float32(ARRIVAL),
                        "valid": more})
        h = ev.fold_np(seed, 3)
        if ok and int(h % np.uint32(256)) < p.handoff_p:
            out.append({"dst": ring_neighbor(np.int32(st["gid"]),
                                             int((h >> np.uint32(8))
                                                 & np.uint32(1)),
                                             p.n_cells),
                        "ts": depart,
                        "seed": ev.fold_np(seed, 5),
                        "payload": np.float32(HANDOFF)})
        return out


def make(**overrides) -> WirelessModel:
    if "n_objects" in overrides:                 # workload-agnostic callers
        overrides["n_cells"] = overrides.pop("n_objects")
    overrides.pop("initial_events", None)
    return WirelessModel(WirelessParams(**overrides))


CONFORMANCE = dict(
    # few channels + a hot head so blocking (absorption), handoff chains and
    # the skewed arrival field are all exercised at differential scale.
    model_kw=dict(n_cells=16, n_channels=3, hot_cells=4, hot_shift=2,
                  hot_streams=2, handoff_p=112, lookahead=0.5, dist="dyadic"),
    n_epochs=24,
    engine_kw=dict(n_buckets=8, bucket_cap=64, route_cap=512,
                   fallback_cap=512),
    dyadic=True,
    supports_batch_impl=False,
)
