"""Rank functions for multi-device checks, run by :func:`repro_torch.core.
dist.spawn` (each rank is its own process, so each function is a
module-level function of ``(rank, group, ...)`` that imports only the
port).

* :func:`states_rank` — run configs of a workload at its conformance
  horizon and return each rank's final state (numpy, the JAX engine's
  shard layout) with the totals, to hold against the JAX engine rank by
  rank, leaf by leaf;
* :func:`bench_states_rank` — the same at the reference bench's scale
  (``bench_path``), under :data:`BENCH_HOT_RUNGS`;
* :func:`digest_rank` — step a config epoch by epoch, count each object's
  processed events from the bucket it drains, and digest the gathered
  state as the oracle's golden digests are made;
* :func:`plain_equal_rank` — the engine on a group of one equals the
  engine without a group, bit for bit;
* :func:`~.conformance.sweep_rank` — conformance sweeps of several
  workloads, each config's failure reported by name instead of ending the
  sweep;
* :func:`a2a_oob_rank` — an out-of-bounds event sent through the real a2a
  exchange is counted on the device it reaches;
* :func:`comm_rank` — the device axis's collectives on a tree of mixed
  dtypes, :func:`hang_rank`, a rank that never joins one, and
  :func:`loaded_rank`, what a rank has imported;
* :func:`tasks_rank` — several of these in one spawn (the ranks start
  once).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.calendar import bucket_occupancy, make_calendar, make_fallback
from ..core.dist import Comm
from ..core.engine import EngineConfig, ParsirEngine
from ..core.events import EventBatch
from ..core.pipeline.base import resolve_router
from ..core.pipeline.deliver import deliver
from ..core.placement import equal_placement
from ..interop import engine_state_to_numpy, numpy_leaves
from ..workloads.registry import (bench_path, conformance_spec,
                                  get_workload)
from .conformance import SWEEP, engine_result, sweep_rank  # noqa: F401
from .golden import golden_case, state_digest


def build(workload: str, config: str, device: str = "cpu", group=None,
          model_overrides: dict | None = None):
    """(engine, horizon in epochs) of ``workload``'s conformance recipe
    under SWEEP point ``config``."""
    spec = conformance_spec(workload)
    model = get_workload(workload, **dict(spec["model_kw"],
                                          **(model_overrides or {})))
    over = dict(SWEEP[config])
    frac = over.pop("epoch_len_frac", None)
    kw = dict(lookahead=model.params.lookahead, **spec["engine_kw"], **over)
    n = spec["n_epochs"]
    if frac is not None:
        kw["epoch_len"] = model.params.lookahead * frac
        n = int(round(n / frac))
    eng = ParsirEngine(model, EngineConfig(**kw), device=device, group=group)
    return eng, n


def states_rank(rank: int, group, workload: str, configs: list[str],
                device: str = "cpu", drain: bool = False) -> dict:
    """Each config's final state on this rank (numpy) and the totals."""
    torch.set_num_threads(1)
    out = {}
    for config in configs:
        eng, n = build(workload, config, device, group)
        st = (eng.run_until_drained(eng.init(), n) if drain
              else eng.run(eng.init(), n))
        out[config] = {"state": engine_state_to_numpy(st),
                       "totals": eng.totals(st)}
    return out


#: the reference bench's phold-hotspot rungs ``steal_on`` and
#: ``placement_adaptive`` (benchmarks/pdes_perf.py, ``build_ladder``) at its
#: own route_cap, as ``bench_path`` overrides.
BENCH_HOT_RUNGS = {
    "steal-a2a": dict(route="a2a", bucket_cap=512, steal=True, steal_cap=8,
                      claim_cap=16),
    "adaptive-a2a": dict(route="a2a", bucket_cap=512, placement="adaptive",
                         placement_slack=1.5, rebalance_every=4,
                         migrate_cap=64),
}
#: the JAX engine's per-device counters under those rungs, 16 epochs on 2
#: fake host devices (the tests hold the JAX run to them and the port's
#: ranks to the JAX run leaf by leaf): the bench's route_cap of 8192 leaves
#: an a2a pair buffer of 4096, and both engines overflow it alike.
BENCH_HOT_JAX = {
    "steal-a2a": {"route_overflow": [3746, 1288], "late_events": [781, 66],
                  "processed": [95713, 74654], "stolen": [0, 125],
                  "migrated": [0, 0]},
    "adaptive-a2a": {"route_overflow": [0, 10657],
                     "late_events": [0, 2657],
                     "processed": [65064, 90865], "stolen": [0, 0],
                     "migrated": [76, 0]},
}


def bench_states_rank(rank: int, group, workload: str,
                      rungs: dict[str, dict], n_epochs: int,
                      device: str = "cpu") -> dict:
    """Each rung (``bench_path`` overrides) of ``workload`` at the bench's
    scale run ``n_epochs``: this rank's final state (numpy) and the
    totals."""
    torch.set_num_threads(1)
    out = {}
    for name, over in rungs.items():
        model, cfg = bench_path(workload, **over)
        eng = ParsirEngine(model, cfg, device=device, group=group)
        st = eng.run(eng.init(), n_epochs)
        out[name] = {"state": engine_state_to_numpy(st),
                     "totals": eng.totals(st)}
    return out


def digest_rank(rank: int, group, key: str, configs: list[str],
                device: str = "cpu") -> dict[str, str] | None:
    """The digest of golden case ``key`` (``"phold/small"``) run under each
    config (conservative steps), gathered from every rank, made as the
    pinned digests are; rank 0 returns ``{config: digest}``."""
    torch.set_num_threads(1)
    name, model_kw, n = golden_case(key)
    out = {}
    for config in configs:
        model = get_workload(name, **model_kw)
        over = dict(SWEEP[config])
        eng = ParsirEngine(model, EngineConfig(
            lookahead=model.params.lookahead,
            **conformance_spec(name)["engine_kw"], **over),
            device=device, group=group)
        out[config] = _digest(eng, n)
    return out if rank == 0 else None


def _digest(eng: ParsirEngine, n: int) -> str:
    st = eng.init()
    processed = np.zeros(eng.model.n_objects, np.int64)
    for _ in range(n):
        # the bucket a step drains holds exactly this epoch's events of
        # each object, wherever a loan processes them.
        occ = eng.comm.all_gather(bucket_occupancy(st.cal, st.epoch[0]))
        gid, live = eng.global_row_of(st)
        np.add.at(processed, gid[live], occ.reshape(-1).cpu().numpy()[live])
        st = eng.step(st)
    return state_digest(engine_result(eng, st, processed))


def plain_equal_rank(rank: int, group, workload: str, configs: list[str],
                     device: str = "cpu") -> list[str]:
    """Each config run on a group of one and without a group: every leaf
    of the final states equal; returns the configs checked."""
    torch.set_num_threads(1)
    for config in configs:
        a, n = build(workload, config, device, group)
        b, _ = build(workload, config, device)
        sa = engine_state_to_numpy(a.run(a.init(), n))
        sb = engine_state_to_numpy(b.run(b.init(), n))
        for x, y in zip(numpy_leaves(sa), numpy_leaves(sb), strict=True):
            np.testing.assert_array_equal(x, y, err_msg=config)
    return list(configs)


def a2a_oob_rank(rank: int, group, device: str = "cpu") -> int:
    """Device 0 writes one event with ``dst = O + 5`` into its sub-buffer
    for device 2; after the a2a exchange and delivery it is counted on
    device 2 alone.  Returns this rank's out-of-bounds count."""
    comm = Comm(group)
    D, O = comm.size, 16
    cfg = EngineConfig(lookahead=0.5, n_buckets=8, bucket_cap=16,
                       route_cap=16 * D, fallback_cap=16, route="a2a")
    pl = equal_placement(O, D)
    pc = cfg.route_cap // D
    shape = (1, D * pc)
    buf = EventBatch(
        dst=torch.zeros(shape, dtype=torch.int32, device=device),
        ts=torch.full(shape, float("inf"), device=device),
        seed=torch.zeros(shape, dtype=torch.int64, device=device),
        payload=torch.zeros(shape, device=device),
        valid=torch.zeros(shape, dtype=torch.bool, device=device))
    if rank == 0:
        buf.dst[0, 2 * pc], buf.ts[0, 2 * pc] = O + 5, 1.25
        buf.valid[0, 2 * pc] = True
    router = resolve_router("a2a")
    routed = router.exchange(buf, pl, cfg, comm)
    fb = make_fallback(cfg.fallback_cap, device)
    fb = type(fb)(EventBatch(*(x[None] for x in fb.events)))
    out = deliver(make_calendar(pl.n_local_max, 8, 16, device), fb, routed,
                  torch.zeros(1, dtype=torch.int32, device=device),
                  comm.rank, pl, cfg, init=False,
                  replicated=router.replicated)
    return int(out[5][0])


def comm_rank(rank: int, group, device: str = "cpu") -> dict:
    """A tree of mixed dtypes (f32 with NaN and signed-zero bits, i64 u32
    seeds, i32, bool, a 0-d leaf, an empty leaf, an EventBatch) through
    ``all_gather``, ``all_to_all`` and ``all_sum``; returns what came back
    as numpy."""
    comm = Comm(group)
    D = comm.size
    g = torch.Generator().manual_seed(rank)
    f = torch.rand((D, 3), generator=g)
    f[0, 0], f[0, 1] = float("nan"), -0.0
    tree = {"f": f.to(device),
            "seed": torch.full((D, 2), 2**32 - 1 - rank,
                               dtype=torch.int64, device=device),
            "i": torch.arange(D * 5, dtype=torch.int32,
                              device=device).view(D, 5) + 100 * rank,
            "b": torch.tensor([[rank % 2 == 0]] * D, device=device),
            "ev": EventBatch(*(x.to(device)[None].expand(D, 4).contiguous()
                               for x in (torch.arange(4, dtype=torch.int32),
                                         torch.rand(4, generator=g),
                                         torch.arange(4) + 2**31,
                                         torch.rand(4, generator=g),
                                         torch.tensor([1, 0, 1, 1]).bool()))),
            "empty": torch.zeros((D, 0), device=device)}
    scalar = {"k": torch.tensor(rank * 7, dtype=torch.int32, device=device)}
    gathered = comm.all_gather(tree)
    swapped = comm.all_to_all(tree)

    def np_(t):
        return {k: np_(v) for k, v in t.items()} if isinstance(t, dict) \
            else ([np_(x) for x in t] if isinstance(t, tuple)
                  else t.cpu().numpy())
    return {"sent": np_(tree), "gathered": np_(gathered),
            "swapped": np_(swapped),
            "scalar": np_(comm.all_gather(scalar)),
            "sum": int(comm.all_sum(torch.tensor(rank + 1))),
            "calls": comm.calls, "bytes": comm.bytes}


def loaded_rank(rank: int, group) -> list[str]:
    """The modules of JAX or of the JAX package loaded in this rank (none:
    a rank imports only the port)."""
    import sys
    return sorted(n for n in sys.modules
                  if n.split(".")[0] in ("jax", "jaxlib", "repro"))


def hang_rank(rank: int, group) -> None:
    """Rank 0 waits in a collective that rank 1 never joins."""
    import time
    if rank == 0:
        Comm(group).all_sum(torch.ones(1))
    else:
        time.sleep(3600)


def tasks_rank(rank: int, group, tasks: list[tuple[str, tuple]]) -> list:
    """Run ``(name, args)`` tasks, ``name`` a rank function of this module,
    in order on one spawn's ranks; returns their results in order."""
    return [globals()[name](rank, group, *args) for name, args in tasks]
