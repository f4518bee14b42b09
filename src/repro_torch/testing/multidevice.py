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
* :func:`replicated_states_rank` — stacked replications over the ranks,
  object-sharded (R x D) or laid over them (``rep_shards``): each config
  held to every replication's oracle and to its own ``run_until_drained``
  leaf by leaf, this rank's stack returned to hold against the JAX
  engine's;
* :func:`rep_shards_errors_rank` — the layout's ``ValueError``s;
* :func:`main_path_replicated_rank` — PHOLD's main path stacked over the
  ranks, either layout: per-replication digests of the rank's rows
  (:func:`shard_digests`), the drain's launches, collectives, host syncs,
  graph replays and ms/epoch;
* :func:`serve_mesh_rank` — a dense config served over a ``(data,
  model)`` mesh of the spawn's ranks (``distributed.sharding``): prefill
  and decode under ``"gather"`` and ``"sp"``, the full logits, each
  leaf's local shape, launches, collectives and times;
* :func:`train_mesh_rank` — a dense config trained by ``Trainer(mesh=)``
  over a ``(data, model)`` mesh of the spawn's ranks, under megatron or
  fsdp, with or without the ZeRO-2 ``grad_shardings``: each step's loss,
  grad norm and lr, the parameters at the end (gathered), each leaf's
  local shape, the first step's gradients' layout and their gap to a
  one-device set, a checkpoint saved and one resumed (the elastic
  reshard), a failure injected on one rank, and on the card the step
  times, collectives and peak memory;
* :func:`elastic_rank` — a checkpoint saved anywhere restored onto this
  spawn's mesh and trained on;
* :func:`tasks_rank` — several of these in one spawn (the ranks start
  once).
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.calendar import bucket_occupancy, make_calendar, make_fallback
from ..core.dist import Comm
from ..core.engine import EngineConfig, ParsirEngine
from ..core.events import EventBatch
from ..core.pipeline.base import resolve_router
from ..core.pipeline.deliver import deliver
from ..core.placement import equal_placement
from ..core.graphs import clone_state
from ..interop import engine_state_to_numpy, numpy_leaves
from ..roofline.analysis import collective_kind
from ..workloads.registry import (bench_path, conformance_spec,
                                  get_workload)
from .conformance import (SWEEP, check_workload_replicated,  # noqa: F401
                          engine_result, replicated_rank, sweep_rank)
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


def replicated_states_rank(rank: int, group, workload: str,
                           configs: list[str], replications: int,
                           device: str = "cpu",
                           rep_shards: int | None = None) -> dict:
    """Each config's stack of ``replications`` seeds drained over the
    ranks (object-sharded, or with ``rep_shards`` laid over them), held to
    every replication's oracle (:func:`~.conformance.
    check_workload_replicated`) and, leaf by leaf, to each replication's
    own ``run_until_drained`` in the same layout; returns this rank's stack
    (numpy), the per-replication totals and epochs."""
    torch.set_num_threads(1)
    out = {}
    for config in configs:
        rep = check_workload_replicated(
            workload, config, replications=replications, device=device,
            group=None if rep_shards else group, rep_shards=rep_shards,
            rep_group=group if rep_shards else None)
        eng, st = rep["engine"], rep["state"]
        own, n = build(workload, config, device,
                       None if rep_shards else group)
        for j, r in enumerate(eng.rep_slice(replications)):
            one = own.run_until_drained(own.init(seed=r), n)
            got = engine_state_to_numpy(eng.replication(st, j))
            for x, y in zip(numpy_leaves(got),
                            numpy_leaves(engine_state_to_numpy(one)),
                            strict=True):
                np.testing.assert_array_equal(
                    x, y, err_msg=f"{workload}/{config} replication {r} "
                                  f"!= its own run_until_drained")
        out[config] = {"state": engine_state_to_numpy(st),
                       "totals": rep["totals"],
                       "epochs": eng.epochs_replicated(st)}
    return out


def rep_shards_errors_rank(rank: int, group) -> list[str | None]:
    """The messages of the three ``ValueError``s of ``rep_shards`` on a
    group of two ranks: an object axis of D = 2, three seeds over two
    shards, three shards over two ranks (None where nothing raised)."""
    spec = conformance_spec("phold")
    model = get_workload("phold", **spec["model_kw"])
    cfg = EngineConfig(lookahead=model.params.lookahead, **spec["engine_kw"])
    tries = (
        lambda: ParsirEngine(model, cfg, "cpu", group=group, rep_shards=2),
        lambda: ParsirEngine(model, cfg, "cpu", rep_shards=2,
                             rep_group=group).init_replicated([0, 1, 2]),
        lambda: ParsirEngine(model, cfg, "cpu", rep_shards=3,
                             rep_group=group))
    msgs = []
    for make in tries:
        try:
            make()
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def tree_digest(tree: dict) -> str:
    """sha256 of a dict of arrays in key order, each in a canonical dtype
    (floats as f32, integers as i64)."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(tree):
        v = np.asarray(tree[k])
        v = v.astype(np.float32 if v.dtype.kind == "f" else np.int64)
        h.update(k.encode() + str(v.shape).encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def shard_digests(state, rows: slice | None = None) -> list[dict]:
    """Per replication of a stacked state: the digests of its object state
    and calendar counts over ``rows`` (all rows by default)."""
    rows = rows or slice(None)
    out = []
    for r in range(state.epoch.shape[0]):
        out.append({
            "obj": tree_digest({k: v[r, rows].cpu().numpy()
                                for k, v in state.obj.items()}),
            "cnt": tree_digest({"cnt": state.cal.cnt[r, rows].cpu().numpy()}),
        })
    return out


def main_path_replicated_rank(rank: int, group, device: str, seeds: list,
                              n_epochs: int, rep_shards: int | None = None,
                              route: str = "allgather") -> dict:
    """PHOLD's main path (``workloads.phold.main_path``) x ``seeds``,
    stacked over the group: object-sharded under ``route``, or with
    ``rep_shards`` each rank draining its own slice (on the card as graph
    replays; a first drain of ``DRAIN_CHUNK`` epochs on a copy captures
    them).  ``n_epochs`` of ``run_replicated_drained`` timed.  Returns the
    rank's per-replication digests (:func:`shard_digests`) with the seeds'
    indices it holds, the totals and epochs of every replication, and the
    timed drain's counters per epoch."""
    import dataclasses
    import time

    from ..core.graphs import DRAIN_CHUNK
    from ..kernels.event_apply import event_apply_cuda
    from ..kernels.ops import KERNELS
    from ..workloads.phold import main_path
    from ..core.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    model, cfg = main_path()
    cfg = dataclasses.replace(cfg, route=route)
    eng = ParsirEngine(model, cfg, device=dev,
                       group=None if rep_shards else group,
                       rep_shards=rep_shards,
                       rep_group=group if rep_shards else None)
    st = eng.init_replicated(seeds)
    eng.run_replicated_drained(clone_state(st), DRAIN_CHUNK)
    comms = [c for c in (eng.comm, eng.rep_comm) if c is not None]
    graphs = eng.rep_graphs
    for fn in KERNELS:
        fn.launches = 0
    calls, syncs = sum(c.calls for c in comms), eng.syncs
    replays, captures = ((graphs.replays, graphs.captures) if graphs
                         else (0, 0))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
    t0 = time.perf_counter()
    st = eng.run_replicated_drained(st, n_epochs)
    if cuda:
        e1.record()
        torch.cuda.synchronize(dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / n_epochs
    timing = {
        "ms_events": e0.elapsed_time(e1) / n_epochs if cuda else None,
        "ms_host": host_ms,
        "collectives": sum(c.calls for c in comms) - calls,
        "syncs": eng.syncs - syncs,
        "launches": event_apply_cuda.launches / n_epochs,
        "rows": eng.placement.n_local_max * st.epoch.shape[0],
        "graphed": graphs is not None,
        "replays": (graphs.replays - replays) if graphs else 0,
        "captures": (graphs.captures - captures) if graphs else 0}
    M = eng.placement.n_local_max
    rows = None if rep_shards else slice(0, M)
    return {"held": list(eng.rep_slice(len(seeds))),
            "row0": 0 if rep_shards else eng.rank * M,
            "digests": shard_digests(st, rows),
            "totals": eng.totals_replicated(st),
            "epochs": eng.epochs_replicated(st), "timing": timing}


def serve_mesh_rank(rank: int, group, cfg, mesh_shape, prompts, runs,
                    tree=None, device: str = "cpu", keep_logits: bool = True,
                    measure: bool = False, max_len: int | None = None,
                    routes: bool = False, all_logits: bool = False) -> dict:
    """Serve ``cfg`` (any family) over a ``("data", "model")`` mesh of
    ``mesh_shape`` (the spawn's ranks, row-major): the model's parameters
    (from ``tree``, a host copy of the JAX model's, through
    ``interop.params_from_numpy``, else the port's seeded ones) placed by
    ``params_shardings``, the caches by ``cache_shardings`` and the
    prompts [B, T] by ``batch_shardings``, with the mesh ambient.  Each of
    ``runs``, ``(dtype, feed, modes, ref)``, serves in compute ``dtype``: a
    prefill of ``prompts`` into caches of ``max_len`` rows (default ``T +
    n``), then, from a copy of them under each ``decode_attn`` of
    ``modes``, one decode step per column of ``feed`` [B, n] (step i feeds
    ``feed[:, i]`` at position ``T + i``).

    Returns ``shapes`` (``(what, key, local shape, shard_shape)`` of every
    parameter leaf and of the first run's cache leaves), ``build_s`` and
    ``seconds`` (host clock: the model made and placed, and the whole
    call) and per run
    (``runs``, in order): the prefill's kernel ``launches`` and
    ``prefill_s`` (host clock, the card synchronized); ``sp_vs_gather``;
    with ``routes`` (an MoE config) ``routes``, each MoE layer's dispatch
    in the prefill as this rank routed its rows (:func:`_recording_routes`:
    ``(idx [Tt, k], keep [Tt, k], margin [Tt])`` in (token, slot) order,
    numpy), and per mode the decode steps' in the order of the calls;
    with ``all_logits`` (a
    decoder) ``prefill_logits``, the prefill's logits at every position
    [B, T, V] (f32, numpy); and per mode: the logits [n + 1, B, V] (the
    prefill's last position, then each step's; f32, numpy) if
    ``keep_logits``, their greedy ``tokens``, their max |Δ| ``err``
    against ``ref`` (numpy, same shape) where it is not None (``errs``:
    at each position).  With
    ``measure`` also: per mode the decode steps' seconds per token on the
    host clock (steps 2..n, the gather of each step's vocab-sharded
    logits included) and the collectives of step 1 (kind → bytes and
    count) with their host µs (the ``c10d`` calls and the functional
    collectives' waits); per run ``allreduce_s``, one all-reduce of a [B,
    1, d] activation over "model", and ``peak_bytes``, the rank's peak
    device memory over the run (the card's allocator; 0 on the CPU)."""
    from ..launch.mesh import make_mesh
    dev = _serving_device(device)
    mesh = make_mesh(mesh_shape, ("data", "model"), dev.type)
    return _serve_on(mesh, dev, cfg, prompts, runs, tree, keep_logits,
                     measure, max_len, routes, all_logits)


def serve_mesh_many(rank: int, group, plan: list,
                    device: str = "cpu") -> list:
    """:func:`serve_mesh_rank` of several jobs in one spawn: ``plan`` is a
    list of ``(mesh_shape, jobs)``, each job a dict of the keyword
    arguments (``cfg``, ``prompts``, ``runs`` and the options), run on a
    ``("data", "model")`` mesh of that shape over the spawn's ranks; per
    entry of ``plan`` the jobs' results in order."""
    from ..launch.mesh import make_mesh
    dev = _serving_device(device)
    out = []
    for mesh_shape, jobs in plan:
        mesh = make_mesh(mesh_shape, ("data", "model"), dev.type)
        out.append([])
        for job in jobs:
            job = dict(job)
            out[-1].append(_serve_on(mesh, dev, job.pop("cfg"),
                                     job.pop("prompts"), job.pop("runs"),
                                     **job))
    return out


def _serving_device(device: str) -> torch.device:
    """A serving rank's device, with one intra-op thread on the CPU (the
    ranks share the host's cores)."""
    from ..core.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    return dev


def _serve_on(mesh, dev, cfg, prompts, runs, tree=None, keep_logits=True,
              measure=False, max_len=None, routes=False,
              all_logits=False) -> dict:
    """:func:`serve_mesh_rank` on ``mesh``."""
    import dataclasses

    from ..distributed import sharding
    from ..models.registry import build_model
    from ..serve.engine import cache_shardings
    import torch.distributed as dist
    t_job = time.perf_counter()
    sharding.refuse_unported(cfg, "decode")
    # every rank makes the whole model and keeps its blocks; ranks sharing
    # one card take turns, so that only one whole model is there at once.
    turns = range(dist.get_world_size()) if dev.type == "cuda" else [None]
    for turn in turns:
        if turn in (None, dist.get_rank()):
            model = build_model(cfg, device=dev)
            if tree is not None:
                from ..interop import params_from_numpy
                model.load_state_dict(params_from_numpy(tree, cfg))
            pspecs = sharding.place_module(model, mesh)
            if dev.type == "cuda":
                gc.collect()
                torch.cuda.empty_cache()
        if turn is not None:
            dist.barrier()
    shapes = [("param", k, tuple(p.to_local().shape),
               sharding.shard_shape(p.shape, pspecs[k], mesh))
              for k, p in model.named_parameters()]
    n_par = len(shapes)
    B, T = prompts.shape
    rows = max_len or T + runs[0][1].shape[1]
    caches = model.init_cache(B, rows)
    cspecs = cache_shardings(caches, mesh, B)
    placed = sharding.place(caches, cspecs, mesh)
    keys, locs = [], []
    sharding.tree_map_with_path(lambda k, t: keys.append(k), caches)
    sharding.tree_map_with_path(lambda k, t: locs.append(t.to_local()),
                                placed)
    sharding._zip_map(lambda t, spec: shapes.append(
        ("cache", keys[len(shapes) - n_par].replace("/", "."),
         tuple(locs[len(shapes) - n_par].shape),
         sharding.shard_shape(t.shape, spec, mesh))), caches, cspecs)
    del caches, placed, locs
    out = {"shapes": shapes, "runs": [],
           "build_s": time.perf_counter() - t_job}
    for dtype, feed, modes, ref in runs:
        model.cfg = dataclasses.replace(cfg, dtype=dtype)
        out["runs"].append(_serve_run(model, mesh, dev, prompts, feed, modes,
                                      ref, keep_logits, measure, rows,
                                      routes, all_logits))
    model.cfg = cfg
    out["seconds"] = time.perf_counter() - t_job
    return out


def _tree_clone(tree):
    """A copy of a nest of dicts, lists and tuples of tensors."""
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_clone(v) for v in tree)
    return tree.clone()


@contextlib.contextmanager
def _recording_routes(into: list):
    """``moe.route`` recording each dispatch it makes into ``into``:
    ``(idx [Tt, k], keep [Tt, k], margin [Tt])`` in (token, slot) order,
    numpy; ``margin`` is each token's k-th largest router logit less its
    (k+1)-th over the call's largest |router logit|, how far the choice of
    its experts is from a tie."""
    from ..models import moe
    real = moe.route

    def recording(cfg, p, xf, *args, **kwargs):
        r = real(cfg, p, xf, *args, **kwargs)
        keep = torch.empty_like(r["keep"])
        keep[r["order"]] = r["keep"]
        k = r["idx"].shape[1]
        top = torch.sort((xf @ p["router"]).float(), dim=-1,
                         descending=True).values
        into.append((r["idx"].cpu().numpy(),
                     keep.reshape(r["idx"].shape).cpu().numpy(),
                     ((top[:, k - 1] - top[:, k])
                      / top.abs().max()).cpu().numpy()))
        return r
    moe.route = recording
    try:
        yield into
    finally:
        moe.route = real


@contextlib.contextmanager
def _forcing_routes(idxs):
    """``moe.route`` taking, at its i-th call, the experts ``idxs[i]``
    ([Tt, k], numpy) instead of the router's top k: a one-device run
    given another run's routing."""
    from ..models import moe
    real = moe.route
    given = iter(idxs)

    def forced(cfg, p, xf, *args, **kwargs):
        idx = torch.as_tensor(next(given), device=xf.device)
        return real(cfg, p, xf, *args, idx=idx, **kwargs)
    moe.route = forced
    try:
        yield
    finally:
        moe.route = real


def _serve_run(model, mesh, dev, prompts, feed, modes, ref, keep_logits,
               measure, rows, routes=False, all_logits=False) -> dict:
    """One run of :func:`serve_mesh_rank`: a prefill, then each mode's
    decode steps."""
    import dataclasses
    import time

    from ..distributed import sharding
    from ..kernels.ops import KERNELS
    from ..models.layers import dt_of, unembed
    from ..serve.engine import (cache_shardings, make_decode_step,
                                make_prefill)
    cfg = model.cfg
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    B, T = prompts.shape
    n = feed.shape[1]
    prompts = torch.as_tensor(prompts, device=dev)
    feed = torch.as_tensor(feed, device=dev)

    def batched(t):
        return sharding.place(t, sharding.batch_shardings(t, mesh), mesh)

    prefill, step = make_prefill(model), make_decode_step(model)
    full = model.init_cache(B, rows)
    filled = sharding.place(full, cache_shardings(full, mesh, B), mesh)
    del full
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    for fn in KERNELS:
        fn.launches = 0
    seen: list = []
    recorder = (_recording_routes(seen) if routes
                else contextlib.nullcontext())
    with sharding.use_mesh(mesh):
        w = model.weights()
        sync()
        t0 = time.perf_counter()
        with recorder:
            lg, filled = prefill(w, batched({"tokens": prompts}), filled)
        first = sharding.full(lg)[:, -1].float()
        sync()
    out = {"modes": {}, "prefill_s": time.perf_counter() - t0,
           "launches": {fn.__name__: fn.launches for fn in KERNELS}}
    if routes:
        out["routes"] = seen
    if all_logits:
        # the prefill's own steps, unembedding every position
        with sharding.use_mesh(mesh), torch.no_grad():
            batch = batched({"tokens": prompts})
            x, _, _ = model.embed_inputs(w, batch)
            pos = torch.arange(x.shape[1], device=dev)[None, :]
            empty = model.init_cache(B, rows)
            x = model._run(w, x, pos, sharding.place(
                empty, cache_shardings(empty, mesh, B), mesh))
            out["prefill_logits"] = sharding.full(
                unembed(cfg, w["embed"], x)).float().cpu().numpy()
    kept = {}
    for mode in modes:
        # the decode attention is the only difference between the modes:
        # each decodes from its own copy of the prefilled caches.
        model.cfg = dataclasses.replace(cfg, decode_attn=mode)
        caches = _tree_clone(filled)
        rec = {}
        steps = [first]
        seen = []
        with sharding.use_mesh(mesh), (_recording_routes(seen) if routes
                                       else contextlib.nullcontext()):
            t0 = None
            for i in range(n):
                tok = batched({"t": feed[:, i:i + 1]})["t"]
                cur = torch.tensor(T + i, device=dev)
                if i == 0 and measure:
                    with _Collectives() as c:
                        lg, caches = step(w, tok, caches, cur)
                        steps.append(sharding.full(lg)[:, -1].float())
                    rec["collectives"] = c.kinds
                    rec["collective_us"] = c.seconds * 1e6
                    sync()
                    t0 = time.perf_counter()
                    continue
                lg, caches = step(w, tok, caches, cur)
                steps.append(sharding.full(lg)[:, -1].float())
            sync()
            if measure and n > 1:
                rec["decode_s_per_token"] = (time.perf_counter() - t0) / (n - 1)
        del caches
        if routes:
            rec["routes"] = seen
        logits = torch.stack(steps).cpu().numpy()
        kept[mode] = logits
        rec["tokens"] = logits.argmax(-1)
        if ref is not None:
            rec["errs"] = np.abs(logits - ref).max(axis=(1, 2)).tolist()
            rec["err"] = max(rec["errs"])
        if keep_logits:
            rec["logits"] = logits
        out["modes"][mode] = rec
    model.cfg = cfg
    if measure:
        out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if cuda
                             else 0)
        # the latency of one collective between the ranks: an all-reduce of
        # a decode step's residual [B, 1, d] over "model".
        x = torch.zeros((B, 1, cfg.d_model), dtype=dt_of(cfg), device=dev)
        sync()
        t0 = time.perf_counter()
        for _ in range(20):
            sharding.all_reduce(x, "sum", mesh, "model")
        sync()
        out["allreduce_s"] = (time.perf_counter() - t0) / 20
    if "gather" in kept and "sp" in kept:
        out["sp_vs_gather"] = float(np.max(np.abs(kept["sp"]
                                                  - kept["gather"])))
    return out


class _Collectives(TorchDispatchMode):
    """The collectives a rank issues (``c10d`` and functional ops, by the
    roofline's kinds: ``{kind: {"bytes", "count"}}``, the bytes of their
    results; ``functional``: the count by kind of those issued as
    ``_c10d_functional`` ops, DTensor's own) and the host seconds spent in
    them, a functional collective's wait included.  Everything else passes straight through
    (``analysis.FlopCounter`` counts the same collectives, at a cost per
    op that would swamp a decode step's time); an op on DTensors is left
    to DTensor, whose local ops come back through the mode."""

    def __init__(self):
        super().__init__()
        self.kinds: dict = {}
        self.functional: dict = {}
        self.seconds = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        import time

        from ..distributed.sharding import is_dtensor
        if any(is_dtensor(a) for a in args):
            return NotImplemented
        if func.namespace not in ("c10d", "_c10d_functional"):
            return func(*args, **(kwargs or {}))
        t0 = time.perf_counter()
        out = func(*args, **(kwargs or {}))
        self.seconds += time.perf_counter() - t0
        kind = collective_kind(func._overloadpacket.__name__)
        if kind is not None and func.namespace == "_c10d_functional":
            self.functional[kind] = self.functional.get(kind, 0) + 1
        if kind is not None:
            rec = self.kinds.setdefault(kind, {"bytes": 0, "count": 0})
            rec["count"] += 1
            rec["bytes"] += sum(t.numel() * t.element_size()
                                for t in _flat_tensors(out))
        return out


def _flat_tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for x in out for t in _flat_tensors(x)]
    return []


class FixedLoader:
    """The loader of a mesh run: ``SyntheticLoader(cfg, B, T)``'s batch of
    each step (or, ``fixed``, of step 0 at every step), the global batch
    that every rank reads whole."""

    def __init__(self, cfg, B: int, T: int, fixed: bool, device):
        from ..data.synthetic import SyntheticLoader
        self.inner = SyntheticLoader(cfg, B, T, device=device)
        self.fixed = fixed

    def batch_at(self, step: int):
        return self.inner.batch_at(0 if self.fixed else step)


def train_mesh_rank(rank: int, group, cfg, mesh_shape, runs: list,
                    data: tuple, tree=None, device: str = "cpu",
                    progress: bool = False) -> list:
    """Train the dense config ``cfg`` with ``Trainer(mesh=)`` over a
    ``("data", "model")`` mesh of ``mesh_shape`` (the spawn's ranks,
    row-major), once per entry of ``runs``, each from a fresh model: its
    parameters from ``tree`` (a host copy of the JAX model's, through
    ``interop.params_from_numpy``), else the port's seeded ones.  ``data``
    is ``(B, T, fixed)``: the global batch of each step is
    :class:`FixedLoader`'s.

    A run is a dict: ``mode`` (megatron or fsdp), ``tcfg`` (a
    ``TrainConfig``; its ``checkpoint_dir`` is read when the run resumes
    or saves), ``steps`` (the Trainer's ``run(steps)``), and optionally:
    ``mesh`` (another mesh shape for this run); ``changes`` (fields of
    ``cfg`` changed for this run: ``dtype``, ``remat``, ``n_layers``);
    ``grad_shardings`` (True: the step takes the parameters' specs as the
    ZeRO-2 constraint, put in place of the Trainer's own step, which
    passes none); ``resume`` (start from the checkpoint in
    ``checkpoint_dir`` instead of step 0); ``grads`` (the first step's
    gradients as its update receives them: their placements and local
    shapes and, with a path, their gap to the one-device gradients saved
    there by ``torch.save``); ``fail`` (``(rank, step)``: that rank's
    first attempt at that step raises after the step's last collective,
    before its update writes anything); ``keep`` (return the final
    parameters, gathered, as numpy); ``digest`` (return a digest of
    them); ``measure`` (step seconds, the collectives of a step, peak
    memory, and the staged all-gather's GB/s between the ranks).

    Returns per run: ``hist`` (the Trainer's metrics of each step run),
    ``step0``, ``seconds`` (the run's, build to gather), ``launches``
    (each kernel's, in the Trainer's steps), ``shapes`` (``(what, key,
    local shape, shard_shape)`` of every parameter and moment after the
    run), ``failures`` and what the run's options ask for.  With
    ``progress`` each rank prints a line as each run ends (its steps'
    losses, its peak device memory)."""
    import dataclasses

    from ..core.device import resolve_device
    from ..distributed import sharding
    from ..kernels.ops import KERNELS
    from ..launch.mesh import make_mesh
    from ..models.registry import build_model
    from ..train.loop import Trainer
    from ..train.step import make_train_step
    sharding.refuse_unported(cfg, "train")
    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)        # the ranks share the host's cores
    meshes = {}
    loader = FixedLoader(cfg, *data, device=dev)
    out = []
    for run in runs:
        t_run = time.perf_counter()
        shape = tuple(run.get("mesh", mesh_shape))
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"), dev.type)
        mesh = meshes[shape]
        sharding.set_mode(run["mode"])
        rcfg = dataclasses.replace(cfg, **run.get("changes", {}))
        if dev.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        model = build_model(rcfg, device=dev)
        if tree is not None:
            from ..interop import params_from_numpy
            model.load_state_dict(params_from_numpy(tree, rcfg))
        tcfg = run["tcfg"]
        tr = Trainer(model, tcfg, mesh=mesh, loader=loader,
                     log=lambda s: None)
        rec = {}
        if run.get("grad_shardings"):
            tr.step_fn.fn = make_train_step(model, tcfg,
                                            grad_shardings=tr._psh)
        if run.get("resume"):
            start = None
        else:
            params = tr.params()
            from ..train import optimizer as opt
            start = (params, opt.init(params), 0)
        timing = _Timing(dev) if run.get("measure") else None
        if timing:
            tr.step_fn.fn = timing.wrap(tr.step_fn.fn)
        for fn in KERNELS:
            fn.launches = 0
        with _failing(rank, run.get("fail")), \
                _first_grads(rec, run.get("grads"), tr._psh, mesh):
            params, state, hist = tr.run(run["steps"], start=start)
        del start
        rec["launches"] = {fn.__name__: fn.launches for fn in KERNELS}
        rec.update(hist=[{k: h[k] for k in ("step", "loss", "grad_norm",
                                             "lr", "step_s")}
                         for h in hist],
                   step0=hist[0]["step"] if hist else run["steps"],
                   failures=tr.step_fn.failures)
        rec["shapes"] = [
            (what, k, tuple(t.to_local().shape),
             sharding.shard_shape(t.shape, tr._psh[k], mesh))
            for what, tr_ in (("param", params), ("mu", state.mu),
                              ("nu", state.nu)) for k, t in tr_.items()]
        if run.get("keep") or run.get("digest"):
            # leaf by leaf: a full-width model's gathered parameters would
            # not fit beside the ranks' shards on one card.
            whole = {k: sharding.full(p.detach()).cpu().numpy()
                     for k, p in params.items()}
            rec["digest"] = tree_digest(whole)
            if run.get("keep"):
                rec["params"] = whole
            del whole
        if timing:
            rec["timing"] = dict(timing.result(),
                                 gather_gbs=_staged_rate(mesh, dev))
        rec["seconds"] = time.perf_counter() - t_run
        if progress:
            peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                    if dev.type == "cuda" else float("nan"))
            print(f"[train_mesh] rank {rank} run {len(out)} ({run['mode']}"
                  f" on {shape}) done in {rec['seconds']:.1f} s: losses "
                  f"{[round(h['loss'], 6) for h in rec['hist']]}, peak "
                  f"{peak:.2f} GiB", flush=True)
        out.append(rec)
        del tr, model, params, state
    return out


@contextlib.contextmanager
def _first_grads(rec: dict, want, specs: dict, mesh):
    """With ``want`` (True, or the path of the one-device gradients saved
    by ``torch.save``): the gradients of the run's first step, as the
    update receives them, into ``rec["grads"]``: each leaf's placements
    against its parameter's and local shape against its ``shard_shape``;
    with a path, each gathered leaf's max gap to the one-device leaf over
    that leaf's max |g|, and the leaves zero here but not there.  The
    identity with ``want`` falsy."""
    from ..train import optimizer as opt
    update = opt.update

    def seen(grads, state, params, tcfg, agree=None):
        if "grads" not in rec:
            rec["grads"] = _grads_report(grads, params, want, specs, mesh)
        return update(grads, state, params, tcfg, agree)
    if want:
        opt.update = seen
    try:
        yield
    finally:
        opt.update = update


def _grads_report(grads, params, want, specs, mesh) -> dict:
    from ..distributed import sharding
    out = {"layout": [(k, str(list(g.placements)),
                       str(list(params[k].placements)),
                       tuple(g.to_local().shape),
                       sharding.shard_shape(g.shape, specs[k], mesh))
                      for k, g in grads.items()]}
    if isinstance(want, str):
        ref = torch.load(want, map_location="cpu")
        err, zero = 0.0, []
        for k, g in grads.items():
            got = sharding.full(g).float().cpu()
            scale = float(ref[k].abs().max())
            err = max(err, float((got - ref[k].float()).abs().max())
                      / max(scale, 1e-30))
            if float(got.abs().max()) == 0 and scale > 0:
                zero.append(k)
        out["err"], out["zero"] = err, zero
    return out


@contextlib.contextmanager
def _failing(rank: int, fail):
    """With ``fail`` = ``(fail_rank, fail_step)``: that rank's first
    attempt at step ``fail_step`` (counted from the run's first) raises
    where a real fault would leave the ranks' collectives aligned: after
    the step's last collective (the gradient norm's), before the update's
    agreement and first write (``optimizer.update`` asks the schedule for
    the learning rate in between).  The identity with ``fail`` None."""
    from ..train import optimizer as opt
    schedule, calls = opt.schedule, [0]

    def failing(step, tcfg):
        calls[0] += 1
        if rank == fail[0] and calls[0] == fail[1] + 1:
            raise RuntimeError(f"injected failure on rank {rank} at step "
                               f"{fail[1]}")
        return schedule(step, tcfg)
    if fail is not None:
        opt.schedule = failing
    try:
        yield
    finally:
        opt.schedule = schedule


class _Timing:
    """A run's steps on the host clock (the device synchronised), the
    collectives of its first step (:class:`_Collectives`: kind → bytes
    and count, and their host seconds; counted on the first step only, as
    the counting mode costs host time at every op) and the peak device
    memory of the run."""

    def __init__(self, dev):
        self.dev, self.steps = dev, []

    def wrap(self, fn):
        sync = (torch.cuda.synchronize if self.dev.type == "cuda"
                else (lambda: None))

        def timed(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            if self.steps:
                out = fn(*args, **kwargs)
                sync()
                self.steps.append({"s": time.perf_counter() - t0})
                return out
            with _Collectives() as c:
                out = fn(*args, **kwargs)
                sync()
            self.steps.append({"s": time.perf_counter() - t0,
                               "collectives": c.kinds,
                               "functional": c.functional,
                               "collective_s": c.seconds})
            return out
        return timed

    def result(self) -> dict:
        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else None)
        return {"steps": self.steps, "peak": peak}


def _staged_rate(mesh, dev, mib: int = 128, reps: int = 3) -> float:
    """GB/s of the staged all-gather (``sharding._staged_collective``) of
    a ``mib`` MiB bf16 block a rank over the mesh's first dim of more than
    one rank: the gathered bytes over the host clock, the device
    synchronised, after one warm-up."""
    from ..distributed import sharding
    i = next(j for j in range(mesh.ndim) if mesh.size(j) > 1)
    block = torch.zeros(mib * 2**19, dtype=torch.bfloat16, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sharding._staged_collective("gather", block, 0, mesh, i)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        sharding._staged_collective("gather", block, 0, mesh, i)
    sync()
    moved = reps * mesh.size(i) * block.numel() * block.element_size()
    return moved / (time.perf_counter() - t0) / 1e9


def elastic_rank(rank: int, group, cfg, mesh_shape, mode: str, tcfg,
                 n_steps: int, data: tuple, device: str = "cpu") -> dict:
    """Restore the checkpoint in ``tcfg.checkpoint_dir`` (saved on one
    device or another mesh) onto a ``("data", "model")`` mesh of
    ``mesh_shape`` under ``mode`` and train on to ``n_steps``
    (:func:`train_mesh_rank` with ``resume``)."""
    run = {"mode": mode, "tcfg": tcfg, "steps": n_steps, "resume": True,
           "keep": True}
    return train_mesh_rank(rank, group, cfg, mesh_shape, [run], data,
                           device=device)[0]


def tasks_rank(rank: int, group, tasks: list[tuple[str, tuple]]) -> list:
    """Run ``(name, args)`` tasks, ``name`` a rank function of this module,
    in order on one spawn's ranks; returns their results in order."""
    return [globals()[name](rank, group, *args) for name, args in tasks]
