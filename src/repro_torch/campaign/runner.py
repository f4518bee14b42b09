"""The campaign loop: one stacked drain per grid point.

Port of ``repro/campaign/runner.py``.  Grid-point parameters change the
model (shapes, branches), so points run one after another; a point's seeds
are data, and all of them advance together through
:meth:`ParsirEngine.run_replicated_drained`: two dispatches per point (the
ingest and the drain), whatever the seed count.

Over ``spec.devices = D > 1`` the runner spawns D ranks
(:func:`~repro_torch.core.dist.spawn`: NCCL with a card per rank where
there are D cards, else gloo ranks sharing the device) and makes the
reference's choice of layout: ``rep_shards = D`` (each rank drains its own
``len(seeds) / D`` replications, collective-free) when D divides the
seed count, else the stack object-sharded over the D ranks (R x D).  Rank 0
writes the store.

Every replication's counters are checked against the clean-run contract
(:mod:`repro_torch.testing.clean`) and its drain recorded; the point's
result lands in the :class:`ResultsStore` before the next point starts, so
an interrupted campaign resumes where it stopped.  A point's result has the
reference runner's keys and values, so a store means the same to both.
"""
from __future__ import annotations

from typing import Any, Callable

from .spec import CampaignSpec
from .store import ResultsStore


def _run_point(spec: CampaignSpec, index: int, device, group=None,
               rep_shards: int | None = None) -> dict[str, Any]:
    from ..core.engine import EngineConfig, ParsirEngine
    from ..testing.clean import unclean_counters
    from ..workloads.registry import get_workload

    point = spec.points()[index]
    model = get_workload(spec.workload, **point)
    eng = ParsirEngine(model, EngineConfig(**spec.engine_kw), device=device,
                       group=None if rep_shards else group,
                       rep_shards=rep_shards,
                       rep_group=group if rep_shards else None)

    base = eng.dispatches
    st = eng.init_replicated(spec.seeds)
    st = eng.run_replicated_drained(st, spec.max_epochs)

    totals = eng.totals_replicated(st)
    in_flight = eng.in_flight_replicated(st)
    epochs = eng.epochs_replicated(st)
    reps = []
    for r, seed in enumerate(spec.seeds):
        reps.append({
            "seed": int(seed),
            "processed": totals[r]["processed"],
            "epochs": int(epochs[r]),
            "in_flight": int(in_flight[r]),
            "unclean": unclean_counters(totals[r]),
            "stats": totals[r],
        })
    return {
        "index": index,
        "label": spec.point_label(index),
        "model_kw": point,
        "seeds": [int(s) for s in spec.seeds],
        "max_epochs": spec.max_epochs,
        "dispatches": eng.dispatches - base,
        "drained": bool(int(in_flight.sum()) == 0),
        "replications": reps,
    }


def campaign_rank(rank: int, group, spec: CampaignSpec,
                  store: ResultsStore | None, indices: list[int], device,
                  rep_shards: int | None) -> list[dict] | None:
    """One rank of a campaign over devices (run by
    :func:`~repro_torch.core.dist.spawn`): the grid points ``indices`` in
    order, each put in ``store`` by rank 0 as it finishes.  Rank 0 returns
    the results."""
    import torch
    torch.set_num_threads(max(1, torch.get_num_threads()
                              // torch.distributed.get_world_size(group)))
    results = []
    for i in indices:
        res = _run_point(spec, i, device, group, rep_shards)
        if rank == 0 and store is not None:
            store.put(spec, i, res)
        results.append(res)
    return results if rank == 0 else None


def run_campaign(spec: CampaignSpec, store: ResultsStore | None = None,
                 device="cuda", log: Callable[[str], None] | None = None
                 ) -> dict[str, Any]:
    """Run (or resume) a campaign on ``device``; return the summary dict.

    With a ``store``, completed grid points are skipped (their stored result
    is reused in the summary) and fresh results are written as they finish.
    With ``spec.devices > 1`` the points run on that many spawned ranks,
    ``rep_shards`` when ``len(spec.seeds) % spec.devices == 0`` and
    object-sharded otherwise (module docstring).

    The summary reports, per the clean-run contract, every replication with
    nonzero overflow/causality counters (``unclean``) and every grid point
    whose drain hit ``max_epochs`` with events still in flight
    (``undrained``) — callers decide which of those are fatal.
    """
    import torch

    from ..core.device import resolve_device

    device = resolve_device(device)
    say = log or (lambda msg: None)
    if store is not None:
        store.write_manifest(spec)

    points = spec.points()
    done_before = {i for i in range(len(points))
                   if store is not None and store.has(spec, i)}
    todo = [i for i in range(len(points)) if i not in done_before]
    fresh: dict[int, dict] = {}
    D = spec.devices
    if D > 1 and todo:
        from ..core.dist import spawn
        # the reference's choice: the replication axis over the devices
        # when they divide the seed count, else the objects.
        rep_shards = D if len(spec.seeds) % D == 0 else None
        nccl = device.type == "cuda" and torch.cuda.device_count() >= D
        got = spawn(campaign_rank, D, spec, store, todo,
                    "cuda" if nccl else str(device), rep_shards,
                    backend="nccl" if nccl else "gloo",
                    timeout=600.0, join_timeout=24 * 3600.0)[0]
        fresh = dict(zip(todo, got))
        say(f"[campaign] {len(todo)} points on {D} ranks, "
            + (f"rep_shards={D}" if rep_shards else
               f"object-sharded (R={len(spec.seeds)} x D={D})"))

    results, ran, resumed = [], 0, 0
    for i in range(len(points)):
        if i in done_before:
            results.append(store.get(spec, i))
            resumed += 1
            say(f"[campaign] point {i} ({spec.point_label(i)}): resumed")
            continue
        res = fresh.get(i)
        if res is None:
            res = _run_point(spec, i, device)
            if store is not None:
                store.put(spec, i, res)
        results.append(res)
        ran += 1
        done = sum(r["processed"] for r in res["replications"])
        say(f"[campaign] point {i} ({res['label']}): {done} events over "
            f"{len(spec.seeds)} seeds, {res['dispatches']} dispatches, "
            f"drained={res['drained']}")

    unclean = [(res["index"], rep["seed"], rep["unclean"])
               for res in results for rep in res["replications"]
               if rep["unclean"]]
    undrained = [res["index"] for res in results if not res["drained"]]
    return {
        "digest": spec.digest(),
        "n_points": len(points),
        "ran": ran,
        "resumed": resumed,
        "missing": store.missing(spec) if store is not None else [],
        "unclean": unclean,
        "undrained": undrained,
        "results": results,
    }
