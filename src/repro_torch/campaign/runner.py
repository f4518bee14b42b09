"""The campaign loop: one stacked drain per grid point.

Port of ``repro/campaign/runner.py`` on one device.  Grid-point parameters
change the model (shapes, branches), so points run one after another; a
point's seeds are data, and all of them advance together through
:meth:`ParsirEngine.run_replicated_drained`: two dispatches per point (the
ingest and the drain), whatever the seed count.

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


def _run_point(spec: CampaignSpec, index: int, device) -> dict[str, Any]:
    from ..core.engine import EngineConfig, ParsirEngine
    from ..testing.clean import unclean_counters
    from ..workloads.registry import get_workload

    point = spec.points()[index]
    model = get_workload(spec.workload, **point)
    eng = ParsirEngine(model, EngineConfig(**spec.engine_kw), device=device)

    base = eng.dispatches
    st = eng.init_replicated(spec.seeds)
    st = eng.run_replicated_drained(st, spec.max_epochs)

    totals = eng.totals_replicated(st)
    in_flight = eng.in_flight_replicated(st)
    epochs = st.epoch[:, 0].tolist()
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


def run_campaign(spec: CampaignSpec, store: ResultsStore | None = None,
                 device="cuda", log: Callable[[str], None] | None = None
                 ) -> dict[str, Any]:
    """Run (or resume) a campaign on ``device``; return the summary dict.

    With a ``store``, completed grid points are skipped (their stored result
    is reused in the summary) and fresh results are written as they finish.
    ``spec.devices > 1`` (the reference's replication-sharded layout) is
    refused: it comes with the rep-sharded slice.

    The summary reports, per the clean-run contract, every replication with
    nonzero overflow/causality counters (``unclean``) and every grid point
    whose drain hit ``max_epochs`` with events still in flight
    (``undrained``) — callers decide which of those are fatal.
    """
    from ..core.device import resolve_device

    if spec.devices != 1:
        raise NotImplementedError(
            f"a campaign over devices={spec.devices} is not in the PyTorch "
            f"port yet; it comes with the rep-sharded slice of the "
            f"multi-device port (rep_shards: the replications laid over "
            f"devices); run it with devices=1")
    device = resolve_device(device)
    say = log or (lambda msg: None)
    if store is not None:
        store.write_manifest(spec)

    points = spec.points()
    results, ran, resumed = [], 0, 0
    for i in range(len(points)):
        if store is not None and store.has(spec, i):
            results.append(store.get(spec, i))
            resumed += 1
            say(f"[campaign] point {i} ({spec.point_label(i)}): resumed")
            continue
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
