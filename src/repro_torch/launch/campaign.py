"""Campaign CLI — a whole parameter sweep, one stacked drain per point.

  PYTHONPATH=src python -m repro_torch.launch.campaign --workload wireless \\
      --seeds 8 --grid max_calls=4,8 --model-kw n_cells=64 \\
      --epochs 256 [--scheduler ltf] [--batch-impl model] \\
      [--store campaign-results] [--require-drained] [--device cpu]

The port's face of ``repro.launch.campaign``, with the same flags and
``--device`` (``cuda`` unless asked for ``cpu``).  Builds a
:class:`repro_torch.campaign.CampaignSpec` (seeds × the cartesian
``--grid`` product over ``--model-kw`` baselines), runs every grid point's
replications stacked through the engine's replicated drain — two
dispatches per point whatever the seed count — and writes one JSON per
point into the digest-keyed results store, the same store the reference
writes for the same flags.  Re-running the same command resumes: completed
points are skipped.

Every choice-typed flag is driven by the live registries (the workload zoo
and the pipeline stage names).  Flags for stages the port does not have
yet (``--devices`` > 1, ``--steal``, ``--route a2a``, a placement other than
``equal``) are accepted and refused by name when the campaign starts, as
are ``--scheduler ltf`` and ``--batch-impl packed`` with more than one
seed.

Exit contract: nonzero if any replication's overflow/causality counters are
dirty (the clean-run contract), if any grid point is missing from the store
at the end, or — under ``--require-drained`` — if any point hit the
``--epochs`` bound with events still in flight.
"""
from __future__ import annotations

import argparse
import ast
import time


def parse_kv(pairs: list[str]) -> dict:
    """``k=v`` strings → kwargs dict (python-literal values, else str); the
    port's copy of ``repro.launch.simulate.parse_kv``."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--model-kw expects k=v, got {pair!r}")
        k, v = pair.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (SyntaxError, ValueError):
            out[k] = v
    return out


def parse_grid(pairs: list[str]) -> dict[str, list]:
    """``k=v1,v2,...`` strings → grid dict (python-literal values)."""
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise SystemExit(f"--grid expects k=v1,v2,..., got {pair!r}")
        k, vs = pair.split("=", 1)
        vals = []
        for v in vs.split(","):
            try:
                vals.append(ast.literal_eval(v))
            except (SyntaxError, ValueError):
                vals.append(v)
        if k in out:
            raise SystemExit(f"--grid axis {k!r} given twice")
        out[k] = vals
    return out


def main(argv=None):
    from ..core.pipeline.names import (BATCH_IMPLS, PLACEMENTS, ROUTES,
                                       SELECTABLE_SCHEDULERS)
    from ..workloads.registry import all_workloads

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="wireless",
                    choices=all_workloads())
    ap.add_argument("--seeds", type=int, default=8,
                    help="replication count; seeds are seed-base..+N-1, all "
                         "stacked into ONE replicated drain per point")
    ap.add_argument("--seed-base", type=int, default=0)
    ap.add_argument("--grid", action="append", default=[], metavar="K=V1,V2",
                    help="model-kwarg sweep axis (repeatable; points are the "
                         "cartesian product), e.g. --grid max_calls=4,8")
    ap.add_argument("--model-kw", action="append", default=[], metavar="K=V",
                    help="baseline workload make() override (repeatable)")
    ap.add_argument("--lookahead", type=float, default=0.5)
    ap.add_argument("--epoch-len", type=float, default=None)
    ap.add_argument("--epochs", type=int, default=256,
                    help="per-point drain bound")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--scheduler", default="batch",
                    choices=list(SELECTABLE_SCHEDULERS))
    ap.add_argument("--route", default="allgather", choices=list(ROUTES))
    ap.add_argument("--batch-impl", default="rounds",
                    choices=list(BATCH_IMPLS))
    ap.add_argument("--pack-tile", type=int, default=64)
    ap.add_argument("--steal", action="store_true")
    ap.add_argument("--placement", default="equal", choices=list(PLACEMENTS))
    ap.add_argument("--rebalance-every", type=int, default=0)
    ap.add_argument("--migrate-cap", type=int, default=16)
    ap.add_argument("--placement-slack", type=float, default=2.0)
    ap.add_argument("--n-buckets", type=int, default=16)
    ap.add_argument("--bucket-cap", type=int, default=256)
    ap.add_argument("--route-cap", type=int, default=8192)
    ap.add_argument("--fallback-cap", type=int, default=8192)
    ap.add_argument("--store", default="campaign-results",
                    help="results-store root (one digest-keyed run dir per "
                         "spec; re-running resumes)")
    ap.add_argument("--require-drained", action="store_true",
                    help="fail if any grid point hits the --epochs bound "
                         "with events still in flight")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ..campaign import CampaignSpec, ResultsStore, run_campaign

    spec = CampaignSpec(
        workload=args.workload,
        seeds=tuple(range(args.seed_base, args.seed_base + args.seeds)),
        base_model_kw=dict(lookahead=args.lookahead,
                           **parse_kv(args.model_kw)),
        grid=parse_grid(args.grid),
        engine_kw=dict(
            lookahead=args.lookahead, epoch_len=args.epoch_len,
            n_buckets=args.n_buckets, bucket_cap=args.bucket_cap,
            route_cap=args.route_cap, fallback_cap=args.fallback_cap,
            scheduler=args.scheduler, route=args.route,
            batch_impl=args.batch_impl, pack_tile=args.pack_tile,
            steal=args.steal, steal_cap=4, claim_cap=8,
            placement=args.placement, rebalance_every=args.rebalance_every,
            migrate_cap=args.migrate_cap,
            placement_slack=args.placement_slack),
        devices=args.devices,
        max_epochs=args.epochs,
    )
    store = ResultsStore(args.store)
    print(f"[campaign] {args.workload}: {len(spec.points())} grid points × "
          f"{len(spec.seeds)} seeds on {args.device} → "
          f"{store.run_dir(spec)}")

    t0 = time.perf_counter()
    summary = run_campaign(spec, store=store, device=args.device, log=print)
    dt = time.perf_counter() - t0

    done = sum(rep["processed"] for res in summary["results"]
               for rep in res["replications"])
    print(f"[campaign] {summary['ran']} points ran, {summary['resumed']} "
          f"resumed; {done} events total in {dt:.2f}s "
          f"({done / max(dt, 1e-9):,.0f} ev/s aggregate)")

    failed = False
    if summary["unclean"]:
        for index, seed, bad in summary["unclean"]:
            print(f"[campaign] UNCLEAN point {index} seed {seed}: {bad}")
        failed = True
    if summary["missing"]:
        print(f"[campaign] MISSING store entries for points "
              f"{summary['missing']}")
        failed = True
    if summary["undrained"]:
        print(f"[campaign] points {summary['undrained']} hit the "
              f"{args.epochs}-epoch bound with events in flight"
              + (" — failing (--require-drained)" if args.require_drained
                 else ""))
        failed = failed or args.require_drained
    if failed:
        raise SystemExit(1)
    print(f"[campaign] complete ✓ ({store.run_dir(spec)})")


if __name__ == "__main__":
    main()
