"""Simulation CLI — the simulator's end-to-end entry point.

  PYTHONPATH=src python -m repro_torch.launch.simulate --workload phold \\
      --epochs 100 [--devices 2] [--scheduler ltf] [--route a2a] \\
      [--batch-impl packed] [--placement adaptive --rebalance-every 4] \\
      [--steal] [--drain] [--model-kw n_channels=2] [--verify] \\
      [--device cpu]

The port's face of ``repro.launch.simulate``, with its flags, defaults and
help, and ``--device`` (the card unless asked for ``cpu``; without a card
the CLI refuses to run).  Every choice-typed flag is driven by the live
registries, the workload zoo (:mod:`repro_torch.workloads.registry`) and
the pipeline stage names (:mod:`repro_torch.core.pipeline.names`);
:mod:`repro_torch.testing.docs_check` cross-checks that this stays true.

``--devices D`` spawns D ranks (:func:`repro_torch.core.dist.spawn`): NCCL
with a card each where there are D cards, otherwise D gloo ranks sharing
the card, and gloo on the CPU.  Every rank runs the same calls; rank 0's
lines are printed.

Before the timed call the engine prepares it on a throwaway copy of the
state (:meth:`ParsirEngine.prepare`, the reference's warm-up ``run(st,
0)``): on the card at one device it captures every CUDA graph the call
replays, so the timed window holds no capture.  The lines are the
reference's (events, epochs, seconds, ev/s and dispatches; the drain line;
``stats: {...}``; the verify line), then one more: the timed window's
host syncs, graph captures and replays, kernel launches and ms/epoch.
At ``--batch-impl model`` on PHOLD the run goes through the ``event_apply``
kernel: replays of CUDA graphs at one device on the card, eagerly across
ranks.

Exit contract: any nonzero overflow/causality counter is a failed run
(events were dropped or misordered; the lines above it are meaningless)
and the process exits nonzero through the clean-run checker
(:mod:`repro_torch.testing.clean`).  ``--drain`` runs
``run_until_drained`` bounded by ``--epochs`` instead of a fixed horizon;
``--verify`` holds the final object state to the port's sequential oracle
(:func:`repro_torch.core.ref_engine.run_sequential`) bit for bit, under
``--dist dyadic``.
"""
from __future__ import annotations

import argparse
import ast
import time


def parse_kv(pairs: list[str]) -> dict:
    """``k=v`` strings → kwargs dict (python-literal values, else str)."""
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


def build_parser() -> argparse.ArgumentParser:
    from ..core.pipeline.names import (BATCH_IMPLS, PLACEMENTS, ROUTES,
                                       SELECTABLE_SCHEDULERS)
    from ..workloads.registry import all_workloads

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="phold", choices=all_workloads())
    ap.add_argument("--objects", type=int, default=512)
    ap.add_argument("--lookahead", type=float, default=0.5)
    ap.add_argument("--epoch-len", type=float, default=None)
    ap.add_argument("--dist", default="exponential",
                    choices=["exponential", "uniform24", "dyadic"])
    ap.add_argument("--model-kw", action="append", default=[],
                    metavar="K=V", help="extra workload make() override "
                    "(repeatable), e.g. --model-kw max_calls=8")
    ap.add_argument("--epochs", type=int, default=100,
                    help="epochs to run (--drain: the drain bound)")
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--scheduler", default="batch",
                    choices=list(SELECTABLE_SCHEDULERS))
    ap.add_argument("--route", default="allgather", choices=list(ROUTES))
    ap.add_argument("--batch-impl", default="rounds",
                    choices=list(BATCH_IMPLS))
    ap.add_argument("--pack-tile", type=int, default=64)
    ap.add_argument("--steal", action="store_true")
    ap.add_argument("--placement", default="equal", choices=list(PLACEMENTS))
    ap.add_argument("--rebalance-every", type=int, default=0,
                    help="adaptive placement: epochs between rebalances")
    ap.add_argument("--migrate-cap", type=int, default=16)
    ap.add_argument("--placement-slack", type=float, default=2.0)
    ap.add_argument("--opt-window", type=int, default=0,
                    help="speculate up to W epochs past the safe horizon "
                         "(Time Warp lite; 0 = strictly conservative). "
                         "Same bits either way — stragglers roll the window "
                         "back; see stats rollbacks/speculated/spec_commits")
    ap.add_argument("--opt-stage-cap", type=int, default=0,
                    help="staging buffer for speculative emissions "
                         "(0 = route_cap); overflow aborts the window, "
                         "never drops")
    ap.add_argument("--opt-commit", default="device",
                    choices=["device", "global"],
                    help="speculation commit locality: 'device' rolls back "
                         "only devices that received a straggler, 'global' "
                         "is the atomic all-or-nothing vote (same bits)")
    ap.add_argument("--opt-adaptive", action="store_true",
                    help="retune the live speculation window between drain "
                         "dispatches from the observed rollback rate "
                         "(--opt-window becomes the cap; --drain only)")
    ap.add_argument("--n-buckets", type=int, default=16)
    ap.add_argument("--bucket-cap", type=int, default=256)
    ap.add_argument("--route-cap", type=int, default=8192)
    ap.add_argument("--fallback-cap", type=int, default=8192)
    ap.add_argument("--drain", action="store_true",
                    help="run to empty as ONE fused on-device dispatch "
                         "(run_until_drained, bounded by --epochs)")
    ap.add_argument("--verify", action="store_true",
                    help="cross-check final object state against the "
                         "sequential oracle (dyadic dist only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    return ap


def simulate_rank(rank: int, group, opts: dict, device) -> dict:
    """One rank of the simulation (run by :func:`~..core.dist.spawn`, or
    as rank 0 with no group): build, prepare, run and time, check.
    Returns ``{"lines": [...], "error": None or the exit message}``; every
    rank makes the same collectives, rank 0 alone runs the oracle."""
    import numpy as np
    import torch

    from ..core.engine import EngineConfig, ParsirEngine
    from ..kernels.ops import KERNELS
    from ..testing.clean import assert_clean
    from ..workloads.registry import get_workload

    args = argparse.Namespace(**opts)
    if group is not None:
        # the ranks share the host's cores.
        torch.set_num_threads(max(1, torch.get_num_threads() // args.devices))
    model = get_workload(args.workload, n_objects=args.objects,
                         lookahead=args.lookahead, dist=args.dist,
                         **parse_kv(args.model_kw))
    cfg = EngineConfig(
        lookahead=args.lookahead, epoch_len=args.epoch_len,
        n_buckets=args.n_buckets, bucket_cap=args.bucket_cap,
        route_cap=args.route_cap, fallback_cap=args.fallback_cap,
        scheduler=args.scheduler, route=args.route,
        batch_impl=args.batch_impl, pack_tile=args.pack_tile,
        steal=args.steal, steal_cap=4, claim_cap=8,
        placement=args.placement, rebalance_every=args.rebalance_every,
        migrate_cap=args.migrate_cap, placement_slack=args.placement_slack,
        opt_window=args.opt_window, opt_stage_cap=args.opt_stage_cap,
        opt_commit=args.opt_commit, opt_adaptive=args.opt_adaptive)
    eng = ParsirEngine(model, cfg, device=device, group=group)
    cuda = eng.device.type == "cuda"
    lines: list[str] = []

    st = eng.init()
    # capture (or warm) what the timed call runs, on a copy of the state.
    eng.prepare(st, args.epochs, drain=args.drain)
    base = eng.totals(st)["processed"]
    start = int(st.epoch[0])
    graphs = eng.graphs
    before = (eng.syncs, graphs.captures if graphs else 0,
              graphs.replays if graphs else 0,
              [k.launches for k in KERNELS])
    if cuda:
        torch.cuda.synchronize(eng.device)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
    t0 = time.perf_counter()
    st = (eng.run_until_drained(st, args.epochs) if args.drain
          else eng.run(st, args.epochs))
    if cuda:
        marks[1].record()
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    syncs = eng.syncs - before[0]
    captures = (graphs.captures if graphs else 0) - before[1]
    replays = (graphs.replays if graphs else 0) - before[2]
    launches = {k.__name__: k.launches - n
                for k, n in zip(KERNELS, before[3]) if k.launches != n}

    tot = eng.totals(st)
    epochs_run = int(st.epoch[0])
    done = tot["processed"] - base
    lines.append(f"[simulate] {args.workload} D={args.devices}: {done} "
                 f"events over {epochs_run} epochs in {dt:.2f}s "
                 f"({done / max(dt, 1e-9):,.0f} ev/s) — {eng.dispatches} "
                 f"host dispatches")
    if args.drain:
        left = eng.in_flight(st)
        lines.append(f"[simulate] drain: "
                     f"{'complete' if left == 0 else 'BOUND HIT'} at epoch "
                     f"{epochs_run} (in-flight {left})")
    lines.append(f"[simulate] stats: {tot}")
    try:
        assert_clean(tot, context="simulate")
    except AssertionError as e:
        return {"lines": lines, "error": f"[simulate] {e}"}

    if args.verify:
        gobj = eng.global_object_state(st)       # collective: every rank
        if rank == 0:
            from ..core.ref_engine import run_sequential
            ref = run_sequential(model, epochs_run, cfg.epoch_len)
            if tot["processed"] != ref.total_processed:
                return {"lines": lines, "error": (
                    f"[simulate] processed {tot['processed']} != the "
                    f"oracle's {ref.total_processed}")}
            for key, leaf in gobj.items():
                ref_leaf = np.stack([s[key] for s in ref.obj_state])
                if not np.array_equal(leaf, ref_leaf):
                    return {"lines": lines, "error": (
                        f"[simulate] object state {key!r} diverges from "
                        f"the oracle")}
        lines.append("[simulate] verified bit-exact vs sequential oracle ✓")
    n = epochs_run - start
    per = ", ".join(f"{k} {v} ({v / max(n, 1):.2f} per epoch)"
                    for k, v in launches.items()) or "none"
    events = (f" ({marks[0].elapsed_time(marks[1]) / max(n, 1):.4f} by "
              f"CUDA events)" if cuda else "")
    lines.append(f"[simulate] timed window on {eng.device}: {n} epochs, "
                 f"{dt * 1e3 / max(n, 1):.4f} ms/epoch{events}; host syncs "
                 f"{syncs}, "
                 f"graph captures {captures}, replays {replays}; kernel "
                 f"launches: {per}")
    return {"lines": lines, "error": None}


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.verify and args.dist != "dyadic":
        raise SystemExit("--verify needs --dist dyadic (bit-exact mode)")

    import torch

    from ..core.device import resolve_device
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[simulate] {e}") from None
    if args.devices > 1:
        from ..core.dist import spawn
        nccl = dev.type == "cuda" and \
            torch.cuda.device_count() >= args.devices
        out = spawn(simulate_rank, args.devices, vars(args),
                    "cuda" if nccl else str(dev),
                    backend="nccl" if nccl else "gloo", timeout=600.0,
                    join_timeout=24 * 3600.0)[0]
    else:
        out = simulate_rank(0, None, vars(args), dev)
    for line in out["lines"]:
        print(line)
    if out["error"]:
        raise SystemExit(out["error"])


if __name__ == "__main__":
    main()
