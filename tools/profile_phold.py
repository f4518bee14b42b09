#!/usr/bin/env python3
"""Where a full-width epoch of the PyTorch port's simulator spends its time
on a GPU.

Runs one of the port's two full-width PHOLD configurations
(``repro_torch.workloads.phold.main_path``: default PHOLD, 1024 objects x
4000 nodes x 6 lanes, dyadic draw, through ``batch_impl="model"`` — the
configuration ``chip_smoke.py`` drives; or ``hotspot_main_path``, the same
width under phold-hotspot's skew) or a workload of the zoo at the
reference's bench scale (``repro_torch.workloads.bench_path``: 512
objects, dyadic draw), either as the engine's ``run`` (on the card: replays
of CUDA graphs of the step where the step reads nothing on the host, a
loop of steps otherwise) or as a loop of eager ``step``s, warms it up,
times a window of epochs untraced, then traces the same number of epochs
with ``torch.profiler`` and prints, per epoch: host wall time, host reads
of device values, device busy time (sum of the device-side ops: kernels,
memcpy, memset) and its share of the untraced wall time, device ops
launched, and the device ops and operators with the most device time.
``--impl`` replaces the configuration's scheduler (``model`` for the PHOLD
configurations, ``rounds`` for the zoo).  ``--replications R`` runs R
stacked replications (seeds 0..R-1) through ``run_replicated_drained``
instead (on the card: replays of CUDA graphs of the stacked step under
``model``, eager chunks under the host-read schedulers); its events are
summed over the replications.  ``--opt-window W`` speculates (``run`` and
the replicated drain run the speculative step, W epochs past the safe one
a window; on the card under ``model`` replays of its CUDA graphs), and
``--inject N`` rolls every N-th window back (``inject_straggler_every``).
Run from the repository root on a machine with a CUDA card::

    python3 tools/profile_phold.py [--config main|hotspot|<zoo id>]
        [--impl rounds|packed|ltf] [--mode graphed|eager]
        [--replications R] [--opt-window W [--inject N]] [--epochs 16]
        [--out DIR]

``--out`` (default ``artifacts/profile_phold``) receives
``profile_phold_<config>[_<impl>]_<mode>[_r<R>][_w<W>[_inj<N>]].json``
and the Chrome trace of the same name with ``_trace`` before ``.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


#: the engine-config overrides of each ``--impl``.
IMPLS = {"rounds": dict(batch_impl="rounds"),
         "packed": dict(batch_impl="packed"),
         "ltf": dict(scheduler="ltf", batch_impl="rounds")}


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None) -> int:
    from repro_torch.workloads.registry import all_workloads
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="main",
                    choices=("main", "hotspot", *all_workloads()))
    ap.add_argument("--impl", choices=tuple(IMPLS), default=None)
    ap.add_argument("--mode", choices=("graphed", "eager"), default="graphed")
    ap.add_argument("--replications", type=int, default=None,
                    help="stacked replications through "
                         "run_replicated_drained (needs --mode graphed)")
    ap.add_argument("--opt-window", type=int, default=0,
                    help="speculate W epochs past the safe one (needs "
                         "--mode graphed)")
    ap.add_argument("--inject", type=int, default=0,
                    help="roll every N-th speculative window back")
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--out", default=str(ROOT / "artifacts" / "profile_phold"))
    args = ap.parse_args(argv)
    if args.replications is not None and (args.replications < 1
                                          or args.mode != "graphed"):
        ap.error("--replications takes R >= 1 and the engine's own loop "
                 "(--mode graphed)")
    if (args.opt_window or args.inject) and (args.opt_window < 1
                                             or args.inject < 0
                                             or args.mode != "graphed"):
        ap.error("--opt-window takes W >= 1 and the engine's own loop "
                 "(--mode graphed; step() stays conservative), --inject "
                 "N >= 0 and --opt-window")

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_phold: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.testing.clean import assert_clean
    from repro_torch.workloads.phold import hotspot_main_path, main_path
    from repro_torch.workloads.registry import bench_path

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if args.config in ("main", "hotspot"):
        model, cfg = (main_path if args.config == "main"
                      else hotspot_main_path)()
        if args.impl:
            cfg = dataclasses.replace(cfg, **IMPLS[args.impl])
    else:
        model, cfg = bench_path(args.config, **IMPLS[args.impl or "rounds"])
    if args.opt_window:
        cfg = dataclasses.replace(cfg, opt_window=args.opt_window,
                                  inject_straggler_every=args.inject)
    eng = ParsirEngine(model, cfg, device="cuda")

    R = args.replications

    def run(st, n):
        if R is not None:
            return eng.run_replicated_drained(st, n)
        if args.mode == "graphed":
            return eng.run(st, n)
        for _ in range(n):
            st = eng.step(st)
        return st

    def processed(st):
        if R is None:
            return eng.totals(st)["processed"]
        return sum(t["processed"] for t in eng.totals_replicated(st))

    st = run(eng.init() if R is None else eng.init_replicated(range(R)),
             args.warmup)
    if args.mode == "graphed":
        st = run(st, args.epochs)       # every graph of the window captured
    torch.cuda.synchronize()

    # the same window untraced, for the wall time the profiler does not slow.
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    st = run(st, args.epochs)
    e1.record()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / args.epochs
    span_us = e0.elapsed_time(e1) * 1e3 / args.epochs
    p0, syncs = processed(st), eng.syncs

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = run(st, args.epochs)
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6 / args.epochs
    syncs = (eng.syncs - syncs) / args.epochs
    for tot in ([eng.totals(st)] if R is None
                else eng.totals_replicated(st)):
        assert_clean(tot, context="profile_phold")
    events = processed(st) - p0

    n = args.epochs
    graphs = eng.graphs if R is None else eng.rep_graphs
    kernels, ops = [], []
    for evt in prof.key_averages():
        dev_us = _self_device_us(evt)
        if dev_us <= 0:
            continue
        row = {"name": evt.key, "calls_per_epoch": evt.count / n,
               "device_us_per_epoch": dev_us / n}
        # device-side rows (kernels, memcpy, memset) hold the busy time;
        # CPU-op rows repeat it, attributed to the operator that launched it.
        (ops if evt.device_type == DeviceType.CPU else kernels).append(row)
    for rows in (kernels, ops):
        rows.sort(key=lambda r: -r["device_us_per_epoch"])
    busy_us = sum(r["device_us_per_epoch"] for r in kernels)
    launches = sum(r["calls_per_epoch"] for r in kernels)
    report = {
        "card": smi, "torch": torch.__version__, "config": args.config,
        "scheduler": cfg.scheduler, "batch_impl": cfg.batch_impl,
        "mode": args.mode, "graphed": graphs is not None, "epochs": n,
        "replications": R, "opt_window": cfg.opt_window,
        "inject_straggler_every": cfg.inject_straggler_every,
        "host_syncs_per_epoch": syncs,
        "events_per_epoch": events / n,
        "wall_us_per_epoch": wall_us,
        "cuda_event_span_us_per_epoch": span_us,
        "traced_wall_us_per_epoch": traced_us,
        "device_busy_us_per_epoch": busy_us if busy_us else None,
        "device_busy_share": busy_us / wall_us if busy_us else None,
        "device_ops_per_epoch": launches,
        "top_device_ops": kernels[:20],
        "top_operators": ops[:20],
    }
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tag = "_".join(filter(None, (args.config, args.impl, args.mode,
                                 R and f"r{R}",
                                 args.opt_window and f"w{args.opt_window}",
                                 args.inject and f"inj{args.inject}")))
    (out / f"profile_phold_{tag}.json").write_text(json.dumps(report, indent=1))
    prof.export_chrome_trace(str(out / f"profile_phold_{tag}_trace.json"))

    print(f"card: {smi}, torch {torch.__version__}; {args.config} "
          f"configuration, scheduler {cfg.scheduler}, batch_impl "
          f"{cfg.batch_impl}, {args.mode}"
          f"{' (CUDA graphs)' if graphs is not None else ''}"
          f"{f', {R} stacked replications' if R else ''}"
          f"{f', opt_window {cfg.opt_window}' if cfg.opt_window else ''}"
          f"{f', a rollback every {args.inject} windows' if args.inject else ''}")
    print(f"{n} epochs: wall {wall_us:.1f} us/epoch untraced (CUDA-event "
          f"span {span_us:.1f}), {traced_us:.1f} traced, "
          f"{report['events_per_epoch']:.0f} events/epoch, host syncs/epoch "
          f"{syncs:g}")
    if busy_us:
        print(f"device busy {busy_us:.1f} us/epoch ({100 * busy_us / wall_us:.1f}"
              f"% of the untraced wall), {launches:.1f} device ops/epoch")
    else:
        print("device time: not measured (the profiler saw no device time)")
    for title, rows in (("device ops", kernels), ("operators", ops)):
        print(f"top {title} by device time per epoch:")
        for r in rows[:15]:
            print(f"  {r['device_us_per_epoch']:9.2f} us  "
                  f"{r['calls_per_epoch']:6.1f}x  {r['name'][:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
