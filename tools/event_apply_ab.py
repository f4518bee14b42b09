#!/usr/bin/env python3
"""Time builds of the event_apply CUDA kernel against each other on one GPU.

Each source is a CUDA file with the C entry point ``event_apply_launch`` of
``src/repro_torch/kernels/csrc/event_apply.cu`` (by default that file; an
earlier revision's copy comes from ``git show
REV:src/repro_torch/kernels/csrc/event_apply.cu``).  Every source is compiled
with the port's flags, held bit for bit against ``event_apply_ref`` and
timed through ``event_apply_cuda`` (L2 flushed before each launch, the
sources in turns A B .. B A) on two batches at the main path's shapes: one
real epoch of PHOLD's main path (after 32 epochs) and the skewed
batch of ``chip_smoke.py`` (4 objects with full buckets, the rest at 0-10
events).  Prints, per batch and source, the median ms per launch beside the
bound and the kernel's own device time by ``torch.profiler``, then the same
two times for a device copy of as many bytes as the bound counts; exits 1
if a source disagrees with the plain version.  Run from the repository root on
a machine with a CUDA card::

    python3 tools/event_apply_ab.py [--source FILE ...] [--reps 20]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build_source(src: Path) -> tuple[Path, str]:
    """Compile ``src`` with event_apply's flags into the build directory;
    return the library and the compiler's report."""
    from repro_torch.kernels import build
    flags = build.flags("event_apply")
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = build.BUILD_DIR / "ab" / f"lib{src.stem}-{key.hexdigest()[:16]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *flags, "-o", str(out), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}")
    return out, proc.stdout


def kernel_ms(fn, inputs, reps, flush, key="event_apply") -> float:
    """Mean device time of the ops named ``key`` that ``fn`` launches, by
    ``torch.profiler`` (without the launch latency that CUDA events around
    the call take in), L2 flushed before each call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = [[t.clone() for t in inputs] for _ in range(reps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args:
            flush.zero_()
            fn(*a)
        torch.cuda.synchronize()
    us = [getattr(e, "self_device_time_total",
                  getattr(e, "self_cuda_time_total", 0.0)) / e.count
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and key in e.key]
    return us[0] / 1e3 if us else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sources = args.source or [ROOT / "src" / "repro_torch" / "kernels" /
                              "csrc" / "event_apply.cu"]

    import torch
    if not torch.cuda.is_available():
        print("event_apply_ab: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.core.calendar import extract_sorted
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.kernels import event_apply as ea
    from repro_torch.workloads.phold import main_path

    print(smoke.nvidia_smi("name,power.limit"), flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        built = list(ex.map(build_source, sources))
    for src, (lib, report) in zip(sources, built):
        for fn, facts in smoke.ptxas_facts(report):
            print(f"[build] {src}: {fn}: {facts}", flush=True)
    launch = [ea.bind(ctypes.CDLL(str(lib))).event_apply_launch
              for lib, _ in built]

    dev = torch.device("cuda", 0)
    model, cfg = main_path()
    p = model.params
    eng = ParsirEngine(model, cfg, device=dev)
    st = eng.run(eng.init(), 32)
    _, ts_s, seed_s, _, cnt_b = extract_sorted(st.cal, st.epoch[0])
    kw = dict(n_objects=p.n_objects, lookahead=p.lookahead, K=p.touch,
              KR=p.realloc_k, dist=p.dist, mean=p.mean_increment)
    batches = {
        "main path": [st.obj["payload"], st.obj["addresses"], st.obj["top"],
                      ts_s, seed_s, cnt_b],
        "skewed": smoke._event_apply_inputs(
            p.n_objects, p.state_nodes, p.lanes, cfg.bucket_cap,
            smoke.SKEWED_CNT_HI, 7, dev, smoke.SKEWED_HEAVY),
    }
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    names = ("payload", "addresses", "top", "dst", "ts", "seed", "pay",
             "valid")
    wrong = set()
    own = ea._launcher
    for batch, inputs in batches.items():
        want = ea.event_apply_ref(*[t.clone() for t in inputs], **kw)
        times = [[] for _ in sources]
        for i, fn in enumerate(launch):
            ea._launcher = lambda fn=fn: fn
            got = ea.event_apply_cuda(*[t.clone() for t in inputs], **kw)
            differ = [name for name, g, w in zip(names, got, want)
                      if not torch.equal(g, w)]
            if differ:
                wrong.add(sources[i])
                print(f"[ab] {batch}: {sources[i]}: {', '.join(differ)} "
                      f"differ from event_apply_ref", flush=True)
        for r in range(args.reps):
            order = range(len(launch)) if r % 2 == 0 else \
                reversed(range(len(launch)))
            for i in order:
                ea._launcher = lambda fn=launch[i]: fn
                times[i].append(smoke._time_launches(
                    lambda *a: ea.event_apply_cuda(*a, **kw), inputs, 1,
                    flush))
        S, LANES = inputs[0].shape[1:]
        nbytes, flops = smoke.event_apply_bound(
            inputs[4], inputs[5], S, p.touch, p.realloc_k, LANES,
            inputs[3].shape[1])
        bound_ms = max(nbytes / smoke.HBM_BYTES_PER_S,
                       flops / smoke.F32_FLOPS) * 1e3
        for src, fn, t in zip(sources, launch, times):
            ea._launcher = lambda fn=fn: fn
            med = statistics.median(t)
            kern = kernel_ms(lambda *a: ea.event_apply_cuda(*a, **kw),
                             inputs, args.reps, flush)
            print(f"[ab] {batch} ({int(inputs[5].sum())} events): {src}: "
                  f"{med:.4f} ms/launch (min {min(t):.4f}, max "
                  f"{max(t):.4f}), kernel {kern:.4f} ms by the profiler, "
                  f"bound {bound_ms:.5f} ms, {bound_ms / med:.1%} of it "
                  f"({bound_ms / kern:.1%} of the kernel's own time)"
                  f"{' (WRONG)' if src in wrong else ''}", flush=True)
        # the floor of plain data movement: one device copy of as many bytes
        # as the bound counts, read half and written half, timed the same way.
        half = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        copy = [half, torch.empty_like(half)]
        med = smoke._time_launches(lambda a, b: b.copy_(a), copy, args.reps,
                                   flush)
        kern = kernel_ms(lambda a, b: b.copy_(a), copy, args.reps, flush,
                         key="Memcpy")
        print(f"[ab] {batch}: a device copy of {nbytes // 2} B "
              f"({nbytes} B moved): {med:.4f} ms/launch, {kern:.4f} ms by "
              f"the profiler", flush=True)
    ea._launcher = own
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
