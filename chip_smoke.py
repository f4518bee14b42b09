#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits nonzero:

  1. device   — the card's name and power limit, torch/CUDA versions;
  2. build    — the port's CUDA source, compiled with nvcc;
  3. kernels  — each kernel against its plain PyTorch version on the card, at
                the unit-test shapes and the full default PHOLD shape, for all
                three draw distributions with hot routing on and off;
  4. golden   — the port's numpy oracle reproduces the pinned digests;
  5. main     — the ``phold`` conformance recipe under ``batch_impl`` rounds
                and model, then the main path (``workloads.phold.main_path``:
                full-width PHOLD, 1024 objects x 4000 nodes x 6 lanes)
                through the event_apply kernel: init + 32 epochs held
                against the oracle (clean counters, processed count, pending
                multiset, bit-exact state), then 256 timed epochs;
  6. timing   — ms/epoch, events/s, host syncs per epoch, each kernel's time
                per launch at the main path's shapes beside its bound;
  7. a JSON line listing every ported kernel, the nvidia-smi line, and the
     last line ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM f32 rate outside the tensor cores, flop/s.
F32_FLOPS = 67e12
MAIN_EPOCHS_CHECKED = 32
MAIN_EPOCHS_TIMED = 256


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions -----------------------------

def _event_apply_inputs(n, S, LANES, C, cnt_hi, seed, device):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    payload = torch.rand((n, S, LANES), generator=g, dtype=torch.float32)
    addresses = torch.arange(S, dtype=torch.int32).expand(n, S).contiguous()
    top = torch.full((n,), S, dtype=torch.int32)
    ts = torch.sort(torch.rand((n, C), generator=g), dim=1).values
    sd = torch.randint(0, 2**32, (n, C), generator=g, dtype=torch.int64)
    cnt = torch.randint(0, cnt_hi + 1, (n,), generator=g, dtype=torch.int32)
    return [t.to(device) for t in (payload, addresses, top, ts, sd, cnt)]


def _max_abs_err(a, b) -> float:
    import torch
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isinf(a) & torch.isinf(b) & (a.sign() == b.sign()))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def check_event_apply(device) -> float:
    """event_apply kernel vs event_apply_ref on the card; returns the
    largest absolute difference seen on any output."""
    import torch
    from repro_torch.kernels.event_apply import (event_apply_cuda,
                                                 event_apply_ref)
    names = ("payload", "addresses", "top", "dst", "ts", "seed", "pay",
             "valid")
    cases = [(n, S, 6, C, max(1, S // 32), 3, 64, C, (4, 128))
             for n, S, C in [(2, 128, 4), (4, 256, 8), (1, 512, 16),
                             (8, 160, 5)]]
    # the main path's shape: default PholdParams with bucket_cap=128.
    cases.append((1024, 4000, 6, 128, 125, 4, 1024, 128, (8, 64)))
    worst = 0.0
    for ci, (n, S, LANES, C, K, KR, n_obj, cnt_hi, hot) in enumerate(cases):
        for dist in ("dyadic", "uniform24", "exponential"):
            for hot_objects, hot_prob in ((0, 0), hot):
                inp = _event_apply_inputs(n, S, LANES, C, cnt_hi,
                                          1000 + ci, device)
                kw = dict(n_objects=n_obj, lookahead=0.5, K=K, KR=KR,
                          dist=dist, mean=1.0, hot_objects=hot_objects,
                          hot_prob=hot_prob)
                got = event_apply_cuda(*[t.clone() for t in inp], **kw)
                want = event_apply_ref(*[t.clone() for t in inp], **kw)
                torch.cuda.synchronize()
                for name, g, w in zip(names, got, want):
                    err = _max_abs_err(g, w)
                    worst = max(worst, err)
                    if dist == "exponential" and name == "ts":
                        ok = torch.allclose(g, w, rtol=1e-6, atol=0.0)
                    else:
                        ok = torch.equal(g, w)
                    if not ok:
                        raise AssertionError(
                            f"event_apply kernel != plain at n={n} S={S} "
                            f"C={C} dist={dist} hot={hot_objects}: output "
                            f"{name} max |diff| {err}")
        log("kernels", f"event_apply n={n} S={S} LANES={LANES} C={C} K={K} "
                       f"KR={KR}: kernel == plain for dyadic, uniform24, "
                       f"exponential (ts rtol 1e-6), hot routing on/off")
    return worst


# -- phase 6: timing -------------------------------------------------------------

def _time_launches(fn, inputs, reps, flush):
    """Median ms per call of ``fn(*fresh inputs)`` with L2 flushed before each.

    A spin of ~1 ms on the card after the flush keeps it busy while the host
    enqueues the events and the call, so the events bracket the device work
    and not the wrapper's Python.  The median, not the mean: a host that is
    descheduled past the spin puts its delay into one sample, not the result.
    """
    import statistics

    import torch
    times = []
    for _ in range(reps):
        args = [t.clone() for t in inputs]
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def event_apply_bound(seed_s, cnt_b, S, K, KR, LANES, C):
    """(bytes, flops) the function needs on these inputs: the union of the
    touched windows read and written once, the arena slots written, the
    live events' ts/seed and every row's cnt/top read, every emission slot
    written."""
    import torch
    from repro_torch.core.events import fold
    n = cnt_b.shape[0]
    dev = cnt_b.device
    live = torch.arange(C, device=dev)[None, :] < cnt_b[:, None]
    start = fold(seed_s, 0) % (S - K + 1)
    d = torch.zeros((n, S + 1), dtype=torch.int32, device=dev)
    d.scatter_add_(1, torch.where(live, start, S), live.to(torch.int32))
    d.scatter_add_(1, torch.where(live, start + K, S), -live.to(torch.int32))
    covered = int((torch.cumsum(d[:, :S], dim=1) > 0).sum())
    events = int(live.sum())
    nbytes = (covered * LANES * 4 * 2                  # window read + write
              + int((cnt_b > 0).sum()) * KR * 4        # arena slots
              + events * (4 + 8) + n * (4 + 4)         # ts, seed; cnt, top
              + n * C * (4 + 4 + 8 + 4 + 4))           # five emission outputs
    flops = events * K * LANES * 2
    return nbytes, flops


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core.calendar import extract_sorted
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.core.ref_engine import run_sequential
    from repro_torch.kernels import build
    from repro_torch.kernels.event_apply import (event_apply_cuda,
                                                 event_apply_ref)
    from repro_torch.testing import golden
    from repro_torch.testing.clean import assert_clean
    from repro_torch.testing.conformance import assert_vs_oracle, check_workload
    from repro_torch.workloads.phold import main_path

    dev = torch.device("cuda", 0)

    # 1. device ---------------------------------------------------------------
    smi = nvidia_smi("name,power.limit")
    log("device", smi)
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"python {sys.version.split()[0]} "
                  f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    path = build.build("event_apply")
    log("build", f"event_apply.cu built in {time.perf_counter() - t0:.2f} s: "
                 f"{path.name}")
    logf = path.with_name(path.name + ".log")
    if logf.exists():
        for line in logf.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"event_apply: {line.strip()}")

    # 3. kernels vs plain versions ----------------------------------------------
    err = check_event_apply(dev)
    log("kernels", f"event_apply max |kernel - plain| over all outputs: {err}")

    # 4. golden digests -----------------------------------------------------------
    for key, want in golden.PINNED.items():
        got = golden.compute_digest(key)
        if got != want:
            raise AssertionError(f"oracle digest {key} drifted: {got}")
        log("golden", f"{key} digest matches the pinned {want[:16]}")

    # 5. main path ------------------------------------------------------------------
    for cfg_name in ("batch-allgather", "batch-model"):
        rep = check_workload("phold", cfg_name, device=dev)
        log("main", f"phold conformance {cfg_name}: processed "
                    f"{rep['totals']['processed']}, pending {rep['pending']},"
                    f" clean, bit-exact vs oracle")

    model, cfg = main_path()
    p = model.params
    event_apply_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    eng = ParsirEngine(model, cfg, device=dev)
    t0 = time.perf_counter()
    st = eng.run(eng.init(), MAIN_EPOCHS_CHECKED)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    tot = eng.totals(st)
    assert_clean(tot, context="full-width phold")
    t0 = time.perf_counter()
    ref = run_sequential(model, MAIN_EPOCHS_CHECKED, cfg.epoch_len)
    t_ref = time.perf_counter() - t0
    assert_vs_oracle(eng, st, tot, ref, True, "[full-width phold]")
    log("main", f"full-width PHOLD O={p.n_objects} S={p.state_nodes} "
                f"LANES={p.lanes} K={p.touch} KR={p.realloc_k}: init + "
                f"{MAIN_EPOCHS_CHECKED} epochs, processed {tot['processed']}, "
                f"clean, bit-exact vs oracle (engine {t_run:.2f} s incl. "
                f"warm-up, oracle {t_ref:.1f} s)")

    syncs0, proc0 = eng.syncs, tot["processed"]
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    st = eng.run(st, MAIN_EPOCHS_TIMED)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = event_apply_cuda.launches
    tot = eng.totals(st)
    assert_clean(tot, context="full-width phold (timed)")
    if launches == 0:
        raise AssertionError("the main path never launched event_apply")
    events = tot["processed"] - proc0
    dev_ms = e0.elapsed_time(e1)

    # 6. timing -----------------------------------------------------------------
    log("timing", f"full-width PHOLD, {MAIN_EPOCHS_TIMED} epochs: "
                  f"{dev_ms / MAIN_EPOCHS_TIMED:.4f} ms/epoch (CUDA events), "
                  f"{wall * 1e3 / MAIN_EPOCHS_TIMED:.4f} ms/epoch (host "
                  f"clock), {events} events, {events / wall:.0f} events/s, "
                  f"host syncs/epoch "
                  f"{(eng.syncs - syncs0) / MAIN_EPOCHS_TIMED:g}, peak device "
                  f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    log("timing", f"event_apply launches on the main path: {launches} "
                  f"({launches / (MAIN_EPOCHS_CHECKED + MAIN_EPOCHS_TIMED):g}"
                  f" per epoch)")

    # one real epoch's inputs at the main path's shapes.
    _, ts_s, seed_s, _, cnt_b = extract_sorted(st.cal, st.epoch[0])
    obj = st.obj
    inputs = [obj["payload"], obj["addresses"], obj["top"], ts_s, seed_s,
              cnt_b]
    kw = dict(n_objects=p.n_objects, lookahead=p.lookahead, K=p.touch,
              KR=p.realloc_k, dist=p.dist, mean=p.mean_increment)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    for _ in range(3):
        event_apply_cuda(*[t.clone() for t in inputs], **kw)
    ms = _time_launches(lambda *a: event_apply_cuda(*a, **kw), inputs, 20,
                        flush)
    plain_ms = _time_launches(lambda *a: event_apply_ref(*a, **kw), inputs,
                              5, flush)
    nbytes, flops = event_apply_bound(seed_s, cnt_b, p.state_nodes, p.touch,
                                      p.realloc_k, p.lanes, cfg.bucket_cap)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    log("timing", f"event_apply at n={p.n_objects} S={p.state_nodes} "
                  f"LANES={p.lanes} C={cfg.bucket_cap} ({int(cnt_b.sum())} "
                  f"events): kernel {ms:.4f} ms/launch, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
                  f"({nbytes} B at 3.35 TB/s; {flops} flop), L2 flushed "
                  f"before each launch")

    # 7. result lines -------------------------------------------------------------
    kernels = [{
        "name": "event_apply", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_apply.cu",
        "replaces": "src/repro/kernels/event_apply.py:176",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
