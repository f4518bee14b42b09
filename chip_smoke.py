#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits nonzero:

  1. device   — the card's name and power limit, torch/CUDA versions;
  2. build    — the port's CUDA sources, one nvcc each, all started together;
                each kernel's registers, spills and shared memory, and
                ssd_scan's CTAs per SM;
  3. kernels  — each kernel against its plain PyTorch version on the card:
                event_apply at the unit-test shapes, a heavy-overlap batch,
                an init range wider than the window, 13 lanes, the full
                default PHOLD shape and the skewed batch, for all three
                draw distributions with hot routing on and off; ssd_scan at
                the unit-test shapes, T=37 and T=160 with chunk 128, and
                the serving shape, in f32 (the
                CUDA-core kernel) and bf16 (the tensor-core kernel), each on
                contiguous x and on the [b, T, H, P] view of a wider
                activation that ``mamba_apply`` passes, with the final
                state against ``ssd_final_state``; flash_attention at the
                unit-test shapes
                (causal and not, Tq < Tk), a ragged T=1000 and the
                full-width llama3.2-3b and zamba2-1.2b shapes, f32 (the
                CUDA-core kernel) and bf16 (the tensor-core kernel), each on
                contiguous inputs and on the [B, H, T, D] views of
                [B, T, H, D] tensors that the models pass;
  4. golden   — the port's numpy oracle reproduces the pinned digests;
  5. main     — the ``phold`` conformance recipe under ``batch_impl`` rounds
                and model, then PHOLD's main path (``workloads.phold.
                main_path``: full-width PHOLD, 1024 objects x 4000 nodes x 6
                lanes) through the event_apply kernel as replayed CUDA
                graphs of the step: init + 32 epochs of the graphed ``run``
                held against the oracle (clean counters, processed count,
                pending multiset, bit-exact state), 256 timed epochs, the
                kernel's launches (1 per epoch, counted under replay);
                64 epochs of the graphed ``run`` against a loop of eager
                ``step``s, leaf by leaf; ``run_until_drained(64)`` against
                ``run(64)`` with one host read per 16 epochs; a drained
                state a fixpoint of the drain.  Then ``hotspot_main_path``
                (phold-hotspot at the same width, buckets of 1024) the same
                way: 32 graphed epochs against the oracle, graphed against
                eager, the drain; then phold-hotspot, queueing and cluster
                through ``check_workload`` under every SWEEP config each
                supports (ltf and batch-packed among them);
  6. timing   — for both full-width configurations, graphed and eager:
                ms/epoch (CUDA events and host clock), events/s, host syncs
                per epoch, graph replays and captures, event_apply launches
                per epoch, peak memory; a profile of 16 graphed epochs of
                each (device busy time and ops per epoch, event_apply
                launches seen against the counter); event_apply's time per
                launch beside its bound at the main path's shapes, on one
                real epoch's batch and on a skewed batch (4 objects with
                full buckets, the rest at 0-10 events), and on one real
                phold-hotspot epoch's batch at its C;
  zoo.        — the rest of the workload zoo, which runs the host-read
                schedulers eagerly and launches no kernel (every counter
                set to 0 before it and read after): phold under ltf and
                batch-packed and open-queueing, epidemic and wireless under
                every SWEEP config, through ``check_workload``; then
                queueing, cluster, open-queueing, epidemic and wireless at
                the reference's bench scale (``workloads.bench_path``: 512
                objects, dyadic): 32 epochs of ``rounds`` held against the
                oracle, the same 32 under ``packed`` (tile 64) equal to
                them, the padded rounds grid against the events present
                over 16 epochs, 128 timed epochs of each scheduler (ms/epoch
                by CUDA events and host clock, events/s, host syncs per
                epoch, peak memory) and a profile of 16 (device busy share
                and ops per epoch); 10 epochs of ``ltf`` on queueing and
                wireless, timed and equal to ``rounds`` at epoch 10 (bucket
                and fallback events as multisets); and three drains
                (wireless with max_calls=4, bound 256; epidemic at 128
                objects, pop=8, n_seeds=16, trans_p=96, bound 512;
                open-queueing with max_jobs=4, bound 256), each drained
                before its bound, equal to the oracle, a fixpoint of the
                drain and equal to ``run`` of its drain epoch;
  replications. — the replication axis and the campaign layer (every kernel
                counter set to 0 before it and read after): PHOLD's main
                path x R, R = 1, 8, 32 (seeds 0..R-1), through
                ``run_replicated_drained`` as replays of CUDA graphs of the
                stacked step: 64 epochs timed after one warm-up call (ms/epoch
                by CUDA events and host clock, events/s summed over R, 1
                event_apply launch and 0 host syncs per epoch, 1 per
                16-epoch chunk, replays, captures, peak memory, a 16-epoch
                profile's busy share and top ops), replications 0 and R-1
                (all eight at R = 8) equal leaf by leaf to their own graphed
                ``run_until_drained``, replication 0 at R = 8 after 32
                epochs bit-exact against the oracle; event_apply at
                R x 1024 = 32,768 rows on a real stacked epoch's batch,
                kernel == plain, timed beside its bound; the reference
                bench's campaign rung (wireless at bench scale, max_calls=4,
                32 seeds, bound 256) as a host loop of ``run_until_drained``
                calls and as one stacked drain, per-seed processed counts
                and drain epochs equal, wall time, dispatches, host syncs
                and busy share of each; ``run_campaign`` over max_calls
                {2, 4} x 8 seeds into a temporary store, then again,
                resuming both points;
  speculation. — speculation (``opt_window``; every kernel counter set to 0
                before it and read after): PHOLD's main path through the
                graphed speculative ``run`` at W = 0 (the baseline), 1, 2
                and 4: 32 epochs against the oracle, 256 epochs equal to
                the conservative graphed run (object state, calendar
                counts, clean Stats, processed), landing on epoch 256 with
                ceil(256 / (W + 1)) commits and no rollback, one flag read
                per chunk and W + 1 event_apply launches a step counted
                under replay, timed (ms/epoch by CUDA events and host
                clock, steps, host syncs, peak memory) and profiled (busy
                share, ops per step, event_apply µs per launch); at W = 2
                64 graphed epochs against the same speculative steps run
                eagerly, leaf by leaf, and the shadow's copy and the select
                of one window timed; W = 2 with a rollback every 2 windows
                (the meters equal the host predictor, the bits the
                conservative run's); PHOLD's main path x 8 through the
                speculative replicated drain at W = 2, each replication
                equal to the conservative stacked drain; and the reference
                bench's speculation rung at one device (wireless at bench
                scale, max_calls=4, rounds, eager) drained at W = 0, 1, 2,
                4 and under the adaptive controller from W = 4: the same
                bits, fewer windows than the W = 0 drain's epochs;
  multidevice. — the engine split over ranks of a process group, spawned
                from the script (``repro_torch.core.dist.spawn``; each
                rank counts its own kernel launches): D = 2 ranks sharing
                cuda:0 over gloo, every exchange staged through the host,
                PHOLD's main path under ``batch-model`` with ``allgather``
                and then ``a2a``: ``run(32)`` bit-exact against the
                oracle, ``run(256)`` equal to the one-device graphed run
                (object state, calendar counts, pending multiset,
                processed, clean Stats), 1 event_apply launch per rank per
                epoch, 224 epochs timed per rank (ms/epoch by CUDA events
                and host clock, the exchange's µs and bytes per epoch,
                collectives and host syncs per epoch, peak memory);
                phold-hotspot at the reference bench's scale (``rounds``)
                under its ``steal_on`` and ``placement_adaptive`` rungs, 16
                epochs against the oracle with loans and rebalances > 0;
                the main path under ``spec-a2a`` at W = 2 drained to 32
                epochs, equal to the conservative a2a drain.  Where the
                machine shows two or more cards, the same over NCCL with
                D = min(cards, 4), one card per rank; on one card a line
                says the NCCL part did not run;
  simulate.   — the simulator as users drive it (every kernel counter set
                to 0 before it and read after): ``python -m
                repro_torch.launch.simulate`` in subprocesses at the main
                path's model and config: (a) 32 epochs ``--verify``,
                bit-exact against the oracle; (b) 288 epochs timed, the
                CLI's ms/epoch and ev/s beside phases 5-6's in-process
                graphed run, 0 captures, 0 host syncs and 1 event_apply
                launch per epoch in the timed window; (c) ``--opt-window 2
                --drain`` passes and a run with a route buffer below one
                epoch's emissions exits nonzero; (d) ``--devices 2 --route
                a2a --verify``, 2 gloo ranks sharing the card, its stats
                those of (a); (e) PHOLD's main path x 8 seeds under
                ``rep_shards=2`` over 2 gloo ranks, each rank's 4 x 1024
                rows drained as graph replays with no collective, each
                replication equal to the one-device stacked drain of the
                same seeds, per rank launches, collectives, host syncs and
                ms/epoch; (f) the main path x 2 object-sharded over 2 ranks
                under ``allgather`` and ``a2a``, equal to the same stack;
                (g) the campaign CLI on the wireless rung at bench scale
                (2 points x 4 seeds, then x 3: rep_shards and
                object-sharded) over ``--devices 2``, every point's
                per-replication stats equal to ``--devices 1``'s; (h)
                ``packed`` and ``ltf`` stacked (wireless at bench scale,
                R = 4), each replication equal to its own drain; (i) (e)
                and (f) over NCCL where two or more cards show.  Ranks
                sharing one card are a correctness path, not a multi-GPU
                speed;
  7. serve    — zamba2 serving (``ServeSession``, whose decode replays one
                CUDA graph of the step per session): the reduced config on
                the card against the CPU; the full-width zamba2-1.2b in f32
                through the graphed session, the prefill's and every decode
                step's logits against the teacher-forced forward; then in
                its own bf16, B=4 prompts of 1024 tokens and 32 greedy
                tokens, timed (prefill ms; decode ms/token with the capture
                and replayed; the first, eager, step; the capture; tok/s;
                peak memory) beside a loop of eager ``decode_step`` calls
                from the same prompts (tokens equal, max |Δlogit| logged),
                with 38 ssd_scan launches per prefill and 0 per decode
                step, a profile of the prefill, of a replayed decode step
                and of an eager one (with the ssd_scan, cumsum and
                strided-copy launches of a prefill), and ssd_scan's own
                time per launch on the model's view beside its bound; the
                bf16 prefill with its shared attention through
                flash_attention (7 launches) and through the plain f32
                attention, in turns; then one zamba2-1.2b bf16 forward
                (B=4, T=1024) through flash_attention (7 launches) and its
                logits' spread against the plain attention and f32;
  7b. serve   — llama3.2-3b serving under ``attn_impl="pallas"`` the same
                way: the reduced config on the card against the CPU; the
                full width in f32 (prefill and decode logits against the
                teacher-forced forward); then bf16, B=4 x 1024 + 32 tokens,
                graphed against eager, timed and profiled, with 28
                flash_attention launches per prefill and 0 per decode step;
  8. lm       — llama3.2-3b's teacher-forced forward and loss
                (``DecoderLM.loss``): the reduced config on the card against
                the CPU; the full width in f32 through the kernel against the
                plain chunked attention (``attn_impl="jnp"``); then in bf16,
                B=4 x 2048 tokens, timed (ms per forward and loss, tokens/s,
                peak memory) with 28 flash launches per forward, a profile
                (with the count and time of its layout copies) and the bf16
                logits' spread; flash_attention's own time per launch at
                llama3.2-3b's and zamba2-1.2b's shapes on the views the
                models pass, beside its plain version, SDPA's and its bound,
                and at llama3.2-3b's prefill shape (T=1024);
  9. a JSON line listing every ported kernel, the nvidia-smi line, and the
     last line ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import statistics
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
#: epochs of the graphed-against-eager and drain checks; eager epochs timed.
GRAPH_EPOCHS = 64
#: phold-hotspot at full width: epochs held against the oracle, then timed.
HOTSPOT_EPOCHS_CHECKED, HOTSPOT_EPOCHS_TIMED = 32, 128
#: zamba2 serving: prompts, prompt length, generated tokens (the first from
#: the prefill), timed repeats after one warm-up.
SERVE_BATCH, SERVE_PROMPT, SERVE_TOKENS, SERVE_REPEATS = 4, 1024, 32, 3
#: ssd_scan tolerances against the plain version: the JAX package's own
#: (tests/test_kernels.py), f32 and bf16 x/y.
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
#: the f32 decode-vs-teacher-forced check at full width: the JAX package's
#: tolerance at the reduced size (tests/test_models_smoke.py).
CAUSAL_TOL = 2e-3
#: H100 SXM dense bf16 tensor-core rate, flop/s.
BF16_FLOPS = 989e12
#: flash_attention tolerances against the plain version: the JAX package's
#: own (tests/test_kernels.py), f32 and bf16.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: llama3.2-3b forward and loss: batch, tokens per row, timed repeats after
#: one warm-up.
LM_BATCH, LM_T, LM_REPEATS = 4, 2048, 3
#: the full-width f32 kernel-vs-plain-attention check: logits within atol =
#: rtol = CAUSAL_TOL, the loss within LOSS_TOL.
LOSS_TOL = 1e-3


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_facts(text: str):
    """(kernel, "N registers, spills ..., stack ...") for each entry function
    in an ``nvcc -Xptxas -v`` log, names demangled where ``c++filt`` is
    installed."""
    import re
    import shutil
    facts, fn, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spill = (f"stack {m.group(1)} B, spill stores {m.group(2)} B, "
                     f"spill loads {m.group(3)} B")
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and fn:
            facts.append([fn, f"{m.group(1)} registers, {spill}"
                              f"{m.group(2).rstrip()}"])
            fn, spill = None, ""
    cxxfilt = shutil.which("c++filt")
    if facts and cxxfilt:
        names = subprocess.run([cxxfilt], input="\n".join(f for f, _ in facts),
                               capture_output=True, text=True, timeout=60)
        for row, name in zip(facts, names.stdout.splitlines()):
            row[0] = name.replace("(anonymous namespace)::", "") \
                .split("(")[0].removeprefix("void ")
    return facts


# -- phase 3: kernels against their plain versions -----------------------------

def _event_apply_inputs(n, S, LANES, C, cnt_hi, seed, device, heavy=0):
    """Random event_apply inputs: cnt uniform in [0, cnt_hi], except the
    first ``heavy`` objects, whose buckets are full (cnt = C)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    payload = torch.rand((n, S, LANES), generator=g, dtype=torch.float32)
    addresses = torch.arange(S, dtype=torch.int32).expand(n, S).contiguous()
    top = torch.full((n,), S, dtype=torch.int32)
    ts = torch.sort(torch.rand((n, C), generator=g), dim=1).values
    sd = torch.randint(0, 2**32, (n, C), generator=g, dtype=torch.int64)
    cnt = torch.randint(0, cnt_hi + 1, (n,), generator=g, dtype=torch.int32)
    cnt[:heavy] = C
    return [t.to(device) for t in (payload, addresses, top, ts, sd, cnt)]


#: event_apply's skewed batch at the main path's shapes: 4 objects (the hot
#: objects of phold-hotspot) with full buckets, the rest at 0-10 events.
SKEWED_HEAVY, SKEWED_CNT_HI = 4, 10


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
    cases = [(n, S, 6, C, max(1, S // 32), 3, 64, C, 0, (4, 128))
             for n, S, C in [(2, 128, 4), (4, 256, 8), (1, 512, 16),
                             (8, 160, 5)]]
    # windows of S/4 with every bucket full (several CTAs per object), an
    # init range wider than the window that the S - KR clamp moves ahead of
    # it, and more lanes than a kernel thread holds at once.
    cases += [(4, 256, 6, 96, 64, 3, 64, 96, 4, (4, 128)),
              (4, 64, 6, 16, 4, 40, 64, 16, 0, (4, 128)),
              (3, 96, 13, 12, 8, 3, 64, 12, 0, (4, 128))]
    # the main path's shape: default PholdParams with bucket_cap=128, then
    # the skewed batch.
    cases += [(1024, 4000, 6, 128, 125, 4, 1024, 128, 0, (8, 64)),
              (1024, 4000, 6, 128, 125, 4, 1024, SKEWED_CNT_HI, SKEWED_HEAVY,
               (4, 128))]
    worst = 0.0
    for ci, (n, S, LANES, C, K, KR, n_obj, cnt_hi, heavy,
             hot) in enumerate(cases):
        for dist in ("dyadic", "uniform24", "exponential"):
            for hot_objects, hot_prob in ((0, 0), hot):
                inp = _event_apply_inputs(n, S, LANES, C, cnt_hi,
                                          1000 + ci, device, heavy)
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
                       f"KR={KR} cnt 0-{cnt_hi}"
                       f"{f' ({heavy} at {C})' if heavy else ''}: kernel == "
                       f"plain for dyadic, uniform24, exponential (ts rtol "
                       f"1e-6), hot routing on/off")
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


def time_event_apply(inputs, kw, flush, plain_reps=5):
    """event_apply's kernel and plain ms per call on ``inputs`` (L2 flushed
    before each) beside the bound of the same work."""
    from repro_torch.kernels.event_apply import (event_apply_cuda,
                                                 event_apply_ref)
    for _ in range(3):
        event_apply_cuda(*[t.clone() for t in inputs], **kw)
    ms = _time_launches(lambda *a: event_apply_cuda(*a, **kw), inputs, 20,
                        flush)
    plain_ms = _time_launches(lambda *a: event_apply_ref(*a, **kw), inputs,
                              plain_reps, flush)
    _, S, LANES = inputs[0].shape
    nbytes, flops = event_apply_bound(inputs[4], inputs[5], S, kw["K"],
                                      kw["KR"], LANES, inputs[3].shape[1])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                nbytes=nbytes, flops=flops, events=int(inputs[5].sum()))


# -- PHOLD: graphed loops against eager steps, timing, profile --------------------

def _same(a, b, ctx):
    """Raise unless two engine states are equal leaf by leaf."""
    import torch
    from repro_torch.core.graphs import leaves
    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb):
        raise AssertionError(f"{ctx}: {len(la)} leaves != {len(lb)}")
    for i, (x, y) in enumerate(zip(la, lb)):
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{ctx}: state leaf {i} differs "
                                 f"({tuple(x.shape)} {x.dtype})")


def _cleared(state):
    """``state`` with an empty calendar and fallback: a drained state."""
    import torch
    from repro_torch.core.events import empty_batch
    cal = state.cal._replace(cnt=torch.zeros_like(state.cal.cnt),
                             ts=torch.full_like(state.cal.ts, float("inf")))
    fb = state.fb._replace(events=empty_batch(state.fb.cap,
                                              device=state.epoch.device))
    return state._replace(cal=cal, fb=fb)


def check_graphs(eng, st, name, n=GRAPH_EPOCHS):
    """From a copy of ``st``: ``n`` epochs of the graphed ``run`` against a
    loop of eager ``step``s, leaf by leaf; ``run_until_drained(n)`` against
    ``run(n)`` (the workload conserves events) with one flag read per
    chunk; a drained state a fixpoint of the drain, epoch unchanged.
    Returns the engine's static state holding ``st``'s values again."""
    import torch
    from repro_torch.core.engine import DRAIN_CHUNK
    from repro_torch.core.graphs import clone_state
    s0 = clone_state(st)
    graphed = clone_state(eng.run(clone_state(s0), n))
    eager = clone_state(s0)
    for _ in range(n):
        eager = eng.step(eager)
    _same(graphed, eager, f"{name}: graphed run vs eager steps")
    del eager
    syncs = eng.syncs
    drained = eng.run_until_drained(clone_state(s0), n)
    if eng.syncs - syncs != -(-n // DRAIN_CHUNK):
        raise AssertionError(f"{name}: drain of {n} epochs made "
                             f"{eng.syncs - syncs} host reads")
    _same(drained, graphed, f"{name}: run_until_drained vs run")
    if eng.in_flight(drained) == 0:
        raise AssertionError(f"{name}: the workload drained")
    del graphed
    cleared = _cleared(clone_state(s0))
    syncs = eng.syncs
    fixed = eng.run_until_drained(clone_state(cleared), n)
    _same(fixed, cleared, f"{name}: drained state under the drain")
    if eng.syncs - syncs != 1 or int(fixed.epoch[0]) != int(s0.epoch[0]):
        raise AssertionError(f"{name}: the drain of a drained state moved")
    torch.cuda.synchronize()
    log("main", f"{name}: graphed run == {n} eager steps leaf by leaf "
                f"(state, Stats, epoch); run_until_drained({n}) == run({n}) "
                f"with {-(-n // DRAIN_CHUNK)} host reads; a drained state is "
                f"a fixpoint of the drain (epoch {int(fixed.epoch[0])} "
                f"unchanged, 1 host read)")
    del cleared, fixed
    return eng.run(s0, 0)


def time_epochs(eng, st, n, graphed=True):
    """Run ``n`` epochs (``run``: replays of graphs where the engine has
    them; or a loop of eager ``step``s) and time them by CUDA events and the
    host clock."""
    import torch
    from repro_torch.kernels.event_apply import event_apply_cuda
    g = eng.graphs
    syncs, p0 = eng.syncs, eng.totals(st)["processed"]
    replays, captures = (g.replays, g.captures) if g else (0, 0)
    launches = event_apply_cuda.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    if graphed:
        st = eng.run(st, n)
    else:
        for _ in range(n):
            st = eng.step(st)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = eng.totals(st)["processed"] - p0
    return dict(state=st, dev_ms=e0.elapsed_time(e1) / n,
                wall_ms=wall * 1e3 / n, events=events,
                events_per_s=events / wall, syncs=(eng.syncs - syncs) / n,
                replays=(g.replays if g else 0) - replays,
                captures=(g.captures if g else 0) - captures,
                launches=(event_apply_cuda.launches - launches) / n,
                peak_mib=torch.cuda.max_memory_allocated() / 2**20)


def log_timing(name, mode, n, t):
    log("timing", f"{name} {mode}, {n} epochs: {t['dev_ms']:.4f} ms/epoch "
                  f"(CUDA events), {t['wall_ms']:.4f} ms/epoch (host "
                  f"clock), {t['events']} events, {t['events_per_s']:.0f} "
                  f"events/s, host syncs/epoch {t['syncs']:g}, graph "
                  f"replays {t['replays']}, captures {t['captures']}, "
                  f"event_apply launches/epoch {t['launches']:g}, peak "
                  f"device memory {t['peak_mib']:.0f} MiB")


#: profiles of one window before the profiler's event_apply count and the
#: launch counter disagreeing fails the run.
PROFILE_TRIES = 3


def profile_counted(run, st, mark):
    """torch.profiler (CPU and CUDA) over ``st = run(st)``, with the
    event_apply launches the trace saw held to the launch counter.

    A trace of a graphed speculative window once lacked one kernel record
    (the profiler saw 49 launches, the counter 50, where 96 profiles of
    that window on the card agreed): a window whose counts differ is run
    and profiled again, up to PROFILE_TRIES times in all, each try held to
    the same exact equality.  A counter that disagrees with the device's
    work disagrees with every trace, and the run fails.  ``mark(st)`` is
    read before each try.  Returns ``(prof, st, mark before the accepted
    try, launches counted, [(seen, counted) of each rejected try])``; a
    trace with no device op is accepted as it is (its time is "not
    measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.event_apply import event_apply_cuda
    misses = []
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        before, m = event_apply_cuda.launches, mark(st)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st = run(st)
            torch.cuda.synchronize()
        counted = event_apply_cuda.launches - before
        rows = _device_rows(prof)
        seen = sum(r[1] for r in rows if "event_apply" in r[2])
        if not rows or seen == counted:
            return prof, st, m, counted, misses
        misses.append((seen, counted))
    raise AssertionError(f"the profiler saw {seen} event_apply launches, "
                         f"the counter {counted}, in each of "
                         f"{PROFILE_TRIES} profiles: {misses}")


def _retried(misses) -> str:
    """The rejected tries of :func:`profile_counted`, for a log line."""
    return "".join(f"; a trace rejected (saw {a} of {b} launches), the "
                   f"window profiled again" for a, b in misses)


def profile_graphed(eng, st, name, n=16):
    """torch.profiler over ``n`` epochs of the graphed ``run``: device busy
    time and ops per epoch, and the event_apply launches it saw against the
    launch counter."""
    st = eng.run(st, n)                  # the graphs exist before the trace
    prof, st, p0, counted, misses = profile_counted(
        lambda s: eng.run(s, n), st, lambda s: eng.totals(s)["processed"])
    events = eng.totals(st)["processed"] - p0
    rows = _device_rows(prof)
    busy_us = sum(r[0] for r in rows) / n
    seen = sum(r[1] for r in rows if "event_apply" in r[2])
    if not rows:
        log("profile", f"{name} graphed: device time not measured (the "
                       f"profiler saw no device op inside the graphs)")
        return st, None
    if counted != n:
        raise AssertionError(f"{name}: {counted} event_apply launches "
                             f"counted in {n} graphed epochs")
    log("profile", f"{name} graphed, {n} epochs: device busy {busy_us:.1f} "
                   f"us/epoch in {sum(r[1] for r in rows) / n:.1f} device "
                   f"ops/epoch, {events / n:.0f} events/epoch; event_apply "
                   f"launches seen {seen} == counted {counted}"
                   f"{_retried(misses)}")
    for us, cnt, key in rows[:8]:
        log("profile", f"  {us / n:9.2f} us/epoch {cnt / n:6.1f}x  "
                       f"{key[:90]}")
    return st, busy_us


# -- the zoo at the reference's bench scale (phase zoo) ---------------------------

#: the five workloads of the zoo that run the rounds path, at bench scale.
ZOO = ("queueing", "cluster", "open-queueing", "epidemic", "wireless")
#: epochs held against the oracle, then timed, then profiled, per scheduler.
ZOO_EPOCHS_CHECKED, ZOO_EPOCHS_TIMED, ZOO_EPOCHS_PROFILED = 32, 128, 16
#: the ltf run: the length of the reference bench's ``ltf_reference_scheduler``
#: rung, on the two workloads it names.
LTF_EPOCHS, LTF_ZOO = 10, ("queueing", "wireless")
#: the packed scheduler at the bench's tile.
PACKED = dict(batch_impl="packed", pack_tile=64)
#: the three drains: workload, ``bench_path`` overrides, epoch bound (the
#: reference bench's draining rungs: wireless ``it4_drain_budget``, epidemic's
#: speculation rung at 128 objects; open-queueing with a job budget).
ZOO_DRAINS = (("wireless", dict(max_calls=4), 256),
              ("epidemic", dict(n_objects=128, pop=8, n_seeds=16,
                                trans_p=96), 512),
              ("open-queueing", dict(max_jobs=4), 256))


def _same_run(a, b, ctx, ordered=True):
    """Raise unless two engine states hold the same simulation.

    Object state, Stats, epoch, bounds and the calendar's counts are
    compared leaf by leaf.  With ``ordered`` (two schedulers that emit in
    the same order, as rounds and packed do) the calendar is compared slot
    by slot and the fallback's live slots in order; its dead slots keep
    whatever the scheduler's emission buffer left there.  Without (ltf, which
    emits in global time order) the events of every calendar bucket and of
    the fallback are compared as sorted multisets of (ts, seed, payload,
    dst)."""
    import torch
    from repro_torch.core.graphs import leaves
    for part in ("obj", "stats", "epoch", "bounds", "load"):
        for i, (x, y) in enumerate(zip(leaves(getattr(a, part)),
                                       leaves(getattr(b, part)))):
            if x.shape != y.shape or not torch.equal(x, y):
                raise AssertionError(f"{ctx}: {part} leaf {i} differs")
    if not torch.equal(a.cal.cnt, b.cal.cnt):
        raise AssertionError(f"{ctx}: calendar counts differ")

    def canon(ts, seed, others, live, dim):
        """The live events sorted by (ts, seed) along ``dim``, dead slots
        masked and last."""
        ts = torch.where(live, ts, float("inf"))
        seed = torch.where(live, seed, -1)
        others = [torch.where(live, x, 0) for x in others]
        o1 = torch.sort(seed, dim=dim, stable=True).indices
        o2 = torch.sort(torch.gather(ts, dim, o1), dim=dim,
                        stable=True).indices
        o = torch.gather(o1, dim, o2)
        return [torch.gather(x, dim, o) for x in (ts, seed, *others)]

    C = a.cal.ts.shape[-1]
    live = torch.arange(C, device=a.cal.ts.device) < a.cal.cnt[..., None]
    fa, fb = a.fb.events, b.fb.events
    if not torch.equal(fa.valid, fb.valid) and ordered:
        raise AssertionError(f"{ctx}: fallback slots differ")
    if int(fa.valid.sum()) != int(fb.valid.sum()):
        raise AssertionError(f"{ctx}: fallback sizes differ")
    if ordered:
        pairs = [(x, y) for x, y in zip(a.cal[:3], b.cal[:3])]
        pairs += [(x[fa.valid], y[fb.valid]) for x, y in zip(fa[:4], fb[:4])]
    else:
        pairs = list(zip(canon(a.cal.ts, a.cal.seed, [a.cal.payload], live, 2),
                         canon(b.cal.ts, b.cal.seed, [b.cal.payload], live,
                               2)))
        pairs += list(zip(
            canon(fa.ts, fa.seed, [fa.payload, fa.dst], fa.valid, 0),
            canon(fb.ts, fb.seed, [fb.payload, fb.dst], fb.valid, 0)))
    for i, (x, y) in enumerate(pairs):
        if not torch.equal(x, y):
            raise AssertionError(f"{ctx}: {'slot' if ordered else 'multiset'}"
                                 f" {i} of the calendar or fallback differs")


def zoo_lanes(eng, st, n=ZOO_EPOCHS_PROFILED):
    """The lanes of the padded rounds grid against the events present
    (``occupancy`` before each step), summed over ``n`` epochs stepped from
    a copy of ``st``."""
    from repro_torch.core.graphs import clone_state
    s = clone_state(st)
    padded = packed = 0
    for _ in range(n):
        occ = eng.occupancy(s)
        padded += int(occ["padded_lanes"].sum())
        packed += int(occ["packed_lanes"].sum())
        s = eng.step(s)
    return padded, packed


def profile_zoo(eng, st, n=ZOO_EPOCHS_PROFILED):
    """torch.profiler over ``n`` epochs of ``run``: device busy µs and ops
    per epoch, and the top ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = eng.run(st, n)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    if not rows:
        return st, None, None, []
    return (st, sum(r[0] for r in rows) / n, sum(r[1] for r in rows) / n,
            rows[:4])


def zoo_workload(dev, name):
    """One workload at bench scale: 32 epochs of rounds against the oracle,
    the same 32 under packed equal to them, then 128 timed and 16 profiled
    epochs of each."""
    import torch
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.core.graphs import clone_state
    from repro_torch.core.ref_engine import run_sequential
    from repro_torch.testing.clean import assert_clean
    from repro_torch.testing.conformance import assert_vs_oracle
    from repro_torch.workloads import bench_path
    n0 = ZOO_EPOCHS_CHECKED
    model, cfg = bench_path(name)
    eng = ParsirEngine(model, cfg, device=dev)
    t0 = time.perf_counter()
    st = eng.run(eng.init(), n0)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    tot = eng.totals(st)
    assert_clean(tot, context=f"bench-scale {name}")
    t0 = time.perf_counter()
    ref = run_sequential(model, n0, cfg.epoch_len)
    t_ref = time.perf_counter() - t0
    pend = assert_vs_oracle(eng, st, tot, ref, True, f"[bench-scale {name}]")
    _, pcfg = bench_path(name, **PACKED)
    peng = ParsirEngine(model, pcfg, device=dev)
    pst = peng.run(peng.init(), n0)
    _same_run(pst, st, f"bench-scale {name}: packed vs rounds")
    log("zoo", f"{name} at bench scale ({model.n_objects} objects, "
               f"{cfg.n_buckets} x {cfg.bucket_cap} calendar): init + {n0} "
               f"epochs of rounds, processed {tot['processed']}, pending "
               f"{pend.shape[0]}, clean, bit-exact vs oracle (engine "
               f"{t_run:.2f} s, oracle {t_ref:.1f} s); packed (tile "
               f"{pcfg.pack_tile}) == rounds (state, Stats, calendar, live "
               f"fallback)")
    padded, packed = zoo_lanes(eng, st)
    log("zoo", f"{name} lanes over the next {ZOO_EPOCHS_PROFILED} epochs: "
               f"the padded rounds grid {padded}, the events present "
               f"{packed} ({padded / max(packed, 1):.2f}x)")
    for impl, e, s in (("rounds", eng, st), ("packed", peng, pst)):
        t = time_epochs(e, clone_state(s), ZOO_EPOCHS_TIMED)
        s = t.pop("state")
        assert_clean(e.totals(s), context=f"bench-scale {name} {impl} (timed)")
        s, busy, ops, top = profile_zoo(e, s)
        busy_txt = ("device busy not measured (the profiler saw no device "
                    "op)" if busy is None else
                    f"device busy {busy:.1f} us/epoch in {ops:.1f} ops "
                    f"({busy / (t['wall_ms'] * 1e3):.1%} of the untraced "
                    f"host-clock epoch)")
        log("zoo", f"{name} {impl}, {ZOO_EPOCHS_TIMED} epochs: "
                   f"{t['dev_ms']:.4f} ms/epoch (CUDA events), "
                   f"{t['wall_ms']:.4f} ms/epoch (host clock), "
                   f"{t['events']} events, {t['events_per_s']:.0f} events/s, "
                   f"host syncs/epoch {t['syncs']:g}, peak device memory "
                   f"{t['peak_mib']:.0f} MiB; {busy_txt}")
        for us, cnt, key in top:
            log("zoo", f"  {us / ZOO_EPOCHS_PROFILED:9.2f} us/epoch "
                       f"{cnt / ZOO_EPOCHS_PROFILED:6.1f}x  {key[:80]}")
        del s


def zoo_ltf(dev, name):
    """LTF_EPOCHS epochs of ltf at bench scale, timed, against rounds."""
    import torch
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.testing.clean import assert_clean
    from repro_torch.workloads import bench_path
    model, cfg = bench_path(name)
    eng = ParsirEngine(model, cfg, device=dev)
    st = eng.run(eng.init(), LTF_EPOCHS)
    _, lcfg = bench_path(name, scheduler="ltf")
    leng = ParsirEngine(model, lcfg, device=dev)
    lst = leng.init()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lst = leng.run(lst, LTF_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tot = leng.totals(lst)
    assert_clean(tot, context=f"bench-scale {name} ltf")
    _same_run(lst, st, f"bench-scale {name}: ltf vs rounds", ordered=False)
    log("zoo", f"{name} ltf, {LTF_EPOCHS} epochs at bench scale: "
               f"{wall * 1e3 / LTF_EPOCHS:.2f} ms/epoch (host clock), "
               f"{tot['processed']} events, {tot['processed'] / wall:.0f} "
               f"events/s, host syncs/epoch {leng.syncs / LTF_EPOCHS:g}; == "
               f"rounds at epoch {LTF_EPOCHS} (state, Stats, calendar counts; "
               f"bucket and fallback events as multisets)")


def zoo_drain(dev, name, over, bound):
    """``run_until_drained`` of a budgeted workload: drained before the
    bound, equal to the oracle there, a fixpoint of the drain and equal to
    ``run(drain_epoch)``."""
    import torch
    from repro_torch.core.engine import DRAIN_CHUNK, ParsirEngine
    from repro_torch.core.graphs import clone_state
    from repro_torch.core.ref_engine import run_sequential
    from repro_torch.testing.clean import assert_clean
    from repro_torch.testing.conformance import assert_vs_oracle
    from repro_torch.workloads import bench_path
    model, cfg = bench_path(name, **over)
    eng = ParsirEngine(model, cfg, device=dev)
    st = eng.init()
    torch.cuda.synchronize()
    syncs = eng.syncs
    t0 = time.perf_counter()
    st = eng.run_until_drained(st, bound)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = eng.syncs - syncs
    d = int(st.epoch[0])
    tot = eng.totals(st)
    assert_clean(tot, context=f"{name} drain")
    if eng.in_flight(st) != 0 or d >= bound:
        raise AssertionError(f"{name}: not drained in {bound} epochs "
                             f"({eng.in_flight(st)} events in flight)")
    ref = run_sequential(model, d, cfg.epoch_len)
    assert_vs_oracle(eng, st, tot, ref, True, f"[{name} drain]")
    if ref.pending_records:
        raise AssertionError(f"{name}: the oracle holds events at the drain")
    again = eng.run_until_drained(clone_state(st), DRAIN_CHUNK)
    _same_run(again, st, f"{name}: the drained state under the drain")
    ran = eng.run(eng.init(), d)
    _same_run(ran, st, f"{name}: run({d}) vs the drain")
    log("zoo", f"{name} drain ({model.n_objects} objects, "
               f"{', '.join(f'{k}={v}' for k, v in over.items())}): "
               f"drained at epoch {d} of {bound}, "
               f"{tot['processed']} events, {wall:.2f} s, {syncs} host syncs "
               f"({syncs / max(d, 1):.2f} per epoch); == oracle, a fixpoint "
               f"of the drain, == run({d})")


def zoo_phase(dev):
    """Phase zoo: conformance of the new workloads under every SWEEP point,
    the five rounds-path workloads at bench scale, ltf, the drains."""
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.testing.conformance import (check_workload,
                                                 supported_configs)
    for fn in KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    for cfg_name in ("ltf", "batch-packed"):
        rep = check_workload("phold", cfg_name, device=dev)
        log("zoo", f"phold conformance {cfg_name}: processed "
                   f"{rep['totals']['processed']}, pending {rep['pending']}, "
                   f"clean, bit-exact vs oracle")
    for name in ("open-queueing", "epidemic", "wireless"):
        for cfg_name in supported_configs(name):
            rep = check_workload(name, cfg_name, device=dev)
            log("zoo", f"{name} conformance {cfg_name}: processed "
                       f"{rep['totals']['processed']}, pending "
                       f"{rep['pending']}, clean, bit-exact vs oracle")
    marks = [("conformance", time.perf_counter())]
    for name in ZOO:
        zoo_workload(dev, name)
        marks.append((name, time.perf_counter()))
    for name in LTF_ZOO:
        zoo_ltf(dev, name)
    marks.append(("ltf", time.perf_counter()))
    for name, over, bound in ZOO_DRAINS:
        zoo_drain(dev, name, over, bound)
    marks.append(("drains", time.perf_counter()))
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    if any(counts.values()):
        raise AssertionError(f"the zoo launched a kernel: {counts}")
    log("zoo", f"kernel launches on the zoo's path: {counts} (no TPU kernel "
               f"is on it)")
    spans, last = [], t0
    for what, t in marks:
        spans.append(f"{what} {t - last:.1f} s")
        last = t
    log("zoo", f"phase time {last - t0:.1f} s: {', '.join(spans)}")


# -- replications and campaigns (phase replications) ------------------------------

#: stacked replications of PHOLD's main path, the epochs of each timed
#: replicated drain (after one warm-up call of DRAIN_CHUNK epochs) and of its
#: profile; at REP_ALL every replication is held to its independent drain,
#: else the first and the last.
REP_COUNTS, REP_EPOCHS, REP_PROFILED, REP_ALL = (1, 8, 32), 64, 16, 8
#: the campaign rung, the reference bench's ``it5_campaign`` at D = 1
#: (benchmarks/pdes_perf.py:533-543, :244-330): wireless at bench scale with
#: max_calls=4, 32 seeds, a drain bound of 256 epochs; then ``run_campaign``
#: over max_calls in {2, 4} x 8 seeds.
CAMPAIGN = dict(max_calls=4)
CAMPAIGN_SEEDS, CAMPAIGN_BOUND, CAMPAIGN_GRID_SEEDS = 32, 256, 8
#: seeds of the host loop that the profiler traces.
CAMPAIGN_PROFILED_SEEDS = 2


def _busy_us(prof):
    """Device busy µs and device ops in a profile (None without device
    time), and the event_apply launches it saw."""
    rows = _device_rows(prof)
    if not rows:
        return None, None, 0
    return (sum(r[0] for r in rows), sum(r[1] for r in rows),
            sum(r[1] for r in rows if "event_apply" in r[2]))


def rep_phold(dev, R, ref):
    """PHOLD's main path x R: one warm-up call, REP_EPOCHS epochs of
    ``run_replicated_drained`` timed, replications against their
    independent graphed drains (and, at REP_ALL, replication 0 after
    MAIN_EPOCHS_CHECKED epochs against the oracle ``ref`` of seed 0), a
    profile of REP_PROFILED epochs.  Returns the timing and the engine and
    its state for the kernel check."""
    import torch
    from repro_torch.core.engine import DRAIN_CHUNK, ParsirEngine
    from repro_torch.kernels.event_apply import event_apply_cuda
    from repro_torch.testing.clean import assert_clean
    from repro_torch.testing.conformance import assert_vs_oracle
    from repro_torch.workloads.phold import main_path
    model, cfg = main_path()
    eng = ParsirEngine(model, cfg, device=dev)
    seeds = list(range(R))
    eng.run_replicated_drained(eng.init_replicated(seeds), DRAIN_CHUNK)
    g = eng.rep_graphs
    if g is None:
        raise AssertionError("the replicated drain does not run as graphs")
    st = eng.init_replicated(seeds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, syncs = event_apply_cuda.launches, eng.syncs
    replays, captures = g.replays, g.captures
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    st = eng.run_replicated_drained(st, REP_EPOCHS)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t = dict(dev_ms=e0.elapsed_time(e1) / REP_EPOCHS,
             wall_ms=wall * 1e3 / REP_EPOCHS,
             launches=(event_apply_cuda.launches - launches) / REP_EPOCHS,
             syncs=eng.syncs - syncs, replays=g.replays - replays,
             captures=g.captures - captures,
             peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    totals = eng.totals_replicated(st)
    for r, tot in enumerate(totals):
        assert_clean(tot, context=f"PHOLD x {R} rep {r}")
    t["events"] = sum(tot["processed"] for tot in totals)
    t["events_per_s"] = t["events"] / wall
    if t["launches"] != 1 or t["syncs"] != REP_EPOCHS // DRAIN_CHUNK \
            or t["captures"] != 0:
        raise AssertionError(f"PHOLD x {R}: {t['launches']} event_apply "
                             f"launches per epoch, {t['syncs']} host reads, "
                             f"{t['captures']} captures in the timed drain")
    if st.epoch[:, 0].tolist() != [REP_EPOCHS] * R:
        raise AssertionError(f"PHOLD x {R}: epochs {st.epoch[:, 0].tolist()}")
    checked = seeds if R == REP_ALL else sorted({0, R - 1})
    for r in checked:
        ind = eng.run_until_drained(eng.init(seed=r), REP_EPOCHS)
        _same(eng.replication(st, r), ind,
              f"PHOLD x {R}: replication {r} vs its independent drain")
    if R == REP_ALL:
        s32 = eng.run_replicated_drained(eng.init_replicated(seeds),
                                         MAIN_EPOCHS_CHECKED)
        tot0 = eng.totals_replicated(s32)[0]
        assert_vs_oracle(eng, eng.replication(s32, 0), tot0, ref, True,
                         f"[PHOLD x {R} rep 0]")
        st = s32             # the runner's static state: profile from it
    log("replications", f"PHOLD main path x {R}: {len(checked)} "
                        f"replications ({', '.join(map(str, checked))}) == "
                        f"their independent graphed run_until_drained("
                        f"{REP_EPOCHS}) leaf by leaf, epoch and Stats "
                        f"included"
                        + (f"; replication 0 after {MAIN_EPOCHS_CHECKED} "
                           f"epochs bit-exact vs the oracle" if R == REP_ALL
                           else ""))
    prof, st, _, _, misses = profile_counted(
        lambda s: eng.run_replicated_drained(s, REP_PROFILED), st,
        lambda s: None)
    busy, ops, _ = _busy_us(prof)
    t["retried"] = _retried(misses)
    t["busy_us"] = None if busy is None else busy / REP_PROFILED
    t["ops"] = None if ops is None else ops / REP_PROFILED
    t["rows"] = _device_rows(prof)[:6]
    return t, eng, st


def rep_event_apply(dev, eng, st, flush):
    """event_apply at R * M rows: the kernel against its plain version on
    one real stacked epoch's batch (bit-exact: dyadic), then timed."""
    import torch
    from repro_torch.core.calendar import Calendar, extract_sorted
    from repro_torch.kernels.event_apply import (event_apply_cuda,
                                                 event_apply_ref)
    p = eng.model.params
    R, M = st.epoch.shape[0], eng.placement.n_local_max
    flat = Calendar(*(x.flatten(0, 1) for x in st.cal))
    _, ts_s, seed_s, _, cnt_b = extract_sorted(
        flat, st.epoch[:, 0].repeat_interleave(M))
    obj = {k: v.flatten(0, 1) for k, v in st.obj.items()}
    inputs = [obj["payload"], obj["addresses"], obj["top"], ts_s, seed_s,
              cnt_b]
    kw = dict(n_objects=p.n_objects, lookahead=p.lookahead, K=p.touch,
              KR=p.realloc_k, dist=p.dist, mean=p.mean_increment)
    got = event_apply_cuda(*[t.clone() for t in inputs], **kw)
    want = event_apply_ref(*[t.clone() for t in inputs], **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("payload", "addresses", "top", "dst", "ts",
                           "seed", "pay", "valid"), got, want):
        err = max(err, _max_abs_err(a, b))
        if not torch.equal(a, b):
            raise AssertionError(f"event_apply at n={R * M}: kernel != "
                                 f"plain on output {name}")
    del got, want
    t = time_event_apply(inputs, kw, flush, plain_reps=2)
    t.update(max_abs_err=err, n=R * M, fullest=int(cnt_b.max()))
    return t


def rep_campaign(dev):
    """The campaign rung: 32 wireless seeds at bench scale drained as a
    host loop of ``run_until_drained`` calls and as one stacked
    ``run_replicated_drained``; per-seed processed counts and drain epochs
    equal, every replication clean and drained."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import DRAIN_CHUNK, ParsirEngine
    from repro_torch.testing.clean import assert_clean
    from repro_torch.workloads import bench_path
    model, cfg = bench_path("wireless", **CAMPAIGN)
    eng = ParsirEngine(model, cfg, device=dev)
    seeds = list(range(CAMPAIGN_SEEDS))
    eng.run_until_drained(eng.init(seed=0), DRAIN_CHUNK)          # warm-up
    eng.run_replicated_drained(eng.init_replicated(seeds), DRAIN_CHUNK)

    def host_loop(some, prof=None):
        per, epochs, dt = [], [], 0.0
        for s in some:
            st = eng.init(seed=s)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = eng.run_until_drained(st, CAMPAIGN_BOUND)
            torch.cuda.synchronize()
            dt += time.perf_counter() - t0
            tot = eng.totals(st)
            assert_clean(tot, context=f"wireless seed {s}")
            if eng.in_flight(st):
                raise AssertionError(f"wireless seed {s} did not drain")
            per.append(tot["processed"])
            epochs.append(int(st.epoch[0]))
        return per, epochs, dt

    d0, s0 = eng.dispatches, eng.syncs
    per_l, ep_l, dt_l = host_loop(seeds)
    loop = dict(dispatches=eng.dispatches - d0, syncs=eng.syncs - s0,
                wall=dt_l)
    d0, s0 = eng.dispatches, eng.syncs
    st = eng.init_replicated(seeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = eng.run_replicated_drained(st, CAMPAIGN_BOUND)
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    stacked = dict(dispatches=eng.dispatches - d0, syncs=eng.syncs - s0,
                   wall=dt_s)
    totals = eng.totals_replicated(st)
    for r, tot in enumerate(totals):
        assert_clean(tot, context=f"stacked wireless rep {r}")
    per_s = [tot["processed"] for tot in totals]
    ep_s = st.epoch[:, 0].tolist()
    if int(eng.in_flight_replicated(st).sum()) != 0:
        raise AssertionError("the stacked campaign did not drain")
    if per_s != per_l or ep_s != ep_l:
        raise AssertionError(f"host loop and stacked drain disagree: "
                             f"processed {per_l} vs {per_s}, drain epochs "
                             f"{ep_l} vs {ep_s}")
    if stacked["dispatches"] != 2:
        raise AssertionError(f"stacked campaign: {stacked['dispatches']} "
                             f"dispatches")
    del st
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st = eng.init_replicated(seeds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_replicated_drained(st, CAMPAIGN_BOUND)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    stacked["busy_us"] = _busy_us(prof)[0]
    stacked["traced"] = traced
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, traced = host_loop(seeds[:CAMPAIGN_PROFILED_SEEDS])
    loop["busy_us"] = _busy_us(prof)[0]
    loop["traced"] = traced
    events = sum(per_s)
    for name, w in (("host loop", loop), ("stacked", stacked)):
        busy = ("not measured (the profiler saw no device op)"
                if w["busy_us"] is None else
                f"{w['busy_us'] / 1e6 / w['traced']:.1%} of the traced "
                f"drain time")
        log("replications", f"wireless campaign ({model.n_objects} objects "
                            f"at bench scale, max_calls=4, "
                            f"{CAMPAIGN_SEEDS} seeds, bound "
                            f"{CAMPAIGN_BOUND}), {name}: {w['wall']:.3f} s "
                            f"of drains, {events} events, "
                            f"{events / w['wall']:.0f} events/s, "
                            f"{w['dispatches']} dispatches (init + drain), "
                            f"{w['syncs']} host syncs; device busy {busy}"
                            + (f" (traced: {CAMPAIGN_PROFILED_SEEDS} seeds)"
                               if name == "host loop" else ""))
    log("replications", f"wireless campaign: per-seed processed and drain "
                        f"epochs equal both ways, every replication clean "
                        f"and drained; drain epochs {min(ep_s)}-"
                        f"{max(ep_s)} (largest {max(ep_s)}), stacked "
                        f"{dt_l / dt_s:.2f}x the host loop's events/s")
    return loop, stacked


def rep_run_campaign(dev):
    """``run_campaign`` on the card: max_calls in {2, 4} x 8 seeds into a
    temporary store, then again, resuming both points."""
    import tempfile
    from repro_torch.campaign import CampaignSpec, ResultsStore, run_campaign
    from repro_torch.workloads.registry import (BENCH_BASE, BENCH_ENGINE,
                                                BENCH_MODEL_KW)
    spec = CampaignSpec(
        workload="wireless", seeds=tuple(range(CAMPAIGN_GRID_SEEDS)),
        base_model_kw=dict(BENCH_BASE, **BENCH_MODEL_KW["wireless"]),
        grid={"max_calls": [2, 4]},
        engine_kw=dict(lookahead=BENCH_BASE["lookahead"], **BENCH_ENGINE),
        max_epochs=CAMPAIGN_BOUND)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        store = ResultsStore(tmp)
        t0 = time.perf_counter()
        first = run_campaign(spec, store=store, device=dev)
        t1 = time.perf_counter()
        second = run_campaign(spec, store=store, device=dev)
        t2 = time.perf_counter()
    if (first["ran"], first["resumed"], second["ran"],
            second["resumed"]) != (2, 0, 0, 2):
        raise AssertionError(f"run_campaign ran {first['ran']}, resumed "
                             f"{first['resumed']}, then ran "
                             f"{second['ran']}, resumed {second['resumed']}")
    if first["unclean"] or first["undrained"] or first["missing"] \
            or any(r["dispatches"] != 2 for r in first["results"]) \
            or second["results"] != first["results"]:
        raise AssertionError(f"run_campaign: unclean {first['unclean']}, "
                             f"undrained {first['undrained']}, missing "
                             f"{first['missing']}")
    events = [sum(r["processed"] for r in res["replications"])
              for res in first["results"]]
    log("replications", f"run_campaign on {dev}: 2 points (max_calls 2, 4) "
                        f"x {CAMPAIGN_GRID_SEEDS} seeds, {events} events, "
                        f"2 dispatches a point, every point drained and "
                        f"clean, {t1 - t0:.2f} s; again: both points "
                        f"resumed from the store in {t2 - t1:.3f} s")


def replications_phase(dev, ref, flush):
    """Phase replications: PHOLD's main path x R through the replicated
    drain, event_apply at R * M rows, the wireless campaign rung both ways
    and run_campaign.  Every kernel counter is set to 0 before it and read
    after.  Returns the R * M kernel timing."""
    import torch
    from repro_torch.kernels.ops import KERNELS
    for fn in KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    for R in REP_COUNTS:
        t, eng, st = rep_phold(dev, R, ref)
        busy = ("device busy not measured (the profiler saw no device op)"
                if t["busy_us"] is None else
                f"device busy {t['busy_us']:.1f} us/epoch in "
                f"{t['ops']:.1f} ops ({t['busy_us'] / (t['wall_ms'] * 1e3):.1%}"
                f" of the host-clock epoch)")
        log("replications", f"PHOLD main path x {R}, run_replicated_drained"
                            f"({REP_EPOCHS}): {t['dev_ms']:.4f} ms/epoch "
                            f"(CUDA events), {t['wall_ms']:.4f} ms/epoch "
                            f"(host clock), {t['events']} events summed "
                            f"over {R}, {t['events_per_s']:.0f} events/s, "
                            f"event_apply launches/epoch "
                            f"{t['launches']:g}, host syncs {t['syncs']} "
                            f"(0 per epoch, 1 per chunk), graph replays "
                            f"{t['replays']}, captures {t['captures']}, "
                            f"peak device memory {t['peak_mib']:.0f} MiB; "
                            f"{busy}{t['retried']}")
        for us, cnt, key in t["rows"]:
            log("replications", f"  {us / REP_PROFILED:9.2f} us/epoch "
                                f"{cnt / REP_PROFILED:6.1f}x  {key[:80]}")
        if R == REP_COUNTS[-1]:
            ea = rep_event_apply(dev, eng, st, flush)
        del eng, st
        torch.cuda.empty_cache()
    log("replications", f"event_apply at n={ea['n']} rows (R="
                        f"{REP_COUNTS[-1]} x {ea['n'] // REP_COUNTS[-1]}; "
                        f"{ea['events']} events, "
                        f"the fullest row at {ea['fullest']}): kernel == "
                        f"plain (max |diff| {ea['max_abs_err']}), kernel "
                        f"{ea['ms']:.4f} ms/launch, plain "
                        f"{ea['plain_ms']:.2f} ms, bound "
                        f"{ea['bound_ms']:.5f} ms ({ea['nbytes']} B at "
                        f"3.35 TB/s; {ea['flops']} flop), "
                        f"{ea['bound_ms'] / ea['ms']:.1%} of the bound, L2 "
                        f"flushed before each launch")
    t1 = time.perf_counter()
    rep_campaign(dev)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    rep_run_campaign(dev)
    t3 = time.perf_counter()
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    if not counts["event_apply_cuda"]:
        raise AssertionError("the replicated drain launched no event_apply")
    log("replications", f"kernel launches in the phase: {counts} (PHOLD's "
                        f"replicated drains, their independent drains and "
                        f"warm-up steps; the wireless drains launch none)")
    log("replications", f"phase time {t3 - t0:.1f} s: PHOLD x R "
                        f"{t1 - t0:.1f} s, campaign rung {t2 - t1:.1f} s, "
                        f"run_campaign {t3 - t2:.1f} s")
    return ea


# -- speculation (phase speculation) ------------------------------------------------

#: the window widths on the main path; the epochs held against the
#: conservative run and timed, held against the oracle, run eagerly
#: against the graphs, and profiled; the injected rollback period.
SPEC_WIDTHS, SPEC_EPOCHS, SPEC_CHECKED, SPEC_EAGER = (1, 2, 4), 256, 32, 64
SPEC_PROFILED, SPEC_INJECT = 48, 2
#: replicated speculation: seeds and drain bound (PHOLD main path, W = 2).
SPEC_REP_SEEDS, SPEC_REP_EPOCHS = 8, 64
#: the drain rung: the reference bench's ``it6_speculation`` (wireless at
#: bench scale, max_calls=4) at D = 1, its widths, bound and the adaptive
#: controller's starting width.
SPEC_DRAIN_WIDTHS, SPEC_DRAIN_BOUND, SPEC_ADAPTIVE_W0 = (0, 1, 2, 4), 256, 4


def predict_meters(chunks, W, inject):
    """The host twin of the speculative engine's window walk: (commits,
    rollbacks) over ``run`` calls of ``chunks`` epochs.  A committed
    window advances ``w_eff + 1`` epochs (clamped to the call's bound), an
    injected abort 1; injection fires on every ``inject``-th window where
    ``w_eff > 0``."""
    e, cm, rb = 0, 0, 0
    for c in chunks:
        bound = e + c
        while e < bound:
            w_eff = min(W, bound - e - 1)
            if inject and (cm + rb) % inject == inject - 1 and w_eff > 0:
                rb, e = rb + 1, e + 1
            else:
                cm, e = cm + 1, e + w_eff + 1
    return cm, rb


def predict_reads(n, W, inject):
    """(steps, flag reads) of a speculative ``run(n)`` from epoch 0: the
    engine's chunks of ``min(16, ceil(left / (W + 1)))`` steps, one read
    after each, walked on the host with :func:`predict_meters`' rule."""
    e, windows, steps, reads, left = 0, 0, 0, 0, n
    while left > 0:
        for _ in range(min(16, -(-left // (W + 1)))):
            steps += 1
            if e >= n:
                continue
            w_eff = min(W, n - e - 1)
            fire = inject and windows % inject == inject - 1 and w_eff > 0
            e += 1 if fire else w_eff + 1
            windows += 1
        reads += 1
        left = n - e
    return steps, reads


def spec_time(eng, init, n):
    """``run(init, n)`` timed by CUDA events and the host clock, with the
    steps (windows), host reads, event_apply launches, replays, captures
    and peak device memory it took.  ``init`` is consumed."""
    import torch
    from repro_torch.kernels.event_apply import event_apply_cuda
    g = eng.graphs
    t0_tot = eng.totals(init)
    syncs, launches = eng.syncs, event_apply_cuda.launches
    replays, captures = g.replays, g.captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    st = eng.run(init, n)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tot = eng.totals(st)
    windows = (tot["spec_commits"] + tot["rollbacks"]
               - t0_tot["spec_commits"] - t0_tot["rollbacks"])
    return st, dict(dev_ms=e0.elapsed_time(e1) / n, wall_ms=wall * 1e3 / n,
                    events=tot["processed"] - t0_tot["processed"],
                    events_per_s=(tot["processed"] - t0_tot["processed"])
                    / wall, steps=windows or n, syncs=eng.syncs - syncs,
                    launches=event_apply_cuda.launches - launches,
                    replays=g.replays - replays,
                    captures=g.captures - captures,
                    peak_mib=torch.cuda.max_memory_allocated() / 2**20)


def spec_profile(eng, st, n):
    """torch.profiler over ``run(st, n)`` (after one untraced run of the
    same length, so that every graph it replays exists): device busy µs
    and ops per step and per epoch, event_apply's launches and µs per
    launch, the top device ops."""
    st = eng.run(st, n)
    prof, st, t0_tot, counted, misses = profile_counted(
        lambda s: eng.run(s, n), st, eng.totals)
    tot = eng.totals(st)
    steps = (tot["spec_commits"] + tot["rollbacks"] - t0_tot["spec_commits"]
             - t0_tot["rollbacks"]) or n
    rows = _device_rows(prof)
    ea = [r for r in rows if "event_apply" in r[2]]
    busy = sum(r[0] for r in rows) if rows else None
    return st, dict(
        steps=steps, busy_us=busy,
        ops=sum(r[1] for r in rows) if rows else None,
        ea_us=(sum(r[0] for r in ea) / counted) if ea and counted else None,
        ea_launches=counted, rows=rows[:6], retried=_retried(misses))


def _spec_same(a, b, ctx):
    """Raise unless object state, calendar counts, epoch and the clean
    counters and processed count of two states agree."""
    import torch
    from repro_torch.testing.clean import CLEAN_COUNTERS
    for k in a.obj:
        if not torch.equal(a.obj[k], b.obj[k]):
            raise AssertionError(f"{ctx}: object state {k} differs")
    if not torch.equal(a.cal.cnt, b.cal.cnt) \
            or not torch.equal(a.epoch, b.epoch):
        raise AssertionError(f"{ctx}: calendar counts or epoch differ")
    for k in CLEAN_COUNTERS + ("processed",):
        if not torch.equal(getattr(a.stats, k), getattr(b.stats, k)):
            raise AssertionError(f"{ctx}: Stats.{k} differs")


def spec_shadow_cost(eng, st, flush, reps=20):
    """The shadow and the select of one window at the main path's width,
    timed by CUDA events: the object state's copy and the window's
    buckets (``take_buckets``), then the per-replication select of the
    object state (in place) and of the calendar (``put_buckets`` and a
    ``torch.where`` per field)."""
    import torch
    from repro_torch.core.calendar import Calendar, put_buckets, take_buckets
    W = eng.cfg.opt_window
    M = eng.placement.n_local_max
    first = (st.epoch.reshape(-1) + 1).repeat_interleave(M)
    obj = st.obj
    keep = torch.ones((M,), dtype=torch.bool, device=st.epoch.device)

    def shadow():
        return (take_buckets(st.cal, first, W),
                {k: v.clone() for k, v in obj.items()})

    def select(sh):
        cal_sh, obj_sh = sh
        a = put_buckets(st.cal, first, cal_sh)
        cal = Calendar(*(torch.where(keep.view((-1,) + (1,) * (x.ndim - 1)),
                                     x, y) for x, y in zip(st.cal, a)))
        for k, v in obj.items():
            torch.where(keep.view((-1,) + (1,) * (v.ndim - 1)), v,
                        obj_sh[k], out=v)
        return cal

    out = {}
    sh = shadow()
    for name, fn in (("shadow", shadow), ("select", lambda: select(sh))):
        ts = []
        for _ in range(reps):
            flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        out[name] = statistics.median(ts)
    nbytes = sum(v.numel() * v.element_size() for v in obj.values())
    out["obj_bytes"] = nbytes
    out["cal_bytes"] = sum(x.numel() * x.element_size() for x in st.cal)
    return out


def spec_main(dev, ref, smi):
    """PHOLD's main path under speculation: the conservative graphed
    run(256) as the baseline, then each width W: run(32) against the
    oracle ``ref``, run(256) against the baseline (object state, counts,
    clean Stats, processed; epoch 256; ceil(256 / (W + 1)) commits, no
    rollback; one flag read per chunk, W + 1 event_apply launches a step,
    counted under replay), timed a second time, profiled; at W = 2 the
    graphed run against the same steps run eagerly, and the shadow's
    cost; then injected rollbacks at W = 2."""
    import dataclasses
    import torch
    from repro_torch.core.engine import ParsirEngine, spec_flag
    from repro_torch.core.graphs import clone_state
    from repro_torch.testing.clean import assert_clean
    from repro_torch.testing.conformance import assert_vs_oracle
    from repro_torch.workloads.phold import main_path
    model, cfg = main_path()
    eng0 = ParsirEngine(model, cfg, device=dev)
    init0 = eng0.init()
    eng0.run(clone_state(init0), SPEC_EPOCHS)               # captures
    base, t0 = spec_time(eng0, clone_state(init0), SPEC_EPOCHS)
    base = clone_state(base)
    _, p0 = spec_profile(eng0, clone_state(base), SPEC_PROFILED)
    results = {0: (t0, p0)}
    del eng0
    for W in SPEC_WIDTHS:
        eng = ParsirEngine(model, dataclasses.replace(cfg, opt_window=W),
                           device=dev)
        if eng.graphs is None:
            raise AssertionError("the speculative main path is not graphed")
        init = eng.init()
        s32 = eng.run(clone_state(init), SPEC_CHECKED)
        tot = eng.totals(s32)
        assert_clean(tot, context=f"speculative PHOLD W={W}")
        assert_vs_oracle(eng, s32, tot, ref, True, f"[spec PHOLD W={W}]")
        eng.run(clone_state(init), SPEC_EPOCHS)              # captures
        st, t = spec_time(eng, clone_state(init), SPEC_EPOCHS)
        tot = eng.totals(st)
        want = -(-SPEC_EPOCHS // (W + 1))
        _spec_same(st, base, f"speculative PHOLD W={W} run({SPEC_EPOCHS})")
        if (tot["spec_commits"], tot["rollbacks"]) != (want, 0) \
                or int(st.epoch[0]) != SPEC_EPOCHS:
            raise AssertionError(f"W={W}: {tot['spec_commits']} commits, "
                                 f"{tot['rollbacks']} rollbacks, epoch "
                                 f"{int(st.epoch[0])}")
        if (t["steps"], t["syncs"]) != predict_reads(SPEC_EPOCHS, W, 0) \
                or t["launches"] != (W + 1) * want or t["captures"]:
            raise AssertionError(f"W={W}: {t['syncs']} host reads, "
                                 f"{t['launches']} event_apply launches, "
                                 f"{t['captures']} captures in the timed "
                                 f"run of {want} steps")
        if W == 2:
            eager = clone_state(init)
            bound = eager.epoch.reshape(-1) + SPEC_EAGER
            while int(spec_flag(eager, bound, False)[0]):
                eager = eng._spec_step(eager, bound, False)
            graphed = eng.run(clone_state(init), SPEC_EAGER)
            _same(graphed, eager, f"speculative W=2: graphed run("
                                  f"{SPEC_EAGER}) vs eager steps")
            log("speculation", f"main path W=2: graphed run({SPEC_EAGER}) "
                               f"== {SPEC_EAGER} epochs of eager "
                               f"speculative steps, leaf by leaf")
            del eager, graphed
            shadow = spec_shadow_cost(eng, clone_state(st),
                                      torch.empty(64 * 2**20,
                                                  dtype=torch.uint8,
                                                  device=dev))
        _, p = spec_profile(eng, st, SPEC_PROFILED)
        results[W] = (t, p)
        log("speculation", f"main path W={W}: run({SPEC_CHECKED}) bit-exact "
                           f"vs the oracle; run({SPEC_EPOCHS}) == the "
                           f"conservative graphed run (object state, "
                           f"calendar counts, clean Stats, processed "
                           f"{tot['processed']}), epoch {SPEC_EPOCHS}, "
                           f"{want} commits, 0 rollbacks; graphs captured "
                           f"{eng.graphs.captures}")
        del eng, st, s32, init
        torch.cuda.empty_cache()

    # injected rollbacks at W = 2, full width.
    W = 2
    eng = ParsirEngine(model, dataclasses.replace(
        cfg, opt_window=W, inject_straggler_every=SPEC_INJECT), device=dev)
    init = eng.init()
    eng.run(clone_state(init), SPEC_EPOCHS)                  # captures
    st, t = spec_time(eng, clone_state(init), SPEC_EPOCHS)
    tot = eng.totals(st)
    cm, rb = predict_meters([SPEC_EPOCHS], W, SPEC_INJECT)
    _spec_same(st, base, f"injected W=2 run({SPEC_EPOCHS})")
    if (tot["spec_commits"], tot["rollbacks"]) != (cm, rb) or rb == 0:
        raise AssertionError(f"injection: {tot['spec_commits']} commits, "
                             f"{tot['rollbacks']} rollbacks, the predictor "
                             f"{cm}, {rb}")
    if t["launches"] != (W + 1) * (cm + rb) or t["captures"]:
        raise AssertionError(f"injection: {t['launches']} event_apply "
                             f"launches in {cm + rb} steps")
    _, p = spec_profile(eng, st, SPEC_PROFILED)
    results["inject"] = (t, p)
    log("speculation", f"main path W=2, a rollback every {SPEC_INJECT} "
                       f"windows: run({SPEC_EPOCHS}) == the conservative "
                       f"run (object state, counts, clean Stats), {cm} "
                       f"commits and {rb} rollbacks == the host predictor, "
                       f"event_apply launches {t['launches']} = 3 x "
                       f"{cm + rb} steps, counted under replay")
    del eng, st, init, base
    torch.cuda.empty_cache()

    for key, (t, p) in results.items():
        what = ("conservative (W=0)" if key == 0 else
                f"W=2, inject {SPEC_INJECT}" if key == "inject"
                else f"W={key}")
        busy = ("device busy not measured (the profiler saw no device op)"
                if p["busy_us"] is None else
                f"device busy {p['busy_us'] / p['steps']:.1f} us/step in "
                f"{p['ops'] / p['steps']:.1f} ops/step "
                f"({p['busy_us'] / SPEC_PROFILED:.1f} us/epoch, "
                f"{p['busy_us'] / SPEC_PROFILED / (t['wall_ms'] * 1e3):.1%}"
                f" of the timed host-clock epoch; {SPEC_PROFILED} epochs "
                f"traced)")
        ea = ("" if p["ea_us"] is None else
              f"; event_apply {p['ea_us']:.2f} us/launch in the trace, "
              f"{t['launches'] / SPEC_EPOCHS:.4f} launches/epoch")
        log("speculation", f"main path {what}, run({SPEC_EPOCHS}): "
                           f"{t['dev_ms']:.4f} ms/epoch (CUDA events), "
                           f"{t['wall_ms']:.4f} ms/epoch (host clock), "
                           f"{t['events_per_s']:.0f} events/s, {t['steps']}"
                           f" steps, {t['syncs']} host syncs, graph "
                           f"replays {t['replays']}, peak device memory "
                           f"{t['peak_mib']:.0f} MiB; {busy}{ea}"
                           f"{p['retried']} [{smi}]")
        if key in (0, 2):
            for us, cnt, name in p["rows"]:
                log("speculation", f"  {us / p['steps']:9.2f} us/step "
                                   f"{cnt / p['steps']:7.1f}x  {name[:80]}")
    log("speculation", f"shadow of one window at W=2 (object state "
                       f"{shadow['obj_bytes']} B copied, {W} of "
                       f"{cfg.n_buckets} calendar buckets taken): "
                       f"{shadow['shadow']:.4f} ms; select (object state "
                       f"in place, the calendar's {shadow['cal_bytes']} B "
                       f"by put_buckets and torch.where): "
                       f"{shadow['select']:.4f} ms, L2 flushed [{smi}]")
    return results


def spec_replicated(dev, smi):
    """PHOLD main path x SPEC_REP_SEEDS through the speculative
    replicated drain at W = 2: each replication equals the conservative
    stacked drain of the same seeds."""
    import dataclasses
    import torch
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.core.graphs import clone_state
    from repro_torch.testing.clean import assert_clean
    from repro_torch.workloads.phold import main_path
    model, cfg = main_path()
    seeds = list(range(SPEC_REP_SEEDS))
    eng0 = ParsirEngine(model, cfg, device=dev)
    base = clone_state(eng0.run_replicated_drained(
        eng0.init_replicated(seeds), SPEC_REP_EPOCHS))
    del eng0
    torch.cuda.empty_cache()
    eng = ParsirEngine(model, dataclasses.replace(cfg, opt_window=2),
                       device=dev)
    eng.run_replicated_drained(eng.init_replicated(seeds),   # captures
                               SPEC_REP_EPOCHS)
    st = eng.init_replicated(seeds)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs, captures = eng.syncs, eng.rep_graphs.captures
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    st = eng.run_replicated_drained(st, SPEC_REP_EPOCHS)
    e1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng.rep_graphs.captures != captures:
        raise AssertionError("the timed speculative replicated drain "
                             "captured graphs")
    totals = eng.totals_replicated(st)
    for r in range(SPEC_REP_SEEDS):
        assert_clean(totals[r], context=f"speculative PHOLD x 8 rep {r}")
        _spec_same(eng.replication(st, r), eng.replication(base, r),
                   f"speculative replicated drain rep {r}")
    events = sum(t["processed"] for t in totals)
    log("speculation", f"PHOLD main path x {SPEC_REP_SEEDS}, W=2, "
                       f"run_replicated_drained({SPEC_REP_EPOCHS}): every "
                       f"replication == the conservative stacked drain of "
                       f"its seed (object state, counts, epoch, clean "
                       f"Stats, processed); "
                       f"{e0.elapsed_time(e1) / SPEC_REP_EPOCHS:.4f} ms/epoch "
                       f"(CUDA events), {wall * 1e3 / SPEC_REP_EPOCHS:.4f}"
                       f" ms/epoch (host clock), {events / wall:.0f} "
                       f"events/s summed, {eng.syncs - syncs} host syncs, "
                       f"{totals[0]['spec_commits']} commits per "
                       f"replication, peak device memory "
                       f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB"
                       f" [{smi}]")


def spec_drain_rung(dev, smi):
    """The reference bench's speculation rung at D = 1: wireless at bench
    scale (max_calls=4) drained under ``rounds`` (eager) at W = 0, 1, 2,
    4, then with the adaptive controller from W0 = 4: the drained bits the
    same, fewer windows than the W = 0 drain's epochs, wall time."""
    import dataclasses
    import torch
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.testing.clean import assert_clean
    from repro_torch.workloads import bench_path
    model, cfg = bench_path("wireless", max_calls=4)
    base = None
    over = [dict(opt_window=w) for w in SPEC_DRAIN_WIDTHS] + [
        dict(opt_window=SPEC_ADAPTIVE_W0, opt_adaptive=True)]
    for kw in over:
        eng = ParsirEngine(model, dataclasses.replace(cfg, **kw), device=dev)
        st = eng.init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = eng.run_until_drained(st, SPEC_DRAIN_BOUND)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tot = eng.totals(st)
        assert_clean(tot, context=f"wireless drain {kw}")
        if eng.in_flight(st):
            raise AssertionError(f"wireless drain {kw} did not drain")
        windows = (tot["spec_commits"] + tot["rollbacks"]
                   if kw["opt_window"] else int(st.epoch[0]))
        if base is None:
            base = dict(obj={k: v.clone() for k, v in st.obj.items()},
                        processed=tot["processed"], epochs=windows)
        else:
            for k, v in base["obj"].items():
                if not torch.equal(st.obj[k], v):
                    raise AssertionError(f"wireless drain {kw}: object "
                                         f"state {k} differs from W=0")
            if tot["processed"] != base["processed"] \
                    or windows >= base["epochs"]:
                raise AssertionError(f"wireless drain {kw}: processed "
                                     f"{tot['processed']}, {windows} "
                                     f"windows against {base['epochs']} "
                                     f"epochs at W=0")
        trail = (f", widths per chunk {eng.window_trail}"
                 if kw.get("opt_adaptive") else "")
        log("speculation", f"wireless drain rung ({model.n_objects} objects"
                           f" at bench scale, max_calls=4, rounds, eager) "
                           f"{kw}: drained at epoch {int(st.epoch[0])} in "
                           f"{windows} {'windows' if kw['opt_window'] else 'epochs'}"
                           f", processed {tot['processed']}, object state "
                           f"== W=0, {wall:.3f} s, {eng.syncs} host syncs, "
                           f"{eng.dispatches - 1} dispatches{trail} [{smi}]")
        del eng, st


def speculation_phase(dev, ref):
    """Phase speculation: PHOLD's main path speculating at W = 1, 2, 4 and
    with injected rollbacks, the speculative replicated drain, and the
    wireless drain rung.  Every kernel counter is set to 0 before it and
    read after."""
    import torch
    from repro_torch.kernels.ops import KERNELS
    smi = nvidia_smi("name,power.limit")
    for fn in KERNELS:
        fn.launches = 0
    t0 = time.perf_counter()
    spec_main(dev, ref, smi)
    t1 = time.perf_counter()
    spec_replicated(dev, smi)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    spec_drain_rung(dev, smi)
    t3 = time.perf_counter()
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    if not counts["event_apply_cuda"]:
        raise AssertionError("the speculative main path launched no "
                             "event_apply")
    log("speculation", f"kernel launches in the phase: {counts}")
    log("speculation", f"phase time {t3 - t0:.1f} s: main path "
                       f"{t1 - t0:.1f} s, replicated {t2 - t1:.1f} s, drain "
                       f"rung {t3 - t2:.1f} s")


# -- multi-device (phase multidevice) -------------------------------------------------

#: the main path across ranks: epochs held against the oracle, then run on
#: (timed) to the epoch held against the one-device graphed run.
MD_CHECKED, MD_EPOCHS = MAIN_EPOCHS_CHECKED, 256
#: phold-hotspot at the reference bench's scale (``bench_path``, rounds)
#: under the bench's ``steal_on`` and ``placement_adaptive`` rungs
#: (``testing.multidevice.BENCH_HOT_RUNGS``), held to the oracle with
#: route_cap 32768: at D = 2 the bench's 8192 leaves an a2a pair buffer of
#: 4096, short of an epoch's traffic to the rank holding the hot objects.
#: At 8192 the ranks' counters (route overflow, late events ...) are held
#: to the JAX engine's on 2 devices (``BENCH_HOT_JAX``).  Epochs run.
MD_HOT_EPOCHS, MD_HOT_CAP = 16, 32768
#: speculation across ranks (main path, spec-a2a at W = 2): drain bound.
MD_SPEC_BOUND = 32
#: seconds a rank waits in one collective; the whole spawn.
MD_COLLECTIVE_TIMEOUT, MD_SPAWN_TIMEOUT = 300, 600


def md_digest(tree) -> str:
    """sha256 of a dict of arrays (``testing.multidevice.tree_digest``), so
    that the gathered engine state and the oracle's digest alike."""
    from repro_torch.testing.multidevice import tree_digest
    return tree_digest(tree)


def _md_snapshot(eng, st) -> dict:
    """What the parent compares, gathered from every rank (collective)."""
    from repro_torch.testing.conformance import engine_pending
    g = eng.global_state(st)
    return {"totals": eng.totals(st), "pending": engine_pending(eng, st),
            "obj": md_digest(eng.global_object_state(st)),
            "cnt": md_digest({"cnt": g.cal.cnt.cpu().numpy()}),
            "epoch": int(st.epoch[0])}


def _md_main(rank, group, dev, route):
    """The main path over the group under ``route``: init + MD_CHECKED
    epochs (snapshot), then on to MD_EPOCHS, timed (snapshot)."""
    import dataclasses
    import torch
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.kernels.event_apply import event_apply_cuda
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.workloads.phold import main_path
    model, cfg = main_path()
    cfg = dataclasses.replace(cfg, route=route)
    for fn in KERNELS:
        fn.launches = 0
    eng = ParsirEngine(model, cfg, device=dev, group=group)
    if eng.graphs is not None:
        raise AssertionError("a step across devices must not be graphed")
    st = eng.run(eng.init(), MD_CHECKED)
    checked = _md_snapshot(eng, st)
    launches_checked = event_apply_cuda.launches
    n = MD_EPOCHS - MD_CHECKED
    c = eng.comm
    torch.cuda.synchronize(dev)
    calls, nbytes, secs, syncs = c.calls, c.bytes, c.seconds, eng.syncs
    launches = event_apply_cuda.launches
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    st = eng.run(st, n)
    e1.record()
    torch.cuda.synchronize(dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    timing = {"ms_events": e0.elapsed_time(e1) / n, "ms_host": host_ms,
              "exchange_us": (c.seconds - secs) * 1e6 / n,
              "exchange_bytes": (c.bytes - nbytes) / n,
              "collectives": (c.calls - calls) / n,
              "syncs": (eng.syncs - syncs) / n,
              "launches": (event_apply_cuda.launches - launches) / n,
              "peak_mib": torch.cuda.max_memory_allocated(dev) / 2**20}
    final = _md_snapshot(eng, st)
    return {"checked": checked, "launches_checked": launches_checked,
            "final": final, "timing": timing,
            "launches": {fn.__name__: fn.launches for fn in KERNELS}}


def _md_hotspot(rank, group, dev, config, route_cap=None):
    """phold-hotspot at bench scale under ``BENCH_HOT_RUNGS[config]``,
    rounds, at ``route_cap`` (the bench's own where None): the snapshot
    and this rank's own counters."""
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.testing.multidevice import BENCH_HOT_JAX, BENCH_HOT_RUNGS
    from repro_torch.workloads.registry import bench_path
    over = dict(BENCH_HOT_RUNGS[config])
    if route_cap is not None:
        over["route_cap"] = route_cap
    model, cfg = bench_path("phold-hotspot", **over)
    eng = ParsirEngine(model, cfg, device=dev, group=group)
    t0 = time.perf_counter()
    st = eng.run(eng.init(), MD_HOT_EPOCHS)
    wall = time.perf_counter() - t0
    out = _md_snapshot(eng, st)
    out.update(wall=wall, syncs=eng.syncs, collectives=eng.comm.calls,
               own={k: int(getattr(st.stats, k).sum())
                    for k in BENCH_HOT_JAX[config]})
    return out


def _md_spec(rank, group, dev):
    """The main path under spec-a2a (W = 2) and conservatively under a2a,
    both drained to MD_SPEC_BOUND epochs."""
    import dataclasses
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.workloads.phold import main_path
    model, cfg = main_path()
    out = {}
    for w in (2, 0):
        eng = ParsirEngine(model, dataclasses.replace(
            cfg, route="a2a", opt_window=w), device=dev, group=group)
        t0 = time.perf_counter()
        st = eng.run_until_drained(eng.init(), MD_SPEC_BOUND)
        out[w] = dict(_md_snapshot(eng, st), wall=time.perf_counter() - t0,
                      syncs=eng.syncs)
    return out


def md_rank(rank, group, backend):
    """One rank of the multi-device phase (run by ``dist.spawn``): the main
    path under allgather and a2a, phold-hotspot under loans and adaptive
    placement, speculation across ranks.  Ranks share ``cuda:0`` over gloo,
    or own ``cuda:rank`` over NCCL."""
    import torch
    from repro_torch.testing.multidevice import BENCH_HOT_RUNGS
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    out = {"main": {r: _md_main(rank, group, dev, r)
                    for r in ("allgather", "a2a")}}
    torch.cuda.empty_cache()
    out["hot"] = {c: _md_hotspot(rank, group, dev, c, MD_HOT_CAP)
                  for c in BENCH_HOT_RUNGS}
    if torch.distributed.get_world_size(group) == 2:
        out["hot_bench_cap"] = {c: _md_hotspot(rank, group, dev, c)
                                for c in BENCH_HOT_RUNGS}
    out["spec"] = _md_spec(rank, group, dev)
    return out


def _md_same(got, want, ctx, cnt=True):
    """A rank's snapshot against a reference snapshot (or the oracle's)."""
    import numpy as np
    if got["totals"]["processed"] != want["processed"]:
        raise AssertionError(f"{ctx}: processed {got['totals']['processed']}"
                             f" != {want['processed']}")
    np.testing.assert_array_equal(got["pending"], want["pending"],
                                  err_msg=f"{ctx}: pending multiset")
    if got["obj"] != want["obj"]:
        raise AssertionError(f"{ctx}: object state differs")
    if cnt and got["cnt"] != want["cnt"]:
        raise AssertionError(f"{ctx}: calendar counts differ")


def _md_oracle(model, n, epoch_len):
    """The oracle's processed count, pending multiset and state digest."""
    from repro_torch.core.ref_engine import run_sequential
    from repro_torch.testing.conformance import stack_oracle_state
    ref = run_sequential(model, n, epoch_len)
    return {"processed": ref.total_processed,
            "pending": ref.pending_sorted(),
            "obj": md_digest(stack_oracle_state(ref.obj_state))}


def md_check(ranks, D, backend, smi, ref_main, d1, hot_refs):
    """Hold the ranks' results to the oracle and the one-device run; log."""
    from repro_torch.testing.clean import assert_clean
    r0 = ranks[0]
    where = f"D={D} ranks over {backend}"
    if backend == "gloo":
        where += " on one card, host-staged"
    for route, res in r0["main"].items():
        ctx = f"[multidevice] main path {route} {where}"
        for snap in (res["checked"], res["final"]):
            assert_clean(snap["totals"], context=ctx)
        _md_same(res["checked"], ref_main, ctx + f" run({MD_CHECKED}) vs "
                 f"the oracle", cnt=False)
        _md_same(res["final"], d1, ctx + f" run({MD_EPOCHS}) vs the "
                 f"one-device graphed run")
        per_rank = [r["main"][route]["launches_checked"] for r in ranks]
        rates = [r["main"][route]["timing"]["launches"] for r in ranks]
        if per_rank != [MD_CHECKED] * D or rates != [1.0] * D:
            raise AssertionError(f"{ctx}: event_apply launches per rank "
                                 f"{per_rank} in {MD_CHECKED} epochs, "
                                 f"{rates} per epoch (want 1 per rank per "
                                 f"epoch)")
        log("multidevice", f"main path (1024 objects x 4000 nodes x 6 "
                           f"lanes, batch-model) {route}, {where}: "
                           f"run({MD_CHECKED}) bit-exact vs the oracle "
                           f"(processed {res['checked']['totals']['processed']}"
                           f"), run({MD_EPOCHS}) == the one-device graphed "
                           f"run (object state, calendar counts, pending "
                           f"multiset, processed "
                           f"{res['final']['totals']['processed']}), clean; "
                           f"event_apply 1 launch per rank per epoch "
                           f"({per_rank} in {MD_CHECKED} epochs)")
        for rank, r in enumerate(ranks):
            t = r["main"][route]["timing"]
            log("multidevice", f"main path {route}, {where}, rank {rank}, "
                               f"{MD_EPOCHS - MD_CHECKED} epochs: "
                               f"{t['ms_events']:.4f} ms/epoch (CUDA "
                               f"events), {t['ms_host']:.4f} (host clock); "
                               f"exchange {t['exchange_us']:.1f} us and "
                               f"{t['exchange_bytes']:.0f} B per epoch in "
                               f"{t['collectives']:.2f} collectives; host "
                               f"syncs {t['syncs']:.2f} per epoch; "
                               f"event_apply {t['launches']:.2f} launches "
                               f"per epoch; peak {t['peak_mib']:.0f} MiB; "
                               f"{smi}")
    from repro_torch.testing.multidevice import BENCH_HOT_JAX
    for c in BENCH_HOT_JAX:
        res = r0["hot"][c]
        ctx = f"[multidevice] phold-hotspot bench scale {c} {where}"
        assert_clean(res["totals"], context=ctx)
        _md_same(res, hot_refs, ctx + " vs the oracle", cnt=False)
        tot = res["totals"]
        key = "stolen" if c.startswith("steal") else "rebalances"
        if tot[key] <= 0:
            raise AssertionError(f"{ctx}: {key} = {tot[key]}")
        log("multidevice", f"phold-hotspot at bench scale (512 objects, "
                           f"rounds) {c}, {where}: {MD_HOT_EPOCHS} epochs "
                           f"bit-exact vs the oracle (processed "
                           f"{tot['processed']}), stolen {tot['stolen']}, "
                           f"rebalances {tot['rebalances']}, migrated "
                           f"{tot['migrated']}; {res['wall']:.2f} s, "
                           f"{res['syncs']} host syncs, "
                           f"{res['collectives']} collectives (rank 0), "
                           f"route_cap {MD_HOT_CAP}")
        if D != 2:
            continue
        got = [r["hot_bench_cap"][c]["own"] for r in ranks]
        for k, want in BENCH_HOT_JAX[c].items():
            if [g[k] for g in got] != want:
                raise AssertionError(f"{ctx} at the bench's route_cap: "
                                     f"{k} per rank {[g[k] for g in got]}, "
                                     f"the JAX engine's {want}")
        log("multidevice", f"phold-hotspot at bench scale {c} at the "
                           f"bench's route_cap 8192, {where}: per rank "
                           + ", ".join(f"{k} {[g[k] for g in got]}"
                                       for k in BENCH_HOT_JAX[c])
                           + " == the JAX engine's on 2 devices")
    spec, cons = r0["spec"][2], r0["spec"][0]
    ctx = f"[multidevice] main path spec-a2a W=2 {where}"
    assert_clean(spec["totals"], context=ctx)
    _md_same(spec, {"processed": cons["totals"]["processed"],
                    "pending": cons["pending"], "obj": cons["obj"],
                    "cnt": cons["cnt"]}, ctx + " vs the conservative drain")
    if spec["epoch"] != cons["epoch"]:
        raise AssertionError(f"{ctx}: drained to epoch {spec['epoch']}, "
                             f"conservatively {cons['epoch']}")
    tot = spec["totals"]
    log("multidevice", f"main path spec-a2a W=2, {where}: "
                       f"run_until_drained({MD_SPEC_BOUND}) == the "
                       f"conservative a2a drain (object state, calendar "
                       f"counts, pending, processed {tot['processed']}), "
                       f"commits {tot['spec_commits']}, rollbacks "
                       f"{tot['rollbacks']}, speculated {tot['speculated']} "
                       f"(summed over ranks); {spec['wall']:.2f} s against "
                       f"{cons['wall']:.2f} s")


def multidevice_phase(dev, ref):
    """Phase multidevice: the engine split over ranks of a process group.
    (a) D = 2 ranks on cuda:0 over gloo, exchanges staged through the host;
    (b) where the machine shows two or more cards, D = min(cards, 4) ranks
    over NCCL, one card each.  The ranks' kernel counters are their own."""
    import concurrent.futures as cf
    import multiprocessing
    import torch
    from repro_torch.core.dist import spawn
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.testing.conformance import stack_oracle_state
    from repro_torch.workloads.phold import main_path
    from repro_torch.workloads.registry import bench_path
    smi = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    # the oracle of the bench-scale hotspot (one model for both rungs)
    # runs beside the ranks, in a process of its own.
    hmodel, hcfg = bench_path("phold-hotspot")
    pool = cf.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    hot_ref = pool.submit(_md_oracle, hmodel, MD_HOT_EPOCHS, hcfg.epoch_len)
    ref_main = {"processed": ref.total_processed,
                "pending": ref.pending_sorted(),
                "obj": md_digest(stack_oracle_state(ref.obj_state))}
    # the one-device graphed run the ranks are held to.
    model, cfg = main_path()
    eng = ParsirEngine(model, cfg, device=dev)
    st = eng.run(eng.init(), MD_EPOCHS)
    d1 = _md_snapshot(eng, st)
    d1 = {"processed": d1["totals"]["processed"], "pending": d1["pending"],
          "obj": d1["obj"], "cnt": d1["cnt"]}
    del eng, st
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = spawn(md_rank, 2, "gloo", backend="gloo",
                  timeout=MD_COLLECTIVE_TIMEOUT,
                  join_timeout=MD_SPAWN_TIMEOUT)
    t2 = time.perf_counter()
    hot_refs = hot_ref.result()
    pool.shutdown()
    md_check(ranks, 2, "gloo", smi, ref_main, d1, hot_refs)
    cards = torch.cuda.device_count()
    if cards >= 2:
        D = min(cards, 4)
        ranks = spawn(md_rank, D, "nccl", backend="nccl",
                      timeout=MD_COLLECTIVE_TIMEOUT,
                      join_timeout=MD_SPAWN_TIMEOUT)
        md_check(ranks, D, "nccl", smi, ref_main, d1, hot_refs)
    else:
        log("multidevice", f"NCCL part not run: the machine shows {cards} "
                           f"CUDA device (NCCL needs one card per rank); "
                           f"NCCL is unverified")
    t3 = time.perf_counter()
    log("multidevice", f"phase time {t3 - t0:.1f} s: the one-device "
                       f"reference {t1 - t0:.1f} s, gloo ranks {t2 - t1:.1f} "
                       f"s, checks and NCCL {t3 - t2:.1f} s")


# -- phase simulate: the CLI, rep_shards, R x D, campaigns over devices -------

#: the simulate CLI at the main path's model and config
#: (``workloads.phold.main_path``: 1024 objects, dyadic, event_apply,
#: 8 buckets of 128, route and fallback caps of 16,384).
SIM_MAIN = ["--workload", "phold", "--objects", "1024", "--dist", "dyadic",
            "--batch-impl", "model", "--route-cap", "16384",
            "--fallback-cap", "16384", "--n-buckets", "8",
            "--bucket-cap", "128"]
#: the CLI's timed run, and the dirty run's route_cap (below one epoch's
#: ~5,100 emissions).
SIM_TIMED, SIM_DIRTY_CAP = 288, 1024
#: PHOLD main path x SIM_REP_SEEDS under rep_shards=2 (and seeds 0, 1
#: object-sharded over 2 ranks), SIM_REP_EPOCHS epochs drained.
SIM_REP_SEEDS, SIM_REP_EPOCHS = 8, 64
#: the campaign CLI on the wireless rung at bench scale (2 points).
SIM_CAMPAIGN = ["--workload", "wireless", "--grid", "max_calls=2,4",
                "--model-kw", "n_objects=512", "--model-kw", "dist='dyadic'",
                "--model-kw", "n_channels=8", "--model-kw", "hot_cells=32",
                "--model-kw", "hot_shift=3", "--model-kw", "hot_streams=2",
                "--model-kw", "handoff_p=112", "--n-buckets", "32",
                "--fallback-cap", "16384", "--epochs", "256",
                "--require-drained"]
#: packed and ltf stacked: wireless at bench scale, R seeds, drain bounds.
SIM_ZOO_R, SIM_ZOO_BOUNDS = 4, {"packed": 32, "ltf": 3}


def _cli(module, args):
    """Start ``python -m module args`` from the checkout (a Popen)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out, err


def _sim_inproc(dev):
    """The CLI's timed calls in this process: the main path's engine, init,
    ``prepare``, SIM_TIMED epochs of ``run``; ms/epoch by the host clock and
    by CUDA events."""
    import torch
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.workloads.phold import main_path
    model, cfg = main_path()
    eng = ParsirEngine(model, cfg, device=dev)
    st = eng.init()
    eng.prepare(st, SIM_TIMED)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    e0.record()
    eng.run(st, SIM_TIMED)
    e1.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / SIM_TIMED
    out = host, e0.elapsed_time(e1) / SIM_TIMED
    del eng, st
    torch.cuda.empty_cache()
    return out


def _sim_parse(out: str) -> dict:
    """The simulate CLI's lines as numbers."""
    import ast
    import re
    got = {}
    for line in out.splitlines():
        if line.startswith("[simulate] stats: "):
            got["stats"] = ast.literal_eval(line.split(": ", 1)[1])
        m = re.search(r"(\d+) events over (\d+) epochs in ([\d.]+)s "
                      r"\(([\d,]+) ev/s\) — (\d+) host dispatches", line)
        if m:
            got.update(events=int(m[1]), epochs=int(m[2]),
                       seconds=float(m[3]),
                       ev_s=int(m[4].replace(",", "")),
                       dispatches=int(m[5]))
        m = re.search(r"timed window on (\S+): (\d+) epochs, ([\d.]+) "
                      r"ms/epoch(?: \(([\d.]+) by CUDA events\))?; host "
                      r"syncs (\d+), graph captures (\d+), replays (\d+); "
                      r"kernel launches: (.*)$", line)
        if m:
            got.update(window=int(m[2]), ms=float(m[3]),
                       ms_events=float(m[4]) if m[4] else None,
                       syncs=int(m[5]), captures=int(m[6]),
                       replays=int(m[7]))
            ea = re.search(r"event_apply_cuda (\d+)", m[8])
            got["ea_launches"] = int(ea[1]) if ea else 0
    got["verified"] = "verified bit-exact vs sequential oracle" in out
    return got


def _sim_ok(name, rc, out, err, verified=False):
    if rc != 0:
        raise AssertionError(f"[simulate] {name}: exit {rc}\n{out}\n{err}")
    got = _sim_parse(out)
    if verified and not got["verified"]:
        raise AssertionError(f"[simulate] {name}: no verified line\n{out}")
    return got


def _same_leaves(a, b, ctx):
    import numpy as np
    from repro_torch.interop import engine_state_to_numpy, numpy_leaves
    for x, y in zip(numpy_leaves(engine_state_to_numpy(a)),
                    numpy_leaves(engine_state_to_numpy(b)), strict=True):
        np.testing.assert_array_equal(x, y, err_msg=ctx)


def _store_points(root):
    """{seed count: [per point replications list]} of a campaign store."""
    out = {}
    for run in Path(root).iterdir():
        manifest = json.loads((run / "manifest.json").read_text())
        n = len(manifest["spec"]["seeds"])
        out[n] = [json.loads((run / f"point-{i}.json").read_text())
                  for i in range(manifest["n_points"])]
    return out


def sim_check_reps(ranks, ref_digests, ref_totals, ref_epochs, where, smi):
    """(e) and (f): the ranks' replications against the one-device
    stacked drain of the same seeds, and the per-rank counters."""
    layouts = [("rep_shards=2", SIM_REP_SEEDS, None)]
    layouts += [(f"R=2 x D=2 {route}", 2, route)
                for route in ("allgather", "a2a")]
    for k, (name, R, route) in enumerate(layouts):
        ctx = f"[simulate] PHOLD main path x {R} {name}, {where}"
        for rank, res in enumerate(r[k] for r in ranks):
            if res["totals"] != ref_totals[:R] or \
                    res["epochs"] != ref_epochs[:R]:
                raise AssertionError(f"{ctx}: rank {rank} totals or epochs "
                                     f"differ from the one-device stack")
            for j, r in enumerate(res["held"]):
                want = ref_digests[route is not None][res["row0"]][r]
                if res["digests"][j] != want:
                    raise AssertionError(f"{ctx}: replication {r} on rank "
                                         f"{rank} differs from the "
                                         f"one-device stack")
            t = res["timing"]
            if t["launches"] != 1.0:
                raise AssertionError(f"{ctx}: rank {rank} launched "
                                     f"event_apply {t['launches']} times "
                                     f"per epoch")
            if route is None and (not t["graphed"] or t["collectives"]
                                  or t["captures"]):
                raise AssertionError(f"{ctx}: rank {rank} graphed "
                                     f"{t['graphed']}, {t['collectives']} "
                                     f"collectives, {t['captures']} "
                                     f"captures in the drain")
            log("simulate", f"{name} PHOLD main path x {R}, {where}, rank "
                            f"{rank} (seeds {res['held']}): "
                            f"run_replicated_drained({SIM_REP_EPOCHS}) == "
                            f"the one-device stacked drain (object state, "
                            f"calendar counts per replication, totals, "
                            f"epochs); event_apply {t['launches']:.2f} "
                            f"launches per epoch over {t['rows']} rows, "
                            f"graphed {t['graphed']} ({t['replays']} "
                            f"replays, {t['captures']} captures), "
                            f"{t['collectives']} collectives and "
                            f"{t['syncs']} host syncs in "
                            f"{SIM_REP_EPOCHS} epochs; "
                            f"{t['ms_events']:.4f} ms/epoch (CUDA events), "
                            f"{t['ms_host']:.4f} (host clock); {smi}")


def simulate_phase(dev, ref, main_t):
    """Phase simulate: the simulator's CLI at the main path's width, the
    replications over ranks (rep_shards and R x D), the campaign CLI over
    devices and packed/ltf stacked.  Ranks share cuda:0 over gloo: a
    correctness path, not a multi-GPU speed."""
    import tempfile
    import torch
    from repro_torch.core.dist import spawn
    from repro_torch.core.engine import DRAIN_CHUNK, ParsirEngine
    from repro_torch.core.graphs import clone_state
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.testing import multidevice as tmd
    from repro_torch.workloads.phold import main_path
    from repro_torch.workloads.registry import bench_path
    smi = nvidia_smi("name,power.limit")
    t0 = time.perf_counter()
    for fn in KERNELS:
        fn.launches = 0
    sim = "repro_torch.launch.simulate"
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(dir=ROOT / "build")
    # (a), (c), (d) and the four campaign runs (g) as processes together.
    procs = {
        "a": _cli(sim, SIM_MAIN + ["--epochs", "32", "--verify"]),
        "c": _cli(sim, SIM_MAIN + ["--opt-window", "2", "--drain",
                                   "--epochs", "64"]),
        "dirty": _cli(sim, [str(SIM_DIRTY_CAP) if p == "16384" and
                            SIM_MAIN[i - 1] == "--route-cap" else p
                            for i, p in enumerate(SIM_MAIN)]
                      + ["--epochs", "4"]),
        "d": _cli(sim, SIM_MAIN + ["--devices", "2", "--route", "a2a",
                                   "--epochs", "32", "--verify"]),
    }
    for n in (4, 3):
        for d in (1, 2):
            procs[f"g{n}{d}"] = _cli("repro_torch.launch.campaign",
                                     SIM_CAMPAIGN + [
                                         "--seeds", str(n), "--devices",
                                         str(d), "--store",
                                         f"{tmp.name}/d{d}"])
    # meanwhile: the one-device stacked drain (e) and (f) are held to.
    model, cfg = main_path()
    eng = ParsirEngine(model, cfg, device=dev)
    st = eng.init_replicated(list(range(SIM_REP_SEEDS)))
    eng.run_replicated_drained(clone_state(st), DRAIN_CHUNK)
    st = eng.run_replicated_drained(st, SIM_REP_EPOCHS)
    M = model.n_objects // 2
    ref_digests = {False: {0: tmd.shard_digests(st)},
                   True: {0: tmd.shard_digests(st, slice(0, M)),
                          M: tmd.shard_digests(st, slice(M, 2 * M))}}
    ref_totals = eng.totals_replicated(st)
    ref_epochs = eng.epochs_replicated(st)
    del eng, st
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    got = {k: _finish(p) for k, p in procs.items()}
    t2 = time.perf_counter()

    # (a) the CLI's main path, verified.
    a = _sim_ok("(a) verify", *got["a"], verified=True)
    if a["stats"]["processed"] != ref.total_processed:
        raise AssertionError(f"[simulate] (a): processed "
                             f"{a['stats']['processed']} != the oracle's "
                             f"{ref.total_processed}")
    log("simulate", f"(a) python -m {sim} {' '.join(SIM_MAIN)} --epochs 32 "
                    f"--verify: exit 0, bit-exact vs the oracle, processed "
                    f"{a['stats']['processed']}, clean")
    # (c) the exit contract.
    c = _sim_ok("(c) --opt-window 2 --drain", *got["c"])
    rc, out, err = got["dirty"]
    if rc == 0 or "UNCLEAN" not in err:
        raise AssertionError(f"[simulate] (c) dirty run: exit {rc}\n{out}"
                             f"\n{err}")
    log("simulate", f"(c) --opt-window 2 --drain --epochs 64: exit 0, "
                    f"commits {c['stats']['spec_commits']}, rollbacks "
                    f"{c['stats']['rollbacks']}, {c['ms']:.4f} ms/epoch; "
                    f"--route-cap {SIM_DIRTY_CAP} (below one epoch's "
                    f"emissions): exit {rc}, "
                    f"{err.strip().splitlines()[-1][:120]}")
    # (d) two gloo ranks sharing the card.
    d = _sim_ok("(d) --devices 2", *got["d"], verified=True)
    if d["stats"] != a["stats"]:
        raise AssertionError(f"[simulate] (d): stats {d['stats']} != D = 1's"
                             f" {a['stats']}")
    log("simulate", f"(d) --devices 2 --route a2a --epochs 32 --verify (2 "
                    f"gloo ranks sharing the card, host-staged): exit 0, "
                    f"bit-exact vs the oracle, stats == D = 1's; "
                    f"{d['ms']:.4f} ms/epoch (rank 0, host clock), "
                    f"event_apply {d['ea_launches']} launches in "
                    f"{d['window']} epochs on rank 0")

    # (b) the timed run, alone on the card, between two in-process runs of
    # the same calls (the card's speed drifts by ~13 % between minutes).
    inproc = [_sim_inproc(dev)]
    rc, out, err = _finish(_cli(sim, SIM_MAIN + ["--epochs",
                                                 str(SIM_TIMED)]))
    inproc.append(_sim_inproc(dev))
    b = _sim_ok("(b) timed", rc, out, err)
    if b["captures"] != 0 or b["ea_launches"] != b["window"] \
            or b["window"] != SIM_TIMED or b["syncs"] != 0:
        raise AssertionError(f"[simulate] (b): {b['captures']} captures, "
                             f"{b['ea_launches']} event_apply launches, "
                             f"{b['syncs']} host syncs in {b['window']} "
                             f"epochs\n{out}")
    near = statistics.mean(h for h, _ in inproc)
    gap = b["ms"] / near - 1
    log("simulate", f"(b) {' '.join(SIM_MAIN)} --epochs {SIM_TIMED}: "
                    f"{b['ms']:.4f} ms/epoch (the CLI's host clock; "
                    f"{b['ms_events']:.4f} by CUDA events), "
                    f"{b['ev_s']} ev/s, {b['events']} events; timed window: "
                    f"0 captures, {b['replays']} replays, 0 host syncs, "
                    f"event_apply {b['ea_launches']} launches (1 per epoch); "
                    f"the same calls in process just before and after: "
                    + ", ".join(f"{h:.4f} ({d:.4f})" for h, d in inproc)
                    + f" ms/epoch host clock (CUDA events): the CLI "
                    f"{gap:+.1%}{' (more than 10 %)' if abs(gap) > 0.1 else ''}"
                    f"; phases 5-6's graphed run {main_t['wall_ms']:.4f} "
                    f"({main_t['dev_ms']:.4f}) minutes earlier; {smi}")

    # (e), (f): rep_shards=2 and R x D over 2 gloo ranks, one spawn.
    seeds = list(range(SIM_REP_SEEDS))
    tasks = [("main_path_replicated_rank", ("cuda:0", seeds, SIM_REP_EPOCHS,
                                            2)),
             ("main_path_replicated_rank", ("cuda:0", [0, 1],
                                            SIM_REP_EPOCHS, None,
                                            "allgather")),
             ("main_path_replicated_rank", ("cuda:0", [0, 1],
                                            SIM_REP_EPOCHS, None, "a2a"))]
    t3 = time.perf_counter()
    ranks = spawn(tmd.tasks_rank, 2, tasks, backend="gloo",
                  timeout=MD_COLLECTIVE_TIMEOUT,
                  join_timeout=MD_SPAWN_TIMEOUT)
    t4 = time.perf_counter()
    sim_check_reps(ranks, ref_digests, ref_totals, ref_epochs,
                   "2 gloo ranks sharing cuda:0", smi)

    # (g) the campaign CLI over devices against --devices 1.
    for n in (4, 3):
        for dd in (1, 2):
            rc, out, err = got[f"g{n}{dd}"]
            if rc != 0:
                raise AssertionError(f"[simulate] (g) campaign --seeds {n} "
                                     f"--devices {dd}: exit {rc}\n{out}\n"
                                     f"{err}")
    one, two = _store_points(f"{tmp.name}/d1"), _store_points(
        f"{tmp.name}/d2")
    for n in (4, 3):
        if [p["replications"] for p in one[n]] != \
                [p["replications"] for p in two[n]]:
            raise AssertionError(f"[simulate] (g) --seeds {n}: the "
                                 f"--devices 2 store differs from "
                                 f"--devices 1's")
        events = [sum(r["processed"] for r in p["replications"])
                  for p in two[n]]
        log("simulate", f"(g) campaign CLI, wireless at bench scale, "
                        f"max_calls 2, 4 x {n} seeds, --devices 2 ("
                        + ("rep_shards=2" if n % 2 == 0 else
                           "object-sharded R=3 x D=2")
                        + f"): every point's per-replication stats == "
                          f"--devices 1's ({events} events, all drained)")
    tmp.cleanup()

    # (h) packed and ltf stacked, each replication equal to its own drain.
    for impl, bound in SIM_ZOO_BOUNDS.items():
        over = (dict(batch_impl="packed") if impl == "packed"
                else dict(scheduler="ltf"))
        zmodel, zcfg = bench_path("wireless", **over)
        zeng = ParsirEngine(zmodel, zcfg, device=dev)
        t5 = time.perf_counter()
        zst = zeng.run_replicated_drained(
            zeng.init_replicated(list(range(SIM_ZOO_R))), bound)
        t6 = time.perf_counter()
        for r in range(SIM_ZOO_R):
            own = zeng.run_until_drained(zeng.init(seed=r), bound)
            _same_leaves(zeng.replication(zst, r), own,
                         f"[simulate] (h) {impl} replication {r}")
        tot = zeng.totals_replicated(zst)
        log("simulate", f"(h) wireless at bench scale, {impl}, R="
                        f"{SIM_ZOO_R} stacked, bound {bound}: each "
                        f"replication == its own run_until_drained leaf by "
                        f"leaf (processed {[t['processed'] for t in tot]}); "
                        f"stacked {t6 - t5:.2f} s")
    counts = {fn.__name__: fn.launches for fn in KERNELS}

    # (i) NCCL where the machine shows two or more cards.
    cards = torch.cuda.device_count()
    if cards >= 2:
        ranks = spawn(tmd.tasks_rank, 2, [(n, ("cuda",) + a[1:])
                                          for n, a in tasks],
                      backend="nccl", timeout=MD_COLLECTIVE_TIMEOUT,
                      join_timeout=MD_SPAWN_TIMEOUT)
        sim_check_reps(ranks, ref_digests, ref_totals, ref_epochs,
                       "2 NCCL ranks, a card each", smi)
    else:
        log("simulate", f"(i) NCCL not run: the machine shows {cards} CUDA "
                        f"device (NCCL needs a card per rank); rep_shards "
                        f"and R x D over NCCL are unverified")
    t7 = time.perf_counter()
    log("simulate", f"in-process kernel launches in the phase (the "
                    f"one-device reference stack): {counts}; the CLI's and "
                    f"the ranks' own are on their lines")
    log("simulate", f"phase time {t7 - t0:.1f} s: the one-device reference "
                    f"{t1 - t0:.1f} s beside the CLI and campaign processes "
                    f"(done at {t2 - t0:.1f} s), the timed CLI run "
                    f"{t3 - t2:.1f} s, the ranks {t4 - t3:.1f} s, "
                    f"campaign checks, packed/ltf and NCCL "
                    f"{t7 - t4:.1f} s")


# -- ssd_scan: kernel against its plain version, time, bound -----------------------

#: (b, T, H, P, N, chunk): the JAX tests' shapes at chunk 32, T=37 (one chunk
#: of 37) and T=160 (chunk 128, 96 padded steps), then the serving shape.
SSD_SHAPES = [(1, 64, 2, 32, 16, 32), (2, 160, 4, 64, 32, 32),
              (1, 96, 1, 16, 8, 32), (1, 37, 2, 16, 8, 128),
              (2, 160, 2, 16, 8, 128), (4, 1024, 64, 64, 64, 128)]


#: the final state against ``ssd_final_state``: f32, and bf16 x (h carried
#: in f32, its products on bf16 operands).
SSD_STATE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _ssd_inputs(b, T, H, P, N, xdtype, seed, device, view=False):
    """x [b, T, H, P], dt, A, B, C; with ``view``, x holds the same values
    as a [b, T, H, P] view of a wider [b, T, H·P + 2N] tensor, the layout in
    which ``mamba_apply`` hands it to the kernel."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn((b, T, H, P), generator=g) * 0.5).to(xdtype)
    dt = torch.rand((b, T, H), generator=g) * 0.2
    A = -torch.rand((H,), generator=g)
    B = torch.randn((b, T, N), generator=g) * 0.3
    C = torch.randn((b, T, N), generator=g) * 0.3
    if view:
        wide = torch.randn((b, T, H * P + 2 * N), generator=g).to(xdtype)
        wide[..., :H * P] = x.reshape(b, T, H * P)
        x = _ssd_view(wide.to(device), H, P)
    return [t.to(device) for t in (x, dt, A, B, C)]


def _ssd_view(wide, H, P):
    """The [b, T, H, P] view of the first H·P columns of ``wide``."""
    b, T, _ = wide.shape
    return wide[..., :H * P].view(b, T, H, P)


def check_ssd_scan(device) -> float:
    """ssd_scan kernels vs ssd_ref on the card, both on the inputs padded by
    ``ops.ssd``'s chunk rule, x contiguous and as the model's view; the
    final state against ``ssd_final_state``.  Returns the largest
    |kernel - plain| of y."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_ref
    from repro_torch.models.mamba2 import ssd_final_state
    worst = 0.0
    for i, (b, T, H, P, N, chunk) in enumerate(SSD_SHAPES):
        errs = []
        for name, view in itertools.product(("float32", "bfloat16"),
                                            (False, True)):
            x0, dt0, A, B0, C0 = _ssd_inputs(b, T, H, P, N,
                                             getattr(torch, name), 2000 + i,
                                             device, view)
            x, dt, B, C, ch = ops.ssd_pad(x0, dt0, B0, C0, chunk=chunk)
            if view and x.shape[1] == T and x.data_ptr() != x0.data_ptr():
                raise AssertionError("ssd_pad copied an unpadded x")
            hT = torch.empty((b, H, N, P), dtype=torch.float32, device=device)
            before = ssd_cuda.launches
            got = ssd_cuda(x, dt, A, B, C, chunk=ch, final_state=hT)[:, :T]
            want = ssd_ref(x, dt, A, B, C, chunk=ch)[:, :T]
            h_want = ssd_final_state(x0, dt0, A, B0)
            torch.cuda.synchronize()
            if ssd_cuda.launches != before + 1 or got.dtype != want.dtype:
                raise AssertionError("ssd_scan: the wrapper did not launch")
            err = float((got.float() - want.float()).abs().max())
            herr = float((hT - h_want).abs().max())
            layout = "view" if view else "contiguous"
            if not (err <= SSD_TOL[name] and herr <= SSD_STATE_TOL[name]):
                raise AssertionError(
                    f"ssd_scan kernel != plain at b={b} T={T} H={H} P={P} "
                    f"N={N} chunk={chunk} x {name} {layout}: max |diff| "
                    f"{err} (tol {SSD_TOL[name]}), final state {herr} (tol "
                    f"{SSD_STATE_TOL[name]})")
            worst = max(worst, err)
            errs.append(f"{name} {layout} {err:.3g} (h {herr:.3g})")
        log("kernels", f"ssd_scan b={b} T={T} H={H} P={P} N={N} chunk="
                       f"{chunk} (runs Q={ch}): max |kernel - plain| "
                       f"{', '.join(errs)} (tol 1e-4 f32, 5e-2 bf16; final "
                       f"state vs ssd_final_state 1e-4 f32, 1e-2 bf16)")
    return worst


def ssd_bound(b, T, H, P, N, Q, x_bytes):
    """(bytes, flops) of one ssd_scan call as the model makes it: x and y
    once, dt, A, B, C once, the f32 final state written once; per (batch,
    head) and chunk the lower-triangle C Bᵀ and G x products (Q(Q+1)/2
    entries) plus C h and the state update, 2 flops a multiply-add."""
    nbytes = (2 * b * T * H * P * x_bytes + (b * T * H + H + 2 * b * T * N) * 4
              + b * H * N * P * 4)
    tri = Q * (Q + 1) // 2
    flops = b * H * (T // Q) * (2 * tri * N + 2 * tri * P + 4 * Q * N * P)
    return nbytes, flops


# -- serving: zamba2-1.2b (phase 7) and llama3.2-3b (phase 7b) ---------------------

def _served_model(dev, arch, **changes):
    """The full-width model of ``arch`` (random weights, seed 0) on the
    card, with those config fields changed: llama3.2-3b under
    ``attn_impl="pallas"``, zamba2-1.2b under its own attention."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(arch)
    if arch == "llama3.2-3b":
        changes = {"attn_impl": "pallas", **changes}
    return build_model(dataclasses.replace(cfg, **changes), device=dev,
                       seed=0)


def _prefill_kernel(m):
    """(kernel wrapper, launches per prefill) of a served model: zamba2's
    prefill runs ssd_scan once per Mamba-2 layer, llama3.2-3b's (under
    ``"pallas"``) flash_attention once per layer."""
    from repro_torch.kernels.flash_attention import flash_cuda
    from repro_torch.kernels.ssd_scan import ssd_cuda
    return (ssd_cuda if m.cfg.family == "hybrid" else flash_cuda,
            m.cfg.n_layers)


def serve_reduced(dev, arch) -> float:
    """The reduced config on the card (a graphed session) and on the CPU,
    same weights and prompts, prefill + 8 greedy tokens: tokens equal,
    logits within 1e-4."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import ServeSession
    cfg = get_config(arch, reduced=True)
    if arch == "llama3.2-3b":
        cfg = dataclasses.replace(cfg, attn_impl="pallas")
    cpu = build_model(cfg, device="cpu", seed=0)
    card = build_model(cfg, device=dev, seed=0)
    card.load_state_dict(cpu.state_dict())
    batch = make_batch(cfg, 2, 32, step=2, device="cpu")
    outs = []
    for m, d in ((cpu, torch.device("cpu")), (card, dev)):
        sess = ServeSession(m, 2, 32 + 9, device=d)
        first = sess.prefill(batch)
        toks = torch.cat([first[:, None], sess.decode(first, 8)], dim=1)
        outs.append((toks.cpu(), torch.stack(sess.logits, 1).cpu()))
    err = float((outs[0][1] - outs[1][1]).abs().max())
    if not torch.equal(outs[0][0], outs[1][0]) or not err <= 1e-4 \
            or (sess.captures, sess.replays) != (1, 7):
        raise AssertionError(f"reduced {arch}: card and CPU disagree (tokens "
                             f"equal {torch.equal(outs[0][0], outs[1][0])}, "
                             f"max |logit diff| {err}), or the card session "
                             f"captured {sess.captures} and replayed "
                             f"{sess.replays} times")
    log("serve", f"reduced {arch} ({cfg.n_layers} layers, d_model "
                 f"{cfg.d_model}, attn_impl={cfg.attn_impl!r}), 2 prompts x 32"
                 f" + 8 greedy tokens: card (graphed decode: 1 capture, 7 "
                 f"replays) == CPU tokens, max |logit diff| {err:.3g} (tol "
                 f"1e-4)")
    return err


def serve_causal_check(dev, arch):
    """Full width in f32 through a graphed session: the prefill's last
    logits and every decode step's against the teacher-forced forward over
    prompt + generated tokens; the prefill kernel's launches counted."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.serve.engine import ServeSession
    m = _served_model(dev, arch, dtype="float32")
    kernel, per_prefill = _prefill_kernel(m)
    batch = make_batch(m.cfg, SERVE_BATCH, SERVE_PROMPT, device=dev)
    sess = ServeSession(m, SERVE_BATCH, SERVE_PROMPT + SERVE_TOKENS,
                        device=dev)
    before = kernel.launches
    first = sess.prefill(batch)
    if kernel.launches - before != per_prefill:
        raise AssertionError(f"f32 prefill: {kernel.__name__} launched "
                             f"{kernel.launches - before} times, not "
                             f"{per_prefill}")
    out = sess.decode(first, SERVE_TOKENS - 1)
    if (sess.captures, sess.replays, kernel.launches - before) != (
            1, SERVE_TOKENS - 2, per_prefill):
        raise AssertionError(f"f32 decode: {sess.captures} captures, "
                             f"{sess.replays} replays, {kernel.__name__} "
                             f"{kernel.launches - before - per_prefill} times")
    seq = torch.cat([batch["tokens"], first[:, None], out[:, :-1]], dim=1)
    full = m(seq)[:, SERVE_PROMPT - 1:]
    steps = torch.stack(sess.logits, dim=1)
    diff = (steps - full).abs()
    err, big = float(diff.max()), float(full.abs().max())
    pre = float(diff[:, 0].max())
    rel = float((diff / full.abs().clamp(min=1.0)).max())
    agree = float((steps.argmax(-1) == full.argmax(-1)).float().mean())
    torch.cuda.synchronize()
    if not bool((diff <= CAUSAL_TOL + CAUSAL_TOL * full.abs()).all()):
        raise AssertionError(
            f"full-width f32 {arch}: served logits differ from the "
            f"teacher-forced forward by up to {err} (max |logit| {big})")
    log("serve", f"full-width {arch} in f32 ({sum(p.numel() for p in m.parameters()):,} "
                 f"params, attn_impl={m.cfg.attn_impl!r}), {SERVE_BATCH} x "
                 f"{SERVE_PROMPT} prompt + {SERVE_TOKENS} greedy tokens, "
                 f"graphed decode ({sess.captures} capture, {sess.replays} "
                 f"replays): prefill + decode logits == teacher-forced "
                 f"forward over {seq.shape[1]} tokens, max |diff| {err:.3g} "
                 f"(the prefill's {pre:.3g}; max |logit| {big:.3g}, max "
                 f"|diff|/max(1,|logit|) {rel:.3g}; tol atol=rtol="
                 f"{CAUSAL_TOL}), argmax agreement {agree:.4f}; "
                 f"{kernel.__name__} {per_prefill} launches in the prefill, "
                 f"0 in decode")
    del m, sess, full, steps, diff
    torch.cuda.empty_cache()
    return err


def _clock(marks):
    """Append the host time after the card has caught up."""
    import torch
    torch.cuda.synchronize()
    marks.append(time.perf_counter())


def eager_decode(m, w, tokens, n, max_len):
    """The yardstick of the graphed session: prefill, then ``n`` eager
    ``decode_step`` calls, the position a device tensor, the same
    ``max_len`` → (tokens [B, n], logits [B, n + 1, V], ms per step)."""
    import torch
    caches = m.init_cache(tokens.shape[0], max_len)
    lg, _ = m.prefill(tokens, caches, w)
    tok = lg[:, -1].argmax(-1)
    cur_len = torch.tensor(tokens.shape[1], device=tokens.device)
    toks, logits, marks = [], [lg[:, -1]], []
    _clock(marks)
    for _ in range(n):
        lg, _ = m.decode_step(tok[:, None], caches, cur_len, w)
        tok = lg[:, -1].argmax(-1)
        cur_len += 1
        toks.append(tok)
        logits.append(lg[:, -1])
    _clock(marks)
    return (torch.stack(toks, 1), torch.stack(logits, 1),
            (marks[1] - marks[0]) * 1e3 / n)


def serve_timed(dev, arch):
    """Full width in bf16: one warm-up and SERVE_REPEATS timed runs, each a
    graphed session (the prefill; the first decode step, eager; the
    second, capture + first replay; the rest, replays) and then the eager
    ``decode_step`` loop from the same prompts with the session's weights:
    greedy tokens equal, max |Δlogit| logged.  Every kernel count is set to
    0 just before and read just after: the prefill kernel launches once per
    layer in each prefill and never in a decode step, no other kernel runs.
    Returns the model, the prompts, the medians and the launches."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.serve.engine import ServeSession
    torch.cuda.reset_peak_memory_stats()
    m = _served_model(dev, arch)
    kernel, per_prefill = _prefill_kernel(m)
    batch = make_batch(m.cfg, SERVE_BATCH, SERVE_PROMPT, device=dev)
    n_dec, max_len = SERVE_TOKENS - 1, SERVE_PROMPT + SERVE_TOKENS
    rows = []
    for fn in KERNELS:
        fn.launches = 0
    for _ in range(1 + SERVE_REPEATS):
        sess = ServeSession(m, SERVE_BATCH, max_len, device=dev)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t = []
        _clock(t)
        e0.record()
        first = sess.prefill(batch)
        e1.record()
        _clock(t)
        launched = kernel.launches
        o1 = sess.decode(first, 1)
        _clock(t)
        o2 = sess.decode(o1[:, -1], 1)
        _clock(t)
        o3 = sess.decode(o2[:, -1], n_dec - 2)
        _clock(t)
        if kernel.launches != launched or (sess.eager_steps, sess.captures,
                                           sess.replays) != (1, 1, n_dec - 1):
            raise AssertionError(f"{arch} decode: {kernel.__name__} launched "
                                 f"{kernel.launches - launched} times; "
                                 f"{sess.eager_steps} eager steps, "
                                 f"{sess.captures} captures, {sess.replays} "
                                 f"replays")
        toks = torch.cat([o1, o2, o3], 1)
        logits = torch.stack(sess.logits, 1)
        e_toks, e_logits, eager_ms = eager_decode(m, sess.weights,
                                                  batch["tokens"], n_dec,
                                                  max_len)
        if not torch.equal(toks, e_toks) or not bool(
                torch.isfinite(logits).all()) or not bool(
                ((toks >= 0) & (toks < m.cfg.vocab_size)).all()):
            raise AssertionError(f"bf16 {arch}: the graphed session's tokens "
                                 f"differ from the eager loop's, or bad "
                                 f"logits")
        steady = (t[4] - t[3]) * 1e3 / (n_dec - 2)
        rows.append({"prefill_ms": (t[1] - t[0]) * 1e3,
                     "prefill_dev_ms": e0.elapsed_time(e1),
                     "first_step_ms": (t[2] - t[1]) * 1e3,
                     "capture_ms": (t[3] - t[2]) * 1e3 - steady,
                     "decode_ms": (t[4] - t[1]) * 1e3 / n_dec,
                     "steady_ms": steady, "eager_ms": eager_ms,
                     "dlogit": float((logits - e_logits).abs().max())})
        del sess, logits, e_logits
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    want = {fn.__name__: 2 * per_prefill * (1 + SERVE_REPEATS)
            if fn is kernel else 0 for fn in KERNELS}
    if launches != want:
        raise AssertionError(f"{arch} serving launched {launches}, not "
                             f"{want} (a prefill per session and per eager "
                             f"loop)")
    timed = rows[1:]
    med = {k: statistics.median(r[k] for r in timed) for k in timed[0]}
    med["tok_s"] = SERVE_BATCH / (med["decode_ms"] / 1e3)
    med["steady_tok_s"] = SERVE_BATCH / (med["steady_ms"] / 1e3)
    med["eager_tok_s"] = SERVE_BATCH / (med["eager_ms"] / 1e3)
    med["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    nbytes = decode_bound(m, max_len)
    med["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    log("serve", f"full-width {arch} in bf16 ({sum(p.numel() for p in m.parameters()):,} "
                 f"params, f32 masters + bf16 copy, attn_impl="
                 f"{m.cfg.attn_impl!r}), {SERVE_BATCH} x {SERVE_PROMPT}-token "
                 f"prompts, {SERVE_TOKENS} greedy tokens, median of "
                 f"{SERVE_REPEATS} after 1 warm-up: prefill "
                 f"{med['prefill_ms']:.2f} ms (CUDA events "
                 f"{med['prefill_dev_ms']:.2f}); graphed decode "
                 f"{med['decode_ms']:.3f} ms/token with the capture "
                 f"({med['tok_s']:.1f} tok/s), {med['steady_ms']:.3f} ms/token "
                 f"replayed ({med['steady_tok_s']:.1f} tok/s), first (eager) "
                 f"step {med['first_step_ms']:.3f} ms, capture "
                 f"{med['capture_ms']:.3f} ms; eager decode_step loop "
                 f"{med['eager_ms']:.3f} ms/token ({med['eager_tok_s']:.1f} "
                 f"tok/s, {med['eager_ms'] / med['steady_ms']:.2f}x the "
                 f"replay); bound {med['bound_ms']:.3f} ms/token "
                 f"({nbytes} B of compute weights and "
                 f"caches at 3.35 TB/s; the replay at "
                 f"{100 * med['bound_ms'] / med['steady_ms']:.1f} % of it); "
                 f"peak device memory {med['peak_mib']:.0f} MiB")
    log("serve", f"{arch} per run (prefill ms, graphed ms/token with capture"
                 f", replayed ms/token, capture ms, eager ms/token): " +
        ", ".join(f"{r['prefill_ms']:.2f}/{r['decode_ms']:.3f}/"
                  f"{r['steady_ms']:.3f}/{r['capture_ms']:.1f}/"
                  f"{r['eager_ms']:.3f}" for r in rows)
        + " (the first is the warm-up)")
    log("serve", f"{arch} graphed decode == eager decode_step loop: greedy "
                 f"tokens equal in every run, max |Δlogit| "
                 f"{max(r['dlogit'] for r in rows):.3g} (logged, not gated); "
                 f"kernel launches on the path: {launches} ({per_prefill} "
                 f"{kernel.__name__} per prefill, 2 prefills a run, 0 per "
                 f"decode step)")
    return m, batch, med, launches[kernel.__name__]


def decode_bound(m, max_len) -> int:
    """Bytes a decode step must move: every compute weight read once (the
    tied table once, for the unembedding), every cache read once as the
    masked attention reads it (all ``max_len`` rows), the SSM states also
    written once; the new k/v rows and the activations are left out."""
    from repro_torch.core.graphs import leaves
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    caches = m.init_cache(SERVE_BATCH, max_len)
    total = nbytes(leaves(m.weights()))
    if isinstance(caches, dict):                 # hybrid: SSM states r+w
        total += nbytes(leaves(caches["attn"])) + 2 * nbytes(
            leaves(caches["mamba"]))
    else:
        total += nbytes(leaves(dict(enumerate(caches))))
    return total


def time_masked_decode(dev, arch, flush):
    """``layers.attn_masked_decode`` alone at a served model's decode shape
    (B prompts, one query each, its bf16 cache of SERVE_PROMPT +
    SERVE_TOKENS rows, the first SERVE_PROMPT + 1 valid), L2 flushed before
    each call: ms per call and per decode step (one call per attention
    layer), beside the bound of reading q and the cache and writing o
    once."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.layers import attn_masked_decode
    cfg = get_config(arch)
    calls = (len(range(0, cfg.n_layers, cfg.attn_every or 6))
             if cfg.family == "hybrid" else cfg.n_layers)
    g = torch.Generator(device="cpu").manual_seed(5)
    smax = SERVE_PROMPT + SERVE_TOKENS
    q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)
               for shape in ((SERVE_BATCH, 1, cfg.n_heads, cfg.hd),
                             (SERVE_BATCH, smax, cfg.n_kv_heads, cfg.hd),
                             (SERVE_BATCH, smax, cfg.n_kv_heads, cfg.hd)))
    valid = torch.tensor(SERVE_PROMPT + 1, device=dev)

    def fn(q, k, v):
        return attn_masked_decode(q, k, v, valid)
    ms = _time_launches(fn, [q, k, v], 20, flush)
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log("timing", f"{arch} masked decode attention (attn_masked_decode, "
                  f"plain PyTorch) at B={SERVE_BATCH} Hq={cfg.n_heads} "
                  f"Hkv={cfg.n_kv_heads} D={cfg.hd}, bf16 cache of {smax} "
                  f"rows: {ms:.4f} ms/call, {calls} calls per decode step = "
                  f"{calls * ms:.3f} ms per step; bound {bound:.4f} ms/call "
                  f"({nbytes} B at 3.35 TB/s), L2 flushed before each call")
    return ms * calls


def _device_rows(prof):
    """(device µs, calls, name) of every device-side op, largest first."""
    from torch.autograd import DeviceType
    rows = []
    for evt in prof.key_averages():
        us = next((float(getattr(evt, a)) for a in (
            "self_device_time_total", "self_cuda_time_total")
            if getattr(evt, a, None) is not None), 0.0)
        if us > 0 and evt.device_type != DeviceType.CPU:
            rows.append((us, evt.count, evt.key))
    return sorted(rows, reverse=True)


#: decode steps each serving profile covers.
PROFILE_STEPS = 8


def serve_profile(dev, m, batch, med):
    """torch.profiler over one prefill, over PROFILE_STEPS replays of a
    captured decode step and over PROFILE_STEPS eager ``decode_step``
    calls: top device ops, and the device's busy share of the untraced
    median times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import ServeSession
    arch = m.cfg.name
    sess = ServeSession(m, SERVE_BATCH, SERVE_PROMPT + SERVE_TOKENS,
                        device=dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as p_pre:
        first = sess.prefill(batch)
        torch.cuda.synchronize()
    out = sess.decode(first, 2)                 # the eager step, the capture
    torch.cuda.synchronize()
    with profile(activities=acts) as p_graph:
        sess.decode(out[:, -1], PROFILE_STEPS)
        torch.cuda.synchronize()
    w, caches, cur_len = sess.weights, sess.caches, sess.cur_len
    tok = sess.tokens
    with profile(activities=acts) as p_eager:
        for _ in range(PROFILE_STEPS):
            lg, _ = m.decode_step(tok, caches, cur_len, w)
            tok = lg[:, -1:].argmax(-1)
            cur_len += 1
        torch.cuda.synchronize()
    shares = {}
    for name, prof, untraced_ms, steps in (
            ("prefill", p_pre, med["prefill_ms"], 1),
            ("graphed decode step", p_graph, med["steady_ms"], PROFILE_STEPS),
            ("eager decode step", p_eager, med["eager_ms"], PROFILE_STEPS)):
        rows = _device_rows(prof)
        busy_ms = sum(r[0] for r in rows) / 1e3 / steps
        ops = sum(r[1] for r in rows) / steps
        shares[name] = busy_ms / untraced_ms if busy_ms else None
        log("profile", f"{arch} {name} (mean of {steps}): device busy "
                       f"{1e3 * busy_ms:.1f} us in {ops:.1f} device ops = " + (
                           f"{100 * shares[name]:.1f} % of the untraced "
                           f"median {untraced_ms:.3f} ms" if busy_ms else
                           "not measured (the profiler saw no device time)"))
        for us, cnt, key in rows[:8]:
            log("profile", f"  {us / 1e3 / steps:9.3f} ms {cnt / steps:7.1f}x"
                           f"  {key[:90]}")
        if prof is p_pre:
            kern, label = (("ssd_", "ssd_scan") if arch == "zamba2-1.2b"
                           else ("flash_", "flash_attention"))
            log("profile", f"{arch} prefill: " + "; ".join(
                f"{what} {sum(r[1] for r in sel)} launches, "
                f"{sum(r[0] for r in sel) / 1e3:.3f} ms" for what, sel in (
                    (label, [r for r in rows if kern in r[2]]),
                    ("cumsum", [r for r in rows if "cumsum" in r[2].lower()
                                or "scan" in r[2].lower()
                                and "ssd_" not in r[2]]),
                    ("direct_copy of strided inputs (casts and copies of "
                     "views)", [
                        r for r in rows if "direct_copy" in r[2]
                        and r[2].startswith(
                            "void at::native::elementwise_kernel<")]))))
    return shares


def time_ssd_scan(dev, flush):
    """ssd_scan at the serving shape as ``mamba_apply`` calls it (x a view
    of the wider activation, the final state written), L2 flushed before
    each launch: the main path's bf16 x/y and, for the record, f32.  The
    bound counts the products at the rate of the kernel's operands: bf16
    tensor cores for bf16, the f32 CUDA-core rate for f32."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_ref
    b, T, H, P, N, Q = SSD_SHAPES[-1]
    out = {}
    for name in ("bfloat16", "float32"):
        xdt = getattr(torch, name)
        x, dt, A, B, C = _ssd_inputs(b, T, H, P, N, xdt, 7, dev, view=True)
        # the whole [b, T, H*P+2N] activation that x is a view of.
        wide = x.as_strided((b, T, x.stride(1)), (x.stride(0), x.stride(1),
                                                  1))
        inp = [wide, dt, A, B, C]
        hT = torch.empty((b, H, N, P), dtype=torch.float32, device=dev)

        def kern(w, *r):
            return ssd_cuda(_ssd_view(w, H, P), *r, chunk=Q, final_state=hT)

        def plain(w, *r):
            return ssd_ref(_ssd_view(w, H, P), *r, chunk=Q, final_state=hT)
        for _ in range(3):
            kern(*inp)
        ms = _time_launches(kern, inp, 20, flush)
        plain_ms = _time_launches(plain, inp, 5, flush)
        nbytes, flops = ssd_bound(b, T, H, P, N, Q, xdt.itemsize)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        peak = BF16_FLOPS if xdt == torch.bfloat16 else F32_FLOPS
        t_ops = flops / peak * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
        log("timing", f"ssd_scan at b={b} T={T} H={H} P={P} N={N} Q={Q}, x/y "
                      f"{name}, x a view of the [b, T, H*P+2N] activation, "
                      f"final state written: kernel {ms:.4f} ms/launch, plain "
                      f"{plain_ms:.4f} ms, bound {out[name]['bound_ms']:.4f} "
                      f"ms ({nbytes} B at 3.35 TB/s = {t_bytes:.4f} ms; "
                      f"{flops} flop at {peak / 1e12:g} TFLOP/s = "
                      f"{t_ops:.4f} ms; {100 * out[name]['bound_ms'] / ms:.1f}"
                      f" % of the bound), L2 flushed before each launch")
        del x, wide, inp
    return out


# -- flash_attention: kernel against its plain version, time, bound ----------------

#: (B, Hq, Hkv, Tq, Tk, D, causal): the JAX tests' shapes, non-causal, Tq < Tk,
#: a ragged T, then llama3.2-3b's and zamba2-1.2b's full-width shapes.
FLASH_SHAPES = [(1, 4, 2, 128, 128, 64, True), (2, 8, 2, 256, 256, 64, True),
                (1, 2, 2, 64, 64, 32, True), (1, 4, 1, 96, 96, 32, True),
                (1, 2, 2, 128, 128, 32, False), (2, 8, 2, 256, 256, 64, False),
                (1, 4, 2, 64, 128, 32, True), (2, 8, 2, 96, 160, 64, True),
                (1, 8, 2, 1000, 1000, 128, True),
                (4, 24, 8, 1024, 1024, 128, True),
                (4, 24, 8, 2048, 2048, 128, True),
                (4, 32, 32, 1024, 1024, 128, True)]


def _flash_inputs(B, Hq, Hkv, Tq, Tk, D, dtype, seed, device,
                  view=False):
    """q [B, Hq, Tq, D], k and v [B, Hkv, Tk, D]; with ``view``, the same
    values as [B, H, T, D] views of [B, T, H, D] tensors, the layout in
    which ``layers.sdpa`` hands them to the kernel."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    ts = [torch.randn(shape, generator=g).to(dtype).to(device)
          for shape in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D))]
    if view:
        ts = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in ts]
    return ts


def check_flash(device) -> float:
    """flash_attention kernels vs attention_ref on the card, on contiguous
    inputs and on the models' views; returns the largest |kernel - plain|
    over every shape, dtype and layout."""
    import torch
    from repro_torch.kernels.flash_attention import attention_ref, flash_cuda
    worst = 0.0
    for i, (B, Hq, Hkv, Tq, Tk, D, causal) in enumerate(FLASH_SHAPES):
        errs = []
        for name, view in itertools.product(("float32", "bfloat16"),
                                            (False, True)):
            q, k, v = _flash_inputs(B, Hq, Hkv, Tq, Tk, D,
                                    getattr(torch, name), 3000 + i, device,
                                    view)
            before = flash_cuda.launches
            got = flash_cuda(q, k, v, causal=causal)
            want = attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            if flash_cuda.launches != before + 1 or got.dtype != want.dtype \
                    or got.stride() != q.stride():
                raise AssertionError("flash_attention: the wrapper did not "
                                     "launch, or o lost q's layout")
            err = float((got.float() - want.float()).abs().max())
            layout = "view" if view else "contiguous"
            if not err <= FLASH_TOL[name]:
                raise AssertionError(
                    f"flash_attention kernel != plain at B={B} Hq={Hq} "
                    f"Hkv={Hkv} Tq={Tq} Tk={Tk} D={D} causal={causal} "
                    f"{name} {layout}: max |diff| {err} > {FLASH_TOL[name]}")
            worst = max(worst, err)
            errs.append(f"{name} {layout} {err:.3g}")
            del q, k, v, got, want
        log("kernels", f"flash_attention B={B} Hq={Hq} Hkv={Hkv} Tq={Tq} "
                     f"Tk={Tk} D={D} {'causal' if causal else 'non-causal'}: "
                     f"max |kernel - plain| {', '.join(errs)} (tol 2e-5 f32, "
                     f"2e-2 bf16)")
    torch.cuda.empty_cache()
    return worst


def flash_bound(B, Hq, Hkv, Tq, Tk, D, causal, itemsize):
    """(bytes, flops) of one attention call: q, k, v read and o written
    once; the two products, 2 flops a multiply-add, over the (row, key)
    pairs the mask leaves visible."""
    nbytes = (2 * B * Hq * Tq * D + 2 * B * Hkv * Tk * D) * itemsize
    off = Tk - Tq
    pairs = (sum(min(Tk, max(0, i + off + 1)) for i in range(Tq)) if causal
             else Tq * Tk)
    return nbytes, 4 * B * Hq * D * pairs


def time_flash(dev, flush):
    """flash_attention as the models call it (the [B, H, T, D] views of
    their [B, T, H, D] activations), L2 flushed before each launch: the main
    path's bf16 at llama3.2-3b's and zamba2-1.2b's full-width shapes and, for
    the record, f32 at llama3.2-3b's; beside the plain version and one SDPA
    call on the same views (the yardstick; the port never calls it).
    Returns {(model, dtype): numbers}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_ref, flash_cuda

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    out = {}
    for model, shape, name in (("llama3.2-3b", FLASH_SHAPES[-2], "bfloat16"),
                               ("llama3.2-3b prefill", FLASH_SHAPES[-3],
                                "bfloat16"),
                               ("zamba2-1.2b", FLASH_SHAPES[-1], "bfloat16"),
                               ("llama3.2-3b", FLASH_SHAPES[-2], "float32")):
        B, Hq, Hkv, Tq, Tk, D, causal = shape
        dt = getattr(torch, name)
        inp = _flash_inputs(B, Hq, Hkv, Tq, Tk, D, dt, 11, dev, view=True)
        for _ in range(2):
            flash_cuda(*inp)
        ms = _time_launches(flash_cuda, inp, 20, flush)
        plain_ms = _time_launches(attention_ref, inp, 5, flush)
        lib_ms = _time_launches(sdpa, inp, 20, flush)
        lib_err = float((sdpa(*inp).float() - flash_cuda(*inp).float())
                        .abs().max())
        nbytes, flops = flash_bound(B, Hq, Hkv, Tq, Tk, D, causal,
                                    dt.itemsize)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        t_ops = flops / peak * 1e3
        out[model, name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        log("timing", f"flash_attention at {model}'s B={B} Hq={Hq} Hkv={Hkv} "
                      f"T={Tq} D={D} causal, {name}, [B,T,H,D] views: kernel "
                      f"{ms:.4f} ms/launch ({flops / ms / 1e9:.1f} TFLOP/s), "
                      f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (max "
                      f"|SDPA - kernel| {lib_err:.3g}; kernel/SDPA "
                      f"{ms / lib_ms:.2f}x), bound "
                      f"{out[model, name]['bound_ms']:.4f} ms ({nbytes} B at "
                      f"3.35 TB/s = {t_bytes:.4f} ms; {flops} flop at "
                      f"{peak / 1e12:g} TFLOP/s = {t_ops:.4f} ms), L2 flushed "
                      f"before each launch")
        del inp
    return out


# -- llama3.2-3b forward and loss ----------------------------------------------------

def _with(model, **changes):
    """The model with those fields of its config changed."""
    model.cfg = dataclasses.replace(model.cfg, **changes)
    return model


def bf16_spread(name, model, tokens):
    """bf16 logits through the kernel and through the plain attention, each
    against the same model's f32 forward (plain attention): how far the
    kernel moves the logits beside the model's own bf16 rounding.  Logged,
    not gated; leaves the model's config as it found it."""
    import torch
    cfg = model.cfg
    w16 = model.weights()
    kern = _with(model, attn_impl="pallas")(tokens, w16)
    plain = _with(model, attn_impl="jnp")(tokens, w16)
    del w16
    ref = _with(model, dtype="float32")(tokens, model.tree(torch.float32))
    model.cfg = cfg

    def cmp(a, b):
        return (f"max |diff| {float((a - b).abs().max()):.3g}, argmax "
                f"agreement {float((a.argmax(-1) == b.argmax(-1)).float().mean()):.4f}")
    log("lm", f"{name} bf16 logits, {tokens.shape[0]} x {tokens.shape[1]} "
              f"tokens (max |logit| {float(ref.abs().max()):.3g} in f32): "
              f"kernel vs plain attention {cmp(kern, plain)}; plain bf16 vs "
              f"f32 {cmp(plain, ref)}; kernel bf16 vs f32 {cmp(kern, ref)} "
              f"(logged, not gated)")
    del kern, plain, ref
    torch.cuda.empty_cache()


def lm_reduced(dev) -> float:
    """The reduced llama3.2 through the kernel on the card and through the
    plain attention on the CPU, same weights and tokens: logits and loss
    within 1e-4."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels.flash_attention import flash_cuda
    from repro_torch.models.transformer import DecoderLM
    cfg = dataclasses.replace(get_config("llama3.2-3b", reduced=True),
                              attn_impl="pallas")
    cpu = DecoderLM(cfg, device="cpu", seed=0)
    card = DecoderLM(cfg, device=dev, seed=0)
    card.load_state_dict(cpu.state_dict())
    batch = make_batch(cfg, 2, 96, step=1, device="cpu")
    before = flash_cuda.launches
    got = (card(batch["tokens"].to(dev)).cpu(),
           float(card.loss({"tokens": batch["tokens"].to(dev)})))
    if flash_cuda.launches - before != 2 * cfg.n_layers:
        raise AssertionError("reduced llama3.2: the card did not run the "
                             "flash kernel once per layer")
    want = (cpu(batch["tokens"]), float(cpu.loss(batch)))
    err = float((got[0] - want[0]).abs().max())
    lerr = abs(got[1] - want[1])
    if not (err <= 1e-4 and lerr <= 1e-4):
        raise AssertionError(f"reduced llama3.2: card and CPU disagree (max "
                             f"|logit diff| {err}, |loss diff| {lerr})")
    log("lm", f"reduced llama3.2 (2 layers, d_model 64), 2 x 96 tokens: card "
              f"(flash kernel) == CPU (plain attention), max |logit diff| "
              f"{err:.3g}, |loss diff| {lerr:.3g} (tol 1e-4)")
    return err


def lm_f32_check(dev, cfg):
    """Full width in f32: logits and loss through the kernel against the
    same model under the plain chunked attention."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels.flash_attention import flash_cuda
    from repro_torch.models.transformer import DecoderLM
    m = DecoderLM(dataclasses.replace(cfg, dtype="float32"), device=dev,
                  seed=0)
    batch = make_batch(m.cfg, LM_BATCH, LM_T, device=dev)
    w = m.weights()
    out = {}
    for impl in ("pallas", "jnp"):
        before = flash_cuda.launches
        logits = _with(m, attn_impl=impl)(batch["tokens"], w)
        loss = float(m.loss(batch, w))
        torch.cuda.synchronize()
        launched = flash_cuda.launches - before
        if launched != (2 * cfg.n_layers if impl == "pallas" else 0):
            raise AssertionError(f"f32 {impl}: {launched} flash launches")
        out[impl] = (logits, loss)
    (lk, ls), (lp, lsp) = out["pallas"], out["jnp"]
    diff = (lk - lp).abs()
    err, big, lerr = float(diff.max()), float(lp.abs().max()), abs(ls - lsp)
    ok = bool((diff <= CAUSAL_TOL + CAUSAL_TOL * lp.abs()).all())
    if not (ok and lerr <= LOSS_TOL and bool(torch.isfinite(lk).all())):
        raise AssertionError(f"full-width f32: kernel and plain attention "
                             f"disagree (max |logit diff| {err}, max |logit| "
                             f"{big}, |loss diff| {lerr})")
    log("lm", f"full-width llama3.2-3b in f32 ({m.cfg.n_layers} layers, "
              f"{sum(p.numel() for p in m.parameters()):,} params, seed 0), "
              f"{LM_BATCH} x {LM_T} tokens: flash kernel vs plain chunked "
              f"attention: max |logit diff| {err:.3g} (max |logit| "
              f"{big:.3g}; tol atol=rtol={CAUSAL_TOL}), loss {ls:.6f} vs "
              f"{lsp:.6f}, |diff| {lerr:.3g} (tol {LOSS_TOL})")
    del m, w, out, lk, lp, diff
    torch.cuda.empty_cache()
    return err, lerr


def lm_timed(dev, cfg):
    """Full width in the config's bf16 through the kernel: one warm-up, then
    LM_REPEATS timed calls of ``loss`` (which runs the forward), the compute
    weights cast once beforehand; every kernel count set to 0 just before."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels.event_apply import event_apply_cuda
    from repro_torch.kernels.flash_attention import flash_cuda
    from repro_torch.kernels.ssd_scan import ssd_cuda
    from repro_torch.models.transformer import DecoderLM
    torch.cuda.reset_peak_memory_stats()
    m = DecoderLM(dataclasses.replace(cfg, attn_impl="pallas"), device=dev,
                  seed=0)
    batch = make_batch(cfg, LM_BATCH, LM_T, device=dev)
    w = m.weights()
    rows = []
    flash_cuda.launches = ssd_cuda.launches = event_apply_cuda.launches = 0
    for _ in range(1 + LM_REPEATS):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        before = flash_cuda.launches
        t0 = time.perf_counter()
        e0.record()
        loss = m.loss(batch, w)
        e1.record()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if flash_cuda.launches - before != cfg.n_layers:
            raise AssertionError(f"forward launched flash_attention "
                                 f"{flash_cuda.launches - before} times, not "
                                 f"{cfg.n_layers}")
        if not bool(torch.isfinite(loss)):
            raise AssertionError(f"bf16 loss is not finite: {loss}")
        rows.append({"ms": (t1 - t0) * 1e3, "dev_ms": e0.elapsed_time(e1),
                     "loss": float(loss)})
    launches = (flash_cuda.launches, ssd_cuda.launches,
                event_apply_cuda.launches)
    if launches[1:] != (0, 0):
        raise AssertionError(f"the dense forward launched other kernels: "
                             f"{launches}")
    timed = rows[1:]
    med = {k: statistics.median(r[k] for r in timed) for k in ("ms", "dev_ms")}
    med["tok_s"] = LM_BATCH * LM_T / (med["ms"] / 1e3)
    med["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    log("lm", f"full-width llama3.2-3b in bf16 (f32 masters + bf16 copy), "
              f"{LM_BATCH} x {LM_T} tokens, forward + loss, median of "
              f"{LM_REPEATS} after 1 warm-up: {med['ms']:.2f} ms (CUDA events "
              f"{med['dev_ms']:.2f}), {med['tok_s']:.0f} tokens/s, peak device "
              f"memory {med['peak_mib']:.0f} MiB, loss {timed[-1]['loss']:.4f}")
    log("lm", "per run (ms): " + ", ".join(f"{r['ms']:.2f}" for r in rows)
        + " (the first is the warm-up)")
    log("lm", f"flash_attention launches on the main path: {launches[0]} "
              f"({launches[0] // (1 + LM_REPEATS)} per forward); ssd_scan "
              f"{launches[1]}, event_apply {launches[2]}")
    return m, w, batch, med, launches[0]


def lm_profile(m, w, batch, med):
    """torch.profiler over one forward + loss: top device ops and the
    device's busy share of the untraced median."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        m.loss(batch, w)
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log("profile", f"llama3.2-3b forward + loss: device busy {busy_ms:.3f} ms "
                   f"in {sum(r[1] for r in rows)} device ops = " + (
                       f"{100 * busy_ms / med['ms']:.1f} % of the untraced "
                       f"median {med['ms']:.3f} ms" if busy_ms else
                       "not measured (the profiler saw no device time)"))
    for us, cnt, key in rows[:10]:
        log("profile", f"  {us / 1e3:9.3f} ms {cnt:6d}x  {key[:90]}")
    # direct_copy runs both the dtype casts (contiguous: the unrolled or
    # vectorized kernel) and the copies of strided tensors (the plain
    # elementwise_kernel), which are the layout copies.
    copies = [(us, cnt, key) for us, cnt, key in rows if "direct_copy" in key]
    layout = [(us, cnt) for us, cnt, key in copies
              if key.startswith("void at::native::elementwise_kernel<")]
    log("profile", f"llama3.2-3b forward + loss: {sum(r[1] for r in copies)} "
                   f"direct_copy launches, "
                   f"{sum(r[0] for r in copies) / 1e3:.3f} ms; of them "
                   f"{sum(c for _, c in layout)} strided (layout) copies, "
                   f"{sum(us for us, _ in layout) / 1e3:.3f} ms")
    for us, cnt, key in copies:
        log("profile", f"  {us / 1e3:9.3f} ms {cnt:6d}x  {key[:90]}")


def zamba_pallas_forward(dev, model):
    """One zamba2-1.2b bf16 forward (B=4, T=1024) through the kernel: one
    launch per shared-attention invocation; then the logits' spread."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels.flash_attention import flash_cuda
    tokens = make_batch(model.cfg, SERVE_BATCH, SERVE_PROMPT,
                        device=dev)["tokens"]
    before = flash_cuda.launches
    got = _with(model, attn_impl="pallas")(tokens)
    torch.cuda.synchronize()
    launched = flash_cuda.launches - before
    if launched != len(model.attn_at) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"zamba2 forward: {launched} flash launches, "
                             f"finite {bool(torch.isfinite(got).all())}")
    log("lm", f"full-width zamba2-1.2b bf16 forward, {SERVE_BATCH} x "
              f"{SERVE_PROMPT} tokens, attn_impl='pallas': {launched} "
              f"flash_attention launches, finite logits")
    del got
    bf16_spread("zamba2-1.2b", model, tokens)


def zamba_pallas_prefill(dev, model, batch):
    """The zamba2-1.2b bf16 prefill with its shared-attention calls through
    the kernel (``attn_impl="pallas"``: one launch per invocation) beside
    its own plain f32 attention, in turns (plain, kernel, kernel, plain):
    ms by the host clock, launches, the last logits' spread (logged, not
    gated)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_cuda
    cfg, w = model.cfg, model.weights()
    ms, last = {"jnp": [], "pallas": []}, {}
    for impl in ("jnp", "pallas", "pallas", "jnp"):
        caches = model.init_cache(SERVE_BATCH, SERVE_PROMPT + SERVE_TOKENS)
        before, t = flash_cuda.launches, []
        _clock(t)
        last[impl], _ = _with(model, attn_impl=impl).prefill(
            batch["tokens"], caches, w)
        _clock(t)
        launched = flash_cuda.launches - before
        if launched != (len(model.attn_at) if impl == "pallas" else 0):
            raise AssertionError(f"zamba2 prefill under {impl}: {launched} "
                                 f"flash launches")
        ms[impl].append((t[1] - t[0]) * 1e3)
        del caches
    model.cfg = cfg
    d = last["pallas"] - last["jnp"]
    log("lm", f"full-width zamba2-1.2b bf16 prefill, {SERVE_BATCH} x "
              f"{SERVE_PROMPT} tokens, in turns: shared attention through "
              f"flash_attention ({len(model.attn_at)} launches) "
              f"{', '.join(f'{x:.2f}' for x in ms['pallas'])} ms, through the "
              f"plain f32 attention {', '.join(f'{x:.2f}' for x in ms['jnp'])}"
              f" ms; last logits max |diff| {float(d.abs().max()):.3g}, "
              f"argmax agreement "
              f"{float((last['pallas'].argmax(-1) == last['jnp'].argmax(-1)).float().mean()):.4f}"
              f" (logged, not gated)")
    del w, last, d
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs.registry import get_config
    from repro_torch.core.calendar import extract_sorted
    from repro_torch.core.engine import ParsirEngine
    from repro_torch.core.graphs import clone_state
    from repro_torch.core.ref_engine import run_sequential
    from repro_torch.kernels import build
    from repro_torch.kernels.event_apply import MAX_SMEM as EA_MAX_SMEM
    from repro_torch.kernels.event_apply import ctas_per_sm as ea_ctas
    from repro_torch.kernels.event_apply import event_apply_cuda
    from repro_torch.kernels.event_apply import smem_bytes as ea_smem
    from repro_torch.kernels.flash_attention import _lib as flash_lib
    from repro_torch.kernels.ssd_scan import ctas_per_sm as ssd_ctas
    from repro_torch.kernels.ssd_scan import smem_bytes as ssd_smem
    from repro_torch.testing import golden
    from repro_torch.testing.clean import assert_clean
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.testing.conformance import (assert_vs_oracle,
                                                 check_workload,
                                                 supported_configs)
    from repro_torch.workloads.phold import hotspot_main_path, main_path

    dev = torch.device("cuda", 0)
    # f32 products in full f32 (both are PyTorch's defaults for matmul; the
    # cuDNN one is not, and is set too).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device ---------------------------------------------------------------
    smi = nvidia_smi("name,power.limit")
    log("device", smi)
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"python {sys.version.split()[0]} "
                  f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build: one nvcc per source, all started together -------------------------
    def timed_build(name):
        t0 = time.perf_counter()
        return build.build(name), time.perf_counter() - t0

    names = ("event_apply", "ssd_scan", "flash_attention")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(timed_build, names)))
    for name, (path, secs) in built.items():
        log("build", f"{name}.cu built in {secs:.2f} s: {path.name}")
        logf = path.with_name(path.name + ".log")
        if logf.exists():
            for fn, facts in ptxas_facts(logf.read_text()):
                log("build", f"{name}: {fn}: {facts}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log("build", f"event_apply: {ea_smem(4000, 128)} B of dynamic shared "
                 f"memory per block at S=4000, C=128, {ea_ctas(4000, 128)} "
                 f"CTAs per SM ({ea_ctas(4000, 128) * sms} resident on {sms} "
                 f"SMs)")
    for bf16, kind in ((1, "bf16 tensor-core"), (0, "f32 CUDA-core")):
        log("build", f"ssd_scan: {ssd_smem(128, 64, 64, bf16)} B of dynamic "
                     f"shared memory per block, {ssd_ctas(128, 64, 64, bf16)}"
                     f" CTAs per SM at Q=128, P=N=64 ({kind} kernel; "
                     f"{4 * 64} CTAs at the serving shape on "
                     f"{torch.cuda.get_device_properties(0).multi_processor_count}"
                     f" SMs)")
    for bf16, kind in ((1, "bf16 tensor-core"), (0, "f32 CUDA-core")):
        log("build", f"flash_attention: "
                     f"{flash_lib().flash_attention_smem_bytes(128, bf16)} B "
                     f"of dynamic shared memory per block at D=128 "
                     f"({kind} kernel)")

    # 3. kernels vs plain versions ----------------------------------------------
    err = check_event_apply(dev)
    log("kernels", f"event_apply max |kernel - plain| over all outputs: {err}")
    ssd_err = check_ssd_scan(dev)
    log("kernels", f"ssd_scan max |kernel - plain| over all shapes: {ssd_err}")
    flash_err = check_flash(dev)
    log("kernels", f"flash_attention max |kernel - plain| over all shapes: "
                   f"{flash_err}")

    # 4. golden digests -----------------------------------------------------------
    for key, want in golden.PINNED.items():
        got = golden.compute_digest(key)
        if got != want:
            raise AssertionError(f"oracle digest {key} drifted: {got}")
        log("golden", f"{key} digest matches the pinned {want[:16]}")

    # 5. PHOLD's main path ------------------------------------------------------------------
    for cfg_name in ("batch-allgather", "batch-model"):
        rep = check_workload("phold", cfg_name, device=dev)
        log("main", f"phold conformance {cfg_name}: processed "
                    f"{rep['totals']['processed']}, pending {rep['pending']},"
                    f" clean, bit-exact vs oracle")

    # the main path: init + MAIN_EPOCHS_CHECKED epochs of the graphed run
    # held against the oracle, then MAIN_EPOCHS_TIMED graphed epochs timed.
    model, cfg = main_path()
    p = model.params
    for fn in KERNELS:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    eng = ParsirEngine(model, cfg, device=dev)
    if eng.graphs is None:
        raise AssertionError("the main path does not run as CUDA graphs")
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
                f"{MAIN_EPOCHS_CHECKED} epochs of the graphed run, processed "
                f"{tot['processed']}, clean, bit-exact vs oracle (engine "
                f"{t_run:.2f} s incl. warm-up and capture, oracle "
                f"{t_ref:.1f} s)")
    main_t = time_epochs(eng, st, MAIN_EPOCHS_TIMED)
    st = main_t.pop("state")
    launches = event_apply_cuda.launches
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    assert_clean(eng.totals(st), context="full-width phold (timed)")
    epochs = MAIN_EPOCHS_CHECKED + MAIN_EPOCHS_TIMED
    if launches != epochs + eng.graphs.warmup_steps or main_t["launches"] != 1:
        raise AssertionError(
            f"the main path launched event_apply {launches} times in "
            f"{epochs} epochs and {eng.graphs.warmup_steps} warm-up steps")
    if main_t["syncs"] != 0 or main_t["captures"] != 0:
        raise AssertionError(f"the timed graphed run read the host "
                             f"{main_t['syncs']} times per epoch or "
                             f"captured {main_t['captures']} graphs")
    log("main", f"kernel launches on the main path: {counts}; event_apply "
                f"{launches} = {epochs} epochs + {eng.graphs.warmup_steps} "
                f"warm-up steps before the captures; graphs captured "
                f"{eng.graphs.captures}, replayed {eng.graphs.replays}")

    # graphed against eager, the drain, the drained fixpoint.
    st = check_graphs(eng, st, "full-width PHOLD")
    main_e = time_epochs(eng, clone_state(st), GRAPH_EPOCHS, graphed=False)
    del main_e["state"]

    # phold-hotspot at the main path's width: the kernel under skew at a
    # larger C, through the graphed run, held against the oracle.
    hmodel, hcfg = hotspot_main_path()
    hp = hmodel.params
    log("build", f"event_apply at hotspot's C={hcfg.bucket_cap}: "
                 f"{ea_smem(hp.state_nodes, hcfg.bucket_cap)} B of dynamic "
                 f"shared memory per block (limit {EA_MAX_SMEM}), "
                 f"{ea_ctas(hp.state_nodes, hcfg.bucket_cap)} CTAs per SM")
    heng = ParsirEngine(hmodel, hcfg, device=dev)
    t0 = time.perf_counter()
    hst = heng.run(heng.init(), HOTSPOT_EPOCHS_CHECKED)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    htot = heng.totals(hst)
    assert_clean(htot, context="full-width phold-hotspot")
    occupancy = int(hst.cal.cnt.max())
    t0 = time.perf_counter()
    href = run_sequential(hmodel, HOTSPOT_EPOCHS_CHECKED, hcfg.epoch_len)
    t_ref = time.perf_counter() - t0
    assert_vs_oracle(heng, hst, htot, href, True, "[full-width hotspot]")
    log("main", f"full-width phold-hotspot O={hp.n_objects} "
                f"S={hp.state_nodes} hot {hp.hot_objects} objects at "
                f"{hp.hot_prob}/256, boost {hp.hot_boost}, C="
                f"{hcfg.bucket_cap}: init + {HOTSPOT_EPOCHS_CHECKED} epochs "
                f"of the graphed run, processed {htot['processed']}, clean, "
                f"bit-exact vs oracle, fullest bucket at the end "
                f"{occupancy} (engine {t_run:.2f} s, oracle {t_ref:.1f} s)")
    hst = check_graphs(heng, hst, "full-width phold-hotspot")
    hot_e = time_epochs(heng, clone_state(hst), GRAPH_EPOCHS, graphed=False)
    del hot_e["state"]
    hot_t = time_epochs(heng, hst, HOTSPOT_EPOCHS_TIMED)
    hst = hot_t.pop("state")
    assert_clean(heng.totals(hst), context="full-width phold-hotspot (timed)")
    if hot_t["launches"] != 1 or hot_t["syncs"] != 0:
        raise AssertionError("phold-hotspot's graphed run: "
                             f"{hot_t['launches']} launches and "
                             f"{hot_t['syncs']} host reads per epoch")

    for name in ("phold-hotspot", "queueing", "cluster"):
        for cfg_name in supported_configs(name):
            rep = check_workload(name, cfg_name, device=dev)
            log("main", f"{name} conformance {cfg_name}: processed "
                        f"{rep['totals']['processed']}, pending "
                        f"{rep['pending']}, clean, bit-exact vs oracle")

    # 6. timing -----------------------------------------------------------------
    log_timing("full-width PHOLD", "graphed", MAIN_EPOCHS_TIMED, main_t)
    log_timing("full-width PHOLD", "eager", GRAPH_EPOCHS, main_e)
    log_timing("full-width phold-hotspot", "graphed", HOTSPOT_EPOCHS_TIMED,
               hot_t)
    log_timing("full-width phold-hotspot", "eager", GRAPH_EPOCHS, hot_e)
    st, _ = profile_graphed(eng, st, "full-width PHOLD")
    hst, _ = profile_graphed(heng, hst, "full-width phold-hotspot")

    # one real epoch's inputs at the main path's shapes.
    _, ts_s, seed_s, _, cnt_b = extract_sorted(st.cal, st.epoch[0])
    obj = st.obj
    inputs = [obj["payload"], obj["addresses"], obj["top"], ts_s, seed_s,
              cnt_b]
    kw = dict(n_objects=p.n_objects, lookahead=p.lookahead, K=p.touch,
              KR=p.realloc_k, dist=p.dist, mean=p.mean_increment)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    ea = time_event_apply(inputs, kw, flush)
    log("timing", f"event_apply at n={p.n_objects} S={p.state_nodes} "
                  f"LANES={p.lanes} C={cfg.bucket_cap} ({ea['events']} "
                  f"events): kernel {ea['ms']:.4f} ms/launch, plain "
                  f"{ea['plain_ms']:.4f} ms, bound {ea['bound_ms']:.5f} ms "
                  f"({ea['nbytes']} B at 3.35 TB/s; {ea['flops']} flop), "
                  f"{ea['bound_ms'] / ea['ms']:.1%} of the bound, L2 flushed "
                  f"before each launch")
    skewed = _event_apply_inputs(p.n_objects, p.state_nodes, p.lanes,
                                 cfg.bucket_cap, SKEWED_CNT_HI, 7, dev,
                                 SKEWED_HEAVY)
    sk = time_event_apply(skewed, kw, flush, plain_reps=3)
    log("timing", f"event_apply on the skewed batch ({SKEWED_HEAVY} objects "
                  f"at cnt={cfg.bucket_cap}, the rest at 0-{SKEWED_CNT_HI}; "
                  f"{sk['events']} events): kernel {sk['ms']:.4f} ms/launch, "
                  f"plain {sk['plain_ms']:.4f} ms, bound {sk['bound_ms']:.5f}"
                  f" ms ({sk['nbytes']} B; {sk['flops']} flop), "
                  f"{sk['bound_ms'] / sk['ms']:.1%} of the bound")
    # one real phold-hotspot epoch's batch at its C.
    _, ts_s, seed_s, _, cnt_b = extract_sorted(hst.cal, hst.epoch[0])
    hinputs = [hst.obj["payload"], hst.obj["addresses"], hst.obj["top"],
               ts_s, seed_s, cnt_b]
    hkw = dict(kw, hot_objects=hp.hot_objects, hot_prob=hp.hot_prob)
    hea = time_event_apply(hinputs, hkw, flush, plain_reps=3)
    log("timing", f"event_apply on a phold-hotspot epoch at C="
                  f"{hcfg.bucket_cap} ({hea['events']} events, the fullest "
                  f"object at {int(cnt_b.max())}): kernel {hea['ms']:.4f} "
                  f"ms/launch, plain {hea['plain_ms']:.4f} ms, bound "
                  f"{hea['bound_ms']:.5f} ms ({hea['nbytes']} B; "
                  f"{hea['flops']} flop), "
                  f"{hea['bound_ms'] / hea['ms']:.1%} of the bound")
    del eng, heng, st, hst, hinputs, inputs, obj
    torch.cuda.empty_cache()

    # zoo. the rest of the workload zoo at the reference's bench scale -----------
    zoo_phase(dev)
    torch.cuda.empty_cache()

    # replications. PHOLD x R, event_apply at R * M rows, the campaigns -----------
    replications_phase(dev, ref, flush)
    torch.cuda.empty_cache()

    # speculation. opt_window on the main path, replicated, the drain rung ------
    speculation_phase(dev, ref)
    torch.cuda.empty_cache()

    # multidevice. the main path, loans, rebalancing, speculation over ranks --
    multidevice_phase(dev, ref)
    torch.cuda.empty_cache()

    # simulate. the CLI, rep_shards, R x D, campaigns over devices ----------
    simulate_phase(dev, ref, main_t)
    del ref
    torch.cuda.empty_cache()

    # 7. zamba2 serving ---------------------------------------------------------
    serve_reduced(dev, "zamba2-1.2b")
    serve_causal_check(dev, "zamba2-1.2b")
    model, batch, med, ssd_launches = serve_timed(dev, "zamba2-1.2b")
    serve_profile(dev, model, batch, med)
    time_masked_decode(dev, "zamba2-1.2b", flush)
    zamba_pallas_prefill(dev, model, batch)
    zamba_pallas_forward(dev, model)
    del model, batch
    torch.cuda.empty_cache()
    ssd_t = time_ssd_scan(dev, flush)["bfloat16"]

    # 7b. llama3.2-3b serving ----------------------------------------------------
    serve_reduced(dev, "llama3.2-3b")
    serve_causal_check(dev, "llama3.2-3b")
    model, batch, med, _ = serve_timed(dev, "llama3.2-3b")
    serve_profile(dev, model, batch, med)
    time_masked_decode(dev, "llama3.2-3b", flush)
    del model, batch
    torch.cuda.empty_cache()

    # 8. llama3.2-3b forward and loss ------------------------------------------------
    cfg = get_config("llama3.2-3b")
    lm_reduced(dev)
    lm_f32_check(dev, cfg)
    m, w, batch, lm_med, flash_launches = lm_timed(dev, cfg)
    lm_profile(m, w, batch, lm_med)
    del w
    bf16_spread("llama3.2-3b", m, batch["tokens"])
    del m, batch
    torch.cuda.empty_cache()
    flash_t = time_flash(dev, flush)["llama3.2-3b", "bfloat16"]

    # 9. result lines --------------------------------------------------------------
    kernels = [{
        "name": "event_apply", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/event_apply.cu",
        "replaces": "src/repro/kernels/event_apply.py:176",
        "launches": launches, "max_abs_err": err, "ms": ea["ms"],
        "plain_ms": ea["plain_ms"], "bound_ms": ea["bound_ms"],
        "bound_by": ea["bound_by"], "library_ms": None,
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:74",
        "launches": ssd_launches, "max_abs_err": ssd_err, "ms": ssd_t["ms"],
        "plain_ms": ssd_t["plain_ms"], "bound_ms": ssd_t["bound_ms"],
        "bound_by": ssd_t["bound_by"], "library_ms": None,
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:107",
        "launches": flash_launches, "max_abs_err": flash_err,
        "ms": flash_t["ms"], "plain_ms": flash_t["plain_ms"],
        "bound_ms": flash_t["bound_ms"], "bound_by": flash_t["bound_by"],
        "library_ms": flash_t["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
