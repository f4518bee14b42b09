"""Differential conformance of the port's engine against the oracle.

The port's face of ``repro/testing/conformance.py``.  A run passes when

  1. every overflow/causality/lookahead counter is zero (:mod:`.clean`);
  2. its processed count equals the oracle's;
  3. the ``(dst, seed)`` multiset still parked in calendar + fallback equals
     the oracle's final event heap (with (2), this pins the processed
     multiset, since the event tree is a pure function of the seeds);
  4. for dyadic workloads, the object state equals the oracle's bit for bit.

:func:`check_workload_replicated` holds every replication of a stacked
drain to the same four checks against its own seed's oracle.

``SWEEP`` holds the reference's engine-config points, all of them.  The
multi-device points (:data:`MULTI_DEVICE`: routing across devices, loans,
weighted and adaptive placement, and speculation composed with them) also
run on one device, where their stage is the identity or degrades to the
single-device one; :func:`supported_configs` lists them only for D > 1.

Across devices every rank of a ``torch.distributed`` group runs the same
calls with ``group=``; the engine's inspection helpers gather the state to
every rank and rank 0 holds it to the oracle.  The module is also the
command line; it runs on the card unless asked for the CPU, and with
``--devices D`` spawns D ranks (gloo on the CPU)::

  PYTHONPATH=src python -m repro_torch.testing.conformance \\
      --workload phold-hotspot --devices 4 --configs all --expect-stolen \\
      --device cpu
"""
from __future__ import annotations

import argparse
import traceback
from typing import Any

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.engine import EngineConfig, EngineState, ParsirEngine
from ..core.ref_engine import SequentialResult, run_sequential
from ..workloads.registry import (all_workloads, conformance_spec,
                                  get_workload)
from .clean import assert_clean

#: named engine-config points (EngineConfig overrides; ``epoch_len_frac``
#: scales epoch_len off the lookahead and rescales the epoch count so the
#: simulated horizon is unchanged), the reference's, in its order.
SWEEP: dict[str, dict] = {
    "batch-allgather": dict(),
    "batch-a2a": dict(route="a2a"),
    "ltf": dict(scheduler="ltf"),
    "steal-allgather": dict(steal=True, steal_cap=2, claim_cap=4),
    "steal-a2a": dict(route="a2a", steal=True, steal_cap=2, claim_cap=4),
    "epoch-fraction": dict(epoch_len_frac=0.5),
    "batch-model": dict(batch_impl="model"),
    # a tiny tile forces many tiles per round (and round-boundary padding)
    # at conformance scale, where the default tile would be one per round.
    "batch-packed": dict(batch_impl="packed", pack_tile=4),
    "packed-a2a": dict(route="a2a", batch_impl="packed"),
    "steal-packed": dict(route="a2a", batch_impl="packed", pack_tile=4,
                         steal=True, steal_cap=2, claim_cap=4),
    "packed-adaptive": dict(batch_impl="packed", pack_tile=4,
                            placement="adaptive", rebalance_every=8,
                            migrate_cap=8),
    # placement: the same drained state from every packing of objects
    # onto devices (the oracle knows nothing of devices).
    "weighted": dict(placement="weighted"),
    "adaptive": dict(placement="adaptive", rebalance_every=8, migrate_cap=8),
    "adaptive-a2a": dict(route="a2a", placement="adaptive",
                         rebalance_every=8, migrate_cap=8),
    "steal-adaptive": dict(route="a2a", placement="adaptive",
                           rebalance_every=8, migrate_cap=8,
                           steal=True, steal_cap=2, claim_cap=4),
    # speculation (pipeline/speculate.py): windows of opt_window epochs past
    # the safe horizon commit or roll back to exactly the conservative bits,
    # so every check is unchanged.  spec-inject forces every 2nd window
    # down the rollback path at any device count; spec-global pins the
    # global verdict beside the per-device one; loans compose under the
    # global verdict only, adaptive placement under either.
    "spec-w1": dict(opt_window=1),
    "spec-w2": dict(opt_window=2),
    "spec-w4": dict(opt_window=4),
    "spec-a2a": dict(route="a2a", opt_window=2),
    "spec-packed-a2a": dict(route="a2a", batch_impl="packed", pack_tile=4,
                            opt_window=2),
    "spec-weighted": dict(placement="weighted", opt_window=2),
    "spec-global": dict(opt_window=2, opt_commit="global"),
    "spec-steal": dict(route="a2a", steal=True, steal_cap=2, claim_cap=4,
                       opt_window=2, opt_commit="global"),
    "spec-adaptive": dict(placement="adaptive", rebalance_every=8,
                          migrate_cap=8, opt_window=2),
    "spec-inject": dict(opt_window=2, inject_straggler_every=2),
}

#: the points whose stage only shows across devices (the reference's
#: multi-device sweep beside its single-device points).
MULTI_DEVICE: tuple[str, ...] = (
    "batch-a2a", "steal-allgather", "steal-a2a", "packed-a2a",
    "steal-packed", "packed-adaptive", "weighted", "adaptive",
    "adaptive-a2a", "steal-adaptive", "spec-a2a", "spec-packed-a2a",
    "spec-weighted", "spec-steal", "spec-adaptive")


def engine_pending(eng: ParsirEngine, state: EngineState) -> np.ndarray:
    """(dst, seed) multiset of events in flight (calendar + fallback) on
    every device, sorted (a collective across devices)."""
    state = eng.global_state(state)
    cnt = state.cal.cnt.cpu().numpy()                  # [D*M, N]
    seed = state.cal.seed.cpu().numpy()                # [D*M, N, C]
    C = seed.shape[2]
    gid, live_row = eng.global_row_of(state)
    if np.any(cnt[~live_row]):
        raise AssertionError("events parked on a pad row")
    live = np.arange(C)[None, None, :] < cnt[:, :, None]
    obj = np.broadcast_to(gid[:, None, None], live.shape)
    dsts = [obj[live].astype(np.uint64)]
    seeds = [seed[live].astype(np.uint64)]

    fbv = state.fb.events.valid.cpu().numpy()
    dsts.append(state.fb.events.dst.cpu().numpy()[fbv].astype(np.uint64))
    seeds.append(state.fb.events.seed.cpu().numpy()[fbv].astype(np.uint64))

    rec = np.stack([np.concatenate(dsts), np.concatenate(seeds)], axis=1)
    return rec[np.lexsort((rec[:, 1], rec[:, 0]))] if rec.size \
        else rec.reshape(0, 2)


def stack_oracle_state(obj_state: list[dict]) -> dict[str, np.ndarray]:
    """List-of-per-object-dicts (oracle) → dict-of-arrays (engine layout)."""
    return {k: np.stack([np.asarray(s[k]) for s in obj_state])
            for k in obj_state[0]}


def engine_result(eng: ParsirEngine, state: EngineState,
                  processed_per_object: np.ndarray) -> SequentialResult:
    """The engine's state in the oracle's form (for
    :func:`~.golden.state_digest`): the pending multiset and the object
    state gathered from every device, beside the per-object processed
    counts the caller measured (the engine keeps none)."""
    res = SequentialResult(eng.model.n_objects)
    res.processed_per_object = np.asarray(processed_per_object, np.int64)
    res.pending_records = [tuple(int(x) for x in r)
                           for r in engine_pending(eng, state)]
    obj = eng.global_object_state(state)
    res.obj_state = [{k: v[i] for k, v in obj.items()}
                     for i in range(eng.model.n_objects)]
    return res


def _gathered(eng: ParsirEngine, st: EngineState, dyadic: bool):
    """What the oracle checks read, gathered from every device (collective:
    every rank calls it)."""
    return (engine_pending(eng, st),
            eng.global_object_state(st) if dyadic else None)


def assert_vs_oracle(eng: ParsirEngine, st: EngineState, tot: dict,
                     ref: SequentialResult | None, dyadic: bool, ctx: str,
                     gathered=None) -> np.ndarray:
    """Checks 2–4; returns the engine's pending records.  Across devices
    every rank calls it (the state is gathered); ranks other than 0 pass
    ``ref=None`` and only gather."""
    pend, obj = gathered if gathered is not None else _gathered(eng, st,
                                                                dyadic)
    if ref is None:
        return pend
    if tot["processed"] != ref.total_processed:
        raise AssertionError(f"{ctx} processed {tot['processed']} != oracle "
                             f"{ref.total_processed}")
    ref_pend = ref.pending_sorted()
    if pend.shape != ref_pend.shape:
        raise AssertionError(f"{ctx} pending count {pend.shape[0]} != "
                             f"oracle {ref_pend.shape[0]}")
    np.testing.assert_array_equal(
        pend, ref_pend, err_msg=f"{ctx} pending (dst, seed) multiset")
    if dyadic:
        want = stack_oracle_state(ref.obj_state)
        if set(want) != set(obj):
            raise AssertionError(f"{ctx} state keys {set(obj)} != "
                                 f"{set(want)}")
        for k in want:
            np.testing.assert_array_equal(
                obj[k], want[k], err_msg=f"{ctx} object state [{k}]")
    return pend


def axes_of(cfg: EngineConfig, n_devices: int) -> str:
    """The sweep coordinates of an engine config, for failure messages."""
    impl = cfg.batch_impl
    if impl == "packed":
        impl += f"(tile={cfg.pack_tile})"
    opt = f"opt_window={cfg.opt_window}"
    if cfg.opt_window:
        opt += f"(commit={cfg.opt_commit})"
    return (f"scheduler={cfg.scheduler} batch_impl={impl} "
            f"route={cfg.route} steal={cfg.steal} "
            f"placement={cfg.placement} epoch_len={cfg.epoch_len:g} "
            f"{opt} D={n_devices}")


def run_conformance(model: Any, overrides: dict, *, n_epochs: int,
                    engine_kw: dict | None = None, dyadic: bool = True,
                    label: str = "", device="cuda", group=None,
                    ref: SequentialResult | None = None,
                    drain: bool = False) -> dict:
    """Run ``model`` through the port's engine under ``overrides`` and assert
    all four checks against the oracle.  Returns a report dict (totals,
    pending count, the oracle result, the engine and its final state).

    With ``group`` every rank calls it; rank 0 runs the oracle (unless
    ``ref`` is given) and checks, the others gather.  ``drain`` runs the
    horizon through ``run_until_drained`` instead of ``run``."""
    overrides = dict(overrides)
    lookahead = model.params.lookahead
    frac = overrides.pop("epoch_len_frac", None)
    kw = dict(lookahead=lookahead)
    kw.update(engine_kw or {})
    kw.update(overrides)
    if frac is not None:
        kw["epoch_len"] = lookahead * frac
        n_epochs = int(round(n_epochs / frac))
    cfg = EngineConfig(**kw)

    eng = ParsirEngine(model, cfg, device=device, group=group)
    ctx = (f"[{label + ': ' if label else ''}{axes_of(cfg, eng.D)} "
           f"device={eng.device}]")
    st = (eng.run_until_drained(eng.init(), n_epochs) if drain
          else eng.run(eng.init(), n_epochs))
    tot = eng.totals(st)
    assert_clean(tot, context=ctx)
    if cfg.placement == "adaptive" and tot["rebalances"] <= 0:
        # every device counts each firing, so the sum is firings x D.
        raise AssertionError(f"{ctx} adaptive placement never rebalanced: "
                             f"{tot}")
    # gather before rank 0 runs the oracle, so that no rank waits in a
    # collective (under its timeout) for the oracle's run.
    gathered = _gathered(eng, st, dyadic)
    if eng.rank == 0 and ref is None:
        ref = run_sequential(model, n_epochs, cfg.epoch_len)
    pend = assert_vs_oracle(eng, st, tot, ref if eng.rank == 0 else None,
                            dyadic, ctx, gathered)
    return {"totals": tot, "pending": int(pend.shape[0]), "ref": ref,
            "config": kw, "n_epochs": n_epochs, "engine": eng, "state": st}


def check_workload_replicated(name: str, config: str, *, replications: int,
                              device="cuda") -> dict:
    """Conformance-check the replicated drain (the port's face of the
    reference's ``check_workload_replicated``).

    Runs ``replications`` seeds of the workload stacked through one
    ``run_replicated_drained`` (bounded by the workload's conformance
    horizon), then holds every replication to the full contract against
    its own seeded sequential oracle: clean counters, processed count,
    pending multiset, bit-exact dyadic state.
    """
    spec = conformance_spec(name)
    overrides = dict(SWEEP[config])
    if overrides.get("batch_impl") == "model" \
            and not spec["supports_batch_impl"]:
        raise ValueError(f"workload {name} has no process_batch")
    model = get_workload(name, **spec["model_kw"])
    n_epochs = spec["n_epochs"]
    lookahead = model.params.lookahead
    frac = overrides.pop("epoch_len_frac", None)
    kw = dict(lookahead=lookahead)
    kw.update(spec["engine_kw"])
    kw.update(overrides)
    if frac is not None:
        kw["epoch_len"] = lookahead * frac
        n_epochs = int(round(n_epochs / frac))
    cfg = EngineConfig(**kw)

    eng = ParsirEngine(model, cfg, device=device)
    seeds = list(range(replications))
    st = eng.run_replicated_drained(eng.init_replicated(seeds), n_epochs)
    totals = eng.totals_replicated(st)
    processed = []
    for r, seed in enumerate(seeds):
        ctx = (f"[{name}/{config} R={replications} rep={r} seed={seed}: "
               f"batch_impl={cfg.batch_impl} device={eng.device}]")
        assert_clean(totals[r], context=ctx)
        ref = run_sequential(model, n_epochs, cfg.epoch_len, seed=seed)
        assert_vs_oracle(eng, eng.replication(st, r), totals[r], ref,
                         spec["dyadic"], ctx)
        processed.append(totals[r]["processed"])
    return {"processed": processed, "totals": totals, "config": kw,
            "n_epochs": n_epochs, "engine": eng, "state": st}


def supported_configs(name: str, devices: int = 1) -> list[str]:
    """The SWEEP configs a registered workload runs under (``batch-model``
    only where it has ``process_batch``): on one device the points that
    need no second device, on ``devices > 1`` every point."""
    spec = conformance_spec(name)
    return [c for c, o in SWEEP.items()
            if (o.get("batch_impl") != "model" or spec["supports_batch_impl"])
            and (devices > 1 or c not in MULTI_DEVICE)]


def check_workload(name: str, config: str, *, device="cuda", group=None,
                   ref_cache: dict | None = None,
                   model_overrides: dict | None = None,
                   engine_overrides: dict | None = None,
                   drain: bool = False) -> dict:
    """Conformance-check a registered workload under a named SWEEP config
    (on every rank of ``group`` together).  ``ref_cache`` keeps the
    oracle's runs across configs of one sweep."""
    spec = conformance_spec(name)
    overrides = dict(SWEEP[config])
    if overrides.get("batch_impl") == "model" \
            and not spec["supports_batch_impl"]:
        raise ValueError(f"workload {name} has no process_batch: it does "
                         f"not run under {config}")
    model = get_workload(name, **dict(spec["model_kw"],
                                      **(model_overrides or {})))
    engine_kw = dict(spec["engine_kw"], **(engine_overrides or {}))
    key = ref = None
    if ref_cache is not None:
        # the oracle depends on the workload and horizon, not the config.
        key = (name, spec["n_epochs"], overrides.get("epoch_len_frac"),
               tuple(sorted((model_overrides or {}).items())),
               tuple(sorted((engine_overrides or {}).items())))
        ref = ref_cache.get(key)
    report = run_conformance(model, overrides, n_epochs=spec["n_epochs"],
                             engine_kw=engine_kw, dyadic=spec["dyadic"],
                             label=f"{name}/{config}", device=device,
                             group=group, ref=ref, drain=drain)
    if ref_cache is not None and report["ref"] is not None:
        ref_cache[key] = report["ref"]
    return report


def sweep_rank(rank: int, group, workloads: list[str], configs: list[str],
               device="cpu", drain: bool = False,
               model_overrides: dict | None = None,
               engine_overrides: dict | None = None) -> dict:
    """One rank of a sweep (run by :func:`~..core.dist.spawn`, or as rank 0
    with no group): ``check_workload`` of every (workload, config) the
    workload supports, the oracle's runs kept across a workload's configs.
    Returns ``{(workload, config): {"totals", "pending"}}``, or ``{"error":
    traceback}`` for a config that failed (the failure is on every rank
    alike, or only in rank 0's oracle check after the collectives, so the
    ranks stay in step)."""
    if group is not None:
        torch.set_num_threads(1)        # the ranks share the host's cores
    out = {}
    for name in workloads:
        ref_cache: dict = {}
        impl_ok = conformance_spec(name)["supports_batch_impl"]
        for config in configs:
            if SWEEP[config].get("batch_impl") == "model" and not impl_ok:
                continue
            try:
                rep = check_workload(name, config, device=device,
                                     group=group, ref_cache=ref_cache,
                                     drain=drain,
                                     model_overrides=model_overrides,
                                     engine_overrides=engine_overrides)
                out[name, config] = {"totals": rep["totals"],
                                     "pending": rep["pending"]}
            except Exception:                   # noqa: BLE001 (reported)
                out[name, config] = {"error": traceback.format_exc()}
    return out


def check_expectations(results: dict[str, dict], devices: int, *,
                       stolen: bool = False, rollbacks: bool = False,
                       rebalances: int = 0) -> None:
    """The sweep's negative-path assertions, as the reference's CLI makes
    them: loans engaged (summed over steal configs), a window rolled back
    (summed over speculating configs), every adaptive config fired at least
    ``rebalances`` times (its counter sums firings x D)."""
    n_stolen = sum(r["totals"]["stolen"] for c, r in results.items()
                   if SWEEP[c].get("steal"))
    n_rb = sum(r["totals"]["rollbacks"] for c, r in results.items()
               if SWEEP[c].get("opt_window"))
    if stolen and n_stolen <= 0:
        raise AssertionError("stealing never engaged across steal configs")
    if rollbacks and n_rb <= 0:
        raise AssertionError("no speculation window ever rolled back "
                             "across opt_window configs")
    for c, r in results.items():
        if SWEEP[c].get("placement") == "adaptive" and rebalances:
            fired = r["totals"]["rebalances"] // devices
            if fired < rebalances:
                raise AssertionError(f"{c}: rebalance fired {fired} < "
                                     f"{rebalances} times")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, choices=all_workloads())
    ap.add_argument("--configs", default="batch-allgather",
                    help="comma-separated SWEEP names, or 'all'")
    ap.add_argument("--devices", type=int, default=1,
                    help="spawn this many ranks (one device each: gloo on "
                         "the CPU, NCCL with a card per rank, else gloo "
                         "ranks sharing the card)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--expect-stolen", action="store_true",
                    help="assert stats.stolen > 0 summed over steal configs")
    ap.add_argument("--expect-rebalances", type=int, default=0, metavar="N",
                    help="assert every adaptive config fired the rebalance "
                         "stage at least N times")
    ap.add_argument("--expect-rollbacks", action="store_true",
                    help="assert stats.rollbacks > 0 summed over "
                         "speculating configs")
    ap.add_argument("--drain", action="store_true",
                    help="run each config through run_until_drained "
                         "bounded by the workload's horizon")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds before a hung sweep is killed")
    args = ap.parse_args(argv)

    names = (supported_configs(args.workload, args.devices)
             if args.configs == "all" else args.configs.split(","))
    unknown = [c for c in names if c not in SWEEP]
    if unknown:
        ap.error(f"unknown config(s) {unknown}; choose from {list(SWEEP)}")
    spec = conformance_spec(args.workload)
    skipped = [c for c in names if SWEEP[c].get("batch_impl") == "model"
               and not spec["supports_batch_impl"]]
    for c in skipped:
        print(f"SKIP {args.workload} {c} (no process_batch)")
    names = [c for c in names if c not in skipped]
    dev = resolve_device(args.device)
    if args.devices > 1:
        # one card per rank over NCCL where there are enough cards, else
        # gloo ranks sharing the device (on a card, host-staged).
        from ..core.dist import spawn
        nccl = dev.type == "cuda" and \
            torch.cuda.device_count() >= args.devices
        results = spawn(sweep_rank, args.devices, [args.workload], names,
                        "cuda" if nccl else str(dev), args.drain,
                        backend="nccl" if nccl else "gloo",
                        timeout=min(args.timeout, 300.0),
                        join_timeout=args.timeout)[0]
    else:
        results = sweep_rank(0, None, [args.workload], names, dev,
                             args.drain)
    failed = [c for (_, c), r in results.items() if "error" in r]
    for (name, c), r in results.items():
        if "error" in r:
            print(f"FAIL {name} {c}\n{r['error']}")
            continue
        tot = r["totals"]
        print(f"OK {name} {c} D={args.devices} "
              f"processed={tot['processed']} pending={r['pending']} "
              f"stolen={tot['stolen']} rebalances={tot['rebalances']} "
              f"migrated={tot['migrated']} rollbacks={tot['rollbacks']} "
              f"speculated={tot['speculated']}")
    if failed:
        print(f"CONFORMANCE FAIL: {', '.join(failed)}")
        return 1
    check_expectations({c: r for (_, c), r in results.items()},
                       args.devices, stolen=args.expect_stolen,
                       rollbacks=args.expect_rollbacks,
                       rebalances=args.expect_rebalances)
    print("CONFORMANCE PASS")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
