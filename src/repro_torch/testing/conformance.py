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

``SWEEP`` holds the engine-config points the port supports: the
reference's single-device points, speculation among them.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..core.engine import EngineConfig, EngineState, ParsirEngine
from ..core.ref_engine import SequentialResult, run_sequential
from ..workloads.registry import conformance_spec, get_workload
from .clean import assert_clean

#: named engine-config points (EngineConfig overrides; ``epoch_len_frac``
#: scales epoch_len off the lookahead and rescales the epoch count so the
#: simulated horizon is unchanged).
SWEEP: dict[str, dict] = {
    "batch-allgather": dict(),
    "ltf": dict(scheduler="ltf"),
    "epoch-fraction": dict(epoch_len_frac=0.5),
    "batch-model": dict(batch_impl="model"),
    # a tiny tile forces many tiles per round (and round-boundary padding)
    # at conformance scale, where the default tile would be one per round.
    "batch-packed": dict(batch_impl="packed", pack_tile=4),
    # speculation (pipeline/speculate.py): windows of opt_window epochs past
    # the safe horizon commit or roll back to exactly the conservative bits,
    # so every check is unchanged.  At one device every window commits but
    # the injected ones: spec-inject forces every 2nd down the rollback
    # path; spec-global pins the global verdict beside the per-device one.
    "spec-w1": dict(opt_window=1),
    "spec-w2": dict(opt_window=2),
    "spec-w4": dict(opt_window=4),
    "spec-global": dict(opt_window=2, opt_commit="global"),
    "spec-inject": dict(opt_window=2, inject_straggler_every=2),
}


def engine_pending(eng: ParsirEngine, state: EngineState) -> np.ndarray:
    """(dst, seed) multiset of events in flight (calendar + fallback), sorted."""
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


def assert_vs_oracle(eng: ParsirEngine, st: EngineState, tot: dict,
                     ref: SequentialResult, dyadic: bool, ctx: str
                     ) -> np.ndarray:
    """Checks 2–4; returns the engine's pending records."""
    if tot["processed"] != ref.total_processed:
        raise AssertionError(f"{ctx} processed {tot['processed']} != oracle "
                             f"{ref.total_processed}")
    pend = engine_pending(eng, st)
    ref_pend = ref.pending_sorted()
    if pend.shape != ref_pend.shape:
        raise AssertionError(f"{ctx} pending count {pend.shape[0]} != "
                             f"oracle {ref_pend.shape[0]}")
    np.testing.assert_array_equal(
        pend, ref_pend, err_msg=f"{ctx} pending (dst, seed) multiset")
    if dyadic:
        want = stack_oracle_state(ref.obj_state)
        obj = eng.global_object_state(st)
        if set(want) != set(obj):
            raise AssertionError(f"{ctx} state keys {set(obj)} != "
                                 f"{set(want)}")
        for k in want:
            np.testing.assert_array_equal(
                obj[k], want[k], err_msg=f"{ctx} object state [{k}]")
    return pend


def run_conformance(model: Any, overrides: dict, *, n_epochs: int,
                    engine_kw: dict | None = None, dyadic: bool = True,
                    label: str = "", device="cuda") -> dict:
    """Run ``model`` through the port's engine under ``overrides`` and assert
    all four checks against the oracle.  Returns a report dict (totals,
    pending count, the oracle result, the engine and its final state)."""
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

    eng = ParsirEngine(model, cfg, device=device)
    ctx = (f"[{label + ': ' if label else ''}batch_impl={cfg.batch_impl} "
           f"route={cfg.route} epoch_len={cfg.epoch_len:g} "
           f"device={eng.device}]")
    st = eng.run(eng.init(), n_epochs)
    tot = eng.totals(st)
    assert_clean(tot, context=ctx)
    ref = run_sequential(model, n_epochs, cfg.epoch_len)
    pend = assert_vs_oracle(eng, st, tot, ref, dyadic, ctx)
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


def supported_configs(name: str) -> list[str]:
    """The SWEEP configs a registered workload runs under (``batch-model``
    only where it has ``process_batch``)."""
    spec = conformance_spec(name)
    return [c for c, o in SWEEP.items()
            if o.get("batch_impl") != "model" or spec["supports_batch_impl"]]


def check_workload(name: str, config: str, *, device="cuda") -> dict:
    """Conformance-check a registered workload under a named SWEEP config."""
    spec = conformance_spec(name)
    overrides = dict(SWEEP[config])
    if overrides.get("batch_impl") == "model" \
            and not spec["supports_batch_impl"]:
        raise ValueError(f"workload {name} has no process_batch: it does "
                         f"not run under {config}")
    model = get_workload(name, **spec["model_kw"])
    return run_conformance(model, overrides, n_epochs=spec["n_epochs"],
                           engine_kw=spec["engine_kw"], dyadic=spec["dyadic"],
                           label=f"{name}/{config}", device=device)
