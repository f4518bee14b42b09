"""The port's fused loops (``run``, ``run_until_drained``) on the CPU.

The port of ``tests/test_fused_drain.py``: on the CPU both loops run the
semantics the card replays as CUDA graphs (chunks of ``DRAIN_CHUNK`` gated
epochs, one in-flight read per chunk).  For every registered workload and
each ``batch_impl`` it supports:

* ``run_until_drained(init, n)`` equals ``run(init, n)`` and the JAX
  engine's ``run_until_drained``, leaf by leaf, ``Stats`` and ``epoch``
  included (the JAX ``batch-model`` path fails on the installed jax, so the
  port's kernel path is held to the JAX rounds bits: object state, counters,
  epoch and pending multiset);
* the bound runs exactly ``max_epochs`` epochs, and a workload that drains
  stops at its drain epoch, equal to the oracle there;
* the gated step at a cleared state is a fixpoint, epoch included, and a
  drain that empties stops with the eager steps' state at that epoch;
* ``dispatches`` counts as the JAX engine does; ``syncs`` for a drain of n
  epochs is ``ceil(n / DRAIN_CHUNK)`` (plus one per epoch under rounds);
* ``check_stats_bound`` raises where the JAX engine's would at an int64 cap.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.pipeline.config import EngineConfig as JConfig  # noqa: E402
from repro.testing.conformance import engine_pending as jengine_pending  # noqa: E402
from repro.workloads import registry as jreg  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import graphs as tgraphs  # noqa: E402
from repro_torch.core.events import empty_batch  # noqa: E402
from repro_torch.core.pipeline.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.core.ref_engine import run_sequential  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.workloads import registry as treg  # noqa: E402
from repro_torch.workloads.cluster import ClusterModel, ClusterParams  # noqa: E402

K = teng.DRAIN_CHUNK
CASES = [(name, impl) for name in treg.all_workloads()
         for impl in (("rounds", "model")
                      if treg.conformance_spec(name)["supports_batch_impl"]
                      else ("rounds",))]
IDS = [f"{n}-{i}" for n, i in CASES]


def _port(name, impl="rounds", **cfg_kw):
    spec = treg.conformance_spec(name)
    model = treg.get_workload(name, **spec["model_kw"])
    cfg = TConfig(lookahead=model.params.lookahead, batch_impl=impl,
                  **dict(spec["engine_kw"], **cfg_kw))
    return teng.ParsirEngine(model, cfg, device="cpu"), spec


def _host(state):
    return interop.engine_state_to_numpy(state)


def _tree(state):
    """(dotted name, array) of every leaf of a host state tree."""
    out = {}

    def walk(x, prefix):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{prefix}.{k}")
        elif hasattr(x, "_fields"):
            for f in x._fields:
                walk(getattr(x, f), f"{prefix}.{f}" if prefix else f)
        else:
            out[prefix] = np.asarray(x)
    walk(state, "")
    return out


def _assert_trees_equal(a, b, ctx):
    ta, tb = _tree(a), _tree(b)
    assert set(ta) == set(tb), ctx
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=f"{ctx} [{k}]")


@pytest.fixture(scope="module")
def jax_drains():
    """The JAX engine's run_until_drained per workload (rounds), its
    dispatch count after init + step + run + run_until_drained, and
    whether the run drained."""
    out = {}
    for name in treg.all_workloads():
        spec = jreg.conformance_spec(name)
        model = jreg.get_workload(name, **spec["model_kw"])
        eng = jeng.ParsirEngine(model, JConfig(lookahead=0.5,
                                               **spec["engine_kw"]))
        st = eng.run_until_drained(eng.init(), spec["n_epochs"])
        out[name] = dict(host=jax.device_get(st), totals=eng.totals(st),
                         state=eng.global_object_state(st),
                         pending=jengine_pending(eng, st),
                         in_flight=eng.in_flight(st))
        d0 = eng.dispatches
        s = eng.step(eng.init())
        s = eng.run(s, 2)
        eng.run_until_drained(s, 3)
        out[name]["dispatches"] = eng.dispatches - d0
    return out


@pytest.mark.parametrize("name,impl", CASES, ids=IDS)
def test_drain_equals_run_and_jax_drain(jax_drains, name, impl):
    eng, spec = _port(name, impl)
    n = spec["n_epochs"]
    a = eng.run(eng.init(), n)
    b = eng.run_until_drained(eng.init(), n)
    assert eng.in_flight(b) > 0        # none of these workloads drains
    _assert_trees_equal(_host(a), _host(b), f"{name}/{impl} run vs drain")
    want = jax_drains[name]
    assert want["in_flight"] == eng.in_flight(b)
    assert eng.totals(b) == want["totals"]
    assert int(b.epoch[0]) == int(np.asarray(want["host"].epoch)[0]) == n
    if impl == "rounds":
        _assert_trees_equal(_host(b), want["host"], f"{name} vs JAX drain")
    for k, v in want["state"].items():
        np.testing.assert_array_equal(eng.global_object_state(b)[k], v,
                                      err_msg=k)
    np.testing.assert_array_equal(tconf.engine_pending(eng, b),
                                  want["pending"])


@pytest.mark.parametrize("name,impl", CASES, ids=IDS)
def test_dispatches_match_jax_and_syncs_count_chunks(jax_drains, name, impl):
    eng, _ = _port(name, impl)
    s = eng.step(eng.init())
    s = eng.run(s, 2)
    eng.run_until_drained(s, 3)
    assert eng.dispatches == jax_drains[name]["dispatches"] == 4
    per_epoch = 1 if impl == "rounds" else 0
    for n in (1, K, K + 1, 2 * K + 3):
        eng, _ = _port(name, impl)
        st = eng.init()
        eng.run_until_drained(st, n)
        assert eng.syncs == -(-n // K) + per_epoch * n, n


def test_bound_runs_exactly_max_epochs():
    eng, _ = _port("phold", "model")
    a = eng.run(eng.init(), K + 5)
    b = eng.run_until_drained(eng.init(), K + 5)
    assert eng.in_flight(b) > 0 and int(b.epoch[0]) == K + 5
    _assert_trees_equal(_host(a), _host(b), "phold bound")


def _cleared(state):
    """``state`` with an empty calendar and fallback (a drained state)."""
    cal = state.cal._replace(cnt=torch.zeros_like(state.cal.cnt),
                             ts=torch.full_like(state.cal.ts, float("inf")))
    fb = state.fb._replace(events=empty_batch(state.fb.cap, device="cpu"))
    return state._replace(cal=cal, fb=fb)


@pytest.mark.parametrize("name,impl", CASES, ids=IDS)
def test_gated_step_is_a_fixpoint_at_a_cleared_state(name, impl):
    eng, spec = _port(name, impl)
    st = _cleared(eng.run(eng.init(), 5))
    before = _host(st)
    after = eng._gated(tgraphs.clone_state(st))
    _assert_trees_equal(_host(after), before, f"{name}/{impl} gated step")
    syncs = eng.syncs
    drained = eng.run_until_drained(st, 3 * K)
    _assert_trees_equal(_host(drained), before, f"{name}/{impl} drain")
    # one flag read; under rounds also one round-count read per epoch
    assert eng.syncs - syncs == 1 + (K if impl == "rounds" else 0)
    # the ungated step advances the epoch all the same
    assert int(eng._step(_cleared(tgraphs.clone_state(st))).epoch[0]) == 6


class _DyingRing(ClusterModel):
    """The token ring whose tokens die at simulated time ``horizon`` — a
    workload that drains."""

    horizon = 12.0

    def process_events(self, state, ts, seed, payload):
        st, out = super().process_events(state, ts, seed, payload)
        return st, out._replace(valid=out.valid & (out.ts < self.horizon))

    def process_event_np(self, st, ts, seed, payload):
        out = super().process_event_np(st, ts, seed, payload)
        out["valid"] = bool(out["ts"] < np.float32(self.horizon))
        return out


def test_drain_stops_at_the_drain_epoch_and_equals_the_oracle():
    spec = treg.conformance_spec("cluster")
    model = _DyingRing(ClusterParams(**spec["model_kw"]))
    cfg = TConfig(lookahead=0.5, **spec["engine_kw"])
    eng = teng.ParsirEngine(model, cfg, device="cpu")
    n = 200
    a = eng.run(eng.init(), n)
    syncs = eng.syncs
    b = eng.run_until_drained(eng.init(), n)
    assert eng.in_flight(a) == eng.in_flight(b) == 0
    drain_epoch = int(b.epoch[0])
    assert 0 < drain_epoch < n and int(a.epoch[0]) == n
    # one read per chunk up to the chunk the drain falls in, one round-count
    # read per epoch run
    chunks = -(-drain_epoch // K)
    assert eng.syncs - syncs == chunks + chunks * K
    # the eager steps stopped where the events ran out: every leaf equal,
    # the fallback's empty slots included
    st = eng.init()
    while eng.in_flight(st):
        st = eng.step(st)
    _assert_trees_equal(_host(st), _host(b), "dying ring drain vs steps")
    # against run past the drain: equal but for the epoch and the fields of
    # the fallback's empty slots
    ha, hb = _tree(_host(a)), _tree(_host(b))
    for k in ha:
        if k != "epoch" and not (k.startswith("fb.") and k != "fb.events.valid"):
            np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)
    assert eng.totals(a) == eng.totals(b)
    ref = run_sequential(model, drain_epoch, cfg.epoch_len)
    assert eng.totals(b)["processed"] == ref.total_processed
    assert not ref.pending_records
    want = tconf.stack_oracle_state(ref.obj_state)
    for k, v in eng.global_object_state(b).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("name", treg.all_workloads())
def test_check_stats_bound_matches_jax_at_an_int64_cap(name, monkeypatch):
    monkeypatch.setattr(jeng, "stats_dtype", lambda: jnp.int64)
    spec = jreg.conformance_spec(name)
    model = jreg.get_workload(name, **spec["model_kw"])
    jengine = jeng.ParsirEngine(model, JConfig(lookahead=0.5,
                                               **spec["engine_kw"]))
    teng_, _ = _port(name)
    per_epoch = max(teng_.placement.n_local_max * teng_.cfg.bucket_cap,
                    teng_.cfg.route_cap, teng_.cfg.fallback_cap)
    top = np.iinfo(np.int64).max // per_epoch
    for n in (1, top - 1, top, top + 1, 2 * top):
        outcomes = []
        for check in (jengine.check_stats_bound, teng_.check_stats_bound):
            try:
                check(n)
                outcomes.append("ok")
            except ValueError:
                outcomes.append("raise")
        assert outcomes[0] == outcomes[1] == ("raise" if n > top else "ok"), n
    st = teng_.init()
    with pytest.raises(ValueError, match="int64 Stats"):
        teng_.run(st, top + 1)
    with pytest.raises(ValueError, match="int64 Stats"):
        teng_.run_until_drained(st, top + 1)
