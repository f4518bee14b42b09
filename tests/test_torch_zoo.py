"""The port's open-queueing, epidemic and wireless against the JAX package's.

* bootstrap events and initial object state for all three distributions,
  the batched ``process_events`` against ``jax.vmap(process_event)`` and the
  numpy mirrors, on seeded inputs made with numpy (bit-exact; emitted and
  state timestamps under ``exponential`` within rtol 1e-6);
* each conformance recipe under the rounds SWEEP points, bit-exact against
  ``run_sequential`` and the JAX engine;
* the three drains (``run_until_drained``) stop at the JAX ``while_loop``'s
  epoch with its bits, under the rounds, packed and ltf schedulers;
* a mid-run JAX state carried across with ``interop`` steps to the same
  bits under the three schedulers;
* the reference's behavioural cases (``tests/test_open_network.py``,
  ``tests/test_epidemic.py``, ``tests/test_wireless.py``), ported one for
  one onto the port's engine and oracle;
* ``bench_path`` equals the reference bench's ``BASE``, ``BENCH_MODEL_KW``
  and engine config, with the one dyadic cut.
"""
import os
import re
import sys

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
from repro_torch.core.events import ring_neighbor  # noqa: E402
from repro_torch.core.pipeline.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.core.ref_engine import as_emitted, run_sequential  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.testing.clean import assert_clean  # noqa: E402
from repro_torch.workloads import registry as treg  # noqa: E402
from repro_torch.workloads.epidemic import LOCAL_STEP, TRAVEL  # noqa: E402
from repro_torch.workloads.wireless import ARRIVAL, HANDOFF  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
NEW = ["open-queueing", "epidemic", "wireless"]
DISTS = ["dyadic", "uniform24", "exponential"]
#: the budgets that make each workload's arity depend on its counters.
BUDGET = {"open-queueing": dict(max_jobs=3), "epidemic": dict(),
          "wireless": dict(max_calls=5)}
IMPLS = {"rounds": dict(), "packed": dict(batch_impl="packed", pack_tile=4),
         "ltf": dict(scheduler="ltf")}


def _pair(name, **kw):
    spec = treg.conformance_spec(name)
    model_kw = dict(spec["model_kw"], **kw)
    return (treg.get_workload(name, **model_kw),
            jreg.get_workload(name, **model_kw))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    else:
        yield prefix, np.asarray(tree)
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}.{k}" if prefix else k)


def _assert_trees_equal(got, want, ctx):
    """Leaf by leaf; object-state leaves also keep their dtype (the port's
    Stats are int64, the JAX engine's int32)."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), ctx
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ctx} [{k}]")
        if k.startswith("obj."):
            assert got[k].dtype == want[k].dtype, f"{ctx} [{k}]"


# -- the models against the JAX package's ---------------------------------------

@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("name", NEW)
def test_initial_events_and_state_match(name, dist):
    t, j = _pair(name, dist=dist)
    for seed in (None, 5):
        got = t.initial_events() if seed is None else t.initial_events(seed)
        want = j.initial_events() if seed is None else j.initial_events(seed)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    gids = np.array([0, 3, 15, 15, 7, 11])
    got, want = t.init_object_state(gids, "cpu"), j.init_object_state(gids)
    assert set(got) == set(want)
    for k in want:
        assert _np(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_object_weights_match():
    for kw in (dict(), dict(n_seeds=5), dict(n_seeds=16)):
        t, j = _pair("epidemic", **kw)
        np.testing.assert_array_equal(t.object_weights(), j.object_weights())
    for kw in (dict(), dict(hot_cells=0), dict(hot_shift=3, hot_streams=4)):
        t, j = _pair("wireless", **kw)
        got, want = t.object_weights(), j.object_weights()
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


def _random_inputs(name, j, n, rng):
    """A random but well-formed batch: roles, ids and payload codes stay in
    their domains; counters small enough that zero and budget cases occur."""
    st = {k: np.asarray(v).copy()
          for k, v in j.init_object_state(np.arange(n) % j.n_objects).items()}
    for k, v in st.items():
        if k == "kind":
            st[k] = rng.integers(0, 5, n).astype(np.int32)
        elif k == "gid":
            continue
        elif v.dtype == np.float32:
            st[k] = (rng.integers(0, 1024, v.shape) / 64.0).astype(np.float32)
        elif k in ("s", "e", "i", "r"):
            st[k] = rng.integers(0, 4, n).astype(np.int32)
        else:
            st[k] = rng.integers(0, 8, n).astype(np.int32)
    ts = (rng.integers(0, 1024, n) / 64.0).astype(np.float32)
    seed = rng.integers(0, 2**32, n, dtype=np.uint32)
    if name == "open-queueing":      # the payload is a job's birth stamp
        pay = (rng.integers(0, 1024, n) / 128.0).astype(np.float32)
    else:                            # the payload is the event's type
        pay = rng.integers(0, 2, n).astype(np.float32)
    return st, ts, seed, pay


def _close(got, want, dist, ctx):
    if dist == "exponential" and want.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=ctx)
    else:
        np.testing.assert_array_equal(got, want, err_msg=ctx)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("name", NEW)
def test_process_events_matches_vmapped_jax(name, dist):
    t, j = _pair(name, dist=dist, **BUDGET[name])
    rng = np.random.default_rng(23)
    n = 64
    st, ts, seed, pay = _random_inputs(name, j, n, rng)
    for _ in range(3):   # chained: each call sees the last one's state
        tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
        got_st, got = t.process_events(
            tst, torch.from_numpy(ts), torch.from_numpy(seed.astype(np.int64)),
            torch.from_numpy(pay))
        want_st, want = jax.vmap(j.process_event)(
            {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(ts),
            jnp.asarray(seed), jnp.asarray(pay))
        assert set(got_st) == set(want_st)
        for k in want_st:
            w = np.asarray(want_st[k])
            assert got_st[k].numpy().dtype == w.dtype, k
            _close(got_st[k].numpy(), w, dist, k)
        for field in ("dst", "seed", "valid"):
            g = getattr(got, field).numpy()
            w = np.asarray(getattr(want, field))
            assert g.shape == w.shape == (n, 2), field
            if field == "seed":
                g = g.astype(np.uint32)
            np.testing.assert_array_equal(g, w, err_msg=field)
        # open-queueing's payload is a timestamp (a new job's birth stamp).
        _close(got.payload.numpy(), np.asarray(want.payload), dist, "payload")
        _close(got.ts.numpy(), np.asarray(want.ts), dist, "ts")
        valid = np.asarray(want.valid)
        assert valid.any() and not valid.all()     # the arity varies
        st = {k: np.asarray(v).copy() for k, v in want_st.items()}
        lane = rng.integers(0, 2, n)
        ts = np.array(want.ts)[np.arange(n), lane]
        seed = np.array(want.seed)[np.arange(n), lane]
        if name != "open-queueing":
            pay = np.array(want.payload)[np.arange(n), lane]


@pytest.mark.parametrize("dist", ["dyadic", "exponential"])
@pytest.mark.parametrize("name", NEW)
def test_numpy_mirrors_match(name, dist):
    t, j = _pair(name, dist=dist, **BUDGET[name])
    a_st = t.init_object_state_np(np.arange(t.n_objects))
    b_st = j.init_object_state_np(np.arange(j.n_objects))
    rng = np.random.default_rng(5)
    for _ in range(200):
        o = int(rng.integers(0, t.n_objects))
        ts = np.float32(rng.integers(0, 64) / 8)
        seed = np.uint32(rng.integers(0, 2**32))
        pay = np.float32(rng.integers(0, 2))
        a = t.process_event_np(a_st[o], ts, seed, pay)
        b = j.process_event_np(b_st[o], ts, seed, pay)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k] == y[k], k
                assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype, k
    for x, y in zip(a_st, b_st):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype


# -- the engine against the oracle and the JAX engine -------------------------------

@pytest.fixture(scope="module")
def jax_rounds():
    """The JAX engine's rounds path per (workload, epoch fraction)."""
    out = {}
    for name in NEW:
        spec = jreg.conformance_spec(name)
        model = jreg.get_workload(name, **spec["model_kw"])
        for frac in (None, 0.5):
            kw = dict(lookahead=0.5, **spec["engine_kw"])
            n = spec["n_epochs"]
            if frac is not None:
                kw["epoch_len"] = 0.5 * frac
                n = int(round(n / frac))
            eng = jeng.ParsirEngine(model, JConfig(**kw))
            st = eng.run(eng.init(), n)
            out[name, frac] = dict(totals=eng.totals(st),
                                   state=eng.global_object_state(st),
                                   pending=jengine_pending(eng, st),
                                   epoch=int(np.asarray(st.epoch)[0]))
    return out


ROUNDS_CASES = [(name, config) for name in NEW
                for config in ("batch-allgather", "epoch-fraction")]


@pytest.mark.parametrize("name,config", ROUNDS_CASES,
                         ids=[f"{n}-{c}" for n, c in ROUNDS_CASES])
def test_conformance_matches_oracle_and_jax_rounds(jax_rounds, name, config):
    rep = tconf.check_workload(name, config, device="cpu")   # vs the oracle
    eng, st = rep["engine"], rep["state"]
    want = jax_rounds[name, tconf.SWEEP[config].get("epoch_len_frac")]
    assert rep["totals"] == want["totals"]
    for k, v in want["state"].items():
        np.testing.assert_array_equal(eng.global_object_state(st)[k],
                                      np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(tconf.engine_pending(eng, st),
                                  want["pending"])
    assert int(st.epoch[0]) == want["epoch"]
    assert rep["totals"]["processed"] > 0 and rep["pending"] > 0


def test_every_sweep_point_but_the_kernel_runs_the_new_workloads():
    for name in NEW:
        assert tconf.supported_configs(name) == [
            c for c in tconf.SWEEP
            if c != "batch-model" and c not in tconf.MULTI_DEVICE]
        assert tconf.supported_configs(name, devices=2) == [
            c for c in tconf.SWEEP if c != "batch-model"]
        with pytest.raises(ValueError, match=f"{name} has no process_batch"):
            tconf.check_workload(name, "batch-model", device="cpu")


#: the reference's three draining recipes: (model kw, engine kw, bound).
DRAINS = {
    "open-queueing": (dict(n_sources=2, n_stage1=2, n_forks=2, n_stage2=2,
                           n_sinks=2, lookahead=0.5, dist="dyadic",
                           max_jobs=2), 64),
    "epidemic": (dict(n_patches=6, pop=3, n_seeds=2, trans_p=64,
                      lookahead=0.5, dist="dyadic"), 192),
    "wireless": (dict(n_cells=6, n_channels=2, max_calls=3, handoff_p=0,
                      lookahead=0.5, dist="dyadic"), 96),
}
SMALL_ENGINE = dict(n_buckets=8, bucket_cap=64, route_cap=512,
                    fallback_cap=512)


@pytest.fixture(scope="module")
def jax_drains():
    """The JAX engine's ``run_until_drained`` (its ``while_loop``) per
    draining recipe and scheduler, fetched to the host.  The schedulers
    emit in different orders, so calendar slots and the fallback differ
    between them: each port scheduler is held to the same JAX scheduler."""
    out = {}
    for name, (kw, bound) in DRAINS.items():
        for impl, over in IMPLS.items():
            eng = jeng.ParsirEngine(jreg.get_workload(name, **kw),
                                    JConfig(lookahead=0.5, **SMALL_ENGINE,
                                            **over))
            st = eng.run_until_drained(eng.init(), bound)
            assert eng.in_flight(st) == 0
            out[name, impl] = jax.device_get(st)
    for name in DRAINS:    # the same bits in every schedule but the order
        a, b = out[name, "rounds"], out[name, "ltf"]
        _assert_trees_equal(a.obj, b.obj, f"{name} JAX ltf vs rounds")
        assert np.array_equal(a.epoch, b.epoch)
    return out


DRAIN_CASES = [(n, i) for n in DRAINS for i in IMPLS]


@pytest.mark.parametrize("name,impl", DRAIN_CASES,
                         ids=[f"{n}-{i}" for n, i in DRAIN_CASES])
def test_drain_stops_at_the_jax_while_loop_epoch_with_its_bits(
        jax_drains, name, impl):
    kw, bound = DRAINS[name]
    eng = teng.ParsirEngine(treg.get_workload(name, **kw),
                            TConfig(lookahead=0.5, **SMALL_ENGINE,
                                    **IMPLS[impl]), device="cpu")
    st = eng.run_until_drained(eng.init(), bound)
    want = jax_drains[name, impl]
    drain_epoch = int(np.asarray(want.epoch)[0])
    assert eng.in_flight(st) == 0 and drain_epoch < bound
    assert int(st.epoch[0]) == drain_epoch
    _assert_trees_equal(interop.engine_state_to_numpy(st), want,
                        f"{name}/{impl} vs the JAX drain")
    # one flag read per chunk up to the drain, one bound read per epoch run.
    chunks = -(-drain_epoch // teng.DRAIN_CHUNK)
    assert eng.syncs == chunks + chunks * teng.DRAIN_CHUNK


@pytest.fixture(scope="module")
def jax_midrun():
    """Per workload: a JAX rounds state halfway through the recipe, fetched
    to the host, and two more JAX epochs from it under each scheduler."""
    out = {}
    for name in NEW:
        spec = jreg.conformance_spec(name)
        model = jreg.get_workload(name, **spec["model_kw"])
        cfg = dict(lookahead=0.5, **spec["engine_kw"])
        rounds = jeng.ParsirEngine(model, JConfig(**cfg))
        host = jax.device_get(rounds.run(rounds.init(),
                                         spec["n_epochs"] // 2))
        nxt = {}
        for impl, over in IMPLS.items():
            eng = jeng.ParsirEngine(model, JConfig(**cfg, **over))
            st = eng.run(jax.device_put(host), 2)
            nxt[impl] = dict(host=jax.device_get(st), totals=eng.totals(st),
                             state=eng.global_object_state(st),
                             pending=jengine_pending(eng, st))
        out[name] = host, nxt
    return out


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("name", NEW)
def test_interop_state_steps_to_same_bits(jax_midrun, name, impl):
    """From a mid-run JAX rounds state carried across with ``interop``, two
    port epochs under each scheduler equal two JAX epochs under the same
    scheduler, leaf by leaf (wireless's ``[n, C]`` ``free_at`` and
    open-queueing's ``kind`` included), and the JAX rounds epochs in object
    state, counters and the pending multiset."""
    spec = treg.conformance_spec(name)
    host, nxt = jax_midrun[name]
    tengine = teng.ParsirEngine(
        treg.get_workload(name, **spec["model_kw"]),
        TConfig(lookahead=0.5, **spec["engine_kw"], **IMPLS[impl]),
        device="cpu")
    tst = interop.engine_state_from_numpy(host, device="cpu")
    _assert_trees_equal(interop.engine_state_to_numpy(tst), host,
                        f"{name} carried across")
    tnext = tengine.run(tst, 2)
    _assert_trees_equal(interop.engine_state_to_numpy(tnext),
                        nxt[impl]["host"], f"{name}/{impl} after two epochs")
    want = nxt["rounds"]
    assert tengine.totals(tnext) == want["totals"]
    for key, v in want["state"].items():
        np.testing.assert_array_equal(tengine.global_object_state(tnext)[key],
                                      v, err_msg=key)
    np.testing.assert_array_equal(tconf.engine_pending(tengine, tnext),
                                  want["pending"])


def test_bench_path_matches_the_reference_bench():
    sys.path.insert(0, REPO)
    try:
        from benchmarks import pdes_perf
    finally:
        sys.path.pop(0)
    base = pdes_perf.BASE
    assert treg.BENCH_BASE == dict(n_objects=base["o"], lookahead=base["la"],
                                   dist="dyadic") and base["dist"] != "dyadic"
    assert treg.BENCH_PHOLD["initial_events"] == base["m"]
    assert treg.BENCH_PHOLD["state_nodes"] == base["s"]
    assert treg.BENCH_MODEL_KW == pdes_perf.BENCH_MODEL_KW
    child = pdes_perf._CHILD
    for key in ("n_buckets", "fallback_cap"):
        assert str(treg.BENCH_ENGINE[key]) in re.search(
            rf"{key}=([^,]+),", child).group(1), key
    assert treg.BENCH_ENGINE["route_cap"] == base["route_cap"]
    assert f'spec.get("bucket_cap", {treg.BENCH_ENGINE["bucket_cap"]})' \
        in child
    assert f'spec.get("pack_tile", {treg.BENCH_ENGINE["pack_tile"]})' in child
    assert "realloc_fraction=0.004" in child
    for name in treg.all_workloads():
        model, cfg = treg.bench_path(name)
        j = jreg.get_workload(name, **dict(
            n_objects=512, lookahead=0.5, dist="dyadic",
            **(dict(initial_events=40, state_nodes=256, realloc_fraction=0.004)
               if name.startswith("phold") else {}),
            **pdes_perf.BENCH_MODEL_KW.get(name, {})))
        assert model.params.__dict__ == j.params.__dict__, name
        assert model.n_objects == j.n_objects == 512
        assert (cfg.n_buckets, cfg.bucket_cap, cfg.route_cap,
                cfg.fallback_cap, cfg.pack_tile, cfg.lookahead) == (
                    32, 256, 8192, 16384, 64, 0.5)
    model, cfg = treg.bench_path("wireless", max_calls=4, batch_impl="packed")
    assert model.params.max_calls == 4 and cfg.batch_impl == "packed"
    model, _ = treg.bench_path("epidemic", n_objects=128, pop=8, n_seeds=16,
                               trans_p=96)
    assert (model.n_objects, model.params.pop) == (128, 8)


# -- tests/test_open_network.py, ported ----------------------------------------------

OQ_DRAIN_KW = DRAINS["open-queueing"][0]


def _engine(model, **cfg_kw):
    kw = dict(lookahead=model.params.lookahead, **SMALL_ENGINE)
    kw.update(cfg_kw)
    return teng.ParsirEngine(model, TConfig(**kw), device="cpu")


def _obj(st):
    return {k: v.numpy() for k, v in st.obj.items()}


def test_absorbing_network_drains_to_empty():
    model = treg.get_workload("open-queueing", **OQ_DRAIN_KW)
    eng = _engine(model)
    st = eng.run_until_drained(eng.init(), 64)
    tot = eng.totals(st)
    assert_clean(tot)
    assert eng.in_flight(st) == 0
    assert int(st.epoch[0]) < 64
    # flow conservation: S sources × max_jobs jobs, each forked into 2 —
    # firings(4) + stage1(4) + fork(4) + stage2(8) + sink(8).
    S, J = OQ_DRAIN_KW["n_sources"], OQ_DRAIN_KW["max_jobs"]
    jobs = S * J
    assert tot["processed"] == S * J + jobs + jobs + 2 * jobs + 2 * jobs
    obj = _obj(st)
    kind = obj["kind"]
    assert obj["count"][kind == 0].sum() == S * J         # source firings
    assert obj["count"][kind == 2].sum() == jobs          # fork passes
    assert obj["count"][kind == 4].sum() == 2 * jobs      # sink absorptions
    assert np.all(obj["sojourn"][kind == 4] >= 0)


def test_drained_network_matches_oracle_bit_exact():
    model = treg.get_workload("open-queueing", **OQ_DRAIN_KW)
    eng = _engine(model)
    st = eng.run_until_drained(eng.init(), 64)
    ref = run_sequential(model, 48, eng.cfg.epoch_len)
    assert eng.totals(st)["processed"] == ref.total_processed
    assert len(ref.pending_records) == 0
    want = tconf.stack_oracle_state(ref.obj_state)
    for k, v in want.items():
        np.testing.assert_array_equal(st.obj[k].numpy(), v,
                                      err_msg=f"object state [{k}]")


def test_max_out_traffic_overflow_is_accounted():
    model = treg.get_workload("open-queueing", n_sources=4, n_stage1=4,
                              n_forks=4, n_stage2=4, n_sinks=4, lookahead=0.5,
                              dist="dyadic")
    eng = _engine(model, route_cap=4, fallback_cap=4096)
    tot = eng.totals(eng.run(eng.init(), 16))
    assert tot["route_overflow"] > 0
    eng2 = _engine(model, route_cap=4, fallback_cap=4)
    tot2 = eng2.totals(eng2.run(eng2.init(), 16))
    assert tot2["fb_overflow"] > 0


def test_as_emitted_normalization():
    e = {"dst": 1, "ts": 2.0, "seed": 3, "payload": 0.0}
    assert as_emitted(None) == []
    assert as_emitted([]) == []
    assert as_emitted(e) == [e]
    assert as_emitted([e, e]) == [e, e]
    assert as_emitted([dict(e, valid=False), e]) == [e]
    assert as_emitted(dict(e, valid=True)) == [dict(e, valid=True)]


def test_oracle_enforces_max_out():
    class TwoOutLiar:
        n_objects = 1
        max_out = 1

        def init_object_state_np(self, gids):
            return [{} for _ in gids]

        def initial_events(self):
            return {"dst": np.zeros(1, np.int32),
                    "ts": np.zeros(1, np.float32),
                    "seed": np.zeros(1, np.uint32),
                    "payload": np.zeros(1, np.float32)}

        def process_event_np(self, st, ts, seed, payload):
            e = {"dst": 0, "ts": float(ts) + 1.0, "seed": 1, "payload": 0.0}
            return [e, dict(e, seed=2)]              # 2 events > max_out=1

    with pytest.raises(ValueError, match="max_out"):
        run_sequential(TwoOutLiar(), 4, 1.0)


def test_degenerate_role_counts_rejected():
    with pytest.raises(ValueError, match="n_objects >= 5"):
        treg.get_workload("open-queueing", n_objects=4)
    with pytest.raises(ValueError, match="n_sinks"):
        treg.get_workload("open-queueing", n_sources=1, n_stage1=1,
                          n_forks=1, n_stage2=1, n_sinks=0)
    with pytest.raises(ValueError, match="not both"):
        treg.get_workload("open-queueing", n_objects=10, n_sinks=2)


# -- tests/test_epidemic.py, ported --------------------------------------------------

BURNOUT_KW = DRAINS["epidemic"][0]


def _patch(model, **over):
    st = model.init_object_state_np(np.arange(model.n_objects))[0]
    for k, v in over.items():
        st[k] = np.int32(v)
    return st


def test_recovered_patch_local_step_emits_nothing():
    model = treg.get_workload("epidemic", **BURNOUT_KW)
    st = _patch(model, s=0, e=0, i=0, r=3)
    out = model.process_event_np(st, np.float32(1.0), np.uint32(7),
                                 np.float32(LOCAL_STEP))
    assert out == []
    assert (int(st["s"]), int(st["e"]), int(st["i"]), int(st["r"])) \
        == (0, 0, 0, 3)


def test_travel_on_depleted_patch_is_absorbed():
    model = treg.get_workload("epidemic", **BURNOUT_KW)
    st = _patch(model, s=0, e=0, i=0, r=3)
    out = model.process_event_np(st, np.float32(1.0), np.uint32(7),
                                 np.float32(TRAVEL))
    assert out == []
    assert int(st["imports"]) == 0


def test_travel_on_active_patch_seeds_but_starts_no_second_chain():
    model = treg.get_workload("epidemic", **BURNOUT_KW)
    st = _patch(model, s=2, e=1, i=1)
    out = model.process_event_np(st, np.float32(1.0), np.uint32(7),
                                 np.float32(TRAVEL))
    assert out == []
    assert int(st["imports"]) == 1 and int(st["e"]) == 2


def test_travel_on_inactive_patch_ignites_exactly_one_chain():
    model = treg.get_workload("epidemic", **BURNOUT_KW)
    st = _patch(model)
    out = model.process_event_np(st, np.float32(1.0), np.uint32(7),
                                 np.float32(TRAVEL))
    assert len(out) == 1 and float(out[0]["payload"]) == LOCAL_STEP
    assert int(out[0]["dst"]) == int(st["gid"])
    assert float(out[0]["ts"]) >= 1.0 + BURNOUT_KW["lookahead"]


def test_epidemic_burns_out_and_drains():
    model = treg.get_workload("epidemic", **BURNOUT_KW)
    eng = _engine(model)
    st = eng.run(eng.init(), 192)
    tot = eng.totals(st)
    for counter in ("cal_overflow", "fb_overflow", "route_overflow",
                    "late_events", "lookahead_violations"):
        assert tot[counter] == 0, (counter, tot)
    assert eng.in_flight(st) == 0
    obj = _obj(st)
    assert np.all(obj["e"] == 0) and np.all(obj["i"] == 0)
    np.testing.assert_array_equal(
        obj["s"] + obj["e"] + obj["i"] + obj["r"],
        np.full(model.n_objects, BURNOUT_KW["pop"]))
    ref = run_sequential(model, 192, eng.cfg.epoch_len)
    assert tot["processed"] == ref.total_processed
    assert len(ref.pending_records) == 0
    want = tconf.stack_oracle_state(ref.obj_state)
    for k in want:
        np.testing.assert_array_equal(obj[k], want[k], err_msg=f"state [{k}]")


def test_population_is_conserved_mid_flight():
    model = treg.get_workload("epidemic", n_patches=16, pop=12, n_seeds=3,
                              trans_p=128, lookahead=0.5, dist="dyadic")
    eng = _engine(model)
    obj = _obj(eng.run(eng.init(), 24))
    np.testing.assert_array_equal(
        obj["s"] + obj["e"] + obj["i"] + obj["r"],
        np.full(model.n_objects, 12))
    assert obj["imports"].sum() > 0


def test_ring_neighbor_edge_wrap():
    n = 8
    assert int(ring_neighbor(np.int32(0), 0, n)) == n - 1      # left wrap
    assert int(ring_neighbor(np.int32(n - 1), 1, n)) == 0      # right wrap
    assert int(ring_neighbor(np.int32(3), 1, n)) == 4
    g = torch.tensor([0, n - 1, 3], dtype=torch.int32)
    right = torch.tensor([False, True, False])
    np.testing.assert_array_equal(ring_neighbor(g, right, n).numpy(),
                                  [n - 1, 0, 2])


# -- tests/test_wireless.py, ported --------------------------------------------------

SCARCE_KW = dict(n_cells=8, n_channels=1, hot_cells=4, hot_shift=3,
                 hot_streams=3, handoff_p=128, lookahead=0.5, dist="dyadic")


def _cell(model, busy_until=None):
    st = model.init_object_state_np(np.arange(model.n_objects))[0]
    if busy_until is not None:
        st["free_at"][:] = np.float32(busy_until)
    return st


def test_blocked_arrival_absorbs_call_but_keeps_generator():
    model = treg.get_workload("wireless", **SCARCE_KW)
    st = _cell(model, busy_until=100.0)
    out = model.process_event_np(st, np.float32(1.0), np.uint32(7),
                                 np.float32(ARRIVAL))
    assert int(st["blocked"]) == 1 and int(st["calls"]) == 0
    assert len(out) == 1 and float(out[0]["payload"]) == ARRIVAL
    np.testing.assert_array_equal(st["free_at"], np.float32(100.0))


def test_blocked_handoff_is_dropped_and_emits_nothing():
    model = treg.get_workload("wireless", **SCARCE_KW)
    st = _cell(model, busy_until=100.0)
    out = model.process_event_np(st, np.float32(1.0), np.uint32(7),
                                 np.float32(HANDOFF))
    assert out == []
    assert int(st["dropped"]) == 1 and int(st["handoffs_in"]) == 0


def test_admission_takes_lowest_indexed_free_channel():
    model = treg.get_workload("wireless", n_cells=4, n_channels=4,
                              lookahead=0.5, dist="dyadic")
    st = _cell(model)
    st["free_at"][:] = np.float32([5.0, 0.25, 9.0, 0.125])  # 1 and 3 free
    model.process_event_np(st, np.float32(1.0), np.uint32(7),
                           np.float32(ARRIVAL))
    assert int(st["calls"]) == 1
    assert st["free_at"][1] >= np.float32(1.5)
    assert st["free_at"][3] == np.float32(0.125)
    # the batched path takes the same channel, on every row of a batch.
    tst = model.init_object_state(np.arange(2), "cpu")
    tst["free_at"][:] = torch.tensor([[5.0, 0.25, 9.0, 0.125],
                                      [0.5, 0.5, 9.0, 9.0]])
    new, _ = model.process_events(tst, torch.tensor([1.0, 1.0]),
                                  torch.tensor([7, 7]),
                                  torch.tensor([ARRIVAL, ARRIVAL]))
    depart = st["free_at"][1]
    np.testing.assert_array_equal(
        new["free_at"].numpy(),
        np.array([[5.0, depart, 9.0, 0.125], [depart, 0.5, 9.0, 9.0]],
                 np.float32))


def test_blocked_ledger_partitions_processed_events():
    model = treg.get_workload("wireless", **SCARCE_KW)
    eng = _engine(model)
    st = eng.run(eng.init(), 24)
    tot = eng.totals(st)
    for counter in ("cal_overflow", "fb_overflow", "route_overflow",
                    "late_events", "lookahead_violations"):
        assert tot[counter] == 0, (counter, tot)
    obj = _obj(st)
    assert obj["blocked"].sum() > 0
    assert obj["dropped"].sum() > 0
    np.testing.assert_array_equal(obj["arrivals"],
                                  obj["calls"] + obj["blocked"])
    np.testing.assert_array_equal(
        obj["count"],
        obj["arrivals"] + obj["handoffs_in"] + obj["dropped"])
    ref = run_sequential(model, 24, eng.cfg.epoch_len)
    want = tconf.stack_oracle_state(ref.obj_state)
    for k in want:
        np.testing.assert_array_equal(obj[k], want[k], err_msg=f"state [{k}]")


def test_exhausted_generators_drain_the_network():
    model = treg.get_workload("wireless", **DRAINS["wireless"][0])
    eng = _engine(model)
    st = eng.run_until_drained(eng.init(), 96)
    tot = eng.totals(st)
    assert eng.in_flight(st) == 0
    assert int(st.epoch[0]) < 96
    obj = _obj(st)
    np.testing.assert_array_equal(obj["arrivals"], np.full(6, 3))
    np.testing.assert_array_equal(obj["calls"] + obj["blocked"],
                                  obj["arrivals"])
    assert tot["processed"] == 6 * 3
