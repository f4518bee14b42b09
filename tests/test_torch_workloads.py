"""The port's zoo beyond PHOLD (phold-hotspot, queueing, cluster) against
the JAX package's.

* bootstrap events, initial object state, the batched ``process_events``
  against ``jax.vmap(process_event)`` and the numpy mirrors, on seeded
  inputs made with numpy (bit-exact; emitted timestamps under
  ``exponential`` within rtol 1e-6);
* each conformance recipe through the port's engine, bit-exact against
  ``run_sequential`` and the JAX engine's rounds path under every SWEEP
  config the workload supports (the JAX ``batch-model`` path fails on the
  installed jax, so hotspot's ``batch-model`` is held to the JAX rounds
  bits, equal on dyadic workloads);
* a mid-run JAX state carried across with ``interop`` steps to the same
  bits;
* the registry, the recipes and the medium golden sizes equal the JAX
  package's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.pipeline.config import EngineConfig as JConfig  # noqa: E402
from repro.testing import golden as jgolden  # noqa: E402
from repro.testing.conformance import engine_pending as jengine_pending  # noqa: E402
from repro.workloads import registry as jreg  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.pipeline.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.testing import golden as tgolden  # noqa: E402
from repro_torch.workloads import registry as treg  # noqa: E402

NEW = ["phold-hotspot", "queueing", "cluster"]


def _pair(name, **kw):
    spec = treg.conformance_spec(name)
    model_kw = dict(spec["model_kw"], **kw)
    return (treg.get_workload(name, **model_kw),
            jreg.get_workload(name, **model_kw))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_registry_and_recipes_match_jax():
    assert treg.all_workloads() == jreg.all_workloads()
    for name in treg.all_workloads():
        assert treg.WORKLOADS[name] == jreg.WORKLOADS[name]
        assert treg.conformance_spec(name) == jreg.conformance_spec(name)
        assert tgolden.MEDIUM_SIZES[name] == jgolden.MEDIUM_SIZES[name]


DISTS = ["dyadic", "uniform24", "exponential"]


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
    gids = np.array([0, 3, 15, 15, 7])
    got, want = t.init_object_state(gids, "cpu"), j.init_object_state(gids)
    assert set(got) == set(want)
    for k in want:
        assert _np(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_object_weights_match():
    for kw in (dict(), dict(hot_prob=0), dict(hot_objects=6, hot_boost=1)):
        t, j = _pair("phold-hotspot", **kw)
        np.testing.assert_array_equal(t.object_weights(), j.object_weights())
    for kw in (dict(), dict(hot_objects=4, hot_prob=100)):
        t, j = _pair("phold", **kw)
        got, want = t.object_weights(), j.object_weights()
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)


def _random_inputs(name, j, n, rng):
    st = j.init_object_state(np.arange(n) % j.n_objects)
    st = {k: np.asarray(v).copy() for k, v in st.items()}
    for k, v in st.items():
        if v.dtype == np.float32 and v.ndim == 1:
            st[k] = (rng.integers(0, 1024, n) / 64.0).astype(np.float32)
        elif v.dtype == np.float32:
            st[k] = (rng.integers(0, 4096, v.shape) / 1024.0).astype(
                np.float32)
        elif v.ndim == 1 and k != "top":
            st[k] = rng.integers(0, 50, n).astype(v.dtype)
    ts = (rng.integers(0, 1024, n) / 64.0).astype(np.float32)
    seed = rng.integers(0, 2**32, n, dtype=np.uint32)
    if name == "cluster":   # the payload is the holder's node id
        pay = rng.integers(0, j.n_objects, n).astype(np.float32)
    else:
        pay = (rng.integers(0, 1024, n) / 8.0).astype(np.float32)
    return st, ts, seed, pay


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("name", NEW)
def test_process_events_matches_vmapped_jax(name, dist):
    t, j = _pair(name, dist=dist)
    rng = np.random.default_rng(17)
    n = 24
    st, ts, seed, pay = _random_inputs(name, j, n, rng)
    for _ in range(3):   # chained: each call sees the last one's state
        tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
        got_st, got = t.process_events(
            tst, torch.from_numpy(ts), torch.from_numpy(seed.astype(np.int64)),
            torch.from_numpy(pay))
        want_st, want = jax.vmap(j.process_event)(
            {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(ts),
            jnp.asarray(seed), jnp.asarray(pay))
        for k in want_st:
            w = np.asarray(want_st[k])
            assert got_st[k].numpy().dtype == w.dtype, k
            if dist == "exponential" and w.dtype == np.float32:
                np.testing.assert_allclose(got_st[k].numpy(), w, rtol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(got_st[k].numpy(), w,
                                              err_msg=k)
        for field in ("dst", "seed", "payload", "valid"):
            g = getattr(got, field).numpy()
            if field == "seed":
                g = g.astype(np.uint32)
            np.testing.assert_array_equal(g, np.asarray(getattr(want, field)),
                                          err_msg=field)
        if dist == "exponential":
            np.testing.assert_allclose(got.ts.numpy(), np.asarray(want.ts),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(got.ts.numpy(), np.asarray(want.ts))
        st = {k: np.asarray(v).copy() for k, v in want_st.items()}
        ts = np.array(want.ts)[:, 0]
        seed = np.array(want.seed)[:, 0]
        pay = np.array(want.payload)[:, 0]


@pytest.mark.parametrize("dist", ["dyadic", "exponential"])
@pytest.mark.parametrize("name", NEW)
def test_numpy_mirrors_match(name, dist):
    t, j = _pair(name, dist=dist)
    a_st = t.init_object_state_np(np.arange(4))
    b_st = j.init_object_state_np(np.arange(4))
    rng = np.random.default_rng(5)
    for _ in range(30):
        o = int(rng.integers(0, 4))
        ts = np.float32(rng.integers(0, 64) / 8)
        seed = np.uint32(rng.integers(0, 2**32))
        pay = np.float32(rng.integers(0, j.n_objects))
        a = t.process_event_np(a_st[o], ts, seed, pay)
        b = j.process_event_np(b_st[o], ts, seed, pay)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == b[k], k
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    for x, y in zip(a_st, b_st):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
            assert np.asarray(x[k]).dtype == np.asarray(y[k]).dtype


@pytest.fixture(scope="module")
def jax_rounds():
    """The JAX engine's rounds path per (workload, SWEEP config), run once."""
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


#: the conservative SWEEP points (the speculative ones are held to the
#: oracle and to the JAX engine under the same config in
#: test_torch_spec_conformance.py and test_torch_speculation.py).
CASES = [(name, config) for name in NEW
         for config in tconf.supported_configs(name)
         if not tconf.SWEEP[config].get("opt_window")]


@pytest.mark.parametrize("name,config", CASES,
                         ids=[f"{n}-{c}" for n, c in CASES])
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


def test_check_workload_refuses_batch_model_by_name():
    for name in ("queueing", "cluster"):
        assert "batch-model" not in tconf.supported_configs(name)
        with pytest.raises(ValueError, match=f"{name} has no process_batch"):
            tconf.check_workload(name, "batch-model", device="cpu")
    assert "batch-model" in tconf.supported_configs("phold-hotspot")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}.{k}" if prefix else k)


@pytest.mark.parametrize("name", NEW)
def test_interop_state_steps_to_same_bits(name):
    """Rounds in both engines from a mid-run JAX state: the whole state
    tree is equal after two steps; hotspot's kernel path from the same
    state gives the same object state, counters and pending multiset."""
    spec = jreg.conformance_spec(name)
    model_kw = spec["model_kw"]
    jengine = jeng.ParsirEngine(jreg.get_workload(name, **model_kw),
                                JConfig(lookahead=0.5, **spec["engine_kw"]))
    jst = jengine.run(jengine.init(), spec["n_epochs"] // 2)
    host = jax.device_get(jst)
    impls = ["rounds"] + (["model"] if spec["supports_batch_impl"] else [])
    jnext = jengine.run(jst, 2)
    want = dict(_leaves(jax.device_get(jnext)))
    for impl in impls:
        tengine = teng.ParsirEngine(
            treg.get_workload(name, **model_kw),
            TConfig(lookahead=0.5, batch_impl=impl, **spec["engine_kw"]),
            device="cpu")
        tst = interop.engine_state_from_numpy(host, device="cpu")
        tnext = tengine.run(tst, 2)
        assert tengine.totals(tnext) == jengine.totals(jnext)
        if impl == "rounds":
            got = dict(_leaves(interop.engine_state_to_numpy(tnext)))
            assert set(got) == set(want)
            for leaf in want:
                np.testing.assert_array_equal(got[leaf], np.asarray(want[leaf]),
                                              err_msg=f"{impl} {leaf}")
        for k, v in jengine.global_object_state(jnext).items():
            np.testing.assert_array_equal(
                tengine.global_object_state(tnext)[k], v, err_msg=k)
        np.testing.assert_array_equal(tconf.engine_pending(tengine, tnext),
                                      jengine_pending(jengine, jnext))
