"""The port's engine at D=1 against the JAX engine and the oracles.

* the ``phold`` conformance recipe and the ``phold/medium`` golden size under
  ``batch_impl`` rounds and model: bit-exact against
  ``repro.core.engine.ParsirEngine.run`` (rounds — the JAX Pallas path is
  not used) and against ``repro.core.ref_engine.run_sequential``;
* the port's own oracle reproduces the pinned golden digests;
* a JAX state carried across with ``interop`` steps to the same bits;
* ``EngineConfig`` accepts and rejects what the JAX config does.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.pipeline import names as jnames  # noqa: E402
from repro.core.pipeline.config import EngineConfig as JConfig  # noqa: E402
from repro.core.ref_engine import run_sequential as jrun_sequential  # noqa: E402
from repro.testing import golden as jgolden  # noqa: E402
from repro.testing.conformance import engine_pending as jengine_pending  # noqa: E402
from repro.workloads.registry import conformance_spec, get_workload  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.pipeline import base as tbase  # noqa: E402
from repro_torch.core.pipeline import names as tnames  # noqa: E402
from repro_torch.core.pipeline.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.testing import golden as tgolden  # noqa: E402
from repro_torch.workloads import registry as treg  # noqa: E402

SIZES = {"small": (dict(), None),
         "medium": jgolden.MEDIUM_SIZES["phold"]}


def _setup(size):
    spec = conformance_spec("phold")
    over, n_epochs = SIZES[size]
    model_kw = dict(spec["model_kw"], **over)
    return model_kw, n_epochs or spec["n_epochs"], spec["engine_kw"]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX engine (rounds) + JAX-package oracle per size, computed once."""
    out = {}
    for size in SIZES:
        model_kw, n_epochs, engine_kw = _setup(size)
        model = get_workload("phold", **model_kw)
        eng = jeng.ParsirEngine(model, JConfig(lookahead=0.5, **engine_kw))
        st = eng.run(eng.init(), n_epochs)
        out[size] = dict(totals=eng.totals(st),
                         state=eng.global_object_state(st),
                         pending=jengine_pending(eng, st),
                         ref=jrun_sequential(model, n_epochs, 0.5))
    return out


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("batch_impl", ["rounds", "model"])
def test_phold_matches_jax_engine_and_oracles(jax_runs, size, batch_impl):
    model_kw, n_epochs, engine_kw = _setup(size)
    model = treg.get_workload("phold", **model_kw)
    rep = tconf.run_conformance(model, dict(batch_impl=batch_impl),
                                n_epochs=n_epochs, engine_kw=engine_kw,
                                device="cpu", label=f"phold/{size}")
    eng, st, tot = rep["engine"], rep["state"], rep["totals"]
    want = jax_runs[size]
    assert tot == want["totals"]
    obj = eng.global_object_state(st)
    for k, v in want["state"].items():
        np.testing.assert_array_equal(obj[k], v, err_msg=k)
    np.testing.assert_array_equal(tconf.engine_pending(eng, st),
                                  want["pending"])
    # the JAX package's oracle agrees with the port's oracle copy
    ref = want["ref"]
    assert rep["ref"].total_processed == ref.total_processed
    np.testing.assert_array_equal(rep["ref"].pending_sorted(),
                                  ref.pending_sorted())
    assert eng.syncs == (n_epochs if batch_impl == "rounds" else 0)


@pytest.mark.parametrize("config", list(tconf.SWEEP))
def test_conformance_sweep(config):
    rep = tconf.check_workload("phold", config, device="cpu")
    assert rep["totals"]["processed"] > 0 and rep["pending"] > 0


def test_run_until_drained_matches_run():
    spec = treg.conformance_spec("phold")
    model = treg.get_workload("phold", **spec["model_kw"])
    cfg = TConfig(lookahead=0.5, batch_impl="model", **spec["engine_kw"])
    eng = teng.ParsirEngine(model, cfg, device="cpu")
    a = eng.run(eng.init(), 10)
    eng2 = teng.ParsirEngine(model, cfg, device="cpu")
    b = eng2.run_until_drained(eng2.init(), 10)
    # one in-flight read per chunk of DRAIN_CHUNK epochs
    assert eng2.syncs == -(-10 // teng.DRAIN_CHUNK) == 1
    assert eng.totals(a) == eng2.totals(b)
    np.testing.assert_array_equal(a.obj["payload"].numpy(),
                                  b.obj["payload"].numpy())
    assert eng.in_flight(a) == eng2.in_flight(b) > 0


@pytest.mark.parametrize("key", sorted(tgolden.PINNED))
def test_port_oracle_reproduces_golden_digests(key):
    pinned = jgolden.load_digests()
    assert tgolden.PINNED[key] == pinned[key]
    assert tgolden.compute_digest(key) == pinned[key]


def _leaves(tree, prefix=""):
    """(dotted name, array) for every leaf of a NamedTuple/dict tree."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}.{k}" if prefix else k)


def _jax_state_after(k):
    spec = conformance_spec("phold")
    jcfg = JConfig(lookahead=0.5, **spec["engine_kw"])
    jengine = jeng.ParsirEngine(get_workload("phold", **spec["model_kw"]),
                                jcfg)
    return jengine, jengine.run(jengine.init(), k)


def _port_engine(batch_impl):
    spec = treg.conformance_spec("phold")
    tcfg = TConfig(lookahead=0.5, batch_impl=batch_impl, **spec["engine_kw"])
    return teng.ParsirEngine(treg.get_workload("phold", **spec["model_kw"]),
                             tcfg, device="cpu")


@pytest.mark.parametrize("k", [3, 9])
def test_interop_state_steps_to_same_bits(k):
    """Rounds in both engines: the whole state tree — calendar slots, stale
    entries and fallback included — is equal after one step."""
    jengine, jst = _jax_state_after(k)
    host = jax.device_get(jst)
    tengine = _port_engine("rounds")
    tst = interop.engine_state_from_numpy(host, device="cpu")
    for (n1, a), (_, b) in zip(_leaves(interop.engine_state_to_numpy(tst)),
                               _leaves(host)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=n1)
    jnext = jax.device_get(jengine.step(jst))
    tnext = interop.engine_state_to_numpy(tengine.step(tst))
    got, want = dict(_leaves(tnext)), dict(_leaves(jnext))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], np.asarray(want[name]),
                                      err_msg=name)


@pytest.mark.parametrize("k", [3, 9])
def test_interop_state_steps_same_through_the_kernel_path(k):
    """batch_impl='model' emits in object-major order, so calendar slots may
    be laid out differently; object state, counters and the pending
    multiset are equal."""
    jengine, jst = _jax_state_after(k)
    tengine = _port_engine("model")
    tst = interop.engine_state_from_numpy(jax.device_get(jst), device="cpu")
    jnext = jengine.step(jst)
    tnext = tengine.step(tst)
    assert tengine.totals(tnext) == jengine.totals(jnext)
    for key, v in jengine.global_object_state(jnext).items():
        np.testing.assert_array_equal(
            tengine.global_object_state(tnext)[key], v, err_msg=key)
    np.testing.assert_array_equal(tconf.engine_pending(tengine, tnext),
                                  jengine_pending(jengine, jnext))
    assert int(tnext.epoch[0]) == int(np.asarray(jnext.epoch)[0]) == k + 1


CONFIGS = [
    dict(), dict(epoch_len=0.25), dict(epoch_len=0.3), dict(epoch_len=0.6),
    dict(lookahead=0.0), dict(lookahead=-1.0), dict(epoch_len=0.0),
    dict(n_buckets=0), dict(bucket_cap=0), dict(route_cap=0),
    dict(fallback_cap=0), dict(pack_tile=0), dict(batch_impl="model"),
    dict(batch_impl="bogus"), dict(route="ring"),
    dict(scheduler="batch-model"), dict(scheduler="nope"),
    dict(scheduler="ltf", batch_impl="model"), dict(placement="knapsack"),
    dict(rebalance_every=4), dict(placement="adaptive"),
    dict(placement="adaptive", rebalance_every=2, migrate_cap=1),
    dict(placement="adaptive", rebalance_every=2, placement_slack=0.5),
    dict(steal=True, steal_cap=0), dict(steal=True, batch_impl="model"),
    dict(opt_window=-1), dict(opt_commit="sometimes"),
    dict(opt_stage_cap=4), dict(opt_commit="global"),
    dict(opt_adaptive=True), dict(inject_straggler_every=2),
    dict(opt_window=8, n_buckets=8), dict(opt_window=2, steal=True),
    dict(scheduler="ltf"), dict(batch_impl="packed"), dict(opt_window=2),
    # the multi-device stages, accepted at any device count
    dict(steal=True), dict(route="a2a"), dict(placement="weighted"),
    dict(placement="adaptive", rebalance_every=8, migrate_cap=8),
    dict(steal=True, batch_impl="packed", route="a2a"),
    dict(steal=True, scheduler="ltf"),
    dict(route="a2a", opt_window=2, steal=True, opt_commit="global"),
    dict(placement="adaptive", rebalance_every=8, migrate_cap=8,
         opt_window=2),
]


def _outcome(cls, kw):
    try:
        cfg = cls(**dict(dict(lookahead=0.5), **kw))
    except ValueError as e:
        return "reject", str(e)
    except NotImplementedError as e:
        return "later", str(e)
    return "accept", cfg


@pytest.mark.parametrize("kw", CONFIGS, ids=[str(c) for c in CONFIGS])
def test_engine_config_matches_jax_validation(kw):
    # every configuration the JAX engine accepts, the port accepts; every
    # one it rejects, the port rejects with the same words.
    j, jres = _outcome(JConfig, kw)
    t, tres = _outcome(TConfig, kw)
    assert t == j, (kw, jres, tres)
    if t == "reject":
        assert tres == jres
    if t == "accept":
        for f in dataclasses.fields(TConfig):
            assert getattr(tres, f.name) == getattr(jres, f.name), f.name


def test_config_validate_per_device_count():
    for D in (1, 2, 3, 4):
        assert TConfig(lookahead=0.5).validate(D) is None
    for route_cap, D in ((4096, 4), (6, 3), (8, 8), (7, 8), (10, 4), (1, 2)):
        t = TConfig(lookahead=0.5, route="a2a", route_cap=route_cap)
        j = JConfig(lookahead=0.5, route="a2a", route_cap=route_cap)
        try:
            j.validate(D)
        except ValueError as want:
            with pytest.raises(ValueError) as got:
                t.validate(D)
            assert str(got.value) == str(want), (route_cap, D)
        else:
            assert t.validate(D) is None, (route_cap, D)
    with pytest.raises(ValueError, match="divisible by mesh size 4"):
        TConfig(lookahead=0.5, route="a2a", route_cap=10).validate(4)


def test_names_and_stats_match_jax():
    for name in ("BATCH_IMPLS", "SELECTABLE_SCHEDULERS", "ROUTES",
                 "PLACEMENTS"):
        assert getattr(tnames, name) == getattr(jnames, name), name
    assert tbase.Stats._fields == jeng.Stats._fields
    assert set(tbase.SCHEDULERS) == {"batch", "batch-model", "batch-packed",
                                     "ltf"}
    assert set(tbase.ROUTERS) == set(tnames.ROUTES) == {"allgather", "a2a"}
    assert set(tbase.STEAL_POLICIES) == {"none", "loan"}
    assert set(tbase.REBALANCERS) == {"none", "adaptive"}
    assert json.loads(json.dumps(tconf.SWEEP))
    # the port pins both sizes of every workload it registers, as copied
    pinned = jgolden.load_digests()
    want = {k for k in pinned if k.split("/")[0] in treg.all_workloads()}
    assert set(tgolden.PINNED) == want == set(pinned) and len(want) == 14
    assert all(tgolden.PINNED[k] == pinned[k] for k in want)


@pytest.mark.parametrize("epoch_len", [0.5, 0.25, 0.3, 0.37])
def test_epoch_of_matches_jax(epoch_len):
    import jax.numpy as jnp
    from repro.core.pipeline.base import epoch_of as jepoch_of
    rng = np.random.default_rng(0)
    ts = np.concatenate([(rng.random(5000) * 64).astype(np.float32),
                         np.arange(0, 8, epoch_len, dtype=np.float32)])
    got = tbase.epoch_of(torch.from_numpy(ts), epoch_len).numpy()
    want = np.asarray(jepoch_of(jnp.asarray(ts), epoch_len))
    np.testing.assert_array_equal(got, want)
