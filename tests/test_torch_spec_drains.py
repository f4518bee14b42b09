"""The port's speculative drains on the CPU: the adaptive-W controller and
the replicated speculative drain.

* ``opt_adaptive``: the drain runs chunks of ``max(8, 4 (W0 + 1))``
  epochs, one speculative drain of the live width each, and retunes the
  width from each chunk's rollback ratio; it ends in the JAX adaptive
  drain's bits (leaf by leaf under ``rounds``; under ``model`` in object
  state, Stats, epoch and pending multiset) with the same width
  trajectory, one dispatch per chunk, and builds only the widths it
  visits;
* the replicated speculative drain (``run_replicated_drained`` with
  ``opt_window > 0``, a bound ``epoch + max_epochs`` per replication)
  equals the JAX engine's at R = 3, and each replication equals its own
  speculative drain leaf by leaf, stopping at its own drain epoch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.pipeline.config import EngineConfig as JConfig  # noqa: E402
from repro.testing.conformance import engine_pending as jengine_pending  # noqa: E402
from repro.workloads import registry as jreg  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.pipeline.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.testing.clean import assert_clean  # noqa: E402
from repro_torch.workloads import registry as treg  # noqa: E402

from test_torch_drain import _assert_trees_equal, _host  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many tiny ops: one intra-op thread, as the test
    workers share the cores and idle intra-op threads spinning beside
    them cost more than the parallel ops save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: adaptive cases: (name, model overrides, config, bound).  phold never
#: drains and every window with W_eff > 0 aborts under inject=1, so its
#: width shrinks chunk by chunk; wireless drains, rolling every 2nd
#: window back, so its width holds.
ADAPTIVE = {
    "phold-shrinks": ("phold", {}, dict(opt_window=2, opt_adaptive=True,
                                        inject_straggler_every=1), 48),
    "wireless-holds": ("wireless", dict(max_calls=4),
                       dict(opt_window=4, opt_adaptive=True,
                            inject_straggler_every=2), 512),
}
#: replicated cases: (name, config, R, bound).
REPLICATED = {
    "wireless-spec-w2": ("wireless", "spec-w2", 3, 24),
    "phold-spec-inject": ("phold", "spec-inject", 3, 24),
}


def _models(name, model_kw):
    spec = jreg.conformance_spec(name)
    kw = dict(spec["model_kw"], **model_kw)
    return (jreg.get_workload(name, **kw), treg.get_workload(name, **kw),
            spec)


@pytest.fixture(scope="module")
def jax_drains():
    """The JAX engine's adaptive drains (with the width of every chunk)
    and replicated speculative drains, fetched to the host."""
    out = {}
    for key, (name, model_kw, cfg, bound) in ADAPTIVE.items():
        jm, _, spec = _models(name, model_kw)
        eng = jeng.ParsirEngine(jm, JConfig(lookahead=0.5,
                                            **spec["engine_kw"], **cfg))
        trail = []
        variant = eng._drain_variant
        eng._drain_variant = lambda w: (trail.append(w), variant(w))[1]
        st = eng.run_until_drained(eng.init(), bound)
        out[key] = dict(host=jax.device_get(st), trail=trail,
                        pending=jengine_pending(eng, st),
                        dispatches=eng.dispatches)
    for key, (name, config, R, bound) in REPLICATED.items():
        jm, _, spec = _models(name, {})
        eng = jeng.ParsirEngine(jm, JConfig(lookahead=0.5,
                                            **spec["engine_kw"],
                                            **tconf.SWEEP[config]))
        st = eng.run_replicated_drained(eng.init_replicated(range(R)), bound)
        out[key] = dict(host=jax.device_get(st), pending=[
            jengine_pending(eng, eng.replication(st, r)) for r in range(R)])
    return out


def _port(name, model_kw, impl, **cfg):
    _, tm, spec = _models(name, model_kw)
    return teng.ParsirEngine(tm, TConfig(lookahead=0.5, batch_impl=impl,
                                         **spec["engine_kw"], **cfg),
                             device="cpu")


def _assert_same_run(eng, st, want, pending, ctx):
    """Object state, Stats, epoch and the pending multiset (the kernel
    path parks the same events in other slots than the JAX rounds)."""
    got = _host(st)
    for part in ("obj", "stats", "epoch", "bounds", "load"):
        _assert_trees_equal(getattr(got, part), getattr(want, part),
                            f"{ctx} {part}")
    np.testing.assert_array_equal(got.cal.cnt, want.cal.cnt)
    np.testing.assert_array_equal(tconf.engine_pending(eng, st), pending)


def _with_impls(cases):
    """(key, impl) pairs: rounds for every case, model where the workload
    has a kernel path."""
    return [(key, impl) for key in sorted(cases)
            for impl in ("rounds", "model")
            if impl == "rounds" or treg.conformance_spec(
                cases[key][0])["supports_batch_impl"]]


@pytest.mark.parametrize("key,impl", _with_impls(ADAPTIVE))
def test_adaptive_drain_equals_the_jax_controller(jax_drains, key, impl):
    name, model_kw, cfg, bound = ADAPTIVE[key]
    eng = _port(name, model_kw, impl, **cfg)
    want = jax_drains[key]
    st = eng.run_until_drained(eng.init(), bound)
    assert eng.window_trail == want["trail"]
    assert eng.dispatches == want["dispatches"] == 1 + len(want["trail"])
    assert sorted(eng._drain_variants) == sorted(set(want["trail"]))
    if impl == "rounds":
        _assert_trees_equal(_host(st), want["host"], f"{key} vs JAX")
    else:
        _assert_same_run(eng, st, want["host"], want["pending"], key)
    assert_clean(eng.totals(st), context=key)


def test_adaptive_widths_shrink_and_the_bits_do_not_move():
    name, model_kw, cfg, bound = ADAPTIVE["phold-shrinks"]
    eng = _port(name, model_kw, "model", **cfg)
    st = eng.run_until_drained(eng.init(), bound)
    assert eng.window_trail == [2, 1, 1, 1]
    ref = _port(name, model_kw, "model")
    s0 = ref.run(ref.init(), bound)
    for k in s0.obj:
        assert torch.equal(st.obj[k], s0.obj[k]), k
    assert int(st.epoch[0]) == bound
    t = eng.totals(st)
    assert t["processed"] == ref.totals(s0)["processed"]
    assert t["rollbacks"] > t["spec_commits"]


@pytest.mark.parametrize("key,impl", _with_impls(REPLICATED))
def test_replicated_speculative_drain_equals_the_jax_one(jax_drains, key,
                                                         impl):
    name, config, R, bound = REPLICATED[key]
    eng = _port(name, {}, impl, **tconf.SWEEP[config])
    d0 = eng.dispatches
    st = eng.run_replicated_drained(eng.init_replicated(range(R)), bound)
    assert eng.dispatches - d0 == 2
    want = jax_drains[key]
    if impl == "rounds":
        _assert_trees_equal(_host(st), want["host"], f"{key} vs JAX")
    else:
        got = _host(st)
        for part in ("obj", "stats", "epoch", "bounds", "load"):
            _assert_trees_equal(getattr(got, part),
                                getattr(want["host"], part),
                                f"{key} {part} vs JAX")
        for r in range(R):
            np.testing.assert_array_equal(
                tconf.engine_pending(eng, eng.replication(st, r)),
                want["pending"][r], err_msg=f"{key} rep {r} pending")
    totals = eng.totals_replicated(st)
    for r in range(R):
        ind = eng.run_until_drained(eng.init(seed=r), bound)
        _assert_trees_equal(_host(eng.replication(st, r)), _host(ind),
                            f"{key} {impl} rep {r} vs its own drain")
        assert totals[r] == eng.totals(ind)
        assert totals[r]["speculated"] > 0


@pytest.mark.parametrize("config", ["spec-w2", "spec-inject"])
def test_replications_stop_at_their_own_drain_epochs(config):
    model = treg.get_workload("wireless", n_cells=6, n_channels=2,
                              max_calls=3, handoff_p=0, lookahead=0.5,
                              dist="dyadic")
    cfg = TConfig(lookahead=0.5, n_buckets=8, bucket_cap=64, route_cap=512,
                  fallback_cap=512, **tconf.SWEEP[config])
    eng = teng.ParsirEngine(model, cfg, device="cpu")
    st = eng.run_replicated_drained(eng.init_replicated(range(6)), 200)
    assert int(eng.in_flight_replicated(st).sum()) == 0
    epochs = st.epoch[:, 0].tolist()
    assert len(set(epochs)) > 1 and max(epochs) < 200, epochs
    for r in range(6):
        ref = eng.run_until_drained(eng.init(seed=r), 200)
        assert int(ref.epoch[0]) == epochs[r]
        _assert_trees_equal(_host(eng.replication(st, r)), _host(ref),
                            f"{config} rep {r}")
