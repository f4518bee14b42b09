"""The port's speculation (``opt_window``), on the CPU; its card twins.

The port of ``tests/test_speculation.py`` at one device, where no straggler
can arrive: every window commits but the ones ``inject_straggler_every``
forces down the rollback path.  Pinned here:

* ``run(n)`` and ``run_until_drained`` under ``rounds`` equal the JAX
  engine under the same config leaf by leaf, Stats meters included
  (phold and wireless); under ``batch_impl="model"`` they equal the JAX
  rounds run of the same config (its Pallas path fails on the installed
  jax, ROADMAP C1) in object state, Stats, epoch and pending multiset;
* the reference's cases: windows always commit and leap ``W + 1`` epochs,
  bit-exact against the conservative run and landing on the bound; the
  speculative drain needs fewer iterations; ``opt_window=0`` builds
  nothing speculative and ``step`` stays conservative; injected
  stragglers roll back bit-exact with the meters of the host predictor;
  the meters count windows and stay out of the clean counters;
* the loops' host reads (one flag per chunk of at most ``DRAIN_CHUNK``
  steps, ``test_torch_spec_graphs.py`` holds the loops themselves);
* the configurations the port takes and the ones it refuses by name.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.pipeline.config import EngineConfig as JConfig  # noqa: E402
from repro.testing.clean import CLEAN_COUNTERS  # noqa: E402
from repro.testing.conformance import engine_pending as jengine_pending  # noqa: E402
from repro.workloads import registry as jreg  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.pipeline import make_spec_step  # noqa: E402
from repro_torch.core.pipeline.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.testing import clean as tclean  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.workloads import registry as treg  # noqa: E402

from test_torch_drain import _assert_trees_equal, _host  # noqa: E402
from test_torch_spec_graphs import predict_meters, predict_reads  # noqa: E402

CLEAN = tclean.CLEAN_COUNTERS


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many tiny ops: one intra-op thread, as the test
    workers share the cores and idle intra-op threads spinning beside
    them cost more than the parallel ops save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(name, model_kw=None, **cfg_kw):
    spec = treg.conformance_spec(name)
    model = treg.get_workload(name, **dict(spec["model_kw"],
                                           **(model_kw or {})))
    cfg = TConfig(lookahead=model.params.lookahead,
                  **dict(spec["engine_kw"], **cfg_kw))
    return teng.ParsirEngine(model, cfg, device="cpu"), spec


# -- against the JAX engine ------------------------------------------------------

#: both commit modes and the injected rollbacks on phold, the drain of a
#: workload that empties on wireless (every width is held to the oracle
#: and the conservative run in test_torch_spec_conformance.py).
JAX_CASES = [("phold", c) for c in ("spec-w2", "spec-global",
                                     "spec-inject")] + \
            [("wireless", c) for c in ("spec-w2", "spec-inject")]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's ``run(n)`` and ``run_until_drained(n + 5)`` under
    each case's config (rounds), fetched to the host, run once."""
    out = {}
    for name, config in JAX_CASES:
        spec = jreg.conformance_spec(name)
        model = jreg.get_workload(name, **spec["model_kw"])
        eng = jeng.ParsirEngine(model, JConfig(
            lookahead=0.5, **spec["engine_kw"], **tconf.SWEEP[config]))
        n = spec["n_epochs"]
        run = eng.run(eng.init(), n)
        pend = jengine_pending(eng, run)
        drain = eng.run_until_drained(eng.init(), n + 5)
        out[name, config] = dict(run=jax.device_get(run), pending=pend,
                                 drain=jax.device_get(drain))
    return out


@pytest.mark.parametrize("name,config", JAX_CASES,
                         ids=[f"{n}-{c}" for n, c in JAX_CASES])
def test_run_and_drain_equal_the_jax_engine(jax_runs, name, config):
    eng, spec = _port(name, **tconf.SWEEP[config])
    n = spec["n_epochs"]
    want = jax_runs[name, config]
    _assert_trees_equal(_host(eng.run(eng.init(), n)), want["run"],
                        f"{name} {config} run({n})")
    _assert_trees_equal(_host(eng.run_until_drained(eng.init(), n + 5)),
                        want["drain"], f"{name} {config} drain({n + 5})")


@pytest.mark.parametrize("config", ["spec-w2", "spec-inject", "spec-global"])
def test_kernel_path_equals_the_jax_rounds_run(jax_runs, config):
    eng, spec = _port("phold", batch_impl="model", **tconf.SWEEP[config])
    st = eng.run(eng.init(), spec["n_epochs"])
    got, want = _host(st), jax_runs["phold", config]["run"]
    # the kernel path emits (row, slot)-ordered, the JAX rounds (round,
    # row): the same events in other calendar slots and fallback order.
    for part in ("obj", "stats", "epoch", "bounds", "load"):
        _assert_trees_equal(getattr(got, part), getattr(want, part),
                            f"model {config} {part} vs JAX")
    np.testing.assert_array_equal(got.cal.cnt, want.cal.cnt)
    np.testing.assert_array_equal(tconf.engine_pending(eng, st),
                                  jax_runs["phold", config]["pending"])


# -- the reference's cases ---------------------------------------------------------

@pytest.mark.parametrize("impl", ["rounds", "model"])
@pytest.mark.parametrize("W", [1, 2, 4])
def test_single_device_windows_always_commit(W, impl):
    eng0, spec = _port("phold", batch_impl=impl)
    n = spec["n_epochs"]
    s0 = eng0.run(eng0.init(), n)
    t0 = eng0.totals(s0)
    eng, _ = _port("phold", batch_impl=impl, opt_window=W)
    s = eng.run(eng.init(), n)
    t = eng.totals(s)
    assert t["rollbacks"] == 0
    assert t["spec_commits"] == -(-n // (W + 1))
    assert t["speculated"] > 0 and t["processed"] == t0["processed"]
    assert all(t[k] == 0 for k in CLEAN)
    assert int(s.epoch[0]) == n               # bound-exact landing
    for k in s0.obj:
        assert torch.equal(s.obj[k], s0.obj[k]), k
    assert torch.equal(s.cal.cnt, s0.cal.cnt)
    # run reads one flag per chunk and nothing else under model
    steps, reads = predict_reads(n, W, 0)
    assert steps == t["spec_commits"]
    assert eng.syncs == (reads if impl == "model" else reads + steps * (W + 1))


def test_fused_drain_needs_fewer_iterations():
    eng0, _ = _port("wireless", model_kw=dict(max_calls=4))
    s0 = eng0.run_until_drained(eng0.init(), 512)
    epochs0 = int(s0.epoch[0])
    assert eng0.in_flight(s0) == 0 and epochs0 < 512
    eng, _ = _port("wireless", model_kw=dict(max_calls=4), opt_window=2)
    s = eng.run_until_drained(eng.init(), 512)
    t = eng.totals(s)
    assert eng.in_flight(s) == 0
    assert t["spec_commits"] + t["rollbacks"] < epochs0
    assert t["processed"] == eng0.totals(s0)["processed"]
    for k in s0.obj:
        assert torch.equal(s.obj[k], s0.obj[k]), k
    assert eng.dispatches == eng0.dispatches == 2


def test_opt_window_zero_builds_nothing_speculative():
    eng, _ = _port("phold", batch_impl="model")
    assert eng._spec_step is None and eng._rep_spec_step is None
    assert eng._drain_variants == {}
    with pytest.raises(ValueError, match="opt_window > 0"):
        make_spec_step(eng.model, eng.cfg, eng.placement)
    st = eng.run_until_drained(eng.init(), 10)
    assert eng.totals(st)["spec_commits"] == 0
    eng_w, _ = _port("phold", batch_impl="model", opt_window=2)
    assert eng_w._spec_step is not None
    assert set(eng_w._drain_variants) == {2}
    # step() stays conservative: one epoch, no window, the W = 0 bits.
    a = eng_w.step(eng_w.init())
    b = eng.step(eng.init())
    assert int(a.epoch[0]) == 1
    _assert_trees_equal(_host(a), _host(b), "step under opt_window=2")


@pytest.mark.parametrize("impl", ["rounds", "model"])
@pytest.mark.parametrize("inject", [2, 3])
def test_injected_stragglers_roll_back_bit_exact(inject, impl):
    W = 2
    eng0, spec = _port("phold", batch_impl=impl)
    n = spec["n_epochs"]
    s0 = eng0.run(eng0.init(), n)
    eng, _ = _port("phold", batch_impl=impl, opt_window=W,
                   inject_straggler_every=inject)
    s = eng.run(eng.init(), n)
    t = eng.totals(s)
    cm, rb = predict_meters([n], W, inject)
    assert rb > 0
    assert (t["spec_commits"], t["rollbacks"]) == (cm, rb)
    assert t["speculated"] > 0
    assert t["processed"] == eng0.totals(s0)["processed"]
    assert all(t[k] == 0 for k in CLEAN)
    assert int(s.epoch[0]) == n
    for k in s0.obj:
        assert torch.equal(s.obj[k], s0.obj[k]), k
    assert torch.equal(s.cal.cnt, s0.cal.cnt)
    steps, reads = predict_reads(n, W, inject)
    assert steps == cm + rb
    if impl == "model":
        assert eng.syncs == reads


def test_meters_count_iterations_and_stay_out_of_clean():
    for k in ("rollbacks", "spec_commits", "speculated"):
        assert k not in CLEAN and k not in CLEAN_COUNTERS
    assert CLEAN == tuple(CLEAN_COUNTERS)
    W, inject = 2, 2
    eng, spec = _port("phold", opt_window=W, inject_straggler_every=inject)
    n = spec["n_epochs"]
    chunks, st, seen, done = [], eng.init(), 0, 0
    while done < n:
        c = min(5, n - done)
        st = eng.run(st, c)
        chunks.append(c)
        done += c
        t = eng.totals(st)
        iters = t["spec_commits"] + t["rollbacks"]
        assert iters > seen
        seen = iters
    assert (t["spec_commits"], t["rollbacks"]) == predict_meters(chunks, W,
                                                                 inject)
    assert int(st.epoch[0]) == n


# -- configuration --------------------------------------------------------------

SCHEDULERS = [dict(), dict(batch_impl="model"),
              dict(batch_impl="packed", pack_tile=4), dict(scheduler="ltf")]


@pytest.mark.parametrize("sched", SCHEDULERS, ids=lambda s: str(s))
def test_speculation_accepted_at_one_device_with_every_scheduler(sched):
    for kw in (dict(opt_window=2), dict(opt_window=4, opt_commit="global"),
               dict(opt_window=1, opt_adaptive=True,
                    inject_straggler_every=3)):
        t = TConfig(lookahead=0.5, route_cap=512, **sched, **kw)
        j = JConfig(lookahead=0.5, route_cap=512, **sched, **kw)
        for f in dataclasses.fields(TConfig):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.opt_stage_cap == 512
        eng, _ = _port("phold", **sched, **kw)
        assert eng._spec_step is not None


@pytest.mark.parametrize("config", ["spec-a2a", "spec-packed-a2a",
                                    "spec-weighted", "spec-steal",
                                    "spec-adaptive"])
def test_multi_device_speculation_points_are_refused_by_name(config):
    # no longer refused: the five points are the port's SWEEP points, as
    # the reference's, and accepted field for field (they run across
    # devices in tests/test_torch_spec_multidevice.py).
    from repro.testing.conformance import SWEEP as JSWEEP
    kw = JSWEEP[config]
    assert tconf.SWEEP[config] == kw and config in tconf.MULTI_DEVICE
    t, j = TConfig(lookahead=0.5, **kw), JConfig(lookahead=0.5, **kw)
    for f in dataclasses.fields(TConfig):
        assert getattr(t, f.name) == getattr(j, f.name), f.name


def test_speculation_rejects_what_the_jax_engine_rejects():
    kw = dict(lookahead=0.5, n_buckets=8)
    bad = [dict(opt_window=2, steal=True),
           dict(opt_window=2, steal=True, opt_commit="device"),
           dict(opt_window=2, opt_commit="quorum"),
           dict(lookahead=0.5, n_buckets=4, opt_window=3),
           dict(opt_window=-1),
           dict(opt_window=2, inject_straggler_every=-1),
           dict(opt_stage_cap=64), dict(opt_commit="global"),
           dict(opt_adaptive=True), dict(inject_straggler_every=2)]
    for b in bad:
        args = dict(kw, **b)
        with pytest.raises(ValueError) as want:
            JConfig(**args)
        with pytest.raises(ValueError) as got:
            TConfig(**args)
        assert str(got.value) == str(want.value), b
    assert TConfig(**kw, route_cap=512).opt_stage_cap == 0
