"""The port's replication axis (``init_replicated`` /
``run_replicated_drained``) on the CPU.

The port of ``tests/test_replication.py``.  The stacked state puts R
replications of one model, one per seed, in one state whose leaves lead
with R; the stacked gated step runs one scheduler call over all their rows
and routes and delivers each replication on its own, so each one stops at
its own drain epoch.  Pinned here, for wireless (R = 1, 8) and phold
(R = 4) under ``rounds`` and ``model``:

* every replication equals its own independent ``run_until_drained``, leaf
  by leaf, epoch and Stats included;
* the whole stack equals the JAX package's ``run_replicated_drained``
  (under ``rounds`` on the JAX side: its Pallas path fails on the installed
  jax, ROADMAP C1), leaf by leaf under ``rounds`` and in object state,
  Stats, epoch and pending multiset under ``model``; a JAX stacked state
  carried across by ``interop`` drains on in the port to the JAX bits;
* every replication passes conformance against its own seed's oracle;
* replications drain at their own epochs; ``dispatches`` rises by 2 for
  ingest + drain and ``syncs`` keeps the drain's rule; the empty seed list
  and an overflowing horizon fail before anything runs; ``ltf`` and
  ``packed`` stack too, each replication equal to its own drain
  (``tests/test_torch_rep_schedulers.py`` holds them to the JAX engine).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.pipeline.config import EngineConfig as JConfig  # noqa: E402
from repro.testing.conformance import engine_pending as jengine_pending  # noqa: E402
from repro.workloads import registry as jreg  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.pipeline.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.testing.clean import assert_clean  # noqa: E402
from repro_torch.workloads import registry as treg  # noqa: E402

from test_torch_drain import _assert_trees_equal, _host  # noqa: E402

K = teng.DRAIN_CHUNK
CASES = [("wireless", 1, "rounds"), ("wireless", 8, "rounds"),
         ("phold", 4, "rounds"), ("phold", 4, "model")]
IDS = [f"{n}-R{r}-{i}" for n, r, i in CASES]


def _port(name, impl="rounds", **cfg_kw):
    spec = treg.conformance_spec(name)
    model = treg.get_workload(name, **spec["model_kw"])
    cfg = TConfig(lookahead=model.params.lookahead, batch_impl=impl,
                  **dict(spec["engine_kw"], **cfg_kw))
    return teng.ParsirEngine(model, cfg, device="cpu"), spec


@pytest.fixture(scope="module")
def jax_stacks():
    """The JAX engine's ``run_replicated_drained`` (rounds) per (workload,
    R) of CASES: the host copy of its stack and its initial stack."""
    out = {}
    for name, R in sorted({(n, r) for n, r, _ in CASES}):
        spec = jreg.conformance_spec(name)
        model = jreg.get_workload(name, **spec["model_kw"])
        eng = jeng.ParsirEngine(model, JConfig(lookahead=0.5,
                                               **spec["engine_kw"]))
        init = eng.init_replicated(range(R))
        init_host = jax.device_get(init)
        st = eng.run_replicated_drained(init, spec["n_epochs"])
        out[name, R] = dict(
            host=jax.device_get(st), init=init_host,
            pending=[jengine_pending(eng, eng.replication(st, r))
                     for r in range(R)])
    return out


@pytest.mark.parametrize("name,R,impl", CASES, ids=IDS)
def test_each_replication_equals_its_independent_drain(name, R, impl):
    eng, spec = _port(name, impl)
    n = spec["n_epochs"]
    d0, s0 = eng.dispatches, eng.syncs
    st = eng.run_replicated_drained(eng.init_replicated(range(R)), n)
    assert eng.dispatches - d0 == 2          # ingest + one drain
    # none of these recipes drains: n epochs in chunks, one flag read per
    # chunk, and under rounds one round-count read per epoch
    assert eng.syncs - s0 == -(-n // K) + (n if impl == "rounds" else 0)
    assert tuple(st.epoch.shape) == (R, 1) and st.cal.ts.shape[0] == R
    totals = eng.totals_replicated(st)
    in_flight = eng.in_flight_replicated(st)
    assert in_flight.dtype == np.int64 and in_flight.shape == (R,)
    for r in range(R):
        ref = eng.run_until_drained(eng.init(seed=r), n)
        _assert_trees_equal(_host(eng.replication(st, r)), _host(ref),
                            f"{name} R={R} {impl} rep {r}")
        assert totals[r] == eng.totals(ref)
        assert int(in_flight[r]) == eng.in_flight(ref) > 0
        assert_clean(totals[r], context=f"{name} rep {r}")


@pytest.mark.parametrize("name,R,impl", CASES, ids=IDS)
def test_stack_equals_the_jax_replicated_drain(jax_stacks, name, R, impl):
    eng, spec = _port(name, impl)
    st = eng.run_replicated_drained(eng.init_replicated(range(R)),
                                    spec["n_epochs"])
    want = jax_stacks[name, R]
    if impl == "rounds":
        _assert_trees_equal(_host(st), want["host"], f"{name} R={R} vs JAX")
        return
    # batch-model emits (row, slot)-ordered, the JAX rounds (round, row):
    # the same events in other calendar slots and fallback order.
    got, jax_host = _host(st), want["host"]
    for part in ("obj", "stats", "epoch", "bounds", "load"):
        _assert_trees_equal(getattr(got, part), getattr(jax_host, part),
                            f"{name} R={R} {impl} {part} vs JAX")
    np.testing.assert_array_equal(got.cal.cnt, jax_host.cal.cnt)
    for r in range(R):
        np.testing.assert_array_equal(
            tconf.engine_pending(eng, eng.replication(st, r)),
            want["pending"][r], err_msg=f"{name} rep {r} pending")


@pytest.mark.parametrize("name,R", [("wireless", 8), ("phold", 4)])
def test_a_jax_stack_drains_on_in_the_port(jax_stacks, name, R):
    eng, spec = _port(name)
    want = jax_stacks[name, R]
    st = interop.engine_state_from_numpy(want["init"], "cpu")
    assert tuple(st.stats.processed.shape) == (R, 1)
    st = eng.run_replicated_drained(st, spec["n_epochs"])
    _assert_trees_equal(_host(st), want["host"], f"{name} R={R} via interop")


def test_stacked_state_round_trips_through_numpy():
    eng, spec = _port("wireless")
    st = eng.run_replicated_drained(eng.init_replicated([3, 5, 7]), 5)
    host = interop.engine_state_to_numpy(st)
    assert host.cal.seed.dtype == np.uint32 and host.cal.ts.shape[0] == 3
    back = interop.engine_state_from_numpy(host, "cpu")
    _assert_trees_equal(_host(back), host, "round trip")
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(st)):
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("name,R,impl", CASES, ids=IDS)
def test_each_replication_passes_conformance(name, R, impl):
    config = "batch-model" if impl == "model" else "batch-allgather"
    rep = tconf.check_workload_replicated(name, config, replications=R,
                                          device="cpu")
    assert len(rep["processed"]) == R and min(rep["processed"]) > 0


def test_replications_drain_at_their_own_epochs():
    # wireless with finite call budgets and no handoffs empties; with
    # different seeds the replications drain at different epochs, and each
    # stops at the epoch of its own drain.
    model = treg.get_workload("wireless", n_cells=6, n_channels=2,
                              max_calls=3, handoff_p=0, lookahead=0.5,
                              dist="dyadic")
    cfg = TConfig(lookahead=0.5, n_buckets=8, bucket_cap=64, route_cap=512,
                  fallback_cap=512)
    eng = teng.ParsirEngine(model, cfg, device="cpu")
    st = eng.run_replicated_drained(eng.init_replicated(range(6)), 200)
    assert int(eng.in_flight_replicated(st).sum()) == 0
    epochs = st.epoch[:, 0].tolist()
    assert len(set(epochs)) > 1, epochs
    assert max(epochs) < 200
    for r in range(6):
        ref = eng.run_until_drained(eng.init(seed=r), 200)
        assert int(ref.epoch[0]) == epochs[r]
        _assert_trees_equal(_host(eng.replication(st, r)), _host(ref),
                            f"rep {r}")


def test_init_replicated_rejects_empty_seed_list():
    eng, _ = _port("wireless")
    with pytest.raises(ValueError, match="at least one seed"):
        eng.init_replicated([])
    assert eng.dispatches == 0


def test_stats_bound_fails_fast_before_dispatch():
    eng, _ = _port("wireless")
    per_epoch = max(eng.placement.n_local_max * eng.cfg.bucket_cap,
                    eng.cfg.route_cap, eng.cfg.fallback_cap)
    too_many = np.iinfo(np.int64).max // per_epoch + 1
    with pytest.raises(ValueError, match="overflow"):
        eng.check_stats_bound(too_many)
    d0, s0 = eng.dispatches, eng.syncs
    st = eng.init_replicated([0])
    before = _host(st)
    with pytest.raises(ValueError, match="overflow"):
        eng.run_replicated_drained(st, too_many)
    assert eng.dispatches - d0 == 1 and eng.syncs == s0  # the ingest only
    _assert_trees_equal(_host(st), before, "untouched")
    eng.check_stats_bound(256)


@pytest.mark.parametrize("cfg_kw,name", [
    (dict(scheduler="ltf"), "scheduler='ltf'"),
    (dict(batch_impl="packed", pack_tile=4), "batch_impl='packed'")])
def test_ltf_and_packed_refuse_stacked_replications(cfg_kw, name):
    # refused until each replication got its own emission order; now both
    # stack: each replication of a two-seed stack equals its own drain, and
    # a stack of two copies of one replication (carried through interop)
    # drains to two copies of it.
    spec = treg.conformance_spec("wireless")
    model = treg.get_workload("wireless", **spec["model_kw"])
    cfg = TConfig(lookahead=0.5, **dict(spec["engine_kw"], **cfg_kw))
    eng = teng.ParsirEngine(model, cfg, device="cpu")
    st = eng.run_replicated_drained(eng.init_replicated([0, 1]), 6)
    assert eng.dispatches == 2
    for r in range(2):
        ref = eng.run_until_drained(eng.init(seed=r), 6)
        _assert_trees_equal(_host(eng.replication(st, r)), _host(ref),
                            f"{name} R=2 rep {r}")
    one = eng.init_replicated([1])
    both = eng.run_replicated_drained(
        interop.engine_state_from_numpy(
            jax.tree_util.tree_map(lambda a: np.concatenate([a, a]),
                                   interop.engine_state_to_numpy(one)),
            "cpu"), 6)
    ref = eng.run_until_drained(eng.init(seed=1), 6)
    for r in range(2):
        _assert_trees_equal(_host(eng.replication(both, r)), _host(ref),
                            f"{name} copy {r}")
