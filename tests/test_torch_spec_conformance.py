"""Speculation (``opt_window``) in the port's conformance, on the CPU.

The reference's single-device speculation points of ``SWEEP`` (``spec-w1``,
``spec-w2``, ``spec-w4``, ``spec-global``, ``spec-inject``) through
``check_workload`` for every registered workload: clean counters, the
oracle's processed count and pending multiset, the object state bit for
bit.  A window commits or rolls back to exactly the conservative bits, so
the oracle, which knows nothing of speculation, is the reference for
every point.  The recipes are the pinned golden cases' "small" sizes, and
the "medium" sizes run too, under ``spec-inject``: at all 14 the engine
is held to the port's oracle, whose digest is the pinned one.  Then the
injected rollbacks under the other schedulers (``batch_impl`` model and
packed, ``ltf``) and the replicated speculative drain against each
replication's own oracle.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.testing import golden as tgolden  # noqa: E402
from repro_torch.workloads import registry as treg  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many tiny ops: one intra-op thread, as the test
    workers share the cores and idle intra-op threads spinning beside
    them cost more than the parallel ops save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SPEC = ["spec-w1", "spec-w2", "spec-w4", "spec-global", "spec-inject"]
CASES = [(name, config) for name in treg.all_workloads()
         for config in tconf.supported_configs(name) if config in SPEC]


def test_every_workload_supports_the_speculation_points():
    # the single-device ones; the five that need a second device
    # (spec-a2a, ...) run in tests/test_torch_spec_multidevice.py.
    assert [c for c in tconf.SWEEP if c.startswith("spec-")
            and c not in tconf.MULTI_DEVICE] == SPEC
    assert len(CASES) == 7 * len(SPEC)


@pytest.mark.parametrize("name,config", CASES,
                         ids=[f"{n}-{c}" for n, c in CASES])
def test_speculation_conformance(name, config):
    rep = tconf.check_workload(name, config, device="cpu")
    tot = rep["totals"]
    n = rep["n_epochs"]
    W = tconf.SWEEP[config]["opt_window"]
    assert tot["processed"] > 0 and tot["speculated"] > 0
    windows = tot["spec_commits"] + tot["rollbacks"]
    if config == "spec-inject":
        assert tot["rollbacks"] > 0
    else:
        # one device: no straggler, every window commits and leaps W + 1.
        assert tot["rollbacks"] == 0 and windows == -(-n // (W + 1))
    assert int(rep["state"].epoch[0]) == n
    # the recipe is the pinned golden case's small size: the oracle the
    # engine was held to reproduces its digest.
    assert tgolden.golden_case(f"{name}/small") == (
        name, treg.conformance_spec(name)["model_kw"], n)
    assert tgolden.state_digest(rep["ref"]) == tgolden.PINNED[f"{name}/small"]


#: spec-inject under the other schedulers: (workload, overrides).
SCHEDULED = ([(name, dict(batch_impl="model")) for name in
              ("phold", "phold-hotspot")]
             + [(name, over) for name in treg.all_workloads()
                for over in (dict(batch_impl="packed", pack_tile=4),
                             dict(scheduler="ltf"))])


@pytest.mark.parametrize("name,over", SCHEDULED, ids=[
    f"{n}-{'-'.join(map(str, o.values()))}" for n, o in SCHEDULED])
def test_injected_rollbacks_under_every_scheduler(name, over):
    spec = treg.conformance_spec(name)
    model = treg.get_workload(name, **spec["model_kw"])
    rep = tconf.run_conformance(
        model, dict(tconf.SWEEP["spec-inject"], **over),
        n_epochs=spec["n_epochs"], engine_kw=spec["engine_kw"],
        dyadic=spec["dyadic"], label=f"{name}/spec-inject", device="cpu")
    assert rep["totals"]["rollbacks"] > 0
    eng = rep["engine"]
    # host-read schedulers read their loop bound once per sub-epoch
    # (W + 1 a step) on top of one flag read per chunk.
    steps = rep["totals"]["spec_commits"] + rep["totals"]["rollbacks"]
    chunks = eng.syncs - (3 * steps if eng._step_syncs else 0)
    assert 1 <= chunks <= steps


@pytest.mark.parametrize("key", sorted(k for k in tgolden.PINNED
                                       if k.endswith("/medium")))
def test_golden_sizes_under_injected_rollbacks(key):
    name, model_kw, n_epochs = tgolden.golden_case(key)
    model = treg.get_workload(name, **model_kw)
    spec = treg.conformance_spec(name)
    rep = tconf.run_conformance(model, tconf.SWEEP["spec-inject"],
                                n_epochs=n_epochs, engine_kw=spec["engine_kw"],
                                dyadic=True, label=key, device="cpu")
    assert rep["totals"]["rollbacks"] > 0
    # the oracle the engine was held to reproduces the pinned digest.
    assert tgolden.state_digest(rep["ref"]) == tgolden.PINNED[key]


@pytest.mark.parametrize("name,config", [("phold", "spec-inject"),
                                         ("wireless", "spec-w2"),
                                         ("queueing", "spec-global")])
def test_replicated_speculative_drain_conformance(name, config):
    rep = tconf.check_workload_replicated(name, config, replications=3,
                                          device="cpu")
    assert len(rep["processed"]) == 3 and min(rep["processed"]) > 0
    assert all(t["speculated"] > 0 for t in rep["totals"])
