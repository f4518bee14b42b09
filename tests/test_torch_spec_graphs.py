"""The speculative loops (``opt_window > 0``) of the port's engine: their
chunks, flag and bound, on the CPU and on the card.

No JAX here, so that the card-only tests run where JAX is not installed.
On the CPU:

* :func:`~repro_torch.core.engine.spec_flag` (how many replications are
  still short of their bound, or in a drain hold events, and the most
  epochs one has left) and the runner's bound tensor, one per replication;
* a replication at its bound, or drained under the drain's gate, is a
  bit-exact fixpoint of the speculative step;
* ``run(n)`` takes the steps and the flag reads of the host walk below
  (chunks of ``min(DRAIN_CHUNK, ceil(left / (W + 1)))`` steps), and lands
  on ``epoch + n``.

On the card (marked ``cuda``, skipped without a device): the graphed
speculative ``run`` and drain equal the same steps run eagerly, leaf by
leaf, with and without injected rollbacks, and pass conformance; replays of
the step at the bound leave the state as it is; the stacked speculative
drain replays its own graphs and equals each replication's own drain.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import graphs as tgraphs  # noqa: E402
from repro_torch.core.pipeline.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.workloads import registry as treg  # noqa: E402

K = teng.DRAIN_CHUNK


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many tiny ops: one intra-op thread, as the test
    workers share the cores and idle intra-op threads spinning beside
    them cost more than the parallel ops save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def predict_meters(chunks, W, inject):
    """The host twin of the engine's window walk (the reference test's
    predictor): a committed window advances ``w_eff + 1`` epochs (clamped to
    the chunk's bound), an injected abort 1; injection fires on every
    ``inject``-th window where ``w_eff > 0``; the window count persists
    across chunks."""
    e, cm, rb = 0, 0, 0
    for c in chunks:
        bound = e + c
        while e < bound:
            w_eff = min(W, bound - e - 1)
            if inject and (cm + rb) % inject == inject - 1 and w_eff > 0:
                rb += 1
                e += 1
            else:
                cm += 1
                e += w_eff + 1
    return cm, rb


def predict_reads(n, W, inject):
    """Steps and flag reads of the port's speculative ``run(n)`` from a
    fresh state: chunks of ``min(DRAIN_CHUNK, ceil(left / (W + 1)))`` steps,
    one read after each (a step past the bound is a fixpoint and counts no
    window)."""
    e, windows, steps, reads = 0, 0, 0, 0
    left = n
    while left > 0:
        for _ in range(min(K, -(-left // (W + 1)))):
            steps += 1
            if e >= n:
                continue
            w_eff = min(W, n - e - 1)
            if inject and windows % inject == inject - 1 and w_eff > 0:
                e += 1
            else:
                e += w_eff + 1
            windows += 1
        reads += 1
        left = n - e
    return steps, reads


def _port(name, device="cpu", **cfg_kw):
    spec = treg.conformance_spec(name)
    model = treg.get_workload(name, **spec["model_kw"])
    cfg = TConfig(lookahead=model.params.lookahead,
                  **dict(spec["engine_kw"], **cfg_kw))
    return teng.ParsirEngine(model, cfg, device=device), spec


def _assert_same(a, b, ctx):
    for i, (x, y) in enumerate(zip(tgraphs.leaves(a), tgraphs.leaves(b),
                                   strict=True)):
        assert x.dtype == y.dtype and torch.equal(x, y), \
            f"{ctx}: leaf {i} differs"


def test_predictors_agree_on_the_run_walk():
    for W in (1, 2, 4):
        for inject in (0, 2, 3):
            for n in (1, 7, 24, 100):
                steps, _ = predict_reads(n, W, inject)
                assert steps == sum(predict_meters([n], W, inject))
    # 256 epochs: the chunks the card replays (PERF.md).
    assert [predict_reads(256, W, 0) for W in (1, 2, 4)] == [
        (128, 8), (86, 6), (52, 4)]
    assert predict_reads(256, 2, 2) == (128, 10)


def test_spec_flag_counts_replications_short_of_their_bound():
    eng, _ = _port("wireless", opt_window=2)
    st = eng.init_replicated([0, 1, 2])
    st = st._replace(epoch=torch.tensor([[3], [5], [7]], dtype=torch.int32))
    bound = torch.tensor([5, 5, 9], dtype=torch.int32)
    assert teng.spec_flag(st, bound, False).tolist() == [2, 2]
    emptied = st._replace(cal=st.cal._replace(
        cnt=torch.where(torch.tensor([True, True, False])[:, None, None],
                        st.cal.cnt, 0)))
    assert int(eng.in_flight_replicated(emptied)[2]) == 0
    assert teng.spec_flag(emptied, bound, True).tolist() == [1, 2]
    assert teng.spec_flag(emptied, bound - 10, False).tolist() == [0, 0]
    one = eng.init()
    assert teng.spec_flag(one, torch.tensor([4], dtype=torch.int32),
                          True).tolist() == [1, 4]


def test_step_graphs_hold_a_bound_per_replication():
    eng, _ = _port("phold", opt_window=2)
    g = tgraphs.StepGraphs({False: eng._step}, torch.device("cpu"))
    assert g.bound is None
    st = g.adopt(eng.init())
    assert tuple(g.bound.shape) == (1,) and g.bound.dtype == torch.int32
    g.add(("spec", 2, True), eng._step)
    g.add(("spec", 2, True), eng._gated)          # a variant is added once
    assert g.steps[("spec", 2, True)] is eng._step
    rep = tgraphs.StepGraphs({True: eng._rep_gated}, torch.device("cpu"))
    rep.adopt(eng.init_replicated([0, 1, 2]))
    assert tuple(rep.bound.shape) == (3,)
    assert st is g.static


@pytest.mark.parametrize("impl", ["rounds", "model"])
@pytest.mark.parametrize("drain", [False, True])
def test_a_replication_at_its_bound_is_a_fixpoint(drain, impl):
    eng, _ = _port("phold", batch_impl=impl, opt_window=2,
                   inject_straggler_every=2)
    st = eng.run(eng.init(), 9)
    assert eng.in_flight(st) > 0
    before = tgraphs.clone_state(st)
    bound = torch.tensor([9], dtype=torch.int32)
    after = eng._spec_step(tgraphs.clone_state(st), bound, drain)
    _assert_same(after, before, "at the bound")
    # and a drained state under the drain's gate, short of its bound.
    cleared = st._replace(
        cal=st.cal._replace(cnt=torch.zeros_like(st.cal.cnt)),
        fb=st.fb._replace(events=st.fb.events._replace(
            valid=torch.zeros_like(st.fb.events.valid))))
    want = tgraphs.clone_state(cleared)
    got = eng._spec_step(tgraphs.clone_state(cleared), bound + 5, True)
    _assert_same(got, want, "drained under the gate")


@pytest.mark.parametrize("inject", [0, 2])
@pytest.mark.parametrize("W", [1, 2, 4])
def test_run_reads_one_flag_per_chunk(W, inject):
    eng, _ = _port("phold", batch_impl="model", opt_window=W,
                   inject_straggler_every=inject)
    n = 30
    st = eng.run(eng.init(), n)
    steps, reads = predict_reads(n, W, inject)
    tot = eng.totals(st)
    assert eng.syncs == reads and eng.dispatches == 2
    assert tot["spec_commits"] + tot["rollbacks"] == steps
    assert int(st.epoch[0]) == n
    assert eng.run(st, 0) is st and eng.syncs == reads


def test_host_read_schedulers_add_one_read_per_sub_epoch():
    eng, spec = _port("queueing", opt_window=2)
    n = spec["n_epochs"]
    eng.run(eng.init(), n)
    steps, reads = predict_reads(n, 2, 0)
    assert eng.graphs is None and eng.syncs == reads + 3 * steps


# -- on the card -------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _eager_spec(eng, st, n, drain):
    """``n`` epochs of the speculative step run eagerly, one read a step."""
    bound = st.epoch.reshape(-1) + n
    while int(teng.spec_flag(st, bound, drain)[0]):
        st = eng._spec_step(st, bound, drain)
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("inject", [0, 2])
def test_graphed_speculation_equals_eager_steps_on_card(inject):
    from repro_torch.kernels.event_apply import event_apply_cuda
    dev = _card()
    eng, spec = _port("phold", device=dev, batch_impl="model", opt_window=2,
                      inject_straggler_every=inject)
    assert eng.graphs is not None
    n = spec["n_epochs"] + 5
    init = eng.init()
    eager = _eager_spec(eng, tgraphs.clone_state(init), n, False)
    before, syncs = event_apply_cuda.launches, eng.syncs
    got = tgraphs.clone_state(eng.run(tgraphs.clone_state(init), n))
    _assert_same(got, eager, "graphed speculative run vs eager steps")
    steps, reads = predict_reads(n, 2, inject)
    assert eng.syncs - syncs == reads
    # W + 1 launches a step, replayed or in the one eager warm-up step.
    assert event_apply_cuda.launches - before == 3 * (
        steps + eng.graphs.warmup_steps)
    drained = eng.run_until_drained(tgraphs.clone_state(init), n)
    _assert_same(drained, eager, "graphed speculative drain vs eager")
    for config in ("spec-w2", "spec-inject"):
        model = treg.get_workload("phold", **spec["model_kw"])
        tconf.run_conformance(model, dict(tconf.SWEEP[config],
                                          batch_impl="model"),
                              n_epochs=spec["n_epochs"],
                              engine_kw=spec["engine_kw"], device=dev)


@pytest.mark.cuda
def test_replayed_step_at_the_bound_is_a_fixpoint_on_card():
    dev = _card()
    eng, _ = _port("phold", device=dev, batch_impl="model", opt_window=2)
    eng.run(eng.init(), 11)
    before = tgraphs.clone_state(eng.graphs.static)
    for length in (4, 16):
        eng.graphs.replay(("spec", 2, False), length)
    torch.cuda.synchronize()
    _assert_same(eng.graphs.static, before, "replays past the bound")
    assert eng.graphs.read(("spec", 2, False)) == [0, 0]


@pytest.mark.cuda
def test_stacked_speculative_drain_replays_its_graphs_on_card():
    dev = _card()
    eng, spec = _port("phold", device=dev, batch_impl="model", opt_window=2,
                      inject_straggler_every=2)
    n = spec["n_epochs"]
    st = tgraphs.clone_state(eng.run_replicated_drained(
        eng.init_replicated(range(3)), n))
    assert eng.rep_graphs is not None and eng.rep_graphs.captures > 0
    for r in range(3):
        ind = eng.run_until_drained(eng.init(seed=r), n)
        _assert_same(eng.replication(st, r), ind, f"replication {r}")
    cpu, _ = _port("phold", batch_impl="model", opt_window=2,
                   inject_straggler_every=2)
    want = cpu.run_replicated_drained(cpu.init_replicated(range(3)), n)
    _assert_same(interop.engine_state_from_numpy(
        interop.engine_state_to_numpy(st), "cpu"), want, "card vs CPU")
