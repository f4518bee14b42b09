"""The engine's CUDA graphs (``repro_torch.core.graphs``).

On the CPU: the graph lengths that make up an epoch count, and that the
engine runs its loops eagerly there.  On the card (marked ``cuda``, skipped
without a device; JAX is not needed):

* the graphed ``run`` and ``run_until_drained`` equal a loop of eager
  ``step``s leaf by leaf on the conformance recipes, and pass conformance
  against the oracle;
* a new epoch count needs no new capture;
* the kernel's launch counter counts every replayed launch;
* a step that reads a device value on the host fails to capture, and the
  call raises instead of falling back to the eager loop;
* the packed and ltf schedulers, whose loop bounds are host reads, build no
  graphs and end every workload's recipe with the oracle's and the CPU's
  bits;
* the replicated drain replays graphs of the stacked step under
  ``batch-model`` (one ``event_apply`` launch an epoch, one flag read a
  chunk, a new set of graphs for a new R) and runs eagerly under
  ``rounds``; each replication equals its own graphed drain, the stack the
  CPU's bits and each replication its oracle.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import graphs as tgraphs  # noqa: E402
from repro_torch.core.pipeline.config import EngineConfig  # noqa: E402
from repro_torch.kernels.event_apply import event_apply_cuda  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.workloads import registry as treg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K = teng.DRAIN_CHUNK


def test_graph_lengths_split_any_count():
    assert K == 16 and tgraphs.LENGTHS == (1, 2, 4, 8, 16)
    for n in range(0, 70):
        parts = tgraphs.split(n)
        assert sum(parts) == n and set(parts) <= set(tgraphs.LENGTHS)
        assert parts == sorted(parts, reverse=True)
    assert tgraphs.split(37) == [16, 16, 4, 1]


def test_state_tree_helpers():
    spec = treg.conformance_spec("queueing")
    model = treg.get_workload("queueing", **spec["model_kw"])
    eng = teng.ParsirEngine(model, EngineConfig(lookahead=0.5,
                                                **spec["engine_kw"]),
                            device="cpu")
    assert eng.graphs is None          # the CPU runs the loops eagerly
    st = eng.init()
    leaves = tgraphs.leaves(st)
    assert len(leaves) == 4 + 5 + 4 + 1 + 13 + 2
    twin = tgraphs.clone_state(st)
    assert all(a is not b and torch.equal(a, b)
               for a, b in zip(leaves, tgraphs.leaves(twin)))
    st2 = eng.run(twin, 3)
    tgraphs.copy_into(twin, st2)
    assert all(torch.equal(a, b) for a, b in zip(tgraphs.leaves(twin),
                                                  tgraphs.leaves(st2)))
    assert int(twin.epoch[0]) == 3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _engine(name, dev, **cfg_kw):
    spec = treg.conformance_spec(name)
    model = treg.get_workload(name, **spec["model_kw"])
    cfg = EngineConfig(lookahead=model.params.lookahead,
                       **dict(spec["engine_kw"],
                              **{"batch_impl": "model", **cfg_kw}))
    return teng.ParsirEngine(model, cfg, device=dev), spec


def _assert_same(a, b, ctx):
    for i, (x, y) in enumerate(zip(tgraphs.leaves(a), tgraphs.leaves(b),
                                   strict=True)):
        assert torch.equal(x, y), f"{ctx}: leaf {i} differs"


GRAPHED = ["phold", "phold-hotspot"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAPHED)
def test_graphed_loops_equal_eager_steps_on_card(name):
    dev = _card()
    eng, spec = _engine(name, dev)
    assert eng.graphs is not None
    n = spec["n_epochs"] + 5
    init = eng.init()
    eager = tgraphs.clone_state(init)
    for _ in range(n):
        eager = eng.step(eager)
    syncs = eng.syncs
    got = tgraphs.clone_state(eng.run(tgraphs.clone_state(init), n))
    assert eng.syncs == syncs            # run reads nothing on the host
    _assert_same(got, eager, f"{name} graphed run vs eager steps")
    drained = eng.run_until_drained(tgraphs.clone_state(init), n)
    assert eng.syncs - syncs == -(-n // K)
    _assert_same(drained, eager, f"{name} graphed drain vs eager steps")
    for config in tconf.supported_configs(name):
        tconf.check_workload(name, config, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["ltf", "batch-packed"])
def test_host_read_schedulers_run_eagerly_with_the_cpu_bits_on_card(config):
    dev = _card()
    for name in treg.all_workloads():
        card = tconf.check_workload(name, config, device=dev)  # vs the oracle
        assert card["engine"].graphs is None
        cpu = tconf.check_workload(name, config, device="cpu")
        for i, (x, y) in enumerate(zip(tgraphs.leaves(card["state"]),
                                       tgraphs.leaves(cpu["state"]),
                                       strict=True)):
            assert torch.equal(x.cpu(), y), f"{name}/{config}: leaf {i}"


@pytest.mark.cuda
def test_new_epoch_counts_need_no_new_capture_on_card():
    dev = _card()
    eng, _ = _engine("phold", dev)
    st = eng.init()
    for n in (37, 23, 21, 1, 0, 16, 9):
        st = eng.run(st, n)
    assert int(st.epoch[0]) == 107
    assert eng.graphs.captures == 5      # 16, 4, 1, 2, 8: each once
    before = eng.graphs.captures
    for n in (5, 31, 64):
        st = eng.run_until_drained(st, n)
    assert int(st.epoch[0]) == 207
    assert eng.graphs.captures - before == 5   # the gated 1, 4, 16, 2, 8
    assert eng.run(st, 2) is st is eng.graphs.static


@pytest.mark.cuda
def test_launch_counter_counts_replays_on_card():
    dev = _card()
    eng, _ = _engine("phold", dev)
    st = eng.init()
    before = event_apply_cuda.launches
    st = eng.run(st, 40)
    torch.cuda.synchronize()
    warm = eng.graphs.warmup_steps
    assert event_apply_cuda.launches - before == 40 + warm
    before = event_apply_cuda.launches
    st = eng.run(st, 40)                  # replays only: no capture, no warm-up
    st = eng.run_until_drained(st, 20)
    torch.cuda.synchronize()
    warm2 = eng.graphs.warmup_steps - warm
    assert event_apply_cuda.launches - before == 60 + warm2


@pytest.mark.cuda
@pytest.mark.parametrize("name,impl,R", [("phold", "model", 4),
                                         ("phold-hotspot", "model", 3),
                                         ("wireless", "rounds", 8)])
def test_replicated_drain_equals_independent_drains_on_card(name, impl, R):
    dev = _card()
    eng, spec = _engine(name, dev, batch_impl=impl)
    n = spec["n_epochs"] + 5
    before, syncs = event_apply_cuda.launches, eng.syncs
    st = eng.run_replicated_drained(eng.init_replicated(range(R)), n)
    torch.cuda.synchronize()
    graphed = impl == "model"
    assert (eng.rep_graphs is not None) == graphed
    chunks = -(-n // K)
    assert eng.syncs - syncs == chunks + (0 if graphed else n)
    if graphed:
        assert st is eng.rep_graphs.static
        assert event_apply_cuda.launches - before \
            == n + eng.rep_graphs.warmup_steps      # one launch an epoch
    st = tgraphs.clone_state(st)
    cpu, _ = _engine(name, "cpu", batch_impl=impl)
    on_cpu = cpu.run_replicated_drained(cpu.init_replicated(range(R)), n)
    for x, y in zip(tgraphs.leaves(st), tgraphs.leaves(on_cpu), strict=True):
        assert torch.equal(x.cpu(), y), f"{name}: card != CPU"
    for r in range(R):
        ref = eng.run_until_drained(eng.init(seed=r), n)
        _assert_same(eng.replication(st, r), ref, f"{name} rep {r}")
    rep = tconf.check_workload_replicated(
        name, "batch-model" if graphed else "batch-allgather",
        replications=R, device=dev)
    assert len(rep["processed"]) == R


@pytest.mark.cuda
def test_replicated_graphs_follow_the_replication_count_on_card():
    dev = _card()
    eng, _ = _engine("phold", dev)
    st = eng.run_replicated_drained(eng.init_replicated(range(2)), 21)
    first = eng.rep_graphs
    assert first.captures == 3 and int(st.epoch.sum()) == 42  # 16, 4, 1
    st = eng.run_replicated_drained(eng.init_replicated(range(2)), 37)
    assert eng.rep_graphs is first and first.captures == 3
    st = eng.run_replicated_drained(eng.init_replicated(range(5)), 16)
    assert eng.rep_graphs is not first and eng.rep_graphs.captures == 1
    assert st.epoch[:, 0].tolist() == [16] * 5
    assert eng.graphs.captures == 0   # the classic graphs are apart


CAPTURE_FAILS = r'''
import torch
from repro_torch.core import engine as teng
from repro_torch.core.pipeline.config import EngineConfig
from repro_torch.workloads import registry as treg

spec = treg.conformance_spec("phold")
model = treg.get_workload("phold", **spec["model_kw"])
inner = model.process_batch

def reads_on_the_host(state, ts_s, seed_s, pay_s, cnt_b, lookahead):
    if int(cnt_b.max()) < 0:
        raise AssertionError
    return inner(state, ts_s, seed_s, pay_s, cnt_b, lookahead)

model.process_batch = reads_on_the_host
eng = teng.ParsirEngine(model, EngineConfig(
    lookahead=0.5, batch_impl="model", **spec["engine_kw"]), device="cuda")
st = eng.init()
for call in (lambda: eng.run(st, 4), lambda: eng.run_until_drained(st, 4)):
    try:
        call()
    except RuntimeError as e:
        print("RAISED", type(e).__name__, str(e).splitlines()[0][:120])
    else:
        print("NO ERROR")
print("CAPTURES", eng.graphs.captures)
'''


@pytest.mark.cuda
def test_a_step_that_reads_the_host_raises_on_card():
    _card()
    out = subprocess.run([sys.executable, "-c", CAPTURE_FAILS], cwd=ROOT,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum(line.startswith("RAISED") for line in lines) == 2, out.stdout
    assert "NO ERROR" not in out.stdout
    assert "CAPTURES 0" in lines, out.stdout
