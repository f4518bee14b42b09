"""``batch_impl="packed"`` and ``scheduler="ltf"`` under stacked
replications (R = 3) in the port, on the CPU.

Each replication's emissions come out in the order the JAX engine's
vmapped scheduler gives that replication: ``packed`` packs each
replication on its own, ``ltf`` sorts each replication's events on their
own.  Pinned for phold and wireless at their conformance recipes, each
scheduler at its SWEEP point (``batch-packed`` with tiles of 4, ``ltf``):

* every replication equals its own ``run_until_drained``, leaf by leaf,
  and its own seeded oracle (``check_workload_replicated``);
* the whole stack equals the JAX engine's ``run_replicated_drained`` under
  the same scheduler, leaf by leaf;
* the stacked packing equals each replication's own ``pack_slice``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.pipeline.config import EngineConfig as JConfig  # noqa: E402
from repro.workloads import registry as jreg  # noqa: E402
from repro_torch.core.pipeline.packing import pack_slice  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402

from test_torch_drain import _assert_trees_equal, _host  # noqa: E402

R = 3
POINTS = {"batch-packed": tconf.SWEEP["batch-packed"],
          "ltf": tconf.SWEEP["ltf"]}
CASES = [(name, p) for name in ("phold", "wireless") for p in POINTS]
IDS = [f"{n}-{p}" for n, p in CASES]


@pytest.fixture(scope="module")
def jax_stacks():
    """The JAX engine's stacked drain of R seeds per case."""
    out = {}
    for name, point in CASES:
        spec = jreg.conformance_spec(name)
        model = jreg.get_workload(name, **spec["model_kw"])
        eng = jeng.ParsirEngine(model, JConfig(
            lookahead=0.5, **dict(spec["engine_kw"], **POINTS[point])))
        st = eng.run_replicated_drained(eng.init_replicated(range(R)),
                                        spec["n_epochs"])
        out[name, point] = jax.device_get(st)
    return out


@pytest.fixture(scope="module")
def port_stacks():
    """The port's stacked drain of R seeds per case, every replication
    held to its own seed's oracle (``check_workload_replicated``)."""
    return {(name, point): tconf.check_workload_replicated(
                name, point, replications=R, device="cpu")
            for name, point in CASES}


@pytest.mark.parametrize("name,point", CASES, ids=IDS)
def test_each_replication_equals_its_own_drain(port_stacks, name, point):
    rep = port_stacks[name, point]
    eng, st, n = rep["engine"], rep["state"], rep["n_epochs"]
    totals = eng.totals_replicated(st)
    for r in range(R):
        ref = eng.run_until_drained(eng.init(seed=r), n)
        _assert_trees_equal(_host(eng.replication(st, r)), _host(ref),
                            f"{name} {point} rep {r}")
        assert totals[r] == eng.totals(ref)


@pytest.mark.parametrize("name,point", CASES, ids=IDS)
def test_stack_equals_the_jax_engine(port_stacks, jax_stacks, name, point):
    st = port_stacks[name, point]["state"]
    _assert_trees_equal(_host(st), jax_stacks[name, point],
                        f"{name} {point} R={R} vs JAX")


@pytest.mark.parametrize("name,point", CASES, ids=IDS)
def test_every_replication_conforms(port_stacks, name, point):
    rep = port_stacks[name, point]
    assert len(rep["processed"]) == R and min(rep["processed"]) > 0


@pytest.mark.parametrize("tile", [1, 4, 64])
def test_stacked_packing_is_each_replications_own(tile):
    g = torch.Generator().manual_seed(tile)
    M, C = 6, 5
    cnt = torch.randint(0, C + 1, (R * M,), generator=g, dtype=torch.int32)
    cnt[M:2 * M] = 0                     # a replication with nothing to do
    ts = torch.rand((R * M, C), generator=g)
    seed = torch.randint(0, 2**32, (R * M, C), generator=g)
    pay = torch.rand((R * M, C), generator=g)
    stacked = pack_slice(ts, seed, pay, cnt, tile, R)
    for r in range(R):
        rows = slice(r * M, (r + 1) * M)
        own = pack_slice(ts[rows], seed[rows], pay[rows], cnt[rows], tile)
        assert stacked.tile == own.tile
        for f in ("ts", "seed", "payload", "row", "rnd", "valid", "n_tiles"):
            np.testing.assert_array_equal(getattr(stacked, f)[r].numpy(),
                                          getattr(own, f).numpy(),
                                          err_msg=f"{f} rep {r}")
