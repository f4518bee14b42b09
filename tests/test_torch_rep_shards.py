"""Stacked replications over devices in the port, the reference's two
layouts, on the CPU (2 gloo ranks, ``repro_torch.core.dist.spawn``):

* R = 3 object-sharded over D = 2 ranks (the JAX ``drain_replicated``
  under a 2-device mesh) and ``rep_shards=2`` with R = 4 (each rank two
  replications whole, collective-free), under ``batch-allgather``,
  ``batch-a2a``, ``steal-a2a`` and ``spec-w2`` (``rep_shards`` under the
  first and the last: on its one-device object axis a2a routes as
  allgather does and loans do not run), on phold and wireless, and R x D
  on phold-hotspot under ``adaptive-a2a`` and ``spec-adaptive`` (each
  replication moving its own boundaries; ``spec-adaptive`` held to the
  oracle and its own drains only):
  every replication clean and equal to its own seeded oracle and, leaf by
  leaf, to its own ``run_until_drained`` in the same layout; the ranks'
  stacks joined (``interop.join_engine_states``, along dim 1 for R x D,
  dim 0 for the rep shards) equal to the JAX engine's stack on 2 fake
  host devices leaf by leaf, and the JAX stack split back equal to each
  rank's;
* the three ``ValueError``s of ``rep_shards`` with the reference's
  messages;

One exception in the JAX engine: its stacked speculative drain over a
2-device mesh is not leaf-exact to its own drains (wireless under
``spec-w2``: replication 0's calendar holds its events in other slots than
its own ``run_until_drained``'s), while the port's is; so under R x D
speculation the ranks are held to the JAX engine's own drains of each
seed, stacked.
* ``run_campaign`` with ``devices=2`` at 4 seeds (rep_shards) and at 3
  (object-sharded) equal per replication to ``devices=1``, and at 4 its
  store's point JSON equal to the JAX runner's for the same spec.

Timing: the ranks start once (one spawn) while the JAX engine runs in two
subprocesses beside them; every collective times out after
``COLLECTIVE_TIMEOUT`` s, the spawn after ``SPAWN_TIMEOUT`` s and a JAX
child after ``JAX_TIMEOUT`` s.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.campaign import (CampaignSpec, ResultsStore,  # noqa: E402
                                  run_campaign)
from repro_torch.core.calendar import Calendar, Fallback  # noqa: E402
from repro_torch.core.dist import spawn  # noqa: E402
from repro_torch.core.events import EventBatch  # noqa: E402
from repro_torch.core.pipeline.base import EngineState, Stats  # noqa: E402
from repro_torch.testing import multidevice as tmd  # noqa: E402

from test_torch_multidevice import _flat  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COLLECTIVE_TIMEOUT, SPAWN_TIMEOUT, JAX_TIMEOUT = 120, 420, 420
WORKLOADS = ["phold", "wireless"]
#: layout → (replications, rep_shards, configs).  Under rep_shards the
#: object axis is one device, where a2a routes as allgather does and loans
#: do not run, so the layout takes the two configs that differ there.
LAYOUTS = {"rxd": (3, None, ["batch-allgather", "batch-a2a", "steal-a2a",
                             "spec-w2"]),
           "rep_shards": (4, 2, ["batch-allgather", "spec-w2"])}
#: with adaptive placement over D = 2 every replication moves its own
#: boundaries (phold-hotspot, whose hot objects make them move).
CASES = [(lay, name, c) for lay in LAYOUTS for name in WORKLOADS
         for c in LAYOUTS[lay][2]] + [
    ("rxd", "phold-hotspot", c) for c in ("adaptive-a2a", "spec-adaptive")]
#: the cases held to the JAX engine (spec-adaptive: to the oracle and its
#: own drains only, in the ranks; its JAX compile is the file's dearest).
JAX_CASES = [c for c in CASES if c[2] != "spec-adaptive"]
#: one rank task per (layout, workload): its configs.
GROUPS: dict[tuple, list] = {}
for _lay, _name, _c in CASES:
    GROUPS.setdefault((_lay, _name), []).append(_c)
CAMPAIGN = dict(workload="wireless",
                base_model_kw=dict(n_cells=6, n_channels=2, handoff_p=64,
                                   lookahead=0.5, dist="dyadic"),
                grid={"max_calls": [2, 3]},
                engine_kw=dict(lookahead=0.5, n_buckets=8, bucket_cap=64,
                               route_cap=512, fallback_cap=512),
                max_epochs=200)
SEED_SETS = [(0, 1, 2, 3), (0, 1, 2)]


_JAX_CHILD = textwrap.dedent("""
    import json
    import sys
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.campaign import CampaignSpec, ResultsStore, run_campaign
    from repro.core.engine import AXIS, EngineConfig, ParsirEngine
    from repro.testing.conformance import SWEEP
    from repro.workloads.registry import conformance_spec, get_workload

    out, cases, camp = sys.argv[1], json.loads(sys.argv[2]), \\
        json.loads(sys.argv[3])
    devs = jax.devices()
    assert len(devs) == 2, devs
    one, two = Mesh(np.array(devs[:1]), (AXIS,)), Mesh(np.array(devs), (AXIS,))
    arrays = {}
    for layout, name, config, R in cases:
        spec = conformance_spec(name)
        model = get_workload(name, **spec["model_kw"])
        cfg = EngineConfig(lookahead=model.params.lookahead,
                           **dict(spec["engine_kw"], **SWEEP[config]))
        eng = (ParsirEngine(model, cfg, mesh=two) if layout == "rxd" else
               ParsirEngine(model, cfg, mesh=one, rep_shards=2))
        st = eng.run_replicated_drained(eng.init_replicated(range(R)),
                                        spec["n_epochs"])
        leaves = FLAT(jax.device_get(st))
        if layout == "rxd" and SWEEP[config].get("opt_window"):
            # each replication's own drain, stacked (see the module doc).
            own = [FLAT(jax.device_get(eng.run_until_drained(
                eng.init(seed=r), spec["n_epochs"]))) for r in range(R)]
            leaves = {k: np.stack([o[k] for o in own]) for k in leaves}
        arrays.update({f"{layout}/{name}/{config}/{k}": v
                       for k, v in leaves.items()})
    np.savez(out, **arrays)
    errors = []
    if camp:
        spec = conformance_spec("phold")
        model = get_workload("phold", **spec["model_kw"])
        cfg = EngineConfig(lookahead=0.5, **spec["engine_kw"])
        for make in (
                lambda: ParsirEngine(model, cfg, mesh=two, rep_shards=2),
                lambda: ParsirEngine(model, cfg, mesh=one, rep_shards=2
                                     ).init_replicated([0, 1, 2]),
                lambda: ParsirEngine(model, cfg, mesh=one, rep_shards=3)):
            try:
                make()
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
    for root, kw in camp:
        kw["seeds"] = tuple(kw["seeds"])
        run_campaign(CampaignSpec(**kw), store=ResultsStore(root))
    print("JAX_ERRORS" + json.dumps(errors))
    print("JAX_OK")
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX children (stacks, errors, campaigns) started, the ranks and
    the port's campaigns run meanwhile, then the children awaited."""
    import inspect
    tmp = tmp_path_factory.mktemp("rep_shards")
    cases = [(lay, name, c, LAYOUTS[lay][0]) for lay, name, c in JAX_CASES]
    camp = [(str(tmp / "jax"), dict(CAMPAIGN, seeds=list(SEED_SETS[0]),
                                    devices=2))]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    code = ("import numpy as np\n"
            + inspect.getsource(_flat).replace("def _flat", "def FLAT")
            + _JAX_CHILD)
    # two children beside the ranks (the JAX engine's compiles dominate):
    # R x D; the rep shards, the errors and the campaign.
    parts = [([c for c in cases if c[0] == "rxd"], []),
             ([c for c in cases if c[0] == "rep_shards"], camp)]
    children = [subprocess.Popen(
        [sys.executable, "-c", code, str(tmp / f"jax{i}.npz"),
         json.dumps(part), json.dumps(cc)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (part, cc) in enumerate(parts)]
    try:
        tasks = [("replicated_states_rank",
                  (name, configs, LAYOUTS[lay][0], "cpu", LAYOUTS[lay][1]))
                 for (lay, name), configs in GROUPS.items()]
        tasks.append(("rep_shards_errors_rank", ()))
        ranks = spawn(tmd.tasks_rank, 2, tasks, timeout=COLLECTIVE_TIMEOUT,
                      join_timeout=SPAWN_TIMEOUT)
        stores = {}
        for seeds in SEED_SETS:
            for d in (1, 2):
                root = tmp / f"port{d}"
                summary = run_campaign(CampaignSpec(
                    **dict(CAMPAIGN, seeds=seeds, devices=d)),
                    store=ResultsStore(root), device="cpu")
                stores[len(seeds), d] = (summary, root)
    finally:
        done = [c.communicate(timeout=JAX_TIMEOUT) for c in children]
    jax_states = {}
    for i, (child, (out, err)) in enumerate(zip(children, done)):
        assert child.returncode == 0 and "JAX_OK" in out, out + err
        z = np.load(tmp / f"jax{i}.npz")
        for key in z.files:
            lay, name, config, path = key.split("/", 3)
            jax_states.setdefault((lay, name, config), {})[path] = z[key]
    out = done[-1][0]
    errors = json.loads(out.split("JAX_ERRORS", 1)[1].splitlines()[0])
    port = {(lay, name, config): [r[t][config] for r in ranks]
            for t, ((lay, name), configs) in enumerate(GROUPS.items())
            for config in configs}
    return {"port": port, "jax": jax_states, "errors": [r[-1] for r in ranks],
            "jax_errors": errors, "stores": stores, "jax_store": tmp / "jax"}


def _tree(flat: dict) -> EngineState:
    """``_flat``'s dict back as a tree, for ``interop``."""
    return EngineState(
        cal=Calendar(*(flat[f"cal.{f}"] for f in Calendar._fields)),
        fb=Fallback(EventBatch(*(flat[f"fb.{f}"]
                                 for f in EventBatch._fields))),
        obj={k[4:]: v for k, v in flat.items() if k.startswith("obj.")},
        epoch=flat["epoch"],
        stats=Stats(*(flat[f"stats.{f}"] for f in Stats._fields)),
        bounds=flat["bounds"], load=flat["load"])


def _joined(ranks, lay):
    axis = 1 if lay == "rxd" else 0
    return interop.join_engine_states([r["state"] for r in ranks], axis)


def _assert_flat_equal(got: dict, want: dict, ctx):
    assert set(got) == set(want), set(got) ^ set(want)
    for path, w in want.items():
        g = got[path]
        if path.endswith("seed"):
            g = g.astype(np.uint32)
        if path.startswith("stats."):
            g, w = g.astype(np.int64), w.astype(np.int64)
        assert g.shape == w.shape, (ctx, path, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{ctx} {path}")


def _assert_reports(ranks, lay, config):
    """Every rank reports every replication, in seed order, and the
    config's stages engaged."""
    R = LAYOUTS[lay][0]
    assert all(len(r["totals"]) == R and r["totals"] == ranks[0]["totals"]
               and r["epochs"] == ranks[0]["epochs"] for r in ranks)
    tot = ranks[0]["totals"]
    assert all(t["processed"] > 0 for t in tot)
    if config.startswith("steal") and lay == "rxd":
        assert sum(t["stolen"] for t in tot) > 0
    if config.startswith("spec"):
        assert all(t["spec_commits"] > 0 for t in tot)
    if "adaptive" in config:
        # each replication fired on every device and moved rows.
        assert all(t["rebalances"] > 0 and t["rebalances"] % 2 == 0
                   and t["migrated"] > 0 for t in tot)


@pytest.mark.parametrize("lay,name,config", JAX_CASES,
                         ids=[f"{a}-{b}-{c}" for a, b, c in JAX_CASES])
def test_stack_equals_the_jax_engine(runs, lay, name, config):
    ranks = runs["port"][lay, name, config]
    want = runs["jax"][lay, name, config]
    ctx = f"{lay} {name}/{config}"
    _assert_flat_equal(_flat(_joined(ranks, lay)), want, ctx)
    # and the JAX stack split back into the ranks' own.
    axis = 1 if lay == "rxd" else 0
    for r, part in enumerate(interop.split_engine_state(_tree(want), 2,
                                                        axis)):
        _assert_flat_equal(_flat(ranks[r]["state"]), _flat(part),
                           f"{ctx} rank {r}")
    _assert_reports(ranks, lay, config)


def test_speculating_adaptive_stack_over_devices(runs):
    # held in the ranks to every replication's oracle and own drain.
    _assert_reports(runs["port"]["rxd", "phold-hotspot", "spec-adaptive"],
                    "rxd", "spec-adaptive")


def test_rep_shards_errors_are_the_references(runs):
    assert runs["errors"][0] == runs["errors"][1] == runs["jax_errors"]
    assert all(runs["jax_errors"])
    assert "single-device engine mesh (got D=2)" in runs["errors"][0][0]


@pytest.mark.parametrize("seeds", SEED_SETS, ids=["rep_shards", "rxd"])
def test_campaign_over_devices_equals_one_device(runs, seeds):
    one, _ = runs["stores"][len(seeds), 1]
    two, root = runs["stores"][len(seeds), 2]
    assert two["ran"] == 2 and not two["unclean"] and not two["undrained"]
    assert [r["replications"] for r in two["results"]] \
        == [r["replications"] for r in one["results"]]
    assert all(r["dispatches"] == 2 for r in two["results"])
    if seeds != SEED_SETS[0]:
        return
    # the port's store for devices=2 is the JAX runner's, file for file.
    spec = CampaignSpec(**dict(CAMPAIGN, seeds=seeds, devices=2))
    mine = ResultsStore(root)
    theirs = ResultsStore(runs["jax_store"])
    for i in range(len(spec.points())):
        assert mine.get(spec, i) == theirs.get(spec, i), i
