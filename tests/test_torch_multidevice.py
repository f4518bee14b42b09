"""The multi-device engine over ``torch.distributed``: D gloo ranks on the
CPU, each its own process (``repro_torch.core.dist.spawn``).

* every multi-device SWEEP point but speculation (``batch-a2a``,
  ``steal-*``, ``packed-a2a``, ``steal-packed``, ``packed-adaptive``,
  ``weighted``, ``adaptive*``) and ``batch-model``, at D = 2 and D = 4, on
  phold, phold-hotspot and queueing: clean, the oracle's processed count
  and pending multiset, the object state bit for bit; loans and
  rebalances engaged;
* the gathered state digested as the oracle's golden digests are: equal
  to the pinned ``phold/small`` and ``phold-hotspot/small``;
* a non-divisible object count (18 over 4 devices, pad rows);
* the out-of-bounds rule through the real a2a exchange;
* drains across devices (conservative under four configs, and the
  adaptive-W controller's speculative drain) against the oracle;
* a group of one equal to the engine without a group, bit for bit;
* at D = 4, the ranks equal to the JAX engine's devices (4 fake host
  devices in a subprocess) leaf by leaf under ``batch-a2a``,
  ``steal-a2a``, ``adaptive-a2a`` and ``steal-packed``: object state,
  calendar, fallback, per-device Stats, bounds, load;
* at D = 2, phold-hotspot at the bench's scale and route_cap under its
  loan and adaptive rungs equal to the JAX engine's leaf by leaf, route
  overflow included;
* the device axis's collectives bit-exact on mixed dtypes, and a hung rank
  failing its spawn instead of hanging the suite.

Timing: each spawn starts its ranks once and runs many configs; every
collective of a rank times out after ``COLLECTIVE_TIMEOUT`` s and every
spawn after ``SPAWN_TIMEOUT`` s, the JAX subprocess after ``JAX_TIMEOUT``.
The speculation points run in ``test_torch_spec_multidevice.py``.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dist import spawn  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.testing import golden as tgolden  # noqa: E402
from repro_torch.testing import multidevice as tmd  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: seconds a rank waits in one collective, a spawn runs, a JAX child runs.
COLLECTIVE_TIMEOUT, SPAWN_TIMEOUT, JAX_TIMEOUT = 120, 420, 420
WORKLOADS = ["phold", "phold-hotspot", "queueing"]
POINTS = [c for c in tconf.MULTI_DEVICE
          if not tconf.SWEEP[c].get("opt_window")] + ["batch-model"]
SWEEP_CASES = [(D, name, c) for D in (2, 4) for name in WORKLOADS
               for c in POINTS if c in tconf.supported_configs(name, D)]
DIGEST_CASES = [(k, c) for k in ("phold/small", "phold-hotspot/small")
                for c in ("batch-a2a", "steal-a2a", "adaptive-a2a")]
ODD_CONFIGS = ["batch-allgather", "steal-a2a", "adaptive"]
JAX_CONFIGS = ["batch-a2a", "steal-a2a", "adaptive-a2a", "steal-packed"]
DRAINS = ["batch-a2a", "steal-a2a", "adaptive-a2a", "batch-model"]
#: epochs of phold-hotspot at the bench's scale (chip_smoke.py's rungs).
BENCH_EPOCHS = 16


def _spawn(D, tasks):
    return spawn(tmd.tasks_rank, D, tasks, timeout=COLLECTIVE_TIMEOUT,
                 join_timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def four():
    """One spawn of 4 ranks: the sweep, the digests, the non-divisible
    layout, the a2a oob rule, and the states held against JAX."""
    keys = ("phold/small", "phold-hotspot/small")
    tasks = [("sweep_rank", (WORKLOADS, POINTS))]
    tasks += [("digest_rank", (key, [c for k, c in DIGEST_CASES if k == key]))
              for key in keys]
    tasks += [("sweep_rank", (["phold"], ODD_CONFIGS, "cpu", False,
                              {"n_objects": 18})),
              ("a2a_oob_rank", ()),
              ("states_rank", ("phold", JAX_CONFIGS))]
    ranks = _spawn(4, tasks)
    sweep, d1, d2, odd, _, _ = ranks[0]
    return {"sweep": sweep, "digests": {"phold/small": d1,
                                        "phold-hotspot/small": d2},
            "odd": odd, "oob": [r[4] for r in ranks],
            "states": [r[5] for r in ranks]}


@pytest.fixture(scope="module")
def two():
    """One spawn of 2 ranks: the sweep, batch-model against rounds, the
    drains (conservative, and the adaptive-W controller's), phold-hotspot
    at the bench's scale."""
    ranks = _spawn(2, [("sweep_rank", (WORKLOADS, POINTS)),
                       ("states_rank", ("phold", ["batch-allgather",
                                                  "batch-model"])),
                       ("sweep_rank", (["phold-hotspot"], DRAINS, "cpu",
                                       True)),
                       ("sweep_rank", (["phold"], ["spec-a2a"], "cpu", True,
                                       None, {"opt_adaptive": True})),
                       ("bench_states_rank", ("phold-hotspot",
                                              tmd.BENCH_HOT_RUNGS,
                                              BENCH_EPOCHS))])
    return {"sweep": ranks[0][0], "states": [r[1] for r in ranks],
            "drain": ranks[0][2], "controller": ranks[0][3],
            "bench": [r[4] for r in ranks]}


def _sweep(request, D):
    return request.getfixturevalue({2: "two", 4: "four"}[D])["sweep"]


@pytest.mark.parametrize("D,name,config", SWEEP_CASES,
                         ids=[f"D{d}-{n}-{c}" for d, n, c in SWEEP_CASES])
def test_sweep_is_oracle_exact(request, D, name, config):
    rep = _sweep(request, D)[name, config]
    assert "error" not in rep, rep.get("error")
    tot = rep["totals"]
    assert tot["processed"] > 0 and rep["pending"] > 0
    cfg = tconf.SWEEP[config]
    if cfg.get("placement") == "adaptive":
        assert tot["rebalances"] >= D and tot["rebalances"] % D == 0
    else:
        assert tot["rebalances"] == tot["migrated"] == 0
    if not cfg.get("steal"):
        assert tot["stolen"] == 0


@pytest.mark.parametrize("D", [2, 4])
def test_loans_and_migrations_engage(request, D):
    sweep = _sweep(request, D)
    got = {k: v for k, v in sweep.items() if k[0] == "phold-hotspot"}
    res = {c: v for (_, c), v in got.items()}
    tconf.check_expectations(res, D, stolen=True, rebalances=1)
    # under the equal split the hot objects overload one device, so every
    # loan config lends (under adaptive placement the weighted start may
    # balance the loads, as it does in the JAX engine at D = 2).
    assert all(res[c]["totals"]["stolen"] > 0 for c in res
               if tconf.SWEEP[c].get("steal")
               and tconf.SWEEP[c].get("placement") != "adaptive")
    assert sum(res[c]["totals"]["migrated"] for c in res) > 0


@pytest.mark.parametrize("key,config", DIGEST_CASES,
                         ids=[f"{k}-{c}" for k, c in DIGEST_CASES])
def test_gathered_state_matches_the_pinned_digest(four, key, config):
    assert four["digests"][key][config] == tgolden.PINNED[key]


@pytest.mark.parametrize("config", ODD_CONFIGS)
def test_non_divisible_objects_conform(four, config):
    # 18 objects over 4 devices: ranges 4/5/4/5 (adaptive: a wider pad).
    rep = four["odd"]["phold", config]
    assert "error" not in rep, rep.get("error")
    assert rep["totals"]["processed"] > 0


def test_a2a_counts_oob_on_the_receiving_device(four):
    assert four["oob"] == [0, 0, 1, 0]


def _flat(st) -> dict:
    """A host EngineState (either package's) as {path: array}."""
    out = {f"cal.{f}": np.asarray(getattr(st.cal, f))
           for f in ("ts", "seed", "payload", "cnt")}
    out.update({f"fb.{f}": np.asarray(getattr(st.fb.events, f))
                for f in ("dst", "ts", "seed", "payload", "valid")})
    out.update({f"obj.{k}": np.asarray(v) for k, v in st.obj.items()})
    out.update({f"stats.{f}": np.asarray(getattr(st.stats, f))
                for f in st.stats._fields})
    out.update(epoch=np.asarray(st.epoch), bounds=np.asarray(st.bounds),
               load=np.asarray(st.load))
    return out


_JAX_CHILD = textwrap.dedent("""
    import json
    import sys
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.core.engine import AXIS, EngineConfig, ParsirEngine
    from repro.testing.conformance import SWEEP
    from repro.workloads.registry import conformance_spec, get_workload

    D, name, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    configs = sys.argv[4].split(",")
    bench = json.loads(sys.argv[5]) if len(sys.argv) > 5 else None
    assert len(jax.devices()) == D, jax.devices()
    mesh = Mesh(np.array(jax.devices()), (AXIS,))
    spec = conformance_spec(name)
    model = get_workload(name, **(bench["model_kw"] if bench
                                  else spec["model_kw"]))
    arrays = {}
    for config in configs:
        kw = (bench["engine_kw"][config] if bench
              else dict(spec["engine_kw"], **SWEEP[config]))
        cfg = EngineConfig(lookahead=model.params.lookahead, **kw)
        eng = ParsirEngine(model, cfg, mesh=mesh)
        n = bench["n_epochs"] if bench else spec["n_epochs"]
        st = jax.device_get(eng.run(eng.init(), n))
        leaves = dict(FLAT(st))
        arrays.update({f"{config}/{k}": v for k, v in leaves.items()})
    np.savez(out, **arrays)
    print("JAX_OK")
""")


def jax_states(tmp_path, D, name, configs, bench=None) -> dict:
    """The JAX engine's final global states on D fake host devices, run in
    a subprocess (the device count is fixed at the first JAX use): each
    config at the workload's conformance recipe, or, with ``bench``
    (``{"model_kw", "engine_kw": {config: kw}, "n_epochs"}``), as given."""
    import inspect
    src = inspect.getsource(_flat).replace("def _flat", "def FLAT")
    out = tmp_path / "jax_states.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={D}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    code = "import numpy as np\n" + src + _JAX_CHILD
    args = [str(D), name, str(out), ",".join(configs)]
    if bench is not None:
        args.append(json.dumps(bench))
    r = subprocess.run([sys.executable, "-c", code, *args], env=env,
                       capture_output=True,
                       text=True, timeout=JAX_TIMEOUT)
    assert r.returncode == 0 and "JAX_OK" in r.stdout, r.stdout + r.stderr
    z = np.load(out)
    return {c: {k.split("/", 1)[1]: z[k] for k in z.files
                if k.startswith(c + "/")} for c in configs}


def assert_ranks_equal_jax(port_ranks, jax_global, config, D):
    """Rank r's every leaf equal to shard r of the JAX engine's."""
    for r, ranks in enumerate(port_ranks):
        got = _flat(ranks[config]["state"])
        assert set(got) == set(jax_global), (set(got) ^ set(jax_global))
        for path, want in jax_global.items():
            shard = np.split(want, D, axis=0)[r]
            mine = got[path]
            if path.endswith("seed"):
                mine = mine.astype(np.uint32)
            if path.startswith("stats."):
                mine, shard = mine.astype(np.int64), shard.astype(np.int64)
            assert mine.shape == shard.shape, (config, r, path)
            np.testing.assert_array_equal(
                mine, shard, err_msg=f"{config} rank {r} {path}")


@pytest.fixture(scope="module")
def jax_four(tmp_path_factory):
    return jax_states(tmp_path_factory.mktemp("jax4"), 4, "phold",
                      JAX_CONFIGS)


@pytest.mark.parametrize("config", JAX_CONFIGS)
def test_ranks_equal_the_jax_engine_leaf_by_leaf(four, jax_four, config):
    assert_ranks_equal_jax(four["states"], jax_four[config], config, 4)
    if config.startswith("steal"):
        assert four["states"][0][config]["totals"]["stolen"] > 0
    if "adaptive" in config:
        assert four["states"][0][config]["totals"]["migrated"] > 0


@pytest.fixture(scope="module")
def jax_bench(tmp_path_factory):
    from repro_torch.workloads.registry import bench_kw
    model_kw, _ = bench_kw("phold-hotspot")
    engine_kw = {c: bench_kw("phold-hotspot", **o)[1]
                 for c, o in tmd.BENCH_HOT_RUNGS.items()}
    bench = {"model_kw": model_kw, "engine_kw": engine_kw,
             "n_epochs": BENCH_EPOCHS}
    return jax_states(tmp_path_factory.mktemp("jaxbench"), 2, "phold-hotspot",
                      list(engine_kw), bench)


@pytest.mark.parametrize("config", list(tmd.BENCH_HOT_RUNGS))
def test_bench_route_cap_overflows_as_in_the_jax_engine(two, jax_bench,
                                                        config, capsys):
    # phold-hotspot at the bench's scale and route_cap (8192: an a2a pair
    # buffer of 4096 at D = 2) overflows the route buffer in the JAX engine
    # too, device by device alike: the configuration's shortfall, not the
    # port's (chip_smoke.py runs these rungs with route_cap 32768).
    assert_ranks_equal_jax(two["bench"], jax_bench[config], config, 2)
    ovf = jax_bench[config]["stats.route_overflow"].astype(np.int64)
    late = jax_bench[config]["stats.late_events"].astype(np.int64)
    assert ovf.sum() > 0 and late.sum() > 0
    # the counters chip_smoke.py holds the card's ranks to.
    for k, want in tmd.BENCH_HOT_JAX[config].items():
        assert jax_bench[config][f"stats.{k}"].tolist() == want, k
    with capsys.disabled():
        print(f"\n[{config} at route_cap 8192, D = 2, {BENCH_EPOCHS} "
              f"epochs] route_overflow per device {ovf.tolist()}, "
              f"late_events {late.tolist()}, both engines")


def test_batch_model_equals_rounds_across_devices(two):
    # the JAX batch-model path cannot run on this jax (ROADMAP C1): the
    # port's is held to the oracle (the sweep) and to its own rounds run.
    for r in two["states"]:
        a, b = r["batch-allgather"], r["batch-model"]
        assert a["totals"] == b["totals"]
        for k in a["state"].obj:
            np.testing.assert_array_equal(a["state"].obj[k],
                                          b["state"].obj[k], err_msg=k)
        np.testing.assert_array_equal(a["state"].cal.cnt, b["state"].cal.cnt)


@pytest.mark.parametrize("config", DRAINS)
def test_drains_across_devices_are_oracle_exact(two, config):
    # run_until_drained: the gated step sums the events in flight over the
    # ranks every epoch, the flag is one all_sum per DRAIN_CHUNK.
    rep = two["drain"]["phold-hotspot", config]
    assert "error" not in rep, rep.get("error")
    assert rep["totals"]["processed"] > 0


def test_adaptive_window_controller_across_devices(two):
    # opt_adaptive: every rank reads the same summed meters and retunes
    # the same width, chunk by chunk.
    rep = two["controller"]["phold", "spec-a2a"]
    assert "error" not in rep, rep.get("error")
    assert rep["totals"]["rollbacks"] > 0


def test_group_of_one_equals_the_plain_engine():
    got = spawn(tmd.plain_equal_rank, 1, "phold",
                ["batch-allgather", "steal-a2a", "adaptive-a2a", "spec-a2a"],
                timeout=COLLECTIVE_TIMEOUT, join_timeout=SPAWN_TIMEOUT)
    assert got == [["batch-allgather", "steal-a2a", "adaptive-a2a",
                    "spec-a2a"]]


def test_collectives_are_bit_exact_on_mixed_dtypes():
    D = 3
    ranks = spawn(tmd.comm_rank, D, timeout=COLLECTIVE_TIMEOUT,
                  join_timeout=SPAWN_TIMEOUT)
    sent = [r["sent"] for r in ranks]
    for me, r in enumerate(ranks):
        for k in ("f", "seed", "i", "b", "empty"):
            want = np.stack([s[k] for s in sent])
            np.testing.assert_array_equal(r["gathered"][k].view(np.uint8),
                                          want.view(np.uint8), err_msg=k)
            # all_to_all: row s of mine is row `me` of rank s's
            np.testing.assert_array_equal(
                r["swapped"][k].view(np.uint8),
                np.stack([s[k][me] for s in sent]).view(np.uint8),
                err_msg=k)
        for i in range(5):
            np.testing.assert_array_equal(
                r["gathered"]["ev"][i], np.stack([s["ev"][i] for s in sent]))
        assert r["scalar"]["k"].tolist() == [0, 7, 14]
        assert r["sum"] == 6
        assert r["calls"] == 4 and r["bytes"] > 0


def test_a_hung_rank_fails_its_spawn_in_time():
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        spawn(tmd.hang_rank, 2, timeout=3, join_timeout=60)
    assert time.monotonic() - t0 < 60
