"""Speculation across devices over ``torch.distributed``: D gloo ranks on
the CPU, each its own process (``repro_torch.core.dist.spawn``).

* the five speculation points that need a second device (``spec-a2a``,
  ``spec-packed-a2a``, ``spec-weighted``, ``spec-steal``,
  ``spec-adaptive``) at D = 2 and D = 4 on phold, phold-hotspot and
  queueing: clean, the oracle's processed count and pending multiset, the
  object state bit for bit; windows rolled back, loans and rebalances
  engaged;
* the reference's D = 4 straggler test: phold drained under ``spec-a2a``,
  ``spec-w2``, ``spec-global``, ``spec-steal``, ``spec-adaptive`` and
  ``spec-inject``, rollbacks and a rebalance in every adaptive config,
  the oracle's bits;
* at D = 4, the ranks equal to the JAX engine's devices leaf by leaf under
  ``spec-a2a`` and ``spec-steal``;
* the conformance CLI spawning its own ranks.

Timing as in ``test_torch_multidevice.py``: one spawn per D, every
collective and spawn under its own timeout.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dist import spawn  # noqa: E402
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.testing import multidevice as tmd  # noqa: E402
from test_torch_multidevice import (  # noqa: E402
    COLLECTIVE_TIMEOUT, ROOT, SPAWN_TIMEOUT, WORKLOADS,
    assert_ranks_equal_jax, jax_states)

SPEC = [c for c in tconf.MULTI_DEVICE if tconf.SWEEP[c].get("opt_window")]
CASES = [(D, name, c) for D in (2, 4) for name in WORKLOADS for c in SPEC]
#: the reference's D = 4 rollback sweep (tests/test_speculation.py).
ROLLBACK = ["spec-a2a", "spec-w2", "spec-global", "spec-steal",
            "spec-adaptive", "spec-inject"]
JAX_CONFIGS = ["spec-a2a", "spec-steal"]


def _spawn(D, tasks):
    return spawn(tmd.tasks_rank, D, tasks, timeout=COLLECTIVE_TIMEOUT,
                 join_timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def four():
    ranks = _spawn(4, [("sweep_rank", (WORKLOADS, SPEC)),
                       ("sweep_rank", (["phold"], ROLLBACK, "cpu", True)),
                       ("states_rank", ("phold", JAX_CONFIGS))])
    return {"sweep": ranks[0][0], "drain": ranks[0][1],
            "states": [r[2] for r in ranks]}


@pytest.fixture(scope="module")
def two():
    return {"sweep": _spawn(2, [("sweep_rank", (WORKLOADS, SPEC))])[0][0]}


def test_the_five_points_need_a_second_device():
    assert SPEC == ["spec-a2a", "spec-packed-a2a", "spec-weighted",
                    "spec-steal", "spec-adaptive"]
    for name in WORKLOADS:
        assert not set(SPEC) & set(tconf.supported_configs(name))
        assert set(SPEC) <= set(tconf.supported_configs(name, devices=2))


@pytest.mark.parametrize("D,name,config", CASES,
                         ids=[f"D{d}-{n}-{c}" for d, n, c in CASES])
def test_spec_sweep_is_oracle_exact(request, D, name, config):
    rep = request.getfixturevalue({2: "two", 4: "four"}[D])["sweep"][
        name, config]
    assert "error" not in rep, rep.get("error")
    tot = rep["totals"]
    assert tot["processed"] > 0 and rep["pending"] > 0
    # every device ticks one meter per window
    assert (tot["spec_commits"] + tot["rollbacks"]) % D == 0
    assert tot["spec_commits"] + tot["rollbacks"] > 0


@pytest.mark.parametrize("D", [2, 4])
def test_windows_roll_back_and_stages_engage(request, D):
    sweep = request.getfixturevalue({2: "two", 4: "four"}[D])["sweep"]
    for name in WORKLOADS:
        res = {c: sweep[name, c] for c in SPEC}
        tconf.check_expectations(res, D, rollbacks=True, rebalances=1,
                                 stolen=name == "phold-hotspot")


@pytest.mark.parametrize("config", ROLLBACK)
def test_four_device_stragglers_roll_back_and_stay_exact(four, config):
    rep = four["drain"]["phold", config]
    assert "error" not in rep, rep.get("error")
    assert rep["totals"]["rollbacks"] > 0


def test_four_device_rollback_sweep_expectations(four):
    res = {c: four["drain"]["phold", c] for c in ROLLBACK}
    tconf.check_expectations(res, 4, rollbacks=True, rebalances=1,
                             stolen=True)


@pytest.fixture(scope="module")
def jax_four(tmp_path_factory):
    return jax_states(tmp_path_factory.mktemp("jax4spec"), 4, "phold",
                      JAX_CONFIGS)


@pytest.mark.parametrize("config", JAX_CONFIGS)
def test_spec_ranks_equal_the_jax_engine_leaf_by_leaf(four, jax_four,
                                                      config):
    assert_ranks_equal_jax(four["states"], jax_four[config], config, 4)
    assert four["states"][0][config]["totals"]["rollbacks"] > 0


def test_conformance_cli_spawns_its_ranks():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    cmd = [sys.executable, "-m", "repro_torch.testing.conformance",
           "--workload", "phold-hotspot", "--devices", "2", "--configs",
           "steal-a2a,adaptive-a2a,spec-a2a,spec-steal", "--expect-stolen",
           "--expect-rebalances", "1", "--expect-rollbacks",
           "--timeout", str(SPAWN_TIMEOUT), "--device", "cpu"]
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=SPAWN_TIMEOUT + 60)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("OK phold-hotspot") == 4
    assert "CONFORMANCE PASS" in r.stdout
