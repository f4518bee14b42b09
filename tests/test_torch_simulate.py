"""The simulator's CLI in the port (``repro_torch.launch.simulate``) on the
CPU, held to the JAX package's CLI (``repro.launch.simulate``).

* ``main(argv)`` with ``--device cpu`` on phold and wireless at small
  sizes under ``--verify``, ``--drain`` and ``--opt-window 2``, and over
  ``--devices 2`` (spawned gloo ranks): the printed ``stats`` dict, the
  events and the epochs equal the JAX CLI's for the same flags (run in
  subprocesses, all at once; at D = 2 on 2 fake host devices), and the
  verified line where ``--verify`` asks for it;
* the timed window's line: no capture and no replay on the CPU, one host
  sync per epoch under the rounds scheduler;
* the exit contract: a dirty run (a route buffer below one epoch's
  emissions) exits nonzero in both packages;
* without ``--device`` and without a card the CLI refuses to run, and
  ``--verify`` needs ``--dist dyadic``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import simulate as tsim  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: seconds a JAX CLI subprocess may run.
JAX_TIMEOUT = 300
SMALL = ["--dist", "dyadic", "--n-buckets", "8", "--bucket-cap", "64",
         "--route-cap", "512", "--fallback-cap", "512"]
PHOLD = ["--workload", "phold", "--objects", "16", "--model-kw",
         "state_nodes=64", "--model-kw", "initial_events=4"] + SMALL
WIRELESS = ["--workload", "wireless", "--objects", "16", "--model-kw",
            "n_channels=3", "--model-kw", "max_calls=3"] + SMALL
#: name → the flags both CLIs run.
CASES = {
    "phold-verify": PHOLD + ["--epochs", "16", "--verify"],
    "phold-drain-opt": PHOLD + ["--epochs", "16", "--drain",
                                "--opt-window", "2", "--verify"],
    "wireless-drain": WIRELESS + ["--epochs", "200", "--drain", "--verify"],
    "phold-d2-a2a": PHOLD + ["--epochs", "16", "--devices", "2",
                             "--route", "a2a", "--verify"],
    "wireless-d2-steal": WIRELESS + ["--epochs", "200", "--drain",
                                     "--devices", "2", "--steal",
                                     "--verify"],
}
DIRTY = PHOLD + ["--epochs", "8", "--route-cap", "16"]


def _devices(argv) -> int:
    return int(argv[argv.index("--devices") + 1]) if "--devices" in argv \
        else 1


def parse(out: str) -> dict:
    got = {"verified": "verified bit-exact vs sequential oracle" in out}
    for line in out.splitlines():
        if line.startswith("[simulate] stats: "):
            got["stats"] = ast.literal_eval(line.split(": ", 1)[1])
        elif " events over " in line:
            got["head"] = line
            words = line.split()
            got["events"] = int(words[words.index("events") - 1])
            got["epochs"] = int(words[words.index("epochs") - 1])
        elif line.startswith("[simulate] timed window"):
            got["window"] = line
    return got


def run_port(argv, capsys) -> dict:
    tsim.main(argv + ["--device", "cpu"])
    return parse(capsys.readouterr().out)


@pytest.fixture(scope="module")
def runs():
    """Every case and the dirty run through the JAX CLI, as processes that
    run together, each at its own fake host device count; meanwhile every
    case through the port's CLI on the CPU, once."""
    import contextlib
    import io
    procs = {}
    for name, argv in dict(CASES, dirty=DIRTY).items():
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(ROOT / "src"),
                   XLA_FLAGS=f"--xla_force_host_platform_device_count="
                             f"{_devices(argv)}")
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "repro.launch.simulate", *argv], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    port = {}
    try:
        for name, argv in CASES.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                tsim.main(argv + ["--device", "cpu"])
            port[name] = parse(buf.getvalue())
    finally:
        jax = {}
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=JAX_TIMEOUT)
            jax[name] = (p.returncode, stdout, stderr)
    return {"jax": jax, "port": port}


@pytest.mark.parametrize("name", list(CASES))
def test_stats_equal_the_jax_cli(name, runs):
    argv = CASES[name]
    rc, out, err = runs["jax"][name]
    assert rc == 0, out + err
    want = parse(out)
    got = runs["port"][name]
    assert got["stats"] == want["stats"], name
    assert (got["events"], got["epochs"]) == (want["events"],
                                              want["epochs"])
    assert got["verified"] == want["verified"] == ("--verify" in argv)
    if "--opt-window" in argv:
        assert got["stats"]["spec_commits"] > 0
    if "--steal" in argv:
        assert got["stats"]["stolen"] > 0
    assert f" D={_devices(argv)}: " in got["head"]


def test_two_ranks_equal_one_device(runs):
    one, two = runs["port"]["phold-verify"], runs["port"]["phold-d2-a2a"]
    assert two["stats"] == one["stats"] and two["verified"]


def test_timed_window_line_on_the_cpu(capsys):
    got = run_port(PHOLD + ["--epochs", "12"], capsys)
    line = got["window"]
    assert "timed window on cpu: 12 epochs" in line
    # the rounds scheduler reads its round count once per epoch; no graphs
    # and no kernel on the CPU.
    assert "host syncs 12, graph captures 0, replays 0" in line
    assert line.endswith("kernel launches: none")


def test_dirty_run_exits_nonzero(runs, capsys):
    rc, out, err = runs["jax"]["dirty"]
    assert rc != 0 and "UNCLEAN" in out + err
    with pytest.raises(SystemExit) as e:
        tsim.main(DIRTY + ["--device", "cpu"])
    assert "UNCLEAN" in str(e.value.code)
    got = parse(capsys.readouterr().out)
    assert got["stats"]["route_overflow"] > 0
    assert got["stats"] == parse(out)["stats"]


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tsim.main(PHOLD + ["--epochs", "1"])
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.simulate",
                        *PHOLD, "--epochs", "1"], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert "[simulate] stats" not in r.stdout


def test_verify_needs_dyadic():
    with pytest.raises(SystemExit, match="--dist dyadic"):
        tsim.main(["--workload", "phold", "--dist", "exponential",
                   "--verify", "--device", "cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("drain,opt_window", [(False, 0), (True, 0),
                                              (True, 2)])
def test_prepare_leaves_no_capture_in_the_window_on_card(drain, opt_window):
    # ``prepare`` captures (and replays once, on a copy) what the timed
    # call replays: the call captures nothing and lands on the bits of a
    # fresh engine that was never prepared.
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import numpy as np
    from repro_torch.core.engine import EngineConfig, ParsirEngine
    from repro_torch.interop import engine_state_to_numpy, numpy_leaves
    from repro_torch.workloads.registry import conformance_spec, get_workload
    spec = conformance_spec("phold")
    model = get_workload("phold", **spec["model_kw"])
    cfg = EngineConfig(lookahead=0.5, batch_impl="model",
                       opt_window=opt_window, **spec["engine_kw"])
    n = 40

    def run(eng, st):
        return (eng.run_until_drained(st, n) if drain else eng.run(st, n))
    eng = ParsirEngine(model, cfg, device="cuda")
    st = eng.init()
    eng.prepare(st, n, drain=drain)
    caps = eng.graphs.captures
    assert caps > 0 and eng.dispatches == 2
    got = engine_state_to_numpy(run(eng, st))
    assert eng.graphs.captures == caps
    fresh = ParsirEngine(model, cfg, device="cuda")
    want = engine_state_to_numpy(run(fresh, fresh.init()))
    for a, b in zip(numpy_leaves(got), numpy_leaves(want), strict=True):
        np.testing.assert_array_equal(a, b)
