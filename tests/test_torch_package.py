"""Package boundaries of the PyTorch port.

``repro_torch`` imports torch and never jax or anything of the JAX package
``repro``; ``chip_smoke.py`` imports nothing of either.  Entry points run on
the card unless the caller asks for the CPU, and a missing card is an error.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_scans_cover_the_campaign_layer():
    code = ("import pkgutil, repro_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    found = set(out.stdout.split())
    files = set(PKG.rglob("*.py"))
    for mod in ("campaign", "campaign.spec", "campaign.store",
                "campaign.runner", "launch.campaign"):
        assert f"repro_torch.{mod}" in found, mod
        path = PKG.joinpath(*mod.split("."))
        assert (path / "__init__.py" if path.is_dir()
                else path.with_suffix(".py")) in files, mod


def test_scans_cover_the_speculation_slice():
    code = ("import pkgutil, repro_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    found = set(out.stdout.split())
    files = set(PKG.rglob("*.py"))
    path = PKG / "core" / "pipeline" / "speculate.py"
    assert "repro_torch.core.pipeline.speculate" in found
    assert path in files
    assert not FORBIDDEN.findall(path.read_text())
    assert "make_spec_step" in path.read_text()


MULTI_DEVICE_MODULES = ("core.dist", "core.stealing", "core.pipeline.steal",
                        "core.pipeline.rebalance", "testing.multidevice",
                        "testing.conformance", "interop")


def test_scans_cover_the_multi_device_slice():
    code = ("import pkgutil, repro_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    found = set(out.stdout.split())
    files = set(PKG.rglob("*.py"))
    for mod in MULTI_DEVICE_MODULES:
        assert f"repro_torch.{mod}" in found, mod
        path = PKG.joinpath(*mod.split(".")).with_suffix(".py")
        assert path in files, mod
        assert not FORBIDDEN.findall(path.read_text()), mod


SIMULATE_MODULES = ("launch.simulate", "testing.docs_check")


def test_scans_cover_the_simulate_slice():
    code = ("import pkgutil, repro_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    found = set(out.stdout.split())
    files = set(PKG.rglob("*.py"))
    for mod in SIMULATE_MODULES:
        assert f"repro_torch.{mod}" in found, mod
        path = PKG.joinpath(*mod.split(".")).with_suffix(".py")
        assert path in files, mod
        assert not FORBIDDEN.findall(path.read_text()), mod
    # docs_check reads its sources and never imports torch.
    text = (PKG / "testing" / "docs_check.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(torch|numpy)", text, re.M)


TRAINING_MODULES = ("train.optimizer", "train.step", "train.loop",
                    "ft.supervisor", "checkpoint.ckpt", "launch.train",
                    "data.synthetic", "interop")


def test_scans_cover_the_training_slice():
    code = ("import pkgutil, repro_torch\n"
            "print(' '.join(m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    found = set(out.stdout.split())
    files = set(PKG.rglob("*.py"))
    for mod in TRAINING_MODULES:
        assert f"repro_torch.{mod}" in found, mod
        path = PKG.joinpath(*mod.split(".")).with_suffix(".py")
        assert path in files, mod
        assert not FORBIDDEN.findall(path.read_text()), mod


ROOFLINE_MODULES = ("configs.base", "configs.registry", "launch.specs",
                    "launch.mesh", "launch.dryrun", "roofline.analysis",
                    "roofline.variant", "roofline.report",
                    "roofline.dryrun_summary", "kernels.counting")
EXAMPLES = ("quickstart_torch", "cluster_sim_torch", "serve_lm_torch")


def test_scans_cover_the_roofline_slice():
    # test_importing_every_module_loads_no_jax_and_no_repro imports them.
    for mod in ROOFLINE_MODULES:
        path = PKG.joinpath(*mod.split(".")).with_suffix(".py")
        assert path.is_file(), mod
        assert not FORBIDDEN.findall(path.read_text()), mod
    for name in EXAMPLES:
        path = ROOT / "examples" / f"{name}.py"
        assert "repro_torch" in path.read_text(), name
        assert not FORBIDDEN.findall(path.read_text()), name


def test_spawned_ranks_import_only_the_port():
    # the spawned rank code (the rank functions, the device axis) loads
    # nothing of JAX or of the JAX package, in the parent or in a rank.
    code = ("import sys\n"
            "from repro_torch.core.dist import spawn\n"
            "from repro_torch.testing import multidevice as tmd\n"
            "if __name__ == '__main__':\n"
            "    print(spawn(tmd.loaded_rank, 2, timeout=60, "
            "join_timeout=120))\n"
            "    print(tmd.loaded_rank(0, None))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[[], []]", "[]"], out.stdout


def test_campaign_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.campaign import CampaignSpec, ResultsStore, run_campaign
    spec = CampaignSpec(workload="wireless", seeds=(0,),
                        base_model_kw=dict(n_cells=6, n_channels=2,
                                           max_calls=2, handoff_p=0),
                        engine_kw=dict(lookahead=0.5, n_buckets=8,
                                       bucket_cap=64, route_cap=512,
                                       fallback_cap=512), max_epochs=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_campaign(spec, store=ResultsStore(tmp_path))
    assert not any(tmp_path.iterdir())
    assert run_campaign(spec, device="cpu")["undrained"] == []


def test_sources_import_neither_jax_nor_repro():
    files = (sorted(PKG.rglob("*.py")) + sorted((ROOT / "tools").glob("*.py"))
             + sorted((ROOT / "examples").glob("*_torch.py"))
             + [ROOT / "chip_smoke.py"])
    assert len(files) > 20
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)
    assert FORBIDDEN.search("from repro_torch import x") is None
    assert FORBIDDEN.search("  from repro.core import x")
    assert FORBIDDEN.search("import jax.numpy as jnp")


def test_engine_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core.engine import EngineConfig, ParsirEngine
    from repro_torch.interop import engine_state_from_numpy
    from repro_torch.workloads import get_workload
    model = get_workload("phold", n_objects=4, state_nodes=64)
    cfg = EngineConfig(lookahead=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        ParsirEngine(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_state_from_numpy(None)
    assert ParsirEngine(model, cfg, device="cpu").device.type == "cpu"


def test_conformance_cli_needs_a_card_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.testing.conformance import main
    for devices in ("1", "2"):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--workload", "phold", "--devices", devices])
    assert main(["--workload", "phold", "--device", "cpu"]) == 0
    assert "OK phold batch-allgather D=1" in capsys.readouterr().out


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone, without the rest of the repository, it fails as well.
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


MESH_MODULES = ("distributed", "distributed.sharding", "launch.mesh",
                "serve.engine", "models.layers", "testing.multidevice")


def test_scans_cover_the_mesh_slice():
    # the sharding rules are a package of their own; the first test
    # imports every module, this one scans the sources.
    for mod in MESH_MODULES:
        path = PKG.joinpath(*mod.split("."))
        path = path / "__init__.py" if path.is_dir() else \
            path.with_suffix(".py")
        assert path.is_file(), mod
        assert not FORBIDDEN.findall(path.read_text()), mod
