"""The port's registry and CLI checks (``repro_torch.testing.docs_check``).

* the tree passes, in process and as the CLI (exit status 0), and the
  module loads nothing of torch, numpy, JAX or the JAX package;
* its registry ids, stage names and speculation knobs are the JAX
  package's, read by its own stdlib means;
* a synthetic CLI in ``tmp_path`` with a literal ``choices`` list that
  misses a value, without ``--opt-window``, or without ``--devices`` is
  flagged; a missing pinned digest is flagged.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.testing import docs_check as dc

ROOT = Path(__file__).resolve().parents[1]
SIMULATE = ROOT / "src" / "repro_torch" / "launch" / "simulate.py"


def test_the_tree_passes():
    assert dc.run_all() == []


def test_cli_exits_zero_and_imports_nothing_heavy():
    code = ("import sys, runpy\n"
            "sys.argv = ['docs_check']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.testing.docs_check',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    heavy = sorted(n for n in sys.modules if n.split('.')[0] in"
            " ('torch', 'numpy', 'jax', 'repro'))\n"
            "    print('STATUS', e.code, heavy)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "[docs_check] OK" in r.stdout
    assert "STATUS 0 []" in r.stdout, r.stdout


def test_reads_what_the_reference_reads():
    from repro.core.pipeline import names as jnames
    from repro.workloads.registry import all_workloads
    names = dc.load_stage_names()
    for sym in ("BATCH_IMPLS", "SELECTABLE_SCHEDULERS", "ROUTES",
                "PLACEMENTS", "SPECULATION_KNOBS"):
        assert getattr(names, sym) == getattr(jnames, sym), sym
    assert dc.registry_ids() == list(all_workloads())
    assert dc.spec_flags() == ("--opt-window", "--opt-stage-cap",
                               "--opt-commit", "--opt-adaptive")


def _variant(tmp_path, old, new) -> Path:
    text = SIMULATE.read_text()
    assert old in text, old
    path = tmp_path / "simulate.py"
    path.write_text(text.replace(old, new))
    return path


def test_a_literal_choices_list_is_flagged(tmp_path):
    path = _variant(tmp_path, 'choices=list(ROUTES))',
                    'choices=["allgather"])')
    problems = dc.check_simulate_cli(path=str(path))
    assert len(problems) == 1 and "`--route`" in problems[0]
    assert "not sourced from `ROUTES`" in problems[0]
    # a literal equal to the registry's set is tolerated, as in the
    # reference.
    path = _variant(tmp_path, 'choices=list(ROUTES))',
                    'choices=["allgather", "a2a"])')
    assert dc.check_simulate_cli(path=str(path)) == []


@pytest.mark.parametrize("flag", ["--opt-window", "--devices"])
def test_a_missing_flag_is_flagged(tmp_path, flag):
    path = _variant(tmp_path, f'ap.add_argument("{flag}"',
                    'ap.add_argument("--renamed"')
    problems = dc.check_simulate_cli(path=str(path))
    assert problems == [f"repro_torch/launch/simulate.py exposes no "
                        f"`{flag}` — the CLI must cover every orchestration "
                        f"axis the engine has"]


def test_a_missing_digest_is_flagged(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    for part in ("workloads/registry.py", "testing/golden.py",
                 "core/pipeline/names.py", "launch/simulate.py",
                 "launch/campaign.py"):
        (pkg / part).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / "src" / "repro_torch" / part, pkg / part)
    golden = pkg / "testing" / "golden.py"
    text = golden.read_text()
    golden.write_text(text.replace('"wireless/medium":', '"wireless/big":'))
    assert dc.run_all(str(tmp_path)) == [
        "workload `wireless` has no pinned `wireless/medium` digest in "
        "repro_torch.testing.golden.PINNED"]
    assert dc.main(["--repo-root", str(tmp_path)]) == 1
