"""Registry and CLI consistency checks of the port (stdlib only).

The port's copy of checks 2, 4 and 5 of ``repro/testing/docs_check.py``,
made on the port's own files:

  2. every workload id of the port's registry
     (``repro_torch/workloads/registry.py``, ``WORKLOADS``) is pinned in
     ``repro_torch.testing.golden.PINNED`` at both sizes (``<id>/small``
     and ``<id>/medium``);
  4. the simulate CLI (``repro_torch/launch/simulate.py``) exposes every
     orchestration axis, one ``--opt-*`` flag per speculation knob of
     ``names.SPECULATION_KNOBS``, and sources each choice-typed flag from
     its registry symbol (``all_workloads()``, the
     :mod:`repro_torch.core.pipeline.names` sets), never a literal list;
  5. the campaign CLI (``repro_torch/launch/campaign.py``) the same, with
     the sweep axes (seeds, grid, store) beside the orchestration ones.

Nothing here imports torch or the port's packages: ``names.py`` is loaded
by file path, and the registry, the pinned digests and the CLIs are parsed
with ``ast``, never imported.  (Checks 1 and 3 of the reference, the README
zoo table and the tutorial, cover documents the port shares with it.)

CLI::

  PYTHONPATH=src python -m repro_torch.testing.docs_check [--repo-root PATH]

Exit status is the number of problems.
"""
from __future__ import annotations

import argparse
import ast
import importlib.util
import os

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
PKG = ("src", "repro_torch")

#: choice-typed CLI flag → the symbol its ``choices=`` expression must
#: reference (registry truth, never a hardcoded list).
CLI_CHOICE_SOURCES = {
    "--workload": "all_workloads",
    "--scheduler": "SELECTABLE_SCHEDULERS",
    "--route": "ROUTES",
    "--batch-impl": "BATCH_IMPLS",
    "--placement": "PLACEMENTS",
}

#: every orchestration axis each CLI must expose; the simulate CLI also
#: owes one ``--opt-*`` flag per ``names.SPECULATION_KNOBS`` entry
#: (:func:`spec_flags`, derived at check time).
SIMULATE_REQUIRED_FLAGS = tuple(CLI_CHOICE_SOURCES) + (
    "--devices", "--rebalance-every", "--model-kw", "--steal", "--drain",
    "--verify")
CAMPAIGN_REQUIRED_FLAGS = tuple(CLI_CHOICE_SOURCES) + (
    "--devices", "--rebalance-every", "--model-kw", "--steal", "--seeds",
    "--grid", "--epochs", "--store", "--require-drained")


def _path(repo_root: str, *parts: str) -> str:
    return os.path.join(repo_root, *PKG, *parts)


def _dict_literal(path: str, name: str) -> dict:
    """The value of the module-level dict literal ``name`` in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == name for t in targets):
            return ast.literal_eval(node.value)
    raise LookupError(f"{path} defines no {name}")


def registry_ids(repo_root: str = REPO_ROOT) -> list[str]:
    """The port's workload ids (``WORKLOADS`` of its registry), in order."""
    return list(_dict_literal(_path(repo_root, "workloads", "registry.py"),
                              "WORKLOADS"))


def load_stage_names(repo_root: str = REPO_ROOT):
    """``repro_torch/core/pipeline/names.py`` loaded by file path (its
    package imports torch)."""
    path = _path(repo_root, "core", "pipeline", "names.py")
    spec = importlib.util.spec_from_file_location("_port_stage_names", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_golden_coverage(repo_root: str = REPO_ROOT) -> list[str]:
    pinned = _dict_literal(_path(repo_root, "testing", "golden.py"),
                           "PINNED")
    return [f"workload `{name}` has no pinned `{name}/{size}` digest in "
            f"repro_torch.testing.golden.PINNED"
            for name in registry_ids(repo_root)
            for size in ("small", "medium") if f"{name}/{size}" not in pinned]


def check_cli(script: str, required: tuple[str, ...],
              repo_root: str = REPO_ROOT, path: str | None = None
              ) -> list[str]:
    """AST-check one launch CLI (``path``, by default
    ``repro_torch/launch/<script>``): every required flag exposed, every
    choice-typed flag's ``choices=`` sourced from its registry symbol (or a
    literal equal to it)."""
    path = path or _path(repo_root, "launch", script)
    with open(path) as f:
        tree = ast.parse(f.read())
    flags: dict[str, ast.expr | None] = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            flags[node.args[0].value] = next(
                (kw.value for kw in node.keywords if kw.arg == "choices"),
                None)

    problems = [f"repro_torch/launch/{script} exposes no `{flag}` — the CLI "
                f"must cover every orchestration axis the engine has"
                for flag in required if flag not in flags]
    names = load_stage_names(repo_root)
    truth = {"--workload": set(registry_ids(repo_root)),
             "--scheduler": set(names.SELECTABLE_SCHEDULERS),
             "--route": set(names.ROUTES),
             "--batch-impl": set(names.BATCH_IMPLS),
             "--placement": set(names.PLACEMENTS)}
    for flag, symbol in CLI_CHOICE_SOURCES.items():
        if flag not in flags or flag not in required:
            continue                  # a missing flag is reported above
        choices = flags[flag]
        if choices is None:
            problems.append(f"{script} `{flag}` has no choices= — drive it "
                            f"from `{symbol}`")
            continue
        referenced = {n.id for n in ast.walk(choices)
                      if isinstance(n, ast.Name)}
        referenced |= {n.attr for n in ast.walk(choices)
                       if isinstance(n, ast.Attribute)}
        if symbol in referenced:
            continue
        try:
            literal = set(ast.literal_eval(choices))
        except (ValueError, SyntaxError):
            literal = None
        if literal != truth[flag]:
            problems.append(f"{script} `{flag}` choices are not sourced from "
                            f"`{symbol}` (and don't literal-match it) — "
                            f"hardcoded choice lists rot as registries grow")
    return problems


def spec_flags(repo_root: str = REPO_ROOT) -> tuple[str, ...]:
    """``names.SPECULATION_KNOBS`` as flags (``opt_window`` →
    ``--opt-window``)."""
    return tuple("--" + knob.replace("_", "-")
                 for knob in load_stage_names(repo_root).SPECULATION_KNOBS)


def check_simulate_cli(repo_root: str = REPO_ROOT,
                       path: str | None = None) -> list[str]:
    return check_cli("simulate.py",
                     SIMULATE_REQUIRED_FLAGS + spec_flags(repo_root),
                     repo_root, path)


def check_campaign_cli(repo_root: str = REPO_ROOT,
                       path: str | None = None) -> list[str]:
    return check_cli("campaign.py", CAMPAIGN_REQUIRED_FLAGS, repo_root, path)


def run_all(repo_root: str = REPO_ROOT) -> list[str]:
    return (check_golden_coverage(repo_root) + check_simulate_cli(repo_root)
            + check_campaign_cli(repo_root))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo-root", default=REPO_ROOT)
    args = ap.parse_args(argv)
    problems = run_all(args.repo_root)
    for p in problems:
        print(f"DOCS DRIFT: {p}")
    if not problems:
        ids = registry_ids(args.repo_root)
        print(f"[docs_check] OK — {len(ids)} workloads ({', '.join(ids)}) "
              f"pinned; simulate and campaign CLIs cover every axis")
    return len(problems)


if __name__ == "__main__":
    raise SystemExit(main())
