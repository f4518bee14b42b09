"""Digest-keyed results store with resumable campaign runs.

The port's copy of ``repro/campaign/store.py``: the same layout, so either
package resumes the other's store of the same spec.

Layout under the store root::

    <root>/<digest12>/manifest.json    — the spec (canonical dict), full
                                         digest, and the git commit the run
                                         started from
    <root>/<digest12>/point-<i>.json   — one result per grid point, indexed
                                         by the spec's deterministic
                                         enumeration (spec.points())

Keying the run directory by the spec digest makes resumption safe by
construction: a re-run of the *same* spec skips every ``point-<i>.json``
already present, while any change to the spec (grid, seeds, engine config)
changes the digest and starts a fresh directory — stale results can never be
mistaken for the new campaign's.  The manifest's commit records provenance
only; it deliberately does not key the directory (a reproducible spec should
resume across commits — bit-exactness is the engine's contract, and the
conformance suite enforces it).
"""
from __future__ import annotations

import json
import subprocess
from pathlib import Path
from typing import Any

from .spec import CampaignSpec


def git_commit(cwd: str | None = None) -> str:
    """The current git HEAD (``+dirty`` if the tree has uncommitted
    changes), or ``"unknown"`` outside a checkout.

    The dirty marker matters for provenance: a manifest recording a bare
    commit hash claims "this campaign ran the committed code", which is a
    false claim from a modified working tree — resuming a campaign after
    an innocent-looking local edit would silently mix results from two
    different programs under one commit id.
    """
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd,
                             capture_output=True, text=True, timeout=10)
        if out.returncode != 0:
            return "unknown"
        head = out.stdout.strip()
        status = subprocess.run(["git", "status", "--porcelain"], cwd=cwd,
                                capture_output=True, text=True, timeout=10)
        # a failed status check must not report a clean tree — fall back to
        # the marker (provenance may only ever err toward "dirty").
        if status.returncode != 0 or status.stdout.strip():
            return head + "+dirty"
        return head
    except OSError:
        return "unknown"


class ResultsStore:
    """One directory per campaign digest; one JSON file per grid point."""

    def __init__(self, root: str | Path):
        self.root = Path(root)

    def run_dir(self, spec: CampaignSpec) -> Path:
        return self.root / spec.digest()[:12]

    def _point_path(self, spec: CampaignSpec, index: int) -> Path:
        return self.run_dir(spec) / f"point-{index}.json"

    # -- manifest -----------------------------------------------------------

    def write_manifest(self, spec: CampaignSpec) -> dict[str, Any]:
        """Create the run directory + manifest (idempotent; an existing
        manifest is verified against the spec digest, never overwritten)."""
        d = self.run_dir(spec)
        d.mkdir(parents=True, exist_ok=True)
        path = d / "manifest.json"
        if path.exists():
            manifest = json.loads(path.read_text())
            if manifest["digest"] != spec.digest():
                raise ValueError(
                    f"{path} holds a different campaign "
                    f"(digest {manifest['digest'][:12]}, "
                    f"expected {spec.digest()[:12]})")
            return manifest
        manifest = {"digest": spec.digest(), "commit": git_commit(),
                    "n_points": len(spec.points()), "spec": spec.as_dict()}
        path.write_text(json.dumps(manifest, indent=2, sort_keys=True))
        return manifest

    # -- per-point results --------------------------------------------------

    def has(self, spec: CampaignSpec, index: int) -> bool:
        """True iff the point is stored AND parses as JSON.

        Existence alone is not enough for the resume contract: a run killed
        mid-write outside :meth:`put`'s atomic rename path (or a truncated
        copy/restore) can leave a zero-byte or corrupt ``point-<i>.json``,
        and treating it as done would silently hole the campaign.  Corrupt
        points read as absent, so ``missing()`` schedules a re-run.
        """
        path = self._point_path(spec, index)
        try:
            json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return False
        return True

    def get(self, spec: CampaignSpec, index: int) -> dict[str, Any]:
        path = self._point_path(spec, index)
        try:
            return json.loads(path.read_text())
        except FileNotFoundError:
            raise KeyError(
                f"campaign {spec.digest()[:12]} has no stored point "
                f"{index} (expected {path}); run the campaign (or check "
                f"missing()) before reading results") from None

    def put(self, spec: CampaignSpec, index: int,
            result: dict[str, Any]) -> None:
        path = self._point_path(spec, index)
        tmp = path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(result, indent=2, sort_keys=True))
        tmp.replace(path)       # atomic: a crash never leaves a half entry

    def missing(self, spec: CampaignSpec) -> list[int]:
        """Grid-point indices not yet stored — empty iff the campaign is
        complete (the CLI's exit criterion)."""
        return [i for i in range(len(spec.points()))
                if not self.has(spec, i)]
