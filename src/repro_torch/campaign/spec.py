"""The declarative campaign grid: seeds × model kwargs × engine config.

The port's copy of ``repro/campaign/spec.py``, kept byte for byte in what
it computes: the same spec has the same :meth:`CampaignSpec.digest` in both
packages, so a results store means the same thing to both.

A :class:`CampaignSpec` is pure data, canonically serializable, and hashable
by content: :meth:`CampaignSpec.digest` is the sha256 of its canonical JSON,
so the results store can key a run directory by *what was asked for* — the
same spec always lands in the same directory (resumable), and any change to
the grid, the seeds or the engine config starts a fresh one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Any


def _canonical(obj: Any) -> str:
    """Deterministic JSON: sorted keys, no whitespace variance."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """A parameter sweep: every grid point runs every seed.

    ``grid`` maps model-kwarg names to value lists; :meth:`points` is their
    cartesian product merged over ``base_model_kw`` (grid wins).  ``seeds``
    are the replication seeds every point runs — stacked into one
    replicated drain by the runner.  ``engine_kw`` feeds ``EngineConfig``
    verbatim; ``max_epochs`` bounds each point's fused drain.
    """

    workload: str
    seeds: tuple[int, ...]
    base_model_kw: dict[str, Any] = dataclasses.field(default_factory=dict)
    grid: dict[str, list] = dataclasses.field(default_factory=dict)
    engine_kw: dict[str, Any] = dataclasses.field(default_factory=dict)
    devices: int = 1
    max_epochs: int = 256

    def __post_init__(self):
        if not self.seeds:
            raise ValueError("a campaign needs at least one seed")
        if len(set(self.seeds)) != len(self.seeds):
            raise ValueError(f"duplicate seeds: {self.seeds}")
        clash = set(self.grid) & set(self.base_model_kw)
        if clash:
            raise ValueError(f"grid keys shadow base_model_kw: {sorted(clash)}")
        for k, vs in self.grid.items():
            if not vs:
                raise ValueError(f"grid axis {k!r} has no values")

    def points(self) -> list[dict[str, Any]]:
        """The grid's cartesian product as model-kwarg dicts, in the
        deterministic (sorted-key, given-value-order) enumeration the store
        indexes by."""
        keys = sorted(self.grid)
        out = []
        for combo in itertools.product(*(self.grid[k] for k in keys)):
            point = dict(self.base_model_kw)
            point.update(zip(keys, combo))
            out.append(point)
        return out

    def point_label(self, index: int) -> str:
        """Human-readable label of grid point ``index`` (varied axes only)."""
        keys = sorted(self.grid)
        if not keys:
            return "base"
        point = self.points()[index]
        return ",".join(f"{k}={point[k]}" for k in keys)

    def as_dict(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["seeds"] = list(self.seeds)
        return d

    def digest(self) -> str:
        """sha256 over the canonical JSON of the whole spec."""
        return hashlib.sha256(_canonical(self.as_dict()).encode()).hexdigest()
