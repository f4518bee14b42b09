"""EngineConfig: the stage-selection + capacity record of the pipeline.

Port of ``repro/core/pipeline/config.py`` with the same fields, defaults and
validation rules (see that module for each field's units and range): a
configuration the JAX engine accepts is accepted here, one it rejects
raises the same ``ValueError`` with the same words, at construction or, for
the checks that need the device count (``route_cap`` against D for
``a2a``), in :meth:`EngineConfig.validate`.  ``opt_stage_cap`` defaults to
``route_cap`` when speculating, as in the JAX package.

Bit-exactness contract: no field of this record changes simulation
semantics; capacities bound buffers, and overflow is counted in ``Stats``.
"""
from __future__ import annotations

import dataclasses

from .names import (BATCH_IMPLS, PLACEMENTS, ROUTES, SELECTABLE_SCHEDULERS)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The engine's configuration surface, one knob per field (the JAX
    package's ``EngineConfig`` documents each)."""

    lookahead: float
    epoch_len: float | None = None
    n_buckets: int = 8
    bucket_cap: int = 128
    route_cap: int = 4096
    fallback_cap: int = 4096
    route: str = "allgather"
    scheduler: str = "batch"
    batch_impl: str = "rounds"
    pack_tile: int = 64
    steal: bool = False
    steal_cap: int = 4
    claim_cap: int = 4
    placement: str = "equal"
    rebalance_every: int = 0
    migrate_cap: int = 16
    placement_slack: float = 2.0
    opt_window: int = 0
    opt_stage_cap: int = 0
    opt_commit: str = "device"
    opt_adaptive: bool = False
    inject_straggler_every: int = 0

    def __post_init__(self):
        if self.lookahead <= 0:
            raise ValueError(f"lookahead must be > 0 (the conservative bound "
                             f"L), got {self.lookahead}")
        el = self.epoch_len if self.epoch_len is not None else self.lookahead
        if el <= 0:
            raise ValueError(f"epoch_len must be > 0, got {el}")
        if el > self.lookahead + 1e-9:
            raise ValueError("epoch_len must be <= lookahead (conservative)")
        object.__setattr__(self, "epoch_len", el)

        caps = ["n_buckets", "bucket_cap", "route_cap", "fallback_cap",
                "pack_tile"]
        if self.steal:
            caps += ["steal_cap", "claim_cap"]
        for cap in caps:
            if getattr(self, cap) < 1:
                raise ValueError(f"{cap} must be >= 1, got {getattr(self, cap)}")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {self.placement!r} "
                             f"(choose from {list(PLACEMENTS)})")
        if self.placement == "adaptive":
            if self.rebalance_every < 1:
                raise ValueError(
                    "placement='adaptive' needs rebalance_every >= 1 — with "
                    f"{self.rebalance_every} the rebalance stage would "
                    "silently never fire")
            if self.migrate_cap < 2:
                raise ValueError(
                    f"migrate_cap must be >= 2 (one row each way per "
                    f"rebalance), got {self.migrate_cap}")
            if self.placement_slack < 1.0:
                raise ValueError(
                    f"placement_slack must be >= 1.0, got "
                    f"{self.placement_slack}")
        elif self.rebalance_every:
            raise ValueError(
                f"rebalance_every={self.rebalance_every} only applies to "
                f"placement='adaptive' (got placement={self.placement!r}) — "
                "it would silently do nothing")

        if self.opt_window < 0:
            raise ValueError(
                f"opt_window must be >= 0, got {self.opt_window}")
        if self.opt_commit not in ("device", "global"):
            raise ValueError(
                f"unknown opt_commit {self.opt_commit!r} "
                "(choose from ['device', 'global'])")
        if self.opt_window > 0:
            if self.steal and self.opt_commit != "global":
                raise ValueError(
                    "steal=True with opt_window > 0 requires "
                    "opt_commit='global' — loaned batches execute on the "
                    "borrower, so a per-device verdict could commit a "
                    "loan's emissions while its owner rolls back")
            if self.inject_straggler_every < 0:
                raise ValueError(
                    f"inject_straggler_every must be >= 0, got "
                    f"{self.inject_straggler_every}")
            if self.n_buckets < self.opt_window + 2:
                raise ValueError(
                    f"opt_window={self.opt_window} needs n_buckets >= "
                    f"{self.opt_window + 2} (got {self.n_buckets}) — the "
                    "shadow window plus the live epoch must fit the bucket "
                    "ring without wrapping onto itself")
            if self.opt_stage_cap == 0:
                object.__setattr__(self, "opt_stage_cap", self.route_cap)
            if self.opt_stage_cap < 1:
                raise ValueError(
                    f"opt_stage_cap must be >= 1 when speculating, got "
                    f"{self.opt_stage_cap}")
        else:
            if self.opt_stage_cap:
                raise ValueError(
                    f"opt_stage_cap={self.opt_stage_cap} only applies with "
                    f"opt_window > 0 — it would silently do nothing")
            if self.opt_commit != "device":
                raise ValueError(
                    f"opt_commit={self.opt_commit!r} only applies with "
                    f"opt_window > 0 — it would silently do nothing")
            if self.opt_adaptive:
                raise ValueError(
                    "opt_adaptive=True only applies with opt_window > 0 — "
                    "the controller needs a window cap to tune under")
            if self.inject_straggler_every:
                raise ValueError(
                    f"inject_straggler_every={self.inject_straggler_every} "
                    "only applies with opt_window > 0 — there is no window "
                    "to abort")

        # stage names, checked against the full name sets of the JAX package
        # (names.py) so both reject the same names.
        if self.batch_impl not in BATCH_IMPLS:
            raise ValueError(f"unknown batch_impl {self.batch_impl!r} "
                             f"(choose from {sorted(BATCH_IMPLS)})")
        if self.route not in ROUTES:
            raise ValueError(f"unknown route {self.route!r} "
                             f"(choose from {sorted(ROUTES)})")
        internal = set(BATCH_IMPLS.values()) - {"batch"}
        if self.scheduler in internal:
            raise ValueError(
                f"scheduler {self.scheduler!r} is internal; use "
                f"scheduler='batch' with batch_impl="
                f"{self.scheduler.split('-', 1)[1]!r}")
        if self.scheduler not in SELECTABLE_SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r} "
                             f"(choose from {sorted(SELECTABLE_SCHEDULERS)})")
        if self.batch_impl != "rounds" and self.scheduler != "batch":
            raise ValueError(
                f"batch_impl={self.batch_impl!r} requires scheduler='batch' "
                f"— with scheduler={self.scheduler!r} it would silently "
                "never take effect")
        if self.steal and (self.scheduler != "batch"
                           or self.batch_impl == "model"):
            raise ValueError(
                f"steal=True only supports scheduler='batch' with "
                f"batch_impl in ('rounds', 'packed') (got "
                f"scheduler={self.scheduler!r}, "
                f"batch_impl={self.batch_impl!r})")

    def validate(self, n_devices: int) -> None:
        """Device-count-dependent fail-fast checks (engine construction)."""
        if self.route == "a2a":
            if self.route_cap < n_devices:
                raise ValueError(
                    f"route_cap={self.route_cap} must be >= n_devices="
                    f"{n_devices} for a2a routing — the per-pair sub-buffer "
                    "(route_cap // n_devices) would be empty and every event "
                    "would spill to fallback instead of being exchanged")
            if self.route_cap % n_devices:
                raise ValueError(
                    f"route_cap={self.route_cap} must be divisible by mesh "
                    f"size {n_devices} for a2a")
