"""Stage interfaces, registries and shared engine types (PyTorch).

Port of ``repro/core/pipeline/base.py``: the narrow interfaces of the
pluggable stages of the epoch pipeline

    extract → steal → process → rebalance → route → deliver

the :class:`Scheduler` (how a device's epoch batch is executed), the
:class:`Router` (how emitted events reach their owners), the
:class:`StealPolicy` (epoch-granular loans before processing) and the
:class:`RebalancePolicy` (moving the placement boundaries).  Stage
implementations are small registered classes; :class:`EngineConfig`
selects them by name and :func:`~repro_torch.core.pipeline.step.make_step`
wires them together.  The stages that talk across devices take the
engine's :class:`~repro_torch.core.dist.Comm` (the reference's ``AXIS``).

Bit-exactness contract (unchanged): a stage chooses *how*, never *what* —
every registered implementation leaves the processed-event multiset and,
for dyadic workloads, the object state bit-identical to the sequential
oracle.
"""
from __future__ import annotations

import abc
import math
from typing import TYPE_CHECKING, Any, Callable, NamedTuple

import torch

from ..api import SimModel
from ..calendar import Calendar, Fallback
from ..events import EventBatch, to_f32
from ..placement import Placement
from .names import BATCH_IMPLS

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..dist import Comm
    from .config import EngineConfig


class Stats(NamedTuple):
    """Per-device event counters, each an int64 tensor of shape [1] (``[R,
    1]`` in a stacked state)."""

    processed: torch.Tensor             # events processed on this device
    cal_overflow: torch.Tensor          # bucket-capacity overflows (must be 0)
    fb_overflow: torch.Tensor           # fallback-capacity overflows (must be 0)
    route_overflow: torch.Tensor        # route-capacity overflows (must be 0)
    late_events: torch.Tensor           # causality violations (must be 0)
    lookahead_violations: torch.Tensor  # model emitted ts < ts_in + L (must be 0)
    stolen: torch.Tensor                # loaned batches processed on this device
    oob_events: torch.Tensor            # emitted dst outside [0, n_objects)
    rebalances: torch.Tensor            # adaptive-placement rebalance firings
    migrated: torch.Tensor              # object rows received via migration
    rollbacks: torch.Tensor             # speculation windows aborted
    speculated: torch.Tensor            # events processed past the safe horizon
    spec_commits: torch.Tensor          # speculation windows committed


def zero_stats(device, R: int | None = None) -> Stats:
    """Zeroed counters: shape [1], or [R, 1] for ``R`` stacked
    replications."""
    shape = (1,) if R is None else (R, 1)
    return Stats(*(torch.zeros(shape, dtype=torch.int64, device=device)
                   for _ in Stats._fields))


class EngineState(NamedTuple):
    """One simulation's state.  A *stacked* state holds R independent
    replications: every leaf gains a leading R (``cal.ts`` [R, M, N, C],
    ``fb`` [R, fallback_cap], ``epoch`` [R, 1], each Stats field [R, 1],
    ``bounds`` [R, 1, 2], ``load`` [R, M], ``obj[k]`` [R, M, ...]), each
    replication contiguous, so that ``[R * M, ...]`` views of the per-row
    leaves cost nothing."""

    cal: Calendar
    fb: Fallback
    obj: Any            # dict of [n_local_max, ...] tensors (model-defined)
    epoch: torch.Tensor   # i32 [1]
    stats: Stats
    bounds: torch.Tensor  # i32 [1, n_devices + 1]
    load: torch.Tensor    # i32 [n_local_max] processed counts per row


def map_tree(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """``tree`` (NamedTuples and dicts of tensors) with ``fn`` applied to
    every tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return type(tree)(*(map_tree(fn, x) for x in tree))


def stack_of_one(state: EngineState) -> EngineState:
    """A state as a stack of one replication (views, no copy)."""
    return map_tree(lambda t: t.unsqueeze(0), state)


def replica(state: EngineState, r: int) -> EngineState:
    """Replication ``r`` of a stacked state in the classic layout (views
    into the stack)."""
    return map_tree(lambda t: t[r], state)


def epoch_of(ts: torch.Tensor, epoch_len: float) -> torch.Tensor:
    """Epoch index of each timestamp, i32.

    Multiplies by ``1/epoch_len`` when that is a power of two, divides by
    ``epoch_len`` otherwise — the same choice as the JAX package, so both
    round identically.  The divisor is a device tensor: CUDA turns a division
    by a host scalar into a multiplication by its reciprocal, which can
    differ in the last bit.  Non-finite timestamps (empty slots, always
    masked by the callers) saturate instead of hitting an undefined cast.
    """
    if math.log2(1.0 / epoch_len).is_integer():
        e = torch.floor(ts * to_f32(1.0 / epoch_len))
    else:
        e = torch.floor(ts / torch.full_like(ts, epoch_len))
    return e.clamp(-2147483648.0, 2147483520.0).to(torch.int32)


# ---------------------------------------------------------------------------
# stage interfaces
# ---------------------------------------------------------------------------

#: a scheduler's result: (updated object state, the emitted EventBatch
#: [reps, E] in each replication's own order, lookahead-violation counts
#: [reps]).
ProcessResult = tuple[Any, EventBatch, torch.Tensor]


class Scheduler(abc.ABC):
    """Per-epoch batch execution strategy (pipeline stage 3, paper §II-A).

    Contract: a scheduler is a *schedule*, never a semantics change — it
    processes each object's epoch batch in timestamp order and hands the
    model exactly the extracted (ts, seed, payload) values.
    """

    name: str
    #: host reads of device values one ``process`` call makes.
    host_syncs: int = 0

    def validate(self, model: SimModel, cfg: "EngineConfig") -> None:
        """Fail fast at engine construction if the model/config can't run."""

    @abc.abstractmethod
    def process(self, model: SimModel, cfg: "EngineConfig", obj: Any,
                ts_s: torch.Tensor, seed_s: torch.Tensor, pay_s: torch.Tensor,
                cnt_b: torch.Tensor, reps: int = 1) -> ProcessResult:
        """Apply every object's sorted epoch batch; return emitted events.

        Inputs are the per-object [n_rows, cap] arrays of
        :func:`repro_torch.core.calendar.extract_sorted`; the rows are
        ``reps`` stacked replications of ``n_rows / reps`` rows each.  The
        emissions and counts come back per replication, each in the order
        its own run would give them.
        """


class Router(abc.ABC):
    """Event exchange strategy (pipeline stage 5, paper §II-B).

    Contract: routing moves events, never invents, drops or reorders them;
    what does not fit the route buffer is handed back to the caller's
    fallback and counted.

    ``replicated`` declares the exchange's output: True if every device
    sees the same routed batch (allgather; an out-of-bounds event is then
    counted once, on device 0), False if each device receives its own
    slice (a2a; counted where it lands).
    """

    name: str
    #: True if exchange() presents an identical batch on every device.
    replicated: bool = True

    def validate(self, cfg: "EngineConfig", placement: Placement) -> None:
        """Fail fast at engine construction on bad capacity/topology."""

    @abc.abstractmethod
    def select_send(self, prod: EventBatch, eligible: torch.Tensor,
                    placement: Placement, cfg: "EngineConfig"
                    ) -> tuple[EventBatch, torch.Tensor, torch.Tensor]:
        """Pick which eligible produced events ride this epoch's exchange.

        Returns (route buffer, sent-mask over ``prod``, overflow count).
        """

    @abc.abstractmethod
    def exchange(self, buf: EventBatch, placement: Placement,
                 cfg: "EngineConfig", comm: "Comm") -> EventBatch:
        """Run the collective over ``comm``; return the events visible to
        this device (``[R, E']`` for route buffers ``[R, E]``)."""

    def sender_ids(self, placement: Placement, cfg: "EngineConfig",
                   device) -> torch.Tensor:
        """Source device of each slot of an :meth:`exchange` output, i32.

        The speculative step filters speculative arrivals by their
        sender's verdict with it (``opt_commit='device'``); a router that
        cannot say where a slot came from does not compose with it.
        """
        raise NotImplementedError(
            f"router {self.name!r} does not expose sender identity; "
            "override sender_ids() to compose with opt_commit='device'")


class StealPolicy(abc.ABC):
    """Load-balancing strategy (pipeline stage 2, paper §II-A)."""

    name: str

    @abc.abstractmethod
    def process(self, model: SimModel, scheduler: Scheduler,
                cfg: "EngineConfig", placement: Placement, comm: "Comm",
                obj: Any, ts_s: torch.Tensor, seed_s: torch.Tensor,
                pay_s: torch.Tensor, cnt_b: torch.Tensor, reps: int = 1
                ) -> tuple[Any, EventBatch, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
        """Run stages 2+3: (obj, emitted EventBatch [reps, E], lookahead
        violations [reps], stolen-batch count [reps], processed-event
        count [reps])."""


class RebalancePolicy(abc.ABC):
    """Placement-rebalancing strategy (epoch-boundary stage, paper §II-C).

    Where a :class:`StealPolicy` loans a batch and returns it, a rebalance
    moves ownership: it recomputes the contiguous boundaries from measured
    load and migrates object state and calendar rows to the new owners.
    It runs between process and route, so the epoch's emissions (and every
    fallback re-offer, which carries global ids) are routed against the
    new boundaries.
    """

    name: str

    def host_syncs(self, n_devices: int) -> int:
        """Host reads one ``rebalance`` call makes on ``n_devices``."""
        return 0

    @abc.abstractmethod
    def rebalance(self, cfg: "EngineConfig", placement: Placement,
                  comm: "Comm", cur: torch.Tensor, bounds: torch.Tensor,
                  load: torch.Tensor, cal: Calendar, obj: Any,
                  gate: torch.Tensor | None = None):
        """Maybe move the boundaries and migrate rows.

        ``cur`` [R] the epochs, ``bounds`` the live i32 [R, D + 1]
        boundaries, ``load`` [R, M] the per-row processed counts since the
        last firing (this epoch's included), ``cal``/``obj`` the ``[R * M,
        ...]`` rows; ``gate`` (bool [R]) keeps a replication from firing.
        Returns (bounds, load, cal, obj, rows received [R], fired [R])."""


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

SCHEDULERS: dict[str, Scheduler] = {}
ROUTERS: dict[str, Router] = {}
STEAL_POLICIES: dict[str, StealPolicy] = {}
REBALANCERS: dict[str, RebalancePolicy] = {}


def _register(registry: dict, kind: str, name: str) -> Callable:
    def deco(cls):
        if name in registry:
            raise ValueError(f"{kind} {name!r} already registered")
        cls.name = name
        registry[name] = cls()
        return cls
    return deco


def register_scheduler(name: str):
    """Class decorator: register a :class:`Scheduler` under ``name``."""
    return _register(SCHEDULERS, "scheduler", name)


def register_router(name: str):
    """Class decorator: register a :class:`Router` under ``name``."""
    return _register(ROUTERS, "router", name)


def register_steal_policy(name: str):
    """Class decorator: register a :class:`StealPolicy` under ``name``."""
    return _register(STEAL_POLICIES, "steal policy", name)


def register_rebalancer(name: str):
    """Class decorator: register a :class:`RebalancePolicy` under ``name``."""
    return _register(REBALANCERS, "rebalancer", name)


def resolve_scheduler(cfg: "EngineConfig") -> Scheduler:
    """EngineConfig → Scheduler (``batch`` is split by ``batch_impl``)."""
    if cfg.scheduler == "batch":
        return SCHEDULERS[BATCH_IMPLS[cfg.batch_impl]]
    return SCHEDULERS[cfg.scheduler]


def resolve_router(name: str) -> Router:
    return ROUTERS[name]


def resolve_steal(cfg: "EngineConfig", n_devices: int) -> StealPolicy:
    if cfg.steal and n_devices > 1:
        return STEAL_POLICIES["loan"]
    return STEAL_POLICIES["none"]


def resolve_rebalance(cfg: "EngineConfig") -> RebalancePolicy:
    if cfg.placement == "adaptive":
        return REBALANCERS["adaptive"]
    return REBALANCERS["none"]
