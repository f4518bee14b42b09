"""The engine as a pipeline of composable stages (PyTorch port).

  * :mod:`base`        — stage interfaces, registries, shared engine types;
  * :mod:`config`      — :class:`EngineConfig` (stage selection + capacities,
    fail-fast validation);
  * :mod:`schedulers`  — ``batch`` (PARSIR rounds), ``batch-model`` (model
    kernel);
  * :mod:`routers`     — ``allgather`` and ``a2a`` (over the engine's
    :class:`~repro_torch.core.dist.Comm`);
  * :mod:`steal`       — ``none`` and ``loan`` (epoch-granular loans);
  * :mod:`rebalance`   — ``none`` and ``adaptive`` (boundary moves with
    calendar-row migration);
  * :mod:`deliver`     — owner-side calendar/fallback insertion;
  * :mod:`step`        — :func:`make_step`, the wiring (one simulation, or
    R stacked replications);
  * :mod:`speculate`   — :func:`make_spec_step`, the bounded-optimism step
    (``opt_window``), stacked the same way.
"""
from . import rebalance, routers, schedulers, steal  # noqa: F401  (registration)
from .base import (REBALANCERS, ROUTERS, SCHEDULERS, STEAL_POLICIES,
                   EngineState, RebalancePolicy, Router, Scheduler,
                   StealPolicy, Stats, epoch_of, map_tree,
                   register_rebalancer, register_router, register_scheduler,
                   register_steal_policy, replica, resolve_rebalance,
                   resolve_router, resolve_scheduler, resolve_steal,
                   stack_of_one, zero_stats)
from .config import EngineConfig
from .deliver import deliver
from .schedulers import refuse_stacking
from .speculate import make_spec_step
from .step import in_flight, make_step, pending_per_replication

__all__ = [
    "REBALANCERS", "ROUTERS", "SCHEDULERS", "STEAL_POLICIES", "EngineConfig",
    "EngineState", "RebalancePolicy", "Router", "Scheduler", "StealPolicy",
    "Stats", "deliver", "epoch_of", "in_flight", "make_spec_step",
    "make_step", "map_tree", "pending_per_replication", "refuse_stacking",
    "register_rebalancer", "register_router", "register_scheduler",
    "register_steal_policy", "replica", "resolve_rebalance",
    "resolve_router", "resolve_scheduler", "resolve_steal", "stack_of_one",
    "zero_stats",
]
