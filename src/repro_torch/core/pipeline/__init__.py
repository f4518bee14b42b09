"""The engine as a pipeline of composable stages (PyTorch port).

  * :mod:`base`        — stage interfaces, registries, shared engine types;
  * :mod:`config`      — :class:`EngineConfig` (stage selection + capacities,
    fail-fast validation);
  * :mod:`schedulers`  — ``batch`` (PARSIR rounds), ``batch-model`` (model
    kernel);
  * :mod:`routers`     — ``allgather`` (single device);
  * :mod:`deliver`     — owner-side calendar/fallback insertion;
  * :mod:`step`        — :func:`make_step`, the wiring (one simulation, or
    R stacked replications);
  * :mod:`speculate`   — :func:`make_spec_step`, the bounded-optimism step
    (``opt_window``), stacked the same way.
"""
from . import routers, schedulers  # noqa: F401  (registration imports)
from .base import (ROUTERS, SCHEDULERS, EngineState, Router, Scheduler, Stats,
                   epoch_of, map_tree, register_router, register_scheduler,
                   replica, resolve_router, resolve_scheduler, stack_of_one,
                   zero_stats)
from .config import EngineConfig
from .deliver import deliver
from .schedulers import refuse_stacking
from .speculate import make_spec_step
from .step import in_flight, make_step, pending_per_replication

__all__ = [
    "ROUTERS", "SCHEDULERS", "EngineConfig", "EngineState", "Router",
    "Scheduler", "Stats", "deliver", "epoch_of", "in_flight",
    "make_spec_step", "make_step", "map_tree", "pending_per_replication",
    "refuse_stacking",
    "register_router", "register_scheduler", "replica", "resolve_router",
    "resolve_scheduler", "stack_of_one", "zero_stats",
]
