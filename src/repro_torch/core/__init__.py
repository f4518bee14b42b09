"""PARSIR engine core, PyTorch port.

  * :mod:`repro_torch.core.api`        — ``SimModel`` / ``EmittedEvents``;
  * :mod:`repro_torch.core.engine`     — ``ParsirEngine`` (one device, or
    one rank of a ``torch.distributed`` group);
  * :mod:`repro_torch.core.dist`       — the device axis (``Comm``,
    ``spawn``);
  * :mod:`repro_torch.core.stealing`   — the loan math;
  * :mod:`repro_torch.core.pipeline`   — the stage pipeline;
  * :mod:`repro_torch.core.events`     — ``EventBatch`` + the counter RNG;
  * :mod:`repro_torch.core.calendar`, :mod:`repro_torch.core.placement`;
  * :mod:`repro_torch.core.ref_engine` — the sequential numpy oracle.
"""
from .api import EmittedEvents, SimModel  # noqa: F401
from .engine import EngineConfig, EngineState, ParsirEngine  # noqa: F401
from .events import EventBatch  # noqa: F401
from .pipeline import Stats, make_step, zero_stats  # noqa: F401
from .placement import (Placement, equal_placement,  # noqa: F401
                        weighted_placement)
from .ref_engine import SequentialResult, run_sequential  # noqa: F401

__all__ = [
    "EmittedEvents", "EngineConfig", "EngineState", "EventBatch",
    "ParsirEngine", "Placement", "SequentialResult", "SimModel", "Stats",
    "equal_placement", "make_step", "run_sequential", "weighted_placement",
    "zero_stats",
]
