"""Selectable stage names of the engine pipeline (stdlib only).

The port's own copy of ``repro/core/pipeline/names.py``: the user-facing
choice sets of :class:`~repro_torch.core.pipeline.config.EngineConfig`,
each a registry key of :mod:`repro_torch.core.pipeline.base`.
``tests/test_torch_engine.py`` holds this copy equal to the JAX package's.
"""
from __future__ import annotations

#: the ``scheduler='batch'`` family, split by ``EngineConfig.batch_impl``
#: (keys = selectable batch_impl values, values = internal registry names).
BATCH_IMPLS: dict[str, str] = {"rounds": "batch", "model": "batch-model",
                               "packed": "batch-packed"}

#: directly selectable ``EngineConfig.scheduler`` names.
SELECTABLE_SCHEDULERS: tuple[str, ...] = ("batch", "ltf")

#: ``EngineConfig.route`` registry keys.
ROUTES: tuple[str, ...] = ("allgather", "a2a")

#: ``EngineConfig.placement`` values (paper §II-A/§II-C knapsacks).
PLACEMENTS: tuple[str, ...] = ("equal", "weighted", "adaptive")

#: ``EngineConfig`` fields of the speculation stage.  Every knob here is a
#: ``--opt-*`` flag of the simulate CLI: :mod:`repro_torch.testing.
#: docs_check` derives the required flags from this tuple.
#: (``inject_straggler_every`` is absent: it is a test harness, not a
#: speculation knob.)
SPECULATION_KNOBS: tuple[str, ...] = ("opt_window", "opt_stage_cap",
                                      "opt_commit", "opt_adaptive")
