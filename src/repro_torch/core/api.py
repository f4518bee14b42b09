"""The application-facing API (paper §I), batched for PyTorch.

Port of ``repro/core/api.py``.  PARSIR exposes ScheduleNewEvent and
ProcessEvent to model code; here ProcessEvent is :meth:`SimModel.process_events`
and the events it returns are the ScheduleNewEvent calls.  The JAX engine
vmaps a per-object callback; the port writes the batch dimension out: row
``i`` of every argument belongs to object row ``i`` of the state.

Contract (the conservative-correctness obligations, unchanged):
  * every emitted event satisfies ``ts_out >= ts_in + lookahead`` (the engine
    counts violations in ``stats.lookahead_violations``);
  * emitted ``dst`` are global object ids;
  * all randomness comes from the event ``seed`` via ``core.events.fold``.
"""
from __future__ import annotations

import abc
from typing import NamedTuple

import numpy as np
import torch


class EmittedEvents(NamedTuple):
    """Up to ``max_out`` events emitted per processed event, for ``n`` rows.

    Every field is ``[n, max_out]``; ``valid`` flags the live entries (an
    all-invalid row absorbs its input, several valid entries fan out).
    """

    dst: torch.Tensor      # i32 [n, max_out] global object id
    ts: torch.Tensor       # f32 [n, max_out]
    seed: torch.Tensor     # u32 in i64 [n, max_out]
    payload: torch.Tensor  # f32 [n, max_out]
    valid: torch.Tensor    # bool [n, max_out]


class SimModel(abc.ABC):
    """A discrete-event simulation model runnable by the PARSIR engine.

    A model may also define ``process_batch(state, ts_s, seed_s, pay_s,
    cnt_b, lookahead) -> (state, EventBatch, lookahead_violations)``, which
    applies every object's whole sorted epoch batch at once, emitting flat
    in (row, slot) order and counting violations per row; the engine
    reaches it through ``EngineConfig(batch_impl="model")``.

    Neither method may depend on a row's position: a stacked state sends
    the rows of R replications through one call (ids come from the state,
    as ``gid``).
    """

    #: maximum number of events a single ProcessEvent call can emit.
    max_out: int = 1

    @property
    @abc.abstractmethod
    def n_objects(self) -> int:
        ...

    @abc.abstractmethod
    def init_object_state(self, global_ids: np.ndarray,
                          device: torch.device) -> dict[str, torch.Tensor]:
        """Per-object state dict with leading dim ``len(global_ids)``."""

    @abc.abstractmethod
    def initial_events(self, seed: int | None = None) -> dict[str, np.ndarray]:
        """Bootstrap events as flat numpy arrays
        {dst:i32[K], ts:f32[K], seed:u32[K], payload:f32[K]}."""

    def object_weights(self) -> np.ndarray | None:
        """Optional per-object expected-load hint, f64[n_objects], for
        ``placement="weighted"`` (and the start of ``"adaptive"``); None
        means no skew is known and the engine splits equally."""
        return None

    @abc.abstractmethod
    def process_events(self, state: dict[str, torch.Tensor], ts: torch.Tensor,
                       seed: torch.Tensor, payload: torch.Tensor
                       ) -> tuple[dict[str, torch.Tensor], EmittedEvents]:
        """ProcessEvent for one event per object row: ``ts``/``seed``/
        ``payload`` are ``[n]``; returns the new state rows (the input state
        is left unchanged) and the ``[n, max_out]`` emissions."""
