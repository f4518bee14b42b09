"""The PARSIR epoch-synchronous conservative engine (paper §II), PyTorch.

Port of ``repro/core/engine.py`` for one device.  An engine step processes
exactly one epoch through the stage pipeline of
:mod:`repro_torch.core.pipeline`: extract the current bucket sorted by
(ts, seed), process every object's batch (the ``batch`` rounds loop, or the
model's kernel with ``batch_impl="model"``), route the emissions (the
identity on one device) and deliver them into the calendar or the fallback
list.  Every overflow/causality condition is counted in ``Stats``.

The host drives the epochs: :meth:`ParsirEngine.run` is a Python loop of
steps, and :meth:`ParsirEngine.run_until_drained` reads the in-flight count
on the host every epoch.  ``syncs`` counts every such host read of a device
value (the round count of the ``batch`` scheduler, the drain predicate) —
the counterpart of the JAX engine's ``dispatches``.

State ownership: like the JAX engine's donated buffers, ``step``/``run``
consume their input state — the ``model`` scheduler updates the object state
in place — so rebind the result and do not reuse the input.
"""
from __future__ import annotations

import numpy as np
import torch

from .api import SimModel
from .calendar import make_calendar, make_fallback
from .device import resolve_device
from .events import EventBatch
from .pipeline import (EngineConfig, EngineState, deliver, make_step,
                       resolve_scheduler, zero_stats)
from .placement import Placement, equal_placement

__all__ = ["EngineConfig", "EngineState", "ParsirEngine"]


class ParsirEngine:
    """Build, initialize and run a PARSIR simulation on one device."""

    def __init__(self, model: SimModel, cfg: EngineConfig,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model, self.cfg = model, cfg
        self.D = 1
        cfg.validate(self.D)
        self.placement: Placement = equal_placement(model.n_objects, self.D)
        self._step = make_step(model, cfg, self.placement)
        self._step_syncs = resolve_scheduler(cfg).host_syncs
        #: host reads of device values made while running epochs (the
        #: inspection helpers below are not counted).
        self.syncs = 0

    # -- lifecycle -------------------------------------------------------------

    def _fresh_state(self) -> EngineState:
        D, M, cfg, dev = self.D, self.placement.n_local_max, self.cfg, \
            self.device
        obj = self.model.init_object_state(self.placement.padded_gids(), dev)
        cal = make_calendar(D * M, cfg.n_buckets, cfg.bucket_cap, dev)
        fb = make_fallback(D * cfg.fallback_cap, dev)
        b = torch.as_tensor(np.asarray(self.placement.boundaries, np.int32),
                            device=dev)
        return EngineState(
            cal, fb, obj,
            epoch=torch.zeros((D,), dtype=torch.int32, device=dev),
            stats=zero_stats(dev),
            bounds=b[None, :].clone(),
            load=torch.zeros((D * M,), dtype=torch.int32, device=dev))

    def _initial_batch(self, seed: int | None) -> EventBatch:
        init_ev = (self.model.initial_events() if seed is None
                   else self.model.initial_events(seed))
        dev = self.device
        return EventBatch(
            dst=torch.as_tensor(np.asarray(init_ev["dst"], np.int32),
                                device=dev),
            ts=torch.as_tensor(np.asarray(init_ev["ts"], np.float32),
                               device=dev),
            seed=torch.as_tensor(np.asarray(init_ev["seed"], np.uint32)
                                 .astype(np.int64), device=dev),
            payload=torch.as_tensor(np.asarray(init_ev["payload"],
                                               np.float32), device=dev),
            valid=torch.ones((len(init_ev["dst"]),), dtype=torch.bool,
                             device=dev),
        )

    def init(self, seed: int | None = None) -> EngineState:
        """Build the initial state and ingest the bootstrap events
        (``seed`` selects the replication stream)."""
        state = self._fresh_state()
        batch = self._initial_batch(seed)
        pl = self.placement.with_boundaries(state.bounds[0])
        cal, fb, cal_ovf, fb_ovf, late, oob = deliver(
            state.cal, state.fb, batch, state.epoch[0], 0, pl, self.cfg,
            init=True)
        st = state.stats
        stats = st._replace(cal_overflow=st.cal_overflow + cal_ovf,
                            fb_overflow=st.fb_overflow + fb_ovf,
                            late_events=st.late_events + late,
                            oob_events=st.oob_events + oob)
        return state._replace(cal=cal, fb=fb, stats=stats)

    def step(self, state: EngineState) -> EngineState:
        """Advance exactly one epoch."""
        self.syncs += self._step_syncs
        return self._step(state)

    def run(self, state: EngineState, n_epochs: int) -> EngineState:
        """Advance exactly ``n_epochs`` epochs."""
        for _ in range(int(n_epochs)):
            state = self.step(state)
        return state

    def run_until_drained(self, state: EngineState,
                          max_epochs: int) -> EngineState:
        """Run until no event is parked anywhere, or ``max_epochs`` epochs.

        A drained state is a fixpoint of the step, so stopping at the drain
        epoch leaves the same state the full bound would (bar the epoch
        counter).  The predicate is read on the host before every epoch.
        """
        for _ in range(int(max_epochs)):
            self.syncs += 1
            if self.in_flight(state) == 0:
                break
            state = self.step(state)
        return state

    # -- inspection -------------------------------------------------------------

    def totals(self, state: EngineState) -> dict[str, int]:
        flat = torch.stack([v.sum() for v in state.stats]).tolist()
        return dict(zip(state.stats._fields, (int(v) for v in flat)))

    def in_flight(self, state: EngineState) -> int:
        return int(state.cal.cnt.sum() + state.fb.events.valid.sum())

    def global_row_of(self, state: EngineState
                      ) -> tuple[np.ndarray, np.ndarray]:
        """(gid, live) per padded row, each [D * n_local_max]."""
        b = state.bounds[0].cpu().numpy().astype(np.int64)
        M = self.placement.n_local_max
        d = np.arange(self.D * M) // M
        i = np.arange(self.D * M) % M
        gid = b[d] + i
        live = i < (b[d + 1] - b[d])
        return np.where(live, gid, 0), live

    def global_object_state(self, state: EngineState) -> dict[str, np.ndarray]:
        """Per-object state in global id order, leading dim ``n_objects``."""
        gid, live = self.global_row_of(state)
        order = np.nonzero(live)[0]
        if not np.array_equal(gid[order], np.arange(self.model.n_objects)):
            raise RuntimeError("live rows do not cover the object ids")
        return {k: v.cpu().numpy()[order] for k, v in state.obj.items()}
