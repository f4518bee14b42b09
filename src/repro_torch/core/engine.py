"""The PARSIR epoch-synchronous conservative engine (paper §II), PyTorch.

Port of ``repro/core/engine.py``.  An engine step processes exactly one
epoch through the stage pipeline of :mod:`repro_torch.core.pipeline`:
extract the current bucket sorted by (ts, seed), optionally loan hot
objects' batches to underloaded devices, process every object's batch (the
``batch`` rounds loop, or the model's kernel with ``batch_impl="model"``),
optionally rebalance the placement, route the emissions and deliver them
into the calendar or the fallback list.  Every overflow/causality
condition is counted in ``Stats``.

Devices.  One engine is one device.  Without a process group it is the
whole simulation; with one (``ParsirEngine(..., group=g)``, a
``torch.distributed`` group of D ranks, each building its engine with the
same model and config) it is rank ``r`` of D devices that share one
simulation, as the JAX engine's ``shard_map`` over a D-device mesh: the
rank holds its contiguous range of objects in ``n_local_max`` padded rows
(its calendar, fallback, object state, epoch, Stats, the replicated
boundaries and the load, the reference's per-device shard), and the
stages' collectives run over the group (:mod:`.dist`).  Placement is
``equal``, ``weighted`` (the model's ``object_weights`` hint) or
``adaptive`` (padded by ``placement_slack``, the boundaries moved by the
rebalance stage).  Every call is collective: every rank calls ``init``,
``step``, ``run``, the drains and the inspection helpers in the same
order.  ``totals`` and ``in_flight`` are summed over the ranks;
``global_state``, ``global_row_of`` and ``global_object_state`` gather to
every rank.  Across devices the loops run eagerly (no CUDA graphs: gloo
cannot be captured, and NCCL capture waits for a machine with several
cards to check it); the drain's flag is one ``all_sum`` per
``DRAIN_CHUNK``, the reference's ``psum``, and the gated step sums the
events in flight over the ranks every epoch.  Stacked replications stay on
one device (R > 1 with D > 1 is refused, naming the rep-sharded slice).

The fused loops.  The JAX engine runs :meth:`ParsirEngine.run` as one
compiled ``fori_loop`` and :meth:`ParsirEngine.run_until_drained` as one
``while_loop`` that carries the drain predicate.  The port runs both on the
card as replays of CUDA graphs of the step (:mod:`repro_torch.core.graphs`)
wherever the step reads nothing on the host (a CUDA device and the
``batch-model`` scheduler): ``run`` replays graphs of the step and reads
nothing; ``run_until_drained`` replays graphs of the *gated* step (the epoch
advances only while events are in flight, so a drained state is a fixpoint)
and reads the in-flight count once per ``DRAIN_CHUNK`` epochs.  Elsewhere
(the CPU, or the ``batch`` rounds, ``batch-packed`` and ``ltf`` schedulers,
whose loop bounds are host reads) ``run`` is a Python loop of steps and
``run_until_drained`` runs the same gated chunks eagerly, one in-flight
read per chunk, so the CPU runs the semantics the card replays.

Replications.  :meth:`ParsirEngine.init_replicated` stacks R simulations
of the same model, one per seed (every leaf gains a leading R, see
:class:`~repro_torch.core.pipeline.base.EngineState`), and
:meth:`ParsirEngine.run_replicated_drained` drains them together: the
stacked gated step runs one scheduler call over the R * M rows of all of
them (one ``event_apply`` launch per epoch under ``batch-model``), replayed
as CUDA graphs on the card exactly as ``run_until_drained`` is, with the
flag summed over the replications.  A replication that drains stops at its
own drain epoch (the gated step, per replication), so each one equals its
own ``run_until_drained``, leaf by leaf.  ``batch_impl="packed"`` and
``scheduler="ltf"`` refuse R > 1 (:func:`~.pipeline.refuse_stacking`).

Speculation (``opt_window = W > 0``, :mod:`.pipeline.speculate`).  The
speculative step takes an exclusive epoch bound per replication and leaps
up to ``W + 1`` epochs a window, so ``run`` and the drains no longer know
their step count: they run chunks of at most ``DRAIN_CHUNK`` steps, each as
long as the farthest replication could need if every window commits
(``ceil(epochs left / (W + 1))``), and read one flag after each chunk (how
many replications are still short of their bound, or hold events in a
drain, and the epochs the farthest has left).  A replication at its bound,
or drained in a drain, is a bit-exact fixpoint of the step, so ``run(n)``
lands on exactly ``epoch + n`` and a drain's cap is the epoch counter, as
in the JAX engine.  On the card under ``batch-model`` the chunks are
replays of CUDA graphs of the speculative step, whose bound is the
runner's static tensor (:attr:`~.graphs.StepGraphs.bound`); the commit or
abort of a window never reaches the host.  ``step`` stays conservative.
With ``opt_adaptive`` the drain runs the reference's controller
(:meth:`ParsirEngine._run_drain_adaptive`), one speculative drain of a
width per chunk.  With ``opt_window = 0`` nothing speculative is built.

Counters: ``dispatches`` counts the JAX engine's way, one per ``init``,
``init_replicated``, ``step``, ``run``, ``run_until_drained`` and
``run_replicated_drained`` (and one per chunk of the adaptive drain);
``syncs`` counts host reads of device values made while running epochs
(the loop bound of the rounds, packed and ltf schedulers, one per epoch or
per sub-epoch of a speculative step, the drain flag or the speculative
loops' flag, one per chunk, and the adaptive controller's reads).

State ownership: like the JAX engine's donated buffers, ``step``/``run``
consume their input state — the ``model`` scheduler updates the object state
in place — so rebind the result and do not reuse the input.  Under graphs
the engine owns one static state: ``run`` and ``run_until_drained`` copy
their input into it (unless the input already is it) and return it, so the
next such call overwrites what the last one returned; clone a result to
keep it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .api import SimModel
from .calendar import (Calendar, bucket_occupancy, make_calendar,
                       make_fallback)
from .device import resolve_device
from .dist import Comm
from .events import EventBatch
from .graphs import DRAIN_CHUNK, StepGraphs, split
from .pipeline import (EngineConfig, EngineState, deliver, in_flight,
                       make_spec_step, make_step, map_tree,
                       pending_per_replication, refuse_stacking, replica,
                       resolve_scheduler, stack_of_one, zero_stats)
from .pipeline.step import refuse_reps_across_devices, step_host_syncs
from .placement import Placement, equal_placement, weighted_placement

__all__ = ["DRAIN_CHUNK", "EngineConfig", "EngineState", "ParsirEngine"]


def build_placement(model: SimModel, cfg: EngineConfig, D: int) -> Placement:
    """``cfg.placement`` as the engine's initial Placement: ``weighted``
    and ``adaptive`` read the model's ``object_weights`` hint (the equal
    split without one); ``adaptive`` widens the row pad by
    ``placement_slack`` so the boundaries have room to skew."""
    O = model.n_objects
    if cfg.placement == "equal":
        return equal_placement(O, D)
    w = model.object_weights()
    pl = equal_placement(O, D) if w is None else weighted_placement(w, D)
    if cfg.placement == "adaptive":
        pad = min(O, int(math.ceil(O / D * cfg.placement_slack)))
        pl = pl.padded(max(pl.n_local_max, pad))
    return pl


def spec_flag(state: EngineState, bound: torch.Tensor, drain: bool,
              comm: Comm | None = None) -> torch.Tensor:
    """The speculative loops' flag, i64 [2]: the replications still short
    of their ``bound`` (and, with ``drain``, holding events in flight,
    summed over ``comm``'s devices), and the most epochs one of them has
    left."""
    e = state.epoch.reshape(-1)
    active = e < bound
    if drain:
        pending = (pending_per_replication(state) if state.epoch.ndim == 2
                   else in_flight(state).reshape(1))
        if comm is not None:
            pending = comm.all_sum(pending)
        active = active & (pending > 0)
    return torch.stack([active.sum(),
                        torch.where(active, bound - e, 0).amax().long()])


class ParsirEngine:
    """Build, initialize and run a PARSIR simulation: on one device, or as
    one rank of ``group``'s devices."""

    def __init__(self, model: SimModel, cfg: EngineConfig,
                 device: str | torch.device = "cuda", group=None):
        self.device = resolve_device(device)
        self.model, self.cfg = model, cfg
        #: the device axis: this engine's rank of D (one device by default).
        self.comm = Comm(group)
        self.D, self.rank = self.comm.size, self.comm.rank
        cfg.validate(self.D)
        self.placement: Placement = build_placement(model, cfg, self.D)
        kw = dict(comm=self.comm)
        self._step = make_step(model, cfg, self.placement, **kw)
        self._gated = make_step(model, cfg, self.placement, gated=True, **kw)
        self._rep_gated = make_step(model, cfg, self.placement, gated=True,
                                    replicated=True, **kw)
        #: the speculative steps per live window width, built lazily (the
        #: adaptive controller builds only the widths it visits); with
        #: ``opt_window == 0`` nothing speculative is built.
        self._drain_variants: dict[int, object] = {}
        self._spec_step = self._rep_spec_step = None
        if cfg.opt_window > 0:
            self._spec_step = self._drain_variant(cfg.opt_window)
            self._rep_spec_step = make_spec_step(model, cfg, self.placement,
                                                 replicated=True, **kw)
        #: the window width of each chunk of the last adaptive drain.
        self.window_trail: list[int] = []
        self._scheduler = resolve_scheduler(cfg)
        self._step_syncs = step_host_syncs(cfg, self.D)
        #: host reads of device values made while running epochs (the
        #: inspection helpers below are not counted).
        self.syncs = 0
        #: calls of init, step, run and run_until_drained (the JAX engine's
        #: count of program launches).
        self.dispatches = 0
        #: the CUDA graphs of the step, where the step reads nothing on the
        #: host and runs on one device; None where the loops run eagerly.
        self._graphed = (self.device.type == "cuda" and self._step_syncs == 0
                         and self.D == 1)
        self.graphs = (StepGraphs({False: self._step, True: self._gated},
                                  self.device) if self._graphed else None)
        #: the graphs of the stacked gated step, with their own static
        #: stacked state, for the R of the last ``run_replicated_drained``
        #: (None where the loops run eagerly, or before the first call).
        self.rep_graphs: StepGraphs | None = None

    # -- lifecycle -------------------------------------------------------------

    def _fresh_state(self, R: int | None = None) -> EngineState:
        """This device's zeroed pre-ingest state (the reference's shard of
        device ``rank``); ``R`` stacks R copies of it."""
        M, cfg, dev = self.placement.n_local_max, self.cfg, self.device
        gids = self.placement.padded_gids()[self.rank * M:(self.rank + 1) * M]
        obj = self.model.init_object_state(gids, dev)
        cal = make_calendar(M, cfg.n_buckets, cfg.bucket_cap, dev)
        fb = make_fallback(cfg.fallback_cap, dev)
        b = torch.as_tensor(np.asarray(self.placement.boundaries, np.int32),
                            device=dev)
        state = EngineState(
            cal, fb, obj,
            epoch=torch.zeros((1,), dtype=torch.int32, device=dev),
            stats=zero_stats(dev),
            bounds=b[None, :].clone(),
            load=torch.zeros((M,), dtype=torch.int32, device=dev))
        if R is None:
            return state
        return map_tree(lambda t: t.unsqueeze(0).repeat(
            R, *(1,) * t.ndim), state)

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

    def _ingest(self, state: EngineState, batch: EventBatch) -> EngineState:
        """Deliver bootstrap batches [R, E] into a stacked state."""
        R, M = state.epoch.shape[0], self.placement.n_local_max
        pl = self.placement.with_boundaries(state.bounds[0, 0])
        flat = Calendar(*(x.flatten(0, 1) for x in state.cal))
        cal, fb, cal_ovf, fb_ovf, late, oob = deliver(
            flat, state.fb, batch, state.epoch[:, 0], self.rank, pl,
            self.cfg, init=True, replicated=True)
        st = state.stats
        stats = st._replace(cal_overflow=st.cal_overflow + cal_ovf[:, None],
                            fb_overflow=st.fb_overflow + fb_ovf[:, None],
                            late_events=st.late_events + late[:, None],
                            oob_events=st.oob_events + oob[:, None])
        cal = Calendar(*(x.unflatten(0, (R, M)) for x in cal))
        return state._replace(cal=cal, fb=fb, stats=stats)

    def init(self, seed: int | None = None) -> EngineState:
        """Build the initial state and ingest the bootstrap events
        (``seed`` selects the replication stream)."""
        self.dispatches += 1
        batch = map_tree(lambda t: t[None], self._initial_batch(seed))
        return replica(self._ingest(stack_of_one(self._fresh_state()),
                                    batch), 0)

    def init_replicated(self, seeds) -> EngineState:
        """Build an R-replication stacked state, one bootstrap stream per
        seed (``R = len(seeds)``).  The initial object state is the same in
        every replication: they diverge through their seed-salted bootstrap
        events alone.  Run it with :meth:`run_replicated_drained`."""
        seeds = [int(s) for s in seeds]
        if not seeds:
            raise ValueError("init_replicated needs at least one seed")
        refuse_stacking(self._scheduler, len(seeds))
        refuse_reps_across_devices(len(seeds), self.D)
        self.dispatches += 1
        batches = [self._initial_batch(s) for s in seeds]
        batch = EventBatch(*(torch.stack(x) for x in zip(*batches)))
        return self._ingest(self._fresh_state(len(seeds)), batch)

    def check_stats_bound(self, n_epochs: int) -> None:
        """Fail fast if ``n_epochs`` epochs could overflow a Stats counter.

        The port's ledger is int64 (:func:`zero_stats`).  The worst-case
        per-epoch increment of any counter is bounded by the largest static
        buffer a stage can fill: the epoch bucket (``n_local_max *
        bucket_cap``), the route buffer or the fallback list.  A stacked
        state keeps one ledger per replication, so the bound is the same
        for any R.  ``run``, ``run_until_drained`` and
        ``run_replicated_drained`` check it before they run.
        """
        cap = torch.iinfo(torch.int64).max
        per_epoch = self.placement.n_local_max * self.cfg.bucket_cap
        if self.cfg.steal:
            per_epoch += self.cfg.claim_cap * self.cfg.bucket_cap
        per_epoch = max(per_epoch, self.cfg.route_cap, self.cfg.fallback_cap)
        if int(n_epochs) * per_epoch > cap:
            raise ValueError(
                f"{n_epochs} epochs could overflow the int64 Stats counters "
                f"(worst-case {per_epoch} events/epoch/device, bound "
                f"{int(n_epochs) * per_epoch:,} > {cap:,}); split the horizon")

    def step(self, state: EngineState) -> EngineState:
        """Advance exactly one epoch (eagerly; always the conservative
        step, speculation engages inside ``run`` and the drains)."""
        self.dispatches += 1
        self.syncs += self._step_syncs
        return self._step(state)

    def run(self, state: EngineState, n_epochs: int) -> EngineState:
        """Advance exactly ``n_epochs`` epochs: replays of the step's graphs
        on the card (no host read), a loop of steps elsewhere.  Under
        speculation, chunks of the speculative step that land on exactly
        ``epoch + n_epochs``, one flag read per chunk."""
        n = int(n_epochs)
        self.check_stats_bound(n)
        self.dispatches += 1
        if self._spec_step is not None:
            return self._spec_loop(state, n, self.cfg.opt_window, drain=False)
        if self.graphs is None:
            for _ in range(n):
                self.syncs += self._step_syncs
                state = self._step(state)
            return state
        state = self.graphs.adopt(state)
        for length in split(n):
            self.graphs.replay(False, length)
        return state

    def run_until_drained(self, state: EngineState,
                          max_epochs: int) -> EngineState:
        """Run until no event is parked anywhere, or ``max_epochs`` epochs.

        Chunks of ``DRAIN_CHUNK`` epochs of the gated step, each followed by
        one host read of the events in flight; the loop stops after the
        first chunk that ends drained.  The gated step leaves a drained
        state as it is, epoch counter included, so the result equals the
        JAX engine's ``while_loop``, which stops at the drain epoch, and a
        workload that never drains runs exactly ``max_epochs`` epochs, equal
        to ``run(state, max_epochs)``.  Under speculation the drain runs
        the speculative step (its cap is the epoch counter), or with
        ``opt_adaptive`` the adaptive controller.
        """
        n = int(max_epochs)
        self.check_stats_bound(n)
        if self._spec_step is not None and self.cfg.opt_adaptive:
            return self._run_drain_adaptive(state, n)
        self.dispatches += 1
        if self._spec_step is not None:
            return self._spec_loop(state, n, self.cfg.opt_window, drain=True)
        return self._drain(state, n, self._gated, self.graphs)

    def run_replicated_drained(self, state: EngineState,
                               max_epochs: int) -> EngineState:
        """Drain the R replications of a stacked state together: the
        stacked gated step in chunks of ``DRAIN_CHUNK`` epochs (replays of
        its CUDA graphs on the card under ``batch-model``), one host read
        of their summed events in flight per chunk, until every replication
        is drained or ``max_epochs`` epochs have run.  Each replication
        stops at its own drain epoch, so replication r of the result equals
        ``run_until_drained(init(seed=seeds[r]), max_epochs)`` leaf by leaf.
        Under speculation the stacked speculative step runs instead, each
        replication with its own bound ``epoch + max_epochs``: it stops
        when it drains or reaches it.
        On the card the result is the runner's static stacked state (the
        next call overwrites it).  Read it with :meth:`replication`,
        :meth:`totals_replicated` and :meth:`in_flight_replicated`.
        """
        n = int(max_epochs)
        self.check_stats_bound(n)
        R = state.epoch.shape[0]
        refuse_stacking(self._scheduler, R)
        refuse_reps_across_devices(R, self.D)
        self.dispatches += 1
        if self._graphed and (self.rep_graphs is None
                              or self.rep_graphs.static.epoch.shape[0] != R):
            self.rep_graphs = None       # free the last R's state and pool
            self.rep_graphs = StepGraphs({True: self._rep_gated},
                                         self.device)
        if self._rep_spec_step is not None:
            return self._spec_loop(state, n, self.cfg.opt_window, drain=True,
                                   stacked=True)
        return self._drain(state, n, self._rep_gated, self.rep_graphs)

    def _drain_variant(self, w: int):
        """The speculative step of live window width ``w`` (of one
        simulation), built and kept on first use: the state carries nothing
        W-shaped, so the same state runs through any width."""
        if w not in self._drain_variants:
            cfg_w = dataclasses.replace(self.cfg, opt_window=w,
                                        opt_adaptive=False)
            self._drain_variants[w] = make_spec_step(
                self.model, cfg_w, self.placement, comm=self.comm)
        return self._drain_variants[w]

    def _spec_loop(self, state: EngineState, n: int, w: int, drain: bool,
                   stacked: bool = False) -> EngineState:
        """``n`` epochs (a bound per replication, ``epoch + n``) of the
        speculative step of width ``w``: chunks of at most ``DRAIN_CHUNK``
        steps, each as long as the farthest replication needs if every
        window commits, and one read of :func:`spec_flag` after each;
        replays of the step's CUDA graphs where the engine has them."""
        graphs = self.rep_graphs if stacked else self.graphs
        step = self._rep_spec_step if stacked else self._drain_variant(w)
        variant = ("spec", w, drain)
        if graphs is not None:
            state = graphs.adopt(state)
            bound = graphs.bound
            graphs.add(variant, lambda s: step(s, bound, drain),
                       lambda s: spec_flag(s, bound, drain))
            bound.copy_(state.epoch.reshape(-1) + n)
        else:
            bound = state.epoch.reshape(-1) + n
        left = n
        while left > 0:
            steps = min(DRAIN_CHUNK, -(-left // (w + 1)))
            if graphs is None:
                for _ in range(steps):
                    self.syncs += self._step_syncs * (w + 1)
                    state = step(state, bound, drain)
                active, left = spec_flag(state, bound, drain,
                                         self.comm).tolist()
            else:
                for length in split(steps):
                    graphs.replay(variant, length)
                active, left = graphs.read(variant)
            self.syncs += 1
            if active == 0:
                break
        return state

    def _run_drain_adaptive(self, state: EngineState, max_epochs: int
                            ) -> EngineState:
        """The reference's adaptive-W drain: chunks of ``max(8, 4 * (W0 +
        1))`` epochs, each one speculative drain of the live width ``w``
        (one dispatch).  After a chunk the host reads its rollback ratio
        ``rollbacks / (rollbacks + spec_commits)``: above 1/2 the width
        shrinks (floor 1), below 1/10 it grows (cap ``opt_window``).  Any
        width sequence drains to the same bits.  The widths go to
        :attr:`window_trail`."""
        W0 = self.cfg.opt_window
        w = W0
        chunk = max(8, 4 * (W0 + 1))
        self.window_trail = []
        start = int(state.epoch[0])
        tot = self.totals(state)
        self.syncs += 2
        prev_cm, prev_rb = tot["spec_commits"], tot["rollbacks"]
        epochs_run = 0
        while True:
            n = min(chunk, max_epochs - epochs_run)
            self.dispatches += 1
            self.window_trail.append(w)
            state = self._spec_loop(state, max(n, 0), w, drain=True)
            epochs_run = int(state.epoch[0]) - start
            pending = self.in_flight(state)
            self.syncs += 2
            if epochs_run >= max_epochs or n <= 0 or pending == 0:
                return state
            tot = self.totals(state)
            self.syncs += 1
            d_cm = tot["spec_commits"] - prev_cm
            d_rb = tot["rollbacks"] - prev_rb
            prev_cm, prev_rb = tot["spec_commits"], tot["rollbacks"]
            if d_cm + d_rb:
                ratio = d_rb / (d_rb + d_cm)
                if ratio > 0.5 and w > 1:
                    w -= 1
                elif ratio < 0.1 and w < W0:
                    w += 1

    def _drain(self, state: EngineState, n: int, gated, graphs
               ) -> EngineState:
        """The drain loop: chunks of ``gated`` (replays of ``graphs`` where
        there are any), one read of the events in flight after each."""
        if graphs is not None:
            state = graphs.adopt(state)
        for c0 in range(0, n, DRAIN_CHUNK):
            chunk = min(DRAIN_CHUNK, n - c0)
            if graphs is None:
                for _ in range(chunk):
                    self.syncs += self._step_syncs
                    state = gated(state)
                pending = int(self.comm.all_sum(in_flight(state)))
            else:
                for length in split(chunk):
                    graphs.replay(True, length)
                pending = graphs.read(True)
            self.syncs += 1
            if pending == 0:
                break
        return state

    # -- inspection -------------------------------------------------------------

    def replication(self, state: EngineState, r: int) -> EngineState:
        """Replication ``r`` of a stacked state in the classic layout (views
        into the stack), for every inspection helper below."""
        return replica(state, r)

    def totals_replicated(self, state: EngineState) -> list[dict[str, int]]:
        """Per-replication Stats totals of a stacked state, in seed order."""
        R = state.epoch.shape[0]
        rows = torch.stack([v.reshape(R, -1).sum(1)
                            for v in state.stats], 1).tolist()
        return [dict(zip(state.stats._fields, (int(v) for v in row)))
                for row in rows]

    def in_flight_replicated(self, state: EngineState) -> np.ndarray:
        """Per-replication in-flight event counts, i64 [R]."""
        return pending_per_replication(state).cpu().numpy().astype(np.int64)

    def totals(self, state: EngineState) -> dict[str, int]:
        """Stats summed over the replications of a stack and the devices."""
        flat = self.comm.all_sum(torch.stack([v.sum() for v in state.stats]))
        return dict(zip(state.stats._fields, (int(v) for v in flat.tolist())))

    def in_flight(self, state: EngineState) -> int:
        """Events in flight, summed over the devices."""
        return int(self.comm.all_sum(in_flight(state)))

    def occupancy(self, state: EngineState) -> dict[str, np.ndarray | int]:
        """Width-packing diagnostics for the *current* epoch's bucket.

        Per device: the live event total (``events``), the deepest
        per-object batch (``max_depth``), the dense rounds grid
        (``padded_lanes = max_depth × n_local_max``) and the events present
        (``packed_lanes``, what ``batch_impl='packed'`` processes up to
        per-round tile rounding).  The padded-row tax is the gap.
        """
        M = self.placement.n_local_max
        depth = self.comm.all_gather(bucket_occupancy(
            state.cal, state.epoch[0])).cpu().numpy().reshape(self.D, M)
        events = depth.sum(axis=1)
        max_depth = depth.max(axis=1, initial=0)
        return {"events": events, "max_depth": max_depth,
                "padded_lanes": max_depth * M, "packed_lanes": events,
                "n_local_max": M}

    def global_state(self, state: EngineState) -> EngineState:
        """Every device's state gathered to every rank, in the JAX engine's
        global layout: each leaf's shards concatenated along dim 0
        (``cal`` [D * M, ...], ``fb`` [D * F], ``epoch`` and each Stats
        field [D], ``bounds`` [D, D + 1], ``load`` [D * M]).  The state
        itself on one device."""
        if self.D == 1:
            return state
        return map_tree(lambda t: t.flatten(0, 1),
                        self.comm.all_gather(state))

    def boundaries_of(self, state: EngineState) -> np.ndarray:
        """The live placement boundaries, i64[D + 1] (the same on every
        device; they move under ``placement='adaptive'``)."""
        return state.bounds[0].cpu().numpy().astype(np.int64)

    def global_row_of(self, state: EngineState
                      ) -> tuple[np.ndarray, np.ndarray]:
        """(gid, live) per padded row of every device, each [D *
        n_local_max]: ``gid[r]`` the global object id row ``r`` backs,
        ``live[r]`` False for pad rows."""
        b = self.boundaries_of(state)
        M = self.placement.n_local_max
        d = np.arange(self.D * M) // M
        i = np.arange(self.D * M) % M
        gid = b[d] + i
        live = i < (b[d + 1] - b[d])
        return np.where(live, gid, 0), live

    def global_object_state(self, state: EngineState) -> dict[str, np.ndarray]:
        """Per-object state in global id order, leading dim ``n_objects``,
        gathered from every device."""
        gid, live = self.global_row_of(state)
        order = np.nonzero(live)[0]
        if not np.array_equal(gid[order], np.arange(self.model.n_objects)):
            raise RuntimeError("live rows do not cover the object ids")
        obj = self.comm.all_gather(state.obj)
        return {k: v.flatten(0, 1).cpu().numpy()[order]
                for k, v in obj.items()}
