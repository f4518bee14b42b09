"""Bounded-optimism speculation: the Time Warp-lite epoch step (opt_window).

Port of ``repro/core/pipeline/speculate.py``.  With
``EngineConfig.opt_window = W > 0`` one step commits the *safe* epoch
``e0`` conservatively and then speculates up to ``W`` further epochs
against a shadow copy of the touched state: the object state and the ``W``
calendar buckets of the window (:func:`~repro_torch.core.calendar.
take_buckets` / ``put_buckets``).  A window commits, leaping the epoch by
``W_eff + 1``, or aborts: the shadow is restored and the epoch advances by
the safe epoch alone.  The reference module documents the verdict (per
device with the horizon guard, or global), the sender filter and the
staging overflow rule; this port follows it step for step:

  1. the safe sub-epoch ``e0`` (extract, process, route, deliver), kept in
     both branches;
  2. the shadow, taken after it;
  3. the speculative sub-epochs ``e0 + w``, ``w = 1 .. W_eff``: emissions
     local and inside the window are inserted at once (later sub-epochs
     consume them), everything else parks in a staging buffer;
  4. the two exchanges, the safe buffer and the staged remote events;
  5. the verdict from ``[m_local, v_local]`` (the earliest in-window
     arrival, the violation count) of every device;
  6. commit or abort.

At one device no event is remote, so no straggler can arrive and every
window commits unless ``inject_straggler_every`` forces it down the abort
path (every n-th window, counted per replication by ``spec_commits +
rollbacks``, where ``W_eff > 0``).  Across devices (the engine's
:class:`~repro_torch.core.dist.Comm`, each rank its shard of the stack) the two
exchanges carry events, the verdict is one ``all_gather`` of every
device's ``[m_local, v_local]``, and a speculative arrival is kept only if
its sender keeps its window (``keep_vec[sender_ids]``).  Loans
(``steal=True``, only under ``opt_commit='global'``) run in the safe
sub-epoch and every speculative one; the adaptive rebalance fires only in
the safe sub-epoch, the window clamped to stop short of the next firing
epoch, and the load the window measured is kept only on commit.  The
window, the flags and the verdict are the same on every device, so every
rank runs the same collectives in the same order.

What differs from the reference, and why:

* **Stacked.**  The step is written for a stacked state of R replications
  (:func:`~.step.make_step`'s layout): extract and process take the
  ``[R * M, ...]`` views, so each sub-epoch is one scheduler call (one
  ``event_apply`` launch under ``batch-model``) for all R; triage, staging,
  the exchanges, the verdict, the deliveries and the Stats work along dim 1
  of ``[R, E]`` batches.  The classic step is it on a stack of one.
* **No branch on the host.**  The reference skips a sub-epoch past
  ``W_eff`` with ``lax.cond`` and picks commit or abort with another.  Here
  ``W_eff`` and the verdict are device values, one per replication, and
  reading them would take the step out of the drain's CUDA graphs.  So
  every sub-epoch runs for every replication with its extract masked (a
  replication past its ``W_eff`` extracts nothing: its bucket stays, its
  rows read a count of 0, the scheduler leaves them alone and nothing is
  inserted or staged), and both branches are computed and each
  replication takes one of them with ``torch.where``: the calendar, the
  fallback, the object state, the Stats deltas and the next epoch.  The
  masked sub-epoch matters because ``batch-model`` writes the object state
  in place: computing a sub-epoch and selecting it away afterwards would
  not undo it.
* **The shadow is a copy.**  JAX's ``shadow_obj = obj`` is free; the
  port's kernel updates the state's own tensors, so the shadow is a clone
  taken after the safe sub-epoch, and the chosen state is written back
  into the state's tensors (``torch.where(..., out=...)``).
* **The bound gates the whole step.**  The reference's loops never call
  the step at or past the bound; the port's graphs replay a fixed number of
  steps, so a replication at its bound (``e0 >= bound``), or in a drain
  one with nothing in flight, must be a bit-exact fixpoint: its extract
  and its fallback are masked out, and its fallback, epoch and Stats are
  kept, as the gated conservative step keeps them.

``rollbacks`` / ``speculated`` / ``spec_commits`` are activity meters,
absent from the clean counters; each window ticks one of ``spec_commits``
/ ``rollbacks``.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..api import SimModel
from ..calendar import (Calendar, Fallback, extract_sorted, fallback_put,
                        insert, put_buckets, take_buckets)
from ..dist import Comm
from ..events import (EventBatch, compact, compact_mask, concat_batches,
                      empty_batch, truncate)
from ..placement import Placement
from . import rebalance, routers, schedulers, steal  # noqa: F401  (registration)
from .base import (EngineState, epoch_of, replica, resolve_rebalance,
                   resolve_router, resolve_scheduler, resolve_steal,
                   stack_of_one)
from .config import EngineConfig
from .deliver import deliver
from .step import live_placement, pending_per_replication

#: "no in-window arrival" marker for the earliest-straggler epoch.
NO_STRAGGLER = torch.iinfo(torch.int32).max


def _stage_put(staging: EventBatch, new: EventBatch):
    """Append the valid events of ``new`` to the staging buffer
    (compacting; per replication along the last dim).  Overflow is counted,
    never dropped in silence: the step turns it into an abort."""
    merged = compact(concat_batches(staging, new))
    cap = staging.capacity
    return truncate(merged, cap), merged.valid[..., cap:].sum(-1)


def _pick(keep: torch.Tensor, a: torch.Tensor, b: torch.Tensor
          ) -> torch.Tensor:
    """``a`` where ``keep`` (one flag per leading row), else ``b``."""
    return torch.where(keep.view((-1,) + (1,) * (a.ndim - 1)), a, b)


def make_spec_step(model: SimModel, cfg: EngineConfig, placement: Placement,
                   replicated: bool = False, comm: Comm | None = None
                   ) -> Callable[..., EngineState]:
    """The speculative step ``step(state, bound, drain=False)``.

    ``bound`` (i32, one per replication, or one for the classic step) is
    the exclusive epoch bound of the enclosing loop: the window is clamped
    to ``W_eff = clamp(bound - 1 - e0, 0, W)``, so ``run(n)`` lands on
    exactly epoch ``n``, and a replication at or past it is left as it is.
    With ``drain`` a replication with no event in flight is left as it is
    too (the drain's gate).  With ``replicated`` the step takes a stacked
    state of any number of replications (each rank its shard of all of
    them across devices).
    """
    comm = comm or Comm()
    N = cfg.n_buckets
    O = placement.n_objects
    M = placement.n_local_max
    D = placement.n_devices
    W = cfg.opt_window
    if W < 1:
        raise ValueError("make_spec_step needs opt_window > 0 (use make_step)")
    if comm.size != D:
        raise ValueError(f"placement over {D} devices, comm of {comm.size}")
    dev = comm.rank

    scheduler = resolve_scheduler(cfg)
    router = resolve_router(cfg.route)
    policy = resolve_steal(cfg, D)
    rebalancer = resolve_rebalance(cfg)
    adaptive = cfg.placement == "adaptive"
    per_rep = adaptive and D > 1
    per_device = cfg.opt_commit == "device"
    inject = cfg.inject_straggler_every
    scheduler.validate(model, cfg)
    router.validate(cfg, placement)

    def stacked(state: EngineState, bound: torch.Tensor,
                drain: bool = False) -> EngineState:
        R = state.epoch.shape[0]
        device = state.epoch.device
        e0 = state.epoch[:, 0]
        active = e0 < bound.reshape(-1)
        if drain:
            active = active & (comm.all_sum(pending_per_replication(state))
                               > 0)
        w_eff = torch.where(active, (bound.reshape(-1) - 1 - e0).clamp(0, W),
                            0).to(e0.dtype)
        if adaptive:
            # never speculate onto (or leap over) a rebalance firing epoch:
            # firings run only in the safe sub-epoch.
            RE = cfg.rebalance_every
            d_fire = (RE - 1 - e0 % RE) % RE
            w_eff = torch.minimum(w_eff, torch.where(d_fire == 0, RE - 1,
                                                     d_fire - 1))
        pl = live_placement(placement, state.bounds[:, 0], per_rep)
        start = pl.start(dev, device)
        row0 = M * torch.arange(R, dtype=torch.int32, device=device)[:, None]

        def rows(x):                      # [R] -> one per row of the stack
            return x.repeat_interleave(M)

        # -- 1. the safe sub-epoch e0 (kept in both branches) ---------------
        cal = Calendar(*(x.flatten(0, 1) for x in state.cal))
        cal, ts_s, seed_s, pay_s, cnt_b = extract_sorted(cal, rows(e0),
                                                         rows(active))
        obj = {k: v.flatten(0, 1) for k, v in state.obj.items()}
        obj, out, lv0, stolen0, proc0 = policy.process(
            model, scheduler, cfg, pl, comm, obj, ts_s, seed_s, pay_s,
            cnt_b, R)

        bounds, load = state.bounds, state.load
        zero = torch.zeros((R,), dtype=torch.int64, device=device)
        migrated = fired = zero
        if adaptive:
            b, load, cal, obj, migrated, fired = rebalancer.rebalance(
                cfg, placement, comm, e0, bounds[:, 0],
                load + cnt_b.view(R, M), cal, obj, active)
            pl = live_placement(placement, b, per_rep)
            bounds = b[:, None, :]
            start = pl.start(dev, device)

        old_fb = state.fb.events
        prod = concat_batches(out, old_fb._replace(
            valid=old_fb.valid & active[:, None]))
        ep_p = epoch_of(prod.ts, cfg.epoch_len)
        c0 = e0[:, None]
        oob_p = prod.valid & ((prod.dst < 0) | (prod.dst >= O))
        late_p = prod.valid & ~oob_p & (ep_p <= c0)
        good = prod.valid & ~oob_p & ~late_p
        local = good & (pl.owner(prod.dst) == dev)
        # remote in-horizon events ride the safe exchange; local ones
        # deliver at once (the window's sub-epochs must see them).
        safe_buf, send, route_ovf0 = router.select_send(
            prod, good & ~local & (ep_p <= c0 + N), pl, cfg)
        kept = compact_mask(prod, good & ~local & ~send)
        fb = Fallback(truncate(kept, cfg.fallback_cap))
        fb_ovf0 = kept.valid[..., cfg.fallback_cap:].sum(-1)
        cal, fb, cal_ovf0, fb_ovf0b, late0b, _ = deliver(
            cal, fb, prod._replace(valid=local), e0, dev, pl, cfg,
            init=False, replicated=False)

        # -- 2. the shadow: the window's buckets and the object state -------
        first = rows(e0 + 1)
        shadow_cal = take_buckets(cal, first, W)
        shadow_obj = {k: v.clone() for k, v in obj.items()}

        # -- 3. the speculative sub-epochs, each masked past W_eff ----------
        staging = empty_batch(cfg.opt_stage_cap, R, device=device)
        spec_proc = spec_lv = spec_late = spec_oob = spec_covf = zero
        stage_ovf = spec_stolen = zero
        load_sp = torch.zeros_like(load)
        for w in range(1, W + 1):
            cur = e0 + w
            cal, ts_w, seed_w, pay_w, cnt_w = extract_sorted(
                cal, rows(cur), rows(w <= w_eff))
            obj, out_w, lv_w, stl_w, proc_w = policy.process(
                model, scheduler, cfg, pl, comm, obj, ts_w, seed_w, pay_w,
                cnt_w, R)
            ep_w = epoch_of(out_w.ts, cfg.epoch_len)
            oob_w = out_w.valid & ((out_w.dst < 0) | (out_w.dst >= O))
            late_w = out_w.valid & ~oob_w & (ep_w <= cur[:, None])
            good_w = out_w.valid & ~oob_w & ~late_w
            # local and inside the shadowed window: insert now (later
            # sub-epochs consume it); anything else parks in staging.
            ins = good_w & (pl.owner(out_w.dst) == dev) \
                & (ep_w <= c0 + W)
            lidx = (out_w.dst - start).clamp(0, M - 1) + row0
            new, _ = insert(cal, lidx.reshape(-1), ep_w.reshape(-1),
                            out_w.ts.reshape(-1), out_w.seed.reshape(-1),
                            out_w.payload.reshape(-1), ins.reshape(-1))
            covf_w = ins.sum(-1) - (new.cnt - cal.cnt).view(R, -1).sum(1)
            cal = new
            staging, sovf_w = _stage_put(staging,
                                         compact_mask(out_w, good_w & ~ins))
            spec_proc = spec_proc + proc_w
            spec_stolen = spec_stolen + stl_w
            load_sp = load_sp + cnt_w.view(R, M)
            spec_lv = spec_lv + lv_w
            spec_late = spec_late + late_w.sum(-1)
            spec_oob = spec_oob + oob_w.sum(-1)
            spec_covf = spec_covf + covf_w
            stage_ovf = stage_ovf + sovf_w

        # -- 4. the two exchanges -------------------------------------------
        routed_safe = router.exchange(safe_buf, pl, cfg, comm)
        ep_st = epoch_of(staging.ts, cfg.epoch_len)
        stage_remote = staging.valid & (pl.owner(staging.dst) != dev)
        horizon = (e0 + w_eff)[:, None]
        spec_buf, spec_send, spec_route_ovf = router.select_send(
            staging, stage_remote & (ep_st <= horizon + N), pl, cfg)
        routed_spec = router.exchange(spec_buf, pl, cfg, comm)

        # -- 5. the verdict ---------------------------------------------------
        def violations(batch: EventBatch):
            ep = epoch_of(batch.ts, cfg.epoch_len)
            mine = (batch.valid & (batch.dst >= 0) & (batch.dst < O)
                    & (pl.owner(batch.dst) == dev))
            viol = mine & (ep <= horizon)
            return (viol.sum(-1),
                    torch.where(viol, ep, NO_STRAGGLER).amin(-1))

        cnt_sf, m_sf = violations(routed_safe)
        cnt_sp, m_sp = violations(routed_spec)
        lost = stage_ovf + spec_route_ovf
        v_local = cnt_sf + cnt_sp + lost
        m_local = torch.minimum(m_sf, m_sp)
        m_local = torch.where(lost > 0, torch.minimum(m_local, e0 + 1),
                              m_local)
        if inject > 0:
            st = state.stats
            windows = st.spec_commits[:, 0] + st.rollbacks[:, 0]
            fire = (windows % inject == inject - 1) & (w_eff > 0)
            v_local = v_local + fire
            m_local = torch.where(fire, torch.minimum(m_local, e0 + 1),
                                  m_local)
        # the verdict's inputs of every device: one all_gather.
        g = comm.all_gather(torch.stack([m_local.to(torch.int64),
                                         v_local.to(torch.int64)], -1))
        m_all, v_all = g[..., 0].T, g[..., 1].T                  # [R, D]
        m_global = m_all.amin(1)
        all_commit = m_global == NO_STRAGGLER
        guard = (e0 + w_eff) <= m_global
        if per_device:
            keep_vec = (v_all == 0) & guard[:, None]
            keep = (v_local == 0) & guard
        else:
            keep_vec = all_commit[:, None].expand(R, D)
            keep = all_commit
        e_next = torch.where(all_commit, e0 + w_eff + 1, e0 + 1)
        cur_c = torch.where(all_commit, e0 + w_eff, e0)
        senders = router.sender_ids(pl, cfg, device).long()
        spec_arrivals = routed_spec._replace(
            valid=routed_spec.valid & keep_vec[:, senders])

        # -- 6. commit and abort, both computed; each replication keeps one
        rep = router.replicated
        c, f, co1, fo1, l1, _ = deliver(cal, fb, routed_safe, cur_c, dev, pl,
                                        cfg, init=False, replicated=rep)
        c, f, co2, fo2, l2, _ = deliver(c, f, spec_arrivals, cur_c, dev, pl,
                                        cfg, init=False, replicated=rep)
        # staged leftovers: local beyond the window deliver (insert or
        # park); remote beyond the horizon park in the fallback.
        leftover = staging.valid & ~spec_send
        lo_local = leftover & (pl.owner(staging.dst) == dev)
        c, f, co3, fo3, l3, _ = deliver(c, f, staging._replace(
            valid=lo_local), cur_c, dev, pl, cfg, init=False,
            replicated=False)
        f, fo4 = fallback_put(f, staging._replace(
            valid=leftover & ~lo_local))
        commit = dict(proc=spec_proc, lv=spec_lv, late=spec_late,
                      oob=spec_oob, covf=spec_covf + co1 + co2 + co3,
                      fovf=fo1 + fo2 + fo3 + fo4, late2=l1 + l2 + l3,
                      rb=zero, cm=zero + 1, spec=spec_proc,
                      stolen=spec_stolen)

        a = put_buckets(cal, first, shadow_cal)
        a, fa, ao1, fao1, la1, _ = deliver(a, fb, routed_safe, cur_c, dev,
                                           pl, cfg, init=False,
                                           replicated=rep)
        # keepers' committed speculative emissions still arrive.
        a, fa, ao2, fao2, la2, _ = deliver(a, fa, spec_arrivals, cur_c, dev,
                                           pl, cfg, init=False,
                                           replicated=rep)
        abort = dict(proc=zero, lv=zero, late=zero, oob=zero,
                     covf=ao1 + ao2, fovf=fao1 + fao2, late2=la1 + la2,
                     rb=zero + 1, cm=zero, spec=zero, stolen=zero)

        rk = rows(keep)
        cal = Calendar(*(_pick(rk, x, y) for x, y in zip(c, a)))
        for k, v in obj.items():
            torch.where(rk.view((-1,) + (1,) * (v.ndim - 1)), v,
                        shadow_obj[k], out=v)
        d = {k: torch.where(keep, commit[k], abort[k]) for k in commit}

        def add(counter, n):
            return counter + n[:, None]

        st = state.stats
        stats = st._replace(
            processed=add(st.processed, proc0 + d["proc"]),
            cal_overflow=add(st.cal_overflow, cal_ovf0 + d["covf"]),
            fb_overflow=add(st.fb_overflow, fb_ovf0 + fb_ovf0b + d["fovf"]),
            route_overflow=add(st.route_overflow, route_ovf0),
            late_events=add(st.late_events, late_p.sum(-1) + late0b
                            + d["late"] + d["late2"]),
            lookahead_violations=add(st.lookahead_violations,
                                     lv0 + d["lv"]),
            stolen=add(st.stolen, stolen0 + d["stolen"]),
            oob_events=add(st.oob_events, oob_p.sum(-1) + d["oob"]),
            rebalances=add(st.rebalances, fired),
            migrated=add(st.migrated, migrated),
            rollbacks=add(st.rollbacks, d["rb"]),
            speculated=add(st.speculated, d["spec"]),
            spec_commits=add(st.spec_commits, d["cm"]),
        )
        # a replication left as it is keeps its fallback, Stats and epoch
        # (its calendar and object state are untouched by construction).
        fb = Fallback(EventBatch(*(
            _pick(keep, x, y) for x, y in zip(f.events, fa.events))))
        fb = Fallback(EventBatch(*(
            _pick(active, x, y) for x, y in zip(fb.events, old_fb))))
        stats = type(st)(*(_pick(active, x, y) for x, y in zip(stats, st)))
        epoch = torch.where(active, e_next, e0)[:, None]
        cal = Calendar(*(x.unflatten(0, (R, M)) for x in cal))
        obj = {k: v.unflatten(0, (R, M)) for k, v in obj.items()}
        if adaptive:
            load = load + torch.where(keep[:, None], load_sp, 0)
        return EngineState(cal, fb, obj, epoch, stats, bounds, load)

    if replicated:
        return stacked

    def step(state: EngineState, bound: torch.Tensor,
             drain: bool = False) -> EngineState:
        return replica(stacked(stack_of_one(state), bound, drain), 0)

    return step
