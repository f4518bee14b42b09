"""RebalancePolicy stage implementations (paper §II-A / §II-C).

Port of ``repro/core/pipeline/rebalance.py``:

``none``     — the boundaries set at engine construction are final.
``adaptive`` — every ``rebalance_every`` epochs, recompute the contiguous
               boundaries from *measured* per-object processed counts (the
               knapsack objective of ``weighted_placement`` fed by runtime
               load) and migrate moved objects (state row and whole
               calendar rows) to their new owners.

The mechanics are the reference's: the per-device ``load`` vectors are
gathered into a global per-object load, the new boundaries are its
equal-mass quantile cuts computed the same on every device, each shift is
clamped to ``migrate_cap // 2`` and each range to the ``n_local_max`` pad
(so no device ever ships more than ``migrate_cap`` rows), the leaving rows
(a prefix and/or suffix of a device's range) are published through an
``all_gather`` with their calendar rows, the staying rows shift slots by a
gather-roll, receivers put the claimed rows in place and vacated slots are
deadened.  Fallback entries carry global ids and re-route themselves.

The firing test ``(cur + 1) % rebalance_every == 0`` is the same on every
device.  Across devices the loads are gathered every step and the firing
test and the window's total load are read on the host together (one read
a step); the migration's collectives run only in a firing epoch, on every
rank together.  A stack of R replications over several devices (the
reference's ``vmap`` of the stage) keeps a row of boundaries per
replication: the loads of all R are gathered at once, and each firing
replication computes its cuts and migrates its rows on its own.  On one
device nothing can move (the only range is all of ``[0, n_objects)``), so
a firing resets the load and counts, with no host read: the step stays
capturable, and each replication of a stack fires at its own epoch.

``_quantile_boundaries`` cuts an f32 prefix sum of integer loads, as the
reference does: exact, whatever the order of the additions, while the
total stays below 2**24.  Above it the reference's cuts depend on its
reduction order, so the port refuses such a total by name instead of
cutting elsewhere.
"""
from __future__ import annotations

import torch

from ..calendar import Calendar, clear_rows, put_rows, take_rows
from .base import RebalancePolicy, register_rebalancer

#: the largest window load whose f32 prefix sum is exact.
EXACT_F32_LOAD = 1 << 24


@register_rebalancer("none")
class NoRebalance(RebalancePolicy):
    """Static placement: boundaries never move."""

    def rebalance(self, cfg, placement, comm, cur, bounds, load, cal, obj,
                  gate=None):
        zero = torch.zeros_like(cur, dtype=torch.int64)
        return bounds, load, cal, obj, zero, zero


def _quantile_boundaries(obj_load, bounds, D, M, O, shift_cap):
    """New boundaries, the same on every device: equal-mass cuts, clamped.

    The clamps keep every boundary within ``shift_cap`` of its old
    position and every range within the row pad ``M`` while staying
    feasible.  ``obj_load`` [O] integer, ``bounds`` i32 [D + 1]."""
    w = obj_load.to(torch.float32)
    cum = torch.cat([w.new_zeros(1), torch.cumsum(w, 0)])
    total = cum[-1]
    targets = total * torch.arange(1, D, dtype=torch.float32,
                                   device=w.device) / D
    cuts = torch.searchsorted(cum, targets, right=False).to(torch.int32)
    desired = torch.cat([cuts.new_zeros(1), cuts, cuts.new_full((1,), O)])
    bounds = bounds.to(torch.int32)
    nb = [bounds.new_zeros(())]
    for d in range(1, D):
        lo = torch.maximum(torch.maximum(nb[d - 1], bounds[d] - shift_cap),
                           bounds.new_tensor(O - (D - d) * M))
        hi = torch.minimum(torch.minimum(nb[d - 1] + M, bounds[d] + shift_cap),
                           bounds.new_tensor(d * M))
        nb.append(torch.minimum(torch.maximum(desired[d], lo), hi))
    nb.append(bounds.new_tensor(O))
    new_b = torch.stack(nb)
    # an idle window (no events processed anywhere) carries no signal.
    return torch.where(total > 0, new_b, bounds)


@register_rebalancer("adaptive")
class AdaptiveRebalance(RebalancePolicy):
    """Epoch-boundary boundary recomputation and object migration."""

    def host_syncs(self, n_devices):
        return int(n_devices > 1)

    def rebalance(self, cfg, placement, comm, cur, bounds, load, cal, obj,
                  gate=None):
        fire = (cur + 1) % cfg.rebalance_every == 0                 # [R]
        if gate is not None:
            fire = fire & gate
        if placement.n_devices == 1:
            # one range, [0, O): nothing moves; the window's load resets.
            load = torch.where(fire[:, None], 0, load)
            return (bounds, load, cal, obj, torch.zeros_like(cur,
                    dtype=torch.int64), fire.to(torch.int64))
        R = cur.shape[0]
        D, M, O = placement.n_devices, placement.n_local_max, \
            placement.n_objects
        device = load.device
        b = bounds.to(torch.int32)                                  # [R, D+1]
        # the measured global per-object load of each replication (the
        # same on every device).
        all_load = comm.all_gather(load)                            # [D, R, M]
        ar = torch.arange(D * M, dtype=torch.int32, device=device)
        d_idx, i_idx = (ar // M).long(), ar % M
        gid_all = b[:, :-1][:, d_idx] + i_idx                       # [R, D*M]
        row_live = i_idx < (b[:, 1:] - b[:, :-1])[:, d_idx]
        obj_load = torch.zeros((R, O + 1), dtype=torch.int64, device=device)
        obj_load.scatter_add_(1, torch.where(row_live, gid_all, O).long(),
                              all_load.movedim(0, 1).reshape(R, D * M)
                              .to(torch.int64))
        obj_load = obj_load[:, :O]
        # the firing test and the window's loads, in one host read.
        host = torch.cat([fire.to(torch.int64), obj_load.sum(1)]).tolist()
        fired, total = host[:R], host[R:]
        zero = torch.zeros((R,), dtype=torch.int64, device=device)
        if not any(fired):
            return bounds, load, cal, obj, zero, zero
        # each firing replication moves its own cuts and rows (every
        # device fires the same replications, so the migrations'
        # collectives run in step).
        new_b, new_load, recv = list(b), list(load), list(zero)
        cals = [Calendar(*(x[r * M:(r + 1) * M] for x in cal))
                for r in range(R)]
        objs = [{k: v[r * M:(r + 1) * M] for k, v in obj.items()}
                for r in range(R)]
        for r in range(R):
            if not fired[r]:
                continue
            if total[r] >= EXACT_F32_LOAD:
                raise NotImplementedError(
                    f"adaptive placement measured {total[r]} events in one "
                    f"rebalance window; the quantile cuts are exact only "
                    f"below 2**24 = {EXACT_F32_LOAD} (the reference's f32 "
                    f"prefix sum rounds above it): fire more often "
                    f"(rebalance_every={cfg.rebalance_every})")
            new_b[r], new_load[r], cals[r], objs[r], recv[r] = self._migrate(
                cfg, placement, comm, b[r], obj_load[r], load[r], cals[r],
                objs[r])
        cal = Calendar(*(torch.cat(x) for x in zip(*cals)))
        obj = {k: torch.cat([o[k] for o in objs]) for k in obj}
        return (torch.stack(new_b), torch.stack(new_load), cal, obj,
                torch.stack(recv), torch.as_tensor(fired, device=device))

    def _migrate(self, cfg, placement, comm, bounds, obj_load, load, cal,
                 obj):
        D, M, O = placement.n_devices, placement.n_local_max, \
            placement.n_objects
        dev = comm.rank
        shift_cap = cfg.migrate_cap // 2
        K = 2 * (cfg.migrate_cap // 2)          # most rows leaving a device
        device = load.device
        new_b = _quantile_boundaries(obj_load, bounds, D, M, O, shift_cap)

        # -- publish the leaving rows (prefix + suffix of my old range) -------
        old_start, old_end = bounds[dev], bounds[dev + 1]
        new_start, new_end = new_b[dev], new_b[dev + 1]
        old_cnt = old_end - old_start
        a = (new_start - old_start).clamp(0).minimum(old_cnt)  # leave front
        c = (old_end - new_end).clamp(0).minimum(old_cnt - a)  # leave back
        k = torch.arange(K, dtype=torch.int32, device=device)
        pub_slot = torch.where(k < a, k, old_cnt - c + (k - a))
        pub_valid = k < a + c
        pub_slot = pub_slot.clamp(0, M - 1)
        pub = {"obj": {n: v[pub_slot.long()] for n, v in obj.items()},
               "cal": take_rows(cal, pub_slot),
               "gid": torch.where(pub_valid, old_start + pub_slot, O)}
        pub_g = comm.all_gather(pub)

        # -- staying rows shift local slots by the boundary delta -------------
        ar_m = torch.arange(M, dtype=torch.int32, device=device)
        src = ((ar_m + (new_start - old_start)) % M).long()
        obj2 = {n: v[src] for n, v in obj.items()}
        cal2 = take_rows(cal, src)
        gid_new = new_start + ar_m
        stay = ((ar_m < new_end - new_start) & (gid_new >= old_start)
                & (gid_new < old_end))

        # -- claim the migrated rows now inside my new range -------------------
        def flat(x):
            return x.reshape((D * K,) + x.shape[2:])
        rgid = flat(pub_g["gid"])
        rown = torch.searchsorted(new_b, rgid.contiguous(),
                                  right=True).to(torch.int32) - 1
        rmine = (rgid < O) & (rown == dev)
        rslot = (rgid - new_start).clamp(0, M - 1)
        safe = torch.where(rmine, rslot, M).long()
        obj3 = {}
        for n, v in obj2.items():
            buf = torch.cat([v, v[:1]])
            buf[safe] = flat(pub_g["obj"][n])
            obj3[n] = buf[:-1]
        cal3 = put_rows(cal2, rslot, Calendar(*(flat(x) for x in
                                                pub_g["cal"])), rmine)
        received = torch.zeros((M + 1,), dtype=torch.bool, device=device)
        received[safe] = True
        cal4 = clear_rows(cal3, ~(stay | received[:M]))
        return (new_b, torch.zeros_like(load), cal4, obj3,
                rmine.sum().to(torch.int64))
