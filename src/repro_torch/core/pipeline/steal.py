"""StealPolicy stage implementations (paper §II-A).

Port of ``repro/core/pipeline/steal.py``:

``none`` — stage 2 is a no-op: the scheduler processes exactly the local
           extract (also whenever D == 1).
``loan`` — epoch-granular batch loans: overloaded devices publish their
           hottest objects' state and current-epoch batch; a plan computed
           the same on every device from the gathered loads assigns each
           loan to an underloaded receiver, which processes it beside its
           own rows and returns the state.  Ownership never moves.

The loan math is :mod:`repro_torch.core.stealing`.  Loaned batches are
concatenated onto the local extract as extra rows, which only the rounds
family (``batch`` rounds, ``batch-packed``) ingests; ``EngineConfig``
refuses ``steal=True`` with any other scheduler.  Three ``all_gather``s an
epoch: the loads, the published loans, the returned state.  Under
speculation loans run in every sub-epoch too, only under the global verdict
(``opt_commit='global'``, enforced by the config).
"""
from __future__ import annotations

import torch

from .. import stealing as steal_mod
from .base import StealPolicy, register_steal_policy


@register_steal_policy("none")
class NoSteal(StealPolicy):
    """Process the local extract as it is."""

    def process(self, model, scheduler, cfg, placement, comm, obj, ts_s,
                seed_s, pay_s, cnt_b, reps=1):
        obj, out, lv = scheduler.process(model, cfg, obj, ts_s, seed_s,
                                         pay_s, cnt_b, reps)
        zero = torch.zeros((reps,), dtype=torch.int64, device=cnt_b.device)
        return obj, out, lv, zero, cnt_b.view(reps, -1).sum(1)


@register_steal_policy("loan")
class LoanSteal(StealPolicy):
    """Publish loans, claim, process augmented batches, return state.

    Stacked replications (``reps = R``, the reference's ``vmap`` of the
    stage) lend and borrow each on its own: the loads, the published loans
    and the returned states of all R travel in one ``all_gather`` each,
    every replication plans its own loans, and the scheduler runs once over
    R augmented blocks of ``M + claim_cap`` rows (replication r's own rows,
    then its claims), as each would alone."""

    def process(self, model, scheduler, cfg, placement, comm, obj, ts_s,
                seed_s, pay_s, cnt_b, reps=1):
        R, D, dev, sc = reps, placement.n_devices, comm.rank, cfg.steal_cap
        cc = cfg.claim_cap
        M = cnt_b.shape[0] // R
        device = cnt_b.device
        start = placement.start(dev, device)   # 0-d, or [R, 1] per replication
        cnt = cnt_b.view(R, M)
        row0 = M * torch.arange(R, device=device)[:, None]

        load = cnt.sum(1)                                           # [R]
        loads = comm.all_gather(load)                               # [D, R]
        target = (loads.sum(0) + D - 1) // D
        picks = [steal_mod.select_loans(cnt[r], load[r], target[r], sc)
                 for r in range(R)]
        top_idx, top_w, loan_valid = (torch.stack(x) for x in zip(*picks))
        rows = top_idx.long() + row0                                # [R, sc]

        def per_rep(x):                   # [R * sc, ...] -> [R, sc, ...]
            return x.view(R, sc, *x.shape[1:])
        flat_rows = rows.reshape(-1)
        pub = {"state": {k: per_rep(v) for k, v in steal_mod.gather_rows(
                   obj, flat_rows).items()},
               "ts": per_rep(ts_s[flat_rows]),
               "seed": per_rep(seed_s[flat_rows]),
               "pay": per_rep(pay_s[flat_rows]),
               "cnt": top_w, "gid": top_idx + start,
               "valid": loan_valid}
        pub_g = comm.all_gather(pub)                 # leaves [D, R, sc, ...]

        cnt_b = cnt_b.clone()
        corder, cvalid = [], []
        for r in range(R):
            plan = steal_mod.plan_loans(loads[:, r], pub_g["cnt"][:, r],
                                        pub_g["valid"][:, r], cc)
            # donor side: claimed loans are processed remotely, zero them.
            own = plan.claimed.view(D, sc)[dev] & loan_valid[r]
            cnt_b[rows[r]] = torch.where(own, 0, cnt_b[rows[r]])
            # receiver side: my claims compacted into claim_cap rows.
            mask = plan.claimed & (plan.assignee == dev)            # [D*sc]
            order = torch.sort((~mask).to(torch.int8),
                               stable=True).indices[:cc]
            corder.append(order)
            cvalid.append(mask[order])
        corder, cvalid = torch.stack(corder), torch.stack(cvalid)   # [R, cc]
        rep = torch.arange(R, device=device)[:, None]

        def claimed(x):                   # [D, R, sc, ...] -> [R, cc, ...]
            x = x.movedim(0, 1).reshape(R, D * sc, *x.shape[3:])
            return x[rep, corder]

        cl_state = {k: claimed(v) for k, v in pub_g["state"].items()}
        cl_cnt = torch.where(cvalid, claimed(pub_g["cnt"]), 0)
        cl_gid = claimed(pub_g["gid"])

        def aug(mine, theirs):            # R blocks of M + cc rows
            return torch.cat([mine.view(R, M, *mine.shape[1:]), theirs],
                             1).flatten(0, 1)
        obj_aug = {k: aug(v, cl_state[k]) for k, v in obj.items()}
        obj_aug, out, lv = scheduler.process(
            model, cfg, obj_aug, aug(ts_s, claimed(pub_g["ts"])),
            aug(seed_s, claimed(pub_g["seed"])),
            aug(pay_s, claimed(pub_g["pay"])), aug(cnt_b, cl_cnt), R)
        blocks = {k: v.view(R, M + cc, *v.shape[1:])
                  for k, v in obj_aug.items()}
        obj = {k: v[:, :M].flatten(0, 1) for k, v in blocks.items()}
        ret = {"state": {k: v[:, M:] for k, v in blocks.items()},
               "gid": cl_gid, "valid": cvalid}
        ret_g = comm.all_gather(ret)                 # leaves [D, R, cc, ...]

        def returned(x):                  # [D, R, cc, ...] -> [R, D * cc, ...]
            return x.movedim(0, 1).reshape(R, D * cc, *x.shape[3:])
        rgid = returned(ret_g["gid"])
        rmine = returned(ret_g["valid"]) & (placement.owner(rgid) == dev)
        lidx = (rgid - start).clamp(0, M - 1) + row0
        rstate = {k: returned(v).flatten(0, 1)
                  for k, v in ret_g["state"].items()}
        obj = steal_mod.scatter_rows(obj, lidx.reshape(-1), rstate,
                                     rmine.reshape(-1))

        stolen = cvalid.sum(1)
        proc = cnt_b.view(R, M).sum(1) + cl_cnt.sum(1)
        return obj, out, lv, stolen, proc
