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
    """Publish loans, claim, process augmented batches, return state."""

    def process(self, model, scheduler, cfg, placement, comm, obj, ts_s,
                seed_s, pay_s, cnt_b, reps=1):
        if reps != 1:
            raise ValueError("loans run on one simulation per device")
        D, dev, sc = placement.n_devices, comm.rank, cfg.steal_cap
        boundaries = torch.as_tensor(placement.boundaries,
                                     device=cnt_b.device).to(torch.int32)

        load = cnt_b.sum()
        loads = comm.all_gather(load)                               # [D]
        target = (loads.sum() + D - 1) // D

        top_idx, top_w, loan_valid = steal_mod.select_loans(
            cnt_b, load, target, sc)
        rows = top_idx.long()
        pub = {"state": steal_mod.gather_rows(obj, top_idx),
               "ts": ts_s[rows], "seed": seed_s[rows], "pay": pay_s[rows],
               "cnt": top_w, "gid": top_idx + boundaries[dev],
               "valid": loan_valid}
        pub_g = comm.all_gather(pub)

        plan = steal_mod.plan_loans(loads, pub_g["cnt"], pub_g["valid"],
                                    cfg.claim_cap)

        # donor side: claimed loans are processed remotely, zero them here.
        own_claimed = plan.claimed.view(D, sc)[dev]
        cnt_b = cnt_b.clone()
        cnt_b[rows] = torch.where(own_claimed & loan_valid, 0, cnt_b[rows])

        # receiver side: my claims compacted into claim_cap rows.
        claim_mask = plan.claimed & (plan.assignee == dev)          # [D*sc]
        corder = torch.sort((~claim_mask).to(torch.int8),
                            stable=True).indices[:cfg.claim_cap]
        cvalid = claim_mask[corder]

        def flat(x):
            return x.reshape((D * sc,) + x.shape[2:])[corder]

        cl_state = {k: flat(v) for k, v in pub_g["state"].items()}
        cl_cnt = torch.where(cvalid, flat(pub_g["cnt"]), 0)
        cl_gid = flat(pub_g["gid"])

        n_local = cnt_b.shape[0]
        obj_aug = {k: torch.cat([v, cl_state[k]]) for k, v in obj.items()}
        obj_aug, out, lv = scheduler.process(
            model, cfg, obj_aug, torch.cat([ts_s, flat(pub_g["ts"])]),
            torch.cat([seed_s, flat(pub_g["seed"])]),
            torch.cat([pay_s, flat(pub_g["pay"])]),
            torch.cat([cnt_b, cl_cnt]), 1)
        obj = {k: v[:n_local] for k, v in obj_aug.items()}
        ret = {"state": {k: v[n_local:] for k, v in obj_aug.items()},
               "gid": cl_gid, "valid": cvalid}
        ret_g = comm.all_gather(ret)
        rgid = ret_g["gid"].reshape(-1)
        rmine = ret_g["valid"].reshape(-1) & (placement.owner(rgid) == dev)
        lidx = (rgid - boundaries[dev]).clamp(0, n_local - 1)
        rstate = {k: v.reshape((-1,) + v.shape[2:])
                  for k, v in ret_g["state"].items()}
        obj = steal_mod.scatter_rows(obj, lidx, rstate, rmine)

        stolen = cvalid.sum().view(1)
        proc = (cnt_b.sum() + cl_cnt.sum()).view(1)
        return obj, out, lv, stolen, proc
