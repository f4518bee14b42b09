"""Work stealing (paper §II-A) as epoch-granular batch loans.

Port of ``repro/core/stealing.py``: the combinatorial loan math, free of
collectives.  Because the lookahead closes an epoch's workload before it
is processed, every device knows its load up front; an overloaded device
publishes its hottest objects (state and current-epoch batch), and a plan
computed identically on every device from the gathered loads assigns each
loan to an underloaded receiver, which processes it and returns the state.
Ownership never moves.  The pipeline stage that wires this around the
scheduler is :class:`repro_torch.core.pipeline.steal.LoanSteal`.

Three places where torch differs from JAX and the port keeps JAX's
integers: ``jax.lax.top_k`` keeps ties in index order and ``torch.topk``
promises no order, so :func:`select_loans` takes the head of a stable
descending sort; ``jnp.searchsorted(side="left")`` is
``torch.searchsorted(right=False)``; and a stable argsort of a bool mask
sorts its int form.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class LoanPlan(NamedTuple):
    # flat over the D * steal_cap published loans
    assignee: torch.Tensor   # i32 receiving device, or D if unassigned
    claimed: torch.Tensor    # bool: assigned and within the claim_cap


def plan_loans(loads: torch.Tensor, loan_weight: torch.Tensor,
               loan_valid: torch.Tensor, claim_cap: int) -> LoanPlan:
    """Deterministic donor → receiver assignment, the same on every device.

    loads:       [D] per-device event load this epoch (gathered)
    loan_weight: [D, steal_cap] event count of each published loan
    loan_valid:  bool [D, steal_cap]
    """
    D = loads.shape[0]
    loads = loads.to(torch.int64)
    total = loads.sum()
    target = (total + D - 1) // D
    deficit = (target - loads).clamp(min=0)               # receiver capacity

    valid = loan_valid.reshape(-1)
    w = torch.where(loan_valid, loan_weight.to(torch.int64), 0).reshape(-1)
    cum_w = torch.cumsum(w, 0)                             # inclusive
    cum_cap = torch.cumsum(deficit, 0)                     # [D]
    # loan j goes to the first receiver whose cumulative capacity covers it.
    assignee = torch.searchsorted(cum_cap, cum_w, right=False).to(torch.int32)
    assignee = torch.where(valid & (assignee < D), assignee, D)

    # rank of each loan among those assigned to the same receiver.
    onehot = (assignee[:, None] == torch.arange(
        D, device=assignee.device)[None, :]).to(torch.int64)
    rank = torch.cumsum(onehot, 0) - onehot
    my_rank = (rank * onehot).sum(1)
    claimed = (assignee < D) & (my_rank < claim_cap)
    return LoanPlan(assignee, claimed)


def select_loans(cnt_b: torch.Tensor, load: torch.Tensor,
                 target: torch.Tensor, steal_cap: int):
    """A donor's loans: its hottest objects, up to ``steal_cap``, only while
    it stays above the target load.  Returns (row index i32, event count
    (0 if invalid), valid)."""
    order = torch.sort(cnt_b, descending=True, stable=True).indices
    top_idx = order[:steal_cap]
    top_cnt = cnt_b[top_idx].to(torch.int64)
    surplus = load.to(torch.int64) - target.to(torch.int64)
    shipped = torch.cumsum(top_cnt, 0) - top_cnt           # exclusive prefix
    valid = (top_cnt > 0) & (surplus > 0) & (shipped < surplus)
    return (top_idx.to(torch.int32), torch.where(valid, top_cnt, 0)
            .to(cnt_b.dtype), valid)


def gather_rows(tree: dict[str, torch.Tensor], idx: torch.Tensor
                ) -> dict[str, Any]:
    idx = idx.long()
    return {k: v[idx] for k, v in tree.items()}


def scatter_rows(tree: dict[str, torch.Tensor], idx: torch.Tensor,
                 rows: dict[str, torch.Tensor], mask: torch.Tensor
                 ) -> dict[str, torch.Tensor]:
    """``tree`` with ``rows`` written at ``idx`` where ``mask`` holds
    (masked-off rows go to a sentinel row that is sliced off)."""
    out = {}
    for k, v in tree.items():
        safe = torch.where(mask, idx.long(), v.shape[0])
        buf = torch.cat([v, v[:1]])
        buf[safe] = rows[k]
        out[k] = buf[:-1]
    return out
