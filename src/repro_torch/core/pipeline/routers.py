"""Router stage implementations (paper §II-B).

Port of ``repro/core/pipeline/routers.py``:

``allgather`` — every device broadcasts its route buffer to everyone and
                each owner filters at delivery;
``a2a``       — the pairwise exchange: per-destination-device sub-buffers
                of ``route_cap // D`` events through ``all_to_all``, D×
                less traffic than the broadcast.

Both are the identity on one device, where a2a also falls back to the
first-come selection.  What misses the route capacity is counted and handed
back to the caller's fallback.  Route buffers are ``[R, E]`` (R stacked
replications; R = 1 across devices); an exchange moves the batch in one
tree collective of the device axis (:class:`~repro_torch.core.dist.Comm`).
Where the reference drops a scatter entry (``mode="drop"``), the port
scatters it into a sentinel slot that is sliced off.
"""
from __future__ import annotations

import torch

from ..events import EventBatch, compact_mask, truncate
from .base import Router, register_router


def _select_send_global(prod: EventBatch, eligible: torch.Tensor, cfg):
    """First-come selection: the first route_cap eligible events are sent.
    Per replication along the last dim of a stacked [R, E] batch."""
    e = eligible.to(torch.int64)
    # one scan over every row at once (a scan along the rows of a stack
    # runs one thread block per row on the card), less each row's start.
    cs = torch.cumsum(e.reshape(-1), 0).view(e.shape)
    rank = cs - (cs[..., -1:] - e.sum(-1, keepdim=True)) - 1
    send = eligible & (rank < cfg.route_cap)
    ovf = (eligible & ~send).sum(-1)
    buf = truncate(compact_mask(prod, send), cfg.route_cap)
    return buf, send, ovf


def _sender_major(got: EventBatch) -> EventBatch:
    """Events [D, R, k] from D senders → [R, D * k], sender-major."""
    D, R, k = got.dst.shape
    return EventBatch(*(x.movedim(0, 1).reshape(R, D * k) for x in got))


@register_router("allgather")
class AllGatherRouter(Router):
    """Broadcast exchange — every device sees every route buffer."""

    replicated = True   # exchange() output is identical on every device

    def select_send(self, prod, eligible, placement, cfg):
        return _select_send_global(prod, eligible, cfg)

    def exchange(self, buf, placement, cfg, comm):
        if comm.size == 1:
            return buf
        return _sender_major(comm.all_gather(buf))

    def sender_ids(self, placement, cfg, device):
        # broadcast layout: D stacked route buffers, route_cap slots each.
        return torch.arange(placement.n_devices, dtype=torch.int32,
                            device=device).repeat_interleave(cfg.route_cap)


@register_router("a2a")
class AllToAllRouter(Router):
    """Pairwise exchange with per-destination-device sub-buffers."""

    replicated = False  # each device receives a distinct routed slice

    def validate(self, cfg, placement):
        cfg.validate(placement.n_devices)

    def select_send(self, prod, eligible, placement, cfg):
        D = placement.n_devices
        if D == 1:
            return _select_send_global(prod, eligible, cfg)
        pair_cap = cfg.route_cap // D
        owner = placement.owner(prod.dst)
        key = torch.where(eligible, owner.to(torch.int64), D)
        ks, order = torch.sort(key, dim=-1, stable=True)
        idx = torch.arange(ks.shape[-1], dtype=torch.int64,
                           device=ks.device).expand_as(ks)
        # rank inside each owner group: distance to the group's first slot.
        rank = idx - torch.searchsorted(ks, ks)
        ok = (ks < D) & (rank < pair_cap)
        ovf = ((ks < D) & ~ok).sum(-1)
        n = D * pair_cap
        slot = torch.where(ok, ks * pair_cap + rank, n)

        def put(field, fill):
            src = torch.gather(field, -1, order)
            out = torch.full(field.shape[:-1] + (n + 1,), fill,
                             dtype=field.dtype, device=field.device)
            out.scatter_(-1, slot, src)
            return out[..., :n]

        valid = torch.zeros(ok.shape[:-1] + (n + 1,), dtype=torch.bool,
                            device=ok.device).scatter_(-1, slot, ok)[..., :n]
        buf = EventBatch(dst=put(prod.dst, 0), ts=put(prod.ts, float("inf")),
                         seed=put(prod.seed, 0), payload=put(prod.payload, 0.0),
                         valid=valid)
        # the sent mask back in the events' own order.
        send = torch.zeros_like(eligible).scatter_(-1, order, ok)
        return buf, send, ovf

    def exchange(self, buf, placement, cfg, comm):
        D = comm.size
        if D == 1:
            return buf
        pair_cap = cfg.route_cap // D
        R = buf.dst.shape[0]
        per_dst = EventBatch(*(x.reshape(R, D, pair_cap).movedim(1, 0)
                               for x in buf))                # [D, R, pc]
        return _sender_major(comm.all_to_all(per_dst))

    def sender_ids(self, placement, cfg, device):
        # after all_to_all, sub-buffer s of the result came from device s.
        D = placement.n_devices
        return torch.arange(D, dtype=torch.int32, device=device) \
            .repeat_interleave(cfg.route_cap // D)
