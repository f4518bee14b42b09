"""Router stage implementations (paper §II-B), single device.

Port of ``repro/core/pipeline/routers.py`` at D=1: the ``allgather``
router, whose exchange is the identity and whose selection is first-come up
to ``route_cap``.
Whatever misses the route capacity is counted and handed back to the
caller's fallback buffer.  The collectives across devices and the
``a2a`` router come with the multi-device slice (``EngineConfig`` refuses
both until then).
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


@register_router("allgather")
class AllGatherRouter(Router):
    """Broadcast exchange — every device sees every route buffer."""

    def select_send(self, prod, eligible, placement, cfg):
        return _select_send_global(prod, eligible, cfg)

    def exchange(self, buf, placement, cfg):
        return buf

    def sender_ids(self, placement, cfg, device):
        # one device: every slot of the route buffer is its own.
        return torch.zeros((cfg.route_cap,), dtype=torch.int32,
                           device=device)
