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
    """First-come selection: the first route_cap eligible events are sent."""
    rank = torch.cumsum(eligible.to(torch.int64), dim=0) - 1
    send = eligible & (rank < cfg.route_cap)
    ovf = (eligible & ~send).sum()
    buf = truncate(compact_mask(prod, send), cfg.route_cap)
    return buf, send, ovf


@register_router("allgather")
class AllGatherRouter(Router):
    """Broadcast exchange — every device sees every route buffer."""

    def select_send(self, prod, eligible, placement, cfg):
        return _select_send_global(prod, eligible, cfg)

    def exchange(self, buf, placement, cfg):
        return buf
