"""Public faces of the port's kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor on
a CUDA device goes to the hand-written kernel, which launches or raises.
"""
from __future__ import annotations

from .event_apply import event_apply_cuda, event_apply_ref


def event_apply(payload, addresses, top, ts, seed, cnt, *, n_objects: int,
                lookahead: float, K: int, KR: int, dist: str = "dyadic",
                mean: float = 1.0, hot_objects: int = 0, hot_prob: int = 0):
    """Batched per-object event application.  payload: [n, S, LANES],
    updated in place together with ``addresses`` (see
    :mod:`repro_torch.kernels.event_apply`)."""
    kw = dict(n_objects=n_objects, lookahead=lookahead, K=K, KR=KR,
              dist=dist, mean=mean, hot_objects=hot_objects,
              hot_prob=hot_prob)
    if payload.device.type == "cuda":
        return event_apply_cuda(payload, addresses, top, ts, seed, cnt, **kw)
    if payload.device.type == "cpu":
        return event_apply_ref(payload, addresses, top, ts, seed, cnt, **kw)
    raise ValueError(f"event_apply: unsupported device {payload.device}")
