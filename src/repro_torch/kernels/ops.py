"""Public faces of the port's kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor on
a CUDA device goes to the hand-written kernel, which launches or raises.
"""
from __future__ import annotations

import torch.nn.functional as F

from .event_apply import event_apply_cuda, event_apply_ref
from .ssd_scan import ssd_cuda, ssd_ref


def _route(name, t, cuda_fn, cpu_fn):
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return cpu_fn
    raise ValueError(f"{name}: unsupported device {t.device}")


def event_apply(payload, addresses, top, ts, seed, cnt, *, n_objects: int,
                lookahead: float, K: int, KR: int, dist: str = "dyadic",
                mean: float = 1.0, hot_objects: int = 0, hot_prob: int = 0):
    """Batched per-object event application.  payload: [n, S, LANES],
    updated in place together with ``addresses`` (see
    :mod:`repro_torch.kernels.event_apply`)."""
    fn = _route("event_apply", payload, event_apply_cuda, event_apply_ref)
    return fn(payload, addresses, top, ts, seed, cnt, n_objects=n_objects,
              lookahead=lookahead, K=K, KR=KR, dist=dist, mean=mean,
              hot_objects=hot_objects, hot_prob=hot_prob)


def ssd_pad(x, dt, B, C, *, chunk: int):
    """The inputs of :func:`ssd` under its chunk rule: ``(x, dt, B, C, ch)``
    padded with ``dt = 0`` steps (an identity update) to a multiple of the
    chunk length ``ch``, contiguous.

    The rule is the JAX package's: a T that ``min(chunk, T)`` divides runs
    chunks of that length (T < chunk: one chunk of T); any other T is padded
    to a multiple of ``chunk``."""
    T = x.shape[1]
    ch = min(chunk, T) if T % min(chunk, T) == 0 else chunk
    pad = (-T) % ch
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    return x.contiguous(), dt.contiguous(), B.contiguous(), C.contiguous(), ch


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    """Mamba-2 SSD.  x: [b,T,H,P]; dt: [b,T,H]; A: [H]; B,C: [b,T,N] →
    y like x.  T is padded and the output sliced back (:func:`ssd_pad`)."""
    fn = _route("ssd", x, ssd_cuda, ssd_ref)
    x_, dt_, B_, C_, ch = ssd_pad(x, dt, B, C, chunk=chunk)
    return fn(x_, dt_, A.contiguous(), B_, C_, chunk=ch)[:, :x.shape[1]]
