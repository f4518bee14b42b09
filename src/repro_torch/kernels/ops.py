"""Public faces of the port's kernels.

A tensor on the CPU goes to the kernel's plain PyTorch version; a tensor on
a CUDA device goes to the hand-written kernel, which launches or raises.

No kernel has a backward (nor has any of the JAX package's Pallas kernels:
``jax.grad`` through its ``ops.mha`` fails), so :func:`mha` and :func:`ssd`
refuse to run when autograd would differentiate them, on the CPU as on the
card: a loss taken through them would otherwise hand every parameter
upstream a zero gradient.  Training runs under ``attn_impl="jnp"``, whose
plain attention and :func:`ssd_plain` differentiate.

Under a FLOP counter (``roofline.analysis.FlopCounter``) :func:`mha` and
:func:`ssd` count as the work of their plain versions for the same call,
on every device (``counting.counted_as``); without one nothing changes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .counting import counted_as
from .event_apply import event_apply_cuda, event_apply_ref
from .flash_attention import attention_ref, flash_cuda
from .ssd_scan import ssd_cuda, ssd_ref

#: every kernel wrapper, each with its ``launches`` counter: a caller that
#: captures launches into a CUDA graph adds them back once per replay.
KERNELS = (event_apply_cuda, flash_cuda, ssd_cuda)

#: the key block of the JAX package's ``ops.mha``; its non-causal rule
#: (Tk a multiple of the block) is kept, though the kernel masks the edge.
KEY_BLOCK = 128


def _refuse_grad(name, *inputs):
    """Raise when grad mode is on and an input requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            f"{name}: the kernel has no backward, so a gradient cannot pass "
            f"through it; train under attn_impl=\"jnp\" (attn_impl="
            f"\"pallas\" is a serving and evaluation setting)")


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


def mha(q, k, v, *, causal: bool = True):
    """GQA attention.  q: [B,Hq,Tq,D]; k, v: [B,Hkv,Tk,D] → [B,Hq,Tq,D] in
    q's dtype; the causal mask is aligned bottom-right (see
    :mod:`repro_torch.kernels.flash_attention`).

    Takes what the JAX package's ``ops.mha`` takes: non-causal attention
    needs Tk to be a multiple of the key block ``min(128, max(8, Tk))``.
    Nothing is padded: the kernel masks the ragged edges itself.  Nothing is
    copied either: the kernel reads q, k and v through their strides, so a
    [B, H, T, D] view of the model's [B, T, H, D] activations goes in as it
    is, and on the card the output has q's layout.

    Raises ``NotImplementedError`` when autograd would differentiate it
    (see the module's docstring)."""
    _refuse_grad("mha (flash_attention)", q, k, v)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"mha: needs q [B,Hq,Tq,D] and k, v [B,Hkv,Tk,D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"mha: Hq={q.shape[1]} is not a multiple of "
                         f"Hkv={k.shape[1]}")
    Tk = k.shape[2]
    if Tk % min(KEY_BLOCK, max(8, Tk)) and not causal:
        raise ValueError("non-causal attention requires Tk % bk == 0")
    fn = _route("mha", q, flash_cuda, attention_ref)
    with counted_as(attention_ref, q, k, v, causal=causal):
        return fn(q, k, v, causal=causal)


def ssd_pad(x, dt, B, C, *, chunk: int):
    """The inputs of :func:`ssd` under its chunk rule: ``(x, dt, B, C, ch)``
    padded with ``dt = 0`` steps (an identity update) to a multiple of the
    chunk length ``ch``; dt, B and C contiguous.

    The rule is the JAX package's: a T that ``min(chunk, T)`` divides runs
    chunks of that length (T < chunk: one chunk of T); any other T is padded
    to a multiple of ``chunk``.  x is copied only when T is padded: the
    kernels read it through its strides, so a view of a wider activation
    goes in as it is."""
    T = x.shape[1]
    ch = min(chunk, T) if T % min(chunk, T) == 0 else chunk
    pad = (-T) % ch
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    return x, dt.contiguous(), B.contiguous(), C.contiguous(), ch


def ssd(x, dt, A, B, C, *, chunk: int = 128, final_state=None):
    """Mamba-2 SSD.  x: [b,T,H,P]; dt: [b,T,H]; A: [H]; B,C: [b,T,N] →
    y [b,T,H,P] like x.  T is padded and the output sliced back
    (:func:`ssd_pad`).  ``final_state`` (f32 [b,H,N,P]), if given, receives
    the SSM state after step T (the padded steps leave it unchanged).

    Raises ``NotImplementedError`` when autograd would differentiate it
    (see the module's docstring)."""
    _refuse_grad("ssd (ssd_scan)", x, dt, A, B, C)
    fn = _route("ssd", x, ssd_cuda, ssd_ref)
    with counted_as(ssd_plain, x, dt, A, B, C, chunk=chunk,
                    final_state=final_state):
        x_, dt_, B_, C_, ch = ssd_pad(x, dt, B, C, chunk=chunk)
        return fn(x_, dt_, A.contiguous(), B_, C_, chunk=ch,
                  final_state=final_state)[:, :x.shape[1]]


def ssd_plain(x, dt, A, B, C, *, chunk: int = 128, final_state=None):
    """The plain Mamba-2 SSD on any device, under :func:`ssd`'s chunk rule:
    what ``mamba_apply`` runs under ``attn_impl="jnp"``, the counterpart of
    the JAX package's ``ref.ssd_ref``, which its ``mamba_apply`` runs under
    that setting.  It is that setting's production function, not a
    fall-back: it runs on a CUDA tensor as on the CPU, and differentiates.
    Same arguments and result as :func:`ssd`."""
    x_, dt_, B_, C_, ch = ssd_pad(x, dt, B, C, chunk=chunk)
    return ssd_ref(x_, dt_, A, B_, C_, chunk=ch,
                   final_state=final_state)[:, :x.shape[1]]
