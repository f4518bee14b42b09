"""GQA flash attention (forward): plain PyTorch version and the launch
wrapper of the hand-written CUDA kernel ``csrc/flash_attention.cu``.

Port of the Pallas kernel ``repro/kernels/flash_attention.py``.  Both
versions take q [B, Hq, Tq, D] and k, v [B, Hkv, Tk, D] (all f32 or all
bf16, Hq a multiple of Hkv) and compute, with query head h reading KV head
``h // (Hq // Hkv)``::

    S = q kᵀ / sqrt(D)  (f32);  o = softmax(S) v  in q's dtype

Under ``causal`` row i sees the key columns ``<= i + (Tk - Tq)``: the mask
is aligned bottom-right, as the JAX package's oracle ``ref.attention_ref``
aligns it (its Pallas kernel aligns top-left, ROADMAP C2; the two agree
when Tq == Tk, which is the teacher-forced forward's case).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

#: head dims the kernel is compiled for (the ported configs use 16, 32, 128).
HEAD_DIMS = (16, 32, 64, 128)
#: dynamic shared memory a block may use on Hopper, bytes.
MAX_SMEM = 232448


def attention_ref(q, k, v, *, causal: bool = True):
    """Plain PyTorch version: exact softmax in f32, GQA by a reshape of the
    query heads into [B, Hkv, G, Tq, D] (K and V are not repeated), the
    bottom-right causal mask.  Used on the CPU and as the kernel's
    yardstick."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Tq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) / math.sqrt(D)
    if causal:
        mask = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=q.device).tril(Tk - Tq)
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Tq, D).to(q.dtype)


@functools.cache
def _lib():
    lib = build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"flash_attention: {name} must be a contiguous, 16-byte aligned "
            f"tensor of shape {shape} and dtype {dtype} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous="
            f"{t.is_contiguous()})")


def flash_cuda(q, k, v, *, causal: bool = True):
    """Launch ``csrc/flash_attention.cu`` on torch's current stream.

    Raises if the inputs are not what the kernel takes or if the launch
    fails; there is no fall-back.  Each launch adds one to
    ``flash_cuda.launches``.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_cuda needs CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, T, D]")
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: dtype {q.dtype} is not float32 "
                         f"or bfloat16")
    _check("q", q, q.dtype, (B, Hq, Tq, D), dev)
    _check("k", k, q.dtype, (B, Hkv, Tk, D), dev)
    _check("v", v, q.dtype, (B, Hkv, Tk, D), dev)
    if D not in HEAD_DIMS or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: needs D in {HEAD_DIMS} and Hq a "
                         f"multiple of Hkv (D={D}, Hq={Hq}, Hkv={Hkv})")
    smem = _lib().flash_attention_smem_bytes(D)
    if smem > MAX_SMEM:
        raise ValueError(f"flash_attention: D={D} needs {smem} B of shared "
                         f"memory, above {MAX_SMEM}")
    o = torch.empty_like(q)
    if B * Hq and Tq and Tk:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
            Hkv, Tq, Tk, D, 1.0 / math.sqrt(D), int(causal),
            int(q.dtype == torch.bfloat16), stream)
        if err:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                               f"error {err}")
        flash_cuda.launches += 1
    return o


flash_cuda.launches = 0
