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

#: head dims the kernel is compiled for: every ported config's (16, 32 at
#: the reduced sizes; 64, 128, and stablelm-12b's 160 at full width).
HEAD_DIMS = (16, 32, 64, 128, 160)
#: dynamic shared memory a block may use on Hopper, bytes.
MAX_SMEM = 232448


def check_heads(D: int, Hq: int, Hkv: int) -> None:
    """Refuse the head shapes the kernel does not take: ``ValueError``
    where the JAX package's ``ops.mha`` refuses them too (Hq not a multiple
    of Hkv), ``NotImplementedError`` for a head dim the kernel is not
    compiled for, which the JAX kernel takes (no config of either package
    has one; ``csrc/flash_attention.cu``'s dispatch lists the compiled
    ones)."""
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: needs Hq a multiple of Hkv "
                         f"(Hq={Hq}, Hkv={Hkv})")
    if D not in HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention: head dim D={D} is not one the kernel is "
            f"compiled for (D in {HEAD_DIMS}); another needs its own "
            f"instantiation in csrc/flash_attention.cu")


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
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


def kernel_strides(name, t):
    """The (B, H, T) strides, in elements, by which the kernels read or
    write the 4-D tensor ``t``; raises ``ValueError`` naming the fault when
    they cannot: the last dimension must be contiguous, the base 16-byte
    aligned and every other stride a multiple of 16 bytes, so that each row
    starts on 16 bytes (the kernels move rows in 16-byte copies).  A
    dimension of size 1 is never stepped, so its stride is not checked."""
    if t.dim() != 4:
        raise ValueError(f"flash_attention: {name} must be 4-D, got "
                         f"{tuple(t.shape)}")
    if t.stride(3) != 1:
        raise ValueError(f"flash_attention: the last dimension of {name} is "
                         f"not contiguous (strides {t.stride()})")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name}'s base address is not "
                         f"16-byte aligned")
    for dim in range(3):
        if t.shape[dim] > 1 and t.stride(dim) * t.element_size() % 16:
            raise ValueError(
                f"flash_attention: stride {t.stride(dim)} of {name}'s "
                f"{'BHT'[dim]} dimension is not a multiple of 16 bytes "
                f"(strides {t.stride()}, {t.element_size()}-byte elements)")
    return tuple(t.stride(dim) for dim in range(3))


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"flash_attention: {name} must be a tensor of shape {shape} and "
            f"dtype {dtype} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}")
    return kernel_strides(name, t)


def flash_cuda(q, k, v, *, causal: bool = True):
    """Launch ``csrc/flash_attention.cu`` on torch's current stream: bf16
    inputs go to the tensor-core kernel, f32 ones to the CUDA-core kernel.

    q, k and v are read through their strides (:func:`kernel_strides`), so a
    [B, H, T, D] view of a [B, T, H, D] tensor needs no copy; o is allocated
    like q and so keeps q's layout.  Raises if the inputs are not what the
    kernel takes or if the launch fails; there is no fall-back.  Each launch
    adds one to ``flash_cuda.launches``.
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
    strides = [*_check("q", q, q.dtype, (B, Hq, Tq, D), dev),
               *_check("k", k, q.dtype, (B, Hkv, Tk, D), dev),
               *_check("v", v, q.dtype, (B, Hkv, Tk, D), dev)]
    check_heads(D, Hq, Hkv)
    bf16 = int(q.dtype == torch.bfloat16)
    smem = _lib().flash_attention_smem_bytes(D, bf16)
    if smem > MAX_SMEM:
        raise ValueError(f"flash_attention: D={D} needs {smem} B of shared "
                         f"memory, above {MAX_SMEM}")
    o = torch.empty_like(q)
    strides += kernel_strides("o", o)
    if B * Hq and Tq and Tk:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Hq,
            Hkv, Tq, Tk, D, (ctypes.c_longlong * 12)(*strides),
            1.0 / math.sqrt(D), int(causal), bf16, stream)
        if err:
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                               f"error {err}")
        flash_cuda.launches += 1
    return o


flash_cuda.launches = 0
