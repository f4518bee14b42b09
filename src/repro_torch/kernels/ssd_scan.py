"""Mamba-2 SSD chunked scan: plain PyTorch version and the launch wrapper of
the hand-written CUDA kernels in ``csrc/ssd_scan.cu``.

Port of the Pallas kernel ``repro/kernels/ssd_scan.py``.  Both versions take
the model's layout and a chunk length ``chunk`` that divides T
(:func:`repro_torch.kernels.ops.ssd` pads T with ``dt = 0``):

    x [b, T, H, P] (f32 or bf16), dt [b, T, H] f32, A [H] f32,
    B, C [b, T, N] f32 (shared by the heads)  →  y [b, T, H, P] in x's dtype

and compute, for every (batch, head) and chunk in order, with the f32 state
``h [N, P]`` carried across chunks::

    l = cumsum(A·dt);  y = ((C Bᵀ) ⊙ e^{l_i − l_j} ⊙ dt_j)_{j≤i} x + (C ⊙ e^l) h
    h ← e^{l_Q} h + (B ⊙ e^{l_Q − l} dt)ᵀ x

Given ``final_state`` (f32 [b, H, N, P]), both also write the h left after
the last step into it.  On the card bf16 x launches the tensor-core kernel
``ssd_wgmma`` and f32 x the CUDA-core kernel ``ssd_f32``; both read x
through its (b, t, h) strides (:func:`x_strides`), so the model's view of a
wider activation goes in uncopied.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: the largest chunk the kernel stages in shared memory.
MAX_CHUNK = 128
#: dynamic shared memory a block may use on Hopper, bytes.
MAX_SMEM = 232448
#: the largest P and N the bf16 tensor-core kernel's register tiles take.
MAX_BF16_STATE = 64


def ssd_ref(x, dt, A, B, C, *, chunk: int, final_state=None):
    """Plain PyTorch version: the chunked form, vectorised over (b, h), one
    loop step per chunk.  Used on the CPU, as the kernel's yardstick, and on
    any device as the port's counterpart of the JAX package's
    ``ref.ssd_ref``: the production SSD of ``attn_impl="jnp"``
    (``ops.ssd_plain``), through which training differentiates.  With
    ``final_state`` (f32 [b, H, N, P]) the carried h is copied into it at
    the end."""
    b, T, H, P = x.shape
    N = B.shape[-1]
    Q = chunk
    if T % Q:
        raise ValueError(f"ssd_ref: T={T} is not a multiple of chunk={Q}")
    xf = x.float().reshape(b, T // Q, Q, H, P)
    dtf = dt.float().reshape(b, T // Q, Q, H)
    Bf = B.float().reshape(b, T // Q, Q, N)
    Cf = C.float().reshape(b, T // Q, Q, N)
    Af = A.float()
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(T // Q):
        xc, dc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        l = torch.cumsum(dc * Af, dim=1)                         # [b, Q, H]
        decay = torch.where(causal[None, :, :, None],
                            torch.exp(l[:, :, None, :] - l[:, None, :, :]),
                            0.0)                                 # [b, i, j, H]
        G = (torch.einsum("bin,bjn->bij", Cc, Bc)[..., None] * decay
             * dc[:, None, :, :])
        y = (torch.einsum("bijh,bjhp->bihp", G, xc)
             + torch.einsum("bin,bhnp->bihp", Cc, h)
             * torch.exp(l)[..., None])
        ys.append(y)
        w = torch.exp(l[:, -1:, :] - l) * dc                     # [b, Q, H]
        h = (torch.exp(l[:, -1, :])[..., None, None] * h
             + torch.einsum("bjn,bjhp->bhnp", Bc, xc * w[..., None]))
    if final_state is not None:
        final_state.copy_(h)
    return torch.stack(ys, dim=1).reshape(b, T, H, P).to(x.dtype)


@functools.cache
def _lib():
    lib = build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p])
    lib.ssd_scan_launch.restype = ctypes.c_int
    for fn in (lib.ssd_scan_smem_bytes, lib.ssd_scan_ctas_per_sm):
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
    return lib


def smem_bytes(chunk: int, P: int, N: int, bf16: bool) -> int:
    """Dynamic shared memory of one CTA at these sizes (-1: the bf16 kernel
    does not take them)."""
    return _lib().ssd_scan_smem_bytes(chunk, P, N, int(bf16))


def ctas_per_sm(chunk: int, P: int, N: int, bf16: bool) -> int:
    """CTAs of the kernel that fit on one SM at these sizes, as the CUDA
    occupancy calculator counts them."""
    return _lib().ssd_scan_ctas_per_sm(chunk, P, N, int(bf16))


def x_strides(x):
    """The (b, t, h) strides, in elements, by which the kernels read the
    4-D x; raises ``ValueError`` naming the fault when they cannot: the last
    dimension must be contiguous, the base 16-byte aligned and every other
    stride a multiple of 16 bytes, so that each row starts on 16 bytes (the
    bf16 kernel moves rows in 16-byte copies).  A dimension of size 1 is
    never stepped, so its stride is not checked."""
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be 4-D, got {tuple(x.shape)}")
    if x.shape[3] > 1 and x.stride(3) != 1:
        raise ValueError(f"ssd_scan: the last dimension of x is not "
                         f"contiguous (strides {x.stride()})")
    if x.data_ptr() % 16:
        raise ValueError("ssd_scan: x's base address is not 16-byte aligned")
    for dim in range(3):
        if x.shape[dim] > 1 and x.stride(dim) * x.element_size() % 16:
            raise ValueError(
                f"ssd_scan: stride {x.stride(dim)} of x's {'bth'[dim]} "
                f"dimension is not a multiple of 16 bytes (strides "
                f"{x.stride()}, {x.element_size()}-byte elements)")
    return tuple(x.stride(dim) for dim in range(3))


def _check(name, t, dtypes, shape, device):
    if t.device != device or t.dtype not in dtypes \
            or tuple(t.shape) != shape or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(
            f"ssd_scan: {name} must be a contiguous, 16-byte aligned tensor "
            f"of shape {shape} and dtype in {dtypes} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous="
            f"{t.is_contiguous()})")


def ssd_cuda(x, dt, A, B, C, *, chunk: int, final_state=None):
    """Launch ``csrc/ssd_scan.cu`` on torch's current stream: bf16 x goes to
    the tensor-core kernel, f32 x to the CUDA-core kernel.

    x is read through its strides (:func:`x_strides`); y is allocated
    contiguous.  ``final_state``, if given, must be a contiguous f32
    [b, H, N, P] tensor and receives the state after the last step.  Raises
    if the inputs are not what the kernel takes or if the launch fails;
    there is no fall-back.  Each launch adds one to ``ssd_cuda.launches``.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_cuda needs CUDA tensors, got {dev}")
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError("ssd_scan: needs x [b, T, H, P] and B, C [b, T, N]")
    b, T, H, P = x.shape
    N = B.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"ssd_scan: x's dtype {x.dtype} is not float32 or "
                         f"bfloat16")
    if not (1 <= chunk <= MAX_CHUNK) or T % chunk or P % 4 or N % 4:
        raise ValueError(
            f"ssd_scan: needs 1 <= chunk <= {MAX_CHUNK}, T % chunk == 0 and "
            f"P, N multiples of 4 (T={T}, chunk={chunk}, P={P}, N={N})")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (P % 8 or P > MAX_BF16_STATE or N > MAX_BF16_STATE):
        raise ValueError(
            f"ssd_scan: the bf16 kernel needs P a multiple of 8 and P, N <= "
            f"{MAX_BF16_STATE} (P={P}, N={N})")
    strides = x_strides(x)
    _check("dt", dt, (torch.float32,), (b, T, H), dev)
    _check("A", A, (torch.float32,), (H,), dev)
    _check("B", B, (torch.float32,), (b, T, N), dev)
    _check("C", C, (torch.float32,), (b, T, N), dev)
    if final_state is not None:
        _check("final_state", final_state, (torch.float32,), (b, H, N, P),
               dev)
    smem = smem_bytes(chunk, P, N, bf16)
    if smem > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk={chunk}, P={P}, N={N} need {smem} "
                         f"B of shared memory, above {MAX_SMEM}")
    y = torch.empty((b, T, H, P), dtype=x.dtype, device=dev)
    if b * H and T:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(),
            None if final_state is None else final_state.data_ptr(), b, T,
            H, P, N, chunk, (ctypes.c_longlong * 3)(*strides), int(bf16),
            stream)
        if err:
            raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                               f"{err}")
        ssd_cuda.launches += 1
    elif final_state is not None:
        final_state.zero_()
    return y


ssd_cuda.launches = 0
