"""Mamba-2 SSD chunked scan: plain PyTorch version and the launch wrapper of
the hand-written CUDA kernel ``csrc/ssd_scan.cu``.

Port of the Pallas kernel ``repro/kernels/ssd_scan.py``.  Both versions take
the model's layout and a chunk length ``chunk`` that divides T
(:func:`repro_torch.kernels.ops.ssd` pads T with ``dt = 0``):

    x [b, T, H, P] (f32 or bf16), dt [b, T, H] f32, A [H] f32,
    B, C [b, T, N] f32 (shared by the heads)  →  y [b, T, H, P] in x's dtype

and compute, for every (batch, head) and chunk in order, with the f32 state
``h [N, P]`` carried across chunks::

    l = cumsum(A·dt);  y = ((C Bᵀ) ⊙ e^{l_i − l_j} ⊙ dt_j)_{j≤i} x + (C ⊙ e^l) h
    h ← e^{l_Q} h + (B ⊙ e^{l_Q − l} dt)ᵀ x
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


def ssd_ref(x, dt, A, B, C, *, chunk: int):
    """Plain PyTorch version: the chunked form, vectorised over (b, h), one
    loop step per chunk.  Used on the CPU and as the kernel's yardstick."""
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
    return torch.stack(ys, dim=1).reshape(b, T, H, P).to(x.dtype)


@functools.cache
def _lib():
    lib = build.load("ssd_scan")
    lib.ssd_scan_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                    + [ctypes.c_void_p])
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_scan_smem_bytes.restype = ctypes.c_int
    return lib


def _check(name, t, dtypes, shape, device):
    if t.device != device or t.dtype not in dtypes \
            or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"ssd_scan: {name} must be a contiguous tensor of shape {shape} "
            f"and dtype in {dtypes} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def ssd_cuda(x, dt, A, B, C, *, chunk: int):
    """Launch ``csrc/ssd_scan.cu`` on torch's current stream.

    Raises if the inputs are not what the kernel takes or if the launch
    fails; there is no fall-back.  Each launch adds one to
    ``ssd_cuda.launches``.
    """
    b, T, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_cuda needs CUDA tensors, got {dev}")
    _check("x", x, (torch.float32, torch.bfloat16), (b, T, H, P), dev)
    _check("dt", dt, (torch.float32,), (b, T, H), dev)
    _check("A", A, (torch.float32,), (H,), dev)
    _check("B", B, (torch.float32,), (b, T, N), dev)
    _check("C", C, (torch.float32,), (b, T, N), dev)
    if not (1 <= chunk <= MAX_CHUNK) or T % chunk or P % 4 or N % 4:
        raise ValueError(
            f"ssd_scan: needs 1 <= chunk <= {MAX_CHUNK}, T % chunk == 0 and "
            f"P, N multiples of 4 (T={T}, chunk={chunk}, P={P}, N={N})")
    smem = _lib().ssd_scan_smem_bytes(chunk, P, N)
    if smem > MAX_SMEM:
        raise ValueError(f"ssd_scan: chunk={chunk}, P={P}, N={N} need {smem} "
                         f"B of shared memory, above {MAX_SMEM}")
    y = torch.empty_like(x)
    if b * H and T:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), b, T, H, P, N, chunk,
            int(x.dtype == torch.bfloat16), stream)
        if err:
            raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                               f"{err}")
        ssd_cuda.launches += 1
    return y


ssd_cuda.launches = 0
