"""Per-object batched event application (PHOLD hot loop): plain PyTorch
version and the launch wrapper of the hand-written CUDA kernel.

Port of the Pallas kernel ``repro/kernels/event_apply.py`` and its oracle
``repro/kernels/ref.py:event_apply_ref``.  Layout differs from the JAX
package: the port keeps the model's ``payload [n, S, LANES]`` (node-major),
so a run of nodes is one contiguous run of floats and no transpose surrounds
the call.

Both versions update ``payload`` and ``addresses`` **in place** (``top`` is
unchanged: every event frees KR nodes and allocates them back) and return
them together with freshly allocated emission buffers, each ``[n, C]``:
``dst`` i32, ``ts`` f32 (+inf in unused slots), ``seed`` u32-in-i64,
``payload`` f32, ``valid`` i32.

The plain version applies the events round by round, as the reference
does.  The kernel (``csrc/event_apply.cu``) needs no order between events:
an event's window, touch increment, init value and emission follow from its
seed alone, so it first computes every event's parameters in parallel, then
reads each node that some event's window or init range covers once, applies
to it in order the events that cover it (``x * 0.5 + delta``, then the init
value) and writes it once; the arena slots, the same for every event since
``top`` does not move, keep the last event's values.  Each node sees the
same f32 operations in the same order as in the plain version, so the two
agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.events import M32, draw, dyadic10, fold, to_f32
from . import build

#: draw-distribution codes shared with csrc/event_apply.cu.
DISTS = {"dyadic": 0, "uniform24": 1, "exponential": 2}
#: shared memory a block can use on Hopper (bytes).
MAX_SMEM = 232448


def _outputs(n: int, C: int, device):
    return (torch.zeros((n, C), dtype=torch.int32, device=device),
            torch.full((n, C), float("inf"), dtype=torch.float32,
                       device=device),
            torch.zeros((n, C), dtype=torch.int64, device=device),
            torch.zeros((n, C), dtype=torch.float32, device=device),
            torch.zeros((n, C), dtype=torch.int32, device=device))


def event_apply_ref(payload, addresses, top, ts, seed, cnt, *,
                    n_objects: int, lookahead: float, K: int, KR: int,
                    dist: str = "dyadic", mean: float = 1.0,
                    hot_objects: int = 0, hot_prob: int = 0):
    """Plain PyTorch version: round ``r`` applies the r-th event of every
    object with ``cnt > r``, one vectorized step per round."""
    if dist not in DISTS:
        raise ValueError(dist)
    n, S, LANES = payload.shape
    C = ts.shape[1]
    dev = payload.device
    odst, ots, oseed, opay, ovalid = _outputs(n, C, dev)
    n_rounds = int(cnt.clamp(0, C).max()) if n else 0
    kk = torch.arange(K, device=dev)
    kr = torch.arange(KR, device=dev)
    for r in range(n_rounds):
        rows = torch.nonzero(cnt > r).squeeze(1)
        rr = rows[:, None]
        t = ts[rows, r]
        s = seed[rows, r] & M32
        start = fold(s, 0) % (S - K + 1)
        win = start[:, None] + kk
        payload[rr, win] = (payload[rr, win] * 0.5
                            + dyadic10(fold(s, 5))[:, None, None])
        at = (top[rows].to(torch.int64) - KR).clamp(0, S - KR)
        addresses[rr, at[:, None] + kr] = (start[:, None] + (KR - 1)
                                           - kr).to(torch.int32)
        init = start.clamp(max=S - KR)[:, None] + kr
        payload[rr, init] = dyadic10(fold(s, 6))[:, None, None]
        dst = fold(s, 1) % n_objects
        if hot_objects and hot_prob:
            hot = (fold(s, 8) & 255) < hot_prob
            dst = torch.where(hot, fold(s, 9) % hot_objects, dst)
        odst[rows, r] = dst.to(torch.int32)
        ots[rows, r] = t + to_f32(lookahead) + draw(fold(s, 2), dist, mean)
        oseed[rows, r] = fold(s, 3)
        opay[rows, r] = dyadic10(fold(s, 4))
        ovalid[rows, r] = 1
    return payload, addresses, top, odst, ots, oseed, opay, ovalid


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of ``event_apply_launch`` in a built library."""
    fn = lib.event_apply_launch
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib():
    lib = bind(build.load("event_apply"))
    for fn in (lib.event_apply_smem_bytes, lib.event_apply_ctas_per_sm):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


def _launcher():
    """The launch entry point ``event_apply_cuda`` calls."""
    return _lib().event_apply_launch


def smem_bytes(S: int, C: int) -> int:
    """Dynamic shared memory of one kernel CTA with ``C`` event slots over
    ``S`` nodes: 16 B of parameters per slot and a coverage bit per node."""
    return _lib().event_apply_smem_bytes(S, C)


def ctas_per_sm(S: int, C: int) -> int:
    """CTAs of the kernel that fit on one SM with ``C`` event slots over
    ``S`` nodes, as the CUDA occupancy calculator counts them."""
    return _lib().event_apply_ctas_per_sm(S, C)


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"event_apply: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def event_apply_cuda(payload, addresses, top, ts, seed, cnt, *,
                     n_objects: int, lookahead: float, K: int, KR: int,
                     dist: str = "dyadic", mean: float = 1.0,
                     hot_objects: int = 0, hot_prob: int = 0):
    """Launch ``csrc/event_apply.cu`` on torch's current stream.

    Raises if the inputs are not what the kernel takes or if the launch
    fails; there is no fall-back.  Each launch adds one to
    ``event_apply_cuda.launches``.
    """
    if dist not in DISTS:
        raise ValueError(dist)
    n, S, LANES = payload.shape
    C = ts.shape[1]
    dev = payload.device
    if dev.type != "cuda":
        raise ValueError(f"event_apply_cuda needs CUDA tensors, got {dev}")
    _check("payload", payload, torch.float32, (n, S, LANES), dev)
    _check("addresses", addresses, torch.int32, (n, S), dev)
    _check("top", top, torch.int32, (n,), dev)
    _check("ts", ts, torch.float32, (n, C), dev)
    _check("seed", seed, torch.int64, (n, C), dev)
    _check("cnt", cnt, torch.int32, (n,), dev)
    if not (1 <= K <= S and 1 <= KR <= S and n_objects >= 1):
        raise ValueError(f"event_apply: need 1 <= K, KR <= S={S} and "
                         f"n_objects >= 1 (K={K}, KR={KR}, "
                         f"n_objects={n_objects})")
    if hot_objects and hot_prob and hot_objects < 1:
        raise ValueError(f"hot_objects must be >= 1, got {hot_objects}")
    if smem_bytes(S, C) > MAX_SMEM:
        raise ValueError(f"event_apply: C={C} event slots over S={S} nodes "
                         f"need {smem_bytes(S, C)} B of shared memory, above "
                         f"{MAX_SMEM}")
    outs = tuple(torch.empty((n, C), dtype=d, device=dev)
                 for d in (torch.int32, torch.float32, torch.int64,
                           torch.float32, torch.int32))
    if n:
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [t.data_ptr() for t in (payload, addresses, top, ts, seed,
                                       cnt, *outs)]
        err = _launcher()(
            *ptrs, n, S, LANES, C, K, KR, n_objects, to_f32(lookahead),
            DISTS[dist], to_f32(mean), int(hot_objects), int(hot_prob),
            stream)
        if err:
            raise RuntimeError(f"event_apply kernel launch failed: CUDA "
                               f"error {err}")
        event_apply_cuda.launches += 1
    return (payload, addresses, top, *outs)


event_apply_cuda.launches = 0
