"""Event records and counter-based RNG for deterministic PDES (PyTorch).

Port of ``repro/core/events.py``.  An event batch is a struct-of-arrays
NamedTuple of tensors with a fixed capacity and a validity mask; capacity
overflow is counted by the callers, never silent.

u32 in int64: torch's ``uint32`` lacks ``+``, ``>>``, ``%`` and ``<`` on the
CPU, so every u32 value (event seeds, RNG words) rides in an ``int64`` tensor
holding ``[0, 2**32)``.  Adds are masked with ``& 0xFFFFFFFF``; multiplies
split the constant into 16-bit halves (:func:`_mul32`) so no intermediate
leaves the int64 range.  The non-negative int64 order equals the unsigned
order, which is what the calendar's ``(ts, seed)`` sort needs.

The numpy mirrors at the bottom are the port's own copy of the oracle's RNG
(the port imports nothing from the JAX package).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

M32 = 0xFFFFFFFF


class EventBatch(NamedTuple):
    """A fixed-capacity batch of events (struct of arrays).

    dst:     global destination object id (i32)
    ts:      timestamp (f32)
    seed:    per-event RNG counter / tie-break (u32 carried in i64)
    payload: one f32 payload lane
    valid:   mask (bool)
    """

    dst: torch.Tensor
    ts: torch.Tensor
    seed: torch.Tensor
    payload: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.dst.shape[-1]

    def count(self) -> torch.Tensor:
        return self.valid.sum(-1, dtype=torch.int32)


def empty_batch(cap: int, *lead: int, device) -> EventBatch:
    shape = tuple(lead) + (cap,)
    return EventBatch(
        dst=torch.zeros(shape, dtype=torch.int32, device=device),
        ts=torch.full(shape, float("inf"), dtype=torch.float32, device=device),
        seed=torch.zeros(shape, dtype=torch.int64, device=device),
        payload=torch.zeros(shape, dtype=torch.float32, device=device),
        valid=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def concat_batches(a: EventBatch, b: EventBatch) -> EventBatch:
    return EventBatch(*(torch.cat([x, y], dim=-1) for x, y in zip(a, b)))


def compact(batch: EventBatch) -> EventBatch:
    """Stable-move valid events to the front of the batch."""
    return compact_mask(batch, batch.valid)


def compact_mask(batch: EventBatch, mask: torch.Tensor) -> EventBatch:
    """Keep only ``mask`` events (stable order, moved to the front)."""
    # sort by !mask (0 < 1), stable → selected entries first, order kept.
    order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices

    def take(x):
        return torch.gather(x, -1, order)

    return EventBatch(take(batch.dst), take(batch.ts), take(batch.seed),
                      take(batch.payload), take(mask & batch.valid))


def truncate(batch: EventBatch, cap: int) -> EventBatch:
    return EventBatch(*(x[..., :cap] for x in batch))


# ---------------------------------------------------------------------------
# splitmix32 on u32-in-int64 tensors, bit-identical to the numpy mirrors.
# ---------------------------------------------------------------------------

def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """``(z * c) mod 2**32`` for ``z`` in ``[0, 2**32)`` without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (z * lo + (((z * hi) & 0xFFFF) << 16)) & M32


def _mix(z: torch.Tensor) -> torch.Tensor:
    z = (z + 0x9E3779B9) & M32
    z = _mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


def fold(seed: torch.Tensor, k: int) -> torch.Tensor:
    """Derive stream k from a seed (u32 bits in an int64 tensor)."""
    c = (k * 0x632BE59B) & M32
    return _mix((seed.to(torch.int64) & M32) ^ c)


def uniform24(bits: torch.Tensor) -> torch.Tensor:
    """u32 → f32 uniform in [0, 1) with 24-bit resolution (exact dyadic)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def dyadic10(bits: torch.Tensor) -> torch.Tensor:
    """u32 → f32 in [0, 1) on a 1/1024 grid (f32-exact partial sums below
    2**14, so every engine and the oracle agree bit-for-bit)."""
    return (bits & 1023).to(torch.float32) * (1.0 / 1024.0)


def to_f32(x: float) -> float:
    """Round a Python float to the nearest f32 (what ``jnp.float32`` does)."""
    return float(np.float32(x))


def draw(bits: torch.Tensor, dist: str, mean: float = 1.0) -> torch.Tensor:
    """Shared increment draw used by every workload model."""
    if dist == "dyadic":
        return dyadic10(bits)
    if dist == "uniform24":
        return uniform24(bits) * to_f32(mean)
    if dist == "exponential":
        return -torch.log1p(-uniform24(bits)) * to_f32(mean)
    raise ValueError(dist)


def dyadic_scaled(bits: torch.Tensor, shift: int) -> torch.Tensor:
    """u32 → f32 in [0, 2**-shift) on the 1/(1024·2**shift) grid."""
    return dyadic10(bits) * (2.0 ** -shift)


def draw_scaled(bits: torch.Tensor, dist: str, shift: int,
                mean: float = 1.0) -> torch.Tensor:
    """:func:`draw` scaled by ``2**-shift`` (exact: power-of-two scaling)."""
    if dist == "dyadic":
        return dyadic_scaled(bits, shift)
    return draw(bits, dist, mean) * (2.0 ** -shift)


def ring_neighbor(gid, go_right, n: int):
    """Neighbor on a ring of ``n`` objects, wrapping at both edges.

    Works on tensors and on numpy/Python ints.  ``go_right`` is a bool
    tensor or a Python/numpy bool; a Python bool stays a Python int step, so
    a tensor ``gid`` makes no host-to-device copy for it.
    """
    if isinstance(gid, torch.Tensor) and isinstance(go_right, torch.Tensor):
        step = torch.where(go_right, 1, n - 1)
    elif isinstance(gid, torch.Tensor):
        step = 1 if go_right else n - 1
    else:
        step = np.int32(1 if go_right else n - 1)
    return (gid + step) % n


# numpy mirrors ---------------------------------------------------------------

def seed_salt_np(seed: int) -> np.uint32:
    """Replication-seed salt for a workload's initial-event stream (seed 0 → 0)."""
    with np.errstate(over="ignore"):
        return np.uint32(np.uint32(seed) * np.uint32(0x9E3779B9))


def _mix_np(z: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        z = (z.astype(np.uint32) + np.uint32(0x9E3779B9)).astype(np.uint32)
        z = ((z ^ (z >> np.uint32(16))) * np.uint32(0x85EBCA6B)).astype(np.uint32)
        z = ((z ^ (z >> np.uint32(13))) * np.uint32(0xC2B2AE35)).astype(np.uint32)
        return (z ^ (z >> np.uint32(16))).astype(np.uint32)


def fold_np(seed, k: int):
    c = np.uint32((k * 0x632BE59B) & M32)
    with np.errstate(over="ignore"):
        return _mix_np(np.uint32(seed) ^ c)


def uniform24_np(bits):
    return np.float32(np.uint32(bits) >> np.uint32(8)) * np.float32(1.0 / (1 << 24))


def dyadic10_np(bits):
    return np.float32(np.uint32(bits) & np.uint32(1023)) * np.float32(1.0 / 1024.0)


def draw_np(bits, dist: str, mean: float = 1.0):
    """numpy mirror of :func:`draw` — identical op order for bit-exactness."""
    if dist == "dyadic":
        return dyadic10_np(bits)
    if dist == "uniform24":
        return uniform24_np(bits) * np.float32(mean)
    if dist == "exponential":
        u = uniform24_np(bits)
        return np.float32(-np.log1p(-u)) * np.float32(mean)
    raise ValueError(dist)


def dyadic_scaled_np(bits, shift: int):
    return np.float32(dyadic10_np(bits) * np.float32(2.0 ** -shift))


def draw_scaled_np(bits, dist: str, shift: int, mean: float = 1.0):
    if dist == "dyadic":
        return dyadic_scaled_np(bits, shift)
    return np.float32(draw_np(bits, dist, mean) * np.float32(2.0 ** -shift))
