"""The per-object stack allocator (paper §II-C, Fig 1), batched over objects.

Port of ``repro/phold/arena.py``.  Per object an ``addresses`` array of
chunk indices and a ``top`` cursor; free chunks live at
``addresses[top : count)``::

    alloc:  return addresses[top++]
    free:   addresses[--top] = addr

The tensor functions carry a leading object dimension ``n``; ``k`` is a
Python int.  The ``_np`` mirrors act on one object, for the oracle.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Arena(NamedTuple):
    addresses: torch.Tensor  # i32 [n, n_nodes] — free-chunk stack at [top:]
    top: torch.Tensor        # i32 [n]


def arena_init(n: int, n_nodes: int, device) -> Arena:
    """All nodes allocated: empty free region (top == count)."""
    addr = torch.arange(n_nodes, dtype=torch.int32, device=device)
    return Arena(addr.expand(n, n_nodes).contiguous(),
                 torch.full((n,), n_nodes, dtype=torch.int32, device=device))


def free_k(a: Arena, idxs: torch.Tensor) -> Arena:
    """Release k chunks per object (``idxs`` is [n, k]): addresses[--top] = addr.

    Successive frees push downward, so the last freed lands at the lowest
    slot.  Positions index like the JAX package's ``.at[pos].set(...,
    mode="drop")``: a negative position counts from the end once, and what
    is still outside ``[0, n_nodes)`` is dropped (scattered into one extra
    sentinel column that is sliced off).
    """
    n, S = a.addresses.shape
    k = idxs.shape[1]
    top2 = a.top - k
    pos = top2[:, None].to(torch.int64) + torch.arange(k, device=idxs.device)
    pos = torch.where(pos < 0, pos + S, pos)
    pos = torch.where((pos >= 0) & (pos < S), pos, S)
    padded = torch.cat([a.addresses, a.addresses.new_zeros((n, 1))], dim=1)
    padded.scatter_(1, pos, idxs.flip(1).to(torch.int32))
    return Arena(padded[:, :S].contiguous(), top2)


def alloc_k(a: Arena, k: int) -> tuple[Arena, torch.Tensor]:
    """Allocate k chunks per object: return addresses[top++] (LIFO)."""
    S = a.addresses.shape[1]
    pos = a.top[:, None].to(torch.int64) + torch.arange(
        k, device=a.top.device)
    vals = torch.gather(a.addresses, 1, pos.clamp(0, S - 1))
    return Arena(a.addresses, a.top + k), vals


# numpy mirror (sequential oracle) -------------------------------------------

def arena_init_np(n_nodes: int):
    return np.arange(n_nodes, dtype=np.int32), np.int32(n_nodes)


def free_k_np(addresses, top, idxs):
    k = len(idxs)
    top2 = top - k
    addresses[top2:top2 + k] = np.asarray(idxs, np.int32)[::-1]
    return addresses, np.int32(top2)


def alloc_k_np(addresses, top, k):
    vals = addresses[top:top + k].copy()
    return addresses, np.int32(top + k), vals
