"""Object → device placement (the paper's NUMA knapsack, §II-A / §II-C).

Port of ``repro/core/placement.py``: contiguous global id ranges per
device, expressed as a boundaries vector, with a weighted variant that
balances a per-object load hint (the knapsack objective).  The owner lookup
used by routing is a ``searchsorted`` over the boundaries.

The boundaries may be live: the engine keeps them in ``EngineState.bounds``
and rebuilds a :class:`Placement` from them every step
(:meth:`Placement.with_boundaries`), so the adaptive rebalance stage can
move the cuts.  A stack of replications over several devices under
adaptive placement moves each replication's cuts on their own: its live
boundaries are a tensor [R, D + 1], one row per replication, which
``owner`` and ``start`` take row by row.  ``n_objects``, ``n_devices``
and ``n_local_max`` never change: every device materializes
``n_local_max`` object rows (the pad), rows beyond its live count inert.  ``owner`` gives garbage for ids outside
``[0, n_objects)``; callers mask ``dst`` first (the engine counts such
events in ``stats.oob_events``).  Everything here is host numpy but
``owner``, ``start`` and ``local_index``, which take tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class Placement(NamedTuple):
    """Contiguous placement of n_objects over n_devices.

    boundaries: device d owns [boundaries[d], boundaries[d+1]); a numpy
                array (static placement) or a tensor (the engine's live copy).
    n_local_max: row pad — objects materialized per device.
    """

    boundaries: np.ndarray
    n_objects: int
    n_devices: int
    n_local_max: int

    def owner_np(self, dst: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.boundaries, dst,
                               side="right").astype(np.int32) - 1

    def owner(self, dst: torch.Tensor) -> torch.Tensor:
        b = torch.as_tensor(self.boundaries, device=dst.device).to(dst.dtype)
        if b.ndim == 2:          # a row per replication of dst [R, ...]
            flat = dst.reshape(b.shape[0], -1).contiguous()
            return (torch.searchsorted(b, flat, right=True).to(torch.int32)
                    - 1).view(dst.shape)
        return (torch.searchsorted(b, dst.contiguous(), right=True)
                .to(torch.int32) - 1)

    def start(self, d: int, device) -> torch.Tensor:
        """Device ``d``'s first global id, i32: 0-d, or [R, 1] for a row
        of boundaries per replication (to broadcast against [R, E])."""
        b = torch.as_tensor(self.boundaries, device=device).to(torch.int32)
        return b[:, d:d + 1] if b.ndim == 2 else b[d]

    def local_index(self, dst: torch.Tensor, owner: torch.Tensor
                    ) -> torch.Tensor:
        starts = torch.as_tensor(self.boundaries, device=dst.device)
        return dst - starts.to(dst.dtype)[owner.long()]

    def range_of(self, d: int) -> tuple[int, int]:
        return int(self.boundaries[d]), int(self.boundaries[d + 1])

    def counts(self) -> np.ndarray:
        return np.diff(np.asarray(self.boundaries)).astype(np.int32)

    def with_boundaries(self, boundaries) -> "Placement":
        """Same static shape info, live boundaries."""
        return self._replace(boundaries=boundaries)

    def padded(self, n_local_max: int) -> "Placement":
        """Widen the per-device row pad (adaptive placement headroom)."""
        if n_local_max < self.n_local_max:
            raise ValueError(f"pad {n_local_max} < required {self.n_local_max}")
        return self._replace(n_local_max=n_local_max)

    def padded_gids(self) -> np.ndarray:
        """Global object id of every padded row, [n_devices * n_local_max].

        Rows beyond a device's live count repeat its last owned id (or 0 for
        an empty device) so padding state is always valid model state.
        """
        out = []
        for d in range(self.n_devices):
            lo, hi = self.range_of(d)
            g = np.arange(lo, hi, dtype=np.int64)
            fill = g[-1] if g.size else 0
            out.append(np.concatenate(
                [g, np.full(self.n_local_max - g.size, fill, np.int64)]))
        return np.concatenate(out)


def equal_placement(n_objects: int, n_devices: int) -> Placement:
    """Uniform knapsack: near-equal contiguous ranges."""
    boundaries = np.round(np.linspace(0, n_objects, n_devices + 1)).astype(np.int64)
    n_local_max = int(np.max(np.diff(boundaries)))
    return Placement(boundaries, n_objects, n_devices, n_local_max)


def weighted_placement(weights: Sequence[float], n_devices: int) -> Placement:
    """Knapsack by expected per-object load: split the float64 prefix sum
    of the weights at equal-mass quantiles, keeping ranges contiguous.

    Degenerate weights (non-finite, negative, or summing to ~zero) fall
    back to the equal split.  ``n_local_max`` is the true largest range.
    """
    w = np.asarray(weights, dtype=np.float64)
    n_objects = w.shape[0]
    total = float(np.sum(w))
    if (not np.isfinite(total) or np.any(~np.isfinite(w)) or np.any(w < 0)
            or total <= 1e-12 * max(1, n_objects)):
        return equal_placement(n_objects, n_devices)
    cum = np.concatenate([[0.0], np.cumsum(w)])
    targets = total * np.arange(1, n_devices) / n_devices
    cuts = np.searchsorted(cum, targets, side="left")
    boundaries = np.concatenate([[0], cuts, [n_objects]]).astype(np.int64)
    # monotone non-decreasing (repeated cuts on zero-weight runs)
    boundaries = np.maximum.accumulate(boundaries)
    n_local_max = int(np.max(np.diff(boundaries)))
    return Placement(boundaries, n_objects, n_devices, n_local_max)
