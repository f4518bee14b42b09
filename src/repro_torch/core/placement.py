"""Object → device placement (the paper's NUMA knapsack, §II-A / §II-C).

Port of the equal split of ``repro/core/placement.py``: contiguous global id
ranges per device, expressed as a boundaries vector; the owner lookup used
by routing is a ``searchsorted`` over it.  The weighted and adaptive
placements come with the multi-device slice.
"""
from __future__ import annotations

from typing import NamedTuple

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

    def owner(self, dst: torch.Tensor) -> torch.Tensor:
        b = torch.as_tensor(self.boundaries, device=dst.device).to(dst.dtype)
        return (torch.searchsorted(b, dst.contiguous(), right=True)
                .to(torch.int32) - 1)

    def range_of(self, d: int) -> tuple[int, int]:
        return int(self.boundaries[d]), int(self.boundaries[d + 1])

    def with_boundaries(self, boundaries) -> "Placement":
        """Same static shape info, live boundaries."""
        return self._replace(boundaries=boundaries)

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
