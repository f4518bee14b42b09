"""Device meshes of the port (``repro/launch/mesh.py``).

A mesh here is a plain description (axis sizes and the devices), not a
device object: the dry run passes fake tensors on the CPU device and reads
only the device count.  Nothing touches a device at import time.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """``shape``: {axis: size}; ``devices``: the devices, as
    ``torch.device`` strings."""
    shape: dict
    devices: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 pod and 2x16x16 pods.  Per-device shapes on
    them need the parameter, optimizer-state, batch and cache shardings of
    ``distributed/sharding.py``, which the port does not have yet
    (ROADMAP A12), so this raises."""
    name = "multi (2x16x16)" if multi_pod else "single (16x16)"
    raise NotImplementedError(
        f"the production mesh {name} needs per-device shapes from "
        f"distributed/sharding.py, not ported yet (ROADMAP A12); the dry "
        f"run takes --mesh local")


def make_local_mesh() -> LocalMesh:
    """A one-axis (``data``) mesh over the CUDA devices there are (the
    records' machine: one card), or over the CPU where there is none."""
    import torch
    if torch.cuda.is_available():
        devs = tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    else:
        devs = ("cpu",)
    return LocalMesh({"data": len(devs)}, devs)
