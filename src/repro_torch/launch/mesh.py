"""Device meshes of the port (``repro/launch/mesh.py``).

A mesh over ranks is a ``torch.distributed`` ``DeviceMesh`` with named
dims (:func:`make_mesh`), built over the ranks of the default process
group.  The reference's production meshes (:func:`make_production_mesh`)
need a group of 256 or 512 ranks; the dry run makes one in its own
process with the fake backend (:func:`fake_mesh`): the process is rank 0,
DTensor computes rank 0's shards and issues rank 0's collectives, which
move nothing.  :class:`LocalMesh` describes the devices there are, for
``--mesh local``.  Nothing touches a device or a process group at import
time.
"""
from __future__ import annotations

import dataclasses
import math

#: the reference's production meshes: a 16x16 pod, and two of them.
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """``shape``: {axis: size}; ``devices``: the devices, as
    ``torch.device`` strings."""
    shape: dict
    devices: tuple

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(shape, axes, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    ranks of the default process group (``init_device_mesh``), row-major:
    on a ``(1, 2)`` ``("data", "model")`` mesh ranks 0 and 1 are the two
    "model" shards."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, fake: bool = False):
    """The reference's 16x16 ``("data", "model")`` pod or 2x16x16 ``("pod",
    "data", "model")`` pods.  Over a default process group of 256 or 512
    ranks; ``fake=True`` makes that group in this process
    (:func:`fake_mesh`), as the dry run does."""
    shape, axes = PRODUCTION[multi_pod]
    if fake:
        return fake_mesh(shape, axes)
    import torch.distributed as dist
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"the production mesh {'x'.join(map(str, shape))} needs a "
            f"process group of {n} ranks; the dry run makes one in its own "
            f"process (fake=True)")
    return make_mesh(shape, axes)


def fake_mesh(shape, axes):
    """A CPU ``DeviceMesh`` of ``shape`` over a process group of the
    ``"fake"`` backend (``torch.testing``'s ``FakeStore``) in this
    process, which is its rank 0.  A fake group of another size left by an
    earlier call is replaced; a real group is left alone and refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a process group of another backend is "
                               "initialized in this process")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return make_mesh(shape, axes, "cpu")


def make_local_mesh() -> LocalMesh:
    """A one-axis (``data``) mesh over the CUDA devices there are (the
    records' machine: one card), or over the CPU where there is none."""
    import torch
    if torch.cuda.is_available():
        devs = tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    else:
        devs = ("cpu",)
    return LocalMesh({"data": len(devs)}, devs)
