"""Checkpoints of trees of tensors, port of ``repro/checkpoint/ckpt.py``,
in the reference's layout::

    <dir>/step_<N>/manifest.json   — step, leaf count, each leaf's path,
                                     shape and dtype
    <dir>/step_<N>/leaf_<i>.npy    — one file per leaf (the whole tensor)
    <dir>/LATEST                   — the last step saved (tmp + rename)

A step is written into a temporary directory and renamed into place, and
``LATEST`` is flipped by a rename after it, so a failure mid-save never
leaves a pointer to a partial step.  Leaves are numbered in the port's tree
order (``train.optimizer.tree_items``: dicts in their key order,
NamedTuples by field, lists by index) and the manifest records each leaf's
path (``params.blocks.0.attn.wq``, ``opt.mu.embed.tok``, ``opt.count``).
numpy cannot hold torch's bfloat16, so a bf16 leaf is stored by its 16-bit
pattern (``uint16``) under the dtype ``"bfloat16"`` and restored bit for
bit.  Leaves are saved from any device and restored onto the device of the
matching leaf of the target tree.

Over a device mesh (DTensor leaves, ``distributed.sharding``) the layout
stays the same, so a checkpoint is free of topology: :func:`save` gathers
each DTensor leaf whole on every rank (``sharding.full``, a collective
every rank of the mesh joins), the mesh's first rank writes, and every
rank then waits at a barrier, so none reads ``LATEST`` before it is
flipped.  :func:`restore` with ``shardings`` (the rules' specs, a tree
shaped as the target) and ``mesh`` is the elastic reshard: every rank
reads the whole arrays and keeps its own block of each
(``sharding.place``), whatever mesh, or no mesh, saved them.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..distributed import sharding
from ..train.optimizer import tree_items


def _to_numpy(t: torch.Tensor):
    """(array, dtype name) of a tensor; bf16 by its bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _mesh_of(items):
    """The mesh of the first DTensor leaf, or None."""
    for _, leaf in items:
        if sharding.is_dtensor(leaf):
            return leaf.device_mesh
    return None


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` waits for every other: a barrier over each
    mesh dim's group in turn (a rank leaves the last one only after every
    rank has entered the first)."""
    import torch.distributed as dist
    for i in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(i))


def save(directory: str | os.PathLike, step: int, tree: Any,
         keep: int = 3) -> Path:
    """Write ``tree`` as ``<directory>/step_<step>``, point ``LATEST`` at it
    and keep the ``keep`` latest steps.  With DTensor leaves every rank of
    their mesh must call it: each leaf is gathered whole, the mesh's
    first rank writes, and all ranks return after it has."""
    d = Path(directory)
    items = tree_items(tree)
    mesh = _mesh_of(items)
    writer = mesh is None or mesh.get_rank() == int(mesh.mesh.flatten()[0])
    if writer:
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()

    manifest = {"step": step, "n_leaves": len(items), "leaves": []}
    for i, (path, leaf) in enumerate(items):
        if sharding.is_dtensor(leaf):
            leaf = sharding.full(leaf)
        arr, dtype = _to_numpy(leaf)
        if writer:
            np.save(tmp / f"leaf_{i}.npy", arr)
        manifest["leaves"].append({"path": path, "shape": list(arr.shape),
                                   "dtype": dtype})
    final = d / f"step_{step}"
    if writer:
        _write(d, tmp, final, step, manifest, keep)
    if mesh is not None:
        _barrier(mesh)
    return final


def _write(d: Path, tmp: Path, final: Path, step: int, manifest: dict,
           keep: int) -> None:
    (tmp / "manifest.json").write_text(json.dumps(manifest))

    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)

    latest_tmp = d / ".LATEST.tmp"
    latest_tmp.write_text(str(step))
    latest_tmp.rename(d / "LATEST")     # atomic pointer flip

    _gc(d, keep)


def _gc(d: Path, keep: int):
    steps = sorted((int(p.name.split("_")[1]) for p in d.glob("step_*")),
                   reverse=True)
    for s in steps[keep:]:
        shutil.rmtree(d / f"step_{s}", ignore_errors=True)


def latest_step(directory: str | os.PathLike) -> int | None:
    f = Path(directory) / "LATEST"
    if not f.exists():
        return None
    return int(f.read_text().strip())


def _rebuild(tree, leaves: dict, prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        return leaves[prefix[:-1]]
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}.")
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, leaves, f"{prefix}{k}.")
                            for k, v in zip(tree._fields, tree)))
    return type(tree)(_rebuild(v, leaves, f"{prefix}{i}.")
                      for i, v in enumerate(tree))


def restore(directory: str | os.PathLike, tree_like: Any,
            step: int | None = None, shardings: Any = None,
            mesh=None) -> tuple[Any, int]:
    """(a tree shaped as ``tree_like`` holding the checkpoint's leaves in
    their saved dtype, each on the device of ``tree_like``'s leaf at the
    same path; the step).  With ``shardings`` (a spec per leaf, a tree
    shaped as ``tree_like``; ``None`` at a leaf keeps it whole) and
    ``mesh``, each leaf becomes a DTensor on ``mesh`` of which this rank
    holds its own block only: the elastic reshard.  Raises
    ``ValueError`` when the leaf count, a path or a shape differs from
    ``tree_like``'s, ``FileNotFoundError`` when there is no
    checkpoint."""
    d = Path(directory)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {d}")
    src = d / f"step_{step}"
    manifest = json.loads((src / "manifest.json").read_text())

    items = tree_items(tree_like)
    if manifest["n_leaves"] != len(items):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target structure has {len(items)}")
    saved = {e["path"]: (i, e) for i, e in enumerate(manifest["leaves"])}
    specs = dict(tree_items(shardings, leaf=_is_spec)) \
        if shardings is not None else {}
    out = {}
    for path, ref in items:
        if path not in saved:
            raise ValueError(f"checkpoint has no leaf {path!r}")
        i, entry = saved[path]
        arr = np.load(src / f"leaf_{i}.npy")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i} ({path}): checkpoint shape "
                             f"{arr.shape} != target {tuple(ref.shape)}")
        t = _from_numpy(arr, entry["dtype"])
        spec = specs.get(path)
        out[path] = t.to(ref.device) if spec is None else \
            sharding.place(t, spec, mesh, device=ref.device)
    return _rebuild(tree_like, out), step


def _is_spec(x) -> bool:
    """A spec (a tuple of axis names, tuples of them and None) or None,
    the leaves of a tree of shardings."""
    return x is None or (isinstance(x, tuple) and not hasattr(x, "_fields")
                         and all(e is None or isinstance(e, (str, tuple))
                                 for e in x))
