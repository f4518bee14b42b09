"""The device axis over ``torch.distributed``: the port's stand-in for the
reference's mesh axis ``AXIS``.

The JAX engine runs one SPMD program per device under ``shard_map`` and
its stages call ``jax.lax.axis_index``, ``all_gather``, ``all_to_all`` and
``psum`` over ``AXIS``.  The port runs one process per device, a *rank* of
a process group, and a :class:`Comm` plays the axis: ``rank`` is
``axis_index(AXIS)``, ``size`` the axis size, and :meth:`Comm.all_gather`,
:meth:`Comm.all_to_all` and :meth:`Comm.all_sum` are the three
collectives.  Each takes a whole tree of tensors (dicts and NamedTuples,
as :func:`~.pipeline.base.map_tree` walks them) and moves it in one
collective: the leaves travel as the bytes of one ``uint8`` buffer, so an
exchange is bit-exact and never meets a dtype the backend lacks (an
:class:`~.events.EventBatch`'s ``valid`` is bool).

A ``Comm`` without a group is one device: every collective is the
identity (a gathered leaf gains a leading axis of 1), and nothing reads
the host, so the one-device step stays capturable in CUDA graphs.

Backends.  NCCL moves CUDA tensors in place.  Gloo moves host tensors: on a
CUDA tensor the collective is staged explicitly, a copy to the host, the
collective, a copy back to the rank's device (gloo's own CUDA support is
not relied on).  So two ranks can share one card over gloo: the exchange
then runs through the host, which checks the distributed step on the card
and says nothing of the speed of a multi-GPU exchange.

Counters: ``calls`` collectives, ``bytes`` the collectives' results on
this rank (what it receives, its own share included: D × its buffer for an
``all_gather``, its buffer's size for an ``all_to_all``), ``seconds`` on the
host clock around them (a staged collective's copies included; an NCCL
collective is timed to its launch, not its end).

:func:`spawn` starts D ranks as processes (the ``spawn`` start method) that
meet through a ``FileStore`` in a fresh temporary directory, so no port
has to be free; every rank's collectives time out after ``timeout``
seconds and the whole join after ``join_timeout``, so a hung rank fails
the call instead of blocking it.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist


def _flatten(tree) -> list[torch.Tensor]:
    """The tensors of a tree in :func:`~.pipeline.base.map_tree`'s order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flatten(v)]
    return [t for x in tree for t in _flatten(x)]


def _rebuild(tree, new: list[torch.Tensor]):
    """``tree`` with its leaves replaced, in :func:`_flatten`'s order."""
    it = iter(new)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return type(node)(*(walk(x) for x in node))
    return walk(tree)


def _to_bytes(t: torch.Tensor, lead: int) -> torch.Tensor:
    """``t`` [lead, ...] as uint8 [lead, nbytes], each row padded to a
    multiple of 8 bytes (so every leaf of a packed buffer starts aligned)."""
    b = t.contiguous().reshape(lead, t.numel() // lead).view(torch.uint8)
    pad = -b.shape[1] % 8
    if pad:
        b = torch.cat([b, b.new_zeros((lead, pad))], 1)
    return b


def _from_bytes(buf: torch.Tensor, like: list[torch.Tensor],
                inner: list[tuple]) -> list[torch.Tensor]:
    """Undo :func:`_to_bytes` on a [L, total] byte buffer: leaf k of
    ``like`` comes back as [L, *inner[k]]."""
    out, off = [], 0
    for t, shape in zip(like, inner):
        size = int(torch.Size(shape).numel()) * t.element_size()
        chunk = buf[:, off:off + size].contiguous()
        out.append(chunk.view(t.dtype).reshape((buf.shape[0],) + shape))
        off += size + (-size % 8)
    return out


class Comm:
    """A process group as the engine's device axis (see the module
    docstring); ``Comm()`` is one device."""

    def __init__(self, group=None):
        self.group = group
        if group is None:
            self.rank, self.size, self.backend = 0, 1, None
        else:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    # -- the raw collectives on one tensor -----------------------------------

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _timed(self, fn, t: torch.Tensor):
        t0 = time.perf_counter()
        out = fn(t.cpu() if self._staged(t) else t)
        if out.device != t.device:
            out = out.to(t.device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        self.bytes += out.numel() * out.element_size()
        return out

    def gather_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """``all_gather``: [D, *t.shape], row d from rank d."""
        if self.size == 1:
            return t.unsqueeze(0)

        def run(x):
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            return torch.stack(parts)
        return self._timed(run, t)

    def a2a_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """``all_to_all`` of t [D, ...]: row d goes to rank d; row s of the
        result came from rank s."""
        if self.size == 1:
            return t
        if t.shape[0] != self.size:
            raise ValueError(f"all_to_all needs a leading {self.size}, got "
                             f"{tuple(t.shape)}")

        def run(x):
            x = x.contiguous()
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=self.group)
            return out
        return self._timed(run, t)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``psum``: the elementwise sum over the ranks (integers summed
        as int64, returned in ``t``'s dtype)."""
        if self.size == 1:
            return t

        def run(x):
            x = x.to(torch.int64 if not x.is_floating_point() else x.dtype
                     ).clone()
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
            return x
        return self._timed(run, t).to(t.dtype)

    # -- trees -----------------------------------------------------------------

    def all_gather(self, tree):
        """``all_gather`` of every leaf of ``tree``: each gains a leading
        [D] (row d from rank d); one collective for the whole tree."""
        if self.size == 1:
            return _rebuild(tree, [t.unsqueeze(0) for t in _flatten(tree)])
        leaves = _flatten(tree)
        buf = torch.cat([_to_bytes(t, 1) for t in leaves], 1)[0]
        got = self.gather_tensor(buf)                       # [D, total]
        return _rebuild(tree, _from_bytes(
            got, leaves, [tuple(t.shape) for t in leaves]))

    def all_to_all(self, tree):
        """``all_to_all`` of every leaf [D, ...] of ``tree`` (row d to rank
        d; row s of a result from rank s); one collective for the tree."""
        if self.size == 1:
            return tree
        leaves = _flatten(tree)
        D = self.size
        buf = torch.cat([_to_bytes(t, D) for t in leaves], 1)
        got = self.a2a_tensor(buf)                          # [D, total]
        return _rebuild(tree, _from_bytes(
            got, leaves, [tuple(t.shape[1:]) for t in leaves]))


def _rank_entry(fn, rank: int, size: int, backend: str, store_path: str,
                timeout: float, args: tuple, results) -> None:
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, size), rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, dist.group.WORLD, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                      # noqa: BLE001 (reported)
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn: Callable[..., Any], size: int, *args, backend: str = "gloo",
          timeout: float = 120.0, join_timeout: float = 600.0) -> list:
    """Run ``fn(rank, group, *args)`` on ``size`` ranks, each its own
    process; returns the ranks' results in rank order.

    ``fn`` and ``args`` must pickle (a module-level function).  The ranks
    meet through a ``FileStore`` in a fresh temporary directory.  Every
    collective of a rank times out after ``timeout`` seconds; the whole
    call after ``join_timeout``, when every rank still alive is killed.
    A rank that raises fails the call with its traceback."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_spawn_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, size, backend,
                               os.path.join(tmp, "store"), timeout, args,
                               results))
             for r in range(size)]
    try:
        for p in procs:
            p.start()
        got: dict[int, Any] = {}
        deadline = time.monotonic() + join_timeout
        while len(got) < size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: {size - len(got)} of {size} ranks did not "
                    f"finish within {join_timeout:g} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead and results.empty():
                    time.sleep(0.5)
                    if results.empty():
                        raise RuntimeError(
                            f"spawn: a rank exited with code "
                            f"{dead[0].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        return [got[r] for r in range(size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
