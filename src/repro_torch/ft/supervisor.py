"""Supervised stepping, port of ``repro/ft/supervisor.py``: bounded retry
of a failed step and straggler accounting.

``SupervisedStep`` wraps the train step.  A step that raises
``RuntimeError`` or ``ValueError`` (a CUDA or runtime fault) is counted,
reported to ``on_failure`` and run again on the same inputs, which the
step leaves untouched until its final update (``train/step.py``); after
``max_retries`` retries it raises :class:`StepFailure`.  Per-step times
feed an EWMA, and a step slower than ``straggler_factor`` times it is
counted as a straggler.  The clock stops after the step's output is ready
on its device (:func:`_block`), so on the card it measures device time too.
Checkpoint and restart are the loop's (``train/loop.py``); the elastic
restart onto another device count is ``checkpoint.ckpt.restore(...,
shardings=, mesh=)``, which ``Trainer.resume_or_init`` calls over a mesh.

Over a device mesh (``mesh=``) every rank runs the same collectives in the
same order, so a retry on one rank alone would pair its collectives with
other ones on its peers, and a rank that had already updated its blocks
would apply the step twice.  So the ranks agree once per attempt, by an
all-reduce (max) of a failure flag over each mesh dim, at the last point
before anything is written: the step is called with ``agree=``, which it
calls after its last collective and before its first write (the train
step's AdamW update does); a rank that failed before that point joins
the same all-reduce from here with its flag set.  Then every rank
retries, each counting the failure (a peer's as a :class:`StepFailure`),
or none does.  A step that never calls ``agree`` is agreed on after it
returns.  This covers a failure that leaves the ranks' collectives
aligned (one raised after the step's last collective and before its
update); a rank that fails between two collectives leaves its peers
waiting in the next until the process group's timeout.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch


@dataclasses.dataclass
class StragglerStats:
    ewma_s: float = 0.0
    count: int = 0
    slow_steps: int = 0
    last_s: float = 0.0

    def update(self, dt: float, factor: float = 2.0) -> bool:
        self.last_s = dt
        self.count += 1
        if self.ewma_s == 0.0:
            self.ewma_s = dt
            return False
        slow = dt > factor * self.ewma_s
        if slow:
            self.slow_steps += 1
        # straggler steps don't poison the EWMA
        self.ewma_s = 0.9 * self.ewma_s + 0.1 * min(dt, factor * self.ewma_s)
        return slow


class StepFailure(RuntimeError):
    pass


class SupervisedStep:
    """Wrap a step callable with retry + straggler accounting."""

    def __init__(self, fn: Callable[..., Any], max_retries: int = 2,
                 straggler_factor: float = 2.0,
                 on_failure: Optional[Callable[[Exception, int],
                                               None]] = None, mesh=None):
        self.fn = fn
        self.mesh = mesh
        self.max_retries = max_retries
        self.straggler = StragglerStats()
        self.straggler_factor = straggler_factor
        self.on_failure = on_failure
        self.failures = 0

    def __call__(self, *args, **kwargs):
        attempt = 0
        if self.mesh is not None:
            kwargs = dict(kwargs, agree=self._agree)
        while True:
            t0 = time.perf_counter()
            err = None
            self._agreed = False
            try:
                out = self.fn(*args, **kwargs)
                _block(out)
                if self.mesh is not None and not self._agreed:
                    self._agree()
            # torch.cuda.OutOfMemoryError is a RuntimeError, so an OOM is
            # retried too: the failed attempt's autograd graph and
            # gradients are freed as the exception unwinds (the retry
            # drops any gradient left on the parameters first), so the
            # retry starts from the memory the first attempt found; an OOM
            # that the step's own size causes fails again each time and
            # ends in StepFailure.
            except (RuntimeError, ValueError) as e:
                err = e
                if self.mesh is not None and not self._agreed:
                    self._agree(failed=True)
            if err is None:
                self.straggler.update(time.perf_counter() - t0,
                                      self.straggler_factor)
                return out
            self.failures += 1
            attempt += 1
            if self.on_failure:
                self.on_failure(err, attempt)
            if attempt > self.max_retries:
                raise StepFailure(
                    f"step failed after {attempt} attempts") from err

    def _agree(self, failed: bool = False) -> None:
        """This attempt's agreement over the mesh (once): raises
        :class:`StepFailure` on a rank that has not failed itself when
        another has."""
        self._agreed = True
        if _any_failed(failed, self.mesh) and not failed:
            raise StepFailure("the step failed on another rank")


def _any_failed(failed: bool, mesh) -> bool:
    """Whether any rank of ``mesh`` failed: this rank's flag all-reduced
    (max) over each mesh dim in turn, on the mesh's device type."""
    from ..distributed.sharding import all_reduce_dim
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    flag = torch.tensor([int(failed)], dtype=torch.int32, device=dev)
    for i in range(mesh.ndim):
        flag = all_reduce_dim(flag, "max", mesh, i)
    return bool(flag.item())


def _block(tree):
    """Wait until the first tensor in ``tree`` is ready on its device."""
    stack = [tree]
    while stack:
        node = stack.pop(0)
        if isinstance(node, torch.Tensor):
            if node.device.type == "cuda":
                torch.cuda.synchronize(node.device)
            return
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
