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
Checkpoint and restart are the loop's (``train/loop.py``); an elastic
restart onto another device count is not ported (ROADMAP A19).
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
                                               None]] = None):
        self.fn = fn
        self.max_retries = max_retries
        self.straggler = StragglerStats()
        self.straggler_factor = straggler_factor
        self.on_failure = on_failure
        self.failures = 0

    def __call__(self, *args, **kwargs):
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                out = self.fn(*args, **kwargs)
                _block(out)
                self.straggler.update(time.perf_counter() - t0,
                                      self.straggler_factor)
                return out
            # torch.cuda.OutOfMemoryError is a RuntimeError, so an OOM is
            # retried too: the failed attempt's autograd graph and
            # gradients are freed as the exception unwinds (the retry
            # drops any gradient left on the parameters first), so the
            # retry starts from the memory the first attempt found; an OOM
            # that the step's own size causes fails again each time and
            # ends in StepFailure.
            except (RuntimeError, ValueError) as e:
                self.failures += 1
                attempt += 1
                if self.on_failure:
                    self.on_failure(e, attempt)
                if attempt > self.max_retries:
                    raise StepFailure(
                        f"step failed after {attempt} attempts") from e


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
