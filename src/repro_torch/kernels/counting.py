"""The kernels' hook for a FLOP counter (``roofline.analysis.FlopCounter``).

A counter entered puts itself in :data:`ACTIVE`.  A kernel wrapper runs
its launch inside :func:`counted_as` with its plain twin, so that the call
counts as the work of the plain version (the ops it would dispatch for
the same call) on every device, while the storages the call really
allocates count as live.  With no counter active :func:`counted_as` is a
no-op.
"""
from __future__ import annotations

import contextlib

import torch

#: counters entered and not yet left, innermost last.  Each has two ints:
#: ``hidden`` (while > 0 it counts no ops, but keeps tallying the storages
#: they allocate) and ``in_plain`` (while > 0 it counts ops but tallies no
#: storage: the plain twin's meta run, which allocates nothing).
ACTIVE: list = []

_NOTHING = contextlib.nullcontext()


def _meta(x):
    """A meta tensor shaped like ``x`` (strides kept); anything else as it
    is."""
    if not isinstance(x, torch.Tensor):
        return x
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device="meta")


def counted_as(plain, *args, **kwargs):
    """A context in which a kernel call counts as
    ``plain(*args, **kwargs)``'s work.

    With no active counter it does nothing.  Otherwise ``plain`` runs once
    on meta copies of the tensors (no value is computed, nothing is
    allocated) where the counters see its ops, and the enclosed call is
    then hidden from their op counts; the storages it allocates are still
    tallied.  Nested uses count the outermost one's plain function."""
    if not ACTIVE:
        return _NOTHING
    return _counted(plain, args, kwargs)


@contextlib.contextmanager
def _counted(plain, args, kwargs):
    active = [c for c in ACTIVE if not c.hidden]
    for c in active:
        c.in_plain += 1
    try:
        with torch.no_grad():
            plain(*map(_meta, args),
                  **{k: _meta(v) for k, v in kwargs.items()})
    finally:
        for c in active:
            c.in_plain -= 1
    for c in active:
        c.hidden += 1
    try:
        yield
    finally:
        for c in active:
            c.hidden -= 1
