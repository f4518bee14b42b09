"""CUDA graphs of the epoch step: the engine's fused loops on the card.

The JAX engine runs ``run`` as one compiled ``fori_loop`` and
``run_until_drained`` as one ``while_loop``.  On a CUDA device the port
captures the step into CUDA graphs of fixed lengths (1, 2, 4, ...,
``DRAIN_CHUNK`` steps) and replays them, so a horizon of any length is a
sequence of replays and never a new capture.  Each graph reads and writes one static
:class:`EngineState` that the runner owns: its steps run from that state,
and its last operations copy the final state back into it (the kernel
updates the object state in place) and write the variant's flag (by
default the events still in flight) to a small static tensor.  ``run``
replays ungated graphs and reads nothing; ``run_until_drained`` replays
graphs of the gated step and reads the flag once per ``DRAIN_CHUNK``
epochs.

A step variant is any hashable key with its step function (and, where it
is not the events in flight, its flag function).  The speculative step
(``opt_window > 0``) takes an exclusive epoch bound per replication: the
runner owns it as a static i32 tensor (:attr:`StepGraphs.bound`), written
with ``copy_`` before the replays, so one graph serves every bound; its
flag says how many replications are still short of their bound (and, in a
drain, hold events) and how many epochs the farthest has left.

Capture launches nothing, so the kernels' ``launches`` counters are put
back after a capture and the launches it recorded are added once per
replay (:func:`capture`, :func:`replay`; the serving session's decode
graph, ``serve/engine.py``, keeps the same rules).  A failed capture or
replay raises; nothing falls back to the eager loop.  A runner holds at
most ``len(LENGTHS)`` graphs per variant, all in one memory pool (their
scratch is dead at every graph's end, so they may share it in any order).
"""
from __future__ import annotations

from typing import Callable, Hashable

import torch

from .pipeline import EngineState, in_flight, map_tree

#: epochs per read of the drain flag, and the longest captured graph.
DRAIN_CHUNK = 16
#: the graph lengths a runner may capture: the powers of two up to
#: ``DRAIN_CHUNK``.
LENGTHS = tuple(1 << i for i in range(DRAIN_CHUNK.bit_length()))


def split(n: int) -> list[int]:
    """``n`` epochs as graph lengths: whole chunks, then the binary digits
    of the rest, longest first."""
    rest = n % DRAIN_CHUNK
    return [DRAIN_CHUNK] * (n // DRAIN_CHUNK) + [
        1 << i for i in reversed(range(rest.bit_length())) if rest >> i & 1]


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a state tree (NamedTuples and dicts, dict keys in
    sorted order)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [t for x in tree for t in leaves(x)]


def clone_state(tree):
    """A copy of a state tree with every tensor cloned."""
    return map_tree(torch.Tensor.clone, tree)


def copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the same leaf of ``dst`` (a leaf
    that already is its source is left alone)."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        if d is not s:
            d.copy_(s)


def capture(fn: Callable[[], object], pool):
    """Capture ``fn()`` into a new CUDA graph in memory pool ``pool``.

    Capture runs nothing, so the kernels' ``launches`` counters are put
    back as they were; the launches the graph recorded come back as
    ``launched`` for :func:`replay` to add on every replay.  Returns
    ``(graph, launched, out)``, ``out`` being what ``fn`` returned: the
    graph's static outputs, rewritten by each replay.  A failed capture
    raises."""
    from ..kernels.ops import KERNELS
    before = [k.launches for k in KERNELS]
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
    finally:
        recorded = [k.launches - b for k, b in zip(KERNELS, before)]
        for k, b in zip(KERNELS, before):
            k.launches = b
    launched = tuple((k, n) for k, n in zip(KERNELS, recorded) if n)
    return graph, launched, out


def replay(graph, launched) -> None:
    """Replay a graph made by :func:`capture` and count its launches."""
    graph.replay()
    for k, n in launched:
        k.launches += n


class StepGraphs:
    """Captured graphs of one engine's step variants (the ungated and gated
    conservative steps, the speculative steps; or, for a stacked state of
    replications, their stacked forms, whose flags sum over the
    replications)."""

    def __init__(self, steps: dict[Hashable, Callable[[EngineState],
                                                     EngineState]],
                 device: torch.device):
        self.steps, self.device = dict(steps), device
        #: the state every graph reads and writes (None until first use).
        self.static: EngineState | None = None
        #: the speculative steps' exclusive epoch bound, i32 [R] (one per
        #: replication; [1] for one simulation), made with the state.
        self.bound: torch.Tensor | None = None
        self._flag_fns: dict[Hashable, Callable] = {}
        self._flags: dict[Hashable, torch.Tensor] = {}
        self._pool = None
        self._graphs: dict[tuple[Hashable, int], tuple] = {}
        self._warm: set[Hashable] = set()
        #: graphs captured, graphs replayed, and eager warm-up steps run
        #: (one per step variant, on a copy of the state, before its first
        #: capture).
        self.captures = self.replays = self.warmup_steps = 0

    def add(self, variant: Hashable, step: Callable[[EngineState],
                                                    EngineState],
            flag: Callable[[EngineState], torch.Tensor] | None = None
            ) -> None:
        """Register a step variant (once) and the flag its graphs write
        (by default the events in flight)."""
        if variant not in self.steps:
            self.steps[variant] = step
            if flag is not None:
                self._flag_fns[variant] = flag

    def adopt(self, state: EngineState) -> EngineState:
        """The static state, holding ``state``'s values (copied in unless
        ``state`` already is it)."""
        if self.static is None:
            self.static = clone_state(state)
            self.bound = torch.zeros_like(self.static.epoch.reshape(-1))
        elif any(a is not b for a, b in zip(leaves(state),
                                            leaves(self.static), strict=True)):
            copy_into(self.static, state)
        return self.static

    def replay(self, variant: Hashable, length: int) -> None:
        """Advance the static state by one replay of ``length`` steps."""
        replay(*self._graph(variant, length))
        self.replays += 1

    def read(self, variant: Hashable):
        """The flag the last replay of ``variant`` wrote (a host read):
        an int, or a list for a flag of several numbers."""
        return self._flags[variant].tolist()

    def _warm_up(self, step) -> None:
        """Run ``step`` once on a copy of the static state, on a side
        stream, so that every kernel it runs is built and loaded before a
        capture."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            step(clone_state(self.static))
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.warmup_steps += 1

    def _graph(self, variant: Hashable, length: int):
        key = (variant, length)
        if key in self._graphs:
            return self._graphs[key]
        if length not in LENGTHS:
            raise ValueError(f"no graph of {length} steps (lengths "
                             f"{LENGTHS})")
        step = self.steps[variant]
        flag = self._flag_fns.get(variant, in_flight)
        if variant not in self._warm:
            self._warm_up(step)
            self._warm.add(variant)
            self._flags[variant] = flag(self.static).clone()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()

        def run():
            s = self.static
            for _ in range(length):
                s = step(s)
            copy_into(self.static, s)
            self._flags[variant].copy_(flag(s))
        graph, launched, _ = capture(run, self._pool)
        self._graphs[key] = (graph, launched)
        self.captures += 1
        return self._graphs[key]
