"""State carried between the JAX package and the port.

PHOLD has no weights: its "weights" are the object state and the calendar.
:func:`engine_state_from_numpy` turns a JAX ``EngineState`` whose leaves
were fetched to the host (``jax.device_get``: numpy arrays, u32 seeds) into
the port's :class:`~repro_torch.core.pipeline.base.EngineState` on a given
device, so both engines can continue from the same mid-run state;
:func:`engine_state_to_numpy` goes the other way.  The input is read by
field name only, so this module imports nothing of the JAX package.  A
stacked state of R replications (the JAX ``init_replicated`` /
``run_replicated_drained`` carry, every leaf with a leading R) crosses the
same way: both packages lay it out alike, so no leaf changes shape.

A state of the JAX engine run over D devices is global: every leaf is the
D devices' shards concatenated along dim 0 (``cal`` [D * n_local_max, ...],
``epoch`` and each Stats field [D], ``bounds`` [D, D + 1]).
:func:`split_engine_state` cuts such a host tree into the D per-rank
states of the port's engine (rank r's leaves are shard r), and
:func:`join_engine_states` concatenates them back, so that the two engines
can be compared rank by rank and leaf by leaf.  A stack of R replications
over D devices (the JAX ``drain_replicated`` carry under a D-device mesh,
``[R, D * n_local, ...]``) splits and joins along dim 1 (``axis=1``), and
a stack laid over W devices by ``rep_shards`` into W slices of R / W
replications along dim 0.

Dtypes: seeds become int64 in the port (u32 again on the way back); the
``Stats`` counters become int64 (the JAX engine keeps int32 unless x64 is
on); every other leaf keeps its dtype.

:func:`zamba_params_from_numpy` and :func:`decoder_params_from_numpy` turn
the JAX ``Zamba.init`` and ``DecoderLM.init`` parameter trees, fetched to
the host, into state dicts of the port's models, keyed by the tree's paths.
:func:`caches_from_numpy` carries a serving state across as well: the JAX
models' caches, fetched to the host, as the port's; :func:`caches_to_numpy`
goes the other way, so that both packages can decode on from the same
mid-decode state.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.calendar import Calendar, Fallback
from .core.device import resolve_device
from .core.events import EventBatch
from .core.pipeline.base import EngineState, Stats
from .models.layers import DTYPES


def _to(a, device, dtype=None) -> torch.Tensor:
    a = np.array(a, copy=True)   # writable, and owned by the new tensor
    if dtype is not None:
        a = a.astype(dtype)
    return torch.from_numpy(a).to(device)


def engine_state_from_numpy(tree, device="cuda") -> EngineState:
    """A host copy of a JAX ``EngineState`` (one simulation or a stack of
    replications) → the port's ``EngineState``."""
    dev = resolve_device(device)
    seed = lambda a: _to(np.asarray(a, np.uint32), dev, np.int64)  # noqa: E731
    cal = Calendar(ts=_to(tree.cal.ts, dev), seed=seed(tree.cal.seed),
                   payload=_to(tree.cal.payload, dev), cnt=_to(tree.cal.cnt, dev))
    e = tree.fb.events
    fb = Fallback(EventBatch(dst=_to(e.dst, dev), ts=_to(e.ts, dev),
                             seed=seed(e.seed), payload=_to(e.payload, dev),
                             valid=_to(e.valid, dev, np.bool_)))
    obj = {k: _to(v, dev) for k, v in tree.obj.items()}
    stats = Stats(*(_to(getattr(tree.stats, k), dev, np.int64)
                    for k in Stats._fields))
    return EngineState(cal, fb, obj, epoch=_to(tree.epoch, dev), stats=stats,
                       bounds=_to(tree.bounds, dev), load=_to(tree.load, dev))


def engine_state_to_numpy(state: EngineState) -> EngineState:
    """The port's ``EngineState`` → the same tree of numpy arrays, with the
    JAX package's dtypes for seeds (u32)."""
    np_ = lambda t: t.detach().cpu().numpy()  # noqa: E731
    seed = lambda t: np_(t).astype(np.uint32)  # noqa: E731
    c, e = state.cal, state.fb.events
    return EngineState(
        cal=Calendar(np_(c.ts), seed(c.seed), np_(c.payload), np_(c.cnt)),
        fb=Fallback(EventBatch(np_(e.dst), np_(e.ts), seed(e.seed),
                               np_(e.payload), np_(e.valid))),
        obj={k: np_(v) for k, v in state.obj.items()},
        epoch=np_(state.epoch),
        stats=Stats(*(np_(v) for v in state.stats)),
        bounds=np_(state.bounds), load=np_(state.load))


def _numpy_tree(tree) -> EngineState:
    """A JAX or port ``EngineState`` of host arrays, read by field name, as
    the port's ``EngineState`` of numpy arrays."""
    e = tree.fb.events
    return EngineState(
        cal=Calendar(*(np.asarray(getattr(tree.cal, f))
                       for f in Calendar._fields)),
        fb=Fallback(EventBatch(*(np.asarray(getattr(e, f))
                                 for f in EventBatch._fields))),
        obj={k: np.asarray(v) for k, v in tree.obj.items()},
        epoch=np.asarray(tree.epoch),
        stats=Stats(*(np.asarray(getattr(tree.stats, f))
                      for f in Stats._fields)),
        bounds=np.asarray(tree.bounds), load=np.asarray(tree.load))


def split_engine_state(tree, n_devices: int, axis: int = 0
                       ) -> list[EngineState]:
    """A host copy of a D-device engine state (global leaves) → the D
    per-rank states (numpy), each leaf cut into D equal shards along
    ``axis``: 0 for one simulation, 1 for a stack of replications over D
    devices (``[R, D * n_local, ...]`` → D ranks' ``[R, n_local, ...]``);
    and along 0 for a stack's W ``rep_shards`` slices of R / W."""
    g = _numpy_tree(tree)
    shards = [[] for _ in range(n_devices)]
    for leaf in numpy_leaves(g):
        for r, part in enumerate(np.split(leaf, n_devices, axis=axis)):
            shards[r].append(part)
    return [_rebuild(g, parts) for parts in shards]


def join_engine_states(states, axis: int = 0) -> EngineState:
    """The per-rank states (numpy, in rank order) → the global state, each
    leaf's shards concatenated along ``axis`` (as split)."""
    trees = [_numpy_tree(s) for s in states]
    cols = zip(*(numpy_leaves(t) for t in trees))
    return _rebuild(trees[0], [np.concatenate(c, axis=axis) for c in cols])


def numpy_leaves(tree) -> list:
    """The arrays of a tree of numpy arrays (NamedTuples and dicts, dict
    keys in sorted order)."""
    if isinstance(tree, np.ndarray):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in numpy_leaves(tree[k])]
    return [x for t in tree for x in numpy_leaves(t)]


def _rebuild(tree, new: list):
    it = iter(new)

    def walk(node):
        if isinstance(node, np.ndarray):
            return next(it)
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return type(node)(*(walk(x) for x in node))
    return walk(tree)


def _flatten(tree) -> dict:
    """Nested dicts and lists of arrays → ``{"a.0.b": tensor}`` on the CPU."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = torch.from_numpy(np.array(node, copy=True))

    walk("", tree)
    return out


def zamba_params_from_numpy(tree) -> dict:
    """A host copy of the JAX zamba parameter tree (nested dicts and the
    ``blocks`` list) → ``{"embed.tok": tensor, "blocks.0.win": ..., ...}``
    on the CPU, for ``Zamba.load_state_dict`` (which copies to the model's
    device)."""
    return _flatten(tree)


def decoder_params_from_numpy(tree, cfg) -> dict:
    """A host copy of the JAX ``DecoderLM`` parameter tree → a state dict of
    the port's :class:`~repro_torch.models.transformer.DecoderLM`
    (``blocks.3.attn.wq``, ...).  Under ``cfg.scan_layers`` the JAX blocks
    are one tree whose leaves carry a leading layer axis; it is unstacked
    into one entry per layer."""
    def layer(node, i):
        return ({k: layer(v, i) for k, v in node.items()}
                if isinstance(node, dict) else node[i])

    blocks = tree["blocks"]
    if cfg.scan_layers:
        blocks = [layer(blocks, i) for i in range(cfg.n_layers)]
    return _flatten({**tree, "blocks": blocks})


def caches_from_numpy(tree, cfg, device="cuda"):
    """A host copy of a JAX model's serving caches (``init_cache``,
    ``prefill``, ``decode_step``) → the port's, on ``device``: for the
    hybrid family ``{"mamba": [{"conv", "h"}], "attn": [{"k", "v"}]}``, for
    the dense family one ``{"k", "v"}`` per layer, the leading layer axis
    of a ``scan_layers`` stack unstacked.  Every leaf takes the port's
    dtype: the compute dtype, except the SSM state ``h`` (f32)."""
    dev = resolve_device(device)
    cdt = DTYPES[cfg.dtype]

    def leaf(a, name):
        a = torch.from_numpy(np.array(a, np.float32))
        return a.to(dev, torch.float32 if name == "h" else cdt)

    def part(layers):
        return [{k: leaf(v, k) for k, v in d.items()} for d in layers]
    if cfg.family == "hybrid":
        return {p: part(tree[p]) for p in ("mamba", "attn")}
    if isinstance(tree, dict):            # the scan_layers stack
        tree = [{k: v[i] for k, v in tree.items()}
                for i in range(cfg.n_layers)]
    return part(tree)


def caches_to_numpy(caches, cfg):
    """The port's serving caches → the JAX model's layout as f32 numpy
    arrays (a dense ``scan_layers`` model's stacked along a leading layer
    axis); cast them to the JAX cache's dtype on the way in."""
    def part(layers):
        return [{k: v.detach().float().cpu().numpy() for k, v in d.items()}
                for d in layers]
    if cfg.family == "hybrid":
        return {p: part(caches[p]) for p in ("mamba", "attn")}
    layers = part(caches)
    if cfg.scan_layers:
        return {k: np.stack([d[k] for d in layers]) for k in ("k", "v")}
    return layers
