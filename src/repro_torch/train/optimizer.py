"""AdamW with a global-norm clip and a warmup-cosine schedule, port of
``repro/train/optimizer.py``: the reference's math, step for step, on
trees of tensors (a tensor, or nested dicts and NamedTuples of them).

The state mirrors the parameters leaf for leaf.  ``mu`` and ``nu`` are
kept in f32 from the start: the reference makes them in the parameters'
dtype and its first update returns them in f32 (``b1 * m + (1 - b1) * g``
with g in f32), so for bf16 masters the two differ only in dtype until
then, never in value.  ``count`` is an int32 0-d tensor on the device; the
bias corrections and the learning rate are computed from it on the device,
so an update reads nothing on the host.  :func:`update` works in place: the
moments and the parameters are overwritten, leaf by leaf, each parameter
kept in its own dtype.

Over a device mesh (DTensor parameters, ``distributed.sharding``) the
moments take their parameter's placements (:func:`init`, or a checkpoint
restored with the rules' specs), a gradient is brought to its
parameter's placements first, each leaf's sum of squares is reduced to a
replicated scalar before the global norm sums them, and the update then
runs on each rank's local blocks with no collective.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..core.pipeline.base import map_tree
from ..distributed.sharding import is_dtensor, redistribute


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


def tree_items(tree, prefix: str = "", leaf=None) -> list:
    """(path, tensor) of every leaf of a tree, in its own order: dicts in
    their key order, NamedTuples by field name, lists and tuples by index
    (``"blocks.0.attn.wq"``, ``"mu.embed.tok"``); a lone tensor's path is
    ``""``.  ``leaf(node)`` true makes a node a leaf (a tree of specs)."""
    if isinstance(tree, torch.Tensor) or (leaf is not None and leaf(tree)):
        return [(prefix[:-1], tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    return [kv for k, v in items
            for kv in tree_items(v, f"{prefix}{k}.", leaf)]


def tree_leaves(tree) -> list:
    """The tensors of a tree, in :func:`tree_items` order."""
    return [t for _, t in tree_items(tree)]


def init(params) -> AdamWState:
    """Zero moments in f32 shaped (and, over a mesh, placed) as
    ``params``, and a count of 0 on the parameters' device."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    dev = tree_leaves(params)[0].device
    return AdamWState(map_tree(zeros, params), map_tree(zeros, params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def schedule(step, tcfg):
    """Linear warmup to ``learning_rate`` over ``warmup_steps``, then a
    cosine decay to a tenth of it at ``total_steps`` (f32, on ``step``'s
    device)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(tcfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tcfg.warmup_steps)
                       / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares in f32.
    A DTensor leaf's sum is reduced over the mesh to a plain replicated
    scalar first, the leaves of one layout together (one collective for
    all of them), so the norm is a plain 0-d tensor, the same on every
    rank."""
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    groups = {}
    for i, s in enumerate(sq):
        if is_dtensor(s):
            groups.setdefault(tuple(s.placements), []).append(i)
    for placements, idx in groups.items():
        from torch.distributed.tensor import DTensor
        mesh = sq[idx[0]].device_mesh
        part = DTensor.from_local(torch.stack([sq[i].to_local()
                                               for i in idx]),
                                  mesh, placements, run_check=False)
        for i, v in zip(idx, _local(_replicated(part)).unbind(0)):
            sq[i] = v
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _replicated(t):
    """A DTensor replicated on its mesh (partial sums reduced)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return redistribute(t, [Replicate()] * t.device_mesh.ndim)


def _as_param(g, p):
    """The gradient ``g`` in its parameter's placements (a partial sum
    reduced, a replicated one cut to the parameter's block)."""
    if is_dtensor(g) and list(g.placements) != list(p.placements):
        return redistribute(g, list(p.placements))
    return g


def _clip_scale(gn, max_norm):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """(grads scaled so that their global norm is at most ``max_norm``, the
    global norm before); each leaf scaled in its own dtype."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return map_tree(lambda g: g * scale.to(g.dtype), grads), gn


def update(grads, state: AdamWState, params, tcfg, agree=None):
    """One AdamW step, in place → (params, new state, metrics
    ``{"grad_norm", "lr"}`` as 0-d device tensors).

    The gradients are clipped by their global norm (``tcfg.grad_clip``),
    then per leaf, in f32: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2)
    g g``, ``p -= lr (m̂ / (sqrt(v̂) + eps) + wd p)`` with the bias-corrected
    moments.  ``mu``, ``nu`` and ``params`` are overwritten leaf by leaf (a
    leaf's temporaries are freed before the next), ``grads`` are only read;
    the count is a new tensor.  The four trees are matched leaf by leaf by
    path (:func:`tree_items`), in the parameters' order.  ``agree`` (a
    supervisor's, over a mesh) is called after the update's last
    collective and before its first write; it raises where another rank
    failed, and then nothing is written."""
    paths = [k for k, _ in tree_items(params)]
    flat = []
    for what, tree in (("gradients", grads), ("parameters", params),
                       ("mu", state.mu), ("nu", state.nu)):
        d = dict(tree_items(tree))
        if sorted(d) != sorted(paths):
            raise ValueError(f"update: the {what} are not shaped as the "
                             f"parameters ({sorted(set(d) ^ set(paths))[:4]}"
                             f" differ)")
        flat.append([d[k] for k in paths])
    flat_g, flat_p, flat_m, flat_v = flat
    flat_g = [_as_param(g, p) for g, p in zip(flat_g, flat_p)]
    gn = global_norm(flat_g)
    scale = _clip_scale(gn, tcfg.grad_clip)
    count = state.count + 1
    c = _local(count).float()
    lr = schedule(c, tcfg)
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    bc1 = 1 - torch.pow(b1, c)
    bc2 = 1 - torch.pow(b2, c)
    if agree is not None:
        agree()
    with torch.no_grad():
        for leaf in zip(flat_g, flat_m, flat_v, flat_p):
            g, m, v, p = map(_local, leaf)
            # the reference's jitted ``(g * scale.astype(g.dtype))
            # .astype(f32)``: XLA keeps the product of a bf16 gradient in
            # f32, rounding only the scale to the gradient's dtype.
            g = g.float() * scale.to(g.dtype).float()
            pf = p.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            step_val = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * pf
            p.copy_(pf - lr * step_val)
    return params, AdamWState(state.mu, state.nu, count), {
        "grad_norm": gn, "lr": lr}
