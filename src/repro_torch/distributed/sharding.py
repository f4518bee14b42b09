"""Sharding rules of the port (``repro/distributed/sharding.py``): logical
axes onto mesh axes, as ``torch.distributed.tensor`` (DTensor) placements.

Logical names used across the stack (the reference's)::

  batch   → ("pod", "data")   activations' leading batch dim
  vocab   → "model"           embedding / logits vocab dim
  heads   → "model"           attention heads (when divisible)
  ffn     → "model"           MLP hidden dim
  expert  → "model"           MoE expert dim
  capacity→ "data"            MoE expert-buffer capacity dim

A *spec* is the port's ``PartitionSpec``: a plain tuple with one entry per
tensor dim, each an axis name, a tuple of names or ``None``; ``()`` is
replicated at any rank.  A *mesh* is a ``DeviceMesh`` with named dims or,
where only its geometry is read (the rules, :func:`shard_shape`), a mapping
``{axis: size}``, the counterpart of the reference's ``AbstractMesh``.

The rules (:func:`params_shardings`, :func:`batch_shardings`,
:func:`replicated`, and ``serve.engine.cache_shardings``) give each leaf
the reference's spec.  Leaf paths are the port's state-dict keys
(``blocks.0.attn.wq``), matched as the reference's ``/``-joined paths
(``blocks/0/attn/wq``): the rules' substrings mean the same thing.  The
reference stacks its layers (``scan_layers``); the port's leaves are one
layer each, so a stacked leaf's spec loses its leading entry here.
:func:`to_placements` turns a spec into placements (a dim sharded over
``("pod", "data")`` is ``Shard(d)`` on both mesh dims, pod-major),
:func:`place` and :func:`place_module` distribute leaves by their specs,
:func:`shard_shape` gives a leaf's per-device shape.

:func:`use_mesh` is the port's ``with mesh:``.  Under it
:func:`ambient_mesh` returns the mesh, and a plain tensor that meets a
DTensor counts as replicated (``implicit_replication``), so the models'
positions, masks and rotary tables need no placing.  The model code calls
:func:`maybe_constraint` and :func:`use_param` where the reference does;
with no ambient mesh (or on a plain tensor) both return their input, so
one-device paths keep their bits.

Every redistribution here (:func:`redistribute`, and through it
:func:`maybe_constraint`, :func:`use_param`, :func:`full`) is
differentiable, so training runs through the same calls: fsdp's
``use_param`` gathers a weight in the forward and reduce-scatters its
gradient in the backward, and :func:`constrain` is the reference's
``with_sharding_constraint`` on a gradient (ZeRO-2).  On a gloo mesh (the
CPU tests, and two ranks sharing one card) each one goes through
:class:`_Staged`, whose all-gathers and reduce-scatters run on host
copies, forward and backward alike, so the CPU runs the card's path.
"""
from __future__ import annotations

import contextlib
import math
import sys

import torch

BATCH = ("pod", "data")
_MODE = {"value": "megatron"}
_AMBIENT: list = []


def set_mode(mode: str):
    """megatron: TP over 'model', batch over ('pod','data').
    fsdp: ZeRO-3 — params sharded over every axis on their largest divisible
    dim; batch/activations sharded over ALL axes; no tensor parallelism."""
    _MODE["value"] = mode


def get_mode() -> str:
    return _MODE["value"]


def batch_axes():
    return ("pod", "data", "model") if _MODE["value"] == "fsdp" else BATCH


def ambient_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _AMBIENT[-1] if _AMBIENT else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) ambient, the reference's ``with
    mesh:``; plain tensors meeting DTensors inside count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    _AMBIENT.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _AMBIENT.pop()


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh)


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def _size(entry, sizes: dict) -> int:
    return math.prod(sizes[n] for n in _names(entry))


def _resolve(axis, sizes: dict):
    """Map a logical spec entry onto the mesh, dropping absent axes."""
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        got = tuple(a for a in axis if a in sizes)
        return got if got else None
    return axis if axis in sizes else None


def logical(*axes) -> tuple:
    """A spec against the ambient mesh from logical entries, dropping axes
    the mesh doesn't have (``()`` without a mesh)."""
    mesh = ambient_mesh()
    if mesh is None:
        return ()
    sizes = axis_sizes(mesh)
    return tuple(_resolve(a, sizes) for a in axes)


def batch_spec() -> tuple:
    return logical(batch_axes())


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor: none exists
    before its module is imported, so one-device paths never load it)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def maybe_constraint(x, *axes):
    """Redistribute the DTensor ``x`` to the spec ``axes`` (one entry per
    dim) under an ambient mesh; the identity without one or on a plain
    tensor.  Axes the mesh lacks or that do not divide their dim are
    dropped, and the literal ``BATCH`` tuple is remapped per sharding mode
    (fsdp shards batch over every axis), as in the reference.

    Unlike the reference, a redistribution that fails raises: the
    reference's ``except Exception: return x`` around
    ``with_sharding_constraint`` (``repro/distributed/sharding.py:72-75``)
    is not copied, so a constraint that cannot hold is an error here, not
    a silent no-op."""
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return redistribute(x, to_placements(fit(x.shape, axes, mesh), mesh))


def fit(shape, axes, mesh) -> tuple:
    """The logical spec ``axes`` (one entry per dim of ``shape``) on
    ``mesh``: the literal ``BATCH`` remapped per sharding mode, axes the
    mesh lacks dropped, an entry dropped where it does not divide its
    dim."""
    sizes = axis_sizes(mesh)
    spec = []
    for dim, a in enumerate(axes):
        if isinstance(a, tuple) and a == BATCH:
            a = batch_axes()
        r = _resolve(a, sizes)
        if r is not None and shape[dim] % _size(r, sizes) != 0:
            r = None
        spec.append(r)
    return tuple(spec)


def use_param(w):
    """ZeRO-3 use-site materialization: under fsdp mode and an ambient
    mesh, a stored-sharded weight is replicated right before its product
    (the per-layer all-gather); the identity otherwise."""
    if _MODE["value"] != "fsdp":
        return w
    mesh = ambient_mesh()
    if mesh is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    return redistribute(w, [Replicate()] * mesh.ndim)


def use_params(tree):
    """:func:`use_param` of every leaf of a nest of dicts and lists (a
    block's parameters).  On a gloo mesh the DTensor leaves are gathered
    together (:class:`_GatherMany`: one staged all-gather per dtype and
    mesh dim, and one reduce-scatter in the backward), the block's
    per-layer gather, where one per weight would cost a host round trip
    each; elsewhere leaf by leaf."""
    if _MODE["value"] != "fsdp" or ambient_mesh() is None:
        return tree
    leaves = _leaves(tree)
    dts = [i for i, t in enumerate(leaves) if is_dtensor(t)]
    if not dts or not _gloo(leaves[dts[0]].device_mesh):
        return _unflatten(tree, [use_param(t) for t in leaves])
    for i, t in zip(dts, _GatherMany.apply(*(leaves[i] for i in dts))):
        leaves[i] = t
    return _unflatten(tree, leaves)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten(tree, leaves: list):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(tree)


# -- parameter sharding rules ---------------------------------------------------

_RULES = [
    # (path substring match, spec by array ndim)
    ("embed/tok", lambda nd: _pad(("model", None), nd)),
    ("embed/head", lambda nd: _pad((None, "model"), nd)),
    ("patch_proj", lambda nd: _pad((None, None), nd)),
    ("attn/wq", lambda nd: _pad((None, "model"), nd)),
    ("attn/wk", lambda nd: _pad((None, "model"), nd)),
    ("attn/wv", lambda nd: _pad((None, "model"), nd)),
    ("attn/wo", lambda nd: _pad(("model", None), nd)),
    ("attn/wdkv", lambda nd: _pad((None, None), nd)),
    ("attn/wkr", lambda nd: _pad((None, None), nd)),
    ("attn/wukv", lambda nd: _pad((None, "model"), nd)),
    ("moe/router", lambda nd: _pad((None, None), nd)),
    # expert-FSDP: experts shard over "model", the ff dim over "data".
    ("moe/wg", lambda nd: _pad(("model", None, "data"), nd)),
    ("moe/wu", lambda nd: _pad(("model", None, "data"), nd)),
    ("moe/wd", lambda nd: _pad(("model", "data", None), nd)),
    ("shared/wg", lambda nd: _pad((None, "model"), nd)),
    ("shared/wu", lambda nd: _pad((None, "model"), nd)),
    ("shared/wd", lambda nd: _pad(("model", None), nd)),
    ("mlp/wg", lambda nd: _pad((None, "model"), nd)),
    ("mlp/wu", lambda nd: _pad((None, "model"), nd)),
    ("mlp/wd", lambda nd: _pad(("model", None), nd)),
    # zamba shared attention / mlstm / mamba projections
    ("wq", lambda nd: _pad((None, "model"), nd)),
    ("wk", lambda nd: _pad((None, "model"), nd)),
    ("wv", lambda nd: _pad((None, "model"), nd)),
    ("wo", lambda nd: _pad(("model", None), nd)),
    ("wg", lambda nd: _pad((None, "model"), nd)),
    ("wu", lambda nd: _pad((None, "model"), nd)),
    ("wd", lambda nd: _pad(("model", None), nd)),
    ("wup", lambda nd: _pad((None, "model"), nd)),
    ("wdown", lambda nd: _pad(("model", None), nd)),
    ("win", lambda nd: _pad((None, "model"), nd)),
    ("wout", lambda nd: _pad(("model", None), nd)),
    ("wproj", lambda nd: _pad(("model", None), nd)),
    ("wx", lambda nd: _pad((None, "model"), nd)),
]


def _pad(spec: tuple, nd: int) -> tuple:
    """Left-pad a spec with None for leading dims (the last ``nd`` entries
    where the spec is longer)."""
    pad = nd - len(spec)
    if pad < 0:
        return spec[-nd:] if nd else ()
    return (None,) * pad + spec


def param_spec(path: str, ndim: int) -> tuple:
    for frag, builder in _RULES:
        if frag in path:
            return builder(ndim)
    return (None,) * ndim


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nest of dicts, lists, tuples and
    NamedTuples; a leaf's path joins its keys with ``/`` (a NamedTuple's
    are its field names), a dict key split at its dots (so a state-dict
    key ``blocks.0.attn.wq`` is ``blocks/0/attn/wq``, and the AdamW
    state's ``mu/blocks/0/attn/wq``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(fn, v, s) for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def params_shardings(params, mesh, mode: str | None = None):
    """The spec of every leaf of a parameter tree (a state dict, or the
    nested tree of ``weights()``; fake tensors do), megatron or fsdp.  Any
    tree of tensors takes the rules: the AdamW state's moments
    (``mu/blocks/0/attn/wq``) get their parameter's spec, its 0-d count
    ``()``."""
    mode = mode or _MODE["value"]
    sizes = axis_sizes(mesh)

    if mode == "fsdp":
        axes = tuple(a for a in ("pod", "data", "model") if a in sizes)
        size = math.prod(sizes[a] for a in axes)

        def spec_fsdp(path, leaf):
            # shard the largest divisible dim over ALL axes (ZeRO-3)
            cands = [(s, i) for i, s in enumerate(leaf.shape)
                     if s % size == 0 and s >= size]
            spec = [None] * leaf.ndim
            if cands:
                _, dim = max(cands)
                spec[dim] = axes
            return tuple(spec)

        return tree_map_with_path(spec_fsdp, params)

    def spec_for(path, leaf):
        fixed = []
        for dim, a in enumerate(param_spec(path, leaf.ndim)):
            if a is None or any(n not in sizes for n in _names(a)):
                fixed.append(None)
                continue
            fixed.append(a if leaf.shape[dim] % _size(a, sizes) == 0
                         else None)
        return tuple(fixed)

    return tree_map_with_path(spec_for, params)


def batch_shardings(batch, mesh, mode: str | None = None):
    """The batch's leading dim over ``("pod", "data")`` (fsdp: every axis)
    where it divides."""
    mode = mode or _MODE["value"]
    src = ("pod", "data", "model") if mode == "fsdp" else BATCH
    sizes = axis_sizes(mesh)
    names = tuple(a for a in src if a in sizes)

    def spec_for(path, leaf):
        if not names:
            return ()
        lead = names if leaf.shape and \
            leaf.shape[0] % _size(names, sizes) == 0 else None
        return (lead,) + (None,) * (leaf.ndim - 1)
    return tree_map_with_path(spec_for, batch)


def replicated(mesh) -> tuple:
    return ()


# -- placements ---------------------------------------------------------------

def to_placements(spec: tuple, mesh) -> list:
    """DTensor placements of a spec on ``mesh``: mesh dim ``i`` is
    ``Shard(d)`` where tensor dim ``d``'s entry names axis ``i``, else
    ``Replicate()``.  A dim over several axes must name them in the mesh's
    order: DTensor shards a dim over mesh dims major to minor in that
    order, which is the reference's ``("pod", "data")``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        if e is None:
            continue
        idx = [names.index(n) for n in _names(e)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {names[i]} shards two dims in "
                                 f"{spec}")
            out[i] = Shard(d)
    return out


def shard_shape(shape, spec: tuple, mesh) -> tuple:
    """The per-device shape of a leaf of ``shape`` under ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec):
        if e is None:
            continue
        n = _size(e, sizes)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {e} ({n})")
        out[d] //= n
    return tuple(out)


def _local_chunk(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``, as a tensor of its own."""
    coord = mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    local = t
    for d, e in enumerate(spec):
        if e is None:
            continue
        idx, n = 0, 1
        for name in _names(e):
            i = names.index(name)
            idx = idx * mesh.size(i) + coord[i]
            n *= mesh.size(i)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {e} ({n})")
        chunk = t.shape[d] // n
        local = local.narrow(d, idx * chunk, chunk)
    return local.clone(memory_format=torch.contiguous_format)


def place(tree, shardings, mesh, device=None):
    """The leaves of ``tree`` as DTensors on ``mesh`` by their specs
    (``shardings``, a tree of the same structure): each rank keeps a copy
    of its own block only (no collective; every rank holds the whole
    leaf), on ``device`` (default: the leaf's own), so a checkpoint read
    on the host moves only its block to the card."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        local = _local_chunk(t, spec, mesh)
        if device is not None:
            local = local.to(device)
        return DTensor.from_local(local, mesh,
                                  to_placements(spec, mesh), run_check=False,
                                  shape=t.shape,
                                  stride=_contiguous_stride(t.shape))
    return _zip_map(one, tree, shardings)


def place_module(module: torch.nn.Module, mesh, mode: str | None = None):
    """Replace ``module``'s parameters by DTensors placed by
    :func:`params_shardings`, each rank keeping its own block; returns the
    specs by state-dict key."""
    specs = params_shardings(dict(module.named_parameters()), mesh, mode)
    for key, spec in specs.items():
        owner, _, name = key.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        p = getattr(sub, name)
        placed = place(p.detach(), spec, mesh)
        setattr(sub, name, torch.nn.Parameter(placed,
                                              requires_grad=p.requires_grad))
    return specs


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def redistribute(t, placements):
    """``t.redistribute`` to ``placements``, differentiable.  A shard that
    moves from one tensor dim to another goes through replicate (an
    all-gather, then a local chunk) rather than DTensor's all-to-all.  On a
    gloo mesh every step goes through :class:`_Staged` (the collectives
    that gather or scatter staged through the host), on the card and on
    the CPU alike; elsewhere (NCCL, the dry run's fake group) DTensor moves
    it."""
    from torch.distributed.tensor import Replicate
    cur = list(t.placements)
    mid = [Replicate() if (c.is_shard() and p.is_shard() and c != p) else c
           for c, p in zip(cur, placements)]
    if mid != cur:
        t = _redistribute(t, mid)
    if list(t.placements) != list(placements):
        t = _redistribute(t, list(placements))
    return t


def _redistribute(t, placements):
    if not _gloo(t.device_mesh):
        return t.redistribute(t.device_mesh, placements)
    return _Staged.apply(t, tuple(placements))


def constrain(t, spec: tuple):
    """The reference's ``with_sharding_constraint(g, sh)`` on a gradient:
    the DTensor ``t`` brought to ``spec`` on its mesh, so a partial sum
    that the spec shards is reduce-scattered (ZeRO-2), one it replicates
    all-reduced; the identity on a plain tensor."""
    if not is_dtensor(t):
        return t
    return redistribute(t, to_placements(spec, t.device_mesh))


def keep_grad_layout(t):
    """``t`` unchanged; in the backward its gradient is brought to ``t``'s
    own placements (a partial one counted as replicated) before it flows
    on.  DTensor may hand a gradient a layout that the ops behind it cannot
    take (a sum over "model" scattered along the sequence, which a
    flattening reshape turns into a strided shard that a product's
    backward refuses); the identity on a plain tensor."""
    if not is_dtensor(t):
        return t
    return _KeepGradLayout.apply(t)


class _KeepGradLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.src = tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        want = [Replicate() if p.is_partial() else p for p in ctx.src]
        if list(g.placements) == want:
            return g
        return redistribute(g, want)


def _gloo(mesh) -> bool:
    import torch.distributed as dist
    return all(str(dist.get_backend(mesh.get_group(i))) == "gloo"
               for i in range(mesh.ndim))


class _Staged(torch.autograd.Function):
    """A redistribution over a gloo mesh (:func:`_move`) as an autograd
    function: its backward moves the gradient back to the input's
    placements by the same means (a partial input placement counted as
    replicated, as DTensor's own redistribution does), so the backward of
    a staged all-gather is the matching staged reduce-scatter and nothing
    after the gather is cut off from the parameter."""

    @staticmethod
    def forward(ctx, t, placements):
        ctx.src = tuple(t.placements)
        return _move(t, placements)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        want = [Replicate() if p.is_partial() else p for p in ctx.src]
        return _move(g, want), None


def _move(t, placements):
    """``t`` (a DTensor on a gloo mesh) in ``placements``, with no autograd:
    the collectives that gather or scatter (shard → replicate, partial →
    shard) each staged through a host copy of the local block, partial →
    replicate an all-reduce, replicate → shard a local chunk.  Gloo's
    all-gather of a CUDA tensor, which DTensor would issue, ends its
    process (SIGSEGV) on the records' card while its all-reduce works; so
    the port stages these, as ``core.dist.Comm`` stages all of its own.

    The shards of a tensor dim that gains a new shard are gathered first
    (innermost mesh dim first), so the new blocks are cut in mesh-dim
    order (outermost first), which is DTensor's layout of a dim sharded
    over several mesh dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = t.device_mesh
    cur, want = list(t.placements), list(placements)
    for p in cur + want:
        if p.is_partial() and not (type(p) is Partial
                                   and p.reduce_op == "sum"):
            raise NotImplementedError(f"a staged redistribution takes sums "
                                      f"only, not {p}")
    local = t.to_local()
    regain = {w.dim for c, w in zip(cur, want) if w.is_shard() and c != w}
    for i in reversed(range(mesh.ndim)):
        c = cur[i]
        if c.is_shard() and (c != want[i] or c.dim in regain):
            local = _staged_collective("gather", local, c.dim, mesh, i)
            cur[i] = Replicate()
    for i in range(mesh.ndim):
        c, w = cur[i], want[i]
        if c.is_partial() and w.is_replicate():
            local = all_reduce_dim(local.contiguous(), "sum", mesh, i)
            cur[i] = w
        elif c.is_partial() and w.is_shard():
            local = _staged_collective("reduce_scatter", local, w.dim, mesh,
                                       i)
            cur[i] = w
        elif c.is_replicate() and w.is_shard():
            n = mesh.size(i)
            local = local.chunk(n, dim=w.dim)[mesh.get_coordinate()[i]]
            cur[i] = w
        elif c != w:
            raise NotImplementedError(f"a staged redistribution from {c} to "
                                      f"{w}")
    return DTensor.from_local(local.contiguous(), mesh, cur, run_check=False,
                              shape=t.shape,
                              stride=_contiguous_stride(t.shape))


class _GatherMany(torch.autograd.Function):
    """DTensors on a gloo mesh (each sharded or replicated on every mesh
    dim) replicated together: per mesh dim, innermost first, the local
    blocks that dim shards are moved so the sharded dim leads, flattened
    and joined per dtype into one buffer, gathered in one staged
    collective and cut apart (:func:`_staged_many`).  Backward: per mesh
    dim, outermost first, the gradients' partial sums are reduce-scattered
    the same way, joined, and a replicated gradient cut locally to its
    block; whatever else a gradient's layout needs goes through
    :func:`_move`, leaf by leaf."""

    @staticmethod
    def forward(ctx, *ts):
        from torch.distributed.tensor import Replicate
        mesh = ts[0].device_mesh
        ctx.src = [tuple(t.placements) for t in ts]
        ctx.shapes = [t.shape for t in ts]
        local = [t.to_local() for t in ts]
        cur = [list(t.placements) for t in ts]
        for i in reversed(range(mesh.ndim)):
            js = [j for j in range(len(ts)) if cur[j][i].is_shard()]
            for j, got in zip(js, _staged_many(
                    "gather", [local[j] for j in js],
                    [cur[j][i].dim for j in js], mesh, i)):
                local[j], cur[j][i] = got, Replicate()
        return tuple(_dtensor(x, mesh, [Replicate()] * mesh.ndim, t.shape)
                     for x, t in zip(local, ts))

    @staticmethod
    def backward(ctx, *gs):
        from torch.distributed.tensor import Partial, Replicate
        live = [j for j, g in enumerate(gs) if g is not None]
        if not live:
            return gs
        mesh = gs[live[0]].device_mesh
        local = {j: gs[j].to_local() for j in live}
        cur = {j: list(gs[j].placements) for j in live}
        for i in range(mesh.ndim):
            js = [j for j in live if ctx.src[j][i].is_shard()
                  and type(cur[j][i]) is Partial
                  and cur[j][i].reduce_op == "sum"]
            for j, got in zip(js, _staged_many(
                    "reduce_scatter", [local[j] for j in js],
                    [ctx.src[j][i].dim for j in js], mesh, i)):
                local[j], cur[j][i] = got, ctx.src[j][i]
            for j in live:
                if ctx.src[j][i].is_shard() and cur[j][i].is_replicate():
                    d = ctx.src[j][i].dim
                    local[j] = local[j].chunk(mesh.size(i), dim=d)[
                        mesh.get_coordinate()[i]].contiguous()
                    cur[j][i] = ctx.src[j][i]
        out = list(gs)
        for j in live:
            g = _dtensor(local[j], mesh, cur[j], ctx.shapes[j])
            want = [Replicate() if p.is_partial() else p
                    for p in ctx.src[j]]
            out[j] = g if cur[j] == want else _move(g, want)
        return tuple(out)


def _dtensor(local, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def _staged_many(kind: str, locals_: list, dims: list, mesh, i: int) -> list:
    """:func:`_staged_collective` of several tensors at once, along their
    own ``dims``, over mesh dim ``i``: one collective per dtype, on the
    tensors' blocks flattened and joined (rank-major for a
    reduce-scatter, so each rank's share of every tensor comes out
    together)."""
    n = mesh.size(i)
    out = [None] * len(locals_)
    for dtype in dict.fromkeys(t.dtype for t in locals_):
        js = [j for j, t in enumerate(locals_) if t.dtype == dtype]
        blocks = [locals_[j].movedim(dims[j], 0) for j in js]
        if kind == "gather":
            flat = torch.cat([b.reshape(-1) for b in blocks])
        else:
            flat = torch.cat([b.reshape(n, -1) for b in blocks], 1)
        got = _staged_collective(kind, flat.reshape(-1), 0, mesh, i)
        rows = got.reshape(n, -1) if kind == "gather" else got.reshape(1, -1)
        off = 0
        for j, b in zip(js, blocks):
            lead = b.shape[0] if kind == "gather" else b.shape[0] // n
            size = lead * math.prod(b.shape[1:])
            part = rows[:, off:off + size].reshape(
                (rows.shape[0] * lead,) + tuple(b.shape[1:]))
            out[j] = part.movedim(0, dims[j]).contiguous()
            off += size
    return out


def _staged_collective(kind: str, local, dim: int, mesh, i: int):
    """An all-gather (``"gather"``) or a reduce-scatter (sums,
    ``"reduce_scatter"``) of ``local`` along ``dim`` over mesh dim ``i``,
    run on host copies: the dim leads on the host, so each copy is one
    block each way, through pinned buffers from a card."""
    import torch.distributed as dist
    # (``all_gather_into_tensor`` and ``reduce_scatter_tensor`` are named
    # ``all_gather_single`` and ``reduce_scatter_single`` in newer torch)
    if kind == "gather":
        op = getattr(dist, "all_gather_single", None) or \
            dist.all_gather_into_tensor
    else:
        op = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
    cuda = local.is_cuda
    block = local.movedim(dim, 0).contiguous()
    host = torch.empty(block.shape, dtype=block.dtype, pin_memory=cuda)
    host.copy_(block)
    n = mesh.size(i)
    lead = block.shape[0] * n if kind == "gather" else block.shape[0] // n
    got = torch.empty((lead,) + block.shape[1:], dtype=block.dtype,
                      pin_memory=cuda)
    op(got, host, group=mesh.get_group(i))
    return got.to(local.device, non_blocking=cuda).movedim(0, dim)


def full(t) -> torch.Tensor:
    """The whole of a DTensor on every rank (a plain tensor)."""
    from torch.distributed.tensor import Replicate
    return redistribute(t, [Replicate()] * t.device_mesh.ndim).to_local()


def wrap(local: torch.Tensor, like, placements, shape):
    """``local`` (made contiguous) as a DTensor of global ``shape`` on
    ``like``'s mesh."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), like.device_mesh,
                              placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def aligned(t, dim: int, groups: int):
    """``t`` with ``dim`` replicated over the mesh dims that shard it into
    blocks that cut one of ``groups`` equal groups (a head); the identity
    on a plain tensor or where the blocks align."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    dim %= t.ndim
    mesh = t.device_mesh
    on = [i for i, p in enumerate(t.placements)
          if p.is_shard() and p.dim == dim]
    if groups % math.prod(mesh.size(i) for i in on) == 0:
        return t
    return redistribute(t, [Replicate() if i in on else p
                            for i, p in enumerate(t.placements)])


def rank_on(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (0 where the mesh lacks it)."""
    if axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def all_reduce(t: torch.Tensor, op: str, mesh, axis: str) -> torch.Tensor:
    """A functional all-reduce (``"sum"`` or ``"max"``) of a local tensor
    over ``axis``'s mesh dim (what the counter and the tracer see as a
    ``_c10d_functional`` collective)."""
    return all_reduce_dim(t, op, mesh, mesh.mesh_dim_names.index(axis))


def all_reduce_dim(t: torch.Tensor, op: str, mesh, i: int) -> torch.Tensor:
    """:func:`all_reduce` over mesh dim ``i``."""
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, i)))


def all_gather_dim(t: torch.Tensor, dim: int, mesh, i: int) -> torch.Tensor:
    """The local tensors ``t`` of mesh dim ``i``'s ranks joined along
    ``dim`` in rank order; through the host on a gloo mesh
    (:func:`_staged_collective`), a functional all-gather elsewhere."""
    if mesh.size(i) == 1:
        return t
    dim %= t.ndim
    if _gloo(mesh):
        return _staged_collective("gather", t, dim, mesh, i)
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_gather_tensor(t.contiguous(), dim,
                                                       (mesh, i)))


def reduce_scatter_dim(t: torch.Tensor, dim: int, mesh,
                       i: int) -> torch.Tensor:
    """The sum of mesh dim ``i``'s local tensors ``t``, this rank's block
    of it along ``dim``; staged like :func:`all_gather_dim`."""
    if mesh.size(i) == 1:
        return t
    dim %= t.ndim
    if _gloo(mesh):
        return _staged_collective("reduce_scatter", t, dim, mesh, i)
    import torch.distributed._functional_collectives as funcol
    return funcol.wait_tensor(funcol.reduce_scatter_tensor(
        t.contiguous(), "sum", dim, (mesh, i)))


def sum_over(t: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``t`` all-reduced (summed) over each mesh dim of ``dims`` wider than
    one rank."""
    for i in dims:
        if mesh.size(i) > 1:
            t = all_reduce_dim(t.contiguous(), "sum", mesh, i)
    return t


def gather_over(t: torch.Tensor, dim: int, mesh, dims) -> torch.Tensor:
    """``t`` all-gathered along ``dim`` over the mesh dims ``dims`` (in
    mesh order, the layout of a dim they shard together), innermost
    first."""
    for i in sorted(dims, reverse=True):
        t = all_gather_dim(t, dim, mesh, i)
    return t


def gather_many(ts, dim: int, mesh, dims) -> list:
    """Tensors that share their leading dim and their dim ``dim`` (this
    rank's block of a dim the mesh dims ``dims`` split, a block of heads)
    all-gathered along ``dim`` in one collective, in f32."""
    if not any(mesh.size(i) > 1 for i in dims):
        return [t.float() for t in ts]
    flat = [t.movedim(dim, 1).float() for t in ts]
    lead, n = flat[0].shape[:2]
    got = gather_over(torch.cat([f.reshape(lead, n, -1) for f in flat], -1),
                      1, mesh, dims)
    out, off = [], 0
    for f in flat:
        width = math.prod(f.shape[2:])
        out.append(got[..., off:off + width].reshape(
            (lead, got.shape[1]) + tuple(f.shape[2:])).movedim(1, dim))
        off += width
    return out


def batch_placements(t) -> list:
    """The placements of a tensor laid out as the DTensor ``t``'s leading
    dim (the batch): ``Shard(0)`` where ``t`` shards that dim, replicated
    elsewhere, so every other dim is whole on each rank."""
    from torch.distributed.tensor import Replicate
    return [p if p.is_shard() and p.dim == 0 else Replicate()
            for p in t.placements]


def batch_local(t) -> torch.Tensor:
    """This rank's rows of the DTensor ``t`` with every other dim whole
    (gathered or reduced where ``t`` shards or sums it), a plain
    tensor."""
    want = batch_placements(t)
    if list(t.placements) != want:
        t = redistribute(t, want)
    return t.to_local()


def as_batch(local: torch.Tensor, like):
    """``local`` (this rank's rows, every other dim whole) as a DTensor in
    the batch layout of ``like`` (:func:`batch_placements`), its leading
    dim ``like``'s."""
    return wrap(local, like, batch_placements(like),
                (like.shape[0],) + tuple(local.shape[1:]))


def own_block(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's block of ``full``, a tensor laid out as the DTensor
    ``like`` but holding this rank's rows only and every other dim whole:
    ``full`` cut along each non-leading dim that ``like`` shards."""
    local = like.to_local()
    for d in range(1, like.ndim):
        if shard_dims(like, d):
            full = full.narrow(d, block_start(like, d), local.shape[d])
    return full


def write_block(state, full: torch.Tensor) -> None:
    """Write this rank's block of ``full`` (:func:`own_block`) into the
    DTensor ``state`` in place."""
    state.to_local().copy_(own_block(full, state))


def local_weight(w) -> tuple:
    """(this rank's block of the DTensor weight ``w`` [n_in, n_out], its
    first row and first column in the whole).  A plain tensor is its own
    block at (0, 0)."""
    if not is_dtensor(w):
        return w, 0, 0
    return w.to_local(), block_start(w, 0), block_start(w, 1)


def whole(w) -> torch.Tensor:
    """The whole of ``w`` (a DTensor, gathered where it is sharded, or a
    plain tensor) as a plain tensor."""
    return full(w) if is_dtensor(w) else w


def column_product(x: torch.Tensor, w) -> torch.Tensor:
    """``x [..., n_in] @ w`` with every column of the weight ``w`` [n_in,
    n_out] (a DTensor, its columns sharded or not) on every rank: where
    the product's rows are fewer than ``n_in`` each rank multiplies by its
    own columns and the products are all-gathered, else the weight is
    gathered first; either way the smaller of the two moves."""
    if not is_dtensor(w):
        return x @ w
    dims = shard_dims(w, 1)
    rows = x.numel() // x.shape[-1]
    if dims and rows < w.shape[0] and not shard_dims(w, 0):
        return gather_over(x @ w.to_local(), -1, w.device_mesh, dims)
    return x @ whole(w)


def row_product(y: torch.Tensor, y0: int, w,
                reduce: bool = True) -> torch.Tensor:
    """The product of a row-parallel weight ``w`` [n_in, n_out] (a
    DTensor, its rows sharded or not) with ``y`` [..., n], which holds the
    input indices ``y0 .. y0 + n`` (its rank's heads, or all of them):
    each rank multiplies the rows it holds and the partial products are
    summed over the mesh dims that shard the rows (the Megatron
    all-reduce; ``reduce`` False leaves the partial sum to the caller).
    ``w``'s block must lie inside ``y``'s range."""
    wl, r0, _ = local_weight(w)
    if r0 < y0 or r0 + wl.shape[0] > y0 + y.shape[-1]:
        raise ValueError(f"rows {r0}..{r0 + wl.shape[0]} of the weight are "
                         f"not in the input's {y0}..{y0 + y.shape[-1]}")
    out = y[..., r0 - y0:r0 - y0 + wl.shape[0]] @ wl
    if not is_dtensor(w) or not reduce:
        return out
    return sum_over(out, w.device_mesh, shard_dims(w, 0))


def head_split(w, dim: int, n_heads: int) -> tuple:
    """(first head, heads) of this rank's block of the DTensor ``w`` along
    ``dim``, where the mesh dims that shard it cut it into whole heads of
    ``n_heads`` equal groups; ``(0, n_heads)`` where nothing shards it or
    its blocks cut a head (every rank then computes every head)."""
    if not is_dtensor(w) or not shard_dims(w, dim):
        return 0, n_heads
    mesh = w.device_mesh
    n = math.prod(mesh.size(i) for i in shard_dims(w, dim))
    if n_heads % n:
        return 0, n_heads
    hl = n_heads // n
    return block_start(w, dim) // (w.shape[dim] // n_heads), hl


def shard_dims(t, dim: int) -> list:
    """The mesh dims that shard dim ``dim`` of the DTensor ``t``, in mesh
    order."""
    dim %= t.ndim
    return [i for i, p in enumerate(t.placements)
            if p.is_shard() and p.dim == dim]


def block_start(t, dim: int) -> int:
    """The global index along ``dim`` of the first element of this rank's
    block of the DTensor ``t`` (0 where no mesh dim shards it)."""
    mesh, coord = t.device_mesh, t.device_mesh.get_coordinate()
    idx = 0
    for i in shard_dims(t, dim):
        idx = idx * mesh.size(i) + coord[i]
    return idx * t.to_local().shape[dim]


def local_rows(t, i: int, k: int):
    """The ``i``-th of ``k`` equal parts of every rank's block of ``t``
    along dim 0, as a DTensor of ``1/k`` of ``t``'s rows in ``t``'s
    placements (no collective); a plain tensor's ``i``-th part.  A
    microbatch of a batch sharded over its rows: each rank's own rows, cut
    in order."""
    if not is_dtensor(t):
        n = t.shape[0] // k
        return t[i * n:(i + 1) * n]
    local = t.to_local()
    n = local.shape[0] // k
    return wrap(local[i * n:(i + 1) * n], t, t.placements,
                (t.shape[0] // k,) + tuple(t.shape[1:]))


def prefix_counts(counts: torch.Tensor, mesh, dims) -> torch.Tensor:
    """The sum of ``counts`` (a local [E] tensor) over the ranks before
    this one along the mesh dims ``dims`` together (mesh order, the first
    outermost): the offset of this rank's block in an order that is
    rank-major over them (the batch over ``("pod", "data")``).  One
    all-gather of ``counts`` per mesh dim."""
    dims = sorted(i for i in dims if mesh.size(i) > 1)
    if not dims:
        return torch.zeros_like(counts)
    every = gather_over(counts[None], 0, mesh, dims)         # [n, E]
    coord, idx = mesh.get_coordinate(), 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return every[:idx].sum(0)


def refuse_unported(cfg, kind: str) -> None:
    """Refuse by name what does not run over a mesh yet: training
    (``kind`` ``"train"``) of every family but the dense decoders (ROADMAP
    A21).  Every family serves (``"prefill"``, ``"decode"``)."""
    if kind == "train" and (cfg.family != "dense" or cfg.use_mla
                            or cfg.n_experts):
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family} family over a mesh "
            f"(MoE's expert-parallel backward, MLA, zamba2's and xLSTM's "
            f"train steps) is not ported yet (ROADMAP A21)")
