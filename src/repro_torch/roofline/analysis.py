"""Roofline analysis of the port on one NVIDIA H100 (``repro/roofline/
analysis.py``, with the card's rates in place of the TPU's).

Three terms per (arch x shape x mesh)::

    compute    = FLOPs / (cards * HW["peak_flops"])        [bf16 dense]
    memory     = bytes / HW["hbm_bw"]                       [per card]
    collective = collective bytes per card / HW["link_bw"]  [NVLink]

The FLOPs come from :class:`FlopCounter`, a ``TorchDispatchMode`` that
walks the aten ops a step dispatches the way the reference's
``jaxpr_flops`` walks the equations of a jaxpr:

* products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution`` and
  the other ops of ``torch.utils.flop_counter.flop_registry``) by that
  registry's formulas, 2·m·n·k, as ``_dot_flops`` counts a
  ``dot_general`` (a grouped convolution by its true work: the reference's
  ``_conv_flops`` divides by the group count twice; no model has one);
* :data:`ZERO_COST` (views, copies, casts, indexing, compares, selects,
  sort / top-k, random draws) as nothing, the reference's ``_ZERO_COST``;
* :data:`TRANSCENDENTAL` ops four per output element;
* every other op one per output element.

Layers run unrolled, so nothing is multiplied by a trip count; under
``torch.utils.checkpoint`` the backward's recompute dispatches its ops
again and is counted as it runs, the counterpart of "remat recompute
counted".  The counter keeps the products (``dot``) apart from the rest
(``rest``): ``torch.utils.flop_counter.FlopCounterMode`` counts only the
first.

A kernel counts as the work of its plain version
(``kernels.counting.counted_as``): ``kernels/ops.py``'s ``mha`` and
``ssd`` report to every active counter the ops their plain twins dispatch
for the same call (run on meta tensors, so nothing is computed) and hide
the call's own ops, on every device; the storages the call allocates
still count as live.  So a run on the card counts what a fake pass on the
CPU counts, and ``attn_impl="pallas"`` counts the products ``"jnp"``
counts; their rest differs by the elementwise ops in which the kernel's
plain twin (``flash_attention.attention_ref``, one softmax) and the
``"jnp"`` attention (``layers.attn_chunked``, an online softmax over key
chunks) split the same work.  The reference's counter enters a
``pallas_call``'s body once and so counts one tile of its grid (ROADMAP
C11); the port does not copy that.

The counter also tallies the bytes each op reads and writes (each input
and output once, a broadcast dim once; views and ``empty`` aside; the
eager ops, unfused: the reference's "bytes accessed" is XLA's count over
fused HLO), the live bytes the step allocates and
their peak, and the ``torch.distributed`` collectives the step issues, by
the reference's names.
"""
from __future__ import annotations

import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from ..distributed.sharding import is_dtensor
from ..kernels import counting

#: the card of the records, as ``nvidia-smi --query-gpu=name,power.limit
#: --format=csv,noheader`` prints it; every rate below is its data sheet's.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"

#: NVIDIA H100 SXM (the records' card, :data:`CARD`), NVIDIA's data sheet,
#: dense rates without sparsity, at the full 700 W power limit.
HW = {
    "peak_flops": 989e12,   # bf16 / fp16 tensor-core FLOP/s per card
    "f32_flops": 67e12,     # f32 FLOP/s outside the tensor cores
    "hbm_bw": 3.35e12,      # HBM3 bytes/s per card
    "link_bw": 450e9,       # NVLink 4 bytes/s per direction (900 GB/s both)
}

#: the reference's ``_TRANSCENDENTAL``, by aten name: four per element.
TRANSCENDENTAL = frozenset({"exp", "log", "log1p", "tanh", "sigmoid", "erf",
                            "sin", "cos", "rsqrt", "sqrt", "pow", "exp2"})

#: views, allocations without a value and queries (``prim.device``): no
#: FLOPs and no bytes.
_VIEWS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "t", "transpose",
    "permute", "expand", "unsqueeze", "squeeze", "select", "slice", "split",
    "split_with_sizes", "unbind", "as_strided", "alias", "detach",
    "lift_fresh", "view_as", "diagonal", "narrow", "unfold", "empty",
    "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "_local_scalar_dense", "resize", "set", "device"})

#: the reference's ``_ZERO_COST``, by aten name (views, copies and casts,
#: concatenation and padding, gathers and scatters, fills and ``arange``,
#: compares and logic, selects and clamps, rounding, sort and top-k,
#: random draws), and the views above: no FLOPs.
ZERO_COST = _VIEWS | frozenset({
    "_to_copy", "copy", "clone", "cat", "stack", "constant_pad_nd", "pad",
    "flip", "index", "_unsafe_index", "index_select", "gather", "embedding",
    "embedding_dense_backward", "scatter", "scatter_add", "scatter_reduce",
    "index_add", "index_copy", "index_put", "_index_put_impl",
    "slice_scatter", "select_scatter", "as_strided_scatter", "masked_fill",
    "where", "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "fill", "zero", "new_zeros", "new_ones", "new_full", "arange",
    "scalar_tensor", "eq", "ne", "lt", "le", "gt", "ge", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_not", "bitwise_xor", "bitwise_left_shift",
    "bitwise_right_shift", "__and__", "__or__", "__xor__", "__lshift__",
    "__rshift__", "sign", "argmax", "argmin", "round", "floor",
    "ceil", "clamp", "clamp_min", "clamp_max", "isfinite", "sort", "topk",
    "argsort", "tril", "triu", "randn", "rand", "randint", "normal",
    "uniform", "bernoulli", "random"})

#: the reference's collective kinds (its HLO names), and the substrings of
#: the ``c10d`` / ``_c10d_functional`` op names that issue each.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_C10D = (("reduce_scatter", "reduce-scatter"),
         ("allgather", "all-gather"), ("all_gather", "all-gather"),
         ("allreduce", "all-reduce"), ("all_reduce", "all-reduce"),
         ("alltoall", "all-to-all"), ("all_to_all", "all-to-all"),
         ("send", "collective-permute"), ("recv", "collective-permute"))


def collective_kind(op_name: str):
    """The reference's kind of a ``c10d`` / ``_c10d_functional`` op, or
    None (``wait_tensor``, barriers)."""
    for key, kind in _C10D:
        if key in op_name:
            return kind
    return None


#: metadata queries that FlopCounterMode also passes by.
_METADATA = {torch.ops.aten.is_contiguous.default,
             torch.ops.aten.is_contiguous.memory_format,
             torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
             torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
             torch.ops.aten.storage_offset.default,
             torch.ops.aten.sym_storage_offset.default,
             torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
             torch.ops.aten.dim.default, torch.ops.prim.layout.default}


def _on_dtensors(types) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(issubclass(t, mod.DTensor) for t in types)


_PROPAGATION_HIDDEN = []


def _hide_shape_propagation() -> None:
    """DTensor derives an op's output shape by running the op once more on
    fake inputs of the global shapes (``ShardingPropagator.
    _propagate_tensor_meta_non_cached``, cached per op schema).  Those ops
    are not the rank's work, and whether they run depends on the cache:
    wrap the method (once per process) so that, while counters are
    active, what it runs counts nothing and tallies no storage."""
    if _PROPAGATION_HIDDEN or "torch.distributed.tensor" not in sys.modules:
        return
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def hidden(self, op_schema):
        active = list(counting.ACTIVE)
        for c in active:
            c.hidden += 1
            c.in_plain += 1
        try:
            return orig(self, op_schema)
        finally:
            for c in active:
                c.hidden -= 1
                c.in_plain -= 1
    ShardingPropagator._propagate_tensor_meta_non_cached = hidden
    _PROPAGATION_HIDDEN.append(orig)


def _tensors(tree) -> list:
    """The tensors in a nest of tuples, lists and dicts (any order); a
    DTensor as this rank's local block."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if is_dtensor(x):
            out.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _touched(t: torch.Tensor) -> int:
    """Bytes an op reads of ``t``: a broadcast (stride-0) dim once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


class FlopCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes, allocations and collectives of the aten ops
    run inside it (see the module's docstring).

    ``dot``: the products' FLOPs; ``rest``: every other op's; ``total``
    their sum; ``by_op``: FLOPs by aten name; ``bytes``: bytes read and
    written; ``live`` / ``peak``: bytes of the storages the ops allocated
    that are still alive / at most; ``collectives``: the reference's
    ``{kind: {"bytes", "count", "scaled_bytes"}}``.

    Enter it inside a ``FakeTensorMode`` to count a pass over fake
    tensors; on real tensors it counts what runs.  On DTensors it counts
    this rank's work: an op on DTensors is left to DTensor, whose local
    ops and collectives come back through the counter, and the ops DTensor
    runs on global-shape fakes to derive an output's shape
    (:func:`_hide_shape_propagation`) count nothing."""

    def __init__(self):
        super().__init__()
        self.dot = 0.0
        self.rest = 0.0
        self.bytes = 0.0
        self.by_op: dict = {}
        self.live = 0
        self.peak = 0
        self.collectives = {c: {"bytes": 0, "count": 0, "scaled_bytes": 0.0}
                            for c in COLLECTIVES}
        self.hidden = 0         # see ``kernels.counting.ACTIVE``
        self.in_plain = 0
        self._owned = WeakIdKeyDictionary()

    @property
    def total(self) -> float:
        return self.dot + self.rest

    def __enter__(self):
        _hide_shape_propagation()
        counting.ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        counting.ACTIVE.remove(self)
        return super().__exit__(*exc)

    def _add(self, name: str, flops: float, dot: bool) -> None:
        if not flops:       # an op with no output elements (``prim.device``)
            return
        if dot:
            self.dot += flops
        else:
            self.rest += flops
        self.by_op[name] = self.by_op.get(name, 0.0) + flops

    def _free(self, n: int) -> None:
        self.live -= n

    def _allocations(self, ins: list, outs: list) -> None:
        """Track the storages of ``outs`` that no input shares: the op
        allocated them.  Each is counted live until it is freed."""
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) in seen or st in self._owned:
                continue
            n = st.nbytes()
            self._owned[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
            self.peak = max(self.peak, self.live)

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace in ("c10d", "_c10d_functional",
                              "c10d_functional"):
            kind = collective_kind(name)
            if kind is not None:
                rec = self.collectives[kind]
                b = sum(_nbytes(t) for t in outs)
                rec["bytes"] += b
                rec["count"] += 1
                rec["scaled_bytes"] += float(b)
            return
        # in-place variants (``add_``) count as their ops
        base = name[:-1] if name.endswith("_") and \
            not name.endswith("__") else name
        if base not in _VIEWS:
            self.bytes += sum(_touched(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
        if packet in flop_registry:
            self._add(name, float(flop_registry[packet](
                *args, **kwargs, out_val=out)), True)
            if base in ("addmm", "baddbmm"):     # the "+ c" of the product
                self._add(name, float(sum(t.numel() for t in outs)), False)
            return
        if base in ZERO_COST:
            return
        mult = 4.0 if base in TRANSCENDENTAL else 1.0
        self._add(name, mult * float(sum(t.numel() for t in outs)), False)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA or _on_dtensors(types):
            return NotImplemented
        if func._overloadpacket not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not self.in_plain:
            self._allocations(ins, outs)
        if not self.hidden:
            self._count(func, args, kwargs, out, ins, outs)
        return out


# ---------------------------------------------------------------------------
# counting a dry-run cell
# ---------------------------------------------------------------------------

def step_call(spec: dict, overrides: dict | None = None):
    """A function of no arguments that runs the cell's step on its inputs
    (:func:`repro_torch.launch.specs.input_specs`): train: one
    ``make_train_step`` step (AdamW included) under the ``train.*``
    overrides, with ``_grad_shard`` the placed parameters' specs
    (``spec["grad_shardings"]``, ``launch.dryrun.place_spec``) as its
    ``grad_shardings``; prefill: ``model.prefill(batch, caches)``;
    decode: ``model.decode_step(tokens, caches, cur_len)``."""
    from ..configs.base import TrainConfig
    from ..train.step import make_train_step
    model = spec["model"]
    if spec["kind"] == "train":
        tkw = {k[6:]: v for k, v in (overrides or {}).items()
               if k.startswith("train.")}
        gsh = spec.get("grad_shardings") \
            if (overrides or {}).get("_grad_shard") else None
        fn = make_train_step(model, TrainConfig(**tkw), grad_shardings=gsh)
        return lambda: fn(spec["opt_state"], spec["batch"])
    if spec["kind"] == "prefill":
        return lambda: model.prefill(spec["batch"], spec["caches"])
    return lambda: model.decode_step(spec["tokens"], spec["caches"],
                                     spec["cur_len"])


def attention_split(cfg, q_shape, k_shape, dtype) -> dict:
    """By aten op, what one teacher-forced attention call counts under
    ``attn_impl="pallas"`` (``ops.mha``, counted as its plain twin
    ``attention_ref``) less under ``"jnp"`` (``layers.sdpa``'s online
    softmax over key chunks), both run on meta tensors.  q: [B,T,Hq,hd],
    k and v: [B,T,Hkv,hd].  The products are the same work, so each
    product op's entry is 0; the rest is the same softmax split into other
    elementwise ops."""
    import dataclasses

    from ..kernels.flash_attention import attention_ref
    from ..models import layers
    q = torch.empty(q_shape, dtype=dtype, device="meta")
    k = torch.empty(k_shape, dtype=dtype, device="meta")
    with torch.no_grad():
        with FlopCounter() as kernel:
            attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          k.transpose(1, 2), causal=True)
        with FlopCounter() as plain:
            layers.sdpa(dataclasses.replace(cfg, attn_impl="jnp"), q, k, k)
    return {op: kernel.by_op.get(op, 0.0) - plain.by_op.get(op, 0.0)
            for op in set(kernel.by_op) | set(plain.by_op)}


def count_spec(spec: dict, overrides: dict | None = None) -> FlopCounter:
    """Run the cell's step (:func:`step_call`) once under its fake mode and
    a :class:`FlopCounter`; returns the counter."""
    run = step_call(spec, overrides)
    with spec["mode"], FlopCounter() as c:
        run()
    return c


def count_cell(arch: str, shape_name: str,
               overrides: dict | None = None) -> FlopCounter:
    """:func:`count_spec` of a dry-run cell, over fake tensors."""
    from ..launch.specs import input_specs
    return count_spec(input_specs(arch, shape_name, overrides=overrides),
                      overrides)


def count_cell_flops(arch: str, shape_name: str,
                     overrides: dict | None = None) -> float:
    """Global FLOPs of the cell's step function (train/prefill/decode)."""
    return count_cell(arch, shape_name, overrides).total


# ---------------------------------------------------------------------------
# roofline terms from a dry-run artifact
# ---------------------------------------------------------------------------

def _bytes_of(spec_tree) -> float:
    return float(sum(_nbytes(t) for t in _tensors(spec_tree)))


def analytic_memory_floor(arch: str, shape_name: str) -> float:
    """Minimum HBM traffic per step, bytes (global): params read + grads/opt
    write (train), or params+cache read/write (serve)."""
    from ..launch.specs import input_specs
    return memory_floor(input_specs(arch, shape_name))


def memory_floor(spec: dict) -> float:
    """:func:`analytic_memory_floor` of built inputs: the reference's
    formula on the port's tensors."""
    pbytes = _bytes_of(spec["params"])
    if spec["kind"] == "train":
        obytes = _bytes_of(spec["opt_state"])
        bbytes = _bytes_of(spec["batch"])
        # read params+opt, write params+opt, read/write grads once
        return 2 * pbytes + 2 * obytes + 2 * pbytes + bbytes
    cbytes = _bytes_of(spec["caches"])
    if spec["kind"] == "prefill":
        return pbytes + 2 * cbytes + _bytes_of(spec["batch"])
    # decode: read the cache, write it (the reference's cache + cache / 1)
    return pbytes + 2 * cbytes


def scaled_collective_bytes(rec: dict) -> dict:
    """The record's collective bytes by kind and their ``total``.  Each
    collective is counted as it is issued (layers run unrolled), so no trip
    count scales them: ``scaled_bytes`` equals ``bytes``."""
    out = {c: v["scaled_bytes"] for c, v in rec.get("collectives", {}).items()}
    out["total"] = sum(out.values())
    return out


def roofline_row(rec: dict, *, flops_global: float, chips: int,
                 model_flops: float, kind: str = "train") -> dict:
    compute_s = flops_global / (chips * HW["peak_flops"])

    hlo_bytes = rec.get("cost_analysis", {}).get("bytes accessed", 0.0)
    floor_global = rec.get("analytic_memory_floor", 0.0)
    mem_per_chip = max(hlo_bytes, floor_global / chips)
    memory_s = mem_per_chip / HW["hbm_bw"]

    coll = scaled_collective_bytes(rec)
    collective_s = coll["total"] / HW["link_bw"]

    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    useful_ratio = model_flops / flops_global if flops_global else 0.0
    if kind == "decode":
        # decode is bandwidth-bound by nature: the roofline reference is the
        # minimum HBM time (params + cache must stream once per token), not
        # the (tiny) per-token matmul time.
        ideal_s = (floor_global / chips) / HW["hbm_bw"]
    else:
        ideal_s = model_flops / (chips * HW["peak_flops"])
    frac = ideal_s / bound if bound > 0 else 0.0
    return {**terms, "dominant": dominant.replace("_s", ""),
            "model_flops": model_flops, "hlo_jaxpr_flops": flops_global,
            "useful_flops_ratio": useful_ratio,
            "roofline_fraction": frac, "ideal_s": ideal_s,
            "collectives_scaled": coll}


def model_flops_for(arch: str, shape_name: str) -> float:
    """MODEL_FLOPS: 6·N·D for train (N active for MoE); 2·N·D for inference."""
    from ..configs.base import SHAPES
    from ..configs.registry import get_config
    return model_flops(get_config(arch), SHAPES[shape_name])


def model_flops(cfg, shape) -> float:
    """:func:`model_flops_for` of a config and a ``ShapeConfig``."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
