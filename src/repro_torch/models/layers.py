"""Shared neural building blocks of the port (``repro/models/layers.py``).

Conventions, as in the JAX package: parameters are kept in
``cfg.param_dtype`` (f32 unless a config asks for bf16 masters,
``cast_params``) and activations run in ``cfg.dtype``; norms, softmax
statistics and logits are f32.  Ported: ``dt_of``, ``dense_init``,
``cast_params``, ``norm``, ``rope``, ``embed``/``unembed`` (tied or not),
the chunked online-softmax attention, ``sdpa`` (the plain attention or,
under ``attn_impl="pallas"``, the flash_attention kernel through
``ops.mha``), the masked decode attention, the GQA attention block with
and without a cache, and the MLP; the trainable parameter tree and the
``cfg.remat`` policy of the training loss (:func:`remat`).

With a cache ({"k","v": [B, Smax, Hkv, hd]}, updated in place) the new k
and v are written at rows ``cur_len + arange(T)``, where ``cur_len`` may be
a 0-d tensor on the device: nothing reads it on the host, so a decode step
can be captured into a CUDA graph.  A prefill from an empty cache then
attends as the teacher-forced forward does, causally; a decode step (T=1)
attends over every cache row with the columns ``>= cur_len + 1`` masked, as
the JAX package's ``_attn_masked_decode`` does.  The JAX package also masks
its cached prefill only by ``cols < valid_len`` (ROADMAP C3), which lets a
prompt position see later ones; the port does not copy that.

Over a device mesh (``distributed.sharding``: DTensor parameters, caches
and activations, the mesh ambient) the same functions run on DTensors.
The reference's call sites are here: ``use_param`` at every weight use,
and the port adds what DTensor needs where GSPMD places it itself: a
head-cutting projection replicated before its reshape (``_heads``), each
branch's partial sum reduced before the residual add (``_residual``), a
vocab-sharded embedding lookup reduced (``embed``), the cache written by
each rank's own rows (``write_rows``), and every attention run on each
rank's plain block of heads (``local_heads``), so the kernel never sees a
DTensor.  A decode step's ``cfg.decode_attn`` is ``"gather"`` (the cache
all-gathered) or ``"sp"`` (:func:`attn_decode_sp`, the reference's
flash-decoding).  With no mesh every one of these is the identity.

Training over a mesh differentiates the same code.  Two steps are the
port's own autograd functions, each gathering nothing: the embedding
lookup in a vocab-sharded table (:class:`_VocabLookup`) and the target
log-probabilities of vocab-sharded logits (:class:`_TargetLogprobs`,
Megatron's vocab-parallel loss: three all-reduces of [B, T]-sized
statistics).  Under fsdp every weight, the norms' scales included, is
gathered before use (a block's together, ``sharding.use_params``; the
rest by ``use_param``) and its gradient reduce-scattered in the
backward; ``remat`` recomputes a block's collectives in the backward, in
the same order on every rank.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..distributed import sharding
from ..distributed.sharding import (BATCH, aligned, ambient_mesh, axis_sizes,
                                    fit, is_dtensor, maybe_constraint,
                                    rank_on, redistribute, to_placements,
                                    use_param, wrap)
from ..kernels import ops

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dt_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def dense_init(gen: torch.Generator, shape, scale=None) -> torch.Tensor:
    """f32 Normal(0, 1) * scale on ``gen``'s device; scale defaults to
    1/sqrt(fan_in) with fan_in = shape[0]."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * scale


def cast_params(cfg, tree):
    """The floating leaves of a nested dict/list of tensors in
    ``cfg.param_dtype`` (the JAX ``cast_params``: bf16 masters for the
    1T-scale config, f32 otherwise); a leaf already in it is not copied."""
    pd = DTYPES[cfg.param_dtype]
    if isinstance(tree, dict):
        return {k: cast_params(cfg, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(cfg, v) for v in tree]
    return tree.to(pd) if tree.is_floating_point() else tree


def init_norm(d: int, kind: str, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm(p, x, kind: str, eps: float):
    """RMS or layer norm over the last dim in f32.  Under fsdp its scale
    and bias are sharded weights like any other, gathered at use
    (``use_param``)."""
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * use_param(p["scale"])).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * use_param(p["scale"]) + use_param(p["bias"])).to(x.dtype)


def norm_heads(scale, y, width: int, eps: float, mesh=None, dims=(),
               c0: int = 0):
    """RMS norm in f32 over ``width`` channels of which ``y`` [..., n]
    holds ``c0 .. c0 + n``: a rank's block of heads, the others on the
    ranks of the mesh dims ``dims``, the sum of squares all-reduced over
    them.  Without ``dims`` (``y`` holds every channel) this is
    :func:`norm`."""
    scale = sharding.whole(scale)
    if not dims:
        return norm({"scale": scale}, y, "rms", eps)
    yf = y.float()
    ss = sharding.sum_over((yf * yf).sum(dim=-1, keepdim=True), mesh, dims)
    return (yf * torch.rsqrt(ss / width + eps)
            * scale[c0:c0 + y.shape[-1]]).to(y.dtype)


def rope(x, positions, theta: float):
    """Half-split rotary embedding.  x: [..., T, H, hd]; positions:
    [..., T] (broadcastable)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., :, None].float() * freqs               # [..., T, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def attn_chunked(q, k, v, *, chunk: int = 1024,
                 compute_dtype=torch.float32):
    """Causal attention with an online softmax over key chunks.

    q: [B,T,Hq,hd]; k, v: [B,T,Hkv,hd] (GQA: query head h reads key head
    h // (Hq/Hkv)).  Row i sees columns ``<= i``.  Scores and statistics
    are f32.
    """
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    qf = q.to(compute_dtype).reshape(B, T, Hkv, G, hd)
    rows = torch.arange(T, device=q.device)
    m = torch.full((B, T, Hkv, G), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, T, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, T, Hkv, G, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, S, chunk):
        kb = k[:, c0:min(S, c0 + chunk)].to(compute_dtype)
        vb = v[:, c0:min(S, c0 + chunk)].to(compute_dtype)
        s = torch.einsum("bthgd,bchd->bthgc", qf, kb).float() * scale
        cols = c0 + torch.arange(kb.shape[1], device=q.device)
        mask = rows[:, None] >= cols[None, :]
        s = torch.where(mask[None, :, None, None, :], s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bthgc,bchd->bthgd", p.to(compute_dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, T, Hq, -1).to(q.dtype)


def attn_masked_decode(q, k, v, valid_len):
    """Decode attention (``_attn_masked_decode`` of the JAX package): q
    [B,T,Hq,hd] over the whole cache k, v [B,Smax,Hkv,hd], only the columns
    ``< valid_len`` taking part.  ``valid_len`` may be a 0-d tensor on the
    device; shapes depend on nothing else, so no value is read on the host.
    In f32 throughout, over chunks of 1024 columns where 1024 divides Smax,
    else one chunk.  Every row sees the same columns: at T=1 that is the
    causal mask, at T>1 it is not (ROADMAP C3).

    Under a mesh (DTensor inputs) this is ``decode_attn="gather"``: the
    cache's sequence shards are all-gathered and each rank attends with
    its own heads (:func:`local_heads`)."""
    if is_dtensor(q):
        return local_heads(attn_masked_decode, q, k, v, valid_len)
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    chunk = 1024 if S % 1024 == 0 else S
    qf = q.float().reshape(B, T, Hkv, G, hd)
    m = torch.full((B, T, Hkv, G), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, T, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, T, Hkv, G, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, S, chunk):
        kb = k[:, c0:c0 + chunk].float()
        vb = v[:, c0:c0 + chunk].float()
        s = torch.einsum("bthgd,bchd->bthgc", qf, kb) * scale
        cols = c0 + torch.arange(chunk, device=q.device)
        s = torch.where(cols < valid_len, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bthgc,bchd->bthgd",
                                                    p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, T, Hq, hd).to(q.dtype)


def sdpa(cfg, q, k, v):
    """The no-cache causal attention of the teacher-forced forward.
    q: [B,T,Hq,hd]; k,v: [B,T,Hkv,hd].  ``attn_impl="pallas"`` goes to
    ``ops.mha`` with [B,H,T,hd] views of them (the flash_attention kernel
    on a CUDA tensor, which reads the views in place and returns o in q's
    layout, so the transpose back is contiguous) and, as in the JAX
    package, ignores ``attn_f32``.  Under a mesh each rank attends with
    its own heads (:func:`local_heads`): the kernel sees plain local
    tensors, never a DTensor."""
    if is_dtensor(q):
        return local_heads(functools.partial(sdpa, cfg), q, k, v)
    if cfg.attn_impl == "pallas":
        o = ops.mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=True)
        return o.transpose(1, 2)
    cdt = torch.float32 if cfg.attn_f32 else dt_of(cfg)
    S = k.shape[1]
    base = cfg.attn_chunk
    return attn_chunked(q, k, v, chunk=S if S <= 2 * base else base,
                        compute_dtype=cdt)


# -- GQA attention block ----------------------------------------------------------

def init_attn(cfg, gen: torch.Generator) -> dict:
    d, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {
        "wq": dense_init(gen, (d, Hq * hd)),
        "wk": dense_init(gen, (d, Hkv * hd)),
        "wv": dense_init(gen, (d, Hkv * hd)),
        "wo": dense_init(gen, (Hq * hd, d), scale=1.0 / math.sqrt(Hq * hd)),
    }


def _heads(t, H: int, hd: int):
    """[B,T,H*hd] → [B,T,H,hd].  Under a mesh the rules shard a
    projection's columns over "model", which can cut a head (llama3.2-3b's
    ``wk``, 1,024 columns, over the production mesh's 16-wide axis gives
    half-heads): such a product is replicated first (``sharding.aligned``)
    so that every rank's block holds whole heads."""
    B, T, _ = t.shape
    return aligned(t, -1, H).reshape(B, T, H, hd)


def qkv(cfg, p, x, positions):
    """x [B,T,d] → rotated q [B,T,Hq,hd] and k, v [B,T,Hkv,hd]."""
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = _heads(x @ use_param(p["wq"]), Hq, hd)
    k = _heads(x @ use_param(p["wk"]), Hkv, hd)
    v = _heads(x @ use_param(p["wv"]), Hkv, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def attend(cfg, q, k, v, cache=None, cur_len=0, decode=False):
    """Attention of q [B,T,Hq,hd] given this call's k, v [B,T,Hkv,hd].

    Without a cache: the teacher-forced forward's causal ``sdpa``.  With a
    cache ({"k","v": [B,Smax,Hkv,hd]}), k and v are first written in place
    at rows ``cur_len + arange(T)`` (``cur_len`` an int or a 0-d tensor on
    the cache's device).  A prefill (``decode`` False; the cache empty,
    ``cur_len`` 0) then attends as the forward does, through ``sdpa``, so
    it stays causal; a decode step (T=1) attends over the whole cache in
    the compute dtype with the columns ``>= cur_len + 1`` masked:
    ``cfg.decode_attn="sp"`` through :func:`attn_decode_sp`, anything else
    (``"gather"``) through :func:`attn_masked_decode`."""
    T = q.shape[1]
    if decode and T != 1:
        raise ValueError(f"a decode step takes one token a row, got {T}: "
                         f"the length mask is causal only at T=1 "
                         f"(ROADMAP C3)")
    if cache is not None:
        write_rows((cache["k"], cache["v"]), (k, v), cur_len)
    if not decode:
        return sdpa(cfg, q, k, v)
    cdt = dt_of(cfg)
    attend_fn = (attn_decode_sp if cfg.decode_attn == "sp"
                 else attn_masked_decode)
    return attend_fn(q, cache["k"].to(cdt), cache["v"].to(cdt), cur_len + 1)


def write_rows(caches, news, cur_len) -> None:
    """Write each ``news[i]`` [B,T,...] into ``caches[i]`` [B,Smax,...] at
    rows ``cur_len + arange(T)``, in place (``index_copy_``).

    Under a mesh the caches are DTensors in their own layout
    (``serve.engine.cache_shardings``: the sequence over "model" for a GQA
    cache), where an ``index_copy_`` along a sharded dim raises.  So the
    new rows (stacked, one collective for all of them) are first brought
    to the caches' layout with the rows replicated, and each rank writes
    the rows that fall in its own block: by a host slice where
    ``cur_len`` is an int (a prefill), else (a decode step, T=1,
    ``cur_len`` on the device) by one clamped row kept as it was on every
    rank but its owner's."""
    if not is_dtensor(caches[0]):
        for cache, new in zip(caches, news):
            rows = cur_len + torch.arange(new.shape[1], device=cache.device)
            cache.index_copy_(1, rows, new.to(cache.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard
    cache = caches[0]
    mesh = cache.device_mesh
    seq = [i for i, p in enumerate(cache.placements)
           if p.is_shard() and p.dim == 1]
    # the caches' layout one dim down (the stack's), the rows replicated
    spec = [Replicate() if i in seq else Shard(p.dim + 1) if p.is_shard()
            else p for i, p in enumerate(cache.placements)]
    rows = redistribute(torch.stack([n.to(cache.dtype) for n in news]),
                        spec).to_local()
    S_loc, T = cache.to_local().shape[1], rows.shape[2]
    block = 0
    for i in seq:
        block = block * mesh.size(i) + mesh.get_coordinate()[i]
    base = block * S_loc
    if not isinstance(cur_len, int) and T != 1:
        raise ValueError(f"a sharded cache takes rows at a device position "
                         f"one at a time, got {T}")
    for c, r in zip(caches, rows.unbind(0)):
        local = c.to_local()
        if isinstance(cur_len, int):
            lo, hi = max(cur_len, base), min(cur_len + T, base + S_loc)
            if lo < hi:
                local[:, lo - base:hi - base] = r[:, lo - cur_len:hi - cur_len]
            continue
        j = (cur_len - base).clamp(0, S_loc - 1).reshape(1)
        mine = (cur_len >= base) & (cur_len < base + S_loc)
        local.index_copy_(1, j, torch.where(mine, r, local.index_select(1, j)))


def local_heads(fn, q, k, v, *args):
    """``fn(q, k, v, *args)`` on each rank's block of DTensors q [B,T,Hq,hd]
    and k, v [B,S,Hkv,hd]: the batch over the batch axes where it divides,
    the heads over "model" where both Hq and Hkv divide it (the GQA
    pairing is then right within a rank's block), everything else
    replicated (a sequence-sharded cache is all-gathered).  Heads the
    rules leave misaligned (Hkv below the axis size: granite-3-2b's 8 kv
    heads on the production mesh's 16-wide axis) are replicated here,
    before the kernel, and every rank of the axis attends with all of
    them.  Returns the output as a DTensor laid out as q was brought."""
    mesh = q.device_mesh
    b, _, hq, _ = fit(q.shape, (BATCH, None, "model", None), mesh)
    hk = fit(k.shape, (None, None, "model", None), mesh)[2]
    h = hq if hq == hk and "model" not in (b or ()) else None
    spec = to_placements((b, None, h, None), mesh)
    q = redistribute(q, spec)
    kl, vl = (t.to_local() for t in _pair(k, v, spec))
    o = fn(q.to_local(), kl, vl, *args)
    return wrap(o, q, spec, q.shape[:-1] + (v.shape[-1],))


def _pair(k, v, spec):
    """k and v in ``spec``: where either must move, both move stacked, in
    one collective."""
    if list(k.placements) == spec and list(v.placements) == spec:
        return k, v
    from torch.distributed.tensor import Shard
    kv = redistribute(torch.stack([k, v]),
                      [Shard(p.dim + 1) if p.is_shard() else p
                       for p in spec])
    return kv.unbind(0)


def attn_decode_sp(q, k, v, valid_len):
    """Sequence-parallel decode attention (flash-decoding; the reference's
    ``_attn_decode_sp``, ``repro/models/layers.py:284``): each "model"
    rank computes the partial ``(m, l, acc)`` of q [B,T,Hq,hd] over its
    own slice of the sequence-sharded cache k, v [B,S,Hkv,hd] (columns
    ``rank * S/n + arange(S/n)``, those ``>= valid_len`` masked), and the
    partials merge by an all-reduce MAX of m and SUM of the rescaled l and
    acc (one collective) over the mesh's "model" dim; the cache never
    moves, only [B,T,H]-sized statistics do.  q is replicated over
    "model" first, as the reference's ``in_specs`` do.  In f32, as the
    reference.  With no ambient mesh, no "model" axis or S not divisible
    by it, this is :func:`attn_masked_decode`, as in the reference."""
    mesh = ambient_mesh()
    S = k.shape[1]
    if (mesh is None or not is_dtensor(q)
            or "model" not in mesh.mesh_dim_names
            or S % axis_sizes(mesh)["model"] != 0):
        return attn_masked_decode(q, k, v, valid_len)
    sizes = axis_sizes(mesh)
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    S_loc = S // sizes["model"]
    bnames = tuple(a for a in BATCH if a in sizes)
    bspec = (bnames if bnames and B % math.prod(sizes[a] for a in bnames) == 0
             else None)
    qspec = to_placements((bspec, None, None, None), mesh)
    kspec = to_placements((bspec, "model", None, None), mesh)
    ql = redistribute(q, qspec).to_local()
    kl, vl = (t.to_local().float() for t in _pair(k, v, kspec))
    Bl = ql.shape[0]
    base = rank_on(mesh, "model") * S_loc
    qf = ql.float().reshape(Bl, T, Hkv, G, hd)
    s = torch.einsum("bthgd,bshd->bthgs", qf, kl) * scale
    cols = base + torch.arange(S_loc, device=ql.device)
    s = torch.where(cols < valid_len, s, -1e30)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    out = merge_partials(m, p.sum(dim=-1),
                         torch.einsum("bthgs,bshd->bthgd", p, vl), mesh,
                         "model")
    return wrap(out.reshape(Bl, T, Hq, hd).to(q.dtype), q, qspec, q.shape)


def merge_partials(m, l, acc, mesh, axis: str):
    """The attention output from each rank's partial softmax over its
    slice of the sequence (flash-decoding's merge): the row maxima ``m``
    [...], the sums ``l`` [...] and the unnormalized outputs ``acc``
    [..., D] rescaled to the maximum over ``axis`` (an all-reduce max)
    and summed over it (one all-reduce of l and acc together)."""
    M = sharding.all_reduce(m, "max", mesh, axis)
    w = torch.exp(m - M)
    la = sharding.all_reduce(torch.cat([(l * w)[..., None],
                                        acc * w[..., None]], -1),
                             "sum", mesh, axis)
    return la[..., 1:] / torch.clamp(la[..., 0], min=1e-30)[..., None]


def attention(cfg, p, x, positions, cache=None, cur_len=0, decode=False):
    """The attention block, x: [B,T,d] → [B,T,d]: without a cache the
    train / teacher-forced forward's, with one a prefill or decode step
    that updates it in place (see :func:`attend`)."""
    B, T, _ = x.shape
    o = attend(cfg, *qkv(cfg, p, x, positions), cache, cur_len, decode)
    return _residual(o.reshape(B, T, -1) @ use_param(p["wo"]))


def _residual(y):
    """A block's branch output before it joins the residual stream: under
    a mesh the row-parallel product is a partial sum over "model", summed
    here (the Megatron all-reduce) so the stream stays replicated over the
    axis; GSPMD places that all-reduce itself, DTensor would otherwise
    carry a partial stream into the next norm and reduce it there twice.
    The identity without a mesh."""
    return maybe_constraint(y, BATCH, None, None)


# -- MLP ---------------------------------------------------------------------------

def init_mlp(cfg, gen: torch.Generator) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        return {"wg": dense_init(gen, (d, ff)), "wu": dense_init(gen, (d, ff)),
                "wd": dense_init(gen, (ff, d), scale=1.0 / math.sqrt(ff))}
    return {"wu": dense_init(gen, (d, ff)),
            "wd": dense_init(gen, (ff, d), scale=1.0 / math.sqrt(ff))}


def mlp(cfg, p, x):
    if cfg.activation == "swiglu":
        h = F.silu(x @ use_param(p["wg"])) * (x @ use_param(p["wu"]))
    else:
        # jax.nn.gelu's default
        h = F.gelu(x @ use_param(p["wu"]), approximate="tanh")
    return _residual(h @ use_param(p["wd"]))


# -- embeddings ---------------------------------------------------------------------

def init_embed(cfg, gen: torch.Generator) -> dict:
    """Token table, and the output head unless the embeddings are tied."""
    e = {"tok": dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02)}
    if not cfg.tie_embeddings:
        e["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size))
    return e


def embed(p, tokens):
    """Rows of the (compute-dtype) token table.  Under a mesh the table is
    sharded over its vocab rows (megatron) or gathered first (fsdp's
    ``use_param``): each rank looks up the rows it holds for its own token
    ids and the lookups are summed over the mesh dims that shard the
    table (:class:`_VocabLookup`)."""
    tok = p["tok"]
    if is_dtensor(tok):
        return _VocabLookup.apply(use_param(tok),
                                  _as_dtensor(tokens, tok.device_mesh))
    return tok[tokens]


def _as_dtensor(t, mesh):
    """``t``, or a plain tensor as a DTensor replicated on ``mesh``."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _VocabLookup(torch.autograd.Function):
    """``tok[ids]`` of a DTensor table [V, d] sharded over its rows (or
    not) by DTensor ids [B, T] sharded over the batch (or not), with no
    collective but one all-reduce: each rank looks up the ids that fall
    in its block of rows (zeros for the others), and the lookups are
    summed over the mesh dims that shard the table.  The output [B, T, d]
    takes the ids' layout.  Backward: each rank's block of the table gets
    the gradient of its own rows, a partial sum over the mesh dims that
    shard the ids (DTensor's own embedding gives a masked partial whose
    backward it cannot take from a partial gradient)."""

    @staticmethod
    def forward(ctx, tok, ids):
        from torch.distributed.tensor import DTensor
        mesh = tok.device_mesh
        vocab = sharding.shard_dims(tok, 0)
        if any(ids.placements[i].is_shard() for i in vocab):
            raise ValueError("the token ids and the table are sharded over "
                             "the same mesh dim")
        tl, il = tok.to_local(), ids.to_local()
        idx = il - sharding.block_start(tok, 0)
        inr = (idx >= 0) & (idx < tl.shape[0])
        idx = torch.where(inr, idx, 0)
        rows = tl[idx]
        if vocab:
            rows = torch.where(inr[..., None], rows, 0)
        for i in vocab:
            rows = sharding.all_reduce_dim(rows, "sum", mesh, i)
        ctx.save_for_backward(idx, inr)
        ctx.tok = (tok.placements, tok.shape, tl.shape)
        ctx.out = sharding.batch_placements(ids)
        return DTensor.from_local(rows, mesh, ctx.out, run_check=False,
                                  shape=tuple(ids.shape) + (tl.shape[1],),
                                  stride=sharding._contiguous_stride(
                                      tuple(ids.shape) + (tl.shape[1],)))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        idx, inr = ctx.saved_tensors
        placements, shape, lshape = ctx.tok
        gl = redistribute(g, ctx.out).to_local()
        grad = torch.zeros(lshape, dtype=gl.dtype, device=gl.device)
        # the ids outside the block add zeros to its row 0 (no boolean
        # index: its shape would depend on the data)
        grad.index_put_((idx,), torch.where(inr[..., None], gl, 0),
                        accumulate=True)
        out = [p if p.is_shard() else Partial() if o.is_shard() else
               Replicate() for p, o in zip(placements, ctx.out)]
        return DTensor.from_local(grad, g.device_mesh, out, run_check=False,
                                  shape=shape,
                                  stride=sharding._contiguous_stride(
                                      shape)), None


def unembed(cfg, p, x):
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    out = x @ use_param(w)
    return out.float() if cfg.logits_fp32 else out


def target_logprobs(logits, tokens):
    """log p(tokens[:, t+1] | ..t) [B, T-1] from logits [B,T,V] (f32).
    DTensor logits (under a mesh, their vocab dim sharded over "model" by
    megatron's rules) go through :class:`_TargetLogprobs`, which gathers
    nothing of them."""
    if is_dtensor(logits):
        return _TargetLogprobs.apply(
            logits, _as_dtensor(tokens, logits.device_mesh))
    lp = torch.log_softmax(logits, dim=-1)
    return torch.gather(lp[:, :-1], -1, tokens[:, 1:, None])[..., 0]


class _TargetLogprobs(torch.autograd.Function):
    """:func:`target_logprobs` of DTensor logits [B,T,V] laid out by batch
    (``Shard(0)``) and vocab (``Shard(2)``, Megatron's vocab-parallel
    loss): each rank works on its own block and the vocab's mesh dims meet
    in three all-reduces of [B, T-1]-sized statistics (the max, the sum of
    exponentials, the target's logit), never the logits.  The output [B,
    T-1] is laid out by batch.  Backward: ``onehot - softmax`` on each
    rank's block, in the logits' placements; the softmax is recomputed
    from the saved logits and statistics."""

    @staticmethod
    def forward(ctx, logits, tokens):
        from torch.distributed.tensor import DTensor
        mesh = logits.device_mesh
        for p in logits.placements:
            if p.is_partial() or (p.is_shard() and p.dim not in (0, 2)):
                raise ValueError(f"the loss takes logits sharded over the "
                                 f"batch and the vocab, not "
                                 f"{logits.placements}")
        vocab = sharding.shard_dims(logits, 2)
        ctx.out = sharding.batch_placements(logits)
        lab = redistribute(tokens, ctx.out).to_local()[:, 1:]
        ll = logits.to_local()
        x = ll[:, :-1]
        m = x.amax(dim=-1)
        for i in vocab:
            m = sharding.all_reduce_dim(m, "max", mesh, i)
        s = torch.exp(x - m[..., None]).sum(dim=-1)
        idx = lab - sharding.block_start(logits, 2)
        inr = (idx >= 0) & (idx < x.shape[-1])
        idx = torch.where(inr, idx, 0)
        t = torch.gather(x, -1, idx[..., None])[..., 0]
        if vocab:
            t = torch.where(inr, t, 0)
        for i in vocab:
            s = sharding.all_reduce_dim(s, "sum", mesh, i)
            t = sharding.all_reduce_dim(t, "sum", mesh, i)
        sel = t - m - torch.log(s)
        ctx.save_for_backward(ll, m, s, idx, inr)
        ctx.logits = (logits.placements, logits.shape)
        B, T = logits.shape[:2]
        return DTensor.from_local(sel, mesh, ctx.out, run_check=False,
                                  shape=(B, T - 1), stride=(T - 1, 1))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        ll, m, s, idx, inr = ctx.saved_tensors
        placements, shape = ctx.logits
        gl = redistribute(g, ctx.out).to_local()
        x = ll[:, :-1]
        dx = torch.exp(x - m[..., None]) / s[..., None] * -gl[..., None]
        dx.scatter_add_(-1, idx[..., None],
                        torch.where(inr, gl, 0)[..., None].to(dx.dtype))
        grad = torch.zeros_like(ll)
        grad[:, :-1] = dx
        return DTensor.from_local(grad, g.device_mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=sharding._contiguous_stride(
                                      shape)), None


# -- parameters ---------------------------------------------------------------------

#: parameters the JAX models use as stored, in ``param_dtype`` (norm
#: scales/biases, SSM scalars, sLSTM's recurrent ``r``); every other one
#: they cast to the compute dtype at use.
AS_STORED = frozenset({"scale", "bias", "a_log", "dt_bias", "r"})


class ParamTree(nn.Module):
    """A nested dict/list of tensors as trainable parameters (the masters),
    so that the state-dict keys are the JAX tree's paths
    (``blocks.0.ln.scale``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, list):
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self, cdt: torch.dtype) -> dict:
        """The parameters as a nested dict, cast to ``cdt`` except
        :data:`AS_STORED` (no copy where the dtype is already right).  Under
        grad mode the casts stay in the autograd graph, so gradients reach
        the masters in their own dtype; the models' ``weights()`` take this
        copy under ``no_grad``, for serving and evaluation."""
        out = {}
        for k, v in self.named_parameters(recurse=False):
            out[k] = v if k in AS_STORED else v.to(cdt)
        for k, m in self.named_children():
            out[k] = ([x.tree(cdt) for x in m] if isinstance(m, nn.ModuleList)
                      else m.tree(cdt))
        return out


# -- rematerialisation ----------------------------------------------------------------

def _save_dots(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims``: keep the outputs of plain 2-D
    products (``aten.mm``, which ``x @ w`` of an activation and a weight
    lowers to), recompute everything else."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


REMAT = ("none", "full", "dots")


def remat(policy: str, fn, *args):
    """``fn(*args)`` under the reference's ``_maybe_remat`` policy
    (``repro/models/transformer.py:47``): ``"none"`` keeps every
    intermediate for the backward, ``"full"`` keeps only the inputs and
    recomputes ``fn`` in the backward, ``"dots"`` keeps the outputs of 2-D
    products and recomputes the rest.  Without grad mode there is no
    backward, and ``fn`` simply runs."""
    if policy not in REMAT:
        raise ValueError(f"unknown remat policy {policy!r}; one of {REMAT}")
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts, _save_dots))
