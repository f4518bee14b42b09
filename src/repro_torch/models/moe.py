"""Mixture-of-Experts FFN (Kimi-K2 / DeepSeek-V2 style) and MLA attention,
port of ``repro/models/moe.py``.

MoE dispatch is the reference's sort-based capacity scheme, in its order of
operations: the router's top k (the head of a stable descending sort, so
tied logits go to the lower expert index first, as ``jax.lax.top_k``
takes them; ``torch.topk`` promises no order among ties), a softmax over
the k gates, the (token, slot) pairs sorted by expert, each pair's rank in
its expert's group, a capacity-capped scatter into an [E, cap, d] buffer
(the dropped pairs go to one sentinel row past the buffer), the expert
products as batched matrix products, and the weighted combine.  ``cap`` is
computed on the host from the shapes alone, so a decode step has static
shapes and captures into a CUDA graph.  The combine does not scatter-add
(``index_add_`` on the card adds with atomics, in no fixed order): each
token's k contributions are put back in slot order by the inverse
permutation and summed in that order, so a graphed decode step equals the
eager one bit for bit.

MLA (DeepSeek): K and V are compressed to a ``kv_lora_rank`` latent plus a
shared rotary key.  The forward and the prefill expand the latent to
per-head K/V (q and k of width ``hd + rope_head_dim``, v of width ``hd``)
and attend through ``layers.attn_chunked``, causally; a decode step (T=1)
takes the absorbed form, scores and context in latent space over the
``{"ckv", "kr"}`` cache, which it writes in place at rows ``cur_len +
arange(T)``.  The reference's cached prefill takes the absorbed form with
the length mask only, which is not causal (ROADMAP C3); the port's stays
causal.  No Pallas kernel is on either path in the reference.

Over a device mesh (DTensor inputs, ``distributed.sharding``) both run
per rank on local blocks with named collectives: :func:`_moe_ffn_mesh`
(expert-parallel, the one-device routing and drops over the global
batch) and :func:`mla_attention` (each rank's heads, the latent cache in
``cache_shardings``' layout, the sp decode in latent space).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed import sharding
from ..distributed.sharding import is_dtensor
from .layers import attn_chunked, dense_init, dt_of, rope


# -- MoE FFN -------------------------------------------------------------------

def init_moe(cfg, gen: torch.Generator) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, (d, E), scale=0.02),
        "wg": dense_init(gen, (E, d, ff)),    # fan-in E, as in the reference
        "wu": dense_init(gen, (E, d, ff)),
        "wd": dense_init(gen, (E, ff, d), scale=1.0 / math.sqrt(ff)),
    }
    if cfg.n_shared_experts:
        sf = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {"wg": dense_init(gen, (d, sf)),
                       "wu": dense_init(gen, (d, sf)),
                       "wd": dense_init(gen, (sf, d),
                                        scale=1.0 / math.sqrt(sf))}
    return p


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens (the reference's formula:
    at least 128, a multiple of 128)."""
    k, E = cfg.experts_per_token, cfg.n_experts
    return max(128, int(math.ceil(cfg.capacity_factor * n_tokens * k / E
                                  / 128)) * 128)


def top_k(logits, k: int):
    """(values, indices) of the k largest along the last dim, largest
    first and, among equal values, the lower index first (``lax.top_k``'s
    order)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def group_ranks(key):
    """``_group_ranks``: the stable sort of ``key`` [N] (order), the sorted
    keys, and each sorted entry's rank among the entries of its key."""
    order = torch.argsort(key, stable=True)
    ks = key[order]
    idx = torch.arange(key.shape[0], device=key.device)
    is_start = torch.ones_like(ks, dtype=torch.bool)
    is_start[1:] = ks[1:] != ks[:-1]
    start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return order, ks, idx - start


def route(cfg, p, xf, cap=None, prior=None, idx=None):
    """The dispatch of tokens xf [Tt, d]: a dict of the gates [Tt, k]
    (compute dtype), expert indices ``idx`` [Tt, k] (the router's top k,
    or the ``idx`` given), the stable ``order``
    of the Tt·k (token, slot) pairs by expert, the sorted experts ``ks``
    and each sorted pair's ``rank`` in its expert's group, ``keep`` (rank
    < cap) and the buffer row ``pos`` (E·cap for a dropped pair); and
    ``cap`` (default ``capacity(cfg, Tt)``).  Over a mesh, where xf is one
    rank's block of a batch, ``prior`` maps the block's pairs per expert
    [E] to those of the blocks before it (``sharding.prefix_counts``), so
    a rank is the pair's rank in the whole batch's order."""
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = (xf @ p["router"]).float()                          # [Tt, E]
    if idx is None:
        gate, idx = top_k(logits, k)
    else:
        gate = logits.gather(1, idx)
    gate = torch.softmax(gate, dim=-1).to(xf.dtype)
    cap = capacity(cfg, xf.shape[0]) if cap is None else cap
    flat = idx.reshape(-1)
    order, ks, rank = group_ranks(flat)
    if prior is not None:
        counts = torch.zeros(E, dtype=rank.dtype, device=rank.device)
        counts.index_add_(0, flat, torch.ones_like(flat))
        rank = rank + prior(counts)[ks]
    keep = rank < cap
    pos = torch.where(keep, ks * cap + rank, E * cap)
    return dict(gate=gate, idx=idx, order=order, ks=ks, rank=rank,
                keep=keep, pos=pos, cap=cap)


def moe_ffn(cfg, p, x):
    """x: [B, T, d] → [B, T, d] via the top-k routed experts (capacity
    ``capacity(cfg, B·T)`` each) plus the shared experts."""
    if is_dtensor(x):
        return _moe_ffn_mesh(cfg, p, x)
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    Tt = B * T
    xf = x.reshape(Tt, d)
    r = route(cfg, p, xf)
    cap, order, pos, keep = r["cap"], r["order"], r["pos"], r["keep"]
    # the expert buffer, with one sentinel row that takes the dropped pairs.
    buf = _dispatch(xf, order // k, pos, E * cap).reshape(E, cap, d)
    out = _experts(buf, p["wg"], p["wu"], p["wd"]).reshape(E * cap, d)
    y = _combine(r, out, pos, keep, Tt)
    if cfg.n_shared_experts:
        sp = p["shared"]
        hs = F.silu(xf @ sp["wg"]) * (xf @ sp["wu"])
        y = y + hs @ sp["wd"]
    return y.reshape(B, T, d)


def _dispatch(xf, token, pos, rows: int):
    """The expert buffer [rows, d]: row ``pos[i]`` holds token
    ``token[i]``; ``pos == rows`` is a sentinel row that takes the
    dropped pairs and is cut off."""
    buf = xf.new_zeros((rows + 1, xf.shape[1]))
    buf[pos] = xf[token]
    return buf[:rows]


def _experts(buf, wg, wu, wd):
    """The expert FFNs on their buffer rows: buf [e, c, d] → [e, c, d]."""
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    return torch.bmm(h, wd)


def _combine(r, out, pos, take, Tt: int):
    """The weighted contributions of the buffer rows ``out`` [rows, d] at
    ``pos`` of the sorted pairs that ``take`` keeps, back in (token, slot)
    order, each token's k slots summed in order → [Tt, d]."""
    order, k = r["order"], r["idx"].shape[1]
    gate = r["gate"].reshape(-1)[order] * take.to(out.dtype)
    contrib = out[pos.clamp(max=out.shape[0] - 1)] * gate[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    contrib = contrib[inv].reshape(Tt, k, -1)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def _moe_ffn_mesh(cfg, p, x):
    """:func:`moe_ffn` over a device mesh, x a DTensor [B, T, d] in the
    stream's layout (the batch over its mesh dims, d whole).

    The routing is the one-device function's on the whole batch: each
    rank routes its own tokens, ``cap`` is ``capacity(cfg, B·T)`` of the
    global batch, and a pair's rank in its expert's group is its rank in
    the global (token, slot) order, rank-major over the batch's mesh
    dims (one all-gather of [E] counts each, :func:`route`'s ``prior``),
    so the same pairs are dropped.

    The experts are stored by the reference's rules, experts over "model"
    and their ff dim over "data".  Each rank puts its kept pairs that go
    to its own experts into its block's buffer [E_loc, cap, d] (zero
    elsewhere: the ranks of the batch fill disjoint slots), and
    ``cfg.moe_buf_layout`` says where the buffer goes from there:

    * ``"m"`` (("model", None, None)): the buffers are summed over the
      batch's mesh dims (an all-reduce, the whole cap on every rank), each
      rank runs its ff block and the partial outputs are summed over
      "data";
    * ``"md"`` (the reference's constraint ("model", "data", None)): the
      buffers are summed over the batch's mesh dims and scattered along
      cap over "data" (a reduce-scatter); the experts' ff blocks are
      gathered over "data", each rank runs its cap block, and the outputs
      are all-gathered along cap;
    * ``"none"``: the buffer stays the rank's own; the ff blocks are
      gathered and each rank runs its own tokens' slots.

    ``"md"`` and ``"none"`` move the experts' weights, 3·ff a row of d an
    expert, where the buffer moves cap rows: where 3·ff is not below cap
    (a decode step's 128 slots, a short prefill) they move the buffer as
    ``"m"`` does, which is less.

    Each rank combines its pairs' contributions from its own experts in
    the one-device slot order, adds the shared experts' partial product
    (their columns over "model") and the sum over "model" (one
    all-reduce) completes every token: its slots from other ranks' experts
    are added in another order than on one device, so the result equals
    it to rounding, not bit for bit."""
    mesh = x.device_mesh
    xl = sharding.batch_local(x)
    Bl, T, d = xl.shape
    k = cfg.experts_per_token
    xf = xl.reshape(-1, d)
    Tl = xf.shape[0]
    cap = capacity(cfg, x.shape[0] * T)
    bdims = sharding.shard_dims(x, 0)
    r = route(cfg, {"router": sharding.whole(p["router"])}, xf, cap=cap,
              prior=lambda c: sharding.prefix_counts(c, mesh, bdims))
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    edims = sharding.shard_dims(wg, 0)
    fdims = sharding.shard_dims(wg, 2)
    El, e0 = wg.to_local().shape[0], sharding.block_start(wg, 0)
    ks, keep = r["ks"], r["keep"]
    mine = keep & (ks >= e0) & (ks < e0 + El)
    pos = torch.where(mine, (ks - e0) * cap + r["rank"], El * cap)
    buf = _dispatch(xf, r["order"] // k, pos, El * cap).reshape(El, cap, d)
    layout = cfg.moe_buf_layout
    if layout not in ("md", "m", "none"):
        raise ValueError(f"unknown moe_buf_layout {layout!r}; one of md, m, "
                         f"none")
    names = list(mesh.mesh_dim_names)
    data = names.index("data") if "data" in names else None
    # the experts' ff blocks move only where they are smaller than the
    # buffer: 3·ff weights an expert against its cap rows
    move_weights = bool(fdims) and 3 * wg.shape[2] < cap
    if layout == "md" and move_weights and data is not None \
            and mesh.size(data) > 1 and cap % mesh.size(data) == 0:
        buf = sharding.sum_over(buf, mesh, [i for i in bdims if i != data])
        if data in bdims:
            buf = sharding.reduce_scatter_dim(buf, 1, mesh, data)
        else:
            buf = buf.chunk(mesh.size(data), 1)[mesh.get_coordinate()[data]]
        out = _experts(buf, *(sharding.gather_over(w.to_local(), dim, mesh,
                                                   fdims)
                              for w, dim in ((wg, 2), (wu, 2), (wd, 1))))
        out = sharding.all_gather_dim(out, 1, mesh, data)
    elif layout == "none" and move_weights:
        out = _experts(buf, *(sharding.gather_over(w.to_local(), dim, mesh,
                                                   fdims)
                              for w, dim in ((wg, 2), (wu, 2), (wd, 1))))
    else:
        buf = sharding.sum_over(buf, mesh, bdims)
        out = _experts(buf, wg.to_local(), wu.to_local(), wd.to_local())
        out = sharding.sum_over(out, mesh, fdims)
    y = _combine(r, out.reshape(El * cap, d), pos, mine, Tl)
    if cfg.n_shared_experts:
        # the shared experts' columns over "model": a partial sum that
        # joins the routed one in one all-reduce where both are over it.
        sp = p["shared"]
        wgl, _, c0 = sharding.local_weight(sp["wg"])
        h = F.silu(xf @ wgl) * (xf @ sharding.local_weight(sp["wu"])[0])
        ys = sharding.row_product(h, c0, sp["wd"], reduce=False)
        sdims = sharding.shard_dims(sp["wd"], 0)
        if sdims == edims:
            y = y + ys
        else:
            y = sharding.sum_over(y, mesh, edims) + sharding.sum_over(
                ys, mesh, sdims)
            edims = []
    y = sharding.sum_over(y, mesh, edims)
    return sharding.as_batch(y.reshape(Bl, T, d), x)


def aux_load_balance_loss(cfg, router_logits):
    """The Switch-style load-balance auxiliary of the reference
    (``repro/models/moe.py:108``; per layer, averaged by the caller, and,
    as there, called by no loss): E · Σ_e frac_e · imp_e over the leading
    axis of ``router_logits`` [..., E], frac the share of rows whose top-1
    expert is e (``torch.argmax`` takes the first of tied maxima, as
    ``jnp.argmax`` does) and imp the mean router probability of e."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    E = probs.shape[-1]
    top1 = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top1, E).float().mean(dim=0)
    imp = probs.mean(dim=0)
    return E * torch.sum(frac * imp)


# -- MLA attention -----------------------------------------------------------------

def init_mla(cfg, gen: torch.Generator) -> dict:
    d, Hq, hd = cfg.d_model, cfg.n_heads, cfg.hd
    r, rd = cfg.kv_lora_rank, cfg.rope_head_dim
    return {
        "wq": dense_init(gen, (d, Hq * (hd + rd))),
        "wdkv": dense_init(gen, (d, r)),
        "wkr": dense_init(gen, (d, rd)),
        "wukv": dense_init(gen, (r, Hq * 2 * hd)),
        "wo": dense_init(gen, (Hq * hd, d), scale=1.0 / math.sqrt(Hq * hd)),
    }


def mla_attention(cfg, p, x, positions, cache=None, cur_len=0,
                  decode=False):
    """MLA, x: [B,T,d] → [B,T,d].  Without a cache the teacher-forced
    forward; with one ({"ckv": [B,Smax,r], "kr": [B,Smax,rd]}) the new
    latents are first written in place at rows ``cur_len + arange(T)``
    (``layers.write_rows``), then a prefill attends as the forward does
    and a decode step (T=1) takes the absorbed form over the cache,
    columns ``>= cur_len + 1`` masked (``cur_len`` an int or a 0-d tensor
    on the device).

    Over a device mesh (x a DTensor in the stream's layout) ``wq`` and
    ``wukv`` hold head columns over "model" by the rules, ``wdkv`` and
    ``wkr`` are replicated and ``wo`` holds head rows, so each rank takes
    its own heads (every head where the blocks cut one) and ``wo``'s
    partial products are summed over "model".  The cache is laid out by
    ``serve.engine.cache_shardings`` (the batch, and the sequence or the
    latent over "model") and each rank writes its own rows.  A prefill
    expands the latent for the rank's heads and attends causally.  A
    decode step under ``decode_attn="sp"`` over a cache whose sequence is
    sharded over "model" merges each rank's partial softmax over its
    slice of the sequence (:func:`_absorbed_sp`); otherwise (``"gather"``,
    or a cache laid out another way) the cache is gathered whole for the
    rank's rows."""
    from .layers import write_rows
    mesh = x.device_mesh if is_dtensor(x) else None
    xl = x if mesh is None else sharding.batch_local(x)
    B, T, _ = xl.shape
    Hq, hd = cfg.n_heads, cfg.hd
    r, rd = cfg.kv_lora_rank, cfg.rope_head_dim
    if decode and T != 1:
        raise ValueError(f"an MLA decode step takes one token a row, got "
                         f"{T}: the length mask is causal only at T=1 "
                         f"(ROADMAP C3)")
    h0, hl = sharding.head_split(p["wq"], 1, Hq)
    if (h0, hl) != sharding.head_split(p["wukv"], 1, Hq) or \
            (h0, hl) != sharding.head_split(p["wo"], 0, Hq):
        h0, hl = 0, Hq
    split = hl != Hq
    q = (xl @ p["wq"].to_local() if split
         else sharding.column_product(xl, p["wq"])).reshape(B, T, hl,
                                                            hd + rd)
    wukv = p["wukv"].to_local() if split else sharding.whole(p["wukv"])
    qn, qr = q[..., :hd], rope(q[..., hd:], positions, cfg.rope_theta)
    ckv = xl @ sharding.whole(p["wdkv"])                         # [B,T,r]
    kr = rope((xl @ sharding.whole(p["wkr"]))[:, :, None, :], positions,
              cfg.rope_theta)[:, :, 0, :]                        # [B,T,rd]
    wukv = wukv.reshape(r, hl, 2 * hd)
    wuk, wuv = wukv[..., :hd], wukv[..., hd:]
    if cache is not None:
        for key, new in (("ckv", ckv), ("kr", kr)):
            write_rows((cache[key],), (new if mesh is None
                                       else sharding.as_batch(new, x),),
                       cur_len)
    if not decode:
        kn = torch.einsum("btr,rhd->bthd", ckv, wuk)
        v = torch.einsum("btr,rhd->bthd", ckv, wuv)
        kfull = torch.cat([kn, kr[:, :, None, :].expand(B, T, hl, rd)], -1)
        qfull = torch.cat([qn, qr], dim=-1)
        # attn_chunked scales by 1/sqrt(hd + rd), the width of qfull.
        o = attn_chunked(qfull, kfull, v, chunk=min(1024, T))
    else:
        cdt = dt_of(cfg)
        q_abs = torch.einsum("bthd,rhd->bthr", qn, wuk)          # [B,T,h,r]
        if mesh is not None and cfg.decode_attn == "sp" and _seq_split(
                cache, mesh):
            ctx = _absorbed_sp(cfg, cache, q_abs, qr, cur_len, split, h0,
                               hl).to(cdt)
        else:
            cckv, ckr = (cache[k] if mesh is None
                         else sharding.batch_local(cache[k])
                         for k in ("ckv", "kr"))
            cckv, ckr = cckv.to(cdt), ckr.to(cdt)
            S = cckv.shape[1]
            s = (torch.einsum("bthr,bsr->bths", q_abs, cckv)
                 + torch.einsum("bthp,bsp->bths", qr, ckr)) \
                * (1.0 / math.sqrt(hd + rd))
            cols = torch.arange(S, device=xl.device)
            s = torch.where(cols < cur_len + T, s, -1e30)
            w = torch.softmax(s.float(), dim=-1).to(cdt)
            ctx = torch.einsum("bths,bsr->bthr", w, cckv)
        o = torch.einsum("bthr,rhd->bthd", ctx, wuv)
    y = sharding.row_product(o.reshape(B, T, hl * hd), h0 * hd, p["wo"])
    return y if mesh is None else sharding.as_batch(y, x)


def _seq_split(cache, mesh) -> bool:
    """Whether the latent cache's sequence (both leaves') is sharded over
    a "model" dim of ``mesh`` wider than one rank, and over nothing
    else."""
    if "model" not in mesh.mesh_dim_names:
        return False
    model = mesh.mesh_dim_names.index("model")
    return mesh.size(model) > 1 and all(
        sharding.shard_dims(cache[k], 1) == [model] for k in ("ckv", "kr"))


def _absorbed_sp(cfg, cache, q_abs, qr, cur_len, split, h0, hl):
    """The absorbed decode step of :func:`mla_attention` over a latent
    cache whose sequence is sharded over "model": each rank runs it on its
    slice of the sequence for every head (the heads' absorbed queries
    all-gathered, [B,1,H,r]), its partial (m, l, ctx), ctx in latent space
    [B,1,H,r], merged by an all-reduce max and one all-reduce sum over
    "model" (the reference's ``_attn_decode_sp``, in f32); the latent
    cache never moves.  Returns ctx of the rank's heads [B,1,hl,r] f32."""
    from .layers import merge_partials
    mesh = cache["ckv"].device_mesh
    heads = [mesh.mesh_dim_names.index("model")] if split else []
    qa = sharding.gather_over(q_abs.float(), 2, mesh, heads)
    qrf = sharding.gather_over(qr.float(), 2, mesh, heads)
    cl, kl = (cache[k].to_local().float() for k in ("ckv", "kr"))
    s = (torch.einsum("bthr,bsr->bths", qa, cl)
         + torch.einsum("bthp,bsp->bths", qrf, kl)) \
        * (1.0 / math.sqrt(cfg.hd + cfg.rope_head_dim))
    cols = sharding.block_start(cache["ckv"], 1) + torch.arange(
        cl.shape[1], device=cl.device)
    s = torch.where(cols < cur_len + qa.shape[1], s, -1e30)
    m = s.amax(dim=-1)
    pe = torch.exp(s - m[..., None])
    ctx = merge_partials(m, pe.sum(dim=-1), torch.einsum(
        "bths,bsr->bthr", pe, cl), mesh, "model")             # [B,T,H,r]
    return ctx[:, :, h0:h0 + hl]
