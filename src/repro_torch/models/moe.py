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
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def route(cfg, p, xf):
    """The dispatch of tokens xf [Tt, d]: a dict of the gates [Tt, k]
    (compute dtype), expert indices ``idx`` [Tt, k], the stable ``order``
    of the Tt·k (token, slot) pairs by expert, and for the sorted pairs
    ``keep`` (rank in the expert's group < cap) and the buffer row ``pos``
    (E·cap for a dropped pair); and ``cap``."""
    E, k = cfg.n_experts, cfg.experts_per_token
    logits = (xf @ p["router"]).float()                          # [Tt, E]
    gate, idx = top_k(logits, k)
    gate = torch.softmax(gate, dim=-1).to(xf.dtype)
    cap = capacity(cfg, xf.shape[0])
    order, ks, rank = group_ranks(idx.reshape(-1))
    keep = rank < cap
    pos = torch.where(keep, ks * cap + rank, E * cap)
    return dict(gate=gate, idx=idx, order=order, keep=keep, pos=pos,
                cap=cap)


def moe_ffn(cfg, p, x):
    """x: [B, T, d] → [B, T, d] via the top-k routed experts (capacity
    ``capacity(cfg, B·T)`` each) plus the shared experts."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    Tt = B * T
    xf = x.reshape(Tt, d)
    r = route(cfg, p, xf)
    cap, order, pos, keep = r["cap"], r["order"], r["pos"], r["keep"]
    token = order // k                      # the sorted pairs' tokens
    # the expert buffer, with one sentinel row that takes the dropped pairs.
    buf = xf.new_zeros((E * cap + 1, d))
    buf[pos] = xf[token]
    buf = buf[:E * cap].reshape(E, cap, d)
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wu"])
    out = torch.bmm(h, p["wd"]).reshape(E * cap, d)
    gate = r["gate"].reshape(-1)[order] * keep.to(x.dtype)
    contrib = out[pos.clamp(max=E * cap - 1)] * gate[:, None]
    # back to (token, slot) order; each token's k slots summed in order.
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    contrib = contrib[inv].reshape(Tt, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    if cfg.n_shared_experts:
        sp = p["shared"]
        hs = F.silu(xf @ sp["wg"]) * (xf @ sp["wu"])
        y = y + hs @ sp["wd"]
    return y.reshape(B, T, d)


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
    latents are first written in place at rows ``cur_len + arange(T)``,
    then a prefill attends as the forward does and a decode step (T=1)
    takes the absorbed form over the cache, columns ``>= cur_len + 1``
    masked (``cur_len`` an int or a 0-d tensor on the device)."""
    B, T, _ = x.shape
    Hq, hd = cfg.n_heads, cfg.hd
    r, rd = cfg.kv_lora_rank, cfg.rope_head_dim
    if decode and T != 1:
        raise ValueError(f"an MLA decode step takes one token a row, got "
                         f"{T}: the length mask is causal only at T=1 "
                         f"(ROADMAP C3)")
    q = (x @ p["wq"]).reshape(B, T, Hq, hd + rd)
    qn, qr = q[..., :hd], rope(q[..., hd:], positions, cfg.rope_theta)
    ckv = x @ p["wdkv"]                                          # [B,T,r]
    kr = rope((x @ p["wkr"])[:, :, None, :], positions,
              cfg.rope_theta)[:, :, 0, :]                        # [B,T,rd]
    wukv = p["wukv"].reshape(r, Hq, 2 * hd)
    wuk, wuv = wukv[..., :hd], wukv[..., hd:]
    if cache is not None:
        rows = cur_len + torch.arange(T, device=x.device)
        cache["ckv"].index_copy_(1, rows, ckv.to(cache["ckv"].dtype))
        cache["kr"].index_copy_(1, rows, kr.to(cache["kr"].dtype))
    if not decode:
        kn = torch.einsum("btr,rhd->bthd", ckv, wuk)
        v = torch.einsum("btr,rhd->bthd", ckv, wuv)
        kfull = torch.cat([kn, kr[:, :, None, :].expand(B, T, Hq, rd)], -1)
        qfull = torch.cat([qn, qr], dim=-1)
        # attn_chunked scales by 1/sqrt(hd + rd), the width of qfull.
        o = attn_chunked(qfull, kfull, v, chunk=min(1024, T))
    else:
        cdt = dt_of(cfg)
        cckv, ckr = cache["ckv"].to(cdt), cache["kr"].to(cdt)
        S = cckv.shape[1]
        q_abs = torch.einsum("bthd,rhd->bthr", qn, wuk)          # [B,T,H,r]
        s = (torch.einsum("bthr,bsr->bths", q_abs, cckv)
             + torch.einsum("bthp,bsp->bths", qr, ckr)) \
            * (1.0 / math.sqrt(hd + rd))
        cols = torch.arange(S, device=x.device)
        s = torch.where(cols < cur_len + T, s, -1e30)
        w = torch.softmax(s.float(), dim=-1).to(cdt)
        ctx = torch.einsum("bths,bsr->bthr", w, cckv)
        o = torch.einsum("bthr,rhd->bthd", ctx, wuv)
    return o.reshape(B, T, Hq * hd) @ p["wo"]
