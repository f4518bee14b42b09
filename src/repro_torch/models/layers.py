"""Shared neural building blocks of the port (``repro/models/layers.py``).

Conventions, as in the JAX package: parameters are kept in
``cfg.param_dtype`` (f32) and activations run in ``cfg.dtype``; norms,
softmax statistics and logits are f32.  This slice ports what the zamba2
serving path needs: ``dt_of``, ``dense_init``, ``norm``, ``rope``,
``embed``/``unembed`` and the chunked online-softmax attention.

The attention is causal by position everywhere: query row ``i`` sits at
absolute position ``q_offset + i`` and sees key columns ``<= q_offset + i``.
With no cache that is the teacher-forced mask; over a cache that holds
``cur_len`` earlier entries (``q_offset = cur_len``) it is the mask of
stepwise decoding.  The JAX package's cached prefill masks only
``cols < valid_len`` (ROADMAP C3), which lets a prompt position see later
ones; the port does not copy that.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dt_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def dense_init(gen: torch.Generator, shape, scale=None) -> torch.Tensor:
    """f32 Normal(0, 1) * scale on ``gen``'s device; scale defaults to
    1/sqrt(fan_in) with fan_in = shape[0]."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * scale


def init_norm(d: int, kind: str, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm(p, x, kind: str, eps: float):
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * p["scale"]).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


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


def attention(q, k, v, *, q_offset: int = 0, chunk: int = 1024,
              compute_dtype=torch.float32):
    """Causal attention with an online softmax over key chunks.

    q: [B,T,Hq,hd]; k, v: [B,S,Hkv,hd] (GQA: query head h reads key head
    h // (Hq/Hkv)).  Row i sees columns ``<= q_offset + i``; columns past
    the last row's position are never read.  Scores and statistics are f32.
    """
    B, T, Hq, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    S = min(S, q_offset + T)
    qf = q.to(compute_dtype).reshape(B, T, Hkv, G, hd)
    rows = q_offset + torch.arange(T, device=q.device)
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


def sdpa(cfg, q, k, v):
    """The no-cache causal attention of the teacher-forced forward.
    q: [B,T,Hq,hd]; k,v: [B,T,Hkv,hd]."""
    if cfg.attn_impl == "pallas":
        raise NotImplementedError(
            "attn_impl='pallas' (the flash_attention kernel) is not in the "
            "PyTorch port yet; it comes with the no-cache forward slice "
            "(ROADMAP B2)")
    cdt = torch.float32 if cfg.attn_f32 else dt_of(cfg)
    S = k.shape[1]
    base = cfg.attn_chunk
    return attention(q, k, v, chunk=S if S <= 2 * base else base,
                     compute_dtype=cdt)


def init_embed(cfg, gen: torch.Generator) -> dict:
    """Token table and output head (untied, as zamba2; tied embeddings come
    with the dense slice)."""
    return {"tok": dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02),
            "head": dense_init(gen, (cfg.d_model, cfg.vocab_size))}


def embed(p, tokens):
    """Rows of the (compute-dtype) token table."""
    return p["tok"][tokens]


def unembed(cfg, p, x):
    out = x @ p["head"]
    return out.float() if cfg.logits_fp32 else out
