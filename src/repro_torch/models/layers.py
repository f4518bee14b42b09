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
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

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
    causal mask, at T>1 it is not (ROADMAP C3)."""
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
    package, ignores ``attn_f32``."""
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


def qkv(cfg, p, x, positions):
    """x [B,T,d] → rotated q [B,T,Hq,hd] and k, v [B,T,Hkv,hd]."""
    B, T, _ = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, T, Hq, hd)
    k = (x @ p["wk"]).reshape(B, T, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, T, Hkv, hd)
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
    the compute dtype with the columns ``>= cur_len + 1`` masked
    (:func:`attn_masked_decode`)."""
    T = q.shape[1]
    if decode and T != 1:
        raise ValueError(f"a decode step takes one token a row, got {T}: "
                         f"the length mask is causal only at T=1 "
                         f"(ROADMAP C3)")
    if cache is not None:
        rows = cur_len + torch.arange(T, device=q.device)
        cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
    if not decode:
        return sdpa(cfg, q, k, v)
    cdt = dt_of(cfg)
    return attn_masked_decode(q, cache["k"].to(cdt), cache["v"].to(cdt),
                              cur_len + 1)


def attention(cfg, p, x, positions, cache=None, cur_len=0, decode=False):
    """The attention block, x: [B,T,d] → [B,T,d]: without a cache the
    train / teacher-forced forward's, with one a prefill or decode step
    that updates it in place (see :func:`attend`)."""
    B, T, _ = x.shape
    o = attend(cfg, *qkv(cfg, p, x, positions), cache, cur_len, decode)
    return o.reshape(B, T, -1) @ p["wo"]


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
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = F.gelu(x @ p["wu"], approximate="tanh")  # jax.nn.gelu's default
    return h @ p["wd"]


# -- embeddings ---------------------------------------------------------------------

def init_embed(cfg, gen: torch.Generator) -> dict:
    """Token table, and the output head unless the embeddings are tied."""
    e = {"tok": dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02)}
    if not cfg.tie_embeddings:
        e["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size))
    return e


def embed(p, tokens):
    """Rows of the (compute-dtype) token table."""
    return p["tok"][tokens]


def unembed(cfg, p, x):
    out = x @ (p["tok"].T if cfg.tie_embeddings else p["head"])
    return out.float() if cfg.logits_fp32 else out


def target_logprobs(logits, tokens):
    """log p(tokens[:, t+1] | ..t) [B, T-1] from logits [B,T,V] (f32)."""
    lp = torch.log_softmax(logits, dim=-1)
    return torch.gather(lp[:, :-1], -1, tokens[:, 1:, None])[..., 0]


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
