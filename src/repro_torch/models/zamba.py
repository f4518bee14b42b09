"""Zamba2 hybrid (arXiv:2411.15242), port of ``repro/models/zamba.py``: a
Mamba-2 backbone plus one weight-SHARED attention block invoked every
``attn_every`` layers on concat(hidden, embed0), at width 2*d_model.

Weights are shared across invocations; caches are not: each invocation has
its own KV slot.  The module's parameters are the masters, named as the
JAX parameter tree (``embed.tok``, ``blocks.3.win``, ...), in
``cfg.param_dtype``.
:meth:`Zamba.weights` casts them once to the compute dtype where the JAX
model casts at every use; a serving session keeps that copy.

Serving and evaluation run under ``no_grad``; :meth:`Zamba.train_loss` is
the loss that training differentiates.  Caches are updated in place.  Prefill is causal (ROADMAP C3): it computes
the same logits as the teacher-forced :meth:`Zamba.forward`, and the same
caches as :meth:`Zamba.decode_step` called once per prompt token.  A decode
step takes its position ``cur_len`` as a 0-d tensor on the device (a host
int is converted) and reads nothing on the host, so a serving session can
capture it into a CUDA graph (``serve/engine.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from .layers import (ParamTree, _residual, attention, cast_params,
                     dense_init, dt_of, embed, init_embed, init_norm, norm,
                     target_logprobs, unembed)
from .mamba2 import init_mamba_block, mamba_apply


def init_shared_attn(cfg, gen: torch.Generator) -> dict:
    da = 2 * cfg.d_model
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    return {
        "ln1": init_norm(da, cfg.norm, gen.device),
        "wq": dense_init(gen, (da, Hq * hd)),
        "wk": dense_init(gen, (da, Hkv * hd)),
        "wv": dense_init(gen, (da, Hkv * hd)),
        "wo": dense_init(gen, (Hq * hd, da), scale=1.0 / math.sqrt(Hq * hd)),
        "ln2": init_norm(da, cfg.norm, gen.device),
        "wg": dense_init(gen, (da, cfg.d_ff)),
        "wu": dense_init(gen, (da, cfg.d_ff)),
        "wd": dense_init(gen, (cfg.d_ff, da), scale=1.0 / math.sqrt(cfg.d_ff)),
        "wproj": dense_init(gen, (da, cfg.d_model), scale=1.0 / math.sqrt(da)),
    }


def shared_attn_apply(cfg, p, h, e0, positions, cache=None, cur_len=0,
                      decode=False):
    """h: hidden [B,T,d]; e0: initial embeddings [B,T,d].  With a cache
    ({"k","v": [B,Smax,Hkv,hd]}), a prefill or decode step of the
    attention that updates it in place (``layers.attend``)."""
    xa = torch.cat([h, e0], dim=-1)                            # [B,T,2d]
    y = norm(p["ln1"], xa, cfg.norm, cfg.norm_eps)
    xa = xa + attention(cfg, p, y, positions, cache, cur_len, decode)
    y = norm(p["ln2"], xa, cfg.norm, cfg.norm_eps)
    ff = F.silu(y @ p["wg"]) * (y @ p["wu"])
    xa = xa + _residual(ff @ p["wd"])
    return h + _residual(xa @ p["wproj"])


class Zamba(ParamTree):
    """zamba2 for serving: ``init_cache``, ``prefill``, ``decode_step``, the
    teacher-forced ``forward`` and its ``loss``.  Parameters come from a seeded
    ``torch.Generator`` on ``device`` (the card unless the caller asks for
    the CPU); load the JAX model's with
    ``load_state_dict(interop.params_from_numpy(tree, cfg))``."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0):
        if cfg.family != "hybrid":
            raise ValueError(f"Zamba needs a hybrid config, got {cfg.family}")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        super().__init__(cast_params(cfg, {
            "embed": init_embed(cfg, gen),
            "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
            "shared_attn": init_shared_attn(cfg, gen),
            "blocks": [init_mamba_block(cfg, gen)
                       for _ in range(cfg.n_layers)],
        }))
        self.cfg = cfg
        every = cfg.attn_every or 6
        self.attn_at = [i for i in range(cfg.n_layers) if i % every == 0]

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @torch.no_grad()
    def weights(self) -> dict:
        """The parameter tree in compute dtype, for serving and evaluation
        (a copy when that differs from f32; norms and SSM scalars stay f32,
        as the JAX model uses them)."""
        return self.tree(dt_of(self.cfg))

    def _run(self, w, x, positions, mamba_states, attn_caches, cur_len,
             decode):
        cfg = self.cfg
        e0 = x
        inv = 0
        for i, bp in enumerate(w["blocks"]):
            if i in self.attn_at:
                cache = None if attn_caches is None else attn_caches[inv]
                x = shared_attn_apply(cfg, w["shared_attn"], x, e0, positions,
                                      cache, cur_len, decode)
                inv += 1
            st = None if mamba_states is None else mamba_states[i]
            x = mamba_apply(cfg, bp, x, st, decode)
        return norm(w["final_norm"], x, cfg.norm, cfg.norm_eps)

    def _logits(self, w, tokens):
        x = embed(w["embed"], tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = self._run(w, x, positions, None, None, 0, False)
        return unembed(self.cfg, w["embed"], x)

    @torch.no_grad()
    def forward(self, tokens, w=None):
        """Teacher-forced logits [B,T,V] (f32) of tokens [B,T], no cache."""
        return self._logits(self.weights() if w is None else w, tokens)

    @torch.no_grad()
    def loss(self, batch, w=None):
        """Next-token cross-entropy of batch["tokens"] [B,T], the unmasked
        mean over the B x (T-1) predictions (``repro/models/zamba.py``)."""
        tokens = batch["tokens"]
        return -target_logprobs(self(tokens, w), tokens).mean()

    def train_loss(self, batch):
        """:meth:`loss` as training differentiates it, from the masters
        (the reference remats no zamba2 block).  Under ``attn_impl=
        "pallas"`` the kernels refuse the gradient (``kernels.ops``)."""
        tokens = batch["tokens"]
        w = self.tree(dt_of(self.cfg))
        return -target_logprobs(self._logits(w, tokens), tokens).mean()

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        """Per-layer SSM state (conv window in the compute dtype, ``h``
        always f32) and per-invocation KV slots in the compute dtype."""
        cfg = self.cfg
        dtype = dt_of(cfg)
        dev = self.device
        B = batch_size
        W, C = cfg.ssm_conv, cfg.d_inner + 2 * cfg.ssm_state
        H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        kv = (B, max_len, cfg.n_kv_heads, cfg.hd)
        return {
            "mamba": [{"conv": torch.zeros((B, W - 1, C), dtype=dtype,
                                           device=dev),
                       "h": torch.zeros((B, H, N, P), dtype=torch.float32,
                                        device=dev)}
                      for _ in range(cfg.n_layers)],
            "attn": [{"k": torch.zeros(kv, dtype=dtype, device=dev),
                      "v": torch.zeros(kv, dtype=dtype, device=dev)}
                     for _ in self.attn_at],
        }

    @torch.no_grad()
    def prefill(self, tokens, caches, w=None):
        """Run prompts tokens [B,T] (or ``{"tokens": ...}``) from empty
        caches (filled in place); returns the last position's logits
        [B,1,V] f32."""
        w = self.weights() if w is None else w
        tokens = tokens["tokens"] if isinstance(tokens, dict) else tokens
        x = embed(w["embed"], tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = self._run(w, x, positions, caches["mamba"], caches["attn"], 0,
                      False)
        return unembed(self.cfg, w["embed"], x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, tokens, caches, cur_len, w=None):
        """One token per row, tokens [B,1], at position ``cur_len`` (a 0-d
        integer tensor on the model's device, or an int); caches advance in
        place.  Returns logits [B,1,V] f32."""
        w = self.weights() if w is None else w
        cur_len = torch.as_tensor(cur_len, device=self.device)
        x = embed(w["embed"], tokens)
        positions = cur_len + torch.arange(x.shape[1], device=x.device)[None, :]
        x = self._run(w, x, positions, caches["mamba"], caches["attn"],
                      cur_len, True)
        return unembed(self.cfg, w["embed"], x), caches
