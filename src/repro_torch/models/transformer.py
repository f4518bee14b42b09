"""Decoder-only LM of the dense family (llama3.2, granite, stablelm,
starcoder2 backbones), port of ``repro/models/transformer.py``: the
teacher-forced forward, the next-token loss and cached serving
(``init_cache``, ``prefill``, ``decode_step``).

The module's parameters are the f32 masters, named as the JAX parameter
tree with its stacked layer axis unstacked (``embed.tok``,
``blocks.3.attn.wq``, ``blocks.3.ln1.scale``, ``final_norm.scale``; load the
JAX model's with ``interop.decoder_params_from_numpy``).
:meth:`DecoderLM.weights` casts them once to the compute dtype where the JAX
model casts at every use.  The blocks run in a Python loop: the reference's
``lax.scan`` and ``remat`` have no counterpart in a forward pass, and its
stacked caches are one ``{"k","v"}`` per layer here.  Every attention
without a cache, and the prefill's, goes through ``layers.sdpa``, so under
``attn_impl="pallas"`` a CUDA tensor runs the flash_attention kernel once
per layer; a decode step attends over the whole cache with a length mask
(``layers.attn_masked_decode``) and reads nothing on the host.

Prefill is causal (ROADMAP C3): it computes the teacher-forced forward's
last logits and the caches of :meth:`DecoderLM.decode_step` called once per
prompt token.  MoE, MLA and the audio/vision front ends come with later
slices (ROADMAP A9).
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from .layers import (ParamTree, attention, dt_of, embed, init_attn,
                     init_embed, init_mlp, init_norm, mlp, norm,
                     target_logprobs, unembed)


def init_block(cfg, gen: torch.Generator) -> dict:
    dev = gen.device
    return {"ln1": init_norm(cfg.d_model, cfg.norm, dev),
            "ln2": init_norm(cfg.d_model, cfg.norm, dev),
            "attn": init_attn(cfg, gen), "mlp": init_mlp(cfg, gen)}


def block_apply(cfg, bp, x, positions, cache=None, cur_len=0,
                decode=False):
    """One block; with a cache, a prefill or decode step that updates it
    in place (``layers.attend``)."""
    x = x + attention(cfg, bp["attn"], norm(bp["ln1"], x, cfg.norm,
                                            cfg.norm_eps), positions,
                      cache, cur_len, decode)
    return x + mlp(cfg, bp["mlp"], norm(bp["ln2"], x, cfg.norm, cfg.norm_eps))


class DecoderLM(ParamTree):
    """Dense decoder: ``forward`` (teacher-forced logits), ``loss``,
    ``init_cache``, ``prefill`` and ``decode_step``.  Parameters come from a seeded ``torch.Generator`` on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0):
        if cfg.family != "dense":
            raise ValueError(f"DecoderLM needs a dense config, got "
                             f"{cfg.family}")
        later = [what for what, on in (
            ("MoE", cfg.n_experts), ("MLA", cfg.use_mla),
            (f"the {cfg.frontend} front end", cfg.frontend)) if on]
        if later:
            raise NotImplementedError(
                f"{', '.join(later)} ({cfg.name}) is not in the PyTorch port "
                f"yet; it comes with a later slice of the LM substrate "
                f"(ROADMAP A9)")
        if cfg.param_dtype != "float32":
            raise NotImplementedError(
                f"param_dtype={cfg.param_dtype!r}: the port keeps f32 master "
                f"weights only until the training slice")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        super().__init__({
            "embed": init_embed(cfg, gen),
            "final_norm": init_norm(cfg.d_model, cfg.norm, dev),
            "blocks": [init_block(cfg, gen) for _ in range(cfg.n_layers)],
        })
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def weights(self) -> dict:
        """The parameter tree in compute dtype (a copy when that differs
        from f32; norm scales stay f32, as the JAX model uses them)."""
        return self.tree(dt_of(self.cfg))

    def _run(self, w, x, positions, caches=None, cur_len=0, decode=False):
        cfg = self.cfg
        for i, bp in enumerate(w["blocks"]):
            x = block_apply(cfg, bp, x, positions,
                            None if caches is None else caches[i], cur_len,
                            decode)
        return norm(w["final_norm"], x, cfg.norm, cfg.norm_eps)

    @torch.no_grad()
    def forward(self, tokens, w=None):
        """Teacher-forced logits [B,T,V] (f32) of tokens [B,T]."""
        w = self.weights() if w is None else w
        x = embed(w["embed"], tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        return unembed(self.cfg, w["embed"], self._run(w, x, positions))

    @torch.no_grad()
    def loss(self, batch, w=None):
        """Next-token cross-entropy of batch["tokens"] [B,T]: the mean over
        the loss mask, which for tokens is every prediction (0 when T=1)."""
        tokens = batch["tokens"]
        sel = target_logprobs(self(tokens, w), tokens)
        return -sel.sum() / max(sel.numel(), 1)

    def init_cache(self, batch_size: int, max_len: int) -> list:
        """One ``{"k","v": [B, max_len, Hkv, hd]}`` per layer in the
        compute dtype (the JAX model's ``scan_layers`` stack, unstacked)."""
        cfg = self.cfg
        kv = (batch_size, max_len, cfg.n_kv_heads, cfg.hd)
        return [{k: torch.zeros(kv, dtype=dt_of(cfg), device=self.device)
                 for k in ("k", "v")} for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def prefill(self, tokens, caches, w=None):
        """Run prompts tokens [B,T] from empty caches (filled in place);
        returns the last position's logits [B,1,V] f32."""
        w = self.weights() if w is None else w
        x = embed(w["embed"], tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = self._run(w, x, positions, caches)
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
        x = self._run(w, x, positions, caches, cur_len, True)
        return unembed(self.cfg, w["embed"], x), caches
