"""Decoder-only LM of the dense and MoE families (granite, stablelm,
starcoder2, llama3.2, the musicgen and internvl2 backbones, kimi-k2,
deepseek-v2), port of ``repro/models/transformer.py``: the teacher-forced
forward, the next-token loss and cached serving (``init_cache``,
``prefill``, ``decode_step``).

The module's parameters are the masters in ``cfg.param_dtype``, named as
the JAX parameter tree with its stacked layer axis unstacked
(``embed.tok``, ``blocks.3.attn.wq``, ``blocks.3.moe.router``,
``patch_proj``; load the JAX model's with
``interop.decoder_params_from_numpy``).  :meth:`DecoderLM.weights` casts
them once to the compute dtype where the JAX model casts at every use (no
copy where the two dtypes agree).  The blocks run in a Python loop where
the reference scans them, and its stacked caches are one dict per layer
here (``{"k","v"}``, or ``{"ckv","kr"}`` under MLA).

Serving and evaluation (``forward``, ``loss``, ``prefill``,
``decode_step``) run under ``no_grad``.  :meth:`DecoderLM.train_loss` is
the reference's ``loss`` as ``train_step`` differentiates it: the masters
cast to the compute dtype inside the autograd graph, each block under the
``cfg.remat`` policy (``layers.remat``: none, full, or keep the 2-D
products), the same number as ``loss``.

Every GQA attention without a cache, and the prefill's, goes through
``layers.sdpa``, so under
``attn_impl="pallas"`` a CUDA tensor runs the flash_attention kernel once
per layer; MLA runs the plain chunked attention (``models/moe.py``), as
the reference does.  A decode step reads nothing on the host.

A block's FFN is the MLP, or under ``n_experts`` the MoE FFN; the first
``first_dense_layers`` blocks of an MoE model keep the MLP (of ``d_ff``),
as ``ModelConfig.param_count`` counts them (the reference's blocks ignore
the field, ROADMAP C9; no config sets it).

Front ends (stubs, as in the reference): under ``frontend="vision"`` a
batch is ``{"tokens": [B, T], "patch_embeds": [B, P, d]}``, the patches
projected by ``patch_proj`` and prepended to the text, their positions out
of the loss; under ``"audio"`` it is ``{"embeds": [B, T, d], "labels":
[B, T]}``, precomputed frame embeddings, and a decode step takes the next
frame's embedding [B, 1, d] in place of a token.

Prefill is causal (ROADMAP C3): it computes the teacher-forced forward's
last logits and the caches of :meth:`DecoderLM.decode_step` called once per
prompt position.

Over a device mesh (``distributed.sharding``): with the parameters
placed by ``sharding.place_module``, the batch and the caches DTensors
and the mesh ambient (``sharding.use_mesh``), the same code runs
tensor-parallel over "model" and data-parallel over the batch axes, and a
decode step attends as ``cfg.decode_attn`` says (``"gather"`` or the
sequence-parallel ``"sp"``, ``layers.attend``); an MoE block's experts
and MLA run their mesh paths (``models/moe.py``).  Training over a mesh
takes the dense configs only (ROADMAP A21).
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..distributed.sharding import (BATCH, get_mode, keep_grad_layout,
                                    maybe_constraint, use_param, use_params)
from .layers import (ParamTree, attention, cast_params, dt_of, embed,
                     init_attn, init_embed, init_mlp, init_norm, mlp, norm,
                     remat, target_logprobs, unembed)
from .moe import init_mla, init_moe, mla_attention, moe_ffn


def init_block(cfg, gen: torch.Generator, layer: int) -> dict:
    dev = gen.device
    b = {"ln1": init_norm(cfg.d_model, cfg.norm, dev),
         "ln2": init_norm(cfg.d_model, cfg.norm, dev),
         "attn": init_mla(cfg, gen) if cfg.use_mla else init_attn(cfg, gen)}
    if cfg.n_experts and layer >= cfg.first_dense_layers:
        b["moe"] = init_moe(cfg, gen)
    else:
        b["mlp"] = init_mlp(cfg, gen)
    return b


def block_apply(cfg, bp, x, positions, cache=None, cur_len=0,
                decode=False):
    """One block; with a cache, a prefill or decode step that updates it
    in place (``layers.attend``, ``moe.mla_attention``).  Under fsdp over a
    mesh its weights are gathered first, together (``use_params``)."""
    bp = use_params(bp)
    attn = mla_attention if cfg.use_mla else attention
    x = x + attn(cfg, bp["attn"], norm(bp["ln1"], x, cfg.norm, cfg.norm_eps),
                 positions, cache, cur_len, decode)
    inner = norm(bp["ln2"], x, cfg.norm, cfg.norm_eps)
    if "moe" in bp:
        return x + moe_ffn(cfg, bp["moe"], inner)
    return x + mlp(cfg, bp["mlp"], inner)


class DecoderLM(ParamTree):
    """Dense or MoE decoder: ``forward`` (teacher-forced logits),
    ``loss``, ``init_cache``, ``prefill`` and ``decode_step``.  Parameters
    come from a seeded ``torch.Generator`` on ``device`` (the card unless
    the caller asks for the CPU), each cast to ``cfg.param_dtype`` as it is
    made."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"DecoderLM needs a dense or moe config, got "
                             f"{cfg.family}")
        if cfg.frontend not in (None, "audio", "vision"):
            raise ValueError(f"unknown frontend {cfg.frontend!r}")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tree = {
            "embed": cast_params(cfg, init_embed(cfg, gen)),
            "final_norm": cast_params(cfg, init_norm(cfg.d_model, cfg.norm,
                                                     dev)),
            "blocks": [cast_params(cfg, init_block(cfg, gen, i))
                       for i in range(cfg.n_layers)],
        }
        if cfg.frontend == "vision":
            tree["patch_proj"] = cast_params(cfg, torch.randn(
                (cfg.d_model, cfg.d_model), generator=gen, device=dev) * 0.02)
        super().__init__(tree)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @torch.no_grad()
    def weights(self) -> dict:
        """The parameter tree in compute dtype, for serving and evaluation
        (the parameters themselves where ``param_dtype`` is the compute
        dtype; norm scales as stored, as the JAX model uses them)."""
        return self.tree(dt_of(self.cfg))

    def embed_inputs(self, w, batch):
        """(x [B,T,d], labels [B,T] or None, loss mask [B,T] bool) of a
        batch (a dict, or token ids [B,T])."""
        if not isinstance(batch, dict):
            batch = {"tokens": batch}
        cdt = dt_of(self.cfg)
        if self.cfg.frontend == "audio":
            # the stub: precomputed EnCodec frame embeddings.
            x = batch["embeds"].to(cdt)
            mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
            return x, batch.get("labels"), mask
        tokens = batch["tokens"]
        x = embed(w["embed"], tokens)
        if self.cfg.frontend != "vision":
            return x, tokens, torch.ones(tokens.shape, dtype=torch.bool,
                                         device=x.device)
        # (over a mesh the patches' gradient is kept in their batch layout:
        # DTensor would scatter it along the patches, which the product's
        # backward cannot take once flattened)
        pe = keep_grad_layout(
            batch["patch_embeds"].to(cdt) @ use_param(w["patch_proj"]))
        B, P = pe.shape[:2]
        x = torch.cat([pe, x], dim=1)
        labels = torch.cat([tokens.new_zeros((B, P)), tokens], dim=1)
        mask = torch.cat([torch.zeros((B, P), dtype=torch.bool,
                                      device=x.device),
                          torch.ones(tokens.shape, dtype=torch.bool,
                                     device=x.device)], dim=1)
        return x, labels, mask

    def _run(self, w, x, positions, caches=None, cur_len=0, decode=False,
             policy="none"):
        cfg = self.cfg
        for i, bp in enumerate(w["blocks"]):
            if caches is None:
                x = remat(policy, block_apply, cfg, bp, x, positions)
            else:
                x = block_apply(cfg, bp, x, positions, caches[i], cur_len,
                                decode)
        return norm(w["final_norm"], x, cfg.norm, cfg.norm_eps)

    @torch.no_grad()
    def forward(self, batch, w=None):
        """Teacher-forced logits [B,T,V] (f32) of a batch (token ids [B,T]
        or a front end's dict; vision: T counts the patches)."""
        w = self.weights() if w is None else w
        x, _, _ = self.embed_inputs(w, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        return unembed(self.cfg, w["embed"], self._run(w, x, positions))

    def _loss(self, w, batch, policy="none"):
        # under fsdp over a mesh the tied table is gathered once for the
        # lookup and the unembedding both
        w = dict(w, embed=use_params(w["embed"]))
        x, labels, mask = self.embed_inputs(w, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        logits = unembed(self.cfg, w["embed"],
                         self._run(w, x, positions, policy=policy))
        # the reference's ``_shard_logits`` (the identity without a mesh).
        # Under fsdp its spec names "model" twice (the batch is over every
        # axis) and the reference's constraint fails and is dropped: the
        # logits keep the batch's layout, the vocab whole.
        vocab = None if get_mode() == "fsdp" else "model"
        logits = maybe_constraint(logits, BATCH, None, vocab)
        sel = target_logprobs(logits.float(), labels)
        m = (mask[:, 1:] & mask[:, :-1]).float()
        # under a mesh a partial sum over the batch's ranks, replicated
        return maybe_constraint(-(sel * m).sum() / m.sum().clamp(min=1.0))

    @torch.no_grad()
    def loss(self, batch, w=None):
        """Next-token cross-entropy, the mean over the loss mask: every
        prediction of a token batch (0 when T=1), the text of a vision
        batch after its first token, every frame's next label of an audio
        batch."""
        return self._loss(self.weights() if w is None else w, batch)

    def train_loss(self, batch):
        """:meth:`loss` as training differentiates it: from the masters,
        each block under ``cfg.remat``; ``backward()`` leaves each
        parameter's gradient in its ``param_dtype``."""
        return self._loss(self.tree(dt_of(self.cfg)), batch, self.cfg.remat)

    def init_cache(self, batch_size: int, max_len: int) -> list:
        """One cache per layer in the compute dtype: ``{"k","v": [B,
        max_len, Hkv, hd]}``, or under MLA ``{"ckv": [B, max_len, r], "kr":
        [B, max_len, rope_head_dim]}`` (the JAX model's ``scan_layers``
        stack, unstacked)."""
        cfg = self.cfg
        shapes = ({"ckv": (batch_size, max_len, cfg.kv_lora_rank),
                   "kr": (batch_size, max_len, cfg.rope_head_dim)}
                  if cfg.use_mla else
                  dict.fromkeys(("k", "v"), (batch_size, max_len,
                                             cfg.n_kv_heads, cfg.hd)))
        return [{k: torch.zeros(s, dtype=dt_of(cfg), device=self.device)
                 for k, s in shapes.items()} for _ in range(cfg.n_layers)]

    @torch.no_grad()
    def prefill(self, batch, caches, w=None):
        """Run prompts (token ids [B,T] or a front end's dict) from empty
        caches (filled in place); returns the last position's logits
        [B,1,V] f32."""
        w = self.weights() if w is None else w
        x, _, _ = self.embed_inputs(w, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = self._run(w, x, positions, caches)
        return unembed(self.cfg, w["embed"], x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, tokens, caches, cur_len, w=None):
        """One position per row at ``cur_len`` (a 0-d integer tensor on the
        model's device, or an int): tokens [B,1], or under the audio front
        end the frame embeddings [B,1,d]; caches advance in place.  Returns
        logits [B,1,V] f32."""
        w = self.weights() if w is None else w
        cur_len = torch.as_tensor(cur_len, device=self.device)
        x = (tokens.to(dt_of(self.cfg)) if self.cfg.frontend == "audio"
             else embed(w["embed"], tokens))
        positions = cur_len + torch.arange(x.shape[1], device=x.device)[None, :]
        x = self._run(w, x, positions, caches, cur_len, True)
        return unembed(self.cfg, w["embed"], x), caches
