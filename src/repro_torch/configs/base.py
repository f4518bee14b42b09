"""Model configuration schema of the port: the JAX package's
``ModelConfig`` (``repro/configs/base.py``), copied field for field so that
``reduced()`` and ``dataclasses.replace`` work alike in both packages.

``remat`` selects the training loss's checkpointing (``layers.remat``).
``sharding_mode`` (megatron or fsdp, ``distributed.sharding.set_mode``)
and ``decode_attn`` (a decode step's ``"gather"`` or sequence-parallel
``"sp"`` attention, ``layers.attend``) are read over a device mesh.
``moe_buf_layout`` (``"md"``, ``"m"`` or ``"none"``) places the MoE expert
buffer over a mesh (``models.moe``); ``scan_layers`` is kept for the
copy's sake and read by nothing in the port.  ``TrainConfig`` is
the reference's, field for field; so are ``ShapeConfig`` and ``SHAPES``,
the dry run's cells (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | xlstm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // n_heads
    activation: str = "swiglu"      # swiglu | gelu
    norm: str = "rms"               # rms | ln
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0     # leading dense layers before MoE starts
    capacity_factor: float = 1.25

    # MLA (DeepSeek)
    use_mla: bool = False
    kv_lora_rank: int = 0
    rope_head_dim: int = 64

    # SSM / recurrent
    ssm_state: int = 0              # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64          # P
    ssm_conv: int = 4
    attn_every: int = 0             # zamba: shared attn block interval
    slstm_every: int = 0            # xlstm: 1-in-k blocks are sLSTM

    # frontend stub (audio/vlm): model consumes precomputed embeddings
    frontend: Optional[str] = None  # None | audio | vision
    n_patches: int = 256            # vision: patches prepended to text

    # execution
    scan_layers: bool = True
    remat: str = "full"             # none | full | dots
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"
    attn_impl: str = "jnp"          # jnp | pallas
    ssd_chunk: int = 128
    mlstm_chunk: int = 128
    attn_chunk: int = 1024          # KV block for chunked attention
    logits_fp32: bool = True        # False → bf16 logits (halves loss temps)
    attn_f32: bool = True           # False → bf16 attention compute (f32 stats)
    mlstm_bf16: bool = False        # bf16 chunk intermediates, f32 accum
    moe_buf_layout: str = "md"      # expert-buffer constraint: md | m | none
    sharding_mode: str = "megatron"  # megatron (TP) | fsdp (ZeRO-3 over all axes)
    decode_attn: str = "gather"     # gather (XLA default) | sp (flash-decoding:
                                    # partial softmax over the S-sharded cache,
                                    # psum-merged — no cache all-gather)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe"):
            if self.use_mla:
                r, rd = self.kv_lora_rank, self.rope_head_dim
                per_layer += d * (Hq * (hd + rd))            # q proj
                per_layer += d * r + d * rd                  # kv down + k_rope
                per_layer += r * Hq * (hd + hd)              # kv up (k_nope, v)
                per_layer += Hq * hd * d                     # o proj
            else:
                per_layer += d * Hq * hd + 2 * d * Hkv * hd + Hq * hd * d
            n_mat = 3 if self.activation == "swiglu" else 2
            if self.family == "moe":
                moe_layers = L - self.first_dense_layers
                dense_layers = self.first_dense_layers
                per_layer = per_layer  # attn for all layers
                ffn_moe = (self.n_experts * n_mat * d * self.moe_d_ff
                           + self.n_shared_experts * n_mat * d * self.moe_d_ff
                           + d * self.n_experts)
                ffn_dense = n_mat * d * self.d_ff
                total = emb + L * per_layer + moe_layers * ffn_moe \
                    + dense_layers * ffn_dense
                return total
            per_layer += n_mat * d * self.d_ff
        elif self.family == "xlstm":
            di = 2 * d
            per_layer = d * di * 2 + di * d + 3 * di  # up(x2), down, gates-ish
        elif self.family == "hybrid":
            di = self.d_inner
            per_layer = (d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                         + di * d + self.ssm_conv * di)
            n_shared = max(1, L // max(1, self.attn_every))
            shared = (2 * d) * 3 * d + d * d + 3 * (2 * d) * self.d_ff // 2
            return emb + L * per_layer + shared
        return emb + L * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d, L = self.d_model, self.n_layers
        n_mat = 3 if self.activation == "swiglu" else 2
        full = self.param_count()
        moe_layers = L - self.first_dense_layers
        all_experts = moe_layers * self.n_experts * n_mat * d * self.moe_d_ff
        active_experts = moe_layers * self.experts_per_token * n_mat * d * self.moe_d_ff
        return full - all_experts + active_experts


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatch: int = 0              # 0 → no accumulation
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = "ckpt"
    keep_checkpoints: int = 3
