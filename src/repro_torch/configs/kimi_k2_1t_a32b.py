"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384e top-8 — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]

Per the assignment table this uses GQA (kv=8) attention; the released K2 uses
MLA — we follow the table (noted in DESIGN.md).  1 shared expert (K2 style).

The port's copy of ``repro/configs/kimi_k2_1t_a32b.py``: ``CONFIG`` and
``reduced()`` are the same values."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=128,
    activation="swiglu", norm="rms", rope_theta=50_000.0,
    n_experts=384, experts_per_token=8, n_shared_experts=1, moe_d_ff=2048,
    capacity_factor=1.25,
    # 1T params: bf16 master weights + bf16 Adam moments are the only way the
    # state approaches the 512-chip HBM budget (see EXPERIMENTS.md §Dry-run).
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=256, n_experts=8, experts_per_token=2,
        n_shared_experts=1, moe_d_ff=64, remat="none", dtype="float32")
