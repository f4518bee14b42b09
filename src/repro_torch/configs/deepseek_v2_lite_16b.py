"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H (MLA) d_ff=1408
vocab=102400, MoE 64e top-6 — MLA kv_lora=512, 2 shared + routed top-6.
[arXiv:2405.04434; hf]

The port's copy of ``repro/configs/deepseek_v2_lite_16b.py``: ``CONFIG`` and
``reduced()`` are the same values."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    activation="swiglu", norm="rms", rope_theta=10_000.0,
    n_experts=64, experts_per_token=6, n_shared_experts=2, moe_d_ff=1408,
    use_mla=True, kv_lora_rank=512, rope_head_dim=64,
    capacity_factor=1.25,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=64, vocab_size=256, n_experts=8, experts_per_token=2,
        n_shared_experts=2, moe_d_ff=64, kv_lora_rank=32, rope_head_dim=8,
        remat="none", dtype="float32")
