"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 — Mamba2 + shared attn blocks.  [arXiv:2411.15242; hf]

The port's copy of ``repro/configs/zamba2_1_2b.py``: ``CONFIG`` and
``reduced()`` are the same values."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=128,
    norm="rms", rope_theta=10_000.0,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, attn_every=6,
    ssd_chunk=128,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16, attn_every=2,
        ssd_chunk=16, remat="none", dtype="float32")
