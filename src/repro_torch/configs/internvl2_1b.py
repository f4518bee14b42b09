"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2.  [arXiv:2404.16821; hf]

Backbone (InternLM2-ish) only: the InternViT frontend is a STUB —
input_specs() provides precomputed patch embeddings [B, n_patches, d] that the
model projects and prepends to the token sequence; loss masks image positions.

The port's copy of ``repro/configs/internvl2_1b.py``: ``CONFIG`` and
``reduced()`` are the same values."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    activation="swiglu", norm="rms", rope_theta=10_000.0,
    frontend="vision", n_patches=256,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, n_patches=8, remat="none", dtype="float32")
