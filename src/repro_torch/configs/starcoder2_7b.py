"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE.  [arXiv:2402.19173; hf]

The port's copy of ``repro/configs/starcoder2_7b.py``: ``CONFIG`` and
``reduced()`` are the same values."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152, head_dim=128,
    activation="gelu", norm="ln", rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, remat="none", dtype="float32")
