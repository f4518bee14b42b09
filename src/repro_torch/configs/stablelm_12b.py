"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352.  [hf:stabilityai/stablelm-2-1_6b; hf]

The port's copy of ``repro/configs/stablelm_12b.py``: ``CONFIG`` and
``reduced()`` are the same values."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352, head_dim=160,
    activation="swiglu", norm="rms", rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=256, remat="none", dtype="float32")
