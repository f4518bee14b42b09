"""musicgen-medium [audio] — 48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a STUB — input_specs() provides
precomputed frame embeddings [B, T, d]; the LM head predicts codebook tokens
(vocab 2048).

The port's copy of ``repro/configs/musicgen_medium.py``: ``CONFIG`` and
``reduced()`` are the same values."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="dense",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048, head_dim=64,
    activation="gelu", norm="ln", rope_theta=10_000.0,
    frontend="audio",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, remat="none", dtype="float32")
