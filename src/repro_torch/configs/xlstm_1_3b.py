"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (7:1).  [arXiv:2405.04517; unverified]

O(1) recurrent state → runs the long_500k shape.

The port's copy of ``repro/configs/xlstm_1_3b.py``: ``CONFIG`` and
``reduced()`` are the same values."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    norm="rms", slstm_every=8, mlstm_chunk=128,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=2, n_kv_heads=2,
        vocab_size=256, slstm_every=3, mlstm_chunk=16, remat="none",
        dtype="float32")
