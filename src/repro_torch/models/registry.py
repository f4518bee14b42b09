"""Model registry of the port: ModelConfig.family → model implementation."""
from __future__ import annotations

from .transformer import DecoderLM
from .xlstm import XLSTM
from .zamba import Zamba


def build_model(cfg, *, device="cuda", seed: int = 0):
    if cfg.family in ("dense", "moe"):
        return DecoderLM(cfg, device=device, seed=seed)
    if cfg.family == "xlstm":
        return XLSTM(cfg, device=device, seed=seed)
    if cfg.family == "hybrid":
        return Zamba(cfg, device=device, seed=seed)
    raise ValueError(f"unknown family {cfg.family}")
