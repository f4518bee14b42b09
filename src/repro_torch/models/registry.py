"""Model registry of the port: ModelConfig.family → model implementation.

Only the families of the ported slices build; another raises
``NotImplementedError`` naming the slice that brings it."""
from __future__ import annotations

from .transformer import DecoderLM
from .zamba import Zamba

#: families whose model comes with a later slice of the LM substrate.
_LATER = ("moe", "xlstm")


def build_model(cfg, *, device="cuda", seed: int = 0):
    if cfg.family == "hybrid":
        return Zamba(cfg, device=device, seed=seed)
    if cfg.family == "dense":
        return DecoderLM(cfg, device=device, seed=seed)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not in the PyTorch port "
            f"yet; it comes with a later slice of the LM substrate "
            f"(ROADMAP A9)")
    raise ValueError(f"unknown family {cfg.family}")
