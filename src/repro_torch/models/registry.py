"""Model registry of the port: ModelConfig.family → model implementation.

Only the families of the ported slices build; another raises
``NotImplementedError`` naming the slice that brings it."""
from __future__ import annotations

from .zamba import Zamba

_LATER = {
    "dense": "the no-cache forward slice (ROADMAP B2) and the dense serving "
             "slice after it",
    "moe": "a later slice of the LM substrate (ROADMAP A15)",
    "xlstm": "a later slice of the LM substrate (ROADMAP A15)",
}


def build_model(cfg, *, device="cuda", seed: int = 0):
    if cfg.family == "hybrid":
        return Zamba(cfg, device=device, seed=seed)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not in the PyTorch port "
            f"yet; it comes with {_LATER[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family}")
