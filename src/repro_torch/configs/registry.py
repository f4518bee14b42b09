"""Arch registry of the port: ``--arch <id>`` → ModelConfig (full or reduced).

``ARCHS`` holds the JAX package's names (a test holds the two lists equal).
Only the architectures that a ported slice can run have a configuration
here; asking for another raises ``NotImplementedError`` naming the slice
that brings it.
"""
from __future__ import annotations

from importlib import import_module

ARCHS = {
    "granite-3-2b": None,
    "stablelm-12b": None,
    "starcoder2-7b": None,
    "llama3.2-3b": "llama3_2_3b",
    "kimi-k2-1t-a32b": None,
    "deepseek-v2-lite-16b": None,
    "musicgen-medium": None,
    "internvl2-1b": None,
    "xlstm-1.3b": None,
    "zamba2-1.2b": "zamba2_1_2b",
}

_LATER = "a later slice of the LM substrate (ROADMAP A9)"


def get_config(arch: str, reduced: bool = False):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    if ARCHS[arch] is None:
        raise NotImplementedError(
            f"{arch} is not in the PyTorch port yet; it comes with "
            f"{_LATER}")
    mod = import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.reduced() if reduced else mod.CONFIG


def all_archs():
    return list(ARCHS)
