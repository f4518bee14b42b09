"""Arch registry of the port: ``--arch <id>`` → ModelConfig (full or reduced).

``ARCHS`` holds the JAX package's names and modules (a test holds the two
lists equal); every architecture has its configuration here.
"""
from __future__ import annotations

from importlib import import_module

ARCHS = {
    "granite-3-2b": "granite_3_2b",
    "stablelm-12b": "stablelm_12b",
    "starcoder2-7b": "starcoder2_7b",
    "llama3.2-3b": "llama3_2_3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "musicgen-medium": "musicgen_medium",
    "internvl2-1b": "internvl2_1b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-1.2b": "zamba2_1_2b",
}

# archs whose attention is quadratic-only → long_500k is skipped (the
# reference's list, ``repro/configs/registry.py``).
FULL_ATTENTION_ONLY = {
    "granite-3-2b", "stablelm-12b", "starcoder2-7b", "llama3.2-3b",
    "kimi-k2-1t-a32b", "deepseek-v2-lite-16b", "musicgen-medium",
    "internvl2-1b",
}


def get_config(arch: str, reduced: bool = False):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.reduced() if reduced else mod.CONFIG


def all_archs():
    return list(ARCHS)
