"""Deterministic synthetic data (``repro/data/synthetic.py``): a batch is a
pure function of (seed, step), drawn from the same numpy stream as the JAX
package, so both packages see the same prompts, patches and frames.

Token ids and labels are int64 here (int32 in the JAX package); front-end
embeddings are drawn in float64 and cast once to the compute dtype.
``SyntheticLoader`` is training's: shard ``shard`` of ``n_shards`` draws
its slice of step ``step`` from the seed ``seed * 131 + shard``, the
reference's rule, so a restarted run reads exactly the batches it would
have read.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.layers import DTYPES


def batch_spec(cfg, batch: int, seq: int) -> dict:
    """{name: (shape, dtype)} of one batch of ``seq`` positions (vision:
    ``n_patches`` patch embeddings and ``seq - n_patches`` tokens)."""
    cdt = DTYPES[cfg.dtype]
    if cfg.frontend == "audio":
        return {"embeds": ((batch, seq, cfg.d_model), cdt),
                "labels": ((batch, seq), torch.int64)}
    if cfg.frontend == "vision":
        return {"tokens": ((batch, seq - cfg.n_patches), torch.int64),
                "patch_embeds": ((batch, cfg.n_patches, cfg.d_model), cdt)}
    return {"tokens": ((batch, seq), torch.int64)}


def make_batch(cfg, batch: int, seq: int, step: int = 0, seed: int = 0,
               *, device="cuda"):
    """One batch matching :func:`batch_spec` on ``device``: token ids
    ``{"tokens"}``; under the audio front end ``{"embeds", "labels"}``;
    under the vision one ``{"tokens", "patch_embeds"}``."""
    dev = resolve_device(device)
    cdt = DTYPES[cfg.dtype]
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003)
                                + np.uint64(step))

    def ints(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(dev)

    def normal(shape):
        return torch.from_numpy(rng.standard_normal(shape) * 0.02).to(
            dev, cdt)

    if cfg.frontend == "audio":
        embeds = normal((batch, seq, cfg.d_model))
        return {"embeds": embeds, "labels": ints((batch, seq))}
    if cfg.frontend == "vision":
        tokens = ints((batch, seq - cfg.n_patches))
        return {"tokens": tokens,
                "patch_embeds": normal((batch, cfg.n_patches, cfg.d_model))}
    return {"tokens": ints((batch, seq))}


class SyntheticLoader:
    """Sharded iterator: each data shard regenerates its slice of a step's
    global batch on its own, on ``device``."""

    def __init__(self, cfg, global_batch: int, seq: int, seed: int = 0,
                 shard: int = 0, n_shards: int = 1, *, device="cuda"):
        if global_batch % n_shards:
            raise ValueError(f"a global batch of {global_batch} does not "
                             f"split into {n_shards} shards")
        self.cfg, self.seq, self.seed = cfg, seq, seed
        self.local_batch = global_batch // n_shards
        self.shard = shard
        self.device = resolve_device(device)

    def batch_at(self, step: int):
        return make_batch(self.cfg, self.local_batch, self.seq, step,
                          seed=self.seed * 131 + self.shard,
                          device=self.device)
