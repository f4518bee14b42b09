"""Deterministic synthetic data (``repro/data/synthetic.py``): a batch is a
pure function of (seed, step), drawn from the same numpy stream as the JAX
package, so both packages see the same prompts."""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device


def make_batch(cfg, batch: int, seq: int, step: int = 0, seed: int = 0,
               *, device="cuda"):
    """One batch of token ids ``{"tokens": [batch, seq] int64}`` on
    ``device``.  Token-only configs; the audio/vision front-end stubs come
    with their slices."""
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"frontend={cfg.frontend!r} batches are not in the PyTorch port "
            f"yet; they come with a later slice of the LM substrate "
            f"(ROADMAP A9)")
    rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003)
                                + np.uint64(step))
    toks = rng.integers(0, cfg.vocab_size, (batch, seq))
    return {"tokens": torch.from_numpy(toks).to(resolve_device(device))}
