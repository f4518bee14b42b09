"""Serving of the port (``repro/serve/engine.py``): a batched greedy
prefill + decode session on one device.  The multi-device cache shardings
come with the multi-device slice."""
from __future__ import annotations

import torch

from ..core.device import resolve_device


class ServeSession:
    """Greedy serving of one batch of prompts.

    The model's weights are cast to the compute dtype once, here.  Next
    tokens stay on the device: nothing in :meth:`prefill` or :meth:`decode`
    waits for the card.  ``logits`` keeps each step's last-position logits
    [B, V] (f32), the prefill's first."""

    def __init__(self, model, batch_size: int, max_len: int, *,
                 device="cuda"):
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"the model lives on {model.device}, the session "
                             f"was asked to serve on {dev}")
        self.model = model
        self.device = dev
        self.max_len = max_len
        self.caches = model.init_cache(batch_size, max_len)
        self.weights = model.weights()
        self.cur_len = 0
        self.logits = []

    def prefill(self, batch) -> torch.Tensor:
        """Prompts {"tokens": [B, T]} → the first generated token [B]."""
        tokens = batch["tokens"].to(self.device)
        if tokens.shape[1] > self.max_len:
            raise ValueError(f"prompt of {tokens.shape[1]} tokens exceeds the "
                             f"cache's {self.max_len}")
        logits, self.caches = self.model.prefill(tokens, self.caches,
                                                 self.weights)
        self.cur_len = tokens.shape[1]
        self.logits = [logits[:, -1]]
        return torch.argmax(logits[:, -1], dim=-1)

    def decode(self, tokens, n_steps: int) -> torch.Tensor:
        """Feed tokens [B] and decode ``n_steps`` greedy tokens → [B, n_steps]."""
        if self.cur_len + n_steps > self.max_len:
            raise ValueError(f"{n_steps} steps from position {self.cur_len} "
                             f"exceed the cache's {self.max_len}")
        toks = tokens.to(self.device).reshape(-1, 1)
        out = []
        for _ in range(n_steps):
            logits, self.caches = self.model.decode_step(
                toks, self.caches, self.cur_len, self.weights)
            self.logits.append(logits[:, -1])
            toks = torch.argmax(logits[:, -1:], dim=-1)
            out.append(toks[:, 0])
            self.cur_len += 1
        return torch.stack(out, dim=1)
