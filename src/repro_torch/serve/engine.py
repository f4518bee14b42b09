"""Serving of the port (``repro/serve/engine.py``): a batched greedy
prefill + decode session on one device, for every family (dense and MoE
decoders, their vision and audio front ends, xLSTM, the zamba2 hybrid).

The reference compiles its decode step once per session
(``jax.jit(make_decode_step(model))``) and passes the position ``cur_len``
as a device scalar.  Here the session owns, on the device, the position
``cur_len`` (a 0-d int64 tensor), the step's input buffer (tokens [B, 1],
or frame embeddings [B, 1, d] under the audio front end) and the caches
(KV, MLA latents, SSM or xLSTM states), which the models update in place;
one decode step is "``decode_step`` → argmax into the token buffer →
``cur_len += 1``" and reads nothing on the host.  On a CUDA device the
first decode step of a session runs eagerly (it loads what the step needs)
and the second captures that step into one CUDA graph
(``core.graphs.capture``), which it and every later step replay; the
capture itself advances nothing.  On the CPU every step runs eagerly.  A
failed capture or replay raises; nothing falls back to the eager loop.  The
host keeps a mirror of the length for its bound checks and never reads the
device's.

The position after a prefill is the prompt's whole length: under the vision
front end ``n_patches + T_text``, where the reference takes ``T_text``
(ROADMAP C8).  Under the audio front end the greedy loop cannot run: the
EnCodec front end is a stub, so a generated codebook token has no frame
embedding to feed back (the reference feeds the token ids as activations
and fails, ROADMAP C7).  Such a session decodes given frames instead
(:meth:`ServeSession.decode_frames`).

Over a device mesh (``distributed.sharding``) the caches are laid out by
:func:`cache_shardings`, the reference's rule, and a step runs through
:func:`make_prefill` and :func:`make_decode_step` with the mesh ambient.
The session stays one device, as the reference's does: across ranks the
steps run eagerly (a gloo collective cannot be captured in a CUDA graph).
"""
from __future__ import annotations

import math

import torch

from ..core.device import resolve_device
from ..core.graphs import capture, replay
from ..distributed.sharding import axis_sizes, tree_map_with_path
from ..models.layers import dt_of


def cache_shardings(caches, mesh, batch_size: int):
    """The spec of every cache leaf (the reference's rule): the
    batch-sized dim over ``("pod", "data")`` where it divides; the largest
    remaining dim divisible by the "model" axis over "model" — for a GQA
    KV cache [B, S, Hkv, hd] that is the sequence (a context-parallel
    cache) or the kv-head dim, for MLA the latent sequence, for SSM states
    the feature dims."""
    sizes = axis_sizes(mesh)
    bnames = tuple(a for a in ("pod", "data") if a in sizes)
    bsize = math.prod(sizes[n] for n in bnames) if bnames else 1
    msize = sizes.get("model", 1)

    def spec_for(path, leaf):
        spec = [None] * leaf.ndim
        bdim = None
        for i, s in enumerate(leaf.shape):
            if s == batch_size and bnames and s % bsize == 0:
                spec[i] = bnames
                bdim = i
                break
        if "model" in sizes and msize > 1:
            cands = [(s, i) for i, s in enumerate(leaf.shape)
                     if i != bdim and s % msize == 0 and s >= msize]
            if cands:
                _, mdim = max(cands)
                spec[mdim] = "model"
        return tuple(spec)

    return tree_map_with_path(spec_for, caches)


def make_decode_step(model):
    """``decode_step(params, tokens, caches, cur_len)``: the reference's
    factory, ``params`` the compute-dtype weights tree."""
    def decode_step(params, tokens, caches, cur_len):
        return model.decode_step(tokens, caches, cur_len, w=params)
    return decode_step


def make_prefill(model):
    """``prefill(params, batch, caches)``: the reference's factory."""
    def prefill(params, batch, caches):
        return model.prefill(batch, caches, w=params)
    return prefill


def prompt_length(batch) -> int:
    """Positions a prefill of ``batch`` fills: the frames of an audio
    batch, the tokens plus a vision batch's patches, or the tokens."""
    if "embeds" in batch:
        return batch["embeds"].shape[1]
    n = batch["tokens"].shape[1]
    if "patch_embeds" in batch:
        n += batch["patch_embeds"].shape[1]
    return n


class ServeSession:
    """Greedy serving of one batch of prompts.

    The model's weights are cast to the compute dtype once, here.  Next
    tokens stay on the device: nothing in :meth:`prefill` or :meth:`decode`
    waits for the card.  ``logits`` keeps each step's last-position logits
    [B, V] (f32), the prefill's first; ``captures``, ``replays`` and
    ``eager_steps`` count the decode graph's captures and replays and the
    decode steps run eagerly."""

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
        #: the position of the next token, on the device.
        self.cur_len = torch.zeros((), dtype=torch.long, device=dev)
        #: its mirror on the host, for the bound checks.
        self.length = 0
        #: the greedy token of each step: the next step's input, or under
        #: the audio front end only its output.
        self.tokens = torch.zeros((batch_size, 1), dtype=torch.long,
                                  device=dev)
        cfg = model.cfg
        self.audio = cfg.frontend == "audio"
        #: under the audio front end, the frame each decode step reads.
        self.frames = (torch.zeros((batch_size, 1, cfg.d_model),
                                   dtype=dt_of(cfg), device=dev)
                       if self.audio else None)
        self.logits = []
        self._graph = None
        self.captures = self.replays = self.eager_steps = 0

    def prefill(self, batch) -> torch.Tensor:
        """Prompts ({"tokens": [B, T]}, or a front end's batch) → the first
        generated token [B]."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        n = prompt_length(batch)
        if n > self.max_len:
            raise ValueError(f"prompt of {n} positions exceeds the cache's "
                             f"{self.max_len}")
        logits, self.caches = self.model.prefill(batch, self.caches,
                                                 self.weights)
        self.cur_len.fill_(n)
        self.length = n
        self.logits = [logits[:, -1]]
        return torch.argmax(logits[:, -1], dim=-1)

    def decode(self, tokens, n_steps: int) -> torch.Tensor:
        """Feed tokens [B] and decode ``n_steps`` greedy tokens → [B, n_steps]."""
        if self.audio:
            raise NotImplementedError(
                f"{self.model.cfg.name}: the EnCodec front end is a stub, so "
                f"a generated codebook token has no frame embedding to feed "
                f"back; decode given frames with decode_frames (ROADMAP C7)")
        B = self.tokens.shape[0]
        self.tokens.copy_(tokens.reshape(B, 1))
        return self._decode(n_steps)

    def decode_frames(self, frames) -> torch.Tensor:
        """Audio front end: feed the given frame embeddings frames [B, n, d]
        one position a step and return each step's greedy codebook token
        → [B, n]."""
        if not self.audio:
            raise ValueError("decode_frames needs the audio front end")
        return self._decode(frames.shape[1], frames.to(self.device))

    def _decode(self, n_steps: int, frames=None) -> torch.Tensor:
        if self.length + n_steps > self.max_len:
            raise ValueError(f"{n_steps} steps from position {self.length} "
                             f"exceed the cache's {self.max_len}")
        B = self.tokens.shape[0]
        out = torch.empty((B, n_steps), dtype=torch.long, device=self.device)
        logits = None
        for i in range(n_steps):
            if frames is not None:
                self.frames.copy_(frames[:, i:i + 1])
            step = self._advance()
            if logits is None:
                logits = step.new_empty((n_steps,) + tuple(step.shape))
            # copies: a replay rewrites the graph's outputs.
            logits[i].copy_(step)
            out[:, i].copy_(self.tokens[:, 0])
            self.length += 1
        if n_steps:
            self.logits.extend(logits.unbind(0))
        return out

    def _step(self) -> torch.Tensor:
        """One decode step on the session's device state → logits [B, V]."""
        logits, _ = self.model.decode_step(
            self.frames if self.audio else self.tokens, self.caches,
            self.cur_len, self.weights)
        self.tokens.copy_(torch.argmax(logits[:, -1:], dim=-1))
        self.cur_len.add_(1)
        return logits[:, -1]

    def _advance(self) -> torch.Tensor:
        """One decode step: eager on the CPU and for a session's first step
        on the card, a replay of the captured step after that."""
        if self.device.type != "cuda" or not self.eager_steps:
            self.eager_steps += 1
            return self._step()
        if self._graph is None:
            self._graph = capture(self._step, torch.cuda.graph_pool_handle())
            self.captures += 1
        graph, launched, logits = self._graph
        replay(graph, launched)
        self.replays += 1
        return logits
