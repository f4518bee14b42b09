"""Fake-tensor stand-ins for every (arch x shape) dry-run cell
(``repro/launch/specs.py``): the model, its parameters, the optimizer
state, the batch and the caches at full size, made under one
``FakeTensorMode`` on the CPU device, so nothing is allocated.

The fake tensors sit on the CPU device, not on ``meta``: a model's seeded
``torch.Generator`` cannot be made on ``meta``, and ``kernels/ops.py``
sends a CPU tensor to a kernel's plain twin, which runs on fake tensors as
on real ones (a fake CUDA tensor would reach a ctypes launch).
"""
from __future__ import annotations

import dataclasses

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.base import SHAPES, ShapeConfig
from ..configs.registry import FULL_ATTENTION_ONLY, get_config
from ..data.synthetic import batch_spec
from ..models.layers import DTYPES
from ..models.registry import build_model
from ..train import optimizer as opt


def cell_is_skipped(arch: str, shape_name: str) -> str | None:
    """Returns a skip reason or None."""
    if shape_name == "long_500k" and arch in FULL_ATTENTION_ONLY:
        return ("pure full-attention arch: 524k-token quadratic prefill is "
                "not representable without sub-quadratic attention "
                "(DESIGN.md §Arch-applicability)")
    return None


def input_specs(arch: str, shape_name: str, overrides: dict | None = None):
    """Returns a dict describing what to run for this cell:

    kind=train:   {params, opt_state, batch}
    kind=prefill: {params, batch, caches}
    kind=decode:  {params, tokens, caches, cur_len}

    and, for every kind, ``kind``, ``cfg``, ``model`` and ``mode`` (the
    ``FakeTensorMode`` that made the tensors; run the step under it).
    ``params`` are the model's own parameters (the masters).

    overrides: ModelConfig field=value replacements (hillclimb variants);
    keys prefixed "train." are handled by the caller.
    """
    cfg = get_config(arch)
    model_over = {k: v for k, v in (overrides or {}).items()
                  if not k.startswith("train.") and not k.startswith("_")}
    if model_over:
        cfg = dataclasses.replace(cfg, **model_over)
    return specs_for(cfg, SHAPES[shape_name])


def specs_for(cfg, shape: ShapeConfig, reuse: dict | None = None):
    """:func:`input_specs` of a config and a ``ShapeConfig`` (a dry-run
    cell or any other), under a new ``FakeTensorMode``; ``reuse``, the
    dict of an earlier call for the same config, lends its mode and
    model."""
    mode = FakeTensorMode() if reuse is None else reuse["mode"]
    B, T = shape.global_batch, shape.seq_len
    with mode:
        model = build_model(cfg, device="cpu") if reuse is None \
            else reuse["model"]
        params = dict(model.named_parameters())
        out = {"kind": shape.kind, "cfg": cfg, "model": model, "mode": mode,
               "params": params}
        if shape.kind == "train":
            out["opt_state"] = opt.init(params)
            out["batch"] = _batch(cfg, B, T)
            return out
        out["caches"] = model.init_cache(B, T)
        if shape.kind == "prefill":
            out["batch"] = _batch(cfg, B, T)
            return out
        # decode: one new token against a cache of seq_len, at its last row
        if cfg.frontend == "audio":
            out["tokens"] = torch.empty((B, 1, cfg.d_model),
                                        dtype=DTYPES[cfg.dtype])
        else:
            out["tokens"] = torch.zeros((B, 1), dtype=torch.int64)
        out["cur_len"] = torch.tensor(T - 1)
        return out


def _batch(cfg, batch: int, seq: int) -> dict:
    """A batch shaped as ``data.synthetic.batch_spec`` (token ids 0)."""
    return {k: torch.zeros(s, dtype=d)
            for k, (s, d) in batch_spec(cfg, batch, seq).items()}
