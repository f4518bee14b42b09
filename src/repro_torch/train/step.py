"""The train step, port of ``repro/train/step.py``: loss → gradients →
AdamW, with optional microbatch accumulation.

The parameters are the model's own (``model.named_parameters()``, the
masters); the loss is the model's ``train_loss``, which casts them to the
compute dtype inside the autograd graph and applies ``cfg.remat``.  A step
touches the parameters and the optimizer state only in its final update
(in place), so a step that fails before it can be run again on the same
inputs.  One device: the reference's ``grad_shardings`` constraint (ZeRO-2
over a mesh) is the identity here.
"""
from __future__ import annotations

import functools

import torch

from . import optimizer as opt


def _accumulate(acc: dict, name: str, p: torch.Tensor) -> None:
    """After autograd has written ``p.grad``: add it into ``acc[name]`` in
    f32 (the first microbatch's f32 gradient is taken as it is) and drop
    it, so one set of gradients is alive at a time."""
    if name in acc:
        acc[name].add_(p.grad)
    else:
        acc[name] = p.grad if p.grad.dtype == torch.float32 \
            else p.grad.float()
    p.grad = None


def _zeros(p, dtype):
    return torch.zeros(p.shape, dtype=dtype, device=p.device)


def loss_and_grads(model, batch, microbatch: int = 0):
    """(loss, {name: gradient}) of ``model.train_loss`` on ``batch``.

    Without accumulation the gradients are in each parameter's dtype, as
    ``jax.value_and_grad`` gives them.  With ``microbatch`` k > 1 the
    leading batch axis is cut into k equal parts in order; each part's
    gradients are summed into f32 as autograd produces them, and the sums
    and the loss are divided by k (the reference's ``lax.scan`` over the
    parts).  A parameter the loss does not reach gets zeros."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    k = microbatch if microbatch and microbatch > 1 else 1
    if k == 1:
        loss = model.train_loss(batch)
        loss.backward()
        grads = {n: p.grad if p.grad is not None else _zeros(p, p.dtype)
                 for n, p in params.items()}
        for p in params.values():
            p.grad = None
        return loss.detach(), grads
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"microbatch={k} does not divide the batch of {b}")
    n = b // k
    acc = {}
    hooks = [p.register_post_accumulate_grad_hook(
        functools.partial(_accumulate, acc, name))
        for name, p in params.items()]
    try:
        lsum = None
        for i in range(k):
            part = {key: v[i * n:(i + 1) * n] for key, v in batch.items()}
            loss = model.train_loss(part)
            loss.backward()
            loss = loss.detach()
            lsum = loss if lsum is None else lsum + loss
    finally:
        for h in hooks:
            h.remove()
    grads = {name: acc[name].div_(k) if name in acc
             else _zeros(p, torch.float32) for name, p in params.items()}
    return lsum / k, grads


def make_train_step(model, tcfg, grad_shardings=None):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``:
    gradients of ``model.train_loss`` (accumulated over
    ``tcfg.microbatch`` parts), then :func:`optimizer.update` on the
    model's parameters in place.  ``metrics``: ``loss``, ``grad_norm`` and
    ``lr`` as 0-d tensors on the device (nothing is read on the host).
    ``grad_shardings`` is the reference's ZeRO-2 constraint on the
    gradients' layout, the identity on one device."""

    def train_step(opt_state, batch):
        loss, grads = loss_and_grads(model, batch, tcfg.microbatch)
        params = dict(model.named_parameters())
        _, opt_state, metrics = opt.update(grads, opt_state, params, tcfg)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step
