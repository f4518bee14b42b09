"""The train step, port of ``repro/train/step.py``: loss → gradients →
AdamW, with optional microbatch accumulation.

The parameters are the model's own (``model.named_parameters()``, the
masters); the loss is the model's ``train_loss``, which casts them to the
compute dtype inside the autograd graph and applies ``cfg.remat``.  A step
touches the parameters and the optimizer state only in its final update
(in place), so a step that fails before it can be run again on the same
inputs.

Over a device mesh (the model's parameters placed by
``sharding.place_module``, the batch by ``batch_shardings``, the step run
under ``sharding.use_mesh``) the same code runs on DTensors: the
gradients come out of the backward in the layout autograd gives them (a
partial sum over the batch's mesh dims for a parameter that is not
sharded there; under fsdp already reduce-scattered onto the parameter's
shards by ``use_param``'s backward), and ``grad_shardings`` (the
reference's ZeRO-2 constraint, usually the parameters' own specs) brings
each one to its spec before the update: a partial sum that the spec
shards is reduce-scattered, not all-reduced.  Without it each gradient
is brought to its parameter's placements at the same point, where the
in-place update needs it.
"""
from __future__ import annotations

import functools

import torch

from ..distributed import sharding
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


def _local(t):
    return t.to_local() if sharding.is_dtensor(t) else t


def _zeros(p, dtype):
    return torch.zeros_like(p, dtype=dtype,
                            memory_format=torch.contiguous_format)


def loss_and_grads(model, batch, microbatch: int = 0):
    """(loss, {name: gradient}) of ``model.train_loss`` on ``batch``.

    Without accumulation the gradients are in each parameter's dtype, as
    ``jax.value_and_grad`` gives them.  With ``microbatch`` k > 1 the
    leading batch axis is cut into k equal parts in order; each part's
    gradients are summed into f32 as autograd produces them, and the sums
    and the loss are divided by k (the reference's ``lax.scan`` over the
    parts).  A batch sharded over its rows is cut on every rank's own
    block (``sharding.local_rows``: part i holds each rank's i-th rows,
    with no collective), so its parts group the rows otherwise than one
    device's; their gradients sum to the same total.  A parameter the
    loss does not reach gets zeros.  The loss is a plain tensor."""
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
        return _local(loss.detach()), grads
    b = _local(next(iter(batch.values()))).shape[0]
    if b % k:
        raise ValueError(f"microbatch={k} does not divide the batch of {b}"
                         f" (a rank's rows under a mesh)")
    acc = {}
    hooks = [p.register_post_accumulate_grad_hook(
        functools.partial(_accumulate, acc, name))
        for name, p in params.items()]
    try:
        lsum = None
        for i in range(k):
            part = {key: sharding.local_rows(v, i, k)
                    for key, v in batch.items()}
            loss = model.train_loss(part)
            loss.backward()
            loss = _local(loss.detach())
            lsum = loss if lsum is None else lsum + loss
    finally:
        for h in hooks:
            h.remove()
    grads = {name: acc[name].div_(k) if name in acc
             else _zeros(p, torch.float32) for name, p in params.items()}
    return lsum / k, grads


def gradients(model, batch, microbatch: int = 0, grad_shardings=None):
    """:func:`loss_and_grads`; over a mesh each gradient is then brought
    to its spec in ``grad_shardings`` (name → spec; ``sharding.constrain``)
    or, without them, to its parameter's placements, where the update
    works.  Each is replaced in the dict as it is moved, so two sets of
    gradients are never alive together."""
    loss, grads = loss_and_grads(model, batch, microbatch)
    params = dict(model.named_parameters())
    for n, g in grads.items():
        if grad_shardings is not None:
            grads[n] = sharding.constrain(g, grad_shardings[n])
        elif sharding.is_dtensor(g) and \
                list(g.placements) != list(params[n].placements):
            grads[n] = sharding.redistribute(g, list(params[n].placements))
    return loss, grads


def make_train_step(model, tcfg, grad_shardings=None):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``:
    gradients of ``model.train_loss`` (accumulated over
    ``tcfg.microbatch`` parts), then :func:`optimizer.update` on the
    model's parameters in place.  ``metrics``: ``loss``, ``grad_norm`` and
    ``lr`` as plain 0-d tensors on the device (nothing is read on the
    host).  ``grad_shardings`` (name → spec) is the reference's ZeRO-2
    constraint on the gradients' layout (:func:`gradients`), the identity
    on one device.  ``agree`` goes to the update (a supervisor's retry
    agreement over a mesh, ``ft.supervisor.SupervisedStep``)."""

    def train_step(opt_state, batch, agree=None):
        loss, grads = gradients(model, batch, tcfg.microbatch,
                                grad_shardings)
        params = dict(model.named_parameters())
        _, opt_state, metrics = opt.update(grads, opt_state, params, tcfg,
                                           agree)
        metrics["loss"] = loss
        return opt_state, metrics

    return train_step
