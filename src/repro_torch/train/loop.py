"""The training loop, port of ``repro/train/loop.py``: the supervised
train step, checkpoint and resume.

  * the state checkpoints every ``checkpoint_every`` steps (``ckpt.save``:
    tmp + rename, then ``LATEST``);
  * on start the loop resumes from ``LATEST`` if there is one (restart ==
    resume);
  * ``SupervisedStep`` retries a failed step and tracks stragglers;
  * batches come from the loader keyed by step index, so a resumed run
    reads exactly the batches it would have read.

The parameters are the model's own (a module holds them; the state's
``params`` is ``dict(model.named_parameters())``), updated in place with
the optimizer state.  One device: the reference's ``mesh=`` (sharded
parameters and optimizer state) is not ported (ROADMAP A19).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch

from ..checkpoint import ckpt
from ..ft.supervisor import SupervisedStep
from . import optimizer as opt
from .step import make_train_step


class Trainer:
    def __init__(self, model, tcfg, mesh=None, loader: Optional[Any] = None,
                 log: Callable[[str], None] = print):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): multi-device training (sharded "
                "parameters, optimizer state and gradients) is not ported; "
                "ROADMAP A19")
        self.model, self.tcfg, self.mesh, self.log = model, tcfg, mesh, log
        self.loader = loader
        self.step_fn = SupervisedStep(make_train_step(model, tcfg))

    def params(self) -> dict:
        """The model's parameters by name (the masters themselves)."""
        return dict(self.model.named_parameters())

    def _load(self, params: dict) -> None:
        """Copy ``params`` (name → tensor) into the model's parameters,
        skipping those that already are them."""
        own = self.params()
        if own.keys() != params.keys():
            raise ValueError(f"the parameters do not match the model's "
                             f"({sorted(set(own) ^ set(params))[:4]} differ)")
        with torch.no_grad():
            for name, p in own.items():
                if params[name] is not p:
                    p.copy_(params[name])

    def init_state(self, seed: int = 0):
        """The model's parameters made anew from ``seed`` (as its
        constructor makes them) and a fresh optimizer state."""
        m = self.model
        fresh = type(m)(m.cfg, device=m.device, seed=seed)
        self._load(dict(fresh.named_parameters()))
        del fresh
        params = self.params()
        return params, opt.init(params)

    def resume_or_init(self, seed: int = 0):
        d = self.tcfg.checkpoint_dir
        last = ckpt.latest_step(d)
        if last is None:
            params, opt_state = self.init_state(seed)
            return params, opt_state, 0
        params = self.params()
        tree, step = ckpt.restore(d, {"params": params,
                                      "opt": opt.init(params)})
        self._load(tree["params"])
        self.log(f"[train] resumed from step {step}")
        return self.params(), tree["opt"], step

    def run(self, n_steps: int, seed: int = 0, start=None):
        """Steps ``step0 .. n_steps - 1`` from ``start`` = (params,
        opt_state, step0), or else from the latest checkpoint or a fresh
        state → (params, opt_state, the metrics of each step: ``loss``,
        ``grad_norm``, ``lr``, ``step``, ``step_s``)."""
        if start is None:
            params, opt_state, step0 = self.resume_or_init(seed)
        else:
            params, opt_state, step0 = start
            self._load(params)
        metrics_hist = []
        for step in range(step0, n_steps):
            batch = self.loader.batch_at(step)
            t0 = time.perf_counter()
            opt_state, metrics = self.step_fn(opt_state, batch)
            dt = time.perf_counter() - t0
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["step_s"] = dt
            metrics_hist.append(m)
            if step % 10 == 0 or step == n_steps - 1:
                self.log(f"[train] step {step} loss {m['loss']:.4f} "
                         f"gnorm {m['grad_norm']:.3f} ({dt*1e3:.0f} ms)")
            if self.tcfg.checkpoint_every and \
                    (step + 1) % self.tcfg.checkpoint_every == 0:
                ckpt.save(self.tcfg.checkpoint_dir, step + 1,
                          {"params": self.params(), "opt": opt_state},
                          keep=self.tcfg.keep_checkpoints)
        return self.params(), opt_state, metrics_hist
