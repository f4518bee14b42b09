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
the optimizer state.

``Trainer(mesh=)`` (a ``DeviceMesh`` with named dims; every rank of it
runs the same Trainer) trains over the mesh as the reference's does,
under the sharding mode in force (``distributed.sharding.set_mode``):
the model's parameters are placed by the rules
(``sharding.place_module``, each rank keeping its own block), the
optimizer state by the same rules (the moments take their parameter's
placements), each step's batch by ``batch_shardings`` (every rank reads
the step's global batch from the loader and keeps its own rows), and the
step runs with the mesh ambient; a retry is agreed by all ranks
(``SupervisedStep(mesh=)``), a checkpoint is written whole by one rank,
and a resume re-places it onto this mesh whatever mesh saved it.  As in
the reference, the Trainer passes no ``grad_shardings``.  Only the dense
decoders train over a mesh; the other families refuse naming ROADMAP A21
(they serve over one: ``serve/engine.py``).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Optional

import torch

from ..checkpoint import ckpt
from ..distributed import sharding
from ..ft.supervisor import SupervisedStep
from . import optimizer as opt
from .step import make_train_step


class Trainer:
    def __init__(self, model, tcfg, mesh=None, loader: Optional[Any] = None,
                 log: Callable[[str], None] = print):
        self.model, self.tcfg, self.mesh, self.log = model, tcfg, mesh, log
        self.loader = loader
        self._psh = self._osh = None
        if mesh is not None:
            sharding.refuse_unported(model.cfg, "train")
            self._psh = sharding.place_module(model, mesh)
            shapes = {k: torch.empty(p.shape, device="meta")
                      for k, p in model.named_parameters()}
            self._osh = sharding.params_shardings(opt.init(shapes), mesh)
        self.step_fn = SupervisedStep(make_train_step(model, tcfg),
                                      mesh=mesh)

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
                src = params[name]
                if src is p:
                    continue
                if sharding.is_dtensor(p):
                    if not sharding.is_dtensor(src):
                        src = sharding.place(src, self._psh[name], self.mesh)
                    if list(src.placements) != list(p.placements):
                        raise ValueError(f"{name} is placed as "
                                         f"{src.placements}, the model's as "
                                         f"{p.placements}")
                    p, src = p.to_local(), src.to_local()
                p.copy_(src)

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
        # the moments are shaped, placed and found as the parameters; the
        # target tree is only read for its paths, shapes and devices.
        like = opt.AdamWState(params, params, torch.zeros(
            (), dtype=torch.int32, device=self.model.device))
        shard = None if self.mesh is None else {"params": self._psh,
                                                "opt": self._osh}
        tree, step = ckpt.restore(d, {"params": params, "opt": like},
                                  shardings=shard, mesh=self.mesh)
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
            batch = self._placed(self.loader.batch_at(step))
            t0 = time.perf_counter()
            with self._ambient():
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

    def _placed(self, batch):
        """The step's global batch, over a mesh as DTensors holding this
        rank's rows (``batch_shardings``)."""
        if self.mesh is None:
            return batch
        return sharding.place(batch, sharding.batch_shardings(batch,
                                                              self.mesh),
                              self.mesh)

    def _ambient(self):
        return contextlib.nullcontext() if self.mesh is None else \
            sharding.use_mesh(self.mesh)
