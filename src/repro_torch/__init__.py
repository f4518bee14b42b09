"""PARSIR on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors ``repro`` module for module (``repro_torch/core/calendar.py``
ports ``repro/core/calendar.py``).  This package imports ``torch`` and never
``jax`` or anything of ``repro``.  Entry points take ``device=`` and run on
the card unless the caller asks for the CPU; there the hand-written CUDA
kernels are replaced by their plain PyTorch versions.

Ported so far: one PHOLD simulation on one device under the conservative
engine, through the ``batch`` rounds scheduler or the hand-written
``event_apply`` kernel (``EngineConfig(batch_impl="model")``); and
zamba2-1.2b serving (``serve.engine.ServeSession``: greedy prefill + decode
on one device), whose prefill runs the hand-written ``ssd_scan`` kernel.
"""
