"""PARSIR on PyTorch and CUDA: the port of the JAX package ``repro``.

The layout mirrors ``repro`` module for module (``repro_torch/core/calendar.py``
ports ``repro/core/calendar.py``).  This package imports ``torch`` and never
``jax`` or anything of ``repro``.  Entry points take ``device=`` and run on
the card unless the caller asks for the CPU; there the hand-written CUDA
kernels are replaced by their plain PyTorch versions.

Ported so far: the PARSIR engine with its stage pipeline (the seven
workloads, four schedulers, the fused drain as CUDA graphs, replications
and campaigns, speculation) on one device or over D ranks of a
``torch.distributed`` group (placement, the allgather and a2a routers, loan
stealing, adaptive rebalancing), PHOLD through the hand-written
``event_apply`` kernel (``EngineConfig(batch_impl="model")``); zamba2-1.2b
and llama3.2-3b serving and llama3.2-3b's forward and loss, through the
hand-written ``ssd_scan`` and ``flash_attention`` kernels.
"""
