"""Workload registry of the port: ``<id>`` → SimModel.

Each module under :mod:`repro_torch.workloads` exposes ``make(**overrides)``
and ``CONFORMANCE`` (the small differential-test recipe: ``model_kw``,
``n_epochs``, ``engine_kw``, ``dyadic``, ``supports_batch_impl``), as in the
JAX package, under the JAX package's ids.  ``open-queueing``, ``epidemic``
and ``wireless`` join with a later slice of the port.
"""
from __future__ import annotations

import copy
from importlib import import_module

WORKLOADS = {
    "phold": "phold",
    "phold-hotspot": "hotspot",
    "queueing": "queueing",
    "cluster": "cluster",
}


def _module(name: str):
    return import_module(f"repro_torch.workloads.{WORKLOADS[name]}")


def get_workload(name: str, **overrides):
    """Build a registered workload model; overrides go to its params."""
    return _module(name).make(**overrides)


def conformance_spec(name: str) -> dict:
    """The workload's differential-test recipe (deep copy — safe to mutate)."""
    return copy.deepcopy(_module(name).CONFORMANCE)


def all_workloads() -> list[str]:
    return list(WORKLOADS)
