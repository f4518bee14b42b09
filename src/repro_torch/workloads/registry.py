"""Workload registry of the port: ``<id>`` → SimModel.

Each module under :mod:`repro_torch.workloads` exposes ``make(**overrides)``
and ``CONFORMANCE`` (the small differential-test recipe: ``model_kw``,
``n_epochs``, ``engine_kw``, ``dyadic``, ``supports_batch_impl``), as in the
JAX package, under the JAX package's seven ids.

:func:`bench_path` builds a workload at the reference's bench scale, the
port's copy of ``BASE`` and ``BENCH_MODEL_KW`` and of the engine config of
the reference's benchmark (``benchmarks/pdes_perf.py``).
"""
from __future__ import annotations

import copy
import dataclasses
from importlib import import_module

from ..core.pipeline.config import EngineConfig

WORKLOADS = {
    "phold": "phold",
    "phold-hotspot": "hotspot",
    "queueing": "queueing",
    "cluster": "cluster",
    "open-queueing": "open_queueing",
    "epidemic": "epidemic",
    "wireless": "wireless",
}

#: the bench's model scale (``BASE``: 512 objects, lookahead 0.5).  The one
#: cut: ``dist="dyadic"`` replaces the bench's ``"exponential"``, so that a
#: run can be held to the oracle bit for bit.
BENCH_BASE = dict(n_objects=512, lookahead=0.5, dist="dyadic")
#: ``BASE``'s PHOLD extras (``m`` initial events, ``s`` state nodes and the
#: benchmark's realloc fraction), for the two PHOLD workloads.
BENCH_PHOLD = dict(initial_events=40, state_nodes=256, realloc_fraction=0.004)
#: workload-specific bench-scale extras (``BENCH_MODEL_KW``).
BENCH_MODEL_KW = {
    "phold-hotspot": dict(hot_objects=32, hot_prob=96, hot_boost=1),
    "queueing": dict(n_jobs=2048),
    "cluster": dict(n_rings=64),
    "open-queueing": dict(),
    "epidemic": dict(pop=64, n_seeds=32, trans_p=128),
    "wireless": dict(n_channels=8, hot_cells=32, hot_shift=3,
                     hot_streams=2, handoff_p=112),
}
#: the bench's engine config (its defaults for every rung that sets none).
BENCH_ENGINE = dict(n_buckets=32, bucket_cap=256, route_cap=8192,
                    fallback_cap=16384, pack_tile=64)


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


def bench_kw(name: str, **over) -> tuple[dict, dict]:
    """The keyword arguments of :func:`bench_path`: ``(model_kw,
    cfg_kw)``, the config's without its lookahead (the model's)."""
    cfg_keys = {f.name for f in dataclasses.fields(EngineConfig)}
    cfg_keys.discard("lookahead")
    model_kw = dict(BENCH_BASE)
    if name in ("phold", "phold-hotspot"):
        model_kw.update(BENCH_PHOLD)
    model_kw.update(BENCH_MODEL_KW.get(name, {}))
    model_kw.update({k: v for k, v in over.items() if k not in cfg_keys})
    cfg_kw = dict(BENCH_ENGINE, **{k: v for k, v in over.items()
                                   if k in cfg_keys})
    return model_kw, cfg_kw


def bench_path(name: str, **over):
    """``name`` at the reference's bench scale: ``(model, EngineConfig)``.

    ``over`` keys that are ``EngineConfig`` fields (``batch_impl``,
    ``scheduler``, ``pack_tile``, capacities ...) go to the config, every
    other key to the model (``max_calls=4``, ``n_objects=128`` ...); the
    config's lookahead is the model's."""
    model_kw, cfg_kw = bench_kw(name, **over)
    model = get_workload(name, **model_kw)
    return model, EngineConfig(lookahead=model.params.lookahead, **cfg_kw)
