"""Classic uniform PHOLD (paper §IV-A), registered in the port's workload zoo.

The model lives in :mod:`repro_torch.phold.model`; this module binds it to
the registry contract (``make`` + ``CONFORMANCE``), the same recipe as the
JAX package's ``repro/workloads/phold.py``, and names the port's main path
(:func:`main_path`).
"""
from __future__ import annotations

from ..core.pipeline.config import EngineConfig
from ..phold.model import Phold, PholdParams


def make(**overrides) -> Phold:
    return Phold(PholdParams(**overrides))


def main_path() -> tuple[Phold, EngineConfig]:
    """The port's main path: default PHOLD (1024 objects x 4000 nodes x 6
    lanes) with the dyadic draw, each epoch through the ``event_apply``
    kernel.  The route and fallback buffers sit above the ~5k emissions of
    one epoch (the JAX default of 4096 is below them)."""
    model = make(dist="dyadic")
    return model, EngineConfig(lookahead=model.params.lookahead,
                               batch_impl="model", route_cap=16384,
                               fallback_cap=16384)


CONFORMANCE = dict(
    model_kw=dict(n_objects=16, initial_events=4, state_nodes=64,
                  realloc_fraction=0.02, lookahead=0.5, dist="dyadic"),
    n_epochs=24,
    engine_kw=dict(n_buckets=8, bucket_cap=64, route_cap=512,
                   fallback_cap=512),
    dyadic=True,
    supports_batch_impl=True,
)
