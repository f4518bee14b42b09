"""Classic uniform PHOLD (paper §IV-A), registered in the port's workload zoo.

The model lives in :mod:`repro_torch.phold.model`; this module binds it to
the registry contract (``make`` + ``CONFORMANCE``), the same recipe as the
JAX package's ``repro/workloads/phold.py``, and names the port's two
full-width configurations (:func:`main_path`, :func:`hotspot_main_path`).
"""
from __future__ import annotations

from ..core.pipeline.config import EngineConfig
from ..phold.model import Phold, PholdParams
from .hotspot import make as make_hotspot


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


#: events a bucket holds in :func:`hotspot_main_path`: half of an epoch's
#: ~5,100 emissions land on 4 hot objects, and the fullest bucket of 64
#: epochs holds 767 (``tools/bucket_occupancy.py``), so 512 would overflow.
HOTSPOT_BUCKET_CAP = 1024


def hotspot_main_path():
    """``phold-hotspot`` at the main path's full width (1024 objects x 4000
    nodes x 6 lanes, touch 125, reallocate 4, lookahead 0.5, dyadic) with
    the reference's hot parameters (4 hot objects, hot_prob 128/256, boost
    3), each epoch through the ``event_apply`` kernel on buckets of
    ``HOTSPOT_BUCKET_CAP`` events."""
    model = make_hotspot(dist="dyadic")
    return model, EngineConfig(lookahead=model.params.lookahead,
                               batch_impl="model",
                               bucket_cap=HOTSPOT_BUCKET_CAP,
                               route_cap=16384, fallback_cap=16384)


CONFORMANCE = dict(
    model_kw=dict(n_objects=16, initial_events=4, state_nodes=64,
                  realloc_fraction=0.02, lookahead=0.5, dist="dyadic"),
    n_epochs=24,
    engine_kw=dict(n_buckets=8, bucket_cap=64, route_cap=512,
                   fallback_cap=512),
    dyadic=True,
    supports_batch_impl=True,
)
