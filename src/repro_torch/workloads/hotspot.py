"""Hot-spot PHOLD: skewed destinations and an imbalanced initial population.

Port of ``repro/workloads/hotspot.py``.  With probability ``hot_prob/256``
every emitted event re-targets one of the first ``hot_objects`` ids (the
PHOLD model's non-uniform routing, here on by default), and those objects
bootstrap with ``(1 + hot_boost)x`` the baseline initial events, so the
first epoch is already skewed.  Processing and state come from
:class:`repro_torch.phold.model.Phold`, so ``batch_impl="model"`` runs the
``event_apply`` kernel on buckets that the hot objects fill.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import events as ev
from ..phold.model import _INIT_C, Phold, PholdParams, _draw_np


@dataclasses.dataclass(frozen=True)
class HotspotParams(PholdParams):
    hot_objects: int = 4
    hot_prob: int = 128       # out of 256
    hot_boost: int = 3        # hot objects start with (1 + boost) * M events


class HotspotPhold(Phold):

    def object_weights(self) -> np.ndarray | None:
        """Routing-skew weights (inherited) times the population boost of
        the hot objects."""
        p = self.params
        w = super().object_weights()
        if w is None:
            w = np.full(p.n_objects, 1.0 / p.n_objects, np.float64)
        boost = np.ones(p.n_objects, np.float64)
        boost[:p.hot_objects] += p.hot_boost
        return w * boost

    def initial_events(self, seed: int | None = None) -> dict[str, np.ndarray]:
        p = self.params
        c = _INIT_C ^ ev.seed_salt_np(p.seed if seed is None else seed)
        counts = np.full(p.n_objects, p.initial_events, np.int64)
        counts[:p.hot_objects] *= 1 + p.hot_boost
        o = np.repeat(np.arange(p.n_objects, dtype=np.uint32), counts)
        m = np.concatenate([np.arange(n, dtype=np.uint32) for n in counts])
        # uniform PHOLD's (object, sequence number) seed formula.
        with np.errstate(over="ignore"):
            s0 = ev._mix_np(ev._mix_np(o ^ c) + m * np.uint32(0x9E3779B9))
        ts0 = _draw_np(ev.fold_np(s0, 2), p).astype(np.float32)
        return {
            "dst": o.astype(np.int32),
            "ts": ts0,
            "seed": s0,
            "payload": ev.dyadic10_np(ev.fold_np(s0, 4)).astype(np.float32),
        }


def make(**overrides) -> HotspotPhold:
    return HotspotPhold(HotspotParams(**overrides))


CONFORMANCE = dict(
    model_kw=dict(n_objects=16, initial_events=3, state_nodes=64,
                  realloc_fraction=0.02, lookahead=0.5, dist="dyadic",
                  hot_objects=4, hot_prob=128, hot_boost=3),
    n_epochs=24,
    # hot objects concentrate ~half the population on 4 ids → deep buckets.
    engine_kw=dict(n_buckets=8, bucket_cap=256, route_cap=512,
                   fallback_cap=512),
    dyadic=True,
    supports_batch_impl=True,
)
