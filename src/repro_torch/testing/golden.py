"""Golden digests of the oracle, for the seven workloads of the zoo.

The port's copy of ``state_digest`` and of the pinned digests of
``repro/testing/golden_digests.json`` for its workloads.  A run of the
port's own oracle (:func:`repro_torch.core.ref_engine.run_sequential`) must
reproduce them, which ties the port's RNG, model arithmetic and oracle order
to the frozen history of the JAX package without importing it.
"""
from __future__ import annotations

import hashlib

import numpy as np

from ..core.ref_engine import SequentialResult, run_sequential
from ..workloads.registry import conformance_spec, get_workload

#: pinned digests, copied from the JAX package's golden_digests.json.
PINNED: dict[str, str] = {
    "cluster/medium":
        "e22297f2765377fa846cf42b0e9c09c1b442e225b9b65d1edd70b0e872ffa66d",
    "cluster/small":
        "17927417d5d78ac4008eab018d20afe505758e4d9da212b96b77dba504768043",
    "epidemic/medium":
        "91d61b74ac5d3717d67f172670abc095634605aae0f8bb74c596e0abaab49ad2",
    "epidemic/small":
        "c31144b99ec94d4cbe056d911b38eab1675cbdddfa6d1e2322fd8769d1677adc",
    "open-queueing/medium":
        "585e2d9cb9a7ac65a76c55fb7e4106a589e30a98b08841d294297ed1ffe5ede7",
    "open-queueing/small":
        "c96cfdeac6f5fd2b5c7f3135c151d766b3d24e902da5f01f79592dc6870f5396",
    "phold-hotspot/medium":
        "eb70daad97a0d2149d01004a6ae59be01a6b21788bb7c47446a0d28b380ab7a8",
    "phold-hotspot/small":
        "4f5eecfd35b62d3c0b4975b0386cfc955b74c1e00eceb462be9ae6b804d0ea5b",
    "phold/medium":
        "580ca61ca229025b135bcf2948ec85c79d5a92262e09017ae28fa3ca8a003f71",
    "phold/small":
        "37caeaa85eb12c467de98d8ff12c1df7fa23e401cfbf03c24df9b2515f64e38c",
    "queueing/medium":
        "405164fac1fa9cfedf4571c793f66782afc37cd13f98018edd29613f70f9f991",
    "queueing/small":
        "6126fa90eb567f875b9278cbe018a62d27f7477ceb033a0a2bf843c393013485",
    "wireless/medium":
        "b06df7d69449312ddd874b37d7736a82475cb0fdab73e44293073954cfba9322",
    "wireless/small":
        "b47e7b06295e6c917010d3440c5293621881ed065534e7abd6f7e9451c536bf1",
}

#: the "medium" size per workload: model_kw overrides on top of the
#: CONFORMANCE model_kw, plus the horizon in epochs.
MEDIUM_SIZES: dict[str, tuple[dict, int]] = {
    "phold": (dict(n_objects=48, initial_events=6), 32),
    "phold-hotspot": (dict(n_objects=48, hot_objects=6), 32),
    "queueing": (dict(n_stations=32, n_jobs=128), 32),
    "cluster": (dict(n_nodes=32, n_rings=8), 48),
    "open-queueing": (dict(n_sources=8, n_stage1=8, n_forks=8, n_stage2=8,
                           n_sinks=8), 32),
    "epidemic": (dict(n_patches=48, pop=16, n_seeds=6), 32),
    "wireless": (dict(n_cells=48, hot_cells=8), 32),
}


def golden_case(key: str) -> tuple[str, dict, int]:
    """``"<workload>/<size>"`` → (workload, model_kw, n_epochs)."""
    name, size = key.split("/")
    spec = conformance_spec(name)
    if size == "small":
        return name, spec["model_kw"], spec["n_epochs"]
    over, n_epochs = MEDIUM_SIZES[name]
    return name, dict(spec["model_kw"], **over), n_epochs


def state_digest(res: SequentialResult) -> str:
    """Canonical sha256 of a sequential run's final state: per-object
    processed counts (i64), the sorted pending ``(dst, seed)`` multiset
    (u64), then every object's state dict in key order with dtype and shape
    tags."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(
        res.processed_per_object.astype(np.int64)).tobytes())
    pend = res.pending_sorted()
    h.update(np.int64(pend.shape[0]).tobytes())
    h.update(np.ascontiguousarray(pend.astype(np.uint64)).tobytes())
    for st in res.obj_state:
        for k in sorted(st):
            v = np.asarray(st[k])
            h.update(k.encode())
            h.update(str(v.dtype).encode())
            h.update(str(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def compute_digest(key: str) -> str:
    """Run the port's oracle for one pinned case and digest its state."""
    name, model_kw, n_epochs = golden_case(key)
    model = get_workload(name, **model_kw)
    res = run_sequential(model, n_epochs, model.params.lookahead)
    if res.total_processed <= 0:
        raise AssertionError(f"golden case {key} processed nothing")
    return state_digest(res)
