"""Quickstart on the PyTorch port: run a PHOLD model on the PARSIR engine
and verify it against the sequential oracle (the twin of
``examples/quickstart.py``).

  PYTHONPATH=src python examples/quickstart_torch.py               # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig, ParsirEngine
from repro_torch.core.ref_engine import run_sequential
from repro_torch.phold.model import Phold, PholdParams


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    params = PholdParams(n_objects=64, initial_events=8, state_nodes=256,
                         realloc_fraction=0.01, lookahead=0.5, dist="dyadic")
    model = Phold(params)
    cfg = EngineConfig(lookahead=0.5, n_buckets=8, bucket_cap=128,
                       route_cap=2048, fallback_cap=2048)
    eng = ParsirEngine(model, cfg, device=args.device)

    state = eng.init()
    print(f"initialized: {eng.in_flight(state)} events in flight "
          f"(= O*M = {params.n_objects * params.initial_events})")

    n_epochs = 40
    t0 = time.perf_counter()
    state = eng.run(state, n_epochs)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    tot = eng.totals(state)
    print(f"ran {n_epochs} epochs in {dt:.2f}s -> "
          f"{tot['processed'] / dt:,.0f} events/s")
    print(f"stats: {tot}")

    ref = run_sequential(model, n_epochs, cfg.epoch_len)
    assert tot["processed"] == ref.total_processed
    pay = eng.global_object_state(state)["payload"]
    ref_pay = np.stack([s["payload"] for s in ref.obj_state])
    assert np.array_equal(pay, ref_pay), "state mismatch!"
    print("parallel engine == sequential oracle (bit-exact) ✓")


if __name__ == "__main__":
    main()
