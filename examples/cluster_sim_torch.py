"""Cluster simulator on the PyTorch port: the PARSIR core simulating a
multi-pod training fleet (the twin of ``examples/cluster_sim.py``).

The model lives in the port's workload zoo
(:mod:`repro_torch.workloads.cluster`); this example keeps the fleet-sizing
experiment: measure achieved steps/hour vs node failure rate, the quantity
that sizes checkpoint intervals on a real fleet.

  PYTHONPATH=src python examples/cluster_sim_torch.py               # the card
  PYTHONPATH=src python examples/cluster_sim_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core.engine import EngineConfig, ParsirEngine
from repro_torch.workloads.cluster import ClusterModel, ClusterParams


def run(fail_ppm, n_epochs=400, device="cuda"):
    model = ClusterModel(ClusterParams(n_nodes=64, n_rings=8,
                                       fail_ppm=fail_ppm, dist="uniform24"))
    cfg = EngineConfig(lookahead=model.params.lookahead, n_buckets=64,
                       bucket_cap=32, route_cap=1024, fallback_cap=4096)
    eng = ParsirEngine(model, cfg, device=device)
    st = eng.run(eng.init(), n_epochs)
    tot = eng.totals(st)
    obj = eng.global_object_state(st)
    hops = int(np.asarray(obj["hops"]).sum())
    fails = int(np.asarray(obj["failures"]).sum())
    sim_time = n_epochs * cfg.epoch_len
    steps = hops / 64  # one "global step" per full ring rotation per ring
    assert tot["late_events"] == 0 and tot["cal_overflow"] == 0
    return steps / sim_time, fails, hops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print("failure-rate sweep: training goodput vs node failure probability")
    print(f"{'fail/M hops':>12} {'steps/sim-h':>12} {'failures':>9} "
          f"{'hops':>8}")
    base = None
    for ppm in (0, 5000, 20000, 80000):
        rate, fails, hops = run(ppm, device=args.device)
        base = base or rate
        print(f"{ppm:>12} {rate*3600:>12.1f} {fails:>9} {hops:>8} "
              f"(goodput {100*rate/base:.0f}%)")
    print("\n→ with the measured goodput curve, pick checkpoint interval "
          "t_ckpt ≈ sqrt(2·t_write·MTBF) (Young/Daly) per fleet size.")


if __name__ == "__main__":
    main()
