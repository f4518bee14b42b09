#!/usr/bin/env python3
"""How full the calendar's buckets get under a full-width PHOLD configuration.

A PHOLD event's emission (destination, timestamp, seed) follows from its
own seed and timestamp alone, never from the object state, so the event
population can be replayed epoch by epoch without the state: this script
does that on the CPU in numpy and reports, over the horizon, the largest
count of events any one object holds for any one epoch (the least
``bucket_cap`` that keeps the run free of calendar overflows) and the mean
events per epoch.  It sizes ``workloads.phold.HOTSPOT_BUCKET_CAP``; the
engine's own ``cal_overflow`` counter on the card stays the proof.  Run
from the repository root::

    python3 tools/bucket_occupancy.py [--config main|hotspot] [--epochs 64]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("main", "hotspot"), default="hotspot")
    ap.add_argument("--epochs", type=int, default=64)
    args = ap.parse_args(argv)

    from repro_torch.core import events as ev
    from repro_torch.phold.model import _draw_np
    from repro_torch.workloads.phold import hotspot_main_path, main_path
    model, cfg = (main_path if args.config == "main" else hotspot_main_path)()
    p = model.params
    init = model.initial_events()
    dst = init["dst"].astype(np.int64)
    ts, seed = init["ts"], init["seed"]
    E, N = np.float32(cfg.epoch_len), cfg.n_buckets
    fullest, per_epoch = 0, []
    for cur in range(args.epochs):
        ep = np.floor(ts / E).astype(np.int64)
        for e in range(cur, cur + N):           # the buckets in the horizon
            sel = ep == e
            if sel.any():
                fullest = max(fullest, int(np.bincount(
                    dst[sel], minlength=p.n_objects).max()))
        now = ep == cur
        per_epoch.append(int(now.sum()))
        s = seed[now]
        nd = (ev.fold_np(s, 1) % np.uint32(p.n_objects)).astype(np.int64)
        if p.hot_objects and p.hot_prob:
            hot = (ev.fold_np(s, 8) & np.uint32(255)) < np.uint32(p.hot_prob)
            nd = np.where(hot, (ev.fold_np(s, 9) % np.uint32(p.hot_objects))
                          .astype(np.int64), nd)
        nts = (ts[now] + np.float32(p.lookahead)
               + _draw_np(ev.fold_np(s, 2), p)).astype(np.float32)
        dst = np.concatenate([dst[~now], nd])
        ts = np.concatenate([ts[~now], nts])
        seed = np.concatenate([seed[~now], ev.fold_np(s, 3)])
    print(f"{args.config}: {args.epochs} epochs, {np.mean(per_epoch):.1f} "
          f"events/epoch, fullest bucket {fullest} events "
          f"(bucket_cap {cfg.bucket_cap}: "
          f"{'fits' if fullest <= cfg.bucket_cap else 'OVERFLOWS'})")
    return 0 if fullest <= cfg.bucket_cap else 1


if __name__ == "__main__":
    sys.exit(main())
