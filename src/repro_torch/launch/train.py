"""Command-line training of the port (``repro/launch/train.py``'s flags and
``--device``): the supervised Trainer on synthetic batches, checkpointing
into ``--ckpt-dir`` and resuming from it.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --reduced --device cpu --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --reduced --steps 200 --batch 8 --seq 128             # on the card

It runs on the card unless given ``--device cpu``.  The model trains under
its config's ``attn_impl`` (``"jnp"`` for every config: no kernel has a
backward) and ``remat``.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs.base import TrainConfig
    from ..configs.registry import get_config
    from ..core.device import resolve_device
    from ..data.synthetic import SyntheticLoader
    from ..models.registry import build_model
    from ..train.loop import Trainer

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg, device=dev)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       microbatch=args.microbatch,
                       checkpoint_dir=args.ckpt_dir,
                       checkpoint_every=args.ckpt_every)
    loader = SyntheticLoader(cfg, args.batch, args.seq, device=dev)
    tr = Trainer(model, tcfg, loader=loader)
    params, opt_state, hist = tr.run(args.steps)
    if hist:
        print(f"[train] done: first loss {hist[0]['loss']:.4f} "
              f"final loss {hist[-1]['loss']:.4f}")
    else:
        print(f"[train] done: nothing to run (resumed at step "
              f"{args.steps} or later)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(hist, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
