"""Command-line serving of the port: prefill a batch of synthetic prompts,
then decode greedily, and report the times.  Takes every arch.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --batch 4 --prompt-len 1024 --tokens 32            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-12b \\
      --batch 4 --prompt-len 1024 --tokens 32 --param-dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \\
      --reduced --batch 2 --prompt-len 32 --tokens 8 --device cpu

``--prompt-len`` counts positions: under the vision front end (internvl2)
``n_patches`` of them are patch embeddings and the rest tokens.  Under the
audio front end (musicgen) the prompt is frame embeddings and the greedy
loop cannot feed a codebook token back (the EnCodec front end is a stub), so
the decode steps read given synthetic frames (``ServeSession.
decode_frames``) and print the codebook tokens predicted after each.
``--param-dtype bfloat16`` keeps bf16 masters (the served weights are then
the masters themselves), which a card needs for the 12-16 B-parameter
configs; kimi-k2-1t-a32b fits one card only ``--reduced``.

Times on a CUDA device wait for the card (``torch.cuda.synchronize``) and
include the first call's warm-up; the first generated token comes from the
prefill, the other ``--tokens - 1`` from decode steps.  On the card the
session runs its first decode step eagerly and replays a CUDA graph of the
step after that: ``decode`` is the mean over every step, the capture
counted in, ``steady`` the mean over the steps after the first two (pure
replays; on the CPU, eager steps).
"""
from __future__ import annotations

import argparse
import time


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--param-dtype", choices=("float32", "bfloat16"),
                    help="the masters' dtype (default: the config's)")
    args = ap.parse_args(argv)
    if args.tokens < 1:
        ap.error("--tokens must be at least 1")

    import dataclasses

    import torch

    from ..configs.registry import get_config
    from ..core.device import resolve_device
    from ..data.synthetic import make_batch
    from ..models.registry import build_model
    from ..serve.engine import ServeSession

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    if args.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.param_dtype)
    if cfg.frontend == "vision" and args.prompt_len <= cfg.n_patches:
        ap.error(f"--prompt-len must exceed {cfg.name}'s {cfg.n_patches} "
                 f"patches")
    model = build_model(cfg, device=dev)
    batch = make_batch(cfg, args.batch, args.prompt_len, device=dev)
    sess = ServeSession(model, args.batch, args.prompt_len + args.tokens,
                        device=dev)
    steps = args.tokens - 1
    # the frames the audio decode steps read: the next batch's embeddings.
    frames = (make_batch(cfg, args.batch, max(steps, 1), step=1,
                         device=dev)["embeds"] if sess.audio else None)

    def decode(tokens, a, b):
        return (sess.decode_frames(frames[:, a:b]) if sess.audio
                else sess.decode(tokens, b - a))

    _sync(dev)
    t0 = time.perf_counter()
    first = sess.prefill(batch)
    _sync(dev)
    t1 = time.perf_counter()
    # the first two steps (eager, then capture + replay), then the rest.
    head = decode(first, 0, min(steps, 2))
    _sync(dev)
    t2 = time.perf_counter()
    tail = decode(head[:, -1], head.shape[1], steps) if steps > 2 \
        else head[:, :0]
    _sync(dev)
    t3 = time.perf_counter()
    out = torch.cat([head, tail], dim=1)
    steady = (f"{1e3 * (t3 - t2) / tail.shape[1]:.2f}ms/token"
              if tail.shape[1] else "n/a")
    print(f"[serve] arch={cfg.name} device={dev} batch={args.batch} "
          f"prompt={args.prompt_len} prefill={1e3 * (t1 - t0):.2f}ms "
          f"decode={1e3 * (t3 - t1) / max(steps, 1):.2f}ms/token "
          f"({args.batch * steps / max(t3 - t1, 1e-9):,.1f} tok/s) "
          f"steady={steady} (graph captures={sess.captures} "
          f"replays={sess.replays} eager steps={sess.eager_steps})")
    toks = torch.cat([first[:, None], out], dim=1).cpu()
    for b in range(min(args.batch, 4)):
        print(f"[serve] req{b}: {toks[b].tolist()}")


if __name__ == "__main__":
    main()
