"""Serve a (reduced) LM on the PyTorch port with batched requests: prefill
+ greedy decode (the twin of ``examples/serve_lm.py``).

  PYTHONPATH=src python examples/serve_lm_torch.py --arch llama3.2-3b --tokens 16
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import ServeSession


def generate(model, batch, rows, prompt_len, n_tokens):
    """Prefill ``batch`` (``rows`` prompts of ``prompt_len``), then decode
    greedily: the first tokens [rows], the next ``n_tokens - 1`` a row
    [rows, n_tokens - 1], and the clock's reading before the prefill,
    after it and after the decode."""
    dev = model.device
    sess = ServeSession(model, rows, max_len=prompt_len + n_tokens + 1,
                        device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    first = sess.prefill(batch)
    sync()
    t1 = time.perf_counter()
    out = sess.decode(first, n_tokens - 1)
    sync()
    return first, out, (t0, t1, time.perf_counter())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    model = build_model(cfg, device=args.device, seed=0)
    dev = model.device
    batch = make_batch(cfg, args.batch, args.prompt_len, device=dev)

    first, out, (t0, t1, t2) = generate(model, batch, args.batch,
                                         args.prompt_len, args.tokens)

    total = args.batch * (args.tokens - 1)
    print(f"arch={cfg.name} (reduced) batch={args.batch}")
    print(f"prefill: {1e3*(t1-t0):.0f} ms; decode: {1e3*(t2-t1):.0f} ms "
          f"({total/(t2-t1):,.0f} tok/s incl. compile)")
    print("sampled continuations (token ids):")
    for b in range(args.batch):
        print(f"  req{b}: {[int(first[b])] + out[b].tolist()}")


if __name__ == "__main__":
    main()
