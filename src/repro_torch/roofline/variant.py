"""Roofline row for a hillclimb variant artifact
(``repro/roofline/variant.py``).

  PYTHONPATH=src python -m repro_torch.roofline.variant artifacts/dryrun/<cell>.json
"""
import json
import sys
from pathlib import Path

from .report import row_of


def row_for(path: str) -> dict:
    rec = json.loads(Path(path).read_text())
    row = row_of(rec)
    row.update({"variant": Path(path).stem.split("__")[-1],
                "overrides": rec.get("overrides")})
    return row


def main(argv=None):
    for path in (sys.argv[1:] if argv is None else argv):
        r = row_for(path)
        print(f"{r['arch']} x {r['shape']} [{r['variant']}]")
        print(f"  compute {r['compute_s']:.4f}s  memory {r['memory_s']:.4f}s  "
              f"collective {r['collective_s']:.4f}s  -> {r['dominant']}")
        print(f"  useful-FLOP ratio {r['useful_flops_ratio']:.3f}  "
              f"roofline fraction {r['roofline_fraction']:.4f}")
        print("  collectives: "
              + ", ".join(f"{k}={v/1e9:.1f}GB"
                          for k, v in r["collectives_scaled"].items()
                          if k != "total" and v > 0))


if __name__ == "__main__":
    main()
