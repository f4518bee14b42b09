"""§Dry-run summary table from the dry run's artifacts
(``repro/roofline/dryrun_summary.py``).

  PYTHONPATH=src python -m repro_torch.roofline.dryrun_summary [--md out.md]

"fits" holds a cell's arguments and peak temporaries against one card's
memory, :data:`HBM_PER_CHIP` (on ``single`` and ``multi`` a record's bytes
are one device's).  ``--collectives`` prints instead one row per record
of a mesh (variants included): per device arguments + peak temporaries,
the GB of each collective kind a step, and whether it fits a card.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

#: one card's memory as ``nvidia-smi --query-gpu=memory.total
#: --format=csv,noheader`` reports it on the records' card (NVIDIA H100
#: 80GB HBM3): 81559 MiB.
HBM_PER_CHIP = 81559 * 2**20
CARD_MEMORY = "81559 MiB (H100 80GB HBM3)"


def gb(x):
    return f"{x / 1e9:.2f}"


def build(artifact_dir: Path) -> str:
    rows = []
    for path in sorted(artifact_dir.glob("*.json")):
        rec = json.loads(path.read_text())
        if "__" not in path.stem:
            continue
        name = f"{rec['arch']} × {rec['shape']}"
        mesh = rec["mesh"]
        variant = rec.get("overrides")
        if variant or path.stem.count("__") > 2:
            continue  # hillclimb variants reported in §Perf
        if rec["status"] in ("skipped", "refused"):
            rows.append((name, mesh, rec["status"], "—", "—", "—", "—",
                         rec.get("skip_reason", "")[:60]))
            continue
        if rec["status"] != "ok":
            rows.append((name, mesh, "ERROR", "—", "—", "—", "—",
                         rec.get("error", "")[:60]))
            continue
        args = rec.get("argument_size_in_bytes", 0)
        temp = rec.get("temp_size_in_bytes", 0)
        fits = "yes" if (args + temp) <= HBM_PER_CHIP else \
            f"no ({gb(args + temp)} GB)"
        coll = rec.get("collectives", {})
        ctypes = ",".join(k for k, v in coll.items() if v["count"])
        rows.append((name, mesh, "ok", f"{rec.get('pass_s', 0):.1f}s",
                     gb(args), gb(temp), fits, ctypes or "none"))

    out = ["| arch × shape | mesh | status | pass | args GB/card | "
           f"temp GB/card | fits {CARD_MEMORY} | collectives |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append("| " + " | ".join(str(c) for c in r) + " |")
    return "\n".join(out) + "\n"


KINDS = ("all-gather", "all-reduce", "reduce-scatter")


def collectives_table(artifact_dir: Path) -> str:
    """One row per ``ok`` record on ``single`` or ``multi``: arch, shape,
    mesh, variant, arguments + peak temporaries (GB), all-gather /
    all-reduce / reduce-scatter GB, fits one card."""
    out = ["| arch | shape | mesh | variant | args + temp GB | "
           "all-gather / all-reduce / reduce-scatter GB | fits |",
           "|---|---|---|---|---|---|---|"]
    for path in sorted(artifact_dir.glob("*.json")):
        rec = json.loads(path.read_text())
        if rec.get("status") != "ok" or rec.get("mesh") == "local":
            continue
        variant = path.stem.split("__")[3] if path.stem.count("__") > 2 \
            else "—"
        args, temp = rec["argument_size_in_bytes"], rec["temp_size_in_bytes"]
        coll = " / ".join(f"{rec['collectives'][k]['bytes'] / 1e9:.3g}"
                          for k in KINDS)
        fits = "yes" if args + temp <= HBM_PER_CHIP else "no"
        out.append(f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
                   f"{variant} | {gb(args)} + {gb(temp)} | {coll} | {fits} |")
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="artifacts/dryrun")
    ap.add_argument("--md", default=None)
    ap.add_argument("--collectives", action="store_true",
                    help="the mesh records' bytes and collectives by kind")
    args = ap.parse_args(argv)
    md = (collectives_table if args.collectives else build)(
        Path(args.artifacts))
    print(md)
    if args.md:
        Path(args.md).write_text(md)


if __name__ == "__main__":
    main()
