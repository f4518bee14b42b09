"""Build the §Roofline table from dry-run artifacts
(``repro/roofline/report.py``).

  PYTHONPATH=src python -m repro_torch.roofline.report [--mesh local] [--md out.md]

Per cell: the three roofline terms (seconds) on the card's rates
(``analysis.HW``), dominant bottleneck, MODEL_FLOPS ratio, roofline
fraction, and a what-would-move-it note.  The FLOPs are the dry run's own
count (``cost_analysis.flops``: ``analysis.FlopCounter`` over the cell's
step, what ``analysis.count_cell_flops`` returns), so nothing is counted
twice.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs.base import SHAPES
from . import analysis


def _note(row: dict) -> str:
    d = row["dominant"]
    if d == "compute":
        if row["useful_flops_ratio"] < 0.5:
            return ("compute-bound with low useful-FLOP ratio: cut remat "
                    "recompute (remat='dots') / avoid duplicated expert math")
        return "compute-bound near useful peak: only faster kernels help"
    if d == "memory":
        return ("HBM-bound: shrink cache/activation dtype (bf16/f8), fuse "
                "reads, or raise arithmetic intensity (larger per-chip tiles)")
    return ("collective-bound: reshard to cut per-layer all-gathers, overlap "
            "collectives with compute, or move traffic off the layer loop")


def row_of(rec: dict) -> dict:
    """The roofline row of an ``ok`` dry-run record (its FLOPs and floor
    are the dry run's).  On ``single`` and ``multi`` a record's FLOPs are
    one device's (rank 0's), so the cell's are them times the devices,
    replicated work included."""
    arch, shape = rec["arch"], rec["shape"]
    mf = analysis.model_flops_for(arch, shape)
    flops = rec["cost_analysis"]["flops"]
    if rec["mesh"] != "local":
        flops *= rec["n_devices"]
    row = analysis.roofline_row(rec, flops_global=flops,
                                chips=rec["n_devices"],
                                model_flops=mf, kind=SHAPES[shape].kind)
    row.update({"arch": arch, "shape": shape, "status": "ok",
                "pass_s": rec.get("pass_s")})
    row["note"] = _note(row)
    return row


def build_rows(artifact_dir: Path, mesh: str):
    rows = []
    for path in sorted(artifact_dir.glob(f"*__{mesh}.json")):
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "status": rec["status"],
                         "note": rec.get("skip_reason", rec.get("error", ""))})
            continue
        rows.append(row_of(rec))
    return rows


def to_markdown(rows, mesh: str) -> str:
    out = [f"### Roofline — {mesh} mesh ({analysis.CARD}: "
           f"{analysis.HW['peak_flops'] / 1e12:g} TFLOP/s bf16, "
           f"{analysis.HW['hbm_bw'] / 1e12:g} TB/s)\n",
           "| arch | shape | compute (s) | memory (s) | collective (s) | "
           "dominant | useful-FLOP ratio | roofline frac | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"{r['status']} | — | — | {r.get('note','')[:80]} |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"{r['dominant']} | {r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {r['note'][:90]} |")
    return "\n".join(out) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="local")
    ap.add_argument("--md", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    rows = build_rows(Path(args.artifacts), args.mesh)
    md = to_markdown(rows, args.mesh)
    print(md)
    if args.md:
        Path(args.md).write_text(md)
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=1, default=str))


if __name__ == "__main__":
    main()
