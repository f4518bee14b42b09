"""Dry run of the port: every (arch x shape) cell's step run once over fake
tensors on the CPU, at full size, with nothing allocated
(``repro/launch/dryrun.py``, whose cells are lowered and compiled by XLA on
512 placeholder devices instead).

For each cell this writes ``<out>/<arch>__<shape>__<mesh>.json`` with the
reference's record:

* ``argument_size_in_bytes``: the exact bytes of the step's inputs
  (parameters, optimizer state and batch; or parameters, batch or tokens,
  and caches);
* ``temp_size_in_bytes``: the peak of the live bytes the step allocates
  above them (``roofline.analysis.FlopCounter``'s tally of the storages its
  ops make, freed as they die); ``output_size_in_bytes``: what the step
  returns that is not an input;
* ``cost_analysis``: ``flops`` (the counter's total), ``dot flops`` (its
  products) and ``bytes accessed``, the bytes each eager op reads and
  writes.  The reference's is XLA's count over fused HLO, so it is smaller
  for the same step;
* ``collectives``: the reference's kinds, counted from the
  ``torch.distributed`` collectives the pass issues (all zero on one
  device).  Layers run unrolled, so each collective is counted as it is
  issued: the reference's HLO parser (``collective_bytes``) has no
  counterpart and ``scaled_bytes`` equals ``bytes``;
* ``param_count``, ``active_param_count`` (analytic), the
  ``analytic_memory_floor``, and the seconds: ``build_s`` (the fake inputs)
  and ``pass_s`` (the step).

``--mesh local`` runs the step on the devices there are (one card on the
records' machine).  ``--mesh single`` and ``multi`` run it on the
reference's 16x16 or 2x16x16 pod, over a fake process group of 256 or 512
ranks in this process (``launch.mesh.fake_mesh``): the parameters, the
batch or tokens and the caches are placed by the reference's rules
(``distributed.sharding``, ``serve.engine.cache_shardings``, the config's
``sharding_mode``) and the step runs on DTensors with the mesh ambient, so
the record is rank 0's, per device: ``argument_size_in_bytes`` its
shards, ``temp_size_in_bytes`` its peak, ``cost_analysis`` its ops,
``collectives`` its collectives and their bytes, ``n_devices`` 256 or 512
(the floor stays the global one, as in the reference).  Those meshes run
every serving cell of every family (MoE's expert-parallel dispatch, MLA's
latent cache, zamba2's and xLSTM's heads) and the dense decoders' train
cells; the other families' train cells refuse naming ROADMAP A21 (a
``"refused"`` record).  A train cell's inputs are the
parameters, the AdamW state (placed by the same rules) and the batch, and
its step is ``make_train_step``'s, forward, backward and update: under
fsdp its ``collectives`` count the per-layer all-gathers of ``use_param``
and their reduce-scatters in the backward.  ``--override _grad_shard=true``
gives the step the parameters' specs as ``grad_shardings`` (the ZeRO-2
constraint), as the reference's dry run does.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh local
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k \\
      --override remat=none --variant remat_none
"""
import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

from ..configs.base import SHAPES
from ..configs.registry import all_archs, get_config
from ..distributed import sharding
from ..launch.mesh import make_local_mesh, make_production_mesh
from ..launch.specs import cell_is_skipped, input_specs
from ..roofline.analysis import (FlopCounter, _bytes_of, _tensors,
                                 memory_floor, step_call)
from ..serve.engine import cache_shardings

MESHES = ("local", "single", "multi")


def mesh_for(kind: str):
    """The mesh ``--mesh kind`` names: ``single`` and ``multi`` over a fake
    process group made in this process (``make_production_mesh(fake=
    True)``)."""
    if kind == "local":
        return make_local_mesh()
    if kind in ("single", "multi"):
        return make_production_mesh(multi_pod=kind == "multi", fake=True)
    raise ValueError(f"unknown mesh {kind!r}; one of {MESHES}")


def place_spec(spec: dict, mesh, batch_size: int) -> None:
    """Place a cell's inputs on ``mesh``, in place in ``spec`` (under its
    fake mode): the model's parameters (``sharding.place_module``; the
    config's ``sharding_mode`` must be set; their specs kept as
    ``spec["grad_shardings"]``), the batch or the tokens
    (``batch_shardings``), and the caches (``cache_shardings``) or the
    AdamW state (``params_shardings`` of the state)."""
    with spec["mode"]:
        spec["grad_shardings"] = sharding.place_module(spec["model"], mesh)
        spec["params"] = dict(spec["model"].named_parameters())
        if spec["kind"] == "train":
            spec["opt_state"] = sharding.place(
                spec["opt_state"],
                sharding.params_shardings(spec["opt_state"], mesh), mesh)
            spec["batch"] = sharding.place(
                spec["batch"], sharding.batch_shardings(spec["batch"], mesh),
                mesh)
            return
        spec["caches"] = sharding.place(
            spec["caches"], cache_shardings(spec["caches"], mesh, batch_size),
            mesh)
        key = "batch" if spec["kind"] == "prefill" else "tokens"
        spec[key] = sharding.place(
            spec[key], sharding.batch_shardings(spec[key], mesh), mesh)


def _parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        elif v in ("false", "False"):
            v = False
        out[k] = v
    return out


def _inputs(spec: dict) -> list:
    keys = {"train": ("params", "opt_state", "batch"),
            "prefill": ("params", "batch", "caches"),
            "decode": ("params", "tokens", "caches", "cur_len")}
    return [spec[k] for k in keys[spec["kind"]]]


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             skip_collectives: bool = False, mesh=None,
             overrides: dict | None = None) -> dict:
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "ok"}
    if overrides:
        rec["overrides"] = dict(overrides)
    reason = cell_is_skipped(arch, shape_name)
    if reason:
        rec["status"] = "skipped"
        rec["skip_reason"] = reason
        return rec

    sharded = mesh_kind != "local"
    if sharded:
        model_over = {k: v for k, v in (overrides or {}).items()
                      if not k.startswith(("train.", "_"))}
        sharding.refuse_unported(
            dataclasses.replace(get_config(arch), **model_over),
            SHAPES[shape_name].kind)
    if mesh is None:
        mesh = mesh_for(mesh_kind)
    rec["n_devices"] = mesh.size() if sharded else mesh.size
    t0 = time.time()
    spec = input_specs(arch, shape_name, overrides=overrides)
    cfg = spec["cfg"]
    floor = memory_floor(spec)
    mode = sharding.get_mode()
    try:
        if sharded:
            sharding.set_mode(cfg.sharding_mode)
            place_spec(spec, mesh, SHAPES[shape_name].global_batch)
        run = step_call(spec, overrides)
        rec["build_s"] = round(time.time() - t0, 2)

        t1 = time.time()
        ambient = (sharding.use_mesh(mesh) if sharded
                   else contextlib.nullcontext())
        with spec["mode"], ambient, FlopCounter() as c:
            out = run()
        rec["pass_s"] = round(time.time() - t1, 2)
    finally:
        sharding.set_mode(mode)

    inputs = _inputs(spec)
    held = {id(t.untyped_storage()) for t in _tensors(inputs)}
    rec["argument_size_in_bytes"] = int(_bytes_of(inputs))
    rec["output_size_in_bytes"] = int(sum(
        t.numel() * t.element_size() for t in _tensors(out)
        if id(t.untyped_storage()) not in held))
    rec["temp_size_in_bytes"] = int(c.peak)
    rec["cost_analysis"] = {"flops": c.total, "dot flops": c.dot,
                            "bytes accessed": c.bytes}
    if not skip_collectives:
        rec["collectives"] = c.collectives
    rec["analytic_memory_floor"] = floor

    # model params (analytic) for §Roofline MODEL_FLOPS = 6 N D
    rec["param_count"] = int(cfg.param_count())
    rec["active_param_count"] = int(cfg.active_param_count())
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=MESHES, default="local")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-collectives", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="tag for hillclimb runs (adds __<variant> to files)")
    ap.add_argument("--override", action="append", default=[],
                    help="ModelConfig field=value (train.* → TrainConfig)")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)

    mesh = mesh_for(args.mesh)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    cells = []
    if args.all:
        for a in all_archs():
            for s in SHAPES:
                cells.append((a, s))
    else:
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(args.arch, s) for s in shapes]

    failures = 0
    for arch, shape in cells:
        tag = f"{arch}__{shape}__{args.mesh}"
        if args.variant:
            tag += f"__{args.variant}"
        path = outdir / f"{tag}.json"
        if path.exists():
            print(f"[dryrun] {tag}: cached", flush=True)
            continue
        print(f"[dryrun] {tag}: running...", flush=True)
        try:
            rec = run_cell(arch, shape, args.mesh,
                           skip_collectives=args.skip_collectives, mesh=mesh,
                           overrides=overrides)
        except NotImplementedError as e:
            rec = {"arch": arch, "shape": shape, "mesh": args.mesh,
                   "status": "refused", "skip_reason": str(e)}
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "mesh": args.mesh,
                   "status": "error", "error": str(e),
                   "traceback": traceback.format_exc()}
            failures += 1
        path.write_text(json.dumps(rec, indent=1))
        print(f"[dryrun] {tag}: {rec['status']} (build "
              f"{rec.get('build_s', '-')}s, pass {rec.get('pass_s', '-')}s)",
              flush=True)
    print(f"[dryrun] done, {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
