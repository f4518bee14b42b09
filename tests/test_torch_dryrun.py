"""The port's dry run (``repro_torch.launch.{specs,mesh,dryrun}``,
``repro_torch.roofline.{report,variant,dryrun_summary}``) on the CPU, held
against the reference's where the two compute the same thing.

* ``cell_is_skipped``, ``model_flops_for`` and ``analytic_memory_floor``
  for every (arch x shape) cell against the reference's, each arch's fake
  model built once;
* a cell's record: the exact argument bytes, the FLOPs ``count_cell``
  gives, the floor, zero collectives on one device, and a collective
  counted when one is issued;
* the CLI's artifact names, the report's, the summary's and the variant's
  tables from them;
* ``--mesh single`` over the fake 256-rank group on a reduced dense
  prefill and decode cell: the argument bytes are the summed per-device
  shapes of the reference's specs, collectives are issued; the same for
  a reduced MoE (16 experts) and a reduced zamba2; the other families'
  train cells refused by name (A21);
* a reduced dense train cell over a fake ``(2, 2)`` mesh under fsdp with
  ``_grad_shard``: the AdamW state placed as the parameters, the
  backward's reduce-scatters counted.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.roofline import analysis as RA  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import all_archs, get_config  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests' tensors are small or fake, and the
    suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- model_flops_for, cell_is_skipped, analytic_memory_floor, every cell -------

@pytest.mark.parametrize("arch", all_archs())
def test_model_flops_and_skips_equal_the_references(arch):
    from repro.launch.specs import cell_is_skipped as ref_skip
    from repro_torch.launch.specs import cell_is_skipped
    for shape in SHAPES:
        assert cell_is_skipped(arch, shape) == ref_skip(arch, shape)
        assert A.model_flops_for(arch, shape) == \
            RA.model_flops_for(arch, shape)


def _batch_gap(ref_batch, port_batch) -> int:
    """Bytes by which the port's batch exceeds the reference's: the same
    leaves and shapes, token ids and labels int64 where the reference's
    are int32 (``data.synthetic``), every other leaf in the same dtype."""
    assert set(ref_batch) == set(port_batch)
    gap = 0
    for k, r in ref_batch.items():
        p = port_batch[k]
        assert tuple(r.shape) == tuple(p.shape), k
        if np.dtype(r.dtype) == np.int32:
            assert p.dtype == torch.int64, k
            gap += 4 * p.numel()
        else:
            assert np.dtype(r.dtype).itemsize == p.element_size(), k
    return gap


@pytest.mark.parametrize("arch", all_archs())
def test_memory_floor_equals_the_references(arch):
    """Parameters and caches are the reference's to the byte in every
    cell, so every decode cell's floor is equal bit for bit.  A train or
    prefill floor differs by exactly the bytes of the leaves the port
    keeps wider: int64 token ids and labels (its batch, read once), and
    under bf16 masters (kimi-k2-1t-a32b) f32 AdamW moments, which the
    reference makes in the masters' dtype (``train.optimizer``; the floor
    reads and writes them)."""
    from repro.launch.specs import input_specs as ref_specs
    from repro_torch.launch.specs import cell_is_skipped, specs_for
    cfg, first = get_config(arch), None
    for shape in SHAPES:
        if cell_is_skipped(arch, shape):
            continue
        spec = specs_for(cfg, SHAPES[shape], reuse=first)
        first = first or spec
        ref = ref_specs(arch, shape)
        assert A._bytes_of(spec["params"]) == RA._bytes_of(ref["params"])
        got, want = A.memory_floor(spec), _ref_floor(ref)
        if spec["kind"] != "train":
            assert A._bytes_of(spec["caches"]) == RA._bytes_of(ref["caches"])
        if spec["kind"] == "decode":
            assert got == want, (shape, got, want)
            continue
        gap = _batch_gap(ref["batch"], spec["batch"])
        if spec["kind"] == "train":
            n = sum(p.numel() for p in spec["params"].values())
            wider = 4 - np.dtype(jax.tree.leaves(ref["opt_state"].mu)[0]
                                 .dtype).itemsize
            assert wider == (2 if cfg.param_dtype == "bfloat16" else 0)
            gap += 2 * 2 * n * wider        # mu and nu, read and written
        assert got - want == gap, (shape, got - want, gap)


def _ref_floor(ref) -> float:
    """The reference's ``analytic_memory_floor`` of specs it has built."""
    pb = RA._bytes_of(ref["params"])
    if ref["kind"] == "train":
        return 4 * pb + 2 * RA._bytes_of(ref["opt_state"]) \
            + RA._bytes_of(ref["batch"])
    cb = RA._bytes_of(ref["caches"])
    if ref["kind"] == "prefill":
        return pb + 2 * cb + RA._bytes_of(ref["batch"])
    return pb + cb + cb


def test_ref_floor_helper_is_the_references():
    from repro.launch.specs import input_specs as ref_specs
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert _ref_floor(ref_specs("llama3.2-3b", shape)) == \
            RA.analytic_memory_floor("llama3.2-3b", shape)


# -- the dry run's records and tables ---------------------------------------------

#: a small train cell of a reduced-width config, in the port's ``SHAPES``.
TINY = ShapeConfig("tiny_train", 32, 2, "train")


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(SHAPES, TINY.name, TINY)
    monkeypatch.setattr("repro_torch.launch.specs.get_config",
                        lambda arch: get_config(arch, reduced=True))
    return TINY.name


@pytest.fixture
def fake_group():
    """The fake process group the production meshes make, destroyed after
    the test (so later tests in this process see none)."""
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_meshes_other_than_local_refuse_by_name(fake_group, tmp_path):
    """On ``single`` and ``multi`` a non-dense family's train cell refuses
    naming A21 before anything is built (its serving cells run:
    :func:`test_run_cell_of_other_families_on_the_single_mesh`); the CLI
    writes a ``"refused"`` record and exits 0."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    for mesh in ("single", "multi"):
        for arch in ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b",
                     "zamba2-1.2b", "xlstm-1.3b"):
            with pytest.raises(NotImplementedError, match="A21"):
                dryrun.run_cell(arch, "train_4k", mesh, mesh=object())
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "kimi-k2-1t-a32b", "--shape", "train_4k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "kimi-k2-1t-a32b__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "refused" and "A21" in rec["skip_reason"]
    m = make_local_mesh()
    assert m.shape == {"data": len(m.devices)} and m.size >= 1


TINY_SERVE = (ShapeConfig("tiny_prefill", 64, 32, "prefill"),
              ShapeConfig("tiny_decode", 64, 32, "decode"))


def _ref_local_bytes(tree, specs, mesh, itemsize) -> int:
    """Bytes of the per-device blocks of a reference tree of shapes under
    its specs (``shard_shape`` of each leaf), at ``itemsize`` bytes an
    element where given, else the leaf's own."""
    from repro_torch.distributed.sharding import shard_shape
    leaves = jax.tree.leaves(tree)
    spec = jax.tree.leaves(specs, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(spec)
    return sum(int(np.prod(shard_shape(t.shape, tuple(sp.spec), mesh)))
               * (itemsize or np.dtype(t.dtype).itemsize)
               for t, sp in zip(leaves, spec))


def test_run_cell_on_the_single_mesh(fake_group, monkeypatch):
    """Reduced granite-3-2b's prefill and decode on the fake 16x16 mesh:
    a per-device record whose argument bytes are the reference's specs'
    per-device blocks (parameters f32; token ids int64 here; caches f32),
    with all-gathers and all-reduces issued, the FLOPs one device's, and
    the floor the global one."""
    from repro.configs.registry import get_config as jget
    from repro.data.synthetic import batch_spec as jbatch
    from repro.distributed.sharding import (batch_shardings,
                                            params_shardings)
    from repro.models.registry import build_model as jbuild
    from repro.serve.engine import cache_shardings
    from jax.sharding import AbstractMesh
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.specs import input_specs
    for shape in TINY_SERVE:
        monkeypatch.setitem(SHAPES, shape.name, shape)
    monkeypatch.setattr("repro_torch.launch.specs.get_config",
                        lambda arch: get_config(arch, reduced=True))
    amesh = AbstractMesh((16, 16), ("data", "model"))
    mesh = {"data": 16, "model": 16}
    jcfg = jget("granite-3-2b", reduced=True)
    jm = jbuild(jcfg)
    params = jax.eval_shape(jm.init, jax.random.key(0))
    pbytes = _ref_local_bytes(params, params_shardings(params, amesh), mesh,
                              None)
    B, T = 32, 64
    caches = jax.eval_shape(lambda: jm.init_cache(B, T, jax.numpy.float32))
    cbytes = _ref_local_bytes(caches, cache_shardings(caches, amesh, B),
                              mesh, None)
    batch = jbatch(jcfg, B, T)
    tokens = {"t": jax.ShapeDtypeStruct((B, 1), np.int32)}
    for shape, inputs in zip(TINY_SERVE, (batch, tokens)):
        rec = run_cell("granite-3-2b", shape.name, "single")
        assert rec["status"] == "ok" and rec["n_devices"] == 256
        want = pbytes + cbytes + _ref_local_bytes(
            inputs, batch_shardings(inputs, amesh), mesh, 8)
        if shape.kind == "decode":
            want += 8                                       # cur_len
        assert rec["argument_size_in_bytes"] == want, (shape.name, want)
        coll = rec["collectives"]
        assert coll["all-gather"]["count"] > 0 and \
            coll["all-reduce"]["count"] > 0, coll
        assert rec["analytic_memory_floor"] == A.memory_floor(
            input_specs("granite-3-2b", shape.name))
        local = run_cell("granite-3-2b", shape.name, "local")
        assert 0 < rec["cost_analysis"]["dot flops"] < \
            local["cost_analysis"]["dot flops"]


@pytest.mark.parametrize("arch,over", [
    ("deepseek-v2-lite-16b", {"n_experts": 16}), ("zamba2-1.2b", {})])
def test_run_cell_of_other_families_on_the_single_mesh(fake_group,
                                                       monkeypatch, arch,
                                                       over):
    """A reduced MoE (deepseek-v2-lite-16b with 16 experts, so that they
    shard over the 16-wide "model" axis, and MLA's latent cache) and
    reduced zamba2-1.2b, prefill and decode on the fake 16x16 mesh: rank
    0's argument bytes are the reference's specs' per-device blocks
    (parameters and caches f32, token ids int64 here), with all-gathers
    and all-reduces issued, and for the MoE's prefill the expert buffer's
    reduce-scatter over "data" (``moe_buf_layout="md"``)."""
    from repro.configs.registry import get_config as jget
    from repro.data.synthetic import batch_spec as jbatch
    from repro.distributed.sharding import (batch_shardings,
                                            params_shardings)
    from repro.models.registry import build_model as jbuild
    from repro.serve.engine import cache_shardings
    from jax.sharding import AbstractMesh
    from repro_torch.launch.dryrun import run_cell
    for shape in TINY_SERVE:
        monkeypatch.setitem(SHAPES, shape.name, shape)
    monkeypatch.setattr("repro_torch.launch.specs.get_config",
                        lambda arch: get_config(arch, reduced=True))
    amesh = AbstractMesh((16, 16), ("data", "model"))
    mesh = {"data": 16, "model": 16}
    jcfg = dataclasses.replace(jget(arch, reduced=True), **over)
    jm = jbuild(jcfg)
    params = jax.eval_shape(jm.init, jax.random.key(0))
    pbytes = _ref_local_bytes(params, params_shardings(params, amesh), mesh,
                              None)
    B, T = 32, 64
    caches = jax.eval_shape(lambda: jm.init_cache(B, T, jax.numpy.float32))
    cbytes = _ref_local_bytes(caches, cache_shardings(caches, amesh, B),
                              mesh, None)
    batch = {"tokens": jax.ShapeDtypeStruct((B, T), np.int32)}
    tokens = {"t": jax.ShapeDtypeStruct((B, 1), np.int32)}
    for shape, inputs in zip(TINY_SERVE, (batch, tokens)):
        rec = run_cell(arch, shape.name, "single", overrides=over)
        assert rec["status"] == "ok" and rec["n_devices"] == 256
        want = pbytes + cbytes + _ref_local_bytes(
            inputs, batch_shardings(inputs, amesh), mesh, 8)
        if shape.kind == "decode":
            want += 8                                       # cur_len
        assert rec["argument_size_in_bytes"] == want, (shape.name, want)
        coll = rec["collectives"]
        assert coll["all-gather"]["count"] > 0 and \
            coll["all-reduce"]["count"] > 0, coll
        if over and shape.kind == "prefill":
            # the prefill's 384 slots an expert exceed its 3·ff = 192
            # weights a row: the buffer is scattered, the weights move
            assert coll["reduce-scatter"]["count"] > 0, coll


def test_train_cell_over_a_fake_mesh_under_fsdp(fake_group, monkeypatch):
    """Reduced granite-3-2b's train step over a fake (2, 2) mesh under
    fsdp with ``_grad_shard``: rank 0's arguments are its blocks of the
    parameters, of both moments (placed as the parameters) and of the
    batch; the step's all-gathers (``use_param``) and the backward's
    reduce-scatters are counted, one of each per parameter and mesh dim
    at least."""
    from repro_torch.distributed.sharding import (params_shardings,
                                                  shard_shape)
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.launch.specs import input_specs
    shape = ShapeConfig("tiny_train", 64, 8, "train")
    monkeypatch.setitem(SHAPES, shape.name, shape)
    monkeypatch.setattr("repro_torch.launch.specs.get_config",
                        lambda arch: get_config(arch, reduced=True))
    over = {"sharding_mode": "fsdp", "_grad_shard": True}
    rec = run_cell("granite-3-2b", shape.name, "single",
                   mesh=fake_mesh((2, 2), ("data", "model")),
                   overrides=over)
    assert rec["status"] == "ok" and rec["n_devices"] == 4
    spec = input_specs("granite-3-2b", shape.name)
    sizes = {"data": 2, "model": 2}
    specs = params_shardings(spec["params"], sizes, "fsdp")
    pbytes = sum(math.prod(shard_shape(p.shape, specs[k], sizes)) * 4
                 for k, p in spec["params"].items())
    want = 3 * pbytes + 4 + 8 * 8 * 64 // 4     # + count, int64 rows
    assert rec["argument_size_in_bytes"] == want
    coll = rec["collectives"]
    n = 2 * len(spec["params"])
    assert coll["all-gather"]["count"] >= n, coll
    assert coll["reduce-scatter"]["count"] >= n, coll


def test_run_cell_record(tiny):
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.specs import input_specs
    rec = run_cell("granite-3-2b", tiny, "local")
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    spec = input_specs("granite-3-2b", tiny)
    want = sum(A._bytes_of(spec[k]) for k in ("params", "opt_state",
                                              "batch"))
    assert rec["argument_size_in_bytes"] == want
    c = A.count_cell("granite-3-2b", tiny)
    assert rec["cost_analysis"] == {"flops": c.total, "dot flops": c.dot,
                                    "bytes accessed": c.bytes}
    assert rec["temp_size_in_bytes"] == c.peak > 0
    assert rec["analytic_memory_floor"] == A.memory_floor(spec)
    assert all(v == {"bytes": 0, "count": 0, "scaled_bytes": 0.0}
               for v in rec["collectives"].values())
    assert rec["param_count"] == get_config("granite-3-2b",
                                            reduced=True).param_count()


def test_cli_artifacts_and_tables(tiny, tmp_path, capsys):
    from repro_torch.launch import dryrun
    from repro_torch.roofline import dryrun_summary, report, variant
    out = tmp_path / "dryrun"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-3b", "--shape", tiny,
                     "--out", str(out)])
    assert e.value.code == 0
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-3b", "--shape", tiny,
                     "--out", str(out), "--override", "remat=full",
                     "--variant", "remat_full"])
    assert e.value.code == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == [f"llama3.2-3b__{tiny}__local.json",
                     f"llama3.2-3b__{tiny}__local__remat_full.json"]
    rows = report.build_rows(out, "local")
    assert [r["shape"] for r in rows] == [tiny]
    r = rows[0]
    assert r["hlo_jaxpr_flops"] == json.loads(
        (out / names[0]).read_text())["cost_analysis"]["flops"]
    assert r["compute_s"] == r["hlo_jaxpr_flops"] / A.HW["peak_flops"]
    assert "llama3.2-3b" in report.to_markdown(rows, "local")
    table = dryrun_summary.build(out)
    assert table.count("llama3.2-3b") == 1      # the variant is left out
    assert "| yes |" in table
    v = variant.row_for(str(out / names[1]))
    assert v["variant"] == "remat_full" and v["overrides"] == {
        "remat": "full"}
    # a full remat recomputes the forward, so it counts more.
    assert v["hlo_jaxpr_flops"] > r["hlo_jaxpr_flops"]
    capsys.readouterr()


def test_a_collective_is_counted(tmp_path):
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already initialized here")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        t = torch.ones(16)
        with A.FlopCounter() as c:
            dist.all_reduce(t)
        want = {"bytes": 64, "count": 1, "scaled_bytes": 64.0}
        assert c.collectives["all-reduce"] == want
        assert sum(v["count"] for v in c.collectives.values()) == 1
    finally:
        dist.destroy_process_group()
