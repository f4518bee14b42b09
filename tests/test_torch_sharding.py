"""The port's sharding rules (``repro_torch.distributed.sharding``,
``repro_torch.serve.engine.cache_shardings``) against the reference's, spec
for spec, on the production meshes' geometry (``AbstractMesh`` there, an
``{axis: size}`` mapping here; no device and no process group).

* ``params_shardings`` in megatron and fsdp mode: llama3.2-3b and
  deepseek-v2-lite-16b at full width (the reference's tree from one
  ``jax.eval_shape``, the port's built over fake tensors), every other
  arch reduced.  The reference stacks the dense and MoE blocks (a leading
  layer axis); the port's leaves are one layer each, so a stacked leaf's
  spec is compared without its leading entry, which must be None;
* ``batch_shardings`` on each arch's batch, both modes;
* ``cache_shardings`` leaf by leaf on every arch's caches, and the
  reference's own ``test_cache_shardings_pick_batch_and_model_dims``
  case;
* ``shard_shape`` and ``to_placements``; with no ambient mesh
  ``maybe_constraint`` and ``use_param`` return their input.
"""
import re

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro_torch.configs.registry import all_archs  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
FULL = ("llama3.2-3b", "deepseek-v2-lite-16b")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests' tensors are small or fake."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(which):
    shape, axes = MESHES[which]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def _norm(spec) -> tuple:
    """A spec (a reference ``PartitionSpec`` or the port's tuple) with
    each entry canonical: an entry naming one axis as the name (JAX keeps
    ``("data",)`` as ``"data"``)."""
    def entry(e):
        if isinstance(e, (tuple, list)):
            return e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(entry(e) for e in spec)


def _ref_specs(tree) -> dict:
    from repro.distributed.sharding import _path_str
    return {_path_str(kp): _norm(sh.spec) for kp, sh in
            jtu.tree_flatten_with_path(
                tree, is_leaf=lambda x: hasattr(x, "spec"))[0]}


_BLOCK = re.compile(r"^blocks\.\d+\.")


def _ref_key(port_key: str, stacked: bool):
    """The reference's path of a port state-dict key, and whether the
    reference's leaf carries the stacked layer axis."""
    if stacked and _BLOCK.match(port_key):
        return "blocks/" + _BLOCK.sub("", port_key).replace(".", "/"), True
    return port_key.replace(".", "/"), False


def _models(arch):
    """(JAX param shapes, the port's parameters (fake tensors at full
    width), whether the reference stacks the blocks) of ``arch``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro.configs.registry import get_config as jget
    from repro.models.registry import build_model as jbuild
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    full = arch in FULL
    jcfg = jget(arch, reduced=not full)
    ref = jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))
    with FakeTensorMode():
        m = build_model(get_config(arch, reduced=not full), device="cpu")
    stacked = jcfg.family in ("dense", "moe") and jcfg.scan_layers
    return ref, dict(m.named_parameters()), stacked


@pytest.mark.parametrize("arch", all_archs())
def test_params_shardings_equal_the_references(arch):
    from repro.distributed.sharding import params_shardings as ref_ps
    ref, params, stacked = _models(arch)
    for which in MESHES:
        amesh, mesh = _meshes(which)
        for mode in ("megatron", "fsdp"):
            want = _ref_specs(ref_ps(ref, amesh, mode))
            got = S.params_shardings(params, mesh, mode)
            assert set(got) == set(params)
            for key, spec in got.items():
                path, lead = _ref_key(key, stacked)
                w = want[path]
                if lead:
                    assert w[0] is None, (which, mode, key, w)
                    w = w[1:]
                assert _norm(spec) == w, (which, mode, key, spec, w)
            assert len({_ref_key(k, stacked)[0] for k in got}) == len(want)


@pytest.mark.parametrize("arch", all_archs())
def test_batch_and_cache_shardings_equal_the_references(arch):
    from repro.configs.registry import get_config as jget
    from repro.data.synthetic import batch_spec as jbatch
    from repro.distributed.sharding import batch_shardings as ref_bs
    from repro.serve.engine import cache_shardings as ref_cs
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import batch_spec
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import cache_shardings
    cfg = get_config(arch, reduced=True)
    B, T = 32, 64
    jb = jbatch(jget(arch, reduced=True), B, T)
    pb = {k: torch.empty(s, dtype=d)
          for k, (s, d) in batch_spec(cfg, B, T).items()}
    caches = build_model(cfg, device="cpu").init_cache(B, T)
    for which in MESHES:
        amesh, mesh = _meshes(which)
        for mode in ("megatron", "fsdp"):
            want = {k: _norm(v.spec) for k, v in ref_bs(jb, amesh,
                                                        mode).items()}
            got = S.batch_shardings(pb, mesh, mode)
            assert {k: _norm(v) for k, v in got.items()} == want, (which,
                                                                   mode)
        pairs = _pairs(caches, cache_shardings(caches, mesh, B))
        assert pairs
        for t, spec in pairs:
            ref = ref_cs({"x": jax.ShapeDtypeStruct(tuple(t.shape),
                                                    jnp.float32)}, amesh, B)
            assert _norm(spec) == _norm(ref["x"].spec), (which, t.shape)


def _pairs(tree, specs) -> list:
    """(leaf, spec) of a tensor tree and its spec tree, walked together."""
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [p for k, v in items for p in _pairs(v, specs[k])]


def test_cache_shardings_of_llama_at_decode_32k():
    """llama3.2-3b's full-width ``decode_32k`` caches (B = 128, S = 32,768,
    fake tensors) against the reference's stacked ones: the batch over
    the batch axes, the sequence over "model"."""
    from repro.launch.specs import input_specs as ref_specs
    from repro.serve.engine import cache_shardings as ref_cs
    from repro_torch.launch.specs import input_specs
    from repro_torch.serve.engine import cache_shardings
    ref = ref_specs("llama3.2-3b", "decode_32k")["caches"]
    caches = input_specs("llama3.2-3b", "decode_32k")["caches"]
    for which in MESHES:
        amesh, mesh = _meshes(which)
        want = {k: _norm(v.spec) for k, v in ref_cs(ref, amesh, 128).items()}
        for layer in cache_shardings(caches, mesh, 128):
            for k, spec in layer.items():
                assert want[k][0] is None and _norm(spec) == want[k][1:]
        assert want["k"][2] == "model"


def test_cache_shardings_pick_batch_and_model_dims():
    """The reference's ``tests/test_serve.py`` case, on the port."""
    from repro_torch.serve.engine import cache_shardings
    _, mesh = _meshes("single")
    cache = {"k": torch.empty((32, 128, 4, 64), dtype=torch.bfloat16),
             "h": torch.empty((32, 16, 64))}
    sh = cache_shardings(cache, mesh, batch_size=32)
    # batch dim (size 32, divisible by data=16) shards over data
    assert sh["k"][0] == ("data",) and sh["h"][0] == ("data",)
    # the largest divisible non-batch dim (seq=128) gets "model"
    assert sh["k"][1] == "model"
    # h: largest divisible dim is 64 (dim 2); 16 would also divide
    assert sh["h"][2] == "model"


def test_shard_shape_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)
    m = Mesh()
    spec = (("pod", "data"), None, "model", None)
    assert S.shard_shape((64, 5, 32, 3), spec, m) == (2, 5, 2, 3)
    assert S.to_placements(spec, m) == [Shard(0), Shard(0), Shard(2)]
    assert S.to_placements((), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        S.to_placements((("data", "pod"),), m)
    with pytest.raises(ValueError, match="divide"):
        S.shard_shape((24,), ("model",), m)


def test_call_sites_are_the_identity_without_a_mesh():
    assert S.ambient_mesh() is None
    x = torch.randn(4, 3, 8)
    assert S.maybe_constraint(x, S.BATCH, None, "model") is x
    for mode in ("megatron", "fsdp"):
        S.set_mode(mode)
        try:
            assert S.use_param(x) is x
        finally:
            S.set_mode("megatron")
