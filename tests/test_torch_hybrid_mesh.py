"""zamba2 and xLSTM served over a device mesh on the CPU: reduced
zamba2-1.2b (Mamba-2 blocks and the shared attention) and reduced
xlstm-1.3b (mLSTM and sLSTM blocks) over gloo ranks on ``(1, 2)`` and
``(2, 2)`` ``("data", "model")`` meshes, one spawn each
(``testing.multidevice.serve_mesh_many``): parameters from the JAX
model's ``key(0)`` through ``interop.params_from_numpy``, placed by the
reference's rules (``win`` and ``wup`` by columns, ``wout``, ``wdown`` and
``wproj`` by rows), the states by ``cache_shardings`` (the SSM state on P,
the conv window on its channels, the xLSTM states on their last dim).

The prefill's last logits (B=4; T=17, xLSTM T=16, a multiple of its
mLSTM chunk) and 3 decode steps', under ``"gather"`` and ``"sp"``, within
1e-4 of the JAX model's ``decode_step`` fed one position at a time (the
JAX prefill is not causal, ROADMAP C3); sp within 1e-5 of gather; every
leaf's local shape its ``shard_shape``.  zamba2 also runs under
``attn_impl="pallas"`` (``ops.ssd`` and ``ops.mha`` on the ranks' heads;
their plain versions here) against the same JAX logits and with
``ssm_head_dim=8``, whose SSM state the rule shards on N; xLSTM also with
one head (``n_heads=1``), which no model size divides: every rank then
runs every head.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

B, N = 4, 3
MESHES = [(1, 2), (2, 2)]
#: (name, arch, config changes on both sides, prompt length)
CASES = (("zamba2", "zamba2-1.2b", {}, 17),
         ("zamba2-p8", "zamba2-1.2b", {"ssm_head_dim": 8}, 17),
         ("xlstm", "xlstm-1.3b", {}, 16),
         ("xlstm-1head", "xlstm-1.3b", {"n_heads": 1}, 16))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (the ranks set their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    from repro.configs.registry import get_config as jget
    from repro_torch.configs.registry import get_config
    return (dataclasses.replace(jget(arch, reduced=True), **over),
            dataclasses.replace(get_config(arch, reduced=True), **over))


@pytest.fixture(scope="module")
def reference():
    """Per case: the JAX parameters on the host, prompts [B, T], fed tokens
    [B, N] and the JAX logits [N + 1, B, V] at positions T - 1 .. T + N -
    1 from ``decode_step`` fed one position at a time."""
    import jax.numpy as jnp
    from repro.models.registry import build_model as jbuild
    out = {}
    for seed, (name, arch, over, T) in enumerate(CASES):
        jcfg, _ = _cfgs(arch, **over)
        jm = jbuild(jcfg)
        params = jm.init(jax.random.key(0))
        toks = np.random.default_rng(seed).integers(
            0, jcfg.vocab_size, (B, T + N), dtype=np.int64)
        step = jax.jit(jm.decode_step)
        caches = jm.init_cache(B, T + N, jnp.float32)
        want = []
        for i in range(T + N):
            logits, caches = step(params, jnp.asarray(toks[:, i:i + 1],
                                                      jnp.int32),
                                  caches, jnp.int32(i))
            if i >= T - 1:
                want.append(np.asarray(logits[:, -1], np.float32))
        out[name] = dict(tree=jax.device_get(params), prompts=toks[:, :T],
                         feed=toks[:, T:], want=np.stack(want))
    return out


def _jobs(reference):
    jobs, names = [], []
    for name, arch, over, _ in CASES:
        ref = reference[name]
        _, cfg = _cfgs(arch, **over)
        jobs.append(dict(cfg=cfg, prompts=ref["prompts"], tree=ref["tree"],
                         runs=[(cfg.dtype, ref["feed"], ("gather", "sp"),
                                None)]))
        names.append(name)
    _, cfg = _cfgs("zamba2-1.2b", attn_impl="pallas")
    ref = reference["zamba2"]
    jobs.append(dict(cfg=cfg, prompts=ref["prompts"], tree=ref["tree"],
                     runs=[(cfg.dtype, ref["feed"], ("gather",), None)]))
    names.append("zamba2-pallas")
    return names, jobs


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: "x".join(map(
    str, m)))
def served(request, reference):
    """(mesh shape, each rank's results by case name)."""
    from repro_torch.core.dist import spawn
    from repro_torch.testing.multidevice import serve_mesh_many
    mesh = request.param
    names, jobs = _jobs(reference)
    ranks = spawn(serve_mesh_many, mesh[0] * mesh[1], [(mesh, jobs)],
                  timeout=60, join_timeout=300)
    return mesh, [dict(zip(names, r)) for r, in ranks]


def _check(served, reference, name, ref_name=None, modes=("gather", "sp")):
    _, ranks = served
    want = reference[ref_name or name]["want"]
    for r, res in enumerate(ranks):
        run, = res[name]["runs"]
        for mode in modes:
            got = run["modes"][mode]["logits"]
            assert got.shape == want.shape
            err = float(np.max(np.abs(got - want)))
            assert err < 1e-4, (name, r, mode, err)


def test_zamba2_serving_matches_jax(served, reference):
    _check(served, reference, "zamba2")


def test_zamba2_pallas_path_matches_jax(served, reference):
    _check(served, reference, "zamba2-pallas", "zamba2", ("gather",))


def test_zamba2_state_sharded_off_its_head_dim(served, reference):
    """``ssm_head_dim=8`` (16 heads of 8): the rule shards ``h`` [B, 16, 16,
    8] on N, not P, so a decode step gathers the state and writes its
    blocks back instead of advancing its own block of P."""
    mesh, ranks = served
    _check(served, reference, "zamba2-p8")
    h = {s[1]: s[2] for s in ranks[0]["zamba2-p8"]["shapes"]}["mamba.0.h"]
    assert h == (B // mesh[0], 16, 16 // mesh[1], 8)


def test_xlstm_serving_matches_jax(served, reference):
    _check(served, reference, "xlstm")


def test_xlstm_heads_not_dividing_the_axis(served, reference):
    _check(served, reference, "xlstm-1head")


def test_sp_equals_gather(served, reference):
    _, ranks = served
    for res in ranks:
        for name, *_ in CASES:
            run, = res[name]["runs"]
            assert run["sp_vs_gather"] < 1e-5, (name, run["sp_vs_gather"])


def test_local_shapes_are_shard_shapes(served, reference):
    mesh, ranks = served
    for r, res in enumerate(ranks):
        for name, out in res.items():
            for what, key, local, expect in out["shapes"]:
                assert tuple(local) == tuple(expect), (r, name, what, key)
        z = {s[1]: s[2] for s in res["zamba2"]["shapes"]}
        Bl, M = B // mesh[0], mesh[1]
        # reduced zamba2: d 64, di 128, N 16, H 8 heads of P 16, conv 4
        assert z["blocks.0.win"] == (64, (2 * 128 + 2 * 16 + 8) // M)
        assert z["blocks.0.wout"] == (128 // M, 64)
        assert z["mamba.0.h"] == (Bl, 8, 16, 16 // M)
        assert z["mamba.0.conv"] == (Bl, 3, (128 + 2 * 16) // M)
        x = {s[1]: s[2] for s in res["xlstm"]["shapes"]}
        # reduced xlstm: d 64, 2 heads; mLSTM di 128, sLSTM dh 32
        assert x["blocks.0.wup"] == (64, 256 // M)
        assert x["0"] == (Bl, 2, 64, 64 // M)
        assert x["2.0"] == (Bl, 2, 32 // M)
