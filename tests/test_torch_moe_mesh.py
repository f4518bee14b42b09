"""The MoE family served over a device mesh on the CPU: reduced
deepseek-v2-lite-16b (MLA, 8 experts top-2, 2 shared) and reduced
kimi-k2-1t-a32b (GQA, 8 experts, 1 shared) over gloo ranks on ``(1, 2)``,
``(2, 1)`` and ``(2, 2)`` ``("data", "model")`` meshes, one spawn each
(``testing.multidevice.serve_mesh_many``): parameters from the JAX
model's ``key(0)`` through ``interop.params_from_numpy``, placed by the
reference's rules (experts over "model", their ff dim over "data"), the
caches by ``cache_shardings``.

* The prefill's last logits (B=4, T=17) and 3 decode steps', under
  ``"gather"`` and the sequence-parallel ``"sp"``, within 1e-4 of the JAX
  model's ``decode_step`` fed one position at a time (the JAX prefill is
  not causal, ROADMAP C3); sp within 1e-5 of gather.  deepseek's latent
  cache at 64 rows shards its sequence over "model"; at 20 rows (fewer
  than ``kv_lora_rank`` 32) it shards the latent, and both modes gather.
* A drop case: B=4, T=160, ``capacity_factor=0.5`` on both sides (cap
  128, 1,280 pairs over 8 x 128 slots): the mesh prefill's logits at
  every position within 1e-4 of the JAX teacher-forced forward, pairs
  dropped, and each rank's dispatch (experts and kept pairs) exactly the
  one-device port's ``route`` on its rows.
* ``moe_buf_layout`` ``"md"``, ``"m"`` and ``"none"`` within 1e-5 of each
  other (at ``moe_d_ff=32``, where the prefill moves the experts' weights
  under ``"md"`` and ``"none"``); every parameter and cache leaf's local
  shape is its ``shard_shape``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

B, T, N = 4, 17, 3
DROP_T, DROP_CF = 160, 0.5
MESHES = [(1, 2), (2, 1), (2, 2)]
ARCHS = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b")


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


def _stepwise(jm, params, toks, rows):
    """The JAX logits [N + 1, B, V] at positions T - 1 .. T + N - 1, from
    ``decode_step`` fed one position at a time into caches of ``rows``."""
    import jax.numpy as jnp
    step = jax.jit(jm.decode_step)
    caches = jm.init_cache(B, rows, jnp.float32)
    want = []
    for i in range(T + N):
        logits, caches = step(params, jnp.asarray(toks[:, i:i + 1],
                                                  jnp.int32),
                              caches, jnp.int32(i))
        if i >= T - 1:
            want.append(np.asarray(logits[:, -1], np.float32))
    return np.stack(want)


def _teacher_forced(jm, jcfg, params, toks):
    import jax.numpy as jnp
    from repro.models.layers import unembed

    @jax.jit
    def fwd(params, toks):
        x, _, _ = jm.embed_inputs(params, {"tokens": toks})
        h, _ = jm.backbone(params, x, jnp.arange(toks.shape[1])[None])
        return unembed(jcfg, params["embed"], h)
    return np.asarray(fwd(params, jnp.asarray(toks, jnp.int32)), np.float32)


def _one_device_routes(cfg, tree, toks):
    """The one-device port's dispatch of each MoE layer in a prefill of
    ``toks``: ``(idx, keep)`` [B·T, k] each, in (token, slot) order (and
    each token's router margin)."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.testing.multidevice import _recording_routes
    m = build_model(cfg, device="cpu")
    m.load_state_dict(params_from_numpy(tree, cfg))
    seen = []
    with _recording_routes(seen):
        m.prefill({"tokens": torch.as_tensor(toks)},
                  m.init_cache(toks.shape[0], toks.shape[1]))
    return seen


@pytest.fixture(scope="module")
def reference():
    """Per arch: the JAX parameters on the host, prompts and fed tokens,
    the stepwise logits (deepseek at 64 and 20 cache rows), and the drop
    case's tokens, teacher-forced logits and one-device routes."""
    from repro.models.registry import build_model as jbuild
    out = {}
    for seed, arch in enumerate(ARCHS):
        jcfg, cfg = _cfgs(arch)
        jm = jbuild(jcfg)
        params = jm.init(jax.random.key(0))
        tree = jax.device_get(params)
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, jcfg.vocab_size, (B, T + N), dtype=np.int64)
        rows = (64, T + N) if cfg.use_mla else (T + N,)
        drop = rng.integers(0, jcfg.vocab_size, (B, DROP_T), dtype=np.int64)
        jdrop, drop_cfg = _cfgs(arch, capacity_factor=DROP_CF)
        out[arch] = dict(
            tree=tree, prompts=toks[:, :T], feed=toks[:, T:],
            want={r: _stepwise(jm, params, toks, r) for r in rows},
            drop=drop,
            drop_want=_teacher_forced(jbuild(jdrop), jdrop, params, drop),
            drop_routes=_one_device_routes(drop_cfg, tree, drop))
    return out


def _jobs(reference):
    jobs = []
    for arch in ARCHS:
        ref = reference[arch]
        _, cfg = _cfgs(arch)
        for rows in ref["want"]:
            jobs.append(dict(cfg=cfg, prompts=ref["prompts"], tree=ref["tree"],
                             runs=[(cfg.dtype, ref["feed"], ("gather", "sp"),
                                    None)], max_len=rows))
        _, drop_cfg = _cfgs(arch, capacity_factor=DROP_CF)
        jobs.append(dict(cfg=drop_cfg, prompts=ref["drop"], tree=ref["tree"],
                         runs=[(cfg.dtype, ref["drop"][:, :0], (), None)],
                         routes=True, all_logits=True, keep_logits=False))
    # an ff of 32 (3·ff below the prefill's 128 slots) so that "md" and
    # "none" move the experts' weights in the prefill, the buffer in decode
    for layout in ("md", "m", "none"):
        _, cfg = _cfgs(ARCHS[0], moe_buf_layout=layout, moe_d_ff=32)
        jobs.append(dict(cfg=cfg, prompts=ref["prompts"],
                         runs=[(cfg.dtype, ref["feed"], ("gather",), None)],
                         max_len=64))
    return jobs


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: "x".join(map(
    str, m)))
def served(request, reference):
    """(mesh shape, each rank's results by job name)."""
    from repro_torch.core.dist import spawn
    from repro_torch.testing.multidevice import serve_mesh_many
    mesh = request.param
    jobs = _jobs(reference)
    names = ([f"{ARCHS[0]}@{r}" for r in reference[ARCHS[0]]["want"]]
             + [f"{ARCHS[0]}:drop"]
             + [f"{ARCHS[1]}@{r}" for r in reference[ARCHS[1]]["want"]]
             + [f"{ARCHS[1]}:drop", "layout:md", "layout:m",
                "layout:none"])
    assert len(names) == len(jobs)
    ranks = spawn(serve_mesh_many, mesh[0] * mesh[1], [(mesh, jobs)],
                  timeout=60, join_timeout=300)
    return mesh, [dict(zip(names, r)) for r, in ranks]


def _check_serving(served, reference, arch):
    _, ranks = served
    for name, want in ((f"{arch}@{r}", w)
                       for r, w in reference[arch]["want"].items()):
        for r, res in enumerate(ranks):
            run, = res[name]["runs"]
            for mode in ("gather", "sp"):
                got = run["modes"][mode]["logits"]
                assert got.shape == want.shape
                err = float(np.max(np.abs(got - want)))
                assert err < 1e-4, (name, r, mode, err)


def test_deepseek_serving_matches_jax(served, reference):
    _check_serving(served, reference, ARCHS[0])


def test_kimi_serving_matches_jax(served, reference):
    _check_serving(served, reference, ARCHS[1])


def test_sp_equals_gather(served, reference):
    _, ranks = served
    for res in ranks:
        for name in (f"{a}@{r}" for a in ARCHS for r in reference[a]["want"]):
            run, = res[name]["runs"]
            assert run["sp_vs_gather"] < 1e-5, (name, run["sp_vs_gather"])


@pytest.mark.parametrize("arch", ARCHS)
def test_drop_case_drops_the_one_device_pairs(served, reference, arch):
    """The mesh prefill of B=4 x 160 at capacity factor 0.5: logits at
    every position against the JAX teacher-forced forward, and every
    rank's experts and kept pairs the one-device port's on its rows."""
    mesh, ranks = served
    ref = reference[arch]
    whole = ref["drop_routes"]
    n_moe = len(whole)
    dropped = sum(int((~keep).sum()) for _, keep, _ in whole)
    assert dropped >= 256 * n_moe, dropped
    rows = B * DROP_T // mesh[0]
    for r, res in enumerate(ranks):
        run, = res[f"{arch}:drop"]["runs"]
        err = float(np.max(np.abs(run["prefill_logits"] - ref["drop_want"])))
        assert err < 1e-4, (r, err)
        got = run["routes"]
        assert len(got) == n_moe
        block = slice(r // mesh[1] * rows, (r // mesh[1] + 1) * rows)
        for (idx, keep, _), (widx, wkeep, _) in zip(got, whole):
            np.testing.assert_array_equal(idx, widx[block])
            np.testing.assert_array_equal(keep, wkeep[block])


def test_buffer_layouts_agree(served, reference):
    _, ranks = served
    for res in ranks:
        md = res["layout:md"]["runs"][0]["modes"]["gather"]["logits"]
        for layout in ("m", "none"):
            got = res[f"layout:{layout}"]["runs"][0]["modes"]["gather"][
                "logits"]
            err = float(np.max(np.abs(got - md)))
            assert err < 1e-5, (layout, err)


def test_local_shapes_are_shard_shapes(served, reference):
    mesh, ranks = served
    for r, res in enumerate(ranks):
        for name, out in res.items():
            for what, key, local, expect in out["shapes"]:
                assert tuple(local) == tuple(expect), (r, name, what, key)
        shapes = {s[1]: s[2] for s in res[f"{ARCHS[0]}@64"]["shapes"]}
        E, d, ff = 8, 64, 64
        assert shapes["blocks.0.moe.wg"] == (E // mesh[1], d, ff // mesh[0])
        assert shapes["blocks.0.moe.wd"] == (E // mesh[1], ff // mesh[0], d)
        assert shapes["0.ckv"] == (B // mesh[0], 64 // mesh[1], 32)
        latent = {s[1]: s[2] for s in res[f"{ARCHS[0]}@20"]["shapes"]}
        assert latent["0.ckv"] == (B // mesh[0], 20, 32 // mesh[1])
