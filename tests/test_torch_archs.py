"""The eight architectures of the LM substrate's last serving slice in the
port against the JAX package, at the reduced size in f32: granite-3-2b,
stablelm-12b, starcoder2-7b (dense GQA), internvl2-1b (vision front end),
musicgen-medium (audio front end), kimi-k2-1t-a32b (MoE, bf16 masters),
deepseek-v2-lite-16b (MoE with MLA) and xlstm-1.3b; and every config of
the ten.

Each JAX model is built once (``init(jax.random.key(1))``) and its
parameters carried across by ``interop.params_from_numpy``; batches come
from both packages' ``make_batch`` (the same numpy stream).  Logits and
losses are held to atol 1e-4.  The JAX model's causal paths are the
teacher-forced forward and ``decode_step``; its cached prefill is not
causal (ROADMAP C3, for GQA and MLA alike), so the port's prefill + decode
is held against the JAX teacher-forced forward, and one decode step from
the port's prefilled caches against JAX ``decode_step`` from the same
caches.  Vision positions count the patches (the prefill fills
``n_patches + T`` rows, ROADMAP C8); audio decode steps read given frames.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.interop import (caches_from_numpy,  # noqa: E402
                                 caches_to_numpy, params_from_numpy)
from repro_torch.models.registry import build_model  # noqa: E402

NEW = ["granite-3-2b", "stablelm-12b", "starcoder2-7b", "internvl2-1b",
       "musicgen-medium", "kimi-k2-1t-a32b", "deepseek-v2-lite-16b",
       "xlstm-1.3b"]
B, T, PROMPT = 2, 32, 16
ATOL = 1e-4


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v, np.int64 if v.dtype.kind == "i"
                                         else np.float32))
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=NEW)
def ref(request):
    """The JAX model of one arch, its params and a batch of T positions;
    the port's model with the same params; the JAX teacher-forced logits
    [B, T, V] and loss."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config
    from repro.data.synthetic import make_batch as jmake
    from repro.models.layers import embed, unembed
    from repro.models.registry import build_model as jbuild
    arch = request.param
    jcfg = get_config(arch, reduced=True)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(1))
    cfg = treg.get_config(arch, reduced=True)
    m = build_model(cfg, device="cpu")
    m.load_state_dict(params_from_numpy(jax.device_get(params), cfg))
    batch = jmake(jcfg, B, T, step=1)

    @jax.jit
    def forward_and_loss(params, batch):
        if cfg.family == "xlstm":
            x = embed(jcfg, params["embed"], batch["tokens"])
            h, _ = jm._run(params, x, [None] * jcfg.n_layers, False)
        else:
            x, _, _ = jm.embed_inputs(params, batch)
            h, _ = jm.backbone(params, x, jnp.arange(T)[None])
        return unembed(jcfg, params["embed"], h), jm.loss(params, batch)

    full, loss = forward_and_loss(params, batch)
    return dict(arch=arch, jcfg=jcfg, jm=jm, params=params, cfg=cfg, m=m,
                batch=batch, tb=_torch_batch(batch), full=np.asarray(full),
                loss=float(loss))


def _prompt(ref, n):
    """The batch's first ``n`` positions as a prompt (vision: the patches
    and the first ``n - n_patches`` tokens; audio: the first n frames)."""
    tb = ref["tb"]
    if "embeds" in tb:
        return {"embeds": tb["embeds"][:, :n], "labels": tb["labels"][:, :n]}
    P = tb["patch_embeds"].shape[1] if "patch_embeds" in tb else 0
    return {**tb, "tokens": tb["tokens"][:, :n - P]}


def _step_input(ref, pos):
    """What a decode step at position ``pos`` reads: the token there, or
    the frame embedding [B, 1, d] under the audio front end."""
    tb = ref["tb"]
    if "embeds" in tb:
        return tb["embeds"][:, pos:pos + 1]
    P = tb["patch_embeds"].shape[1] if "patch_embeds" in tb else 0
    return tb["tokens"][:, pos - P:pos - P + 1]


# -- configs -----------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", list(treg.ARCHS))
def test_config_is_the_jax_config(arch, reduced):
    from repro.configs.registry import get_config
    got = treg.get_config(arch, reduced=reduced)
    want = get_config(arch, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.param_count(), got.active_param_count()) == \
        (want.hd, want.param_count(), want.active_param_count())


@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-1b",
                                  "musicgen-medium"])
def test_make_batch_and_batch_spec_are_the_jax_packages(arch):
    """Token, patch and frame batches: the same values from the same numpy
    stream, and the same shapes as ``batch_spec`` (int64 for int32)."""
    from repro.configs.registry import get_config
    from repro.data.synthetic import batch_spec as jspec
    from repro.data.synthetic import make_batch as jmake
    from repro_torch.data.synthetic import batch_spec, make_batch
    cfg = treg.get_config(arch, reduced=True)
    got = make_batch(cfg, B, T, step=2, seed=1, device="cpu")
    want = jmake(get_config(arch, reduced=True), B, T, step=2, seed=1)
    spec, jsp = batch_spec(cfg, B, T), jspec(get_config(arch, True), B, T)
    assert sorted(got) == sorted(want) == sorted(spec) == sorted(jsp)
    for k, v in got.items():
        assert tuple(v.shape) == spec[k][0] == jsp[k].shape
        assert v.dtype == spec[k][1]
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))


# -- the eight against JAX -----------------------------------------------------------

def test_forward_matches_jax(ref):
    got = ref["m"](ref["tb"] if ref["cfg"].family != "xlstm"
                   else ref["tb"]["tokens"])
    assert got.dtype == torch.float32 and got.shape == ref["full"].shape
    np.testing.assert_allclose(got.numpy(), ref["full"], atol=ATOL)


def test_loss_matches_jax(ref):
    assert abs(float(ref["m"].loss(ref["tb"])) - ref["loss"]) <= ATOL


def test_prefill_then_decode_is_the_teacher_forced_forward(ref):
    """Prefill the first PROMPT positions, then decode the rest one
    position a step on the batch's own inputs: each step's logits are the
    JAX forward's at that position."""
    m = ref["m"]
    caches = m.init_cache(B, T)
    logits, caches = m.prefill(_prompt(ref, PROMPT), caches)
    steps = [logits[:, 0]]
    for pos in range(PROMPT, T):
        lg, caches = m.decode_step(_step_input(ref, pos), caches, pos)
        steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               ref["full"][:, PROMPT - 1:], atol=ATOL)


def test_decode_step_matches_jax_decode_step(ref):
    """One decode step at T=1 from the port's prefilled caches, carried to
    JAX and back: logits and the caches after the step agree."""
    import jax.numpy as jnp
    m, cfg = ref["m"], ref["cfg"]
    caches = m.init_cache(B, T)
    m.prefill(_prompt(ref, PROMPT), caches)
    jc = _jax_tree(caches_to_numpy(caches, cfg))
    inp = _step_input(ref, PROMPT)
    jinp = jnp.asarray(inp.numpy())
    jl, jc = ref["jm"].decode_step(ref["params"], jinp, jc, jnp.int32(PROMPT))
    lg, caches = m.decode_step(inp, caches, PROMPT)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=ATOL)
    back = caches_from_numpy(_np_tree(jc), cfg, device="cpu")
    for got, want in zip(_leaves(caches), _leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def _jax_tree(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for t in tree for x in _leaves(t)]


def test_parameters_are_the_jax_tree(ref):
    """Every JAX leaf has its entry, shape and dtype in the port (kimi's
    bf16 masters bit for bit), and nothing more."""
    import jax
    host = jax.device_get(ref["params"])
    sd = params_from_numpy(host, ref["cfg"])
    got = ref["m"].state_dict()
    assert sorted(sd) == sorted(got)
    for k, v in got.items():
        assert v.shape == sd[k].shape and v.dtype == sd[k].dtype, k
        assert torch.equal(v, sd[k]), k
    assert sum(np.size(x) for x in jax.tree.leaves(host)) == \
        sum(p.numel() for p in ref["m"].parameters())
