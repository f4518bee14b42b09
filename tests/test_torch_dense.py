"""The dense decoder (llama3.2-3b) in the port against the JAX package, at
the reduced size (f32, 2 layers, width 64), and the reduced zamba2's loss.

The JAX model's parameters (``DecoderLM.init(jax.random.key(4))``, layers
stacked along a leading axis under ``scan_layers``) are carried across by
``interop.decoder_params_from_numpy``; tokens come from both packages'
``make_batch`` (the same numpy stream).  Logits and losses are held to
atol 1e-4 under both ``attn_impl`` values: ``"jnp"`` (the chunked
attention) and ``"pallas"`` (JAX: the Pallas kernel in interpret mode; the
port on the CPU: ``ops.mha``'s plain version).  The JAX ``ops.mha`` takes
blocks of ``min(128, T)``, so T=64 and T=96 run one block and T=160 runs
its padding path (two blocks of 128, 96 rows and keys padded).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.interop import (decoder_params_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402

ARCH = "llama3.2-3b"
B = 2
ATOL = 1e-4
IMPLS = ["jnp", "pallas"]


@pytest.fixture(scope="module")
def jax_llama():
    import jax
    from repro.configs.registry import get_config
    from repro.models.registry import build_model as jbuild
    jcfg = get_config(ARCH, reduced=True)
    params = jbuild(jcfg).init(jax.random.key(4))
    return jcfg, params, jax.device_get(params)


def _port(cfg, host_params, impl):
    m = DecoderLM(dataclasses.replace(cfg, attn_impl=impl), device="cpu")
    m.load_state_dict(decoder_params_from_numpy(host_params, m.cfg))
    return m


@pytest.mark.parametrize("T", [64, 96, 160])
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_loss_match_jax(jax_llama, impl, T):
    import jax.numpy as jnp
    from repro.data.synthetic import make_batch as jmake
    from repro.models.layers import unembed
    from repro.models.registry import build_model as jbuild
    jcfg, params, host = jax_llama
    jcfg = dataclasses.replace(jcfg, attn_impl=impl)
    jm = jbuild(jcfg)
    batch = jmake(jcfg, B, T, step=1)
    x, _, _ = jm.embed_inputs(params, batch)
    h, _ = jm.backbone(params, x, jnp.arange(T)[None])
    want = np.asarray(unembed(jcfg, params["embed"], h))
    want_loss = float(jm.loss(params, batch))

    m = _port(treg.get_config(ARCH, reduced=True), host, impl)
    tokens = torch.from_numpy(np.array(batch["tokens"])).long()
    got = m(tokens)
    assert got.dtype == torch.float32 and got.shape == (B, T, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    loss = m.loss({"tokens": tokens})
    assert abs(float(loss) - want_loss) <= ATOL


@pytest.mark.parametrize("impl", IMPLS)
def test_zamba_loss_matches_jax(impl):
    import jax
    from repro.configs.registry import get_config
    from repro.data.synthetic import make_batch as jmake
    from repro.models.registry import build_model as jbuild
    from repro_torch.models.zamba import Zamba
    jcfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True),
                               attn_impl=impl)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(2))
    batch = jmake(jcfg, B, 40, step=3)
    m = Zamba(dataclasses.replace(treg.get_config("zamba2-1.2b", reduced=True),
                                  attn_impl=impl), device="cpu")
    m.load_state_dict(params_from_numpy(jax.device_get(params), jcfg))
    loss = m.loss({"tokens": torch.from_numpy(np.array(batch["tokens"]))
                   .long()})
    assert abs(float(loss) - float(jm.loss(params, batch))) <= ATOL


def test_pallas_forward_runs_mha_once_per_layer(jax_llama, monkeypatch):
    from repro_torch.kernels import ops
    calls = []
    real = ops.mha

    def spy(q, k, v, *, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "mha", spy)
    m = _port(treg.get_config(ARCH, reduced=True), jax_llama[2], "pallas")
    m.loss({"tokens": torch.zeros((B, 24), dtype=torch.long)})
    # [B, H, T, hd]: 4 query heads over 2 KV heads, one call per layer.
    assert calls == [((B, 4, 24, 16), (B, 2, 24, 16), True)] * 2


def test_parameters_are_the_unstacked_jax_tree(jax_llama):
    jcfg, _, host = jax_llama
    assert jcfg.scan_layers and host["blocks"]["attn"]["wq"].shape == (
        2, 64, 64)
    sd = decoder_params_from_numpy(host, jcfg)
    model = DecoderLM(treg.get_config(ARCH, reduced=True), device="cpu",
                      seed=3)
    assert sorted(sd) == sorted(model.state_dict())
    assert "embed.head" not in sd  # tied embeddings
    for k, v in model.state_dict().items():
        assert v.shape == sd[k].shape and v.dtype == sd[k].dtype, k
    np.testing.assert_array_equal(sd["blocks.1.mlp.wd"].numpy(),
                                  host["blocks"]["mlp"]["wd"][1])
    import jax
    n_jax = sum(np.size(x) for x in jax.tree.leaves(host))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_unstacked_layers_pass_through_without_scan():
    tree = {"embed": {"tok": np.ones((4, 2))},
            "blocks": [{"w": np.full(3, i)} for i in range(2)]}
    cfg = dataclasses.replace(treg.get_config(ARCH, reduced=True),
                              scan_layers=False)
    sd = decoder_params_from_numpy(tree, cfg)
    assert sorted(sd) == ["blocks.0.w", "blocks.1.w", "embed.tok"]
    assert sd["blocks.1.w"].tolist() == [1, 1, 1]


def test_seeded_init_is_deterministic():
    cfg = treg.get_config(ARCH, reduced=True)
    a = DecoderLM(cfg, device="cpu", seed=1).state_dict()
    b = DecoderLM(cfg, device="cpu", seed=1).state_dict()
    c = DecoderLM(cfg, device="cpu", seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.wq"], c["blocks.0.attn.wq"])


def test_compute_weights_follow_the_jax_casts():
    cfg = dataclasses.replace(treg.get_config(ARCH, reduced=True),
                              dtype="bfloat16")
    m = DecoderLM(cfg, device="cpu")
    w = m.weights()
    for t in (w["embed"]["tok"], w["blocks"][0]["attn"]["wq"],
              w["blocks"][1]["mlp"]["wg"]):
        assert t.dtype == torch.bfloat16
    for t in (w["blocks"][0]["ln1"]["scale"], w["final_norm"]["scale"]):
        assert t.dtype == torch.float32
    logits = m(make_batch(cfg, B, 16, device="cpu")["tokens"], w)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    # in f32 the compute weights are the masters themselves, not a copy.
    m32 = DecoderLM(treg.get_config(ARCH, reduced=True), device="cpu")
    assert m32.weights()["blocks"][0]["attn"]["wq"].data_ptr() == \
        m32.blocks[0].attn.wq.data_ptr()


def test_bf16_masters_are_the_compute_weights():
    """With ``param_dtype`` equal to the compute dtype (the bf16 masters
    that 12-16 B-parameter configs need on one card), ``weights()`` hands
    out the parameters themselves, no copy; norm scales stay as stored."""
    cfg = dataclasses.replace(treg.get_config(ARCH, reduced=True),
                              dtype="bfloat16", param_dtype="bfloat16")
    m = DecoderLM(cfg, device="cpu")
    w = m.weights()
    assert w["blocks"][0]["attn"]["wq"].data_ptr() == \
        m.blocks[0].attn.wq.data_ptr()
    assert w["embed"]["tok"].data_ptr() == m.embed.tok.data_ptr()
    assert w["final_norm"]["scale"].dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_mlp_is_jax_mlp(activation):
    import jax
    import jax.numpy as jnp
    from repro.models.layers import init_mlp as jinit
    from repro.models.layers import mlp as jmlp
    from repro_torch.models.layers import mlp
    cfg = dataclasses.replace(treg.get_config(ARCH, reduced=True),
                              activation=activation)
    p = jax.device_get(jinit(cfg, jax.random.key(0)))
    x = np.random.default_rng(0).standard_normal((2, 5, 64)).astype(
        np.float32)
    got = mlp(cfg, {k: torch.from_numpy(np.array(v)) for k, v in p.items()},
              torch.from_numpy(x))
    want = jmlp(cfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_loss_of_one_token_is_zero_as_in_jax():
    m = DecoderLM(treg.get_config(ARCH, reduced=True), device="cpu")
    assert float(m.loss({"tokens": torch.zeros((2, 1), dtype=torch.long)})) \
        == 0.0


# -- configs, registries, the other block kinds ------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_llama_config_is_the_jax_config(reduced):
    from repro.configs.registry import get_config
    got = treg.get_config(ARCH, reduced=reduced)
    want = get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.param_count()) == (want.hd, want.param_count())


def test_registry_builds_the_dense_decoder():
    m = build_model(treg.get_config(ARCH, reduced=True), device="cpu")
    assert isinstance(m, DecoderLM) and m.device == torch.device("cpu")
    cfg = m.cfg
    norms = (2 * cfg.n_layers + 1) * cfg.d_model  # not in param_count()
    assert sum(p.numel() for p in m.parameters()) == \
        cfg.param_count() + norms


@pytest.mark.parametrize("change,part", [
    (dict(family="moe", n_experts=4, experts_per_token=2, moe_d_ff=32),
     "blocks.0.moe.router"),
    (dict(use_mla=True, kv_lora_rank=16, rope_head_dim=8), "blocks.0.attn.wukv"),
    (dict(frontend="vision", n_patches=4), "patch_proj"),
    (dict(param_dtype="bfloat16"), "blocks.0.attn.wq"),
])
def test_decoder_builds_moe_mla_front_ends_and_bf16_masters(change, part):
    """What the dense slice refused builds and runs: its parameters are
    counted by ``param_count`` (plus norms, plus the vision projection),
    kept in ``param_dtype``, and the forward is finite."""
    cfg = dataclasses.replace(treg.get_config(ARCH, reduced=True), **change)
    m = DecoderLM(cfg, device="cpu")
    sd = m.state_dict()
    assert sd[part].dtype == getattr(torch, cfg.param_dtype)
    extra = (2 * cfg.n_layers + 1) * cfg.d_model + (
        cfg.d_model ** 2 if cfg.frontend else 0)
    assert sum(p.numel() for p in m.parameters()) == \
        cfg.param_count() + extra
    batch = make_batch(cfg, B, 12, device="cpu")
    assert torch.isfinite(m(batch)).all() and torch.isfinite(m.loss(batch))


@pytest.mark.cuda
def test_card_forward_runs_the_kernel_and_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import flash_cuda
    cfg = dataclasses.replace(treg.get_config(ARCH, reduced=True),
                              attn_impl="pallas")
    cpu = DecoderLM(cfg, device="cpu", seed=5)
    card = DecoderLM(cfg, device="cuda", seed=5)
    card.load_state_dict(cpu.state_dict())
    batch = make_batch(cfg, B, 96, step=2, device="cpu")
    before = flash_cuda.launches
    got = card(batch["tokens"].cuda())
    loss = card.loss({"tokens": batch["tokens"].cuda()})
    assert flash_cuda.launches == before + 2 * cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(),
                               cpu(batch["tokens"]).numpy(), atol=ATOL)
    assert abs(float(loss) - float(cpu.loss(batch))) <= ATOL
