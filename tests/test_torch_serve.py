"""zamba2 serving in the port against the JAX package, at the reduced size.

The JAX model's parameters (``Zamba.init(jax.random.key(2))``) are carried
across by ``interop.params_from_numpy``; prompts come from both
packages' ``make_batch`` (the same numpy stream).  All in f32, atol 1e-4.

The JAX model has two causal paths, the teacher-forced forward (``_run``
without caches) and stepwise ``decode_step``; its cached ``prefill`` is not
causal (ROADMAP C3).  So the port's prefill is held against the first two,
and against JAX ``Zamba.prefill`` only at T=1, where the masks coincide.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.zamba import Zamba  # noqa: E402
from repro_torch.serve.engine import ServeSession  # noqa: E402

ARCH = "zamba2-1.2b"
B, T, MAX_LEN, STEPS = 2, 32, 48, 8
ATOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its params and prompts; the port's model with the
    same params; the JAX teacher-forced logits of the prompts."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config
    from repro.data.synthetic import make_batch as jmake
    from repro.models.layers import embed, unembed
    from repro.models.registry import build_model

    jcfg = get_config(ARCH, reduced=True)
    jm = build_model(jcfg)
    params = jm.init(jax.random.key(2))
    model = Zamba(treg.get_config(ARCH, reduced=True), device="cpu")
    model.load_state_dict(params_from_numpy(jax.device_get(params), jcfg))
    toks = jmake(jcfg, B, T, step=2)["tokens"]
    x = embed(jcfg, params["embed"], toks)
    h, _, _ = jm._run(params, x, jnp.arange(T)[None], None, None, None, False)
    full = np.asarray(unembed(jcfg, params["embed"], h))
    return dict(jm=jm, params=params, toks=toks, model=model, full=full,
                ttoks=torch.from_numpy(np.array(toks)).long(),
                decode=jax.jit(jm.decode_step))


def _jax_caches(c):
    """A copy of the port's caches as JAX arrays (a copy: the port updates
    its caches in place, and a JAX array may share a numpy buffer)."""
    import jax.numpy as jnp
    return {part: [{k: jnp.asarray(v.numpy().copy()) for k, v in d.items()}
                   for d in c[part]] for part in ("mamba", "attn")}


def test_forward_matches_jax_teacher_forced(ref):
    got = ref["model"](ref["ttoks"])
    assert got.dtype == torch.float32 and got.shape == ref["full"].shape
    np.testing.assert_allclose(got.numpy(), ref["full"], atol=ATOL)


def test_prefill_is_the_teacher_forced_last_position(ref):
    m = ref["model"]
    logits, _ = m.prefill(ref["ttoks"], m.init_cache(B, MAX_LEN))
    assert logits.shape == (B, 1, m.cfg.vocab_size)
    np.testing.assert_allclose(logits[:, 0].numpy(), ref["full"][:, -1],
                               atol=ATOL)


def test_prefill_caches_match_stepwise_jax_decode(ref):
    import jax.numpy as jnp
    m = ref["model"]
    _, caches = m.prefill(ref["ttoks"], m.init_cache(B, MAX_LEN))
    jc = ref["jm"].init_cache(B, MAX_LEN, jnp.float32)
    for i in range(T):
        _, jc = ref["decode"](ref["params"], ref["toks"][:, i:i + 1], jc,
                              jnp.int32(i))
    assert len(caches["attn"]) == len(jc["attn"]) == 2
    for got, want in zip(caches["attn"], jc["attn"]):
        for k in ("k", "v"):
            np.testing.assert_allclose(got[k][:, :T].numpy(),
                                       np.asarray(want[k])[:, :T], atol=ATOL)
            assert not got[k][:, T:].any()
    for got, want in zip(caches["mamba"], jc["mamba"]):
        assert got["h"].dtype == torch.float32
        for k in ("conv", "h"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=ATOL)


def test_prefill_of_one_token_matches_jax_prefill(ref):
    import jax.numpy as jnp
    m = ref["model"]
    logits, _ = m.prefill(ref["ttoks"][:, :1], m.init_cache(B, MAX_LEN))
    jl, _ = ref["jm"].prefill(ref["params"], {"tokens": ref["toks"][:, :1]},
                              ref["jm"].init_cache(B, MAX_LEN, jnp.float32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL)


def test_greedy_tokens_match_jax_decode_loop(ref):
    import jax.numpy as jnp
    m = ref["model"]
    sess = ServeSession(m, B, MAX_LEN, device="cpu")
    first = sess.prefill({"tokens": ref["ttoks"]})
    jc = _jax_caches(sess.caches)  # the same caches, before decoding
    out = sess.decode(first, STEPS)
    assert out.shape == (B, STEPS) and sess.cur_len == T + STEPS
    assert len(sess.logits) == STEPS + 1
    toks = jnp.asarray(first.numpy(), jnp.int32)[:, None]
    want = []
    for i in range(STEPS):
        jl, jc = ref["decode"](ref["params"], toks, jc, jnp.int32(T + i))
        np.testing.assert_allclose(sess.logits[i + 1].numpy(),
                                   np.asarray(jl)[:, -1], atol=ATOL)
        toks = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        want.append(np.asarray(toks[:, 0]))
    np.testing.assert_array_equal(out.numpy(), np.stack(want, axis=1))


def test_decode_equals_teacher_forced_logits(ref):
    """Stepwise decode from an empty cache, in the port alone."""
    m = ref["model"]
    caches = m.init_cache(B, T)
    steps = []
    for i in range(T):
        lg, caches = m.decode_step(ref["ttoks"][:, i:i + 1], caches, i)
        steps.append(lg[:, 0].numpy())
    np.testing.assert_allclose(np.stack(steps, axis=1), ref["full"],
                               atol=ATOL)


def test_jax_prefill_is_not_causal_but_the_port_is(ref):
    """ROADMAP C3: if this fails on the JAX side, the reference was fixed
    and the port's note on C3 is stale."""
    import jax.numpy as jnp
    jl, _ = ref["jm"].prefill(ref["params"], {"tokens": ref["toks"]},
                              ref["jm"].init_cache(B, MAX_LEN, jnp.float32))
    assert np.abs(np.asarray(jl)[:, 0] - ref["full"][:, -1]).max() > 0.1
    m = ref["model"]
    logits, _ = m.prefill(ref["ttoks"], m.init_cache(B, MAX_LEN))
    assert np.abs(logits[:, 0].numpy() - ref["full"][:, -1]).max() < ATOL


def test_parameters_are_the_jax_tree():
    import jax
    from repro.configs.registry import get_config
    from repro.models.registry import build_model
    jm = build_model(get_config(ARCH, reduced=True))
    tree = jax.device_get(jm.init(jax.random.key(0)))
    sd = params_from_numpy(tree, get_config(ARCH, reduced=True))
    model = Zamba(treg.get_config(ARCH, reduced=True), device="cpu", seed=3)
    assert sorted(sd) == sorted(model.state_dict())
    for k, v in model.state_dict().items():
        assert v.shape == sd[k].shape and v.dtype == sd[k].dtype, k
    n_jax = sum(np.size(x) for x in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_seeded_init_is_deterministic():
    cfg = treg.get_config(ARCH, reduced=True)
    a = Zamba(cfg, device="cpu", seed=1).state_dict()
    b = Zamba(cfg, device="cpu", seed=1).state_dict()
    c = Zamba(cfg, device="cpu", seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.win"], c["blocks.0.win"])


def test_compute_weights_follow_the_jax_casts():
    cfg = dataclasses.replace(treg.get_config(ARCH, reduced=True),
                              dtype="bfloat16")
    w = Zamba(cfg, device="cpu").weights()
    assert w["blocks"][0]["win"].dtype == torch.bfloat16
    assert w["blocks"][0]["dskip"].dtype == torch.bfloat16
    assert w["embed"]["tok"].dtype == torch.bfloat16
    for f32 in (w["blocks"][0]["a_log"], w["blocks"][0]["dt_bias"],
                w["blocks"][0]["ln"]["scale"], w["final_norm"]["scale"]):
        assert f32.dtype == torch.float32


def test_bf16_session_runs_with_f32_state():
    cfg = dataclasses.replace(treg.get_config(ARCH, reduced=True),
                              dtype="bfloat16")
    m = Zamba(cfg, device="cpu")
    sess = ServeSession(m, B, 24, device="cpu")
    first = sess.prefill(make_batch(cfg, B, 16, device="cpu"))
    out = sess.decode(first, 4)
    assert out.shape == (B, 4)
    assert sess.caches["mamba"][0]["h"].dtype == torch.float32
    assert sess.caches["attn"][0]["k"].dtype == torch.bfloat16
    assert all(torch.isfinite(lg).all() for lg in sess.logits)


def test_session_refuses_overlong_requests():
    m = Zamba(treg.get_config(ARCH, reduced=True), device="cpu")
    sess = ServeSession(m, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        sess.prefill({"tokens": torch.zeros((1, 9), dtype=torch.long)})
    first = sess.prefill({"tokens": torch.zeros((1, 6), dtype=torch.long)})
    with pytest.raises(ValueError, match="exceed"):
        sess.decode(first, 3)


def test_softplus_is_jax_softplus():
    import jax
    import jax.numpy as jnp
    from repro_torch.models.mamba2 import softplus
    x = np.array([-100, -30, -1, 0, 0.5, 19, 20, 21, 30, 100], np.float32)
    np.testing.assert_allclose(softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-37)  # XLA flushes denormals


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norm_is_jax_norm(kind):
    import jax.numpy as jnp
    from repro.models.layers import norm as jnorm
    from repro_torch.models.layers import norm
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    p = {"scale": rng.random(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    got = norm({k: torch.from_numpy(v) for k, v in p.items()},
               torch.from_numpy(x), kind, 1e-5)
    want = jnorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                 kind, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_ssd_final_state_matches_jax():
    import jax.numpy as jnp
    from repro.models.mamba2 import ssd_final_state as jfinal
    from repro_torch.models.mamba2 import ssd_final_state
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, 3, 8)).astype(np.float32)
    dt = rng.random((2, 20, 3)).astype(np.float32)
    A = -rng.random((3,)).astype(np.float32)
    Bm = rng.standard_normal((2, 20, 4)).astype(np.float32)
    got = ssd_final_state(*map(torch.from_numpy, (x, dt, A, Bm)))
    want = jfinal(*map(jnp.asarray, (x, dt, A, Bm)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_prefill_takes_the_state_from_the_scan(ref, monkeypatch):
    """The prefill's SSM state is the one ``ops.ssd`` carries out of the
    scan: with ``ssd_final_state`` made to raise, a prefill still runs and
    leaves the same caches and logits."""
    from repro_torch.models import mamba2
    m = ref["model"]
    want_logits, want = m.prefill(ref["ttoks"], m.init_cache(B, MAX_LEN))

    def boom(*args, **kwargs):
        raise AssertionError("prefill called ssd_final_state")
    monkeypatch.setattr(mamba2, "ssd_final_state", boom)
    logits, caches = m.prefill(ref["ttoks"], m.init_cache(B, MAX_LEN))
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    for got, exp in zip(caches["mamba"], want["mamba"]):
        torch.testing.assert_close(got["h"], exp["h"], rtol=0, atol=0)
        assert got["h"].abs().max() > 0


# -- configs, registry, data ------------------------------------------------------

def test_registry_names_are_the_jax_packages():
    from repro.configs.registry import ARCHS
    assert list(treg.ARCHS) == list(ARCHS)
    assert treg.all_archs() == list(ARCHS)


@pytest.mark.parametrize("reduced", [False, True])
def test_zamba_config_is_the_jax_config(reduced):
    from repro.configs.registry import get_config
    got = treg.get_config(ARCH, reduced=reduced)
    want = get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.hd, got.d_inner, got.ssm_heads, got.param_count()) == \
        (want.hd, want.d_inner, want.ssm_heads, want.param_count())


@pytest.mark.parametrize("arch", list(treg.ARCHS))
def test_every_arch_has_a_config(arch):
    cfg = treg.get_config(arch)
    assert cfg.name == arch and treg.get_config(arch, reduced=True).name == arch
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


@pytest.mark.parametrize("arch,cls", [
    ("deepseek-v2-lite-16b", "DecoderLM"), ("kimi-k2-1t-a32b", "DecoderLM"),
    ("xlstm-1.3b", "XLSTM"), ("zamba2-1.2b", "Zamba")])
def test_every_family_builds(arch, cls):
    from repro_torch.models.registry import build_model
    m = build_model(treg.get_config(arch, reduced=True), device="cpu")
    assert type(m).__name__ == cls and m.device == torch.device("cpu")
    bad = dataclasses.replace(m.cfg, family="no-such-family")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(bad, device="cpu")


def test_pallas_attention_names_its_slice(monkeypatch):
    """The slice that brings ``attn_impl="pallas"`` (ROADMAP B2) is in:
    ``sdpa`` hands q, k, v to ``ops.mha`` as [B, H, T, hd] and gets the
    plain attention's result back."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import sdpa
    cfg = treg.get_config(ARCH, reduced=True)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6, 4, 8))
                                .astype(np.float32)) for _ in range(3))
    seen = []
    real = ops.mha
    monkeypatch.setattr(ops, "mha", lambda *a, **kw: seen.append(
        (a[0].shape, kw)) or real(*a, **kw))
    got = sdpa(dataclasses.replace(cfg, attn_impl="pallas"), q, k, v)
    assert seen == [((1, 4, 6, 8), {"causal": True})]
    np.testing.assert_allclose(got.numpy(), sdpa(cfg, q, k, v).numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("step,seed", [(0, 0), (2, 0), (5, 3)])
def test_make_batch_is_the_jax_stream(step, seed):
    from repro.configs.registry import get_config
    from repro.data.synthetic import make_batch as jmake
    want = np.asarray(jmake(get_config(ARCH), 3, 17, step, seed)["tokens"])
    got = make_batch(treg.get_config(ARCH), 3, 17, step, seed,
                     device="cpu")["tokens"]
    np.testing.assert_array_equal(got.numpy(), want)


# -- entry points: the card by default ----------------------------------------------

def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import serve
    cfg = treg.get_config(ARCH, reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Zamba(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(cfg, 1, 4)
    m = Zamba(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeSession(m, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", ARCH, "--reduced"])


def test_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
                "8", "--tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill=" in out and "ms/token" in out and "tok/s" in out
    assert out.count("[serve] req") == 2


# -- on the card ----------------------------------------------------------------------

@pytest.mark.cuda
def test_reduced_session_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.ssd_scan import ssd_cuda
    # under "pallas" the prefill's SSD is the ssd_scan kernel on the card
    # (its plain version on the CPU), as the reference dispatches it.
    cfg = dataclasses.replace(treg.get_config(ARCH, reduced=True),
                              attn_impl="pallas")
    cpu = Zamba(cfg, device="cpu", seed=4)
    card = Zamba(cfg, device="cuda", seed=0)
    card.load_state_dict(cpu.state_dict())
    batch = make_batch(cfg, B, T, device="cpu")
    outs = []
    for m, dev in ((cpu, "cpu"), (card, "cuda")):
        before = ssd_cuda.launches
        sess = ServeSession(m, B, MAX_LEN, device=dev)
        first = sess.prefill(batch)
        if dev == "cuda":
            assert ssd_cuda.launches == before + cfg.n_layers
        toks = torch.cat([first[:, None], sess.decode(first, STEPS)], dim=1)
        outs.append((toks.cpu(), [lg.cpu() for lg in sess.logits]))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=ATOL)


def test_a_cuda_device_without_index_is_the_current_one(monkeypatch):
    """``device="cuda"`` must compare equal to where tensors land, or a
    session refuses a model made with the same default."""
    from repro_torch.core.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
