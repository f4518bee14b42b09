"""Dense serving (llama3.2) in the port against the JAX package at the
reduced size, the masked decode attention both families share, a decode
step's device-side position, and the serving caches carried between the two
packages (``interop.caches_from_numpy`` / ``caches_to_numpy``).

The JAX model's parameters (``DecoderLM.init(jax.random.key(4))``, layers
stacked under ``scan_layers``) are carried across by
``interop.decoder_params_from_numpy``; prompts come from both packages'
``make_batch`` (the same numpy stream).  All in f32, atol 1e-4.

As for zamba2 (``tests/test_torch_serve.py``), the JAX model's causal paths
are the teacher-forced forward and stepwise ``decode_step``; its cached
``prefill`` is not causal (ROADMAP C3), so the port's prefill is held
against JAX ``prefill`` only at T=1.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.interop import (caches_from_numpy,  # noqa: E402
                                 caches_to_numpy, decoder_params_from_numpy)
from repro_torch.models.layers import attn_masked_decode  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.models.zamba import Zamba  # noqa: E402
from repro_torch.serve.engine import ServeSession  # noqa: E402

ARCH = "llama3.2-3b"
B, T, MAX_LEN, STEPS = 2, 24, 40, 8
ATOL = 1e-4


@pytest.fixture(scope="module")
def ref():
    """The JAX model, its params and prompts; the port's model with the
    same params (and one under ``attn_impl="pallas"``); the JAX
    teacher-forced logits of the prompts."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config
    from repro.data.synthetic import make_batch as jmake
    from repro.models.layers import unembed
    from repro.models.registry import build_model

    jcfg = get_config(ARCH, reduced=True)
    jm = build_model(jcfg)
    params = jm.init(jax.random.key(4))
    sd = decoder_params_from_numpy(jax.device_get(params), jcfg)
    models = {}
    for impl in ("jnp", "pallas"):
        m = DecoderLM(dataclasses.replace(treg.get_config(ARCH, reduced=True),
                                          attn_impl=impl), device="cpu")
        m.load_state_dict(sd)
        models[impl] = m
    toks = jmake(jcfg, B, T, step=2)["tokens"]
    x, _, _ = jm.embed_inputs(params, {"tokens": toks})
    h, _ = jm.backbone(params, x, jnp.arange(T)[None])
    full = np.asarray(unembed(jcfg, params["embed"], h))
    return dict(jm=jm, jcfg=jcfg, params=params, toks=toks, models=models,
                model=models["jnp"], full=full,
                ttoks=torch.from_numpy(np.array(toks)).long(),
                decode=jax.jit(jm.decode_step))


def _jax(tree):
    """numpy leaves → JAX arrays (copies: the port updates its caches in
    place, and a JAX array may share a numpy buffer)."""
    import jax
    import jax.numpy as jnp
    return jax.tree.map(lambda a: jnp.array(a, copy=True), tree)


def _jax_stepwise(ref, n):
    """The JAX caches after ``decode_step`` over the first n prompt
    tokens, and the last step's logits."""
    import jax.numpy as jnp
    jc = ref["jm"].init_cache(B, MAX_LEN, jnp.float32)
    for i in range(n):
        jl, jc = ref["decode"](ref["params"], ref["toks"][:, i:i + 1], jc,
                               jnp.int32(i))
    return jc, jl


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_prefill_is_the_teacher_forced_last_position(ref, impl):
    m = ref["models"][impl]
    logits, _ = m.prefill(ref["ttoks"], m.init_cache(B, MAX_LEN))
    assert logits.shape == (B, 1, m.cfg.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits[:, 0].numpy(), ref["full"][:, -1],
                               atol=ATOL)


def test_prefill_caches_match_stepwise_jax_decode(ref):
    m = ref["model"]
    _, caches = m.prefill(ref["ttoks"], m.init_cache(B, MAX_LEN))
    assert len(caches) == m.cfg.n_layers
    jc, _ = _jax_stepwise(ref, T)
    got = caches_to_numpy(caches, m.cfg)
    for k in ("k", "v"):
        assert got[k].shape == np.asarray(jc[k]).shape
        np.testing.assert_allclose(got[k][:, :, :T],
                                   np.asarray(jc[k])[:, :, :T], atol=ATOL)
        assert not got[k][:, :, T:].any()


def test_prefill_of_one_token_matches_jax_prefill(ref):
    import jax.numpy as jnp
    m = ref["model"]
    logits, caches = m.prefill(ref["ttoks"][:, :1], m.init_cache(B, MAX_LEN))
    jl, jc = ref["jm"].prefill(ref["params"], {"tokens": ref["toks"][:, :1]},
                               ref["jm"].init_cache(B, MAX_LEN, jnp.float32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL)
    got = caches_to_numpy(caches, m.cfg)
    for k in ("k", "v"):
        np.testing.assert_allclose(got[k], np.asarray(jc[k]), atol=ATOL)


def test_greedy_tokens_match_jax_decode_loop(ref):
    """A session's tokens and logits against a JAX ``decode_step`` loop
    that starts from the session's caches, carried across after the
    prefill."""
    import jax.numpy as jnp
    m = ref["model"]
    sess = ServeSession(m, B, MAX_LEN, device="cpu")
    first = sess.prefill({"tokens": ref["ttoks"]})
    jc = _jax(caches_to_numpy(sess.caches, m.cfg))
    out = sess.decode(first, STEPS)
    assert out.shape == (B, STEPS) and sess.length == T + STEPS
    assert int(sess.cur_len) == T + STEPS and len(sess.logits) == STEPS + 1
    toks = jnp.asarray(first.numpy(), jnp.int32)[:, None]
    want = []
    for i in range(STEPS):
        jl, jc = ref["decode"](ref["params"], toks, jc, jnp.int32(T + i))
        np.testing.assert_allclose(sess.logits[i + 1].numpy(),
                                   np.asarray(jl)[:, -1], atol=ATOL)
        toks = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
        want.append(np.asarray(toks[:, 0]))
    np.testing.assert_array_equal(out.numpy(), np.stack(want, axis=1))


def test_decode_continues_from_jax_caches(ref):
    """The other direction: the JAX caches after stepwise decoding of the
    prompt, carried into the port, decode on as the JAX model does."""
    import jax
    import jax.numpy as jnp
    m = ref["model"]
    jc, jl = _jax_stepwise(ref, T)
    caches = caches_from_numpy(jax.device_get(jc), m.cfg, device="cpu")
    tok = torch.from_numpy(np.array(jnp.argmax(jl[:, -1:], axis=-1))).long()
    got, _ = m.decode_step(tok, caches, torch.tensor(T))
    want, _ = ref["decode"](ref["params"], jnp.asarray(tok.numpy(), jnp.int32),
                            jc, jnp.int32(T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


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
    """ROADMAP C3 for the dense family: if this fails on the JAX side, the
    reference was fixed and the port's note on C3 is stale."""
    import jax.numpy as jnp
    jl, _ = ref["jm"].prefill(ref["params"], {"tokens": ref["toks"]},
                              ref["jm"].init_cache(B, MAX_LEN, jnp.float32))
    assert np.abs(np.asarray(jl)[:, 0] - ref["full"][:, -1]).max() > 0.05
    m = ref["model"]
    logits, _ = m.prefill(ref["ttoks"], m.init_cache(B, MAX_LEN))
    assert np.abs(logits[:, 0].numpy() - ref["full"][:, -1]).max() < ATOL


def test_pallas_runs_mha_in_prefill_and_not_in_decode(ref, monkeypatch):
    from repro_torch.kernels import ops
    calls = []
    real = ops.mha
    monkeypatch.setattr(ops, "mha", lambda *a, **kw: calls.append(
        tuple(a[0].shape)) or real(*a, **kw))
    m = ref["models"]["pallas"]
    sess = ServeSession(m, B, MAX_LEN, device="cpu")
    first = sess.prefill({"tokens": ref["ttoks"]})
    assert calls == [(B, 4, T, 16)] * m.cfg.n_layers
    sess.decode(first, 3)
    assert len(calls) == m.cfg.n_layers


def test_decode_takes_one_token_a_row(ref):
    m = ref["model"]
    with pytest.raises(ValueError, match="one token"):
        m.decode_step(ref["ttoks"][:, :2], m.init_cache(B, MAX_LEN), 0)


def test_dense_session_in_bf16_runs_with_bf16_caches():
    cfg = dataclasses.replace(treg.get_config(ARCH, reduced=True),
                              dtype="bfloat16")
    from repro_torch.data.synthetic import make_batch
    m = DecoderLM(cfg, device="cpu")
    sess = ServeSession(m, B, 20, device="cpu")
    out = sess.decode(sess.prefill(make_batch(cfg, B, 16, device="cpu")), 4)
    assert out.shape == (B, 4)
    assert sess.caches[0]["k"].dtype == torch.bfloat16
    assert all(lg.dtype == torch.float32 and torch.isfinite(lg).all()
               for lg in sess.logits)


def test_serve_cli_serves_llama_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
                "8", "--tokens", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=llama3.2-3b" in out and "prefill=" in out
    assert "steady=" in out and "eager steps=4" in out
    assert out.count("[serve] req") == 2


# -- the masked decode attention ------------------------------------------------

@pytest.mark.parametrize("S,valid,Tq", [(48, 1, 1), (48, 17, 1), (48, 48, 1),
                                        (2048, 1000, 1), (2048, 1500, 1),
                                        (2048, 2048, 1), (48, 30, 2)])
def test_masked_decode_matches_jax(S, valid, Tq):
    """Both chunkings of the reference: one chunk of S, and chunks of 1024
    where 1024 divides S; ``valid_len`` a 0-d tensor."""
    import jax.numpy as jnp
    from repro.models.layers import _attn_masked_decode
    rng = np.random.default_rng(S + valid)
    q = rng.standard_normal((2, Tq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = attn_masked_decode(*map(torch.from_numpy, (q, k, v)),
                             torch.tensor(valid))
    want = _attn_masked_decode(*map(jnp.asarray, (q, k, v)), jnp.int32(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_masked_decode_reads_no_row_past_the_length():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 1, 4, 16), (1, 32, 2, 16), (1, 32, 2, 16)))
    want = attn_masked_decode(q, k, v, torch.tensor(9))
    k[:, 9:], v[:, 9:] = 1e4, -3e4
    torch.testing.assert_close(attn_masked_decode(q, k, v, torch.tensor(9)),
                               want, rtol=0, atol=0)


# -- a decode step's position on the device; the caches across packages ---------

def _model(arch, dtype="float32"):
    cfg = dataclasses.replace(treg.get_config(arch, reduced=True), dtype=dtype)
    return (Zamba if cfg.family == "hybrid" else DecoderLM)(cfg, device="cpu",
                                                            seed=1)


def _leaves(caches):
    from repro_torch.core.graphs import leaves
    return leaves(caches if isinstance(caches, dict) else dict(enumerate(
        caches)))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", ARCH])
def test_decode_step_takes_a_device_cur_len(arch):
    """``cur_len`` as a 0-d tensor gives the host int's logits and caches,
    bit for bit."""
    import copy
    from repro_torch.data.synthetic import make_batch
    m = _model(arch)
    _, caches = m.prefill(make_batch(m.cfg, B, 12, device="cpu")["tokens"],
                          m.init_cache(B, 16))
    twin = copy.deepcopy(caches)
    tok = torch.tensor([[3], [5]])
    a, _ = m.decode_step(tok, caches, 12)
    b, _ = m.decode_step(tok, twin, torch.tensor(12))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for x, y in zip(_leaves(caches), _leaves(twin), strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", ARCH])
def test_interop_cache_round_trip(arch, dtype):
    """JAX caches (random values in the JAX model's layout: the dense
    ``scan_layers`` stack) → the port's (the layout and dtypes of its
    ``init_cache``: the compute dtype, ``h`` f32) → the JAX layout again,
    equal; in bf16 up to the rounding of the compute dtype."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config
    from repro.models.registry import build_model
    jm = build_model(get_config(arch, reduced=True))
    rng = np.random.default_rng(7)
    host = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(jm.init_cache(B, MAX_LEN, jnp.float32)))
    m = _model(arch, dtype)
    got = caches_from_numpy(host, m.cfg, device="cpu")
    for x, y in zip(_leaves(got), _leaves(m.init_cache(B, MAX_LEN)),
                    strict=True):
        assert x.shape == y.shape and x.dtype == y.dtype
    back = caches_to_numpy(got, m.cfg)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    rtol = 0 if dtype == "float32" else 2 ** -8
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=0)
