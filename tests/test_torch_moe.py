"""The port's MoE dispatch and MLA attention (``repro_torch/models/moe.py``)
against the JAX package's (``repro/models/moe.py``), at the reduced
deepseek-v2-lite config in f32, mirroring ``tests/test_moe_mla.py``.

The JAX layers' parameters (``init_moe`` / ``init_mla`` with a fixed key)
are carried across leaf by leaf; inputs are drawn with numpy.  Routing (the
top-k experts of each token) and the capacity drops must be equal; outputs
are held to atol 1e-5 against JAX's ``moe_ffn`` and 2e-4 against the dense
no-capacity reference (the JAX test's tolerance).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCH = "deepseek-v2-lite-16b"


def _cfg(**kw):
    return dataclasses.replace(treg.get_config(ARCH, reduced=True), **kw)


def _jax_layer(init, cfg, seed):
    """(JAX params, the same as CPU tensors) of a JAX layer init."""
    import jax
    from repro.configs.registry import get_config
    jcfg = dataclasses.replace(get_config(ARCH, reduced=True),
                               **{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
    p = init(jcfg, jax.random.key(seed))
    host = jax.device_get(p)
    return jcfg, p, jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                 host)


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jax_routing(jcfg, p, x):
    """JAX's top-k experts [Tt, k] and keep mask, in its sorted order, by
    its own functions."""
    import math

    import jax
    import jax.numpy as jnp
    from repro.models.moe import _group_ranks
    xf = jnp.asarray(x).reshape(-1, jcfg.d_model)
    Tt, k, E = xf.shape[0], jcfg.experts_per_token, jcfg.n_experts
    cap = max(128, int(math.ceil(jcfg.capacity_factor * Tt * k / E / 128))
              * 128)

    @jax.jit
    def routing(xf, router):
        logits = (xf @ router).astype(jnp.float32)
        _, idx = jax.lax.top_k(logits, k)
        order, _, rank = _group_ranks(idx.reshape(-1).astype(jnp.int32), E)
        return idx, order, rank < cap
    return (*map(np.asarray, routing(xf, p["router"])), cap)


@pytest.fixture(scope="module")
def jax_moe():
    from repro.models.moe import init_moe
    return _jax_layer(init_moe, _cfg(), 0)


@pytest.mark.parametrize("factor,tokens", [(1.25, (2, 16)), (0.01, (4, 160)),
                                          (0.01, (8, 128))])
def test_moe_ffn_matches_jax_with_its_routing_and_drops(jax_moe, factor,
                                                         tokens):
    """At the config's capacity factor nothing drops; at 0.01 the capacity
    is its floor of 128 slots, which the 4 x 160 and 8 x 128 batches (160
    and 256 pairs an expert on average) overflow (the JAX test's "tiny
    capacity")."""
    import jax
    import jax.numpy as jnp
    from repro.models.moe import moe_ffn
    cfg = _cfg(capacity_factor=factor)
    jcfg, p, tp = jax_moe
    jcfg = dataclasses.replace(jcfg, capacity_factor=factor)
    x = _x(tokens + (cfg.d_model,), 1)
    want = np.asarray(jax.jit(moe_ffn, static_argnums=0)(jcfg, p,
                                                         jnp.asarray(x)))
    got = moe.moe_ffn(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    idx, order, keep, cap = _jax_routing(jcfg, p, x)
    r = moe.route(cfg, tp, torch.from_numpy(x).reshape(-1, cfg.d_model))
    assert r["cap"] == cap
    np.testing.assert_array_equal(r["idx"].numpy(), idx)
    np.testing.assert_array_equal(r["order"].numpy(), order)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    assert bool(r["keep"].all()) == (factor > 1)


def _dense_reference(cfg, p, x):
    """Every token to its true top-k experts, no capacity (the JAX test's
    ``_dense_moe_reference``, in torch)."""
    import torch.nn.functional as F
    xf = x.reshape(-1, cfg.d_model)
    gate, idx = moe.top_k(xf @ p["router"], cfg.experts_per_token)
    gate = torch.softmax(gate, dim=-1)
    y = torch.zeros_like(xf)
    for e in range(cfg.n_experts):
        w = torch.where(idx == e, gate, 0.0).sum(-1)[:, None]
        h = F.silu(xf @ p["wg"][e]) * (xf @ p["wu"][e])
        y = y + w * (h @ p["wd"][e])
    sp = p["shared"]
    y = y + (F.silu(xf @ sp["wg"]) * (xf @ sp["wu"])) @ sp["wd"]
    return y.reshape(x.shape)


def test_moe_matches_dense_reference_when_capacity_suffices():
    cfg = _cfg(capacity_factor=8.0)
    tp = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(_x((2, 16, cfg.d_model), 1))
    np.testing.assert_allclose(moe.moe_ffn(cfg, tp, x).numpy(),
                               _dense_reference(cfg, tp, x).numpy(),
                               atol=2e-4)


def test_tied_router_logits_resolve_as_jax_top_k():
    """Logits with ties (whole columns equal, and rows of one value): the
    lower expert index comes first, as in ``jax.lax.top_k``."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    logits = rng.integers(-2, 3, (64, 8)).astype(np.float32)
    logits[:, 5] = logits[:, 1]
    logits[7] = 1.0
    for k in (1, 2, 6):
        vals, idx = moe.top_k(torch.from_numpy(logits), k)
        jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    # and through the router: identical router columns tie every token.
    cfg = _cfg()
    tp = moe.init_moe(cfg, torch.Generator().manual_seed(1))
    tp["router"][:, 3] = tp["router"][:, 0]
    tp["router"][:, 6] = tp["router"][:, 0]
    xf = torch.from_numpy(_x((40, cfg.d_model), 2))
    _, ji = jax.lax.top_k(jnp.asarray((xf @ tp["router"]).numpy()),
                          cfg.experts_per_token)
    np.testing.assert_array_equal(moe.route(cfg, tp, xf)["idx"].numpy(),
                                  np.asarray(ji))


def test_two_runs_are_bit_equal():
    cfg = _cfg(capacity_factor=0.01)
    tp = moe.init_moe(cfg, torch.Generator().manual_seed(2))
    x = torch.from_numpy(_x((2, 96, cfg.d_model), 4))
    assert torch.equal(moe.moe_ffn(cfg, tp, x), moe.moe_ffn(cfg, tp, x))


def test_moe_conserves_tokens_under_permutation():
    cfg = _cfg(capacity_factor=8.0)
    tp = moe.init_moe(cfg, torch.Generator().manual_seed(4))
    x = torch.from_numpy(_x((1, 12, cfg.d_model), 5, 1.0))
    perm = torch.from_numpy(np.random.default_rng(0).permutation(12))
    np.testing.assert_allclose(moe.moe_ffn(cfg, tp, x)[:, perm].numpy(),
                               moe.moe_ffn(cfg, tp, x[:, perm]).numpy(),
                               atol=1e-5)


# -- MLA ---------------------------------------------------------------------------

B, T = 2, 10


@pytest.fixture(scope="module")
def mla():
    from repro.models.moe import init_mla
    cfg = _cfg()
    jcfg, p, tp = _jax_layer(init_mla, cfg, 2)
    x = _x((B, T, cfg.d_model), 3)
    return cfg, jcfg, p, tp, x


def _positions(n, start=0):
    return torch.arange(start, start + n)[None]


def test_mla_forward_matches_jax(mla):
    import jax.numpy as jnp
    from repro.models.moe import mla_attention
    cfg, jcfg, p, tp, x = mla
    want, _ = mla_attention(jcfg, p, jnp.asarray(x), jnp.arange(T)[None])
    got = moe.mla_attention(cfg, tp, torch.from_numpy(x), _positions(T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mla_absorbed_decode_equals_expanded_forward(mla):
    """A prefill of 4 positions, then absorbed decode steps one position at
    a time: every output is the expanded forward's; the cache rows past
    the position stay zero."""
    cfg, _, _, tp, x = mla
    xt = torch.from_numpy(x)
    full = moe.mla_attention(cfg, tp, xt, _positions(T))
    cache = {"ckv": torch.zeros((B, T + 2, cfg.kv_lora_rank)),
             "kr": torch.zeros((B, T + 2, cfg.rope_head_dim))}
    outs = [moe.mla_attention(cfg, tp, xt[:, :4], _positions(4), cache, 0)]
    for i in range(4, T):
        outs.append(moe.mla_attention(cfg, tp, xt[:, i:i + 1],
                                      _positions(1, i), cache,
                                      torch.tensor(i), decode=True))
        assert not cache["ckv"][:, i + 1:].any()
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=1e-5)


def test_mla_decode_step_matches_jax(mla):
    import jax.numpy as jnp
    from repro.models.moe import mla_attention
    cfg, jcfg, p, tp, x = mla
    cache = {"ckv": torch.zeros((B, T, cfg.kv_lora_rank)),
             "kr": torch.zeros((B, T, cfg.rope_head_dim))}
    moe.mla_attention(cfg, tp, torch.from_numpy(x[:, :6]), _positions(6),
                      cache, 0)
    jc = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    want, jc = mla_attention(jcfg, p, jnp.asarray(x[:, 6:7]),
                             jnp.asarray([[6]]), jc, jnp.int32(6))
    got = moe.mla_attention(cfg, tp, torch.from_numpy(x[:, 6:7]),
                            _positions(1, 6), cache, 6, decode=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for k in ("ckv", "kr"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-6)


def test_jax_mla_prefill_is_not_causal_but_the_port_is(mla):
    """ROADMAP C3, extended to MLA: the JAX layer with a cache takes the
    absorbed form masked by length only, so a prompt position sees later
    ones.  If this fails on the JAX side, the reference was fixed and the
    port's note on C3 is stale."""
    import jax.numpy as jnp
    from repro.models.moe import mla_attention
    cfg, jcfg, p, tp, x = mla
    full, _ = mla_attention(jcfg, p, jnp.asarray(x), jnp.arange(T)[None])
    jc = {"ckv": jnp.zeros((B, T, cfg.kv_lora_rank)),
          "kr": jnp.zeros((B, T, cfg.rope_head_dim))}
    cached, _ = mla_attention(jcfg, p, jnp.asarray(x), jnp.arange(T)[None],
                              jc, jnp.int32(0))
    assert np.abs(np.asarray(cached) - np.asarray(full))[:, :-1].max() > 1e-2
    cache = {"ckv": torch.zeros((B, T, cfg.kv_lora_rank)),
             "kr": torch.zeros((B, T, cfg.rope_head_dim))}
    got = moe.mla_attention(cfg, tp, torch.from_numpy(x), _positions(T),
                            cache, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(full), atol=1e-5)


def test_mla_decode_takes_one_token():
    cfg = _cfg()
    tp = moe.init_mla(cfg, torch.Generator().manual_seed(0))
    cache = {"ckv": torch.zeros((1, 4, cfg.kv_lora_rank)),
             "kr": torch.zeros((1, 4, cfg.rope_head_dim))}
    with pytest.raises(ValueError, match="one token"):
        moe.mla_attention(cfg, tp, torch.zeros((1, 2, cfg.d_model)),
                          _positions(2), cache, 0, decode=True)


def test_first_dense_layers_keep_the_mlp():
    """``first_dense_layers`` blocks run the MLP of d_ff, as
    ``param_count`` counts them (the JAX blocks ignore it, ROADMAP C9)."""
    from repro_torch.models.transformer import DecoderLM
    cfg = _cfg(first_dense_layers=1)
    m = DecoderLM(cfg, device="cpu")
    assert "mlp" in m.weights()["blocks"][0]
    assert "moe" in m.weights()["blocks"][1]
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    assert sum(p.numel() for p in m.parameters()) == cfg.param_count() + norms
    assert torch.isfinite(m(torch.zeros((1, 8), dtype=torch.long))).all()
