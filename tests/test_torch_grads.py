"""Gradients of the port's models against ``jax.value_and_grad`` of the JAX
package's, at the reduced size in f32: one config per family (granite
dense GQA, deepseek-v2-lite MoE with MLA, the zamba2 hybrid, xLSTM, the
internvl2 vision and musicgen audio front ends).

Each JAX model is built once (``init(jax.random.key(1))``) and its
parameters carried across by ``interop.params_from_numpy``, as are its
gradients; batches come from both packages' ``make_batch``.  The loss is
held to 1e-5 and every gradient leaf to 1e-4 of that leaf's largest |g|.
Then the port alone: the three ``remat`` policies give bit-equal
gradients, ``aux_load_balance_loss`` against the reference's, the kernels
refuse a gradient, and ``mamba_apply`` dispatches on ``attn_impl`` as the
reference does.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

FAMILIES = ["granite-3-2b", "deepseek-v2-lite-16b", "zamba2-1.2b",
            "xlstm-1.3b", "internvl2-1b", "musicgen-medium"]
B, T = 2, 32
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v, np.int64 if v.dtype.kind == "i"
                                         else np.float32))
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=FAMILIES)
def ref(request):
    """The JAX loss and gradients of one reduced config, and the port's
    model with the same parameters and the same batch."""
    import jax
    from repro.configs.registry import get_config
    from repro.data.synthetic import make_batch as jmake
    from repro.models.registry import build_model as jbuild
    arch = request.param
    jcfg = get_config(arch, reduced=True)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(1))
    batch = jmake(jcfg, B, T, step=1)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(params, batch)
    cfg = treg.get_config(arch, reduced=True)
    m = build_model(cfg, device="cpu")
    m.load_state_dict(params_from_numpy(jax.device_get(params), cfg))
    return dict(arch=arch, cfg=cfg, m=m, tb=_torch_batch(batch),
                loss=float(loss),
                grads=params_from_numpy(jax.device_get(grads), cfg))


def test_loss_and_every_gradient_match_jax(ref):
    m = ref["m"]
    loss = m.train_loss(ref["tb"])
    assert loss.requires_grad
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - ref["loss"]) <= LOSS_TOL
    # the evaluation loss is the same number and builds no graph.
    ev = m.loss(ref["tb"])
    assert not ev.requires_grad and float(ev) == float(loss)
    names = dict(m.named_parameters())
    assert names.keys() == ref["grads"].keys()
    for name, p in names.items():
        want = ref["grads"][name]
        got = (p.grad if p.grad is not None else torch.zeros_like(p))
        assert got.dtype == p.dtype, name
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= GRAD_TOL * max(scale, 1e-30), (name, err, scale)
        # a leaf the reference trains gets a gradient here too.
        assert (scale == 0) == (float(got.abs().max()) == 0), name
    m.zero_grad(set_to_none=True)


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v2-lite-16b"])
def test_remat_policies_give_bit_equal_gradients(arch):
    """``none``, ``full`` and ``dots`` differentiate the same function:
    equal gradients bit for bit.  In the backward, ``full`` recomputes the
    blocks' 2-D products, ``dots`` keeps them and recomputes the rest."""
    base = treg.get_config(arch, reduced=True)
    batch = make_batch(base, B, T, device="cpu")
    grads, ops_seen = {}, {}
    for policy in ("none", "full", "dots"):
        m = build_model(dataclasses.replace(base, remat=policy),
                        device="cpu", seed=3)
        loss = m.train_loss(batch)
        with _OpCount() as count:
            loss.backward()
        grads[policy] = {n: p.grad for n, p in m.named_parameters()}
        ops_seen[policy] = count.ops
    for policy in ("full", "dots"):
        for name, g in grads["none"].items():
            assert torch.equal(g, grads[policy][name]), (policy, name)
    mm = {p: c["aten.mm.default"] for p, c in ops_seen.items()}
    total = {p: sum(c.values()) for p, c in ops_seen.items()}
    assert mm["full"] > mm["none"] == mm["dots"]
    assert total["dots"] > total["none"]


def test_remat_refuses_an_unknown_policy():
    cfg = dataclasses.replace(treg.get_config("granite-3-2b", reduced=True),
                              remat="everything")
    m = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        m.train_loss(make_batch(cfg, B, T, device="cpu"))


def test_aux_load_balance_loss_matches_reference():
    import jax.numpy as jnp
    from repro.configs.registry import get_config
    from repro.models.moe import aux_load_balance_loss as jaux
    from repro_torch.models.moe import aux_load_balance_loss
    cfg = treg.get_config("deepseek-v2-lite-16b", reduced=True)
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((64, cfg.n_experts)).astype(np.float32)
    # ties: rows with two equal maxima go to the lower expert in both.
    logits[:8, 2] = logits[:8, 5] = logits[:8].max(axis=1) + 1.0
    want = float(jaux(get_config("deepseek-v2-lite-16b", reduced=True),
                      jnp.asarray(logits)))
    t = torch.from_numpy(logits).requires_grad_()
    got = aux_load_balance_loss(cfg, t)
    assert abs(float(got.detach()) - want) <= 1e-6
    got.backward()
    assert t.grad is not None and float(t.grad.abs().max()) > 0


def test_kernels_refuse_a_gradient_on_the_cpu():
    """``ops.mha`` and ``ops.ssd`` have no backward: asked for one they
    raise, here as on the card; under no_grad, or without an input that
    requires grad, they run."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 16, 16), generator=g)
    x = torch.randn((1, 16, 2, 8), generator=g)
    dt = torch.rand((1, 16, 2), generator=g)
    A = -torch.rand((2,), generator=g)
    Bm = torch.randn((1, 16, 4), generator=g)
    with pytest.raises(NotImplementedError, match="attn_impl"):
        ops.mha(q.requires_grad_(), q, q)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd(x, dt, A.requires_grad_(), Bm, Bm, chunk=8)
    with torch.no_grad():
        ops.mha(q, q, q)
        ops.ssd(x, dt, A, Bm, Bm, chunk=8)
    ops.mha(q.detach(), q.detach(), q.detach())
    for arch in ("llama3.2-3b", "zamba2-1.2b"):
        cfg = dataclasses.replace(treg.get_config(arch, reduced=True),
                                  attn_impl="pallas")
        m = build_model(cfg, device="cpu")
        batch = make_batch(cfg, B, T, device="cpu")
        with pytest.raises(NotImplementedError, match="no backward"):
            m.train_loss(batch)
        assert torch.isfinite(m.loss(batch))     # evaluation still runs


def test_mamba_dispatch_follows_attn_impl(monkeypatch):
    """As ``repro/models/mamba2.py:95``: the ssd_scan path (``ops.ssd``)
    only under ``attn_impl="pallas"``, the plain SSD (``ops.ssd_plain``)
    otherwise; the logits agree within 1e-4 (on the CPU "pallas" also
    swaps the attention for ``ops.mha``'s plain version)."""
    calls = collections.Counter()
    for name in ("ssd", "ssd_plain"):
        real = getattr(ops, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    base = treg.get_config("zamba2-1.2b", reduced=True)
    tokens = make_batch(base, B, T, device="cpu")["tokens"]
    logits = {}
    for impl in ("jnp", "pallas"):
        m = build_model(dataclasses.replace(base, attn_impl=impl),
                        device="cpu", seed=2)
        calls.clear()
        logits[impl] = m(tokens)
        want = {"ssd": base.n_layers} if impl == "pallas" else {
            "ssd_plain": base.n_layers}
        assert dict(calls) == want, impl
        calls.clear()
        m.prefill(tokens, m.init_cache(B, T))
        assert dict(calls) == want, impl
    torch.testing.assert_close(logits["jnp"], logits["pallas"], rtol=0,
                               atol=1e-4)
