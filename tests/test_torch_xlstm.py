"""The port's xLSTM (``repro_torch/models/xlstm.py``) against the JAX
package's (``repro/models/xlstm.py``): the mLSTM core in its chunkwise form
(``gated_chunk``, with a state in and out) and its one-step recurrence
(``gated_step``), the recurrence against the chunk form, and the whole
reduced model's loss and decode against its teacher-forced forward.  Inputs
are drawn with numpy; f32, atol 1e-5 on the core, 1e-4 on logits and loss.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402

ARCH = "xlstm-1.3b"
B, T, H, DK, DV = 2, 24, 2, 8, 12


def _core(seed, T=T):
    """q, k [B,T,H,DK], v [B,T,H,DV], logf <= 0, ig in (0, 1) [B,T,H] and
    a state [B,H,DK,DV], as numpy f32."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal
    return dict(q=f((B, T, H, DK)), k=f((B, T, H, DK)), v=f((B, T, H, DV)),
                logf=-np.log1p(np.exp(-f((B, T, H)) - 2.0)),
                ig=1.0 / (1.0 + np.exp(-f((B, T, H)))),
                state=f((B, H, DK, DV)) * 0.1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("chunk", [8, 24, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_gated_chunk_matches_jax(chunk, with_state):
    import jax.numpy as jnp
    from repro.models.xlstm import gated_chunk as jchunk
    a = _core(1)
    st = a["state"] if with_state else None
    want_y, want_s = jchunk(*(jnp.asarray(a[n], jnp.float32) for n in
                              ("q", "k", "v", "logf", "ig")), chunk=chunk,
                            state=None if st is None else jnp.asarray(
                                st, jnp.float32))
    y, s = xlstm.gated_chunk(*(_t(a[n]) for n in ("q", "k", "v", "logf",
                                                  "ig")), chunk=chunk,
                             state=None if st is None else _t(st))
    assert s.dtype == torch.float32 and s.shape == (B, H, DK, DV)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-5)


def test_gated_step_matches_jax():
    import jax.numpy as jnp
    from repro.models.xlstm import gated_step as jstep
    a = _core(2, T=1)
    scale = 1.0 / math.sqrt(DK)
    want_y, want_s = jstep(*(jnp.asarray(a[n], jnp.float32) for n in
                             ("q", "k", "v", "logf", "ig", "state")), scale)
    y, s = xlstm.gated_step(*(_t(a[n]) for n in ("q", "k", "v", "logf", "ig",
                                                 "state")), scale)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-5)


def test_step_recurrence_equals_the_chunk_form():
    """T steps of ``gated_step`` from a state give ``gated_chunk``'s
    outputs and final state."""
    a = {n: _t(v) for n, v in _core(3).items()}
    y, s = xlstm.gated_chunk(a["q"], a["k"], a["v"], a["logf"], a["ig"],
                             chunk=8, state=a["state"])
    st, ys = a["state"], []
    for t in range(T):
        yt, st = xlstm.gated_step(*(a[n][:, t:t + 1] for n in
                                    ("q", "k", "v", "logf", "ig")), st,
                                  1.0 / math.sqrt(DK))
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), s.numpy(), atol=1e-5)


def test_chunk_must_divide_t():
    a = {n: _t(v) for n, v in _core(4, T=20).items()}
    with pytest.raises(ValueError, match="multiple of the mLSTM chunk 8"):
        xlstm.gated_chunk(a["q"], a["k"], a["v"], a["logf"], a["ig"],
                          chunk=8)


def test_blocks_interleave_as_in_jax():
    from repro.configs.registry import get_config
    from repro.models.xlstm import XLSTM as JXLSTM
    for reduced in (False, True):
        cfg = treg.get_config(ARCH, reduced=reduced)
        assert xlstm.kinds(cfg) == JXLSTM(get_config(ARCH, reduced))._kinds()
    assert xlstm.kinds(treg.get_config(ARCH)).count("s") == 6


@pytest.fixture(scope="module")
def model():
    m = xlstm.XLSTM(treg.get_config(ARCH, reduced=True), device="cpu", seed=3)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, m.cfg.vocab_size, (B, 32)))
    return m, tokens, m(tokens)


def test_loss_is_the_mean_next_token_ce_of_the_forward(model):
    m, tokens, full = model
    lp = torch.log_softmax(full, -1)[:, :-1]
    want = -lp.gather(-1, tokens[:, 1:, None]).mean()
    assert abs(float(m.loss({"tokens": tokens})) - float(want)) <= 1e-4


def test_prefill_and_decode_equal_the_teacher_forced_forward(model):
    """Prefill 16 tokens (the reduced config's mLSTM chunk), then decode
    the other 16 one a step: every step's logits are the forward's; the
    states advance in place and stay f32."""
    m, tokens, full = model
    caches = m.init_cache(B, 0)
    ids = [id(c) if isinstance(c, torch.Tensor) else tuple(map(id, c))
           for c in caches]
    logits, _ = m.prefill({"tokens": tokens[:, :16]}, caches)
    steps = [logits[:, 0]]
    for t in range(16, 32):
        lg, _ = m.decode_step(tokens[:, t:t + 1], caches)
        steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               full[:, 15:].numpy(), atol=1e-4)
    assert ids == [id(c) if isinstance(c, torch.Tensor)
                   else tuple(map(id, c)) for c in caches]
    assert all(t.dtype == torch.float32 for c in caches
               for t in (c if isinstance(c, tuple) else (c,)))
    # the stepwise states from an empty cache are the prefill's.
    again = m.init_cache(B, 0)
    for t in range(16):
        m.decode_step(tokens[:, t:t + 1], again)
    fresh = m.init_cache(B, 0)
    m.prefill(tokens[:, :16], fresh)
    for a, b in zip(again, fresh):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5)


def test_full_width_state_shapes():
    """At full width a matrix memory is [B, 4, 1024, 1024] f32 (16 MiB a
    row of the batch), 42 of them, and the sLSTM triple [B, 4, 512]."""
    cfg = treg.get_config(ARCH)
    kinds = xlstm.kinds(cfg)
    assert kinds.count("m") == 42
    d, Hn = cfg.d_model, cfg.n_heads
    assert ((2 * d) // Hn, d // Hn) == (1024, 512)
