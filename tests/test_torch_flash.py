"""flash_attention: the port's ``ops.mha`` on the CPU (the plain
``attention_ref``) against the JAX package's Pallas kernel in interpret mode
and its oracle ``ref.attention_ref``, the wrapper's refusals, and the
hand-written CUDA kernels against the plain version on the card, on
contiguous inputs and on the [B, H, T, D] views of [B, T, H, D] tensors that
``layers.sdpa`` passes; the strides the kernels take; a model of the bf16
kernel's rounding.

Tolerances are the JAX package's own (tests/test_kernels.py): atol 2e-5 in
f32, 2e-2 in bf16.  The port's causal mask is aligned bottom-right, as the
oracle's; the reference's Pallas kernel aligns it top-left (ROADMAP C2), so
the port is held against the kernel at Tq == Tk only and against the oracle
at Tq < Tk as well.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, attention_ref, check_heads, flash_cuda, kernel_strides)

# (B, Hq, Hkv, Tq, Tk, D): the JAX tests' shapes (GQA group 2, group 4, MHA,
# ragged 96), then Tq < Tk.
SHAPES = [(1, 4, 2, 128, 128, 64), (2, 8, 2, 256, 256, 64),
          (1, 2, 2, 64, 64, 32), (1, 4, 1, 96, 96, 32)]
SHORT_Q = [(1, 4, 2, 64, 128, 32), (2, 8, 2, 96, 160, 64)]
# stablelm-12b's head dim (160) at a small T, and its ragged edge.
STABLELM = [(1, 4, 2, 64, 64, 160), (1, 4, 1, 96, 96, 160)]
# llama3.2-3b and zamba2-1.2b at full width (card only).
FULL = [(4, 24, 8, 2048, 2048, 128), (4, 32, 32, 1024, 1024, 128)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _cases(shapes):
    """(shape, causal) pairs; non-causal only where ``ops.mha`` takes it
    (Tk a multiple of the key block min(128, Tk))."""
    return [pytest.param(s, c, id=f"{'x'.join(map(str, s))}-"
                         f"{'causal' if c else 'full'}")
            for s in shapes for c in (True, False)
            if c or s[4] % min(128, s[4]) == 0]


def _inputs(B, Hq, Hkv, Tq, Tk, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Tq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32))


def _torch(arrs, dtype="float32", device="cpu"):
    return [torch.from_numpy(a).to(getattr(torch, dtype)).to(device)
            for a in arrs]


def _views(ts):
    """The same values as [B, H, T, D] views of [B, T, H, D] tensors: the
    layout in which ``layers.sdpa`` hands q, k and v to ``ops.mha``."""
    return [t.transpose(1, 2).contiguous().transpose(1, 2) for t in ts]


def _jax(arrs, dtype):
    import jax.numpy as jnp
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", _cases(SHAPES + STABLELM))
def test_mha_matches_jax_pallas_kernel(shape, causal, dtype):
    from repro.kernels import ops as jops
    arrs = _inputs(*shape, seed=sum(shape))
    got = ops.mha(*_torch(arrs, dtype), causal=causal)
    B, Hq, _, Tq, _, D = shape
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, Hq, Tq, D)
    # the JAX tests' blocks of 64 when causal (T=96 then runs the padding
    # path); non-causal keeps the default 128, which T=96 needs.
    blocks = dict(bq=64, bk=64) if causal else {}
    want = jops.mha(*_jax(arrs, dtype), causal=causal, use_pallas=True,
                    **blocks)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", _cases(SHAPES + SHORT_Q + STABLELM))
def test_mha_matches_jax_oracle(shape, causal, dtype):
    from repro.kernels import ref
    arrs = _inputs(*shape, seed=sum(shape) + 1)
    got = ops.mha(*_torch(arrs, dtype), causal=causal)
    want = ref.attention_ref(*_jax(arrs, dtype), causal=causal)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


def test_jax_pallas_is_top_left_but_the_port_is_bottom_right():
    """ROADMAP C2: at Tq < Tk the reference's Pallas kernel disagrees with
    its own oracle, and the port follows the oracle.  If this fails on the
    JAX side, the reference was fixed and the port's note on C2 is stale."""
    from repro.kernels import ops as jops
    from repro.kernels import ref
    arrs = _inputs(*SHORT_Q[0], seed=3)
    oracle = np.asarray(ref.attention_ref(*_jax(arrs, "float32")))
    kernel = np.asarray(jops.mha(*_jax(arrs, "float32"), use_pallas=True))
    assert np.abs(kernel - oracle).max() > 0.5
    got = ops.mha(*_torch(arrs)).numpy()
    np.testing.assert_allclose(got, oracle, atol=TOL["float32"])


def test_last_row_sees_every_key_and_first_row_the_offset():
    """Bottom-right alignment by hand: with v = one-hot of the key index,
    o[i] is the softmax weight row, which must vanish past i + Tk - Tq."""
    Tq, Tk = 3, 7
    q = torch.zeros((1, 1, Tq, 16))
    k = torch.zeros((1, 1, Tk, 16))
    v = torch.eye(Tk, 16)[None, None]
    o = ops.mha(q, k, v)[0, 0, :, :Tk]
    for i in range(Tq):
        seen = i + Tk - Tq + 1
        np.testing.assert_allclose(o[i, :seen].numpy(), 1.0 / seen, rtol=1e-6)
        assert not o[i, seen:].any()


def test_plain_version_does_not_repeat_kv():
    """GQA by reshape: query head h reads KV head h // group."""
    arrs = _inputs(1, 6, 2, 8, 8, 16, seed=4)
    q, k, v = _torch(arrs)
    got = attention_ref(q, k, v)
    for h in range(6):
        want = attention_ref(q[:, h:h + 1], k[:, h // 3:h // 3 + 1],
                             v[:, h // 3:h // 3 + 1])
        np.testing.assert_allclose(got[:, h:h + 1].numpy(), want.numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("shapes,match", [
    (((1, 2, 200, 16), (1, 2, 200, 16)), "Tk % bk"),
    (((1, 3, 8, 16), (1, 2, 8, 16)), "multiple of"),
    (((1, 2, 8, 16), (1, 2, 8, 32)), "needs q"),
    (((2, 8, 16), (2, 8, 16)), "needs q"),
])
def test_mha_refusals(shapes, match):
    qs, ks = shapes
    with pytest.raises(ValueError, match=match):
        ops.mha(torch.zeros(qs), torch.zeros(ks), torch.zeros(ks),
                causal=match != "Tk % bk")


def test_noncausal_ragged_keys_below_one_block_are_taken():
    arrs = _inputs(1, 2, 2, 8, 100, 16, seed=5)
    got = ops.mha(*_torch(arrs), causal=False)
    want = attention_ref(*_torch(arrs), causal=False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", _cases(SHAPES))
def test_mha_on_views_equals_mha_on_contiguous_copies(shape, causal, dtype):
    ts = _torch(_inputs(*shape, seed=sum(shape) + 2), dtype)
    views = _views(ts)
    assert not views[0].is_contiguous()  # (k, v are when Hkv == 1)
    got = ops.mha(*views, causal=causal)
    want = ops.mha(*[t.contiguous() for t in views], causal=causal)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", _cases(SHAPES))
def test_mha_on_views_matches_jax_pallas_kernel(shape, causal, dtype):
    from repro.kernels import ops as jops
    arrs = _inputs(*shape, seed=sum(shape))
    got = ops.mha(*_views(_torch(arrs, dtype)), causal=causal)
    blocks = dict(bq=64, bk=64) if causal else {}
    want = jops.mha(*_jax(arrs, dtype), causal=causal, use_pallas=True,
                    **blocks)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


def test_kernel_strides_take_a_view_of_the_model_layout():
    B, T, H, D = 2, 24, 3, 32
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros((B, T, H, D), dtype=dtype).transpose(1, 2)
        assert not q.is_contiguous()
        assert kernel_strides("q", q) == (T * H * D, D, H * D)
        assert kernel_strides("q", q.contiguous()) == (H * T * D, T * D, D)


def _odd_t_stride():
    # bf16 rows 17 elements (34 bytes) apart; the B and H strides are
    # multiples of 16 bytes, so only T's is at fault.
    return torch.zeros((1, 2, 8, 17), dtype=torch.bfloat16)[..., :16]


def _misaligned():
    flat = torch.zeros(2 * 8 * 16 + 1, dtype=torch.bfloat16)
    return flat[1:].view(1, 2, 8, 16)


@pytest.mark.parametrize("make,match", [
    (lambda: torch.zeros((1, 2, 8, 32), dtype=torch.bfloat16)[..., ::2],
     "last dimension of q is not contiguous"),
    (_odd_t_stride, "T dimension is not a multiple of 16 bytes"),
    (_misaligned, "base address is not 16-byte aligned"),
], ids=["last-stride", "odd-t-stride", "misaligned-base"])
def test_kernel_strides_refuse_what_the_kernel_cannot_read(make, match):
    t = make()
    assert t.shape == (1, 2, 8, 16)
    with pytest.raises(ValueError, match=match):
        kernel_strides("q", t)


def _kernel_rounding_model(q, k, v, *, causal, bk=64):
    """The bf16 kernel's arithmetic in torch, block by block: S in f32 from
    the bf16 q and k, scaled into the log2 domain; the running max m; P =
    exp2(S - m) in f32, summed into l, then rounded to bf16 for P·V with the
    bf16 v; o = acc / l rounded to bf16.  GQA by reshape, as attention_ref."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Tq, D)
    c = (1.0 / math.sqrt(D)) * math.log2(math.e)
    rows = torch.arange(Tq)[:, None]
    m = torch.full((B, Hkv, Hq // Hkv, Tq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, Hq // Hkv, Tq, D))
    for k0 in range(0, Tk, bk):
        kb, vb = k[:, :, k0:k0 + bk].float(), v[:, :, k0:k0 + bk]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * c
        cols = k0 + torch.arange(kb.shape[2])[None, :]
        if causal:
            s = torch.where(cols <= rows + Tk - Tq, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhgqk,bhkd->bhgqd",
                          p.to(torch.bfloat16).float(), vb.float())
        acc = acc * alpha + pv
        m = m_new
    o = acc / l.clamp(min=1e-30)
    return o.reshape(B, Hq, Tq, D).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_kernel_rounding_model_stays_within_bf16_tolerance(causal):
    """Rounding P to bf16 for the P·V product (l from the f32 P) keeps the
    bf16 kernel within 2e-2 of attention_ref at llama3.2-3b's T and D."""
    q, k, v = _torch(_inputs(1, 3, 1, 2048, 2048, 128, seed=7), "bfloat16")
    got = _kernel_rounding_model(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL["bfloat16"], err


def test_sdpa_hands_views_of_the_model_tensors_to_mha(monkeypatch):
    """``layers.sdpa`` under ``attn_impl="pallas"`` copies nothing: ops.mha
    receives [B, H, T, D] views of the [B, T, H, D] q, k, v, and the output
    comes back through a transpose."""
    from types import SimpleNamespace

    from repro_torch.models import layers
    B, T, Hq, Hkv, hd = 2, 16, 4, 2, 16
    q, k, v = (torch.randn((B, T, H, hd)) for H in (Hq, Hkv, Hkv))
    seen = []

    def spy(qv, kv, vv, *, causal):
        seen.append((qv, kv, vv, causal))
        return attention_ref(qv, kv, vv, causal=causal)
    monkeypatch.setattr(layers.ops, "mha", spy)
    out = layers.sdpa(SimpleNamespace(attn_impl="pallas"), q, k, v)
    (qv, kv, vv, causal), = seen
    assert causal
    for view, base, H in ((qv, q, Hq), (kv, k, Hkv), (vv, v, Hkv)):
        assert view.shape == (B, H, T, hd) and not view.is_contiguous()
        assert view.data_ptr() == base.data_ptr()
        assert view.stride() == (T * H * hd, hd, H * hd, 1)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2)).transpose(1, 2)
    assert out.shape == (B, T, Hq, hd) and torch.equal(out, want)


def test_cuda_wrapper_refuses_cpu_tensors():
    before = flash_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_cuda(*_torch(_inputs(1, 2, 2, 8, 8, 16, seed=0)))
    assert flash_cuda.launches == before


def test_flash_attention_is_built_with_the_default_flags():
    from repro_torch.kernels import build
    assert build.flags("flash_attention") == build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert build.library_path("flash_attention").name.startswith(
        "libflash_attention-")


# -- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "view"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", _cases(
    SHAPES + SHORT_Q + FULL + STABLELM + [(1, 8, 2, 1000, 1000, 128),
                                          (2, 32, 8, 1024, 1024, 160)]))
def test_kernel_matches_plain_on_card(shape, causal, dtype, layout):
    _card()
    q, k, v = _torch(_inputs(*shape, seed=sum(shape)), dtype, "cuda")
    if layout == "view":
        q, k, v = _views((q, k, v))
    before = flash_cuda.launches
    got = ops.mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_cuda.launches == before + 1 and got.dtype == q.dtype
    assert got.stride() == q.stride()
    want = attention_ref(q, k, v, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take():
    _card()
    q, k, v = _torch(_inputs(1, 2, 2, 64, 64, 48, seed=0), device="cuda")
    with pytest.raises(NotImplementedError, match="D=48.*compiled for"):
        flash_cuda(q, k, v)
    q, k, v = _torch(_inputs(1, 2, 2, 64, 64, 32, seed=0), device="cuda")
    with pytest.raises(ValueError, match="not contiguous"):
        flash_cuda(torch.cat([q, q], dim=-1)[..., ::2], k, v)
    with pytest.raises(ValueError, match="dtype"):
        flash_cuda(q, k.bfloat16(), v)
    before = flash_cuda.launches
    with pytest.raises(ValueError, match="aligned"):
        flash_cuda(q, k, torch.empty(k.numel() + 1, device="cuda")[1:]
                   .view(k.shape))
    assert flash_cuda.launches == before


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_head_dims_the_kernel_is_built_for_are_taken(D):
    assert check_heads(D, 8, 2) is None


@pytest.mark.parametrize("D,Hq,Hkv,err", [
    (48, 2, 2, NotImplementedError), (96, 4, 2, NotImplementedError),
    (64, 3, 2, ValueError), (160, 3, 2, ValueError), (64, 2, 0, ValueError)])
def test_head_refusals_name_the_slice_or_the_reference_rule(D, Hq, Hkv, err):
    # a head dim the reference takes but no config uses is a port gap that
    # names where the compiled ones are listed; a GQA ratio the reference
    # refuses too stays a ValueError.
    with pytest.raises(err, match="compiled for" if err is NotImplementedError
                       else "multiple of Hkv"):
        check_heads(D, Hq, Hkv)


def test_every_configs_head_dim_is_compiled():
    """Every config whose attention can reach ``sdpa`` (all but xLSTM's,
    which has none, and MLA's, which runs the plain chunked attention)."""
    from repro_torch.configs.registry import all_archs, get_config
    for arch in all_archs():
        for reduced in (False, True):
            cfg = get_config(arch, reduced)
            if cfg.family != "xlstm" and not cfg.use_mla:
                assert cfg.hd in HEAD_DIMS, arch
