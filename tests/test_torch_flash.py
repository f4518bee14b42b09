"""flash_attention: the port's ``ops.mha`` on the CPU (the plain
``attention_ref``) against the JAX package's Pallas kernel in interpret mode
and its oracle ``ref.attention_ref``, the wrapper's refusals, and the
hand-written CUDA kernel against the plain version on the card.

Tolerances are the JAX package's own (tests/test_kernels.py): atol 2e-5 in
f32, 2e-2 in bf16.  The port's causal mask is aligned bottom-right, as the
oracle's; the reference's Pallas kernel aligns it top-left (ROADMAP C2), so
the port is held against the kernel at Tq == Tk only and against the oracle
at Tq < Tk as well.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_ref,  # noqa: E402
                                                 flash_cuda)

# (B, Hq, Hkv, Tq, Tk, D): the JAX tests' shapes (GQA group 2, group 4, MHA,
# ragged 96), then Tq < Tk.
SHAPES = [(1, 4, 2, 128, 128, 64), (2, 8, 2, 256, 256, 64),
          (1, 2, 2, 64, 64, 32), (1, 4, 1, 96, 96, 32)]
SHORT_Q = [(1, 4, 2, 64, 128, 32), (2, 8, 2, 96, 160, 64)]
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


def _jax(arrs, dtype):
    import jax.numpy as jnp
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", _cases(SHAPES))
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
@pytest.mark.parametrize("shape,causal", _cases(SHAPES + SHORT_Q))
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,causal", _cases(
    SHAPES + SHORT_Q + FULL + [(1, 8, 2, 1000, 1000, 128)]))
def test_kernel_matches_plain_on_card(shape, causal, dtype):
    _card()
    q, k, v = _torch(_inputs(*shape, seed=sum(shape)), dtype, "cuda")
    before = flash_cuda.launches
    got = ops.mha(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_cuda.launches == before + 1 and got.dtype == q.dtype
    want = attention_ref(q, k, v, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take():
    _card()
    q, k, v = _torch(_inputs(1, 2, 2, 64, 64, 48, seed=0), device="cuda")
    with pytest.raises(ValueError, match="D in"):
        flash_cuda(q, k, v)
    q, k, v = _torch(_inputs(1, 2, 2, 64, 64, 32, seed=0), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        flash_cuda(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="dtype"):
        flash_cuda(q, k.bfloat16(), v)
    before = flash_cuda.launches
    with pytest.raises(ValueError, match="aligned"):
        flash_cuda(q, k, torch.empty(k.numel() + 1, device="cuda")[1:]
                   .view(k.shape))
    assert flash_cuda.launches == before
