"""ssd_scan: the port's plain PyTorch SSD against the JAX package's
sequential oracle (``repro.kernels.ref.ssd_ref``) and its Pallas kernel in
interpret mode, the chunk rule of ``ops.ssd``, the wrapper's checks, and the
hand-written CUDA kernel against the plain version on the card.

Tolerances are the JAX package's own (tests/test_kernels.py): atol 1e-4 in
f32, 5e-2 with bf16 x/y.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_ref  # noqa: E402

# (b, T, H, P, N, chunk): the JAX tests' three shapes at chunk 32, then
# T < 128 (one chunk of Q = T) and T = 160 (Q = 128, 96 padded steps).
SHAPES = [(1, 64, 2, 32, 16, 32), (2, 160, 4, 64, 32, 32),
          (1, 96, 1, 16, 8, 32), (1, 37, 2, 16, 8, 128),
          (2, 160, 2, 16, 8, 128)]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _inputs(b, T, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, T, H, P)).astype(np.float32) * 0.5,
            rng.random((b, T, H)).astype(np.float32) * 0.2,
            -rng.random((H,)).astype(np.float32),
            rng.standard_normal((b, T, N)).astype(np.float32) * 0.3,
            rng.standard_normal((b, T, N)).astype(np.float32) * 0.3)


def _torch(arrs, xdtype=torch.float32, device="cpu"):
    x, *rest = (torch.from_numpy(a) for a in arrs)
    return [t.to(device) for t in [x.to(xdtype), *rest]]


def _jax(arrs, chunk, *, xdtype, use_pallas):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    x, *rest = arrs
    x = jnp.asarray(torch.from_numpy(x).to(getattr(torch, xdtype)).float()
                    .numpy(), getattr(jnp, xdtype))
    y = jops.ssd(x, *map(jnp.asarray, rest), chunk=chunk,
                 use_pallas=use_pallas)
    return np.asarray(y, np.float32)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["sequential-oracle", "pallas-interpret"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax(shape, use_pallas):
    b, T, H, P, N, chunk = shape
    arrs = _inputs(b, T, H, P, N, seed=T + H + P)
    got = ops.ssd(*_torch(arrs), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (b, T, H, P)
    want = _jax(arrs, chunk, xdtype="float32", use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL["float32"])


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["sequential-oracle", "pallas-interpret"])
def test_plain_matches_jax_bf16(use_pallas):
    b, T, H, P, N, chunk = 1, 64, 2, 32, 16, 32
    arrs = _inputs(b, T, H, P, N, seed=7)
    got = ops.ssd(*_torch(arrs, torch.bfloat16), chunk=chunk)
    assert got.dtype == torch.bfloat16
    want = _jax(arrs, chunk, xdtype="bfloat16", use_pallas=use_pallas)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=TOL["bfloat16"])


@pytest.mark.parametrize("T,chunk,want_q,want_t", [
    (64, 32, 32, 64), (37, 128, 37, 37), (160, 128, 128, 256),
    (1, 128, 1, 1), (1024, 128, 128, 1024)])
def test_chunk_rule_pads_with_identity_steps(T, chunk, want_q, want_t,
                                             monkeypatch):
    seen = []

    def spy(x, dt, A, B, C, *, chunk):
        seen.append((chunk, x.shape[1], float(dt[:, T:].abs().sum())))
        return ssd_ref(x, dt, A, B, C, chunk=chunk)

    monkeypatch.setattr(ops, "ssd_ref", spy)
    arrs = _inputs(1, T, 2, 8, 4, seed=T)
    y = ops.ssd(*_torch(arrs), chunk=chunk)
    assert seen == [(want_q, want_t, 0.0)]
    assert y.shape == (1, T, 2, 8)
    # padding never changes the first T outputs.
    np.testing.assert_allclose(y.numpy(), ssd_ref(*_torch(arrs), chunk=T)
                               .numpy(), atol=1e-5)


def test_plain_version_needs_whole_chunks():
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_ref(*_torch(_inputs(1, 10, 1, 4, 4, seed=0)), chunk=4)


def test_only_event_apply_is_built_without_fma_contraction():
    from repro_torch.kernels import build
    assert "-fmad=false" in build.flags("event_apply")
    assert "-fmad=false" not in build.flags("ssd_scan")
    assert build.library_path("ssd_scan").name.startswith("libssd_scan-")


def test_cuda_wrapper_refuses_cpu_tensors():
    before = ssd_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(*_torch(_inputs(1, 8, 1, 4, 4, seed=0)), chunk=8)
    assert ssd_cuda.launches == before


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + [(4, 1024, 64, 64, 64, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_card(shape, xdtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, T, H, P, N, chunk = shape
    inp = _torch(_inputs(b, T, H, P, N, seed=T + P), getattr(torch, xdtype),
                 "cuda")
    before = ssd_cuda.launches
    got = ops.ssd(*inp, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    want = ops.ssd(*[t.cpu() for t in inp], chunk=chunk)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), atol=TOL[xdtype])


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inp = _torch(_inputs(1, 256, 1, 6, 4, seed=0), device="cuda")
    with pytest.raises(ValueError, match="multiples of 4"):
        ssd_cuda(*inp, chunk=128)
    inp = _torch(_inputs(1, 256, 1, 8, 4, seed=0), device="cuda")
    with pytest.raises(ValueError, match="chunk"):
        ssd_cuda(*inp, chunk=256)
