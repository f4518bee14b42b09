"""ssd_scan: the port's plain PyTorch SSD against the JAX package's
sequential oracle (``repro.kernels.ref.ssd_ref``) and its Pallas kernel in
interpret mode, the chunk rule of ``ops.ssd``, the final state it hands back
against the JAX ``ssd_final_state``, strided x, the wrapper's checks, a
plain-torch model of the bf16 kernel's roundings, and the hand-written CUDA
kernels against the plain version on the card.

Tolerances are the JAX package's own (tests/test_kernels.py): atol 1e-4 in
f32, 5e-2 with bf16 x/y; the final state 1e-4 in f32, 1e-2 with bf16 x.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    ssd_cuda, ssd_ref, x_strides)
from repro_torch.models.mamba2 import ssd_final_state  # noqa: E402

# (b, T, H, P, N, chunk): the JAX tests' three shapes at chunk 32, then
# T < 128 (one chunk of Q = T) and T = 160 (Q = 128, 96 padded steps).
SHAPES = [(1, 64, 2, 32, 16, 32), (2, 160, 4, 64, 32, 32),
          (1, 96, 1, 16, 8, 32), (1, 37, 2, 16, 8, 128),
          (2, 160, 2, 16, 8, 128)]
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
STATE_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _inputs(b, T, H, P, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, T, H, P)).astype(np.float32) * 0.5,
            rng.random((b, T, H)).astype(np.float32) * 0.2,
            -rng.random((H,)).astype(np.float32),
            rng.standard_normal((b, T, N)).astype(np.float32) * 0.3,
            rng.standard_normal((b, T, N)).astype(np.float32) * 0.3)


def _torch(arrs, xdtype=torch.float32, device="cpu", view=False):
    """The inputs as tensors; with ``view``, x holds the same values as a
    [b, T, H, P] view of a wider [b, T, H·P + 2N] tensor, the layout in
    which ``mamba_apply`` hands it over."""
    x, *rest = (torch.from_numpy(a) for a in arrs)
    x = x.to(xdtype).to(device)
    if view:
        b, T, H, P = x.shape
        wide = torch.zeros((b, T, H * P + 2 * rest[-1].shape[-1]),
                           dtype=xdtype, device=device)
        wide[..., :H * P] = x.reshape(b, T, H * P)
        x = wide[..., :H * P].view(b, T, H, P)
    return [x, *(t.to(device) for t in rest)]


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

    def spy(x, dt, A, B, C, *, chunk, final_state=None):
        seen.append((chunk, x.shape[1], float(dt[:, T:].abs().sum())))
        return ssd_ref(x, dt, A, B, C, chunk=chunk, final_state=final_state)

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


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """A kernel is rebuilt when ``csrc/wgmma.cuh``, which it includes,
    changes."""
    from repro_torch.kernels import build
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("ssd_scan")
    header = tmp_path / "wgmma.cuh"
    header.write_text(header.read_text() + "\n")
    assert build.library_path("ssd_scan") != before


def test_cuda_wrapper_refuses_cpu_tensors():
    before = ssd_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(*_torch(_inputs(1, 8, 1, 4, 4, seed=0)), chunk=8)
    assert ssd_cuda.launches == before


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_final_state_matches_jax(shape):
    """``ops.ssd(..., final_state=h)`` hands back the state the scan
    carries, equal to the JAX closed form, padded T included."""
    from repro.models.mamba2 import ssd_final_state as jax_final_state
    b, T, H, P, N, chunk = shape
    arrs = _inputs(b, T, H, P, N, seed=T + N)
    h = torch.full((b, H, N, P), float("nan"))
    ops.ssd(*_torch(arrs), chunk=chunk, final_state=h)
    x, dt, A, B, _ = arrs
    want = np.asarray(jax_final_state(x, dt, A, B))
    np.testing.assert_allclose(h.numpy(), want, atol=STATE_TOL["float32"])


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["sequential-oracle", "pallas-interpret"])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3]],
                         ids=lambda s: "x".join(map(str, s)))
def test_strided_x_matches_contiguous_and_jax(shape, use_pallas):
    b, T, H, P, N, chunk = shape
    arrs = _inputs(b, T, H, P, N, seed=3 * T)
    view = _torch(arrs, view=True)
    assert not view[0].is_contiguous()
    got = ops.ssd(*view, chunk=chunk)
    torch.testing.assert_close(got, ops.ssd(*_torch(arrs), chunk=chunk),
                               rtol=0, atol=0)
    want = _jax(arrs, chunk, xdtype="float32", use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL["float32"])


@pytest.mark.parametrize("T,copied", [(256, False), (128, False),
                                      (160, True)])
def test_ssd_pad_copies_x_only_to_pad(T, copied):
    x, dt, _, B, C = _torch(_inputs(1, T, 2, 16, 8, seed=1), view=True)
    x_, dt_, B_, C_, ch = ops.ssd_pad(x, dt, B, C, chunk=128)
    assert (x_.data_ptr() != x.data_ptr()) == copied
    assert x_.shape[1] % ch == 0 and dt_.is_contiguous()


def test_x_strides_take_the_model_view_and_refuse_by_name():
    b, T, H, P, N = 2, 8, 4, 16, 8
    wide = torch.zeros((b, T, H * P + 2 * N), dtype=torch.bfloat16)
    view = wide[..., :H * P].view(b, T, H, P)
    assert x_strides(view) == (T * (H * P + 2 * N), H * P + 2 * N, P)
    assert x_strides(view.contiguous()) == (T * H * P, H * P, P)
    with pytest.raises(ValueError, match="last dimension of x is not "
                                         "contiguous"):
        x_strides(torch.zeros((b, T, P, H)).transpose(2, 3))
    odd = torch.zeros((b, T, H * P + 3), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stride 67 of x's t dimension is "
                                         "not a multiple of 16 bytes"):
        x_strides(odd[..., :H * P].view(b, T, H, P))
    flat = torch.zeros(b * T * H * P + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="base address"):
        x_strides(flat[1:].view(b, T, H, P))


def _kernel_rounding_model(x, dt, A, B, C, *, chunk):
    """The bf16 kernel's arithmetic in torch, chunk by chunk, f32 products
    on bf16 operands: C and B rounded to bf16; S = C Bᵀ; G = S ⊙ decay ⊙ dt
    rounded to bf16 (in registers); y = e^l ⊙ (C · bf16(h)) + G x; h carried
    in f32 and updated by bf16(B ⊙ w)ᵀ x.  Returns y in f32 (before the
    output's own bf16 rounding) and the final h."""
    def bf(t):
        return t.to(torch.bfloat16).float()
    b, T, H, P = x.shape
    N = B.shape[-1]
    Q = chunk
    xf = bf(x).reshape(b, T // Q, Q, H, P)
    dtf = dt.float().reshape(b, T // Q, Q, H)
    Bf = bf(B).reshape(b, T // Q, Q, N)
    Cf = bf(C).reshape(b, T // Q, Q, N)
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    h = torch.zeros((b, H, N, P))
    ys = []
    for c in range(T // Q):
        xc, dc, Bc, Cc = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        l = torch.cumsum(dc * A, dim=1)                          # [b, Q, H]
        S = torch.einsum("bin,bjn->bij", Cc, Bc)
        decay = torch.exp(l[:, :, None, :] - l[:, None, :, :])
        G = torch.where(causal[None, :, :, None],
                        S[..., None] * decay * dc[:, None, :, :], 0.0)
        ys.append(torch.exp(l)[..., None]
                  * torch.einsum("bin,bhnp->bihp", Cc, bf(h))
                  + torch.einsum("bijh,bjhp->bihp", bf(G), xc))
        w = torch.exp(l[:, -1:, :] - l) * dc                     # [b, Q, H]
        Bw = bf(Bc[..., None] * w[:, :, None, :])                # [b, Q, N, H]
        h = (torch.exp(l[:, -1, :])[..., None, None] * h
             + torch.einsum("bjnh,bjhp->bhnp", Bw, xc))
    return torch.stack(ys, dim=1).reshape(b, T, H, P), h


def test_kernel_rounding_model_stays_within_bf16_tolerance():
    """bf16 operands (C, B, G, the copy of h, B ⊙ w) with f32 accumulation
    and an f32 h keep the bf16 kernel within 2e-2 of ssd_ref, and its final
    state within 1e-2 of ssd_final_state, at the serving P, N, Q and T."""
    arrs = _inputs(1, 1024, 4, 64, 64, seed=11)
    x, dt, A, B, C = _torch(arrs, torch.bfloat16)
    y, h = _kernel_rounding_model(x, dt, A, B, C, chunk=128)
    want = ssd_ref(x.float(), dt, A, B, C, chunk=128)
    assert float((y - want).abs().max()) <= 2e-2
    assert float((h - ssd_final_state(x, dt, A, B)).abs().max()) <= \
        STATE_TOL["bfloat16"]


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "view"])
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES + [(4, 1024, 64, 64, 64, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_card(shape, xdtype, layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b, T, H, P, N, chunk = shape
    inp = _torch(_inputs(b, T, H, P, N, seed=T + P), getattr(torch, xdtype),
                 "cuda", view=layout == "view")
    h = torch.full((b, H, N, P), float("nan"), device="cuda")
    before = ssd_cuda.launches
    got = ops.ssd(*inp, chunk=chunk, final_state=h)
    torch.cuda.synchronize()
    assert ssd_cuda.launches == before + 1
    want = ops.ssd(*[t.cpu() for t in inp], chunk=chunk)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), atol=TOL[xdtype])
    x, dt, A, B, _ = (t.cpu() for t in inp)
    np.testing.assert_allclose(h.cpu().numpy(),
                               ssd_final_state(x, dt, A, B).numpy(),
                               atol=STATE_TOL[xdtype])


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
    # the bf16 tensor-core kernel: P a multiple of 8, P and N at most 64.
    for P, N in ((12, 8), (72, 8), (16, 68)):
        inp = _torch(_inputs(1, 128, 1, P, N, seed=0), torch.bfloat16, "cuda")
        with pytest.raises(ValueError, match="bf16 kernel needs"):
            ssd_cuda(*inp, chunk=128)
    # x through its strides: a unit last stride, rows on 16 bytes.
    x, *rest = _torch(_inputs(1, 128, 2, 16, 8, seed=0), torch.bfloat16,
                      "cuda")
    with pytest.raises(ValueError, match="not contiguous"):
        ssd_cuda(x.as_strided(x.shape, (4096, 32, 1, 2)), *rest, chunk=128)
    odd = torch.zeros((1, 128, 2 * 16 + 3), dtype=torch.bfloat16,
                      device="cuda")
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        ssd_cuda(odd[..., :32].view(1, 128, 2, 16), *rest, chunk=128)
