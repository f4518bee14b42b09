"""event_apply: the port's plain PyTorch version against the JAX package's
pure-jnp oracle, and the hand-written CUDA kernel against the plain version.

The JAX side runs ``repro.kernels.ops.event_apply(..., use_pallas=False)``
(``ref.event_apply_ref``), never the Pallas path.  The port keeps payload as
``[n, S, LANES]``; the JAX oracle takes ``[n, LANES, S]``, so the test swaps
axes on the JAX side.  Bit-exact, except the emitted timestamps under the
``exponential`` draw (two ``log1p`` implementations; rtol 1e-6 as in
tests/test_kernels.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.event_apply import (event_apply_cuda,  # noqa: E402
                                             event_apply_ref)

NAMES = ("payload", "addresses", "top", "dst", "ts", "seed", "pay", "valid")


def _inputs(n, S, C, seed, LANES=6):
    rng = np.random.default_rng(seed)
    return dict(
        payload=rng.random((n, S, LANES), np.float32),
        addresses=np.broadcast_to(np.arange(S, dtype=np.int32), (n, S)).copy(),
        top=np.full((n,), S, np.int32),
        ts=np.sort(rng.random((n, C)).astype(np.float32), axis=1),
        seed=rng.integers(0, 2**32, (n, C), dtype=np.uint32),
        cnt=rng.integers(0, C + 1, (n,), dtype=np.int32),
    )


def _torch_inputs(x, device="cpu"):
    return [torch.from_numpy(x["payload"].copy()).to(device),
            torch.from_numpy(x["addresses"].copy()).to(device),
            torch.from_numpy(x["top"].copy()).to(device),
            torch.from_numpy(x["ts"].copy()).to(device),
            torch.from_numpy(x["seed"].astype(np.int64)).to(device),
            torch.from_numpy(x["cnt"].copy()).to(device)]


def _jax_outputs(x, kw):
    # imported here so that the card-only tests below also run where JAX is
    # not installed (a machine with the card need not have it).
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    out = jops.event_apply(
        jnp.asarray(np.swapaxes(x["payload"], 1, 2)),
        jnp.asarray(x["addresses"]), jnp.asarray(x["top"]),
        jnp.asarray(x["ts"]), jnp.asarray(x["seed"]), jnp.asarray(x["cnt"]),
        **kw, use_pallas=False)
    out = [np.asarray(o) for o in out]
    out[0] = np.swapaxes(out[0], 1, 2)
    return out


def _np(t, name):
    a = t.cpu().numpy()
    return a.astype(np.uint32) if name == "seed" else a


SHAPES = [(2, 128, 4), (4, 256, 8), (1, 512, 16), (8, 160, 5)]


@pytest.mark.parametrize("n,S,C", SHAPES)
@pytest.mark.parametrize("dist", ["dyadic", "uniform24", "exponential"])
@pytest.mark.parametrize("hot", [(0, 0), (4, 128)])
def test_plain_matches_jax_oracle(n, S, C, dist, hot):
    x = _inputs(n, S, C, seed=n * 1000 + S + C)
    kw = dict(n_objects=64, lookahead=0.5, K=max(1, S // 32), KR=3,
              dist=dist, mean=1.0, hot_objects=hot[0], hot_prob=hot[1])
    got = event_apply_ref(*_torch_inputs(x), **kw)
    want = _jax_outputs(x, kw)
    for name, g, w in zip(NAMES, got, want):
        if dist == "exponential" and name == "ts":
            np.testing.assert_allclose(_np(g, name), w, rtol=1e-6)
        else:
            np.testing.assert_array_equal(_np(g, name), w, err_msg=name)


def test_plain_updates_state_in_place_and_ops_routes_cpu_to_plain():
    x = _inputs(4, 256, 8, seed=7)
    kw = dict(n_objects=64, lookahead=0.5, K=8, KR=3)
    inp = _torch_inputs(x)
    out = ops.event_apply(*inp, **kw)
    assert out[0] is inp[0] and out[1] is inp[1] and out[2] is inp[2]
    want = event_apply_ref(*_torch_inputs(x), **kw)
    for name, g, w in zip(NAMES, out, want):
        np.testing.assert_array_equal(_np(g, name), _np(w, name), err_msg=name)
    assert not np.array_equal(inp[0].numpy(), x["payload"])


def test_cuda_wrapper_refuses_cpu_tensors():
    x = _inputs(2, 128, 4, seed=1)
    before = event_apply_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        event_apply_cuda(*_torch_inputs(x), n_objects=64, lookahead=0.5,
                         K=4, KR=3)
    assert event_apply_cuda.launches == before


@pytest.mark.parametrize("edit", ["source", "flags"])
def test_build_is_keyed_by_source_and_flags(edit, tmp_path, monkeypatch):
    p = build.library_path("event_apply")
    assert p == build.library_path("event_apply")
    assert p.parent == build.BUILD_DIR and p.name.startswith("libevent_apply-")
    if edit == "source":
        src = (build.CSRC / "event_apply.cu").read_text()
        (tmp_path / "event_apply.cu").write_text(src + "\n// edited\n")
        monkeypatch.setattr(build, "CSRC", tmp_path)
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    q = build.library_path("event_apply")
    assert q != p and q.parent == p.parent
    assert q.name.startswith("libevent_apply-")


@pytest.mark.cuda
@pytest.mark.parametrize("n,S,C", SHAPES + [(1024, 4000, 128)])
@pytest.mark.parametrize("dist", ["dyadic", "uniform24", "exponential"])
def test_kernel_matches_plain_on_card(n, S, C, dist):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _inputs(n, S, C, seed=n + S + C)
    kw = dict(n_objects=max(n, 64), lookahead=0.5,
              K=max(1, S // 32), KR=4 if S == 4000 else 3, dist=dist,
              hot_objects=4, hot_prob=128)
    before = event_apply_cuda.launches
    got = event_apply_cuda(*_torch_inputs(x, "cuda"), **kw)
    want = event_apply_ref(*_torch_inputs(x, "cuda"), **kw)
    torch.cuda.synchronize()
    assert event_apply_cuda.launches == before + 1
    for name, g, w in zip(NAMES, got, want):
        if dist == "exponential" and name == "ts":
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)
        else:
            assert torch.equal(g, w), name
