"""event_apply: the port's plain PyTorch version against the JAX package's
pure-jnp oracle, a numpy mirror of the CUDA kernel's order of work against
both, and the hand-written CUDA kernel against the plain version.

The JAX side runs ``repro.kernels.ops.event_apply(..., use_pallas=False)``
(``ref.event_apply_ref``), never the Pallas path.  The port keeps payload as
``[n, S, LANES]``; the JAX oracle takes ``[n, LANES, S]``, so the test swaps
axes on the JAX side.  Bit-exact, except the emitted timestamps under the
``exponential`` draw (two ``log1p`` implementations; rtol 1e-6 as in
tests/test_kernels.py).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.events import (draw_np, dyadic10_np,  # noqa: E402
                                     fold_np)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.event_apply import (event_apply_cuda,  # noqa: E402
                                             event_apply_ref)

NAMES = ("payload", "addresses", "top", "dst", "ts", "seed", "pay", "valid")


def _inputs(n, S, C, seed, LANES=6, cnt=None):
    rng = np.random.default_rng(seed)
    x = dict(
        payload=rng.random((n, S, LANES), np.float32),
        addresses=np.broadcast_to(np.arange(S, dtype=np.int32), (n, S)).copy(),
        top=np.full((n,), S, np.int32),
        ts=np.sort(rng.random((n, C)).astype(np.float32), axis=1),
        seed=rng.integers(0, 2**32, (n, C), dtype=np.uint32),
        cnt=rng.integers(0, C + 1, (n,), dtype=np.int32),
    )
    if cnt is not None:
        x["cnt"] = np.asarray(cnt, np.int32)
    return x


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

#: (name, n, S, C, K, KR, cnt, LANES) batches that stress the kernel's order
#: of work: windows of S/4 with every bucket full (each node under ~C/3
#: events, several CTAs per object), an init range wider than the window that
#: the S - KR clamp moves ahead of it, rows without events, and more lanes
#: than a kernel thread holds at once.
STRESS = [("heavy-overlap", 4, 256, 96, 64, 3, [96] * 4, 6),
          ("init-past-window", 4, 64, 16, 4, 40, None, 6),
          ("empty-rows", 6, 128, 8, 4, 3, [0, 8, 0, 3, 0, 0], 6),
          ("lanes-13", 3, 96, 12, 8, 3, None, 13)]


def _kernel_constants():
    """The launch constants of csrc/event_apply.cu, read from its source."""
    src = (build.CSRC / "event_apply.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def _kernel_order(x, *, n_objects, lookahead, K, KR, dist="dyadic", mean=1.0,
                  hot_objects=0, hot_prob=0):
    """numpy mirror of the CUDA kernel's order of work (csrc/event_apply.cu).

    Per object: every event's parameters and emission at once; the arena
    slots from the last event; then each tile of ``kTile`` nodes, in the
    order the CTAs of the object's parts and their warps take them, holds
    the events that meet it in event order, and each float of the tile
    (float ``l + 32 i`` of lane ``l``) is loaded if an event covers its
    node, composed over those events (``x * 0.5 + delta`` on the window,
    then the init value) and stored once.  Asserts that every tile is taken
    exactly once.
    """
    k = _kernel_constants()
    tile, warps = k["kTile"], k["kThreads"] // 32
    payload, addresses = x["payload"].copy(), x["addresses"].copy()
    n, S, LANES = payload.shape
    C = x["ts"].shape[1]
    odst = np.zeros((n, C), np.int32)
    ots = np.full((n, C), np.inf, np.float32)
    oseed = np.zeros((n, C), np.uint32)
    opay = np.zeros((n, C), np.float32)
    ovalid = np.zeros((n, C), np.int32)
    ntiles = -(-S // tile)
    max_parts = max(1, -(-C // k["kEventsPerPart"]))
    q = np.arange(tile * LANES)
    for o in range(n):
        c = int(np.clip(x["cnt"][o], 0, C))
        s = x["seed"][o, :c].astype(np.uint32)
        start = (fold_np(s, 0) % np.uint32(S - K + 1)).astype(np.int64)
        istart = np.minimum(start, S - KR)
        delta, init = dyadic10_np(fold_np(s, 5)), dyadic10_np(fold_np(s, 6))
        dst = fold_np(s, 1) % np.uint32(n_objects)
        if hot_objects and hot_prob:
            hot = (fold_np(s, 8) & np.uint32(255)) < np.uint32(hot_prob)
            dst = np.where(hot, fold_np(s, 9) % np.uint32(hot_objects), dst)
        odst[o, :c] = dst
        ots[o, :c] = (x["ts"][o, :c] + np.float32(lookahead)
                      + draw_np(fold_np(s, 2), dist, mean))
        oseed[o, :c] = fold_np(s, 3)
        opay[o, :c] = dyadic10_np(fold_np(s, 4))
        ovalid[o, :c] = 1
        if c == 0:
            continue
        at = min(max(int(x["top"][o]) - KR, 0), S - KR)
        addresses[o, at:at + KR] = start[-1] + KR - 1 - np.arange(KR)
        parts = min(max(-(-c // k["kEventsPerPart"]), 1), max_parts)
        flat = payload[o].reshape(-1)
        taken = np.zeros(ntiles, np.int64)
        for first in range(parts * warps):
            for t in range(first, ntiles, parts * warps):
                taken[t] += 1
                lo = t * tile
                meets = (((start < lo + tile) & (start + K > lo))
                         | ((istart < lo + tile) & (istart + KR > lo)))
                events = np.nonzero(meets)[0]
                node = lo + q // LANES
                win = [(node - start[e] >= 0) & (node - start[e] < K)
                       for e in events]
                ini = [(node - istart[e] >= 0) & (node - istart[e] < KR)
                       for e in events]
                cov = np.zeros(q.shape, bool)
                for w, i in zip(win, ini):
                    cov |= w | i
                at = lo * LANES + q[cov]
                xv = np.zeros(q.shape, np.float32)
                xv[cov] = flat[at]
                for e, w, i in zip(events, win, ini):
                    xv = np.where(w, xv * np.float32(0.5) + delta[e], xv)
                    xv = np.where(i, init[e], xv)
                flat[at] = xv[cov]
        assert (taken == 1).all()
    return payload, addresses, x["top"], odst, ots, oseed, opay, ovalid


def _assert_same(got, want, dist, to_np=lambda a, name: a):
    for name, g, w in zip(NAMES, got, want):
        g, w = to_np(g, name), to_np(w, name)
        if dist == "exponential" and name == "ts":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _order_cases():
    for n, S, C in SHAPES:
        for hot in ((0, 0), (4, 128)):
            yield (f"n{n}-S{S}-C{C}-hot{hot[0]}", n, S, C, max(1, S // 32), 3,
                   None, 6, hot)
    for name, n, S, C, K, KR, cnt, lanes in STRESS:
        yield name, n, S, C, K, KR, cnt, lanes, (4, 128)


@pytest.mark.parametrize("case", list(_order_cases()), ids=lambda c: c[0])
@pytest.mark.parametrize("dist", ["dyadic", "uniform24", "exponential"])
def test_kernel_order_of_work_is_exact(case, dist):
    """The kernel's reformulation (parameters first, then each covered node
    composed over its events) equals the JAX oracle and the plain version:
    bit for bit, ts within rtol 1e-6 under ``exponential``."""
    _, n, S, C, K, KR, cnt, lanes, hot = case
    x = _inputs(n, S, C, seed=n * 1000 + S + C + K, LANES=lanes, cnt=cnt)
    kw = dict(n_objects=64, lookahead=0.5, K=K, KR=KR, dist=dist, mean=1.0,
              hot_objects=hot[0], hot_prob=hot[1])
    got = _kernel_order(x, **kw)
    _assert_same(got, _jax_outputs(x, kw), dist)
    _assert_same(got, event_apply_ref(*_torch_inputs(x), **kw), dist,
                 lambda a, name: _np(a, name) if torch.is_tensor(a) else a)


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


def _card_cases():
    for n, S, C in SHAPES + [(1024, 4000, 128)]:
        yield (f"n{n}-S{S}-C{C}", n, S, C, max(1, S // 32),
               4 if S == 4000 else 3, None, 6)
    for case in STRESS:
        yield case
    # the main path's shape with 4 objects' buckets full (phold-hotspot's
    # hot objects), the rest at 0-10 events.
    cnt = np.random.default_rng(5).integers(0, 11, 1024)
    cnt[:4] = 128
    yield "main-skewed", 1024, 4000, 128, 125, 4, cnt, 6


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_card_cases()), ids=lambda c: c[0])
@pytest.mark.parametrize("dist", ["dyadic", "uniform24", "exponential"])
def test_kernel_matches_plain_on_card(case, dist):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, n, S, C, K, KR, cnt, lanes = case
    x = _inputs(n, S, C, seed=n + S + C, LANES=lanes, cnt=cnt)
    kw = dict(n_objects=max(n, 64), lookahead=0.5, K=K, KR=KR, dist=dist,
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
