"""The port's event records and counter RNG against the JAX package's.

Inputs are numpy-made u32 words, edge values included; the port carries
them in int64.  Every function is bit-exact except ``exponential``, which
goes through two different ``log1p`` implementations (rtol 1e-6, the
tolerance of tests/test_kernels.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import events as jev  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402

EDGES = np.array([0, 1, 2, 1023, 1024, 0x7FFFFFFF, 0x80000000, 0x80000001,
                  0xFFFFFF00, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _words(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 2**32, n, dtype=np.uint32)])


def _t(x):
    return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))


def _u32(t):
    a = t.numpy()
    assert a.min() >= 0 and a.max() <= 0xFFFFFFFF
    return a.astype(np.uint32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def test_mix_matches_jax():
    x = _words()
    np.testing.assert_array_equal(_u32(tev._mix(_t(x))),
                                  np.asarray(jev._mix(jnp.asarray(x))))


@pytest.mark.parametrize("k", list(range(10)) + [123456])
def test_fold_matches_jax_and_numpy(k):
    x = _words(seed=k)
    got = _u32(tev.fold(_t(x), k))
    np.testing.assert_array_equal(got, np.asarray(jev.fold(jnp.asarray(x), k)))
    np.testing.assert_array_equal(got, jev.fold_np(x, k))
    np.testing.assert_array_equal(tev.fold_np(x, k), jev.fold_np(x, k))


@pytest.mark.parametrize("fn", ["uniform24", "dyadic10"])
def test_unit_draws_bitexact(fn):
    x = _words()
    got = getattr(tev, fn)(_t(x)).numpy()
    want = np.asarray(getattr(jev, fn)(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(getattr(tev, fn + "_np")(x)),
                                  _bits(getattr(jev, fn + "_np")(x)))


@pytest.mark.parametrize("dist", ["dyadic", "uniform24"])
@pytest.mark.parametrize("mean", [1.0, 0.75, 1.3])
def test_draw_bitexact(dist, mean):
    x = _words()
    got = tev.draw(_t(x), dist, mean).numpy()
    want = np.asarray(jev.draw(jnp.asarray(x), dist, mean))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(tev.draw_np(x, dist, mean)),
                                  _bits(jev.draw_np(x, dist, mean)))


@pytest.mark.parametrize("mean", [1.0, 0.75])
def test_draw_exponential_close(mean):
    x = _words()
    got = tev.draw(_t(x), "exponential", mean).numpy()
    want = np.asarray(jev.draw(jnp.asarray(x), "exponential", mean))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(tev.draw_np(x, "exponential", mean),
                                  jev.draw_np(x, "exponential", mean))


@pytest.mark.parametrize("shift", [0, 1, 3])
@pytest.mark.parametrize("dist", ["dyadic", "uniform24"])
def test_scaled_draws_bitexact(shift, dist):
    x = _words()
    np.testing.assert_array_equal(
        _bits(tev.dyadic_scaled(_t(x), shift).numpy()),
        _bits(np.asarray(jev.dyadic_scaled(jnp.asarray(x), shift))))
    np.testing.assert_array_equal(
        _bits(tev.draw_scaled(_t(x), dist, shift).numpy()),
        _bits(np.asarray(jev.draw_scaled(jnp.asarray(x), dist, shift))))
    np.testing.assert_array_equal(_bits(tev.draw_scaled_np(x, dist, shift)),
                                  _bits(jev.draw_scaled_np(x, dist, shift)))


def test_seed_salt_and_ring_neighbor():
    for s in (0, 1, 7, 2**31, 2**32 - 1):
        assert tev.seed_salt_np(s) == jev.seed_salt_np(s)
    gid = np.array([0, 1, 5, 6], np.int32)
    right = np.array([True, False, True, False])
    got = tev.ring_neighbor(torch.from_numpy(gid), torch.from_numpy(right), 7)
    want = jev.ring_neighbor(jnp.asarray(gid), jnp.asarray(right), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tev.ring_neighbor(np.int32(0), False, 7) == \
        jev.ring_neighbor(np.int32(0), False, 7)


@pytest.mark.parametrize("go_right", [True, False, np.bool_(True)])
def test_ring_neighbor_of_a_tensor_with_a_host_bool(go_right):
    gid = np.array([0, 1, 5, 6], np.int32)
    got = tev.ring_neighbor(torch.from_numpy(gid), go_right, 7)
    want = jev.ring_neighbor(jnp.asarray(gid), bool(go_right), 7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _batches(n=40, seed=3):
    rng = np.random.default_rng(seed)
    cols = dict(dst=rng.integers(0, 9, n, dtype=np.int32),
                ts=rng.random(n).astype(np.float32),
                seed=rng.integers(0, 2**32, n, dtype=np.uint32),
                payload=rng.random(n).astype(np.float32),
                valid=rng.random(n) < 0.6)
    jb = jev.EventBatch(*(jnp.asarray(v) for v in cols.values()))
    tb = tev.EventBatch(*(torch.from_numpy(v.astype(np.int64)) if k == "seed"
                          else torch.from_numpy(v) for k, v in cols.items()))
    return jb, tb, rng


def _assert_batch_equal(tb, jb):
    for name, t, j in zip(tev.EventBatch._fields, tb, jb):
        t = t.numpy()
        if name == "seed":
            t = t.astype(np.uint32)
        np.testing.assert_array_equal(t, np.asarray(j), err_msg=name)


def test_compact_concat_truncate_match_jax():
    jb, tb, rng = _batches()
    mask = rng.random(40) < 0.5
    _assert_batch_equal(tev.compact_mask(tb, torch.from_numpy(mask)),
                        jev.compact_mask(jb, jnp.asarray(mask)))
    _assert_batch_equal(tev.compact(tb), jev.compact(jb))
    _assert_batch_equal(tev.concat_batches(tb, tb),
                        jev.concat_batches(jb, jb))
    _assert_batch_equal(tev.truncate(tb, 7), jev.truncate(jb, 7))
    assert int(tb.count()) == int(jb.count())


def test_empty_batch_matches_jax():
    _assert_batch_equal(tev.empty_batch(5, 2, device="cpu"),
                        jev.empty_batch(5, 2))
    assert tev.empty_batch(5, device="cpu").capacity == 5
