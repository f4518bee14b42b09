"""The port's PHOLD model against the JAX package's: bootstrap events,
initial object state, the batched ``process_events`` against
``jax.vmap(Phold.process_event)``, the stack allocator, and the numpy
mirrors.  Bit-exact, except emitted timestamps under ``exponential``
(rtol 1e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.phold import arena as jar  # noqa: E402
from repro.phold.model import Phold as JPhold  # noqa: E402
from repro.phold.model import PholdParams as JParams  # noqa: E402
from repro_torch.phold import arena as tar  # noqa: E402
from repro_torch.phold.model import Phold as TPhold  # noqa: E402
from repro_torch.phold.model import PholdParams as TParams  # noqa: E402

SMALL = dict(n_objects=16, initial_events=4, state_nodes=64,
             realloc_fraction=0.02, lookahead=0.5)


def _pair(**kw):
    p = dict(SMALL, **kw)
    return TPhold(TParams(**p)), JPhold(JParams(**p))


@pytest.mark.parametrize("kw", [dict(), dict(seed=3), dict(dist="uniform24"),
                                dict(dist="exponential", initial_events=7),
                                dict(hot_objects=4, hot_prob=100)])
def test_initial_events_match(kw):
    t, j = _pair(**kw)
    got, want = t.initial_events(), j.initial_events()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in t.initial_events(seed=5).items():
        np.testing.assert_array_equal(v, j.initial_events(seed=5)[k])


def test_init_object_state_matches():
    t, j = _pair(hot_objects=4, hot_prob=64)
    gids = np.array([0, 3, 15, 15, 7])
    got, want = t.init_object_state(gids, "cpu"), j.init_object_state(gids)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def _random_state(t, j, n, rng):
    p = t.params
    st = j.init_object_state(np.arange(n) % p.n_objects)
    st = {k: np.asarray(v).copy() for k, v in st.items()}
    st["payload"] = (rng.integers(0, 4096, st["payload"].shape)
                     / 1024.0).astype(np.float32)
    return st


@pytest.mark.parametrize("dist", ["dyadic", "uniform24", "exponential"])
@pytest.mark.parametrize("hot", [(0, 0), (4, 200)])
def test_process_events_matches_vmapped_jax(dist, hot):
    t, j = _pair(dist=dist, hot_objects=hot[0], hot_prob=hot[1])
    rng = np.random.default_rng(11)
    n = 24
    st = _random_state(t, j, n, rng)
    ts = (rng.integers(0, 512, n) / 64.0).astype(np.float32)
    seed = rng.integers(0, 2**32, n, dtype=np.uint32)
    pay = rng.random(n).astype(np.float32)
    for _ in range(3):   # chained: the second call sees the arena's writes
        tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
        got_st, got = t.process_events(tst, torch.from_numpy(ts),
                                       torch.from_numpy(seed.astype(np.int64)),
                                       torch.from_numpy(pay))
        want_st, want = jax.vmap(j.process_event)(
            {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(ts),
            jnp.asarray(seed), jnp.asarray(pay))
        for k in want_st:
            np.testing.assert_array_equal(got_st[k].numpy(),
                                          np.asarray(want_st[k]), err_msg=k)
        for name in ("dst", "seed", "payload", "valid"):
            g = getattr(got, name).numpy()
            if name == "seed":
                g = g.astype(np.uint32)
            np.testing.assert_array_equal(g, np.asarray(getattr(want, name)),
                                          err_msg=name)
        if dist == "exponential":
            np.testing.assert_allclose(got.ts.numpy(), np.asarray(want.ts),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(got.ts.numpy(), np.asarray(want.ts))
        # the input state is left unchanged
        np.testing.assert_array_equal(tst["payload"].numpy(), st["payload"])
        st = {k: np.asarray(v).copy() for k, v in want_st.items()}
        seed = np.asarray(want.seed)[:, 0]


def test_arena_matches_jax():
    rng = np.random.default_rng(2)
    n, S, k = 5, 32, 3
    addr = np.stack([rng.permutation(S).astype(np.int32) for _ in range(n)])
    # top 2 and 0 free below slot 0: like JAX, those positions wrap to the end
    top = np.array([S, S - 1, 10, 2, 0], np.int32)
    idxs = rng.integers(0, S, (n, k), dtype=np.int32)
    ta = tar.free_k(tar.Arena(torch.from_numpy(addr), torch.from_numpy(top)),
                    torch.from_numpy(idxs))
    ja = jax.vmap(jar.free_k)(jar.Arena(jnp.asarray(addr), jnp.asarray(top)),
                              jnp.asarray(idxs))
    np.testing.assert_array_equal(ta.addresses.numpy(), np.asarray(ja.addresses))
    np.testing.assert_array_equal(ta.top.numpy(), np.asarray(ja.top))
    ta2, tvals = tar.alloc_k(ta, k)
    ja2, jvals = jax.vmap(lambda a: jar.alloc_k(a, k))(ja)
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(ta2.top.numpy(), np.asarray(ja2.top))
    a0 = tar.arena_init(3, 8, "cpu")
    np.testing.assert_array_equal(a0.addresses.numpy()[1], np.arange(8))
    np.testing.assert_array_equal(a0.top.numpy(), [8, 8, 8])


@pytest.mark.parametrize("dist", ["dyadic", "exponential"])
def test_numpy_mirrors_match(dist):
    t, j = _pair(dist=dist, hot_objects=4, hot_prob=128)
    ts_np = t.init_object_state_np(np.arange(4))
    js_np = j.init_object_state_np(np.arange(4))
    rng = np.random.default_rng(5)
    for _ in range(20):
        o = int(rng.integers(0, 4))
        ts_, seed = np.float32(rng.integers(0, 64) / 8), rng.integers(0, 2**32)
        a = t.process_event_np(ts_np[o], ts_, np.uint32(seed), np.float32(0))
        b = j.process_event_np(js_np[o], ts_, np.uint32(seed), np.float32(0))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == b[k] and np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    for x, y in zip(ts_np, js_np):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
