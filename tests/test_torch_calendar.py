"""The port's calendar multi-queue against the JAX package's, on random
batches (ring reuse, conflict-free insert with overflow, (ts, seed)-sorted
extraction with seeds >= 2**31, the fallback list).  Bit-exact: every
array of the resulting calendars is compared, stale slots included."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import calendar as jcal  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro_torch.core import calendar as tcal  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402


def _to_jax_cal(tc):
    return jcal.Calendar(jnp.asarray(tc.ts.numpy()),
                         jnp.asarray(tc.seed.numpy().astype(np.uint32)),
                         jnp.asarray(tc.payload.numpy()),
                         jnp.asarray(tc.cnt.numpy()))


def _assert_cal_equal(tc, jc):
    np.testing.assert_array_equal(tc.ts.numpy(), np.asarray(jc.ts))
    np.testing.assert_array_equal(tc.seed.numpy().astype(np.uint32),
                                  np.asarray(jc.seed))
    np.testing.assert_array_equal(tc.payload.numpy(), np.asarray(jc.payload))
    np.testing.assert_array_equal(tc.cnt.numpy(), np.asarray(jc.cnt))


def _random_events(rng, k, n_local, n_buckets, ts_grid=True):
    li = rng.integers(0, n_local, k, dtype=np.int32)
    ep = rng.integers(0, 3 * n_buckets, k, dtype=np.int32)
    # dyadic timestamps inside each event's epoch; duplicates on purpose so
    # the seed tie-break is exercised.
    ts = (ep + rng.integers(0, 4, k) / 4.0).astype(np.float32) if ts_grid \
        else (ep + rng.random(k)).astype(np.float32)
    seed = rng.integers(0, 2**32, k, dtype=np.uint32)
    seed[: k // 3] |= np.uint32(0x80000000)       # seeds >= 2**31
    pay = rng.random(k).astype(np.float32)
    valid = rng.random(k) < 0.8
    return li, ep, ts, seed, pay, valid


def _insert_both(tc, jc, ev):
    li, ep, ts, seed, pay, valid = ev
    tc, tovf = tcal.insert(tc, torch.from_numpy(li), torch.from_numpy(ep),
                           torch.from_numpy(ts),
                           torch.from_numpy(seed.astype(np.int64)),
                           torch.from_numpy(pay), torch.from_numpy(valid))
    jc, jovf = jcal.insert(jc, jnp.asarray(li), jnp.asarray(ep),
                           jnp.asarray(ts), jnp.asarray(seed),
                           jnp.asarray(pay), jnp.asarray(valid))
    return tc, jc, int(tovf), int(jovf)


@pytest.mark.parametrize("seed,cap,k", [(0, 8, 40), (1, 3, 60), (2, 16, 10),
                                        (3, 2, 80)])
def test_insert_matches_jax_with_overflow(seed, cap, k):
    rng = np.random.default_rng(seed)
    n_local, n_buckets = 5, 4
    tc = tcal.make_calendar(n_local, n_buckets, cap, "cpu")
    jc = jcal.make_calendar(n_local, n_buckets, cap)
    total_ovf = 0
    for _ in range(3):
        tc, jc, tovf, jovf = _insert_both(
            tc, jc, _random_events(rng, k, n_local, n_buckets))
        assert tovf == jovf
        total_ovf += tovf
        _assert_cal_equal(tc, jc)
    if cap <= 3:
        assert total_ovf > 0      # the small caps really overflow


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_sorted_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_local, n_buckets, cap = 6, 4, 12
    tc = tcal.make_calendar(n_local, n_buckets, cap, "cpu")
    jc = jcal.make_calendar(n_local, n_buckets, cap)
    tc, jc, _, _ = _insert_both(
        tc, jc, _random_events(rng, 60, n_local, n_buckets))
    for epoch in range(2 * n_buckets):
        tres = tcal.extract_sorted(tc, torch.tensor(epoch, dtype=torch.int32))
        jres = jcal.extract_sorted(jc, jnp.int32(epoch))
        tc, jc = tres[0], jres[0]
        _assert_cal_equal(tc, jc)
        t_ts, t_seed, t_pay, t_cnt = (x.numpy() for x in tres[1:])
        j_ts, j_seed, j_pay, j_cnt = (np.asarray(x) for x in jres[1:])
        np.testing.assert_array_equal(t_ts, j_ts)
        np.testing.assert_array_equal(t_seed.astype(np.uint32), j_seed)
        np.testing.assert_array_equal(t_pay, j_pay)
        np.testing.assert_array_equal(t_cnt, j_cnt)
        np.testing.assert_array_equal(
            tcal.bucket_occupancy(tc, torch.tensor(epoch + 1)).numpy(),
            np.asarray(jcal.bucket_occupancy(jc, jnp.int32(epoch + 1))))


def test_extract_orders_large_seeds_unsigned():
    # equal timestamps: 0x80000000 must sort after 5 (an i32 view would not).
    tc = tcal.make_calendar(1, 2, 8, "cpu")
    seeds = np.array([0x80000000, 5, 0xFFFFFFFF, 0x7FFFFFFF], np.uint32)
    tc, ovf = tcal.insert(
        tc, torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
        torch.ones(4), torch.from_numpy(seeds.astype(np.int64)),
        torch.zeros(4), torch.ones(4, dtype=torch.bool))
    _, _, seed_s, _, cnt = tcal.extract_sorted(tc, torch.tensor(0))
    assert int(ovf) == 0 and int(cnt[0]) == 4
    np.testing.assert_array_equal(seed_s[0, :4].numpy(),
                                  [5, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF])


@pytest.mark.parametrize("seed", [0, 1])
def test_group_ranks_matches_jax(seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 7, 50, dtype=np.int32)
    valid = rng.random(50) < 0.7
    t = tcal.group_ranks(torch.from_numpy(key), torch.from_numpy(valid), 7)
    j = jcal.group_ranks(jnp.asarray(key), jnp.asarray(valid), 7)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _fb_batch(rng, n):
    cols = dict(dst=rng.integers(0, 9, n, dtype=np.int32),
                ts=rng.random(n).astype(np.float32),
                seed=rng.integers(0, 2**32, n, dtype=np.uint32),
                payload=rng.random(n).astype(np.float32),
                valid=rng.random(n) < 0.6)
    tb = tev.EventBatch(*(torch.from_numpy(v.astype(np.int64)) if k == "seed"
                          else torch.from_numpy(v) for k, v in cols.items()))
    jb = jev.EventBatch(*(jnp.asarray(v) for v in cols.values()))
    return tb, jb


@pytest.mark.parametrize("cap,n", [(4, 6), (8, 20), (16, 5)])
def test_fallback_put_matches_jax(cap, n):
    rng = np.random.default_rng(cap)
    tfb, jfb = tcal.make_fallback(cap, "cpu"), jcal.make_fallback(cap)
    for _ in range(3):
        tb, jb = _fb_batch(rng, n)
        tfb, tovf = tcal.fallback_put(tfb, tb)
        jfb, jovf = jcal.fallback_put(jfb, jb)
        assert int(tovf) == int(jovf)
        for name, a, b in zip(tev.EventBatch._fields, tfb.events, jfb.events):
            a = a.numpy()
            if name == "seed":
                a = a.astype(np.uint32)
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_ring_reuse_and_invalid_events():
    N, cap = 4, 4
    cal = tcal.make_calendar(2, N, cap, "cpu")
    one = lambda *v, dt=torch.float32: torch.tensor(v, dtype=dt)  # noqa: E731
    cal, _ = tcal.insert(cal, one(0, 1, dt=torch.int32), one(0, 0, dt=torch.int32),
                         one(0.5, 0.5), one(1, 2, dt=torch.int64), one(0, 0),
                         one(True, False, dt=torch.bool))
    assert int(cal.cnt.sum()) == 1
    cal, ts_s, _, _, cnt = tcal.extract_sorted(cal, torch.tensor(0))
    assert int(cnt[0]) == 1 and int(cal.cnt.sum()) == 0
    cal, ovf = tcal.insert(cal, one(0, dt=torch.int32), one(N, dt=torch.int32),
                           one(N + 0.5), one(3, dt=torch.int64), one(0),
                           one(True, dt=torch.bool))
    assert int(ovf) == 0
    _, ts_s, seed_s, _, cnt = tcal.extract_sorted(cal, torch.tensor(N))
    assert int(cnt[0]) == 1 and float(ts_s[0, 0]) == N + 0.5
    assert int(seed_s[0, 0]) == 3


@pytest.mark.parametrize("first,n", [(0, 2), (3, 3), (6, 4), (13, 5)])
def test_take_and_put_buckets_match_jax(first, n):
    """The speculation window's shadow: take_buckets gathers n buckets from
    ``first`` in window order (wrapping round the ring) as the JAX package
    does; damaging them and putting the shadow back restores the window
    and leaves every other bucket as the damage left it."""
    rng = np.random.default_rng(first + 10 * n)
    n_local, n_buckets, cap = 5, 6, 8
    tc = tcal.make_calendar(n_local, n_buckets, cap, "cpu")
    jc = jcal.make_calendar(n_local, n_buckets, cap)
    tc, jc, _, _ = _insert_both(
        tc, jc, _random_events(rng, 70, n_local, n_buckets))
    first_t = torch.tensor(first, dtype=torch.int32)
    shadow = tcal.take_buckets(tc, first_t, n)
    jshadow = jcal.take_buckets(jc, jnp.int32(first), n)
    _assert_cal_equal(shadow, jshadow)
    assert tuple(shadow.ts.shape) == (n_local, n, cap)
    # damage: drain every bucket, then insert a second batch.
    for e in range(n_buckets):
        tc = tcal.extract_sorted(tc, torch.tensor(e))[0]
        jc = jcal.extract_sorted(jc, jnp.int32(e))[0]
    tc, jc, _, _ = _insert_both(
        tc, jc, _random_events(rng, 40, n_local, n_buckets))
    damaged = tc
    tc = tcal.put_buckets(tc, first_t, shadow)
    jc = jcal.put_buckets(jc, jnp.int32(first), jshadow)
    _assert_cal_equal(tc, jc)
    window = [(first + w) % n_buckets for w in range(n)]
    for b in range(n_buckets):
        src = shadow if b in window else damaged
        i = window.index(b) if b in window else b
        for x, y in zip(tc, src):
            assert torch.equal(x[:, b], y[:, i]), b


def test_take_and_put_buckets_per_row_epochs():
    """Stacked replications hand the [R * M] view with one first epoch per
    row: each row's window starts at its own epoch."""
    rng = np.random.default_rng(5)
    n_local, n_buckets, cap = 6, 5, 4
    tc = tcal.make_calendar(n_local, n_buckets, cap, "cpu")
    jc = jcal.make_calendar(n_local, n_buckets, cap)
    tc, _, _, _ = _insert_both(
        tc, jc, _random_events(rng, 50, n_local, n_buckets))
    firsts = torch.tensor([0, 0, 0, 3, 3, 3], dtype=torch.int32)
    got = tcal.take_buckets(tc, firsts, 2)
    for r in range(n_local):
        one = tcal.take_buckets(tcal.Calendar(*(x[r:r + 1] for x in tc)),
                                firsts[r], 2)
        for x, y in zip(got, one):
            assert torch.equal(x[r:r + 1], y)
    back = tcal.put_buckets(tcal.make_calendar(n_local, n_buckets, cap,
                                               "cpu"), firsts, got)
    assert torch.equal(tcal.take_buckets(back, firsts, 2).cnt, got.cnt)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_extract_leaves_rows_out(seed):
    """extract_sorted with ``take``: the rows taken equal the unmasked
    extract; a row left out reads a count of 0 and +inf timestamps, and
    keeps its bucket as it was."""
    rng = np.random.default_rng(seed)
    n_local, n_buckets, cap = 6, 4, 12
    tc = tcal.make_calendar(n_local, n_buckets, cap, "cpu")
    jc = jcal.make_calendar(n_local, n_buckets, cap)
    tc, _, _, _ = _insert_both(
        tc, jc, _random_events(rng, 60, n_local, n_buckets))
    take = torch.tensor([True, False, True, True, False, False])
    epoch = torch.tensor(1, dtype=torch.int32)
    full = tcal.extract_sorted(tc, epoch)
    part = tcal.extract_sorted(tc, epoch, take)
    for x, y, z in zip(part[0], full[0], tc):
        assert torch.equal(x[take], y[take])
        assert torch.equal(x[~take], z[~take])
    for x, y in zip(part[1:], full[1:]):
        assert torch.equal(x[take], y[take])
    assert not part[4][~take].any() and part[1][~take].isinf().all()
    assert int(full[4][~take].sum()) > 0     # there was something to keep
    every = tcal.extract_sorted(tc, epoch, torch.ones(n_local, dtype=bool))
    for x, y in zip(every[0] + tuple(every[1:]), full[0] + tuple(full[1:])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_take_put_and_clear_rows_match_jax(seed):
    """The migration's row moves: whole rows gathered (take_rows), put in
    place where a mask holds and dropped elsewhere (put_rows), and rows
    deadened (clear_rows: counts 0, +inf timestamps), as the JAX package
    does, on calendars with live events; the input calendar unchanged."""
    rng = np.random.default_rng(seed)
    n_local, n_buckets, cap, k = 7, 4, 6, 5
    tc = tcal.make_calendar(n_local, n_buckets, cap, "cpu")
    jc = jcal.make_calendar(n_local, n_buckets, cap)
    tc, jc, _, _ = _insert_both(
        tc, jc, _random_events(rng, 60, n_local, n_buckets))
    before = [x.clone() for x in tc]
    src = rng.integers(0, n_local, k).astype(np.int32)
    rows_t = tcal.take_rows(tc, torch.from_numpy(src))
    rows_j = jcal.take_rows(jc, jnp.asarray(src))
    _assert_cal_equal(rows_t, rows_j)
    dst = rng.permutation(n_local)[:k].astype(np.int32)
    mask = rng.random(k) < 0.6
    mask[0] = True
    put_t = tcal.put_rows(tc, torch.from_numpy(dst), rows_t,
                          torch.from_numpy(mask))
    put_j = jcal.put_rows(jc, jnp.asarray(dst), rows_j, jnp.asarray(mask))
    _assert_cal_equal(put_t, put_j)
    dead = rng.random(n_local) < 0.4
    _assert_cal_equal(tcal.clear_rows(put_t, torch.from_numpy(dead)),
                      jcal.clear_rows(put_j, jnp.asarray(dead)))
    for x, y in zip(tc, before):
        assert torch.equal(x, y)
