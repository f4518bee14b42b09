"""The port's loan math against the JAX package's on seeded load vectors
with ties: the donor's choice (a stable top-k: ties in index order, as
``jax.lax.top_k`` keeps them), the replicated plan, and the row
gather/scatter of a loan."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import stealing as jst  # noqa: E402
from repro_torch.core import stealing as tst  # noqa: E402


def _select_both(cnt, load, target, sc):
    j = jst.select_loans(jnp.asarray(cnt), jnp.int32(load), jnp.int32(target),
                         sc)
    t = tst.select_loans(torch.from_numpy(cnt), torch.tensor(load),
                         torch.tensor(target), sc)
    return j, t


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("sc", [1, 2, 4])
def test_select_loans_matches_jax_with_ties(seed, sc):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(sc, 24))
    # few distinct values: ties between the hottest rows on purpose.
    cnt = rng.choice([0, 1, 3, 3, 5, 5, 5], n).astype(np.int32)
    load = int(cnt.sum())
    for target in (0, load // 3, load // 2, load, load + 1):
        (ji, jw, jv), (ti, tw, tv) = _select_both(cnt, load, target, sc)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_select_loans_breaks_ties_by_row_index():
    cnt = np.array([2, 7, 7, 1, 7, 7], np.int32)
    (ji, _, _), (ti, _, _) = _select_both(cnt, 31, 5, 3)
    assert ti.tolist() == np.asarray(ji).tolist() == [1, 2, 4]


@settings(max_examples=80, deadline=None)
@given(st.lists(st.integers(0, 100), min_size=2, max_size=8),
       st.integers(1, 4), st.integers(1, 3), st.integers(0, 2**16))
def test_plan_loans_matches_jax(loads, claim_cap, steal_cap, seed):
    rng = np.random.default_rng(seed)
    D = len(loads)
    w = rng.integers(0, 4, (D, steal_cap)).astype(np.int32)
    valid = rng.random((D, steal_cap)) < 0.8
    j = jst.plan_loans(jnp.asarray(loads, jnp.int32), jnp.asarray(w),
                       jnp.asarray(valid), claim_cap)
    t = tst.plan_loans(torch.tensor(loads, dtype=torch.int32),
                       torch.from_numpy(w), torch.from_numpy(valid),
                       claim_cap)
    np.testing.assert_array_equal(t.assignee.numpy(), np.asarray(j.assignee))
    np.testing.assert_array_equal(t.claimed.numpy(), np.asarray(j.claimed))


@pytest.mark.parametrize("seed", range(3))
def test_gather_and_scatter_rows_match_jax(seed):
    rng = np.random.default_rng(seed)
    n, k = 10, 4
    tree = {"a": rng.random((n, 3)).astype(np.float32),
            "b": rng.integers(0, 9, n).astype(np.int32)}
    idx = rng.permutation(n)[:k].astype(np.int32)
    mask = rng.random(k) < 0.6
    rows = {"a": rng.random((k, 3)).astype(np.float32),
            "b": rng.integers(10, 20, k).astype(np.int32)}
    jt = {x: jnp.asarray(v) for x, v in tree.items()}
    tt = {x: torch.from_numpy(v) for x, v in tree.items()}
    jg = jst.gather_rows(jt, jnp.asarray(idx))
    tg = tst.gather_rows(tt, torch.from_numpy(idx))
    js = jst.scatter_rows(jt, jnp.asarray(idx),
                          {x: jnp.asarray(v) for x, v in rows.items()},
                          jnp.asarray(mask))
    ts = tst.scatter_rows(tt, torch.from_numpy(idx),
                          {x: torch.from_numpy(v) for x, v in rows.items()},
                          torch.from_numpy(mask))
    for x in tree:
        np.testing.assert_array_equal(tg[x].numpy(), np.asarray(jg[x]))
        np.testing.assert_array_equal(ts[x].numpy(), np.asarray(js[x]))
    np.testing.assert_array_equal(tt["b"].numpy(), tree["b"])  # functional
