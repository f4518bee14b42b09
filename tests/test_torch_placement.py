"""The port's placement, the adaptive rebalance's boundary cut, the a2a
router's selection and the delivery's out-of-bounds rule, against the JAX
package's functions on seeded inputs (in process, no second device: the
a2a selection of D devices is a pure function of the placement)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import calendar as jcal  # noqa: E402
from repro.core import events as jev  # noqa: E402
from repro.core import placement as jpl  # noqa: E402
from repro.core.engine import EngineConfig as JConfig  # noqa: E402
from repro.core.pipeline import routers as jrouters  # noqa: E402
from repro.core.pipeline.deliver import deliver as jdeliver  # noqa: E402
from repro.core.pipeline.rebalance import \
    _quantile_boundaries as jquantile  # noqa: E402
from repro_torch.core import calendar as tcal  # noqa: E402
from repro_torch.core import events as tev  # noqa: E402
from repro_torch.core import placement as tpl  # noqa: E402
from repro_torch.core.engine import EngineConfig as TConfig  # noqa: E402
from repro_torch.core.pipeline import routers as trouters  # noqa: E402
from repro_torch.core.pipeline.deliver import deliver as tdeliver  # noqa: E402
from repro_torch.core.pipeline.rebalance import (  # noqa: E402
    EXACT_F32_LOAD, _quantile_boundaries as tquantile)


def _same_placement(t, j):
    np.testing.assert_array_equal(np.asarray(t.boundaries),
                                  np.asarray(j.boundaries))
    assert (t.n_objects, t.n_devices, t.n_local_max) == \
        (j.n_objects, j.n_devices, j.n_local_max)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(st.just(0.0), st.floats(0.0, 100.0)),
                min_size=4, max_size=64),
       st.integers(1, 8), st.integers(0, 64))
def test_weighted_placement_matches_jax(weights, n_devices, n_zero_prefix):
    weights = [0.0] * min(n_zero_prefix, len(weights) - 1) \
        + weights[min(n_zero_prefix, len(weights) - 1):]
    t = tpl.weighted_placement(weights, n_devices)
    _same_placement(t, jpl.weighted_placement(weights, n_devices))
    assert t.counts().sum() == len(weights)
    np.testing.assert_array_equal(
        t.owner_np(np.arange(len(weights))),
        jpl.weighted_placement(weights, n_devices).owner_np(
            np.arange(len(weights))))


@pytest.mark.parametrize("weights", [
    [0.0] * 8, [1e-18] * 8, [0.0, 0.0, 0.0, 1e-300], [np.nan, 1.0, 1.0, 1.0],
    [np.inf, 1.0, 1.0, 1.0], [-1.0, 2.0, 2.0, 2.0]])
def test_weighted_placement_degenerate_weights_split_equally(weights):
    for D in (1, 2, 3, 4):
        t = tpl.weighted_placement(weights, D)
        _same_placement(t, jpl.weighted_placement(weights, D))
        _same_placement(t, tpl.equal_placement(len(weights), D))


@pytest.mark.parametrize("O,D,pad", [(16, 4, 8), (18, 4, 9), (5, 3, 2),
                                     (7, 4, 4), (3, 4, 1)])
def test_padded_layout_matches_jax(O, D, pad):
    t = tpl.equal_placement(O, D)
    j = jpl.equal_placement(O, D)
    _same_placement(t, j)
    pad = max(pad, t.n_local_max)
    tp, jp = t.padded(pad), j.padded(pad)
    _same_placement(tp, jp)
    np.testing.assert_array_equal(tp.padded_gids(), jp.padded_gids())
    np.testing.assert_array_equal(tp.counts(), jp.counts())
    dst = np.arange(-1, O + 1, dtype=np.int32)
    np.testing.assert_array_equal(tp.owner_np(dst), jp.owner_np(dst))
    own_t = tp.owner(torch.from_numpy(dst))
    np.testing.assert_array_equal(own_t.numpy(), np.asarray(
        jp.owner(jnp.asarray(dst))))
    ok = (dst >= 0) & (dst < O)
    np.testing.assert_array_equal(
        tp.local_index(torch.from_numpy(dst[ok]), own_t[ok]).numpy(),
        np.asarray(jp.local_index(jnp.asarray(dst[ok]),
                                  jnp.asarray(own_t[ok].numpy()))))
    with pytest.raises(ValueError, match="pad"):
        t.padded(t.n_local_max - 1)


@pytest.mark.parametrize("trial", range(12))
def test_quantile_boundaries_match_jax(trial):
    rng = np.random.default_rng(trial)
    D = int(rng.integers(2, 7))
    O = int(rng.integers(D, 65))
    eq = tpl.equal_placement(O, D)
    M = min(O, int(np.ceil(O / D * 2.0)))
    shift_cap = int(rng.integers(1, 9))
    bounds = eq.boundaries.astype(np.int32)
    for load in (rng.integers(0, 50, O), np.zeros(O, np.int64),
                 np.where(rng.random(O) < 0.2, rng.integers(0, 10**5, O), 0)):
        load = load.astype(np.int32)
        want = np.asarray(jquantile(jnp.asarray(load), jnp.asarray(bounds),
                                    D, M, O, jnp.int32(shift_cap)))
        got = tquantile(torch.from_numpy(load), torch.from_numpy(bounds),
                        D, M, O, shift_cap).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[0] == 0 and got[-1] == O and np.all(np.diff(got) >= 0)
        assert np.all(np.diff(got) <= M)


def test_quantile_cut_at_the_top_of_the_exact_range_matches_jax():
    # integer loads summing to 2**24 - 1, the largest total whose f32
    # prefix sum is exact in any order of the additions.
    O, D = 32, 4
    rng = np.random.default_rng(5)
    load = rng.integers(0, 2 * (EXACT_F32_LOAD // O), O).astype(np.int64)
    load[7] += (EXACT_F32_LOAD - 1) - load.sum()
    assert load.sum() == EXACT_F32_LOAD - 1 and load.min() >= 0
    bounds = tpl.equal_placement(O, D).boundaries.astype(np.int32)
    got = tquantile(torch.from_numpy(load), torch.from_numpy(bounds), D, O,
                    O, 64).numpy()
    want = np.asarray(jquantile(jnp.asarray(load.astype(np.int32)),
                                jnp.asarray(bounds), D, O, O, jnp.int32(64)))
    np.testing.assert_array_equal(got, want)


def _random_prod(rng, E, O, epoch_hi):
    dst = rng.integers(-2, O + 2, E).astype(np.int32)
    ts = (rng.integers(0, epoch_hi * 4, E) / 8.0).astype(np.float32)
    seed = rng.integers(0, 2**32, E, dtype=np.uint32)
    pay = rng.random(E).astype(np.float32)
    valid = rng.random(E) < 0.85
    return dst, ts, seed, pay, valid


@pytest.mark.parametrize("D,route_cap,seed", [(2, 8, 0), (4, 16, 1),
                                              (4, 4, 2), (3, 12, 3)])
def test_a2a_select_send_matches_jax(D, route_cap, seed):
    rng = np.random.default_rng(seed)
    O, E = 24, 40
    dst, ts, sd, pay, valid = _random_prod(rng, E, O, 8)
    eligible = valid & (dst >= 0) & (dst < O) & (rng.random(E) < 0.9)
    tcfg = TConfig(lookahead=0.5, route="a2a", route_cap=route_cap)
    jcfg = JConfig(lookahead=0.5, route="a2a", route_cap=route_cap)
    jp, tp = jpl.equal_placement(O, D), tpl.equal_placement(O, D)
    jb, js, jo = jrouters.AllToAllRouter().select_send(
        jev.EventBatch(jnp.asarray(dst), jnp.asarray(ts), jnp.asarray(sd),
                       jnp.asarray(pay), jnp.asarray(valid)),
        jnp.asarray(eligible), jp, jcfg)
    tb, ts_, to = trouters.AllToAllRouter().select_send(
        tev.EventBatch(torch.from_numpy(dst)[None], torch.from_numpy(ts)[None],
                       torch.from_numpy(sd.astype(np.int64))[None],
                       torch.from_numpy(pay)[None],
                       torch.from_numpy(valid)[None]),
        torch.from_numpy(eligible)[None], tp, tcfg)
    for f in ("dst", "ts", "payload", "valid"):
        np.testing.assert_array_equal(getattr(tb, f)[0].numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    np.testing.assert_array_equal(tb.seed[0].numpy().astype(np.uint32),
                                  np.asarray(jb.seed))
    np.testing.assert_array_equal(ts_[0].numpy(), np.asarray(js))
    assert int(to[0]) == int(jo)
    # provenance of the exchanged slots, as the reference lays them out
    np.testing.assert_array_equal(
        trouters.AllToAllRouter().sender_ids(tp, tcfg, "cpu").numpy(),
        np.asarray(jrouters.AllToAllRouter().sender_ids(jp, jcfg)))
    np.testing.assert_array_equal(
        trouters.AllGatherRouter().sender_ids(tp, tcfg, "cpu").numpy(),
        np.asarray(jrouters.AllGatherRouter().sender_ids(jp, jcfg)))


@pytest.mark.parametrize("replicated", [True, False])
@pytest.mark.parametrize("dev", [0, 1, 3])
def test_deliver_counts_oob_once_or_where_it_lands(replicated, dev):
    # an oob event in a replicated batch is counted on device 0 only; in a
    # device's own (a2a) slice, on the device it reached.
    rng = np.random.default_rng(dev)
    D, O, N, C, F = 4, 16, 8, 16, 16
    pl = tpl.equal_placement(O, D)
    M = pl.n_local_max
    dst, ts, sd, pay, valid = _random_prod(rng, 24, O, 6)
    dst[:3] = [O + 5, -1, O]
    valid[:3] = True
    tcfg = TConfig(lookahead=0.5, n_buckets=N, bucket_cap=C, fallback_cap=F)
    jcfg = JConfig(lookahead=0.5, n_buckets=N, bucket_cap=C, fallback_cap=F)
    jc, jf = jcal.make_calendar(M, N, C), jcal.make_fallback(F)
    j = jdeliver(jc, jf, jev.EventBatch(
        jnp.asarray(dst), jnp.asarray(ts), jnp.asarray(sd), jnp.asarray(pay),
        jnp.asarray(valid)), jnp.int32(0), jnp.int32(dev),
        jpl.equal_placement(O, D), jcfg,
        init=False, replicated=replicated)
    t = tdeliver(tcal.make_calendar(M, N, C, "cpu"),
                 tcal.Fallback(tev.EventBatch(*(
                     x[None] for x in tcal.make_fallback(F, "cpu").events))),
                 tev.EventBatch(torch.from_numpy(dst)[None],
                                torch.from_numpy(ts)[None],
                                torch.from_numpy(sd.astype(np.int64))[None],
                                torch.from_numpy(pay)[None],
                                torch.from_numpy(valid)[None]),
                 torch.zeros(1, dtype=torch.int32), dev, pl, tcfg,
                 init=False, replicated=replicated)
    n_oob = int(np.sum(valid & ((dst < 0) | (dst >= O))))
    assert n_oob >= 3
    assert int(t[5][0]) == int(j[5]) == (n_oob if (dev == 0 or not replicated)
                                         else 0)
    for k in (2, 3, 4):
        assert int(t[k][0]) == int(j[k])
    np.testing.assert_array_equal(t[0].cnt.numpy(), np.asarray(j[0].cnt))
    np.testing.assert_array_equal(t[0].ts.numpy(), np.asarray(j[0].ts))
    np.testing.assert_array_equal(t[1].events.valid[0].numpy(),
                                  np.asarray(j[1].events.valid))


@pytest.mark.parametrize("config", ["adaptive", "spec-adaptive"])
def test_one_device_adaptive_stack_equals_the_jax_replicated_drain(config):
    # on one device an adaptive firing moves nothing but resets the load
    # and counts, each replication of a stack at its own epochs, with no
    # host read: the stack against the JAX package's replicated drain,
    # leaf by leaf.
    import jax
    from repro.core import engine as jeng
    from repro.testing.conformance import SWEEP as JSWEEP
    from repro.workloads import registry as jreg
    from repro_torch.core import engine as teng
    from repro_torch.testing import conformance as tconf
    from repro_torch.workloads import registry as treg
    from test_torch_drain import _assert_trees_equal, _host
    name, R = "phold-hotspot", 3
    spec = jreg.conformance_spec(name)
    jm = jreg.get_workload(name, **spec["model_kw"])
    je = jeng.ParsirEngine(jm, JConfig(lookahead=0.5, **spec["engine_kw"],
                                       **JSWEEP[config]))
    want = jax.device_get(je.run_replicated_drained(
        je.init_replicated(range(R)), spec["n_epochs"]))
    tm = treg.get_workload(name, **spec["model_kw"])
    te = teng.ParsirEngine(tm, TConfig(lookahead=0.5, **spec["engine_kw"],
                                       **tconf.SWEEP[config]), device="cpu")
    got = te.run_replicated_drained(te.init_replicated(range(R)),
                                    spec["n_epochs"])
    _assert_trees_equal(_host(got), want, f"{config} R={R} vs JAX")
    assert all(t["rebalances"] > 0 for t in te.totals_replicated(got))
