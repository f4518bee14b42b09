"""The port's width-packed (``batch-packed``) and ``ltf`` schedulers against
the JAX package's.

* the packer (``pack_slice`` / ``unpack_slice``): the three properties of
  ``tests/test_property.py`` (round trip, multiset and per-object order, no
  tile mixing rounds) under hypothesis, each with an always-run direct
  case, and every field of the packed slice equal to the JAX packer's on
  the same seeded numpy slice;
* the edge cases of ``tests/test_pipeline.py``: empty, single-row, full and
  ragged slices, zero and three rows through every scheduler, a
  ``pack_tile`` sweep against the rounds loop, ``occupancy``;
* all seven workloads' conformance recipes under ``ltf`` and
  ``batch-packed``, against ``run_sequential`` and, leaf by leaf (calendar
  slots and fallback order included), the JAX engine under the same
  scheduler;
* configuration: ltf and packed accepted, the JAX rejections kept; one
  host read per epoch under both.

Their card-only twin is in ``tests/test_torch_graphs.py`` (no JAX there).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.pipeline.config import EngineConfig as JConfig  # noqa: E402
from repro.core.pipeline.packing import pack_slice as jpack_slice  # noqa: E402
from repro.testing.fixtures import random_sorted_slice  # noqa: E402
from repro.workloads import registry as jreg  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.pipeline.config import EngineConfig as TConfig  # noqa: E402
from repro_torch.core.pipeline.packing import (pack_capacity, pack_slice,  # noqa: E402
                                               unpack_slice)
from repro_torch.core.pipeline.schedulers import (  # noqa: E402
    LtfScheduler, process_batch_packed, process_batch_rounds)
from repro_torch.testing import conformance as tconf  # noqa: E402
from repro_torch.workloads import registry as treg  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:       # the direct cases below still run
    HAVE_HYPOTHESIS = False

CAP = 6


def _tslice(ts, seed, pay, cnt):
    return (torch.from_numpy(ts), torch.from_numpy(seed.astype(np.int64)),
            torch.from_numpy(pay), torch.from_numpy(cnt))


def _pack_both(cnts, tile, vseed, cap=CAP):
    """The port's and the JAX packer's output on one seeded slice, every
    field held equal; returns the port's slice and the numpy inputs."""
    ts, seed, pay, cnt, live = random_sorted_slice(cnts, vseed, cap)
    p = pack_slice(*_tslice(ts, seed, pay, cnt), tile)
    q = jpack_slice(jnp.asarray(ts), jnp.asarray(seed), jnp.asarray(pay),
                    jnp.asarray(cnt), tile)
    assert p.tile == q.tile and int(p.n_tiles) == int(q.n_tiles)
    assert p.ts.shape[0] == pack_capacity(len(cnts), cap, tile)
    for f in ("ts", "seed", "payload", "row", "rnd", "valid"):
        got, want = getattr(p, f).numpy(), np.asarray(getattr(q, f))
        if f == "seed":
            got = got.astype(np.uint32)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    return p, (ts, seed, pay, cnt, live)


def _check_roundtrip(cnts, tile, vseed):
    p, (ts, seed, pay, cnt, live) = _pack_both(cnts, tile, vseed)
    uts, useed, upay, ucnt = unpack_slice(p, len(cnts), CAP)
    np.testing.assert_array_equal(ucnt.numpy(), cnt)
    np.testing.assert_array_equal(uts.numpy(), ts)
    np.testing.assert_array_equal(useed.numpy()[live], seed[live])
    np.testing.assert_array_equal(upay.numpy()[live], pay[live])


def _check_multiset_and_order(cnts, tile, vseed):
    p, (ts, seed, pay, cnt, live) = _pack_both(cnts, tile, vseed)
    v = p.valid.numpy()
    assert int(v.sum()) == int(cnt.sum())
    rows, rnds = p.row.numpy()[v], p.rnd.numpy()[v]
    seeds = p.seed.numpy()[v]
    got = sorted(zip(rows.tolist(), rnds.tolist(), seeds.tolist()))
    r, c = np.nonzero(live)
    want = sorted(zip(r.tolist(), c.tolist(), seed[live].tolist()))
    assert got == want
    key = rnds.astype(np.int64) * (len(cnts) + 1) + rows
    assert np.all(np.diff(key) > 0)


def _check_tiles_never_mix_rounds(cnts, tile, vseed):
    p, _ = _pack_both(cnts, tile, vseed)
    v = p.valid.numpy()
    k = np.nonzero(v)[0]
    assert k.size == 0 or k.max() < int(p.n_tiles) * p.tile
    rnds, rows = p.rnd.numpy()[v], p.row.numpy()[v]
    for t in np.unique(k // p.tile):
        in_tile = k // p.tile == t
        assert len(np.unique(rnds[in_tile])) == 1
        assert len(np.unique(rows[in_tile])) == in_tile.sum()


PROPERTIES = [_check_roundtrip, _check_multiset_and_order,
              _check_tiles_never_mix_rounds]
DIRECT = [([], 4, 0), ([0, 0, 0], 2, 1), ([6, 0, 3, 1, 6, 2], 3, 2),
          ([1] * 10, 12, 3), ([5, 4, 3, 2, 1, 0, 6], 1, 4),
          ([2, 6, 6, 0, 4, 1, 3, 5, 6, 2], 4, 5)]


@pytest.mark.parametrize("case", DIRECT, ids=[str(c) for c in DIRECT])
@pytest.mark.parametrize("prop", PROPERTIES, ids=lambda f: f.__name__[7:])
def test_packer_properties_direct(prop, case):
    prop(*case)


if HAVE_HYPOTHESIS:
    _pack_case = st.tuples(
        st.lists(st.integers(0, 6), min_size=0, max_size=10),  # cnt per row
        st.integers(1, 12),                                    # tile width
        st.integers(0, 2**31 - 1),                             # value seed
    )

    @pytest.mark.parametrize("prop", PROPERTIES,
                             ids=lambda f: f.__name__[7:])
    @settings(max_examples=25, deadline=None)
    @given(case=_pack_case)
    def test_packer_properties(prop, case):
        prop(*case)


@pytest.mark.parametrize("cnts,cap,tile", [
    ([0, 0, 0, 0], 6, 2),          # all-empty: zero tiles, nothing live
    ([5], 5, 3),                   # single row, full depth
    ([4] * 6, 4, 4),               # full width: every slot occupied
    ([0, 7, 0, 1, 3], 7, 2),       # ragged
])
def test_pack_unpack_edge_cases(cnts, cap, tile):
    p, (ts, seed, pay, cnt, live) = _pack_both(cnts, tile, 0, cap)
    total = int(np.sum(cnts))
    assert int(p.valid.sum()) == total
    if total == 0:
        assert int(p.n_tiles) == 0
    v = p.valid.numpy()
    k = np.nonzero(v)[0]
    rr = p.rnd.numpy()[v]
    for t in np.unique(k // p.tile):
        assert len(np.unique(rr[k // p.tile == t])) == 1
    uts, useed, upay, ucnt = unpack_slice(p, len(cnts), cap)
    np.testing.assert_array_equal(ucnt.numpy(), cnt)
    np.testing.assert_array_equal(uts.numpy(), ts)
    np.testing.assert_array_equal(useed.numpy()[live], seed[live])
    np.testing.assert_array_equal(upay.numpy()[live], pay[live])


def _tiny(name="phold"):
    spec = treg.conformance_spec(name)
    return treg.get_workload(name, **spec["model_kw"]), spec


@pytest.mark.parametrize("n_rows", [0, 3])
@pytest.mark.parametrize("impl", ["rounds", "packed", "ltf"])
def test_schedulers_handle_empty_and_tiny_slices(n_rows, impl):
    model, _ = _tiny()
    obj = model.init_object_state(np.arange(n_rows), "cpu")
    cap = 4
    ts = torch.full((n_rows, cap), float("inf"))
    seed = torch.zeros((n_rows, cap), dtype=torch.int64)
    pay = torch.zeros((n_rows, cap))
    cnt = torch.zeros((n_rows,), dtype=torch.int32)
    if impl == "rounds":
        obj2, flat, lv = process_batch_rounds(model, obj, ts, seed, pay, cnt,
                                              0.5)
    elif impl == "packed":
        obj2, flat, lv = process_batch_packed(model, obj, ts, seed, pay, cnt,
                                              0.5, tile=2)
    else:
        obj2, flat, lv = LtfScheduler().process(
            model, TConfig(lookahead=0.5, scheduler="ltf"), obj, ts, seed,
            pay, cnt)
    assert int(lv) == 0
    assert int(flat.valid.sum()) == 0
    assert set(obj2) == set(obj)
    for k in obj:
        assert torch.equal(obj[k], obj2[k]), k


@pytest.mark.parametrize("pack_tile", [1, 4, 64])
def test_packed_engine_bit_exact_vs_batch(pack_tile):
    model, spec = _tiny()
    kw = dict(lookahead=0.5, **spec["engine_kw"])
    a = teng.ParsirEngine(model, TConfig(**kw), device="cpu")
    b = teng.ParsirEngine(model, TConfig(batch_impl="packed",
                                         pack_tile=pack_tile, **kw),
                          device="cpu")
    sa, sb = a.run(a.init(), 16), b.run(b.init(), 16)
    assert a.totals(sa) == b.totals(sb)
    assert a.totals(sa)["processed"] > 0
    oa, ob = a.global_object_state(sa), b.global_object_state(sb)
    for k in oa:
        np.testing.assert_array_equal(oa[k], ob[k], err_msg=k)
    assert a.syncs == b.syncs == 16          # one loop bound per epoch


def test_occupancy_reports_padded_vs_packed_lanes():
    for name in ("phold", "wireless"):
        model, spec = _tiny(name)
        kw = dict(lookahead=0.5, **spec["engine_kw"])
        eng = teng.ParsirEngine(model, TConfig(**kw), device="cpu")
        st = eng.run(eng.init(), 4)
        occ = eng.occupancy(st)
        assert np.all(occ["padded_lanes"] >= occ["packed_lanes"])
        assert occ["events"].sum() == int(
            st.cal.cnt[:, int(st.epoch[0]) % kw["n_buckets"]].sum()) > 0
        jengine = jeng.ParsirEngine(jreg.get_workload(name,
                                                      **spec["model_kw"]),
                                    JConfig(**kw))
        want = jengine.occupancy(jengine.run(jengine.init(), 4))
        assert set(occ) == set(want)
        for k in want:
            np.testing.assert_array_equal(occ[k], want[k], err_msg=k)


# -- the seven workloads under ltf and batch-packed ----------------------------------

SCHEDS = ("ltf", "batch-packed")


@pytest.fixture(scope="module")
def jax_scheduled():
    """The JAX engine's run of every conformance recipe under ltf and
    batch-packed, fetched to the host."""
    out = {}
    for name in jreg.all_workloads():
        spec = jreg.conformance_spec(name)
        model = jreg.get_workload(name, **spec["model_kw"])
        for config in SCHEDS:
            eng = jeng.ParsirEngine(model, JConfig(
                lookahead=0.5, **spec["engine_kw"], **tconf.SWEEP[config]))
            out[name, config] = jax.device_get(
                eng.run(eng.init(), spec["n_epochs"]))
    return out


CASES = [(name, config) for name in treg.all_workloads() for config in SCHEDS]


def _host_tree(state):
    out = {}

    def walk(x, prefix):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{prefix}.{k}")
        elif hasattr(x, "_fields"):
            for f in x._fields:
                walk(getattr(x, f), f"{prefix}.{f}" if prefix else f)
        else:
            out[prefix] = np.asarray(x)
    walk(state, "")
    return out


@pytest.mark.parametrize("name,config", CASES,
                         ids=[f"{n}-{c}" for n, c in CASES])
def test_conformance_matches_oracle_and_the_jax_scheduler(jax_scheduled, name,
                                                          config):
    assert config in tconf.supported_configs(name)
    rep = tconf.check_workload(name, config, device="cpu")   # vs the oracle
    eng, st = rep["engine"], rep["state"]
    assert rep["totals"]["processed"] > 0 and rep["pending"] > 0
    got = _host_tree(interop.engine_state_to_numpy(st))
    want = _host_tree(jax_scheduled[name, config])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert eng.syncs == tconf.conformance_spec(name)["n_epochs"]


def test_ltf_and_packed_accepted_and_the_jax_rejections_kept():
    for kw in (dict(scheduler="ltf"), dict(batch_impl="packed", pack_tile=4)):
        t, j = TConfig(lookahead=0.5, **kw), JConfig(lookahead=0.5, **kw)
        assert t.__dict__ == j.__dict__
    bad = [dict(steal=True, scheduler="ltf"),
           dict(steal=True, batch_impl="model"),
           dict(scheduler="ltf", batch_impl="model"),
           dict(scheduler="ltf", batch_impl="packed"),
           dict(scheduler="batch-model"), dict(scheduler="batch-packed"),
           dict(batch_impl="packed", pack_tile=0)]
    for kw in bad:
        with pytest.raises(ValueError) as want:
            JConfig(lookahead=0.5, **kw)
        with pytest.raises(ValueError) as got:
            TConfig(lookahead=0.5, **kw)
        assert str(got.value) == str(want.value), kw
    # loan stealing under packed: accepted by both, field for field.
    for kw in (dict(steal=True, batch_impl="packed"),
               dict(steal=True, batch_impl="packed", route="a2a")):
        t, j = TConfig(lookahead=0.5, **kw), JConfig(lookahead=0.5, **kw)
        assert t.__dict__ == j.__dict__


@pytest.mark.parametrize("config", SCHEDS)
def test_one_host_read_per_epoch_and_per_drain_chunk(config):
    model, spec = _tiny("queueing")
    cfg = TConfig(lookahead=0.5, **spec["engine_kw"], **tconf.SWEEP[config])
    eng = teng.ParsirEngine(model, cfg, device="cpu")
    assert eng.graphs is None                    # a host-read bound: eager
    st = eng.run(eng.init(), 5)
    assert eng.syncs == 5
    eng.run_until_drained(st, 20)
    assert eng.syncs == 5 + 20 + 2
