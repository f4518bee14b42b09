"""The port's roofline (``repro_torch.roofline.analysis``) held against the
reference's (``repro.roofline.analysis``) on the CPU.

* the reference's counter tests (``tests/test_roofline_methodology.py``)
  mirrored: exact on a matmul, batch dims, remat recompute counted,
  6·N·D and 2·N·D;
* ``model_flops_for``, ``cell_is_skipped`` and ``analytic_memory_floor``
  for every cell (each arch's fake model built once);
* ``count_cell``'s product term against a walk of the reference's jaxpr
  that counts what ``jaxpr_flops`` counts for ``dot_general`` and
  ``conv_general_dilated``, at full width with ``n_layers`` cut and a small
  shape put into both packages' ``SHAPES``, one config per family
  (:data:`FAMILIES`) at train, prefill and decode;
* a kernel counts as its plain version's work, so ``attn_impl="pallas"``
  counts the products ``"jnp"`` counts, and a real run what a fake pass
  counts; its call's storages count as live;
  the reference's counter enters a ``pallas_call`` once (ROADMAP C11).
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.roofline import analysis as RA  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests' tensors are small or fake, and the
    suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: one config per family at full width: its layers cut, and the cells'
#: small shape (2 sequences of T positions, put into both packages'
#: ``SHAPES``).  zamba2-1.2b's T holds two SSD chunks; xlstm-1.3b's two
#: blocks are an mLSTM and an sLSTM (``slstm_every=2``) over one mLSTM
#: chunk, which keeps the sLSTM loop short.
B_TINY = 2
FAMILIES = {"llama3.2-3b": ({"n_layers": 2}, 256),
            "kimi-k2-1t-a32b": ({"n_layers": 2}, 256),
            "zamba2-1.2b": ({"n_layers": 2}, 256),
            "xlstm-1.3b": ({"n_layers": 2, "slstm_every": 2}, 32)}
KINDS = ("train", "prefill", "decode")
#: totals (products and the rest) against the reference's ``jaxpr_flops``.
#: The products agree exactly for dense and MoE; the rest differs by op
#: granularity: one aten op (``silu``, ``_softmax``, ``_log_softmax``,
#: ``mean``, their backwards) counts one per output element where the
#: reference counts each primitive of its decomposition (``logistic`` x 4,
#: ``exp`` x 4, ``reduce_max``, ``sub``, ...).  The rest is 1-7 % of the
#: reference's total at these shapes, so a 2 % band holds every cell with
#: room and still fails if the rest were counted twice or dropped.
TOTAL_RTOL = 0.02


# -- the reference's counter tests, mirrored -----------------------------------

def _count(fn, *args):
    with A.FlopCounter() as c:
        fn(*args)
    return c


def test_counter_exact_on_a_matmul():
    c = _count(lambda a, b: a @ b, torch.ones(64, 128), torch.ones(128, 32))
    assert c.dot == 2 * 64 * 128 * 32 and c.rest == 0


def test_counter_dot_with_batch_dims():
    c = _count(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
               torch.ones(4, 8, 16), torch.ones(4, 16, 32))
    assert c.dot == 4 * 2 * 8 * 16 * 32


def test_counter_counts_remat_recompute():
    from torch.utils.checkpoint import checkpoint

    def mk(remat):
        w = torch.randn(6, 32, 32, requires_grad=True)
        x = torch.randn(8, 32)

        def body(c, wi):
            return torch.tanh(c @ wi)
        with A.FlopCounter() as c:
            h = x
            for i in range(6):
                h = checkpoint(body, h, w[i], use_reentrant=False) \
                    if remat else body(h, w[i])
            h.sum().backward()
        return c
    plain, remat = mk(False), mk(True)
    assert remat.total > plain.total
    # the recompute is the forward once more: 6 products and 6 tanh.
    assert remat.dot - plain.dot == 6 * 2 * 8 * 32 * 32
    assert remat.by_op["tanh"] == 2 * plain.by_op["tanh"]


def test_model_flops_6nd_and_2nd():
    t = A.model_flops_for("granite-3-2b", "train_4k")
    d = A.model_flops_for("granite-3-2b", "decode_32k")
    n = get_config("granite-3-2b").param_count()
    assert t == pytest.approx(6.0 * n * 4096 * 256)
    assert d == pytest.approx(2.0 * n * 128)


def test_counter_products_are_flop_counter_modes():
    """The product term is ``FlopCounterMode``'s whole count; the rest,
    which it does not count, comes on top."""
    from torch.utils.flop_counter import FlopCounterMode
    m = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                            torch.nn.Linear(32, 8))
    x = torch.randn(4, 16)
    with FlopCounterMode(display=False) as fc:
        m(x).sum().backward()
    c = _count(lambda: m(x).sum().backward())
    assert c.dot == fc.get_total_flops() and c.rest > 0
    # addmm's "+ bias" is one per output element, as the reference's add.
    assert c.by_op["addmm"] == 2 * 4 * (16 * 32 + 32 * 8) + 4 * (32 + 8)


def test_zero_cost_and_transcendental_rules():
    x = torch.randn(4, 8)
    c = _count(lambda: (x.t().contiguous(), torch.cat([x, x]), x > 0,
                        torch.where(x > 0, x, 0.0), x.sort()))
    assert c.total == 0
    c = _count(lambda: (torch.exp(x), x + 1, torch.sqrt(x.abs())))
    assert c.by_op == {"exp": 4 * 32, "add": 32, "sqrt": 4 * 32, "abs": 32}


def test_allocation_tally():
    with A.FlopCounter() as c:
        a = torch.empty(1000, dtype=torch.float32)   # 4000 B
        b = a * 2                                    # 8000 B
        d = torch.zeros(500, dtype=torch.float64)    # 12000 B
        del b                                        # 8000 B
        a.add_(1)                                    # in place: no more
        v = a.view(10, 100)                          # a view: no more
    assert c.peak == 3 * 4000 and c.live == 2 * 4000
    del a, d, v
    assert c.live == 0


# -- the products against the reference's jaxpr, one config per family ------------

def _walk(jaxpr, pick) -> float:
    """``jaxpr_flops``'s walk (scan bodies times their length, the larger
    branch of a cond, calls entered), counting ``pick(eqn)`` for products
    and nothing for any other equation."""
    if hasattr(jaxpr, "jaxpr"):
        jaxpr = jaxpr.jaxpr
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in ("dot_general", "conv_general_dilated"):
            total += pick(eqn)
        elif name == "scan":
            total += _walk(eqn.params["jaxpr"], pick) * eqn.params["length"]
        elif name == "while":
            total += _walk(eqn.params["body_jaxpr"], pick)
        elif name == "cond":
            total += max(_walk(b, pick) for b in eqn.params["branches"])
        else:
            for p in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                if eqn.params.get(p) is not None:
                    total += _walk(eqn.params[p], pick)
                    break
    return total


def _products(eqn) -> float:
    if eqn.primitive.name == "dot_general":
        return RA._dot_flops(eqn)
    return RA._conv_flops(eqn)


def _free_products(eqn) -> float:
    """A ``dot_general`` with no contracting dims: an outer or
    elementwise product, which ``torch.einsum`` runs as ``aten.mul``."""
    if eqn.primitive.name == "dot_general" and \
            not eqn.params["dimension_numbers"][0][0]:
        return RA._dot_flops(eqn)
    return 0.0


def _ref_jaxpr(arch, shape, overrides):
    """The jaxpr ``repro.roofline.analysis.count_cell_flops`` walks."""
    from repro.configs.base import TrainConfig
    from repro.launch.specs import input_specs
    from repro.serve.engine import make_decode_step, make_prefill
    from repro.train.step import make_train_step
    spec = input_specs(arch, shape, overrides=overrides)
    model = spec["model"]
    if spec["kind"] == "train":
        return jax.make_jaxpr(make_train_step(model, TrainConfig()))(
            spec["params"], spec["opt_state"], spec["batch"])
    if spec["kind"] == "prefill":
        return jax.make_jaxpr(make_prefill(model))(
            spec["params"], spec["batch"], spec["caches"])
    return jax.make_jaxpr(make_decode_step(model))(
        spec["params"], spec["tokens"], spec["caches"],
        jax.ShapeDtypeStruct((), np.int32))


def _tiny(monkeypatch, kind, T) -> str:
    """A small cell of ``kind`` in both packages' ``SHAPES``."""
    from repro.configs import base as rbase
    name = f"tiny_{kind}_{T}"
    monkeypatch.setitem(SHAPES, name, ShapeConfig(name, T, B_TINY, kind))
    monkeypatch.setitem(rbase.SHAPES, name,
                        rbase.ShapeConfig(name, T, B_TINY, kind))
    return name


def _ssd_products(kind, cfg, b, T) -> tuple:
    """Products of one Mamba-2 block's SSD in the port (the chunked form
    of ``ssd_scan`` that ``ops.ssd_plain`` runs, chunk Q) and in the
    reference (``ref.ssd_ref``, the step-by-step recurrence: its only
    product is the read-out ``C_t · h_t``, 2·H·N·P a step; the state update
    is elementwise there).  Per chunk the port multiplies C·Bᵀ (2bQ²N),
    G·x (2bHQ²P), C·h and the state update (2bQNHP each).  The backward
    (train) takes each product twice, but for the read-out of the zero
    initial state (only C's gradient) and the last chunk's state update
    (nothing reads it), which autograd skips; the reference's scan
    transposes every step's read-out twice.  A prefill with a cache adds,
    in the reference only, ``ssd_final_state``'s product over T (2bTHNP),
    which the port's scan carries out instead."""
    H, P, N, Q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssd_chunk
    nc = T // Q
    cb, gx, ch = 2 * b * Q * Q * N, 2 * b * H * Q * Q * P, 2 * b * Q * N * H * P
    fwd = nc * (cb + gx + 2 * ch)
    readout = 2 * b * T * H * N * P
    if kind == "prefill":
        return fwd, 2 * readout
    bwd = 2 * nc * (cb + gx) + (2 * nc - 1) * ch + 2 * (nc - 1) * ch
    return fwd + bwd, 3 * readout


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_products_against_the_references(arch, kind, monkeypatch):
    """Dense and MoE: the products equal the reference's exactly.  Hybrid
    and xLSTM: the same work where the two packages run the same
    algorithm, and an exact, named gap where they do not:

    * contraction-free products (outer products such as the SSD decode's
      ``dt ⊗ B ⊗ x`` and xLSTM's ``k vᵀ``): the reference's einsum lowers
      them to ``dot_general`` (2 per element, a product), ``torch.einsum``
      to ``aten.mul`` (1 per element, the rest);
    * zamba2's SSD: the chunked form against the recurrence
      (:func:`_ssd_products`);
    * training xLSTM: the products above and their transposes, and the
      gradients into the zero initial states, which autograd skips and
      JAX's scan transposes compute (the sLSTM's first recurrent step, the
      mLSTM's first chunk): pinned as a number at this cell.

    The totals, products and the rest, within :data:`TOTAL_RTOL`."""
    over, T = FAMILIES[arch]
    L = over["n_layers"]
    shape = _tiny(monkeypatch, kind, T)
    jx = _ref_jaxpr(arch, shape, over)
    ref_dot, free = _walk(jx, _products), _walk(jx, _free_products)
    ref_total = RA.jaxpr_flops(jx)
    c = A.count_cell(arch, shape, over)
    cfg = dataclasses.replace(get_config(arch), **over)
    B = B_TINY
    if cfg.family in ("dense", "moe"):
        assert free == 0
        assert c.dot == ref_dot
    elif cfg.family == "hybrid":
        if kind == "decode":
            assert c.dot == ref_dot - free
        else:
            port, ref = _ssd_products(kind, cfg, B, T)
            gap = cfg.n_layers * (port - ref)
            # the prefill's final state adds its outer product dt ⊗ B too;
            # in training, the read-out's transpose into h is contraction-
            # free (counted in the recurrence's three read-outs).
            assert c.dot - ref_dot == (gap - free if kind == "prefill"
                                       else gap)
    elif kind != "train":
        assert c.dot == ref_dot - free
    else:
        assert T <= cfg.mlstm_chunk     # one chunk: the state's edges meet
        H, d = cfg.n_heads, cfg.d_model
        dk, dh = 2 * d // H, d // H
        n_s = sum(i % cfg.slstm_every == cfg.slstm_every - 1
                  for i in range(L))
        n_m = L - n_s
        skipped = (3 * n_m * 2 * B * H * T * dk * dk  # mLSTM: C0 and C_T
                   + n_s * 2 * B * H * dh * 4 * dh    # sLSTM: into h0
                   + n_m * 2 * 2 * B * T * H * dk)    # 2 gate ⊗ v, into gates
        assert ref_dot - c.dot == skipped + free
    # the totals, once the product gap named above is put back.
    assert c.total + ref_dot - c.dot == pytest.approx(ref_total,
                                                      rel=TOTAL_RTOL)


# -- kernels count as their plain versions' work -------------------------------

def _spy(monkeypatch, *names) -> list:
    """Record the calls of the kernel wrappers ``ops.<name>``: the name and
    the shapes and dtype of the first two arguments."""
    from repro_torch.kernels import ops
    calls = []

    def wrap(name, real):
        def spy(*args, **kwargs):
            calls.append((name, tuple(args[0].shape), tuple(args[1].shape),
                          args[0].dtype))
            return real(*args, **kwargs)
        return spy
    for name in names:
        monkeypatch.setattr(ops, name, wrap(name, getattr(ops, name)))
    return calls


def _fake_passes(cfg):
    """Forward + loss and a prefill of ``cfg`` over fake tensors, as the dry
    run runs them: their counters."""
    from repro_torch.launch.specs import specs_for
    spec = specs_for(cfg, ShapeConfig("t", 32, 2, "prefill"))
    with spec["mode"], A.FlopCounter() as loss:
        spec["model"].loss(spec["batch"])
    with spec["mode"], A.FlopCounter() as pre:
        spec["model"].prefill(spec["batch"], spec["caches"])
    return loss, pre


@pytest.mark.parametrize("arch", ["llama3.2-3b", "zamba2-1.2b"])
def test_pallas_counts_what_jnp_counts(arch, monkeypatch):
    """Forward + loss and a prefill of a reduced config, over fake tensors
    as the dry run runs them, count the same products under
    ``attn_impl="pallas"`` (through ``ops.mha`` / ``ops.ssd``) as under
    ``"jnp"``, op by op; the rest differs by exactly each ``ops.mha``
    call's :func:`analysis.attention_split` (``ops.ssd`` counts as the
    ``ssd_plain`` that ``"jnp"`` runs, so it adds nothing).  A real run on
    CPU tensors counts what the fake pass counts.  The fake pass's peak
    of live bytes under ``"pallas"`` is the path's that runs: equal to the
    same pass with the kernels' calls counted as themselves, which the
    plain twins' meta runs do not raise."""
    from repro_torch.kernels import ops
    calls = _spy(monkeypatch, "mha", "ssd")
    base = get_config(arch, reduced=True)
    counts = {}
    for impl in ("jnp", "pallas"):
        del calls[:]
        cfg = dataclasses.replace(base, attn_impl=impl)
        counts[impl] = _fake_passes(cfg)
        assert bool(calls) == (impl == "pallas")
    split = {}
    for name, q, k, dtype in calls:
        if name == "mha":
            for op, f in A.attention_split(cfg, (q[0], q[2], q[1], q[3]),
                                           (k[0], k[2], k[1], k[3]),
                                           dtype).items():
                split[op] = split.get(op, 0.0) + f
    pallas, jnp_ = counts["pallas"], counts["jnp"]
    assert pallas[0].dot == jnp_[0].dot and pallas[1].dot == jnp_[1].dot
    got = {}
    for p, j in zip(pallas, jnp_):
        for op in set(p.by_op) | set(j.by_op):
            got[op] = got.get(op, 0.0) + p.by_op.get(op, 0.0) \
                - j.by_op.get(op, 0.0)
    assert {op: f for op, f in got.items() if f} == \
        {op: f for op, f in split.items() if f}
    assert any(split.values())
    # memory: the kernels' calls counted as themselves, allocations alike.
    monkeypatch.setattr(ops, "counted_as",
                        lambda *a, **k: contextlib.nullcontext())
    seen = _fake_passes(cfg)
    assert [c.peak for c in seen] == [c.peak for c in pallas]
    assert all(c.peak > 0 for c in pallas)
    if arch == "llama3.2-3b":
        from repro_torch.data.synthetic import make_batch
        from repro_torch.models.registry import build_model
        monkeypatch.undo()
        m = build_model(cfg, device="cpu")
        with A.FlopCounter() as real:
            m.prefill(make_batch(cfg, 2, 32, device="cpu"),
                      m.init_cache(2, 32))
        assert real.by_op == pallas[1].by_op


def test_kernel_calls_tally_the_storages_they_allocate():
    """An ``ops.mha`` call counts as ``attention_ref``'s work, and the
    storages it allocates as live, as ``attention_ref`` run bare does; the
    plain twin's meta run adds none."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import attention_ref
    q = torch.randn(2, 4, 64, 16, generator=torch.Generator().manual_seed(0))
    k = q[:, :2]
    with A.FlopCounter() as kernel:
        o = ops.mha(q, k, k, causal=True)
    with A.FlopCounter() as plain:
        ref = attention_ref(q, k, k, causal=True)
    assert torch.equal(o, ref)
    assert kernel.by_op == plain.by_op
    assert (kernel.live, kernel.peak) == (plain.live, plain.peak)
    assert kernel.live == o.numel() * o.element_size() > 0


def test_ssd_counts_its_plain_versions_work():
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 40, 4, 8, generator=g)
    dt = torch.rand(2, 40, 4, generator=g)
    A_ = -torch.rand(4, generator=g)
    B_, C_ = torch.randn(2, 40, 16, generator=g), torch.randn(2, 40, 16,
                                                             generator=g)
    h, h_plain = torch.zeros(2, 4, 16, 8), torch.zeros(2, 4, 16, 8)
    want = ops.ssd(x, dt, A_, B_, C_, chunk=16)   # no counter: no change
    with A.FlopCounter() as kernel:
        got = ops.ssd(x, dt, A_, B_, C_, chunk=16, final_state=h)
    with A.FlopCounter() as plain:
        ref = ops.ssd_plain(x, dt, A_, B_, C_, chunk=16, final_state=h_plain)
    assert torch.equal(got, want) and torch.equal(got, ref)
    assert torch.equal(h, h_plain)
    assert kernel.by_op == plain.by_op and kernel.dot > 0


def test_jax_counter_counts_a_pallas_call_once_but_the_port_counts_its_work():
    """ROADMAP C11: ``jaxpr_flops`` enters a ``pallas_call``'s body once,
    so the reference's Pallas flash attention counts one (bq, bk) tile of
    its grid: 4.4178e6 at B=1, H=2, T=256, D=64, causal, bq = bk = 128,
    where the products alone are 4·B·H·T²·D = 3.36e7 unmasked (1.68e7
    causal).  The port's ``ops.mha`` counts its plain version's work, the
    whole grid's."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops
    B, H, T, D = 1, 2, 256, 64
    spec = jax.ShapeDtypeStruct((B, H, T, D), jnp.float32)
    jx = jax.make_jaxpr(lambda q, k, v: jops.mha(
        q, k, v, causal=True, bq=128, bk=128, interpret=True))(spec, spec,
                                                               spec)
    assert "pallas_call" in str(jx)
    ref = RA.jaxpr_flops(jx)
    assert ref == pytest.approx(4.4178e6, rel=1e-4)
    q = torch.zeros(B, H, T, D)
    with A.FlopCounter() as c:
        ops.mha(q, q, q, causal=True)
    assert c.dot == 4 * B * H * T * T * D
    assert c.total > 7 * ref
