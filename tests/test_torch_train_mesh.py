"""Training over a device mesh on the CPU (``Trainer(mesh=)``, through
``testing.multidevice.train_mesh_rank``): reduced granite-3-2b with
``n_heads = n_kv_heads = 4`` and ``head_dim = 16`` (as
``tests/test_torch_mesh_serve.py`` sets them), its parameters from the JAX
model's ``key(0)`` through ``interop.params_from_numpy``, trained for 3
steps in f32 on SyntheticLoader's batches over gloo ranks on ``(1, 2)``,
``(2, 1)`` and ``(2, 2)`` ``("data", "model")`` meshes, under megatron and
fsdp, with and without the ZeRO-2 ``grad_shardings``; one spawn per mesh
runs its cases in turn.

* each step's loss and grad norm within 1e-5 (relative) of the JAX
  ``Trainer``'s on one device, and the final parameters within 1e-5 of the
  port's one-device ``Trainer``'s wherever AdamW's step is well
  conditioned.  Where a gradient entry falls below ``ILL`` of its leaf's
  largest |g| at some step, ``m̂ / (sqrt(v̂) + eps)`` turns float noise in
  it (another order of the same sums) into a step of up to about lr:
  an entry beyond 1e-5 must be such a one (a few in ten thousand here),
  within 2.5·lr per step taken, the bound of
  ``tests/test_torch_train.py``;
* under fsdp with ``grad_shardings``: every gradient placed as its
  parameter and sharded, every gradient, parameter and moment's local
  shape its ``shard_shape``; on gloo no all-gather or reduce-scatter is
  DTensor's own (each is staged through the host, as on the card);
* ``remat="full"`` and ``"dots"`` with ``microbatch=2`` over a mesh;
* a step that fails on one rank is retried on both, and the run ends
  where the one that never failed does, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

B, T, STEPS = 4, 16, 3
MESHES = [(1, 2), (2, 1), (2, 2)]
MODES = ("megatron", "fsdp")
TOL = 1e-5
#: a gradient entry below this share of its leaf's largest |g| makes its
#: AdamW step ill conditioned (see the module's docstring).
ILL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (the ranks set their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    from repro.configs.registry import get_config as jget
    from repro_torch.configs.registry import get_config
    over = dict(n_heads=4, n_kv_heads=4, head_dim=16)
    return (dataclasses.replace(jget("granite-3-2b", reduced=True), **over),
            dataclasses.replace(get_config("granite-3-2b", reduced=True),
                                **over))


def _tcfg(**kw):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(learning_rate=3e-3, total_steps=8, warmup_steps=2,
                       checkpoint_every=0, **kw)


def _one_device(cfg, tree, tcfg):
    """The port's one-device Trainer: (metrics, final parameters, the
    entries whose AdamW step is ill conditioned: a gradient below ILL of
    its leaf's largest |g| at some step)."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.registry import build_model
    from repro_torch.testing.multidevice import FixedLoader
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import Trainer
    m = build_model(cfg, device="cpu")
    m.load_state_dict(params_from_numpy(tree, cfg))
    p = dict(m.named_parameters())
    grads = []
    update = opt.update

    def seen(g, *args, **kw):
        grads.append({k: v.detach().abs() for k, v in g.items()})
        return update(g, *args, **kw)
    opt.update = seen
    try:
        _, _, hist = Trainer(m, tcfg,
                             loader=FixedLoader(cfg, B, T, False, "cpu"),
                             log=lambda s: None).run(
                                 STEPS, start=(p, opt.init(p), 0))
    finally:
        opt.update = update
    ill = {k: np.any([(g[k] < ILL * g[k].max()).numpy() for g in grads],
                     axis=0) for k in p}
    return hist, {k: v.detach().numpy().copy()
                  for k, v in m.named_parameters()}, ill


@pytest.fixture(scope="module")
def reference():
    """The JAX model's parameters (host), the JAX Trainer's metrics of 3
    steps, and the port's one-device runs (plain, and microbatch 2)."""
    from repro.data.synthetic import SyntheticLoader as JLoader
    from repro.models.registry import build_model as jbuild
    from repro.train import optimizer as jopt
    from repro.train.loop import Trainer as JTrainer
    jcfg, cfg = _cfgs()
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(0))
    tree = jax.device_get(params)       # the JAX step donates its inputs
    _, _, jhist = JTrainer(jm, _tcfg(), loader=JLoader(jcfg, B, T),
                           log=lambda s: None).run(
                               STEPS, start=(params, jopt.init(params), 0))
    return {"tree": tree, "jax": jhist,
            "port": _one_device(cfg, tree, _tcfg()),
            "port_mb2": _one_device(cfg, tree, _tcfg(microbatch=2))}


def _runs(mesh_shape):
    """The runs of one mesh's spawn: each mode with and without
    grad_shardings (fsdp + grad_shardings also the first step's gradients
    and the step's collectives); on (1, 2) the remat cases, on (2, 1) a
    failure injected on rank 1 at step 1."""
    runs = [dict(mode=mode, grad_shardings=gs, tcfg=_tcfg(), steps=STEPS,
                 keep=True, grads=gs and mode == "fsdp",
                 measure=gs and mode == "fsdp")
            for mode in MODES for gs in (False, True)]
    if mesh_shape == (1, 2):
        runs += [dict(mode=mode, changes={"remat": remat}, steps=STEPS,
                      keep=True, tcfg=_tcfg(microbatch=2))
                 for mode, remat in (("megatron", "full"), ("fsdp", "dots"))]
    if mesh_shape == (2, 1):
        runs.append(dict(mode="fsdp", tcfg=_tcfg(), steps=STEPS,
                         fail=(1, 1), digest=True))
    return runs


@pytest.fixture(scope="module")
def spawned(reference):
    """Each mesh's ranks' results, spawned once per mesh."""
    from repro_torch.core.dist import spawn
    from repro_torch.testing.multidevice import train_mesh_rank
    _, cfg = _cfgs()
    done = {}

    def get(mesh_shape):
        if mesh_shape not in done:
            done[mesh_shape] = spawn(
                train_mesh_rank, mesh_shape[0] * mesh_shape[1], cfg,
                mesh_shape, _runs(mesh_shape), (B, T, False),
                reference["tree"], timeout=60, join_timeout=300)
        return done[mesh_shape]
    return get


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _check_params(got: dict, want: tuple, ctx) -> None:
    """The final parameters against the one-device run's: within TOL where
    AdamW's step is well conditioned; an entry beyond TOL must be ill
    conditioned, within 2.5·lr a step, and such entries at most one in a
    thousand of the leaf's."""
    hist, params, ill = want
    assert got.keys() == params.keys()
    lr_sum = sum(h["lr"] for h in hist)
    for k, w in params.items():
        gap = np.abs(got[k] - w)
        off = gap > TOL
        assert not np.any(off & ~ill[k]), (ctx, k, float(gap.max()))
        assert off.mean() <= 1e-3, (ctx, k, int(off.sum()))
        assert float(gap.max()) <= 2.5 * lr_sum, (ctx, k)


@pytest.mark.parametrize("gs", [False, True], ids=["plain", "zero2"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_mesh_training_matches_one_device(reference, spawned, mesh_shape,
                                          mode, gs):
    i = 2 * MODES.index(mode) + gs
    for r, ranks in enumerate(spawned(mesh_shape)):
        run = ranks[i]
        assert run["failures"] == 0 and run["step0"] == 0
        assert [h["step"] for h in run["hist"]] == list(range(STEPS))
        for h, j in zip(run["hist"], reference["jax"]):
            for k in ("loss", "grad_norm"):
                assert _rel(h[k], j[k]) <= TOL, (r, h["step"], k, h[k], j[k])
            assert h["lr"] == pytest.approx(j["lr"], rel=1e-6)
        _check_params(run["params"], reference["port"], r)
        for what, key, local, expect in run["shapes"]:
            assert tuple(local) == tuple(expect), (r, what, key)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)], ids=lambda s: "x".join(
    map(str, s)))
def test_zero2_gradients_are_sharded_as_their_parameters(spawned,
                                                         mesh_shape):
    """Under fsdp with grad_shardings the first step's gradients: each
    placed as its parameter, sharded wherever the parameter is, and of
    its shard_shape; the step's gathers and reduce-scatters all staged
    (``c10d``), none DTensor's own (``_c10d_functional``), and the
    backward's reduce-scatters issued."""
    i = 2 * MODES.index("fsdp") + 1
    for r, ranks in enumerate(spawned(mesh_shape)):
        run = ranks[i]
        sharded = 0
        for key, got, want, local, expect in run["grads"]["layout"]:
            assert got == want, (r, key, got, want)
            assert tuple(local) == tuple(expect), (r, key)
            sharded += "Shard" in got
        assert sharded > len(run["grads"]["layout"]) // 2, r
        step0 = run["timing"]["steps"][0]
        assert step0["collectives"]["reduce-scatter"]["count"] > 0
        assert not {"all-gather", "reduce-scatter", "all-to-all"} & set(
            step0["functional"]), (r, step0["functional"])


@pytest.mark.parametrize("case", ["megatron-full", "fsdp-dots"])
def test_remat_over_a_mesh(reference, spawned, case):
    """remat "full" (megatron) and "dots" (fsdp) with microbatch 2 on the
    (1, 2) mesh: the recomputed blocks reissue their collectives in the
    same order on both ranks, and the run equals the one-device run with
    microbatch 2 within 1e-5 (the parameters as the main test holds
    them)."""
    i = 4 + ["megatron-full", "fsdp-dots"].index(case)
    for r, ranks in enumerate(spawned((1, 2))):
        run = ranks[i]
        for h, w in zip(run["hist"], reference["port_mb2"][0]):
            for k in ("loss", "grad_norm"):
                assert _rel(h[k], w[k]) <= TOL, (r, case, h["step"], k)
        _check_params(run["params"], reference["port_mb2"], (r, case))


def test_a_failure_on_one_rank_is_retried_on_all(spawned):
    """Rank 1's first attempt at step 1 raises after the step's last
    collective (fsdp on the (2, 1) mesh): both ranks count one failure,
    retry, and end with the parameters of the run that never failed, bit
    for bit; the metrics are the same on both ranks."""
    ranks = spawned((2, 1))
    plain = 2 * MODES.index("fsdp")
    for r, out in enumerate(ranks):
        run = out[-1]
        assert run["failures"] == 1, r
        assert run["digest"] == out[plain]["digest"], r
        assert [h["loss"] for h in run["hist"]] == \
            [h["loss"] for h in out[plain]["hist"]], r
    keys = ("step", "loss", "grad_norm", "lr")
    assert [[{k: h[k] for k in keys} for h in out[-1]["hist"]]
            for out in ranks] == [[{k: h[k] for k in keys}
                                   for h in ranks[0][-1]["hist"]]] * 2
