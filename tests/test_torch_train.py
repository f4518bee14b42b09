"""The port's training substrate (``repro_torch/{train,ft,checkpoint}``,
``data.synthetic.SyntheticLoader``, ``launch/train.py``) against the JAX
package's, and the mirror of ``tests/test_train_substrate.py``.

Against the reference, at granite-3-2b's reduced size in f32: AdamW's
``update`` leaf by leaf, one ``make_train_step`` with and without
``microbatch=2``, the moments carried across by
``interop.opt_state_from_numpy`` (bf16 and f32), and an 8-step Trainer on
one fixed batch.  Losses are held to 1e-5 (one step) and 1e-4 (each of
the 8).  Parameters are held loosely: AdamW's step m̂ / (sqrt(v̂) + eps) is
about ±1 wherever a gradient is far below the others, so float noise in a
near-zero gradient moves its parameter by up to 2·lr a step; the bound
used is 2.5·lr per step taken, on every leaf.  Then the port alone: the
reference's substrate cases, a resumed run equal to the uninterrupted one
bit for bit, a retried step equal to one that never failed, bf16 leaves
through a checkpoint bit for bit, the CLI.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.synthetic import SyntheticLoader  # noqa: E402
from repro_torch.ft.supervisor import (StepFailure,  # noqa: E402
                                       StragglerStats, SupervisedStep)
from repro_torch.interop import (opt_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

ARCH = "granite-3-2b"
B, T = 4, 16


def _cfg():
    return treg.get_config(ARCH, reduced=True)


def _batch(batch):
    return {k: torch.from_numpy(np.array(v, np.int64)) for k, v in
            batch.items()}


@pytest.fixture(scope="module")
def ref():
    """The JAX model's parameters (key 0), a batch of B x T, and the JAX
    train step's results from them with and without microbatch=2."""
    import jax
    from repro.configs.registry import get_config
    from repro.data.synthetic import SyntheticLoader as JLoader
    from repro.models.registry import build_model as jbuild
    from repro.train import optimizer as jopt
    from repro.train.step import make_train_step as jstep
    jcfg = get_config(ARCH, reduced=True)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(0))
    batch = JLoader(jcfg, B, T).batch_at(0)
    out = {}
    for mb in (0, 2):
        tcfg = TrainConfig(microbatch=mb, warmup_steps=1)
        p, o, m = jax.jit(jstep(jm, tcfg))(params, jopt.init(params), batch)
        out[mb] = jax.device_get((p, o, m))
    return dict(jm=jm, jcfg=jcfg, params=params,
                host=jax.device_get(params), batch=batch, out=out)


def _port_model(ref, cfg=None):
    cfg = cfg or _cfg()
    m = build_model(cfg, device="cpu")
    m.load_state_dict(params_from_numpy(ref["host"], cfg))
    return m


def _max_step_gap(m, want, cfg):
    want = params_from_numpy(want, cfg)
    return max(float((p.detach() - want[n]).abs().max())
               for n, p in m.named_parameters())


# -- against the reference ----------------------------------------------------

def test_optimizer_update_matches_reference():
    """Three AdamW steps on a small tree with an f32 and a bf16 leaf, from
    the same gradients: parameters, moments, count, grad norm and lr."""
    import jax
    import jax.numpy as jnp
    from repro.train import optimizer as jopt
    rng = np.random.default_rng(0)
    p32 = rng.standard_normal((5, 3)).astype(np.float32)
    p16 = rng.standard_normal((7,)).astype(np.float32)
    tcfg = TrainConfig(learning_rate=0.05, warmup_steps=2, total_steps=6,
                       grad_clip=0.5)
    jp = {"a": jnp.asarray(p32), "b": jnp.asarray(p16, jnp.bfloat16)}
    tp = {"a": torch.from_numpy(p32.copy()),
          "b": torch.from_numpy(p16).to(torch.bfloat16)}
    js, ts = jopt.init(jp), opt.init(tp)
    assert ts.mu["b"].dtype == torch.float32        # f32 from the start
    jupdate = jax.jit(jopt.update, static_argnums=3)
    for i in range(3):
        g32 = rng.standard_normal((5, 3)).astype(np.float32)
        g16 = rng.standard_normal((7,)).astype(np.float32)
        jp, js, jm = jupdate({"a": jnp.asarray(g32),
                              "b": jnp.asarray(g16, jnp.bfloat16)},
                             js, jp, tcfg)
        tp, ts, tm = opt.update({"a": torch.from_numpy(g32),
                                 "b": torch.from_numpy(g16).to(
                                     torch.bfloat16)}, ts, tp, tcfg)
        assert int(ts.count) == int(js.count) == i + 1
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * float(jm[k])
        for name in ("a", "b"):
            assert tp[name].dtype == (torch.float32 if name == "a"
                                      else torch.bfloat16)
            # f32 to 1e-6; bf16 to one bf16 ulp (2^-8 relative).
            np.testing.assert_allclose(
                tp[name].float().numpy(),
                np.asarray(jp[name], np.float32),
                rtol=0 if name == "a" else 2.0 ** -8,
                atol=1e-6 if name == "a" else 0)
            for t, j in ((ts.mu, js.mu), (ts.nu, js.nu)):
                np.testing.assert_allclose(t[name].numpy(),
                                           np.asarray(j[name], np.float32),
                                           rtol=1e-5, atol=1e-7)


def test_opt_state_from_numpy_takes_bf16_and_f32_moments(ref):
    """A JAX AdamWState of a scan_layers stack with bf16 masters (bf16
    moments at init, f32 after an update, as kimi-k2's config makes them)
    → moments keyed as the port's parameters, in f32, equal in value."""
    import jax
    import jax.numpy as jnp
    from repro.train import optimizer as jopt
    cfg = _cfg()
    params = jax.tree.map(lambda p: p.astype(jnp.bfloat16), ref["params"])
    grads = jax.tree.map(lambda p: p * 0.5, params)
    s0 = jopt.init(params)
    _, s1, _ = jax.jit(jopt.update, static_argnums=3)(grads, s0, params,
                                                      TrainConfig())
    names = [n for n, _ in _port_model(ref).named_parameters()]
    for js, dtype in ((s0, "bfloat16"), (s1, "float32")):
        host = jax.device_get(js)
        assert jax.tree.leaves(host.mu)[0].dtype.name == dtype
        assert jax.tree.leaves(host.mu)[0].shape[0] == cfg.n_layers
        st = opt_state_from_numpy(host, cfg, device="cpu")
        assert sorted(st.mu) == sorted(names) == sorted(st.nu)
        assert st.count.dtype == torch.int32 and st.count.dim() == 0
        assert int(st.count) == int(host.count)
        want = params_from_numpy(host.nu, cfg)
        for n in names:
            assert st.mu[n].dtype == st.nu[n].dtype == torch.float32
            assert torch.equal(st.nu[n], want[n].float())


@pytest.mark.parametrize("mb", [0, 2])
def test_train_step_matches_reference(ref, mb):
    cfg = _cfg()
    m = _port_model(ref)
    tcfg = TrainConfig(microbatch=mb, warmup_steps=1)
    state, metrics = make_train_step(m, tcfg)(opt.init(
        dict(m.named_parameters())), _batch(ref["batch"]))
    jp, jo, jm = ref["out"][mb]
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-5
    assert abs(float(metrics["grad_norm"]) - float(jm["grad_norm"])) \
        <= 1e-5 * float(jm["grad_norm"])
    assert float(metrics["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert _max_step_gap(m, jp, cfg) <= 2.5 * float(jm["lr"])
    mu = params_from_numpy(jo.mu, cfg)
    for n, t in state.mu.items():
        scale = float(mu[n].abs().max())
        assert float((t - mu[n]).abs().max()) <= 1e-4 * max(scale, 1e-30), n


def test_microbatch_accumulation_matches_full_batch(ref):
    """As the reference's test: microbatch=2 against one batch of 4, the
    loss within rtol 1e-5 and the parameters within 2e-5."""
    out = []
    for mb in (0, 2):
        m = _port_model(ref)
        _, metrics = make_train_step(m, TrainConfig(
            microbatch=mb, warmup_steps=1))(opt.init(
                dict(m.named_parameters())), _batch(ref["batch"]))
        out.append((float(metrics["loss"]),
                    [p.detach().clone() for p in m.parameters()]))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        assert float((a - b).abs().max()) <= 2e-5


class _FixedLoader(SyntheticLoader):
    def batch_at(self, step):  # the same batch → the loss must fall
        return super().batch_at(0)


def test_trainer_matches_the_jax_trainer(ref):
    """8 steps of both Trainers on one fixed batch from the same
    parameters: each step's loss within 1e-4, the last parameters within
    2.5·lr per step."""
    from repro.data.synthetic import SyntheticLoader as JLoader
    from repro.train import optimizer as jopt
    from repro.train.loop import Trainer as JTrainer

    class JFixed(JLoader):
        def batch_at(self, step):
            return super().batch_at(0)
    tcfg = TrainConfig(learning_rate=3e-3, total_steps=8, warmup_steps=2,
                       checkpoint_every=0)
    jtr = JTrainer(ref["jm"], tcfg, loader=JFixed(ref["jcfg"], 2, 32),
                   log=lambda s: None)
    params = ref["params"]
    jp, _, jhist = jtr.run(8, start=(params, jopt.init(params), 0))
    cfg = _cfg()
    m = _port_model(ref)
    tr = Trainer(m, tcfg, loader=_FixedLoader(cfg, 2, 32, device="cpu"),
                 log=lambda s: None)
    _, _, hist = tr.run(8, start=(dict(m.named_parameters()),
                                  opt.init(dict(m.named_parameters())), 0))
    assert [h["step"] for h in hist] == list(range(8))
    for h, j in zip(hist, jhist):
        assert abs(h["loss"] - j["loss"]) <= 1e-4, (h, j)
        assert h["lr"] == pytest.approx(j["lr"], rel=1e-6)
        assert set(h) == set(j)
    assert hist[-1]["loss"] < hist[0]["loss"]
    import jax
    lr_sum = sum(h["lr"] for h in jhist)
    assert _max_step_gap(m, jax.device_get(jp), cfg) <= 2.5 * lr_sum


# -- the reference's substrate cases, mirrored --------------------------------

def test_adamw_reduces_quadratic():
    w = torch.tensor([3.0, -2.0, 1.5])
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=1, total_steps=200,
                       weight_decay=0.0, grad_clip=10.0)
    state = opt.init(w)
    for _ in range(150):
        g = 2 * w
        w, state, m = opt.update(g, state, w, tcfg)
    assert float(torch.sum(w * w)) < 1e-2


def test_grad_clip_caps_global_norm():
    g = {"a": torch.full((4,), 100.0), "b": torch.full((2,), -100.0)}
    clipped, gn = opt.clip_by_global_norm(g, 1.0)
    assert float(opt.global_norm(clipped)) <= 1.0 + 1e-5
    assert float(gn) > 100


def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "n": torch.tensor(7, dtype=torch.int32)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, tree, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    got, step = ckpt.restore(tmp_path, tree)
    assert step == 5
    assert torch.equal(got["w"], tree["w"]) and got["n"].dtype == torch.int32
    # GC kept only 2
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_4", "step_5"]


def test_checkpoint_restore_rejects_shape_mismatch(tmp_path):
    ckpt.save(tmp_path, 1, {"w": torch.zeros((3,))})
    with pytest.raises(ValueError):
        ckpt.restore(tmp_path, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(tmp_path, {"w": torch.zeros((3,)), "v": torch.ones(1)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", {"w": torch.zeros((3,))})


def test_checkpoint_keeps_bf16_bits_and_records_paths(tmp_path):
    g = torch.Generator().manual_seed(0)
    state = opt.init({"w": torch.zeros(5)})
    tree = {"params": {"w": torch.randn(5, generator=g).to(torch.bfloat16)},
            "opt": state._replace(count=torch.tensor(3, dtype=torch.int32))}
    ckpt.save(tmp_path, 2, tree)
    manifest = json.loads((tmp_path / "step_2" / "manifest.json").read_text())
    assert [(e["path"], e["dtype"]) for e in manifest["leaves"]] == [
        ("params.w", "bfloat16"), ("opt.mu.w", "float32"),
        ("opt.nu.w", "float32"), ("opt.count", "int32")]
    got, _ = ckpt.restore(tmp_path, tree)
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"].view(torch.int16),
                       tree["params"]["w"].view(torch.int16))
    assert type(got["opt"]) is opt.AdamWState and int(got["opt"].count) == 3


def test_supervised_step_retries_then_raises():
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        raise RuntimeError("injected device failure")

    s = SupervisedStep(flaky, max_retries=2)
    with pytest.raises(StepFailure):
        s(1)
    assert calls["n"] == 3  # initial + 2 retries


def test_straggler_detection():
    st = StragglerStats()
    for _ in range(10):
        st.update(0.1)
    assert st.slow_steps == 0
    assert st.update(1.0)  # 10x EWMA → straggler
    assert st.slow_steps == 1
    # EWMA not poisoned by the straggler
    assert st.ewma_s < 0.2


def test_trainer_end_to_end_with_resume(tmp_path):
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    tcfg = TrainConfig(learning_rate=3e-3, total_steps=8, warmup_steps=2,
                       checkpoint_every=4, checkpoint_dir=str(tmp_path),
                       keep_checkpoints=2)
    loader = _FixedLoader(cfg, 2, 32, device="cpu")
    tr = Trainer(model, tcfg, loader=loader, log=lambda s: None)
    params, opt_state, hist = tr.run(8)
    assert hist[-1]["loss"] < hist[0]["loss"]  # loss went down
    assert ckpt.latest_step(tmp_path) == 8

    # crash-restart: a fresh Trainer resumes from step 8 and continues
    tr2 = Trainer(build_model(cfg, device="cpu", seed=5), tcfg,
                  loader=loader, log=lambda s: None)
    p2, o2, step0 = tr2.resume_or_init()
    assert step0 == 8
    for n, p in p2.items():
        assert torch.equal(p, params[n])
    _, _, hist2 = tr2.run(10, start=(p2, o2, step0))
    assert len(hist2) == 2  # only steps 8, 9 executed


# -- the port alone -----------------------------------------------------------

def test_resume_equals_uninterrupted_bit_for_bit(tmp_path):
    """8 steps straight, against 4 steps, a checkpoint, and a fresh Trainer
    (another model, other weights) resuming it for steps 4-7: every
    parameter, moment, the count and each step's metrics equal."""
    cfg = _cfg()
    loader = SyntheticLoader(cfg, 2, 16, device="cpu")
    tcfg = TrainConfig(learning_rate=3e-3, total_steps=8, warmup_steps=2,
                       microbatch=2, checkpoint_every=4,
                       checkpoint_dir=str(tmp_path / "a"))
    straight = Trainer(build_model(cfg, device="cpu"), tcfg, loader=loader,
                       log=lambda s: None)
    p_a, o_a, h_a = straight.run(8)
    tcfg_b = dataclasses.replace(tcfg, checkpoint_dir=str(tmp_path / "b"))
    first = Trainer(build_model(cfg, device="cpu"), tcfg_b, loader=loader,
                    log=lambda s: None)
    first.run(4)
    assert ckpt.latest_step(tmp_path / "b") == 4
    logs = []
    second = Trainer(build_model(cfg, device="cpu", seed=9), tcfg_b,
                     loader=loader, log=logs.append)
    p_b, o_b, h_b = second.run(8)
    assert logs[0] == "[train] resumed from step 4"
    assert [h["step"] for h in h_b] == [4, 5, 6, 7]
    for a, b in zip(h_a[4:], h_b):
        assert {k: a[k] for k in ("loss", "grad_norm", "lr")} == \
            {k: b[k] for k in ("loss", "grad_norm", "lr")}
    for n in p_a:
        assert torch.equal(p_a[n], p_b[n]), n
        assert torch.equal(o_a.mu[n], o_b.mu[n]) and \
            torch.equal(o_a.nu[n], o_b.nu[n]), n
    assert torch.equal(o_a.count, o_b.count)


def test_a_retried_step_equals_one_that_never_failed():
    """A failure in the first attempt's backward (after the forward and
    part of the gradients) is retried on the same inputs, to the same
    parameters and state bit for bit."""
    cfg = _cfg()
    batch = SyntheticLoader(cfg, 4, 16, device="cpu").batch_at(3)
    tcfg = TrainConfig(warmup_steps=1, microbatch=2)
    out = []
    for inject in (False, True):
        m = build_model(cfg, device="cpu")
        state = opt.init(dict(m.named_parameters()))
        fired = []
        if inject:
            def boom(grad):
                if not fired:
                    fired.append(1)
                    raise RuntimeError("injected device failure")
                return grad
            m.embed.tok.register_hook(boom)
        step = SupervisedStep(make_train_step(m, tcfg), max_retries=1)
        state, metrics = step(state, batch)
        assert step.failures == int(inject) and len(fired) == int(inject)
        out.append((dict(m.named_parameters()), state, metrics))
    (p0, s0, m0), (p1, s1, m1) = out
    assert float(m0["loss"]) == float(m1["loss"])
    for n in p0:
        assert torch.equal(p0[n], p1[n]) and torch.equal(s0.mu[n], s1.mu[n])


def test_unused_parameters_get_zero_gradients():
    """musicgen's audio batches never read the token table: its gradient
    is zeros (as ``jax.grad`` gives), not missing, in both step forms."""
    from repro_torch.train.step import loss_and_grads
    cfg = treg.get_config("musicgen-medium", reduced=True)
    m = build_model(cfg, device="cpu")
    batch = SyntheticLoader(cfg, 2, 16, device="cpu").batch_at(0)
    for mb in (0, 2):
        _, grads = loss_and_grads(m, batch, mb)
        assert grads.keys() == dict(m.named_parameters()).keys()
        assert float(grads["embed.tok"].abs().max()) == 0
        assert float(grads["blocks.0.attn.wq"].abs().max()) > 0
        assert all(p.grad is None for p in m.parameters())


def test_loader_follows_the_reference_seed_rule():
    from repro.configs.registry import get_config
    from repro.data.synthetic import SyntheticLoader as JLoader
    cfg = _cfg()
    got = SyntheticLoader(cfg, 4, 8, seed=3, shard=1, n_shards=2,
                          device="cpu").batch_at(5)
    want = JLoader(get_config(ARCH, reduced=True), 4, 8, seed=3, shard=1,
                   n_shards=2).batch_at(5)
    assert got["tokens"].shape == (2, 8)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))


def test_trainer_refuses_a_mesh():
    """``Trainer(mesh=)`` trains the dense decoders
    (``tests/test_torch_train_mesh.py``); an MoE config refuses naming
    ROADMAP A21 before anything is placed."""
    m = build_model(treg.get_config("deepseek-v2-lite-16b", reduced=True),
                    device="cpu")
    with pytest.raises(NotImplementedError, match="A21"):
        Trainer(m, TrainConfig(), mesh=object())


def test_train_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / "ck"),
            "--metrics-out", str(tmp_path / "m.json")]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "[train] done: first loss" in out
    hist = json.loads((tmp_path / "m.json").read_text())
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert ckpt.latest_step(tmp_path / "ck") == 4
    # again: resumed at step 4, nothing left to run.
    assert main(args) == 0
    assert "resumed from step 4" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--arch", ARCH, "--reduced", "--steps", "1"])
