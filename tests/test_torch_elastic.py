"""Elastic scaling of the port, the mirror of ``tests/test_elastic.py``: a
checkpoint written under one topology restores onto another (the
checkpoint holds whole tensors; ``ckpt.restore(..., shardings=, mesh=)``
re-places each on the new mesh, through ``Trainer.resume_or_init``) and
training goes on as it would have.

* reduced granite-3-2b trained 4 steps on one device with a checkpoint at
  step 4, restored onto a ``(2, 2)`` mesh of 4 gloo ranks (megatron) and
  trained on to step 6: each step's loss and grad norm within 1e-5
  (relative) of the one-device continuation (the reference holds its own
  to 1e-3);
* a checkpoint written from a ``(1, 2)`` mesh (fsdp, the mesh's first rank
  writing) restores on one device bit for bit: the parameters equal the
  mesh's gathered ones.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.dist import spawn  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.testing.multidevice import (FixedLoader,  # noqa: E402
                                             elastic_rank, train_mesh_rank)
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.loop import Trainer  # noqa: E402

ARCH = "granite-3-2b"
B, T = 4, 32
TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (the ranks set their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(d, every):
    return TrainConfig(learning_rate=3e-3, total_steps=8, warmup_steps=2,
                       checkpoint_every=every, checkpoint_dir=str(d))


def test_checkpoint_reshards_onto_a_2x2_mesh(tmp_path):
    cfg = get_config(ARCH, reduced=True)
    tcfg = _tcfg(tmp_path, 4)
    tr = Trainer(build_model(cfg, device="cpu"), tcfg,
                 loader=FixedLoader(cfg, B, T, True, "cpu"),
                 log=lambda s: None)
    params, opt_state, _ = tr.run(4)
    assert ckpt.latest_step(tmp_path) == 4
    _, _, want = tr.run(6, start=(params, opt_state, 4))
    ranks = spawn(elastic_rank, 4, cfg, (2, 2), "megatron", tcfg, 6,
                  (B, T, True), timeout=60, join_timeout=300)
    for r, run in enumerate(ranks):
        assert [h["step"] for h in run["hist"]] == [4, 5], r
        for h, w in zip(run["hist"], want):
            for k in ("loss", "grad_norm"):
                assert abs(h[k] - w[k]) <= TOL * abs(w[k]), (r, h["step"], k)
            assert h["lr"] == pytest.approx(w["lr"], rel=1e-6)
        for what, key, local, expect in run["shapes"]:
            assert tuple(local) == tuple(expect), (r, what, key)


def test_a_mesh_checkpoint_restores_on_one_device_bit_for_bit(tmp_path):
    cfg = get_config(ARCH, reduced=True)
    tcfg = _tcfg(tmp_path, 2)
    run = dict(mode="fsdp", tcfg=tcfg, steps=2, keep=True)
    ranks = spawn(train_mesh_rank, 2, cfg, (1, 2), [run], (B, T, True),
                  timeout=60, join_timeout=300)
    assert ckpt.latest_step(tmp_path) == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["LATEST",
                                                          "step_2"]
    m = build_model(cfg, device="cpu", seed=5)
    params = dict(m.named_parameters())
    tree, step = ckpt.restore(tmp_path, {"params": params,
                                         "opt": opt.init(params)})
    assert step == 2 and int(tree["opt"].count) == 2
    for r, (out,) in enumerate(ranks):
        assert out["params"].keys() == tree["params"].keys()
        for k, want in out["params"].items():
            assert torch.equal(tree["params"][k], torch.from_numpy(want)), \
                (r, k)
        for k, t in tree["opt"].mu.items():
            assert t.shape == params[k].shape and t.dtype == torch.float32
