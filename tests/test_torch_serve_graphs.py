"""The serving session's decode loop (``serve/engine.py``): on the CPU
every step runs eagerly; on a CUDA device the first step runs eagerly and
the rest replay one CUDA graph of the step, captured once per session.

Either way the session must give what a loop of eager
``model.decode_step`` calls gives from the same prefill, and it checks its
bound on a host mirror of the length, never by reading the device.  The
tests marked ``cuda`` hold the graphed session to the eager loop bit for
bit at the reduced configs in f32 (zamba2 under its own plain attention,
llama3.2 under ``attn_impl="pallas"``, the flash_attention kernel in its
prefill) and count captures, replays and kernel launches; they skip where
there is no card.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve.engine import ServeSession  # noqa: E402

B, T, MAX_LEN = 2, 16, 32
#: the reduced configs, each with the attention its card test runs.
CONFIGS = {"zamba2-1.2b": "jnp", "llama3.2-3b": "pallas"}


def _model(arch, device):
    cfg = dataclasses.replace(treg.get_config(arch, reduced=True),
                              attn_impl=CONFIGS[arch])
    return build_model(cfg, device=device, seed=3)


def _prompts(m):
    return make_batch(m.cfg, B, T, step=1, device=m.device)


def _eager_loop(m, n):
    """Prefill, then ``n`` eager ``decode_step`` calls with the position
    as a device tensor → (tokens [B, n], logits [B, n + 1, V])."""
    w = m.weights()
    caches = m.init_cache(B, MAX_LEN)
    lg, _ = m.prefill(_prompts(m)["tokens"], caches, w)
    tok = lg[:, -1].argmax(-1)
    cur_len = torch.tensor(T, device=m.device)
    toks, logits = [], [lg[:, -1]]
    for _ in range(n):
        lg, _ = m.decode_step(tok[:, None], caches, cur_len, w)
        tok = lg[:, -1].argmax(-1)
        cur_len += 1
        toks.append(tok)
        logits.append(lg[:, -1])
    return torch.stack(toks, 1), torch.stack(logits, 1)


def _served(m, *chunks):
    """A session's prefill, then one ``decode`` call per chunk of steps,
    each fed the last token → (session, tokens, logits)."""
    sess = ServeSession(m, B, MAX_LEN, device=m.device)
    tok = sess.prefill(_prompts(m))
    outs = []
    for n in chunks:
        outs.append(sess.decode(tok, n))
        tok = outs[-1][:, -1]
    return sess, torch.cat(outs, 1), torch.stack(sess.logits, 1)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_cpu_session_is_the_eager_loop(arch):
    m = _model(arch, "cpu")
    sess, toks, logits = _served(m, 2, 3)
    want_toks, want_logits = _eager_loop(m, 5)
    assert (sess.eager_steps, sess.captures, sess.replays) == (5, 0, 0)
    assert sess.length == T + 5 and int(sess.cur_len) == T + 5
    assert torch.equal(toks, want_toks)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)


def test_session_checks_its_bound_on_the_host():
    m = _model("zamba2-1.2b", "cpu")
    sess = ServeSession(m, B, T + 3, device="cpu")
    tok = sess.prefill(_prompts(m))
    out = sess.decode(tok, 2)
    with pytest.raises(ValueError, match="exceed"):
        sess.decode(out[:, -1], 2)
    assert sess.length == T + 2 and len(sess.logits) == 3
    assert sess.decode(out[:, -1], 0).shape == (B, 0)


# -- on the card -----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_graphed_session_equals_the_eager_loop_on_card(arch):
    """n decode steps: one eager step, one capture, n - 1 replays; tokens
    equal and f32 logits bit for bit against a loop of eager steps; under
    ``attn_impl="pallas"`` flash_attention runs once per layer in the
    prefill and never in a decode step, replays counted."""
    _needs_card()
    from repro_torch.kernels.flash_attention import flash_cuda
    n = 6
    m = _model(arch, "cuda")
    before = flash_cuda.launches
    sess, toks, logits = _served(m, n)
    pallas = m.cfg.attn_impl == "pallas"
    assert flash_cuda.launches - before == (m.cfg.n_layers if pallas else 0)
    assert (sess.eager_steps, sess.captures, sess.replays) == (1, 1, n - 1)
    want_toks, want_logits = _eager_loop(m, n)
    assert torch.equal(toks, want_toks)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    # each step's logits are the session's own copy, not the graph's output.
    assert len({lg.data_ptr() for lg in sess.logits}) == n + 1


@pytest.mark.cuda
def test_two_decode_calls_reuse_the_graph_on_card():
    _needs_card()
    m = _model("llama3.2-3b", "cuda")
    sess, toks, logits = _served(m, 3, 4)
    assert (sess.eager_steps, sess.captures, sess.replays) == (1, 1, 6)
    _, want_toks, want_logits = _served(m, 7)
    assert torch.equal(toks, want_toks)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)


@pytest.mark.cuda
def test_session_refuses_past_max_len_without_reading_the_device_on_card():
    """With synchronizing calls made errors, replays run and the bound
    check refuses a request past ``max_len``."""
    _needs_card()
    m = _model("zamba2-1.2b", "cuda")
    sess = ServeSession(m, B, T + 5, device="cuda")
    out = sess.decode(sess.prefill(_prompts(m)), 2)    # eager + capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sess.decode(out[:, -1], 3)                # replays only
        with pytest.raises(ValueError, match="exceed"):
            sess.decode(out[:, -1], 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (sess.captures, sess.replays, sess.length) == (1, 4, T + 5)


CAPTURE_FAILS = r'''
import torch
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import make_batch
from repro_torch.models.zamba import Zamba
from repro_torch.serve.engine import ServeSession

m = Zamba(get_config("zamba2-1.2b", reduced=True), device="cuda")
real = m.decode_step

def reads_the_host(tokens, caches, cur_len, w=None):
    if int(cur_len) < 0:
        raise AssertionError
    return real(tokens, caches, cur_len, w)

m.decode_step = reads_the_host
sess = ServeSession(m, 2, 32, device="cuda")
tok = sess.prefill(make_batch(m.cfg, 2, 16, device="cuda"))
try:
    sess.decode(tok, 3)
except RuntimeError as e:
    print("RAISED", type(e).__name__, str(e).splitlines()[0][:120])
else:
    print("NO ERROR")
print("COUNTS", sess.eager_steps, sess.captures, sess.replays)
'''


@pytest.mark.cuda
def test_a_step_that_reads_the_host_fails_to_capture_on_card():
    """A host read inside the step breaks its capture, and the session
    raises rather than decode eagerly (in a process of its own: a failed
    capture leaves its stream unusable)."""
    _needs_card()
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", CAPTURE_FAILS], cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root / "src")},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any(line.startswith("RAISED") for line in lines), out.stdout
    assert "NO ERROR" not in out.stdout
    assert "COUNTS 1 0 0" in lines, out.stdout
