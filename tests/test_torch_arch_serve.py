"""Serving sessions of the new families in the port, at the reduced size on
the CPU: MoE with MLA (deepseek-v2-lite's ``{"ckv", "kr"}`` cache), xLSTM
(matrix memories and sLSTM triples), the vision front end (internvl2: the
position after a prefill counts the patches) and the audio front end
(musicgen: the greedy loop refuses, given frames decode); the serve CLI on
each; pins for the JAX ``ServeSession``'s faults on the two front ends
(ROADMAP C7, C8); and, on the card, graphed decode against eager steps.

Every session is held against the port's own teacher-forced forward over
the prompt and what was fed after it (the forward is held against the JAX
package in ``tests/test_torch_archs.py``), atol 1e-4.
"""
import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve.engine import ServeSession, prompt_length  # noqa: E402

B, PROMPT, STEPS = 2, 16, 16   # xLSTM: a forward over 32 = 2 mLSTM chunks
ATOL = 1e-4


def _model(arch, device="cpu"):
    return build_model(treg.get_config(arch, reduced=True), device=device,
                       seed=1)


def _greedy(arch, device="cpu"):
    """(model, prompt batch, session after a prefill and STEPS greedy
    steps, the generated tokens [B, STEPS + 1])."""
    m = _model(arch, device)
    batch = make_batch(m.cfg, B, PROMPT, step=3, device=device)
    sess = ServeSession(m, B, PROMPT + STEPS, device=device)
    first = sess.prefill(batch)
    out = sess.decode(first, STEPS)
    return m, batch, sess, torch.cat([first[:, None], out], 1)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-1.3b",
                                  "kimi-k2-1t-a32b", "stablelm-12b"])
def test_greedy_session_is_the_teacher_forced_forward(arch):
    m, batch, sess, toks = _greedy(arch)
    assert sess.length == PROMPT + STEPS and int(sess.cur_len) == sess.length
    seq = torch.cat([batch["tokens"], toks[:, :-1]], 1)
    full = m(seq)[:, PROMPT - 1:]
    np.testing.assert_allclose(torch.stack(sess.logits, 1).numpy(),
                               full.numpy(), atol=ATOL)
    assert torch.equal(toks, full.argmax(-1))


def test_mla_session_keeps_the_latent_cache():
    m, _, sess, _ = _greedy("deepseek-v2-lite-16b")
    cfg = m.cfg
    assert len(sess.caches) == cfg.n_layers
    for c in sess.caches:
        assert sorted(c) == ["ckv", "kr"]
        assert c["ckv"].shape == (B, PROMPT + STEPS, cfg.kv_lora_rank)
        assert c["kr"].shape == (B, PROMPT + STEPS, cfg.rope_head_dim)
        assert c["ckv"][:, -1].abs().sum() > 0   # the last step's row


def test_vision_session_starts_after_the_patches():
    """ROADMAP C8: the prefill fills n_patches + T positions and the first
    decode step runs at that position."""
    m, batch, sess, toks = _greedy("internvl2-1b")
    P = m.cfg.n_patches
    assert batch["tokens"].shape[1] == PROMPT - P
    assert prompt_length(batch) == PROMPT
    assert sess.length == PROMPT + STEPS
    full = m({"patch_embeds": batch["patch_embeds"],
              "tokens": torch.cat([batch["tokens"], toks[:, :-1]], 1)})
    np.testing.assert_allclose(torch.stack(sess.logits, 1).numpy(),
                               full[:, PROMPT - 1:].numpy(), atol=ATOL)


def test_audio_session_refuses_greedy_and_decodes_given_frames():
    m = _model("musicgen-medium")
    batch = make_batch(m.cfg, B, PROMPT, step=3, device="cpu")
    frames = make_batch(m.cfg, B, STEPS, step=4, device="cpu")["embeds"]
    sess = ServeSession(m, B, PROMPT + STEPS, device="cpu")
    first = sess.prefill(batch)
    with pytest.raises(NotImplementedError, match="stub.*C7"):
        sess.decode(first, 1)
    out = sess.decode_frames(frames)
    assert out.shape == (B, STEPS) and sess.length == PROMPT + STEPS
    full = m({"embeds": torch.cat([batch["embeds"], frames], 1)})
    np.testing.assert_allclose(torch.stack(sess.logits, 1).numpy(),
                               full[:, PROMPT - 1:].numpy(), atol=ATOL)
    assert torch.equal(out, full[:, PROMPT:].argmax(-1))
    with pytest.raises(ValueError, match="audio"):
        _greedy_session = ServeSession(_model("granite-3-2b"), B, 8,
                                       device="cpu")
        _greedy_session.decode_frames(frames)


def _jax_session(arch):
    import jax
    from repro.configs.registry import get_config
    from repro.data.synthetic import make_batch as jmake
    from repro.models.registry import build_model as jbuild
    from repro.serve.engine import ServeSession as JSession
    jcfg = get_config(arch, reduced=True)
    jm = jbuild(jcfg)
    sess = JSession(jm, jm.init(jax.random.key(0)), B, PROMPT + STEPS + 1,
                    dtype=np.float32)
    return jcfg, sess, jmake(jcfg, B, PROMPT, step=3)


def test_jax_session_cannot_serve_audio_but_the_port_refuses_by_name():
    """ROADMAP C7: the JAX session feeds int tokens [B, 1] to the audio
    decode step, which takes them for [B, 1, d] embeddings and fails.  If
    this fails on the JAX side, the reference was fixed and the port's note
    on C7 is stale."""
    _, sess, batch = _jax_session("musicgen-medium")
    first = sess.prefill(batch)
    with pytest.raises(ValueError, match="not enough values to unpack"):
        sess.decode(first, 1)
    m = _model("musicgen-medium")
    port = ServeSession(m, B, PROMPT + STEPS, device="cpu")
    first = port.prefill(make_batch(m.cfg, B, PROMPT, device="cpu"))
    with pytest.raises(NotImplementedError, match="C7"):
        port.decode(first, 1)


def test_jax_session_decodes_vision_at_the_text_length_but_the_port_does_not():
    """ROADMAP C8: the JAX session sets its position from the first value
    of the batch (the text tokens), inside the prompt the prefill wrote
    (patches + tokens).  If this fails on the JAX side, the reference was
    fixed and the port's note on C8 is stale."""
    jcfg, sess, batch = _jax_session("internvl2-1b")
    sess.prefill(batch)
    assert sess.cur_len == PROMPT - jcfg.n_patches
    m = _model("internvl2-1b")
    port = ServeSession(m, B, PROMPT + STEPS, device="cpu")
    port.prefill(make_batch(m.cfg, B, PROMPT, device="cpu"))
    assert port.length == int(port.cur_len) == PROMPT


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-1.3b",
                                  "internvl2-1b", "musicgen-medium"])
def test_cli_serves_every_family(arch):
    from repro_torch.launch.serve import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
              "16", "--tokens", "4", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith(f"[serve] arch={arch} device=cpu")
    assert "eager steps=3" in lines[0]
    toks = json.loads(lines[1].split(": ", 1)[1])
    assert len(toks) == 4


def test_cli_refuses_a_prompt_of_patches_only():
    from repro_torch.launch.serve import main
    with contextlib.redirect_stderr(io.StringIO()), \
            pytest.raises(SystemExit):
        main(["--arch", "internvl2-1b", "--reduced", "--prompt-len", "8",
              "--device", "cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-1.3b",
                                  "internvl2-1b", "musicgen-medium"])
def test_graphed_session_equals_eager_steps_on_card(arch):
    """On the card a session captures its second decode step and replays
    it; its tokens and logits equal the CPU session's (same weights)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu = _model(arch)
    card = _model(arch, "cuda")
    card.load_state_dict(cpu.state_dict())
    batch = make_batch(cpu.cfg, B, PROMPT, step=3, device="cpu")
    frames = make_batch(cpu.cfg, B, STEPS, step=4, device="cpu")
    outs = []
    for m, dev in ((cpu, "cpu"), (card, "cuda")):
        sess = ServeSession(m, B, PROMPT + STEPS, device=dev)
        first = sess.prefill(batch)
        out = (sess.decode_frames(frames["embeds"]) if sess.audio
               else sess.decode(first, STEPS))
        outs.append((out.cpu(), torch.stack(sess.logits, 1).cpu()))
    assert (sess.captures, sess.replays) == (1, STEPS - 1)
    assert torch.equal(outs[0][0], outs[1][0])
    np.testing.assert_allclose(outs[1][1].numpy(), outs[0][1].numpy(),
                               atol=ATOL)
