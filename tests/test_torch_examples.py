"""The examples' PyTorch twins (``examples/*_torch.py``) on the CPU: each
runs with ``--device cpu`` and prints what its reference prints; the
quickstart's oracle check passes; the cluster simulator's numbers equal
the reference example's run, and the LM server's greedy tokens the
reference example's session on the same weights; without ``--device``
they need a card."""
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests' tensors are small or fake, and the
    suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_is_bit_exact_against_the_oracle(capsys):
    _example("quickstart_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "initialized: 512 events in flight (= O*M = 512)"
    assert out[1].startswith("ran 40 epochs in ")
    assert out[2].startswith("stats: {'processed': ")
    assert out[-1] == "parallel engine == sequential oracle (bit-exact) ✓"


def test_quickstart_twin_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example("quickstart_torch").main([])


def test_cluster_sim_twin_equals_the_reference():
    # at the sweep's highest failure rate: failures and restarts on.
    ref = _example("cluster_sim").run(80000, n_epochs=40)
    port = _example("cluster_sim_torch")
    assert port.run(80000, n_epochs=40, device="cpu") == ref


def test_serve_lm_twin_prints_its_references_lines(capsys):
    _example("serve_lm_torch").main(["--device", "cpu", "--batch", "2",
                                     "--tokens", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=llama3.2-3b (reduced) batch=2"
    assert out[1].startswith("prefill: ") and "tok/s incl. compile" in out[1]
    assert out[2] == "sampled continuations (token ids):"
    assert [len(ast.literal_eval(line.split(": ", 1)[1])) for line in out[3:]] == [4, 4]


def test_serve_lm_twin_decodes_the_references_tokens():
    """The twin's ``generate`` on the reference example's model (weights
    from ``key(0)``, carried across by ``interop.params_from_numpy``) and
    prompts decodes the greedy token ids of the reference model's
    ``decode_step``, fed the prompt one position at a time and then its
    own argmax.  The reference example's session prefills the prompt in
    one call, which is not causal (ROADMAP C3), so its tokens are not the
    yardstick."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jget
    from repro.data.synthetic import make_batch as jmake
    from repro.models.registry import build_model as jbuild
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.interop import params_from_numpy
    from repro_torch.models.registry import build_model
    B, T, N = 2, 16, 6
    jcfg = jget("llama3.2-3b", reduced=True)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(0))
    toks = jmake(jcfg, B, T)["tokens"]
    step = jax.jit(jm.decode_step)
    caches = jm.init_cache(B, T + N + 1, jnp.float32)
    want = []
    for i in range(T + N - 1):
        tok = toks[:, i:i + 1] if i < T else want[-1][:, None]
        logits, caches = step(params, tok, caches, jnp.int32(i))
        if i >= T - 1:
            want.append(jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32))
    want = np.stack([np.asarray(w) for w in want], axis=1)
    m = build_model(get_config("llama3.2-3b", reduced=True), device="cpu")
    m.load_state_dict(params_from_numpy(jax.device_get(params), jcfg))
    batch = make_batch(m.cfg, B, T, device="cpu")
    assert np.array_equal(batch["tokens"].numpy(), np.asarray(toks))
    first, out, _ = _example("serve_lm_torch").generate(m, batch, B, T, N)
    got = torch.cat([first[:, None], out], dim=1).numpy()
    assert got.shape == (B, N) and np.array_equal(got, want)
