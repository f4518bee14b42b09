"""Serving over a device mesh on the CPU: reduced granite-3-2b with
``n_heads = n_kv_heads = 4`` and ``head_dim = 16`` (as
``tests/test_flash_decode.py`` sets them) over gloo ranks on a ``(1, 2)``
and a ``(2, 2)`` ``("data", "model")`` mesh, one spawn each
(``testing.multidevice.serve_mesh_rank``): parameters from the JAX model's
``key(0)`` through ``interop.params_from_numpy``, placed by the rules, the
caches (20 rows, so the sequence is the largest dim and shards over
"model") by ``cache_shardings``.

The prefill's last logits and each decode step's, under ``"gather"`` and
under the sequence-parallel ``"sp"``, are held within 1e-4 of the JAX
model's one-device ``decode_step`` fed one position at a time (the JAX
prefill is not causal, ROADMAP C3); sp equals gather within 1e-5; every
parameter and cache leaf's local shape is its ``shard_shape``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

B, T, N = 4, 17, 3


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


@pytest.fixture(scope="module")
def reference():
    """(JAX parameters on the host, prompts [B, T], fed tokens [B, N], the
    JAX logits [N + 1, B, V] at positions T - 1 .. T + N - 1)."""
    import jax.numpy as jnp
    from repro.models.registry import build_model as jbuild
    jcfg, _ = _cfgs()
    jm = jbuild(jcfg)
    params = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, T + N), dtype=np.int64)
    step = jax.jit(jm.decode_step)
    caches = jm.init_cache(B, T + N, jnp.float32)
    want = []
    for i in range(T + N):
        logits, caches = step(params, jnp.asarray(toks[:, i:i + 1],
                                                  jnp.int32),
                              caches, jnp.int32(i))
        if i >= T - 1:
            want.append(np.asarray(logits[:, -1], np.float32))
    return (jax.device_get(params), toks[:, :T], toks[:, T:],
            np.stack(want))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
def test_mesh_serving_matches_jax(reference, mesh_shape):
    from repro_torch.core.dist import spawn
    from repro_torch.testing.multidevice import serve_mesh_rank
    tree, prompts, feed, want = reference
    _, cfg = _cfgs()
    D = mesh_shape[0] * mesh_shape[1]
    runs = [(cfg.dtype, feed, ("gather", "sp"), None)]
    ranks = spawn(serve_mesh_rank, D, cfg, mesh_shape, prompts, runs, tree,
                  timeout=60, join_timeout=300)
    for r, out in enumerate(ranks):
        run, = out["runs"]
        for mode in ("gather", "sp"):
            got = run["modes"][mode]["logits"]
            assert got.shape == want.shape
            err = float(np.max(np.abs(got - want)))
            assert err < 1e-4, (r, mode, err)
        assert run["sp_vs_gather"] < 1e-5, (r, run["sp_vs_gather"])
        for what, key, local, expect in out["shapes"]:
            assert tuple(local) == tuple(expect), (r, what, key)
        k = [s for s in out["shapes"] if s[:2] == ("cache", "0.k")][0]
        assert k[2] == (B // mesh_shape[0], (T + N) // mesh_shape[1], 4, 16)
        col = [s for s in out["shapes"] if s[1] == "blocks.0.attn.wq"][0]
        assert col[2] == (cfg.d_model, 4 * 16 // mesh_shape[1])
