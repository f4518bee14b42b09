"""xLSTM (arXiv:2405.04517): mLSTM + sLSTM blocks, 7:1 interleave; port of
``repro/models/xlstm.py``.

The mLSTM's matrix memory runs in the reference's chunkwise-parallel form
(``gated_chunk``: per chunk, the intra-chunk gated attention and the state
carried in from the chunks before) for the forward and the prefill, and as
the one-step recurrence (``gated_step``) in a decode step.  sLSTM is
sequential: a Python loop over T here, as ``lax.scan`` is in the reference.
Input gates are sigmoids and forget gates log-sigmoids, the reference's
stabilized simplification.

Serving state is O(1) in the sequence length: per mLSTM block an f32 [B, H,
dk, dv] matrix memory, per sLSTM block an f32 (c, n, h) [B, H, dh] triple.
``prefill`` and ``decode_step`` update them in place (``copy_``), so a
serving session can capture a decode step into a CUDA graph; ``cur_len`` is
taken and ignored.  No Pallas kernel is on this path in the reference.
Serving and evaluation run under ``no_grad``; :meth:`XLSTM.train_loss`,
which training differentiates, runs ``_run`` without states, so the
in-place updates stay out of its graph.  Over a device mesh (DTensor
inputs) each rank runs its own heads (:func:`mlstm_apply`,
:func:`_slstm_mesh`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.device import resolve_device
from ..distributed import sharding
from ..distributed.sharding import is_dtensor
from .layers import (ParamTree, cast_params, dense_init, dt_of, embed,
                     init_embed, init_norm, norm, norm_heads,
                     target_logprobs, unembed)


# -- chunkwise gated linear attention (the mLSTM core) ---------------------------

def gated_chunk(q, k, v, logf, ig, *, chunk: int, state=None,
                compute_bf16: bool = False):
    """q, k: [B,T,H,dk]; v: [B,T,H,dv]; logf, ig: [B,T,H] (logf <= 0,
    ig >= 0)::

        y_t = q_t · S_t,   S_t = exp(logf_t)·S_{t-1} + ig_t·k_t v_tᵀ

    (q scaled by 1/sqrt(dk)), over chunks of ``min(chunk, T)`` steps, which
    must divide T.  Returns (y [B,T,H,dv] in q's dtype, the final state
    [B,H,dk,dv] f32); ``state`` is the state before step 0 (zeros if
    None)."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    Q = min(chunk, T)
    if T % Q:
        raise ValueError(f"gated_chunk: T={T} is not a multiple of the "
                         f"mLSTM chunk {Q} (mlstm_chunk={chunk})")
    nc = T // Q
    scale = 1.0 / math.sqrt(dk)
    cdt = torch.bfloat16 if compute_bf16 else torch.float32
    qc = q.to(cdt).reshape(B, nc, Q, H, dk)
    kc = k.to(cdt).reshape(B, nc, Q, H, dk)
    vc = v.to(cdt).reshape(B, nc, Q, H, dv)
    fc = logf.float().reshape(B, nc, Q, H)
    ic = ig.float().reshape(B, nc, Q, H)
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=q.device).tril()[None, :, :, None]
    S = (torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
         if state is None else state.float())
    ys = []
    for c in range(nc):
        qb, kb, vb, ib = qc[:, c], kc[:, c], vc[:, c], ic[:, c]
        L = torch.cumsum(fc[:, c], dim=1)                    # [B,Q,H]
        # intra-chunk: decay exp(L_i - L_j) for i >= j
        dmat = torch.exp(L[:, :, None, :] - L[:, None, :, :])  # [B,Q,Q,H]
        dmat = torch.where(causal, dmat, 0.0)
        att = torch.einsum("bihd,bjhd->bijh", qb, kb).float() * scale
        g = (att * dmat * ib[:, None, :, :]).to(cdt)
        y = torch.einsum("bijh,bjhv->bihv", g, vb).float()
        # inter-chunk: the inherited state decayed to position i
        qe = (qb * torch.exp(L).to(cdt)[..., None]).float()
        y = y + torch.einsum("bihd,bhdv->bihv", qe, S) * scale
        # state update
        w = (torch.exp(L[:, -1:, :] - L) * ib).to(cdt)       # [B,Q,H]
        S = S * torch.exp(L[:, -1, :])[:, :, None, None] + torch.einsum(
            "bjhd,bjhv->bhdv", kb * w[..., None], vb).float()
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, T, H, dv)
    return y.to(q.dtype), S


def gated_step(q, k, v, logf, ig, state, scale):
    """The one-token recurrence (decode).  q, k, v: [B,1,H,d*]; logf, ig:
    [B,1,H]; state [B,H,dk,dv] f32 → (y [B,1,H,dv], new state)."""
    kv = (k[:, 0].float() * ig[:, 0, :, None])[..., :, None] \
        * v[:, 0].float()[..., None, :]
    S = state * torch.exp(logf[:, 0])[..., None, None] + kv
    y = torch.einsum("bhd,bhdv->bhv", q[:, 0].float(), S) * scale
    return y[:, None].to(q.dtype), S


# -- blocks -----------------------------------------------------------------------

def init_mlstm_block(cfg, gen: torch.Generator) -> dict:
    d = cfg.d_model
    di = 2 * d
    H = cfg.n_heads
    return {
        "ln": init_norm(d, cfg.norm, gen.device),
        "wup": dense_init(gen, (d, 2 * di)),            # x_in, z gate
        "wq": dense_init(gen, (di, di)),
        "wk": dense_init(gen, (di, di)),
        "wv": dense_init(gen, (di, di)),
        "wif": dense_init(gen, (di, 2 * H), scale=0.02),
        "out_norm": init_norm(di, "rms", gen.device),
        "wdown": dense_init(gen, (di, d), scale=1.0 / math.sqrt(di)),
    }


def mlstm_apply(cfg, p, x, state=None, decode=False):
    """One mLSTM block, x [B,T,d] → (x + its output, the new matrix memory
    [B,H,dk,dv] f32).

    Over a device mesh (x a DTensor [B,T,d] in the stream's layout) the
    state [B,H,dk,dv] keeps ``cache_shardings``' layout (the batch and its
    largest dim): it is gathered whole for the rank's rows and each rank
    writes its own block of the new one (the new state returned is then
    None), except in a decode step over a state laid out by dv (the
    rule's choice), which each rank advances in place on its own block of
    dv for every head (:func:`_mlstm_own_step`).  ``wup``'s columns over
    "model" lie in one half of ``[x_in | z]`` each, so its product is
    gathered whole (``sharding.column_product``); ``wq``, ``wk`` and
    ``wv`` hold head columns, so each rank runs its own heads (every head
    where the blocks cut one, their products made whole), the replicated
    ``wif`` giving their gates; ``out_norm``'s RMS comes from one
    all-reduce of partial sums of squares (``layers.norm_heads``) and
    ``wdown``'s partial product is summed over "model"."""
    mesh = x.device_mesh if is_dtensor(x) else None
    xl = x if mesh is None else sharding.batch_local(x)
    B, T, d = xl.shape
    di, H = 2 * d, cfg.n_heads
    dh = di // H
    h0, hl = sharding.head_split(p["wq"], 1, H)
    for k in ("wk", "wv"):
        if sharding.head_split(p[k], 1, H) != (h0, hl):
            h0, hl = 0, H
    heads = sharding.shard_dims(p["wq"], 1) if hl != H else []
    c0, c1 = h0 * dh, (h0 + hl) * dh
    h = norm({k: sharding.whole(v) for k, v in p["ln"].items()}, xl,
             cfg.norm, cfg.norm_eps)
    up = sharding.column_product(h, p["wup"])
    xin, z = up[..., :di], up[..., di + c0:di + c1]
    q, k, v = ((xin @ p[w].to_local() if heads
                else sharding.column_product(xin, p[w])).reshape(B, T, hl, dh)
               for w in ("wq", "wk", "wv"))
    gates = (xin @ sharding.whole(p["wif"])).float()
    ig = torch.sigmoid(gates[..., h0:h0 + hl])
    logf = F.logsigmoid(gates[..., H + h0:H + h0 + hl])
    if mesh is not None and decode and not any(
            sharding.shard_dims(state, d) for d in (1, 2)):
        y = _mlstm_own_step(state, q, k, v, gates, h0, hl, heads)
        S = None
    else:
        S = state
        if mesh is not None and state is not None:
            S = sharding.batch_local(state)[:, h0:h0 + hl]
        if decode:
            y, S = gated_step(q, k, v, logf, ig, S, 1.0 / math.sqrt(dh))
        else:
            y, S = gated_chunk(q, k, v, logf, ig, chunk=cfg.mlstm_chunk,
                               state=S, compute_bf16=cfg.mlstm_bf16)
        if mesh is not None and state is not None:
            sharding.write_block(state,
                                 sharding.gather_over(S, 1, mesh, heads))
            S = None
    y = norm_heads(p["out_norm"]["scale"], y.reshape(B, T, hl * dh), di,
                   cfg.norm_eps, mesh, heads, c0)
    y = y * F.silu(z)
    y = xl + sharding.row_product(y, c0, p["wdown"])
    return (y, S) if mesh is None else (sharding.as_batch(y, x), S)


def _mlstm_own_step(state, q, k, v, gates, h0, hl, heads):
    """A decode step of :func:`mlstm_apply` over a mesh whose state (a
    DTensor [B,H,dk,dv]) holds every head and a block of dv: the step is
    separable over dv, so each rank advances its own block in place for
    every head (their q, k, v gathered from the ranks' heads ``h0 .. h0 +
    hl``, split over the mesh dims ``heads``; the gates are every head's)
    and the outputs are gathered along dv.  Returns y [B,1,hl,dv]."""
    mesh = state.device_mesh
    H = gates.shape[-1] // 2
    Sb = state.to_local()                                   # [B,H,dk,dvl]
    v0 = sharding.block_start(state, 3)
    q_all, k_all, v_all = sharding.gather_many([q[:, 0], k[:, 0], v[:, 0]],
                                               1, mesh, heads)
    ig_all = torch.sigmoid(gates[:, 0, :H])
    kv = (k_all * ig_all[..., None])[..., :, None] \
        * v_all[..., v0:v0 + Sb.shape[3]][..., None, :]
    Sb.mul_(torch.exp(F.logsigmoid(gates[:, 0, H:]))[..., None, None]
            ).add_(kv)
    y = torch.einsum("bhd,bhdv->bhv", q_all, Sb) \
        * (1.0 / math.sqrt(q.shape[-1]))
    y = sharding.gather_over(y, 2, mesh, sharding.shard_dims(state, 3))
    return y[:, h0:h0 + hl][:, None].to(q.dtype)


def init_slstm_block(cfg, gen: torch.Generator) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    return {
        "ln": init_norm(d, cfg.norm, gen.device),
        "wx": dense_init(gen, (d, 4 * d)),              # z, i, f, o
        "r": dense_init(gen, (H, dh, 4 * dh), scale=1.0 / math.sqrt(dh)),
        "wout": dense_init(gen, (d, d), scale=1.0 / math.sqrt(d)),
    }


def slstm_init_state(B, H, dh, device):
    """(c, n, h) before step 0: zeros, n = 1e-6."""
    return (torch.zeros((B, H, dh), dtype=torch.float32, device=device),
            torch.full((B, H, dh), 1e-6, dtype=torch.float32, device=device),
            torch.zeros((B, H, dh), dtype=torch.float32, device=device))


def slstm_apply(cfg, p, x, state=None):
    """Sequential sLSTM with a per-head recurrence, x [B,T,d] → (x + its
    output, the state (c, n, h) [B,H,dh] f32 after step T)."""
    if is_dtensor(x):
        return _slstm_mesh(cfg, p, x, state), None
    B, T, d = x.shape
    H = cfg.n_heads
    dh = d // H
    inp = norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    pre = (inp @ p["wx"]).reshape(B, T, H, 4 * dh).float()
    r = p["r"].float()                  # used as stored, as in the reference
    c, n, h = (slstm_init_state(B, H, dh, x.device) if state is None
               else state)
    y, state = _slstm_loop(pre, r, (c, n, h))
    return x + y.reshape(B, T, d).to(x.dtype) @ p["wout"], state


def _slstm_loop(pre, r, state):
    """The sLSTM recurrence over pre [B,T,H,4·dh] (f32) from ``state``
    (c, n, h) [B,H,dh] → (h of every step [B,T,H,dh], the state after
    step T)."""
    c, n, h = state
    dh = r.shape[1]
    hs = []
    for t in range(pre.shape[1]):
        g = pre[:, t] + torch.einsum("bhd,hdk->bhk", h, r)
        z, i, f, o = g.split(dh, dim=-1)
        z, i, f, o = torch.tanh(z), torch.sigmoid(i), torch.sigmoid(f), \
            torch.sigmoid(o)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp(n, min=1e-6)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h)


# -- full model ---------------------------------------------------------------------

class XLSTM(ParamTree):
    """xLSTM: ``forward`` (teacher-forced logits), ``loss``, ``init_cache``,
    ``prefill`` and ``decode_step``.  Parameters come from a seeded
    ``torch.Generator`` on ``device`` (the card unless the caller asks for
    the CPU), kept in ``cfg.param_dtype``; the module's state dict has the
    JAX tree's paths (``embed.tok``, ``blocks.2.r``; load the JAX model's
    with ``interop.xlstm_params_from_numpy``)."""

    def __init__(self, cfg, *, device="cuda", seed: int = 0):
        if cfg.family != "xlstm":
            raise ValueError(f"XLSTM needs an xlstm config, got {cfg.family}")
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        block_kinds = kinds(cfg)
        super().__init__({
            "embed": cast_params(cfg, init_embed(cfg, gen)),
            "final_norm": cast_params(cfg, init_norm(cfg.d_model, cfg.norm,
                                                     dev)),
            "blocks": [cast_params(cfg, init_mlstm_block(cfg, gen)
                                   if kind == "m" else
                                   init_slstm_block(cfg, gen))
                       for kind in block_kinds],
        })
        self.cfg = cfg
        self.kinds = block_kinds

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @torch.no_grad()
    def weights(self) -> dict:
        """The parameter tree in compute dtype, for serving and evaluation
        (the parameters themselves where ``param_dtype`` is the compute
        dtype; norm scales and sLSTM's ``r`` as stored, as the JAX model
        uses them)."""
        return self.tree(dt_of(self.cfg))

    def _run(self, w, x, states=None, decode=False):
        cfg = self.cfg
        for i, (kind, bp) in enumerate(zip(self.kinds, w["blocks"])):
            st = None if states is None else states[i]
            # (over a mesh the blocks write their states' blocks
            # themselves and return None)
            if kind == "m":
                x, S = mlstm_apply(cfg, bp, x, st, decode)
                if st is not None and S is not None:
                    st.copy_(S)
            else:
                x, new = slstm_apply(cfg, bp, x, st)
                if st is not None and new is not None:
                    for a, b in zip(st, new):
                        a.copy_(b)
        return norm(w["final_norm"], x, cfg.norm, cfg.norm_eps)

    @torch.no_grad()
    def forward(self, tokens, w=None):
        """Teacher-forced logits [B,T,V] (f32) of tokens [B,T]."""
        w = self.weights() if w is None else w
        x = embed(w["embed"], tokens)
        return unembed(self.cfg, w["embed"], self._run(w, x))

    @torch.no_grad()
    def loss(self, batch, w=None):
        """Next-token cross-entropy of batch["tokens"] [B,T], the unmasked
        mean over the B x (T-1) predictions."""
        tokens = batch["tokens"]
        return -target_logprobs(self(tokens, w), tokens).mean()

    def train_loss(self, batch):
        """:meth:`loss` as training differentiates it, from the masters
        (the reference remats no xLSTM block): the chunkwise mLSTM and the
        sLSTM loop, neither writing any state in place."""
        tokens = batch["tokens"]
        w = self.tree(dt_of(self.cfg))
        x = self._run(w, embed(w["embed"], tokens))
        return -target_logprobs(unembed(self.cfg, w["embed"], x),
                                tokens).mean()

    def init_cache(self, batch_size: int, max_len: int = 0) -> list:
        """The recurrent states before step 0, one per block: an f32 [B, H,
        dk, dv] matrix memory per mLSTM block, an f32 (c, n, h) [B, H, dh]
        per sLSTM block.  ``max_len`` is taken and ignored (O(1) state)."""
        cfg = self.cfg
        d, H = cfg.d_model, cfg.n_heads
        dhm, dhs = (2 * d) // H, d // H
        return [torch.zeros((batch_size, H, dhm, dhm), dtype=torch.float32,
                            device=self.device) if kind == "m" else
                slstm_init_state(batch_size, H, dhs, self.device)
                for kind in self.kinds]

    @torch.no_grad()
    def prefill(self, tokens, caches, w=None):
        """Run prompts tokens [B,T] (T a multiple of ``min(mlstm_chunk,
        T)``) from the states before step 0, updated in place; returns the
        last position's logits [B,1,V] f32."""
        w = self.weights() if w is None else w
        tokens = tokens["tokens"] if isinstance(tokens, dict) else tokens
        x = self._run(w, embed(w["embed"], tokens), caches)
        return unembed(self.cfg, w["embed"], x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, tokens, caches, cur_len=None, w=None):
        """One token per row, tokens [B,1]; the states advance in place.
        Returns logits [B,1,V] f32."""
        w = self.weights() if w is None else w
        x = self._run(w, embed(w["embed"], tokens), caches, decode=True)
        return unembed(self.cfg, w["embed"], x), caches


def _slstm_mesh(cfg, p, x, state):
    """:func:`slstm_apply` over a device mesh, x a DTensor [B,T,d] in the
    stream's layout.  ``wx``'s columns (head-major, 4·dh a head) over
    "model" hold whole heads where the heads divide the axis: each rank
    then runs the recurrence of its own heads (with their blocks of the
    replicated ``r``), else every rank runs every head, ``wx``'s product
    made whole (``sharding.column_product``).
    The state (c, n, h) [B,H,dh] is gathered whole for the rank's rows and
    each rank writes its own block of the new one; ``wout``'s partial
    product is summed over "model".  Returns x plus the block's output."""
    mesh = x.device_mesh
    xl = sharding.batch_local(x)
    Bl, T, d = xl.shape
    H = cfg.n_heads
    dh = d // H
    h0, hl = sharding.head_split(p["wx"], 1, H)
    heads = sharding.shard_dims(p["wx"], 1) if hl != H else []
    inp = norm({"scale": sharding.whole(p["ln"]["scale"])}, xl, cfg.norm,
               cfg.norm_eps)
    pre = (inp @ p["wx"].to_local() if heads
           else sharding.column_product(inp, p["wx"]))
    pre = pre.reshape(Bl, T, hl, 4 * dh).float()
    r = sharding.whole(p["r"]).float()[h0:h0 + hl]
    st = (slstm_init_state(Bl, hl, dh, xl.device) if state is None
          else tuple(sharding.batch_local(s)[:, h0:h0 + hl] for s in state))
    y, new = _slstm_loop(pre, r, st)
    if state is not None:
        for s, n in zip(state, new):
            sharding.write_block(s, sharding.gather_over(n, 1, mesh, heads))
    y = y.reshape(Bl, T, hl * dh).to(xl.dtype)
    return sharding.as_batch(
        xl + sharding.row_product(y, h0 * dh, p["wout"]), x)


def kinds(cfg) -> list:
    """"m" or "s" per block: block i is sLSTM where i % k == k - 1, k =
    ``slstm_every`` (8 if 0)."""
    k = cfg.slstm_every or 8
    return ["s" if i % k == k - 1 else "m" for i in range(cfg.n_layers)]
