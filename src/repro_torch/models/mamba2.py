"""Mamba-2 block (SSD) of the zamba2 hybrid (``repro/models/mamba2.py``).

Prefill and the teacher-forced forward run the chunked SSD as the JAX
package dispatches it: under ``attn_impl="pallas"`` through
:func:`repro_torch.kernels.ops.ssd` (the ``ssd_scan`` kernel on the card,
its plain version on the CPU; no backward), otherwise through
:func:`repro_torch.kernels.ops.ssd_plain`, the counterpart of the JAX
package's ``ref.ssd_ref`` on any device, which training differentiates.
Decode runs the O(1) per-step recurrence.
State = (conv window ``[B, W-1, C]``, SSM state ``h [B, H, N, P]`` f32),
constant in sequence length.  Parameters ``p`` are the block's weights in
compute dtype (see :meth:`repro_torch.models.zamba.Zamba.weights`).  Over
a device mesh (DTensor inputs) each rank runs its block of heads.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..distributed import sharding
from ..distributed.sharding import is_dtensor
from ..kernels import ops
from .layers import dense_init, dt_of, init_norm, norm, norm_heads


def init_mamba_block(cfg, gen: torch.Generator) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    N = cfg.ssm_state
    H = cfg.ssm_heads
    dev = gen.device
    return {
        "ln": init_norm(d, cfg.norm, dev),
        "win": dense_init(gen, (d, 2 * di + 2 * N + H)),
        "conv": dense_init(gen, (cfg.ssm_conv, di + 2 * N), scale=0.5),
        "a_log": torch.zeros((H,), dtype=torch.float32, device=dev),  # A = -1
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "dskip": torch.ones((H,), dtype=torch.float32, device=dev),
        "out_norm": init_norm(di, "rms", dev),
        "wout": dense_init(gen, (di, d), scale=1.0 / math.sqrt(di)),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv over time.  x: [B,T,C]; w: [W,C].

    state: [B, W-1, C] previous inputs (decode, prefill) or None (zero-pad).
    Returns (y [B,T,C], new_state [B, W-1, C] in x's dtype)."""
    B, T, C = x.shape
    W = w.shape[0]
    if state is None:
        state = x.new_zeros((B, W - 1, C))
    xp = torch.cat([state.to(x.dtype), x], dim=1)              # [B, T+W-1, C]
    y = sum(xp[:, i:i + T, :] * w[i] for i in range(W))
    return y, xp[:, xp.shape[1] - (W - 1):, :]


def softplus(x):
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_final_state(x, dt, A, B):
    """SSM state after a full sequence: h_T = Σ_j exp(Σ_{k>j} A·dt_k) dt_j B_j x_j^T.

    The closed form of the state ``ops.ssd(..., final_state=h)`` carries out
    of the scan; kept as the yardstick of the tests.

    x: [b,T,H,P]; dt: [b,T,H]; A: [H]; B: [b,T,N] → h [b,H,N,P] f32."""
    l = torch.cumsum(A * dt, dim=1)                            # [b,T,H]
    w = torch.exp(l[:, -1:, :] - l) * dt                       # [b,T,H]
    return torch.einsum("btn,bthp->bhnp", B.float(),
                        x.float() * w.float()[..., None])


def mamba_apply(cfg, p, x, state=None, decode=False):
    """x: [B,T,d].  state: {"conv": [B,W-1,C], "h": [B,H,N,P]} or None.

    With a state, the new conv window and h are written into it in place
    (prefill fills it from the prompt, decode advances it by one step).
    Returns the block's output [B,T,d].

    Over a device mesh (x a DTensor [B,T,d] in the stream's layout) each
    rank runs the block of SSM heads whose ``wout`` rows it holds (every
    head where the rules' blocks cut one): the rules shard ``win``'s fused
    ``[z | xBC | dt]`` columns over "model" in blocks that cut across its
    segments, so the z, x and dt columns of those heads and B and C whole
    come from ``win``'s product with every column (``sharding.
    column_product``: the products or the weight all-gathered, whichever
    is smaller); the depthwise conv runs per channel, the scan on the
    rank's heads (under ``"pallas"`` the ``ssd_scan`` kernel on a view of
    the rank's xBC), ``out_norm``'s RMS over di from one all-reduce of
    partial sums of squares (``layers.norm_heads``), and ``wout``'s partial
    product is summed over "model".  The state keeps ``cache_shardings``'
    layout (``h`` and the conv window over their largest dims, which no
    head split matches): a prefill gathers each whole for its rows and
    each rank writes its own block of the new state, the heads' parts
    all-gathered first (``h`` along H, the window's x channels); a decode
    step over ``h`` laid out by P (the rule's choice) advances each rank's
    own block of P for every head in place instead (:func:`_own_step`)."""
    mesh = x.device_mesh if is_dtensor(x) else None
    xl = x if mesh is None else sharding.batch_local(x)
    B, T, _ = xl.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    cdt = dt_of(cfg)
    h0, hl = sharding.head_split(p["wout"], 0, H)
    heads = sharding.shard_dims(p["wout"], 0) if hl != H else []
    c0, c1 = h0 * P, (h0 + hl) * P
    hn = norm({k: sharding.whole(v) for k, v in p["ln"].items()}, xl,
              cfg.norm, cfg.norm_eps)
    proj = sharding.column_product(hn, p["win"])
    z = proj[..., c0:c1]
    xBC = proj[..., di:di + di + 2 * N]
    dt_raw = proj[..., 2 * di + 2 * N + h0:2 * di + 2 * N + h0 + hl]
    conv = sharding.whole(p["conv"])
    conv_state = None if state is None else state["conv"]
    if mesh is not None and state is not None:
        conv_state = sharding.batch_local(conv_state)
    if hl != H:
        # the rank's x channels, then B and C
        xBC = torch.cat([proj[..., di + c0:di + c1],
                         proj[..., 2 * di:2 * di + 2 * N]], -1)
        mine = torch.cat([torch.arange(c0, c1),
                          torch.arange(di, di + 2 * N)]).to(xl.device)
        conv = conv.index_select(1, mine)
        if conv_state is not None:
            conv_state = conv_state.index_select(2, mine)
    xBC, new_conv = _causal_conv(xBC, conv, conv_state)
    xBC = F.silu(xBC)
    xs = xBC[..., :hl * P].reshape(B, T, hl, P)
    Bm = xBC[..., hl * P:hl * P + N]
    Cm = xBC[..., hl * P + N:]

    a_log = sharding.whole(p["a_log"])
    dt = softplus(dt_raw.float() + sharding.whole(p["dt_bias"])[h0:h0 + hl])
    A = -torch.exp(a_log[h0:h0 + hl])

    own = mesh is not None and decode and not any(
        sharding.shard_dims(state["h"], d) for d in (1, 2))
    h = None if state is None else state["h"]
    if own:
        y = _own_step(h, xs, dt, a_log, Bm, Cm, h0, hl, heads)
        y = y[:, None].to(cdt)
    elif decode:
        if mesh is not None:
            h = sharding.batch_local(h)[:, h0:h0 + hl]
        decay = torch.exp(A[None, :] * dt[:, 0])                   # [B,H]
        upd = torch.einsum("bh,bn,bhp->bhnp", dt[:, 0], Bm[:, 0].float(),
                           xs[:, 0].float())
        h.mul_(decay[..., None, None]).add_(upd)
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), h)
        y = y[:, None].to(cdt)                                     # [B,1,H,P]
    else:
        # the reference's dispatch (``repro/models/mamba2.py:95``); with a
        # state, the scan itself leaves its final h there.
        scan = ops.ssd if cfg.attn_impl == "pallas" else ops.ssd_plain
        if mesh is not None and h is not None:
            h = torch.empty((B, hl, N, P), dtype=torch.float32,
                            device=xl.device)
        y = scan(xs, dt, A, Bm.float(), Cm.float(), chunk=cfg.ssd_chunk,
                 final_state=h).to(cdt)
    if state is not None and mesh is None:
        state["conv"].copy_(new_conv)
    elif state is not None:
        # each rank writes its own block of the new state
        if not own:
            sharding.write_block(state["h"],
                                 sharding.gather_over(h, 1, mesh, heads))
        xw = sharding.gather_over(new_conv[..., :hl * P], 2, mesh, heads)
        sharding.write_block(state["conv"],
                             torch.cat([xw, new_conv[..., hl * P:]], -1))

    y = y + xs.to(cdt) * sharding.whole(p["dskip"])[None, None, h0:h0 + hl,
                                                    None]
    y = y.reshape(B, T, hl * P)
    y = norm_heads(p["out_norm"]["scale"], y, di, cfg.norm_eps, mesh, heads,
                   c0)
    y = y * F.silu(z)
    y = xl + sharding.row_product(y, c0, p["wout"])
    return y if mesh is None else sharding.as_batch(y, x)


def _own_step(h, xs, dt, a_log, Bm, Cm, h0, hl, heads):
    """A decode step of :func:`mamba_apply` over a mesh whose ``h``
    [B,H,N,P] (a DTensor) holds every head and a block of P: the step is
    separable over P, so each rank advances its own block in place for
    every head (their x and dt gathered from the ranks' heads ``h0 ..
    h0 + hl``, split over the mesh dims ``heads``) and the outputs are
    gathered along P; the state never moves.  Returns y [B,hl,P] f32."""
    mesh = h.device_mesh
    hb = h.to_local()                                        # [B,H,N,Pl]
    p0 = sharding.block_start(h, 3)
    x_all, dt_all = sharding.gather_many([xs[:, 0], dt[:, 0]], 1, mesh,
                                         heads)
    decay = torch.exp(-torch.exp(a_log)[None, :] * dt_all)
    upd = torch.einsum("bh,bn,bhp->bhnp", dt_all, Bm[:, 0].float(),
                       x_all[..., p0:p0 + hb.shape[3]])
    hb.mul_(decay[..., None, None]).add_(upd)
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), hb)
    y = sharding.gather_over(y, 2, mesh, sharding.shard_dims(h, 3))
    return y[:, h0:h0 + hl]
