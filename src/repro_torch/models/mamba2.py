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
compute dtype (see :meth:`repro_torch.models.zamba.Zamba.weights`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import dense_init, dt_of, init_norm, norm


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
    Returns the block's output [B,T,d]."""
    B, T, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    cdt = dt_of(cfg)
    hloc = norm(p["ln"], x, cfg.norm, cfg.norm_eps)
    proj = hloc @ p["win"]
    z = proj[..., :di]
    xBC = proj[..., di:di + di + 2 * N]
    dt_raw = proj[..., di + di + 2 * N:]

    conv_state = None if state is None else state["conv"]
    xBC, new_conv = _causal_conv(xBC, p["conv"], conv_state)
    xBC = F.silu(xBC)
    xs = xBC[..., :di].reshape(B, T, H, P)
    Bm = xBC[..., di:di + N]
    Cm = xBC[..., di + N:]

    dt = softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])

    if decode:
        h = state["h"]
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
        y = scan(xs, dt, A, Bm.float(), Cm.float(), chunk=cfg.ssd_chunk,
                 final_state=None if state is None else state["h"]).to(cdt)
    if state is not None:
        state["conv"].copy_(new_conv)

    y = y + xs.to(cdt) * p["dskip"][None, None, :, None]
    y = y.reshape(B, T, di)
    y = norm(p["out_norm"], y, "rms", cfg.norm_eps)
    y = y * F.silu(z)
    return x + y @ p["wout"]
