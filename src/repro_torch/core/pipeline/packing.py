"""Width-packing of the padded per-epoch calendar slice (paper §II-A).

Port of ``repro/core/pipeline/packing.py``.  The ``batch`` rounds loop runs a
dense ``[n_rows, C]`` grid: round ``r`` processes every row, live or not, so
an epoch costs ``max batch depth × row count`` lanes.  The packer compacts
the slice into a dense work list ordered round-major, row-minor — stable by
``(round, row)``, so an object's events keep their (ts, seed) order:

* within a round every object appears at most once, so a tile drawn from one
  round can gather per-object state, process it and scatter it back with no
  read-after-write conflict;
* each round's occupied slots are padded up to a multiple of the tile width,
  so no tile spans a round boundary;
* rounds appear in increasing order, so round ``r+1`` of an object lands in a
  strictly later tile than its round ``r``.

The (round, row) position comes from prefix sums, with no sort.  Torch has
no drop-mode scatter: every scatter here writes its dead entries to one
extra sentinel slot, which is sliced off.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..calendar import group_ranks


class PackedSlice(NamedTuple):
    """A calendar slice compacted to a dense (round-major) work list.

    Slots ``[0, n_tiles * tile)`` are ``n_tiles`` tiles; each tile's events
    belong to one batch round (distinct rows).  Dead slots (per-round tile
    padding and everything past the live region) carry ``valid=False``,
    ``row = n_rows`` and ``ts=+inf``.  Packed per replication (``reps >
    1``), every field but ``tile`` gains a leading R, and ``row`` is the row
    within the replication (``n_rows / R`` on dead slots).
    """

    ts: torch.Tensor       # f32 [k_pad]
    seed: torch.Tensor     # u32 in i64 [k_pad]
    payload: torch.Tensor  # f32 [k_pad]
    row: torch.Tensor      # i32 [k_pad] local object row (n_rows on dead slots)
    rnd: torch.Tensor      # i32 [k_pad] batch round (intra-object event index)
    valid: torch.Tensor    # bool [k_pad]
    n_tiles: torch.Tensor  # i32 0-d — live tiles (= padded total / tile)
    tile: int              # static effective tile width


def effective_tile(tile: int, n_rows: int) -> int:
    """Clamp the configured tile to the slice width (a tile wider than the
    row count would only re-buy the padded-grid lanes packing removes)."""
    return max(1, min(int(tile), n_rows)) if n_rows else 1


def pack_capacity(n_rows: int, cap: int, tile: int) -> int:
    """Static work-list capacity: every round padded to a full tile."""
    t = effective_tile(tile, n_rows)
    return cap * t * ((n_rows + t - 1) // t) if n_rows else 0


def _scatter(k_pad: int, flat: torch.Tensor, vals: torch.Tensor,
             fill, dtype, reps: int = 1) -> torch.Tensor:
    """``full((reps, k_pad), fill).at[flat].set(vals, mode="drop")`` over
    the flat ``reps * (k_pad + 1)`` slots, each replication's dropped
    entries carrying its own sentinel slot ``k_pad``; [k_pad] for one."""
    buf = torch.full((reps * (k_pad + 1),), fill, dtype=dtype,
                     device=flat.device)
    buf[flat] = vals.reshape(-1).to(dtype)
    out = buf.view(reps, k_pad + 1)[:, :k_pad]
    return out[0] if reps == 1 else out


def pack_slice(ts_s: torch.Tensor, seed_s: torch.Tensor, pay_s: torch.Tensor,
               cnt_b: torch.Tensor, tile: int, reps: int = 1) -> PackedSlice:
    """Compact a sorted ``[n_rows, C]`` calendar slice into a PackedSlice.

    Row ``o``'s live events sit in columns ``[0, cnt_b[o])``; column ``r`` is
    round ``r``.  Event ``(o, r)`` lands at ``round_base[r] + rank of o among
    the round's live rows``.  With ``reps`` the rows are R replications of
    ``n_rows / R`` rows, each packed on its own (its own rounds, tiles and
    tile count), as it would be alone.
    """
    n_rows, cap = ts_s.shape
    M = n_rows // reps
    dev = ts_s.device
    t = effective_tile(tile, M)
    k_pad = pack_capacity(M, cap, tile)
    i32 = dict(dtype=torch.int32, device=dev)
    lead = () if reps == 1 else (reps,)
    if k_pad == 0:
        return PackedSlice(
            ts=torch.zeros(lead + (0,), dtype=torch.float32, device=dev),
            seed=torch.zeros(lead + (0,), dtype=torch.int64, device=dev),
            payload=torch.zeros(lead + (0,), dtype=torch.float32, device=dev),
            row=torch.zeros(lead + (0,), **i32),
            rnd=torch.zeros(lead + (0,), **i32),
            valid=torch.zeros(lead + (0,), dtype=torch.bool, device=dev),
            n_tiles=torch.zeros(lead, **i32), tile=t)

    mask = (torch.arange(cap, device=dev)[None, None, :]
            < cnt_b.view(reps, M)[:, :, None])                 # [R, M, cap]
    m = mask.to(torch.int64)
    occ = m.sum(1)                                             # [R, cap]
    rank = m.cumsum(1) - 1                                     # [R, M, cap]
    padded = ((occ + t - 1) // t) * t
    base = padded.cumsum(1) - padded                           # exclusive
    flat = torch.where(mask, base[:, None, :] + rank, k_pad)
    flat = (flat + (k_pad + 1) * torch.arange(
        reps, device=dev)[:, None, None]).reshape(-1)

    rows = torch.arange(M, **i32)[None, :, None].expand(reps, M, cap)
    rnds = torch.arange(cap, **i32)[None, None, :].expand(reps, M, cap)

    def scat(vals, fill, dtype):
        return _scatter(k_pad, flat, vals, fill, dtype, reps)
    n_tiles = (padded.sum(1) // t).to(torch.int32)
    return PackedSlice(
        ts=scat(ts_s, float("inf"), torch.float32),
        seed=scat(seed_s, 0, torch.int64),
        payload=scat(pay_s, 0.0, torch.float32),
        row=scat(rows, M, torch.int32),
        rnd=scat(rnds, 0, torch.int32),
        valid=scat(mask, False, torch.bool),
        n_tiles=n_tiles[0] if reps == 1 else n_tiles,
        tile=t)


def unpack_slice(packed: PackedSlice, n_rows: int, cap: int):
    """Invert :func:`pack_slice` back to the ``[n_rows, cap]`` slice layout.

    Returns ``(ts, seed, payload, cnt)`` with each row's events front-packed
    in their original (round) order and dead slots at ``ts=+inf`` — the
    :func:`~repro_torch.core.calendar.extract_sorted` layout the packer
    consumed.
    """
    dev = packed.ts.device
    order, ks, rank = group_ranks(packed.row, packed.valid, n_rows)
    valid_s = ks < n_rows
    dest = torch.where(valid_s & (rank < cap), ks * cap + rank, n_rows * cap)

    def scat(vals, fill, dtype):
        return _scatter(n_rows * cap, dest, vals[order], fill,
                        dtype).view(n_rows, cap)

    ts = scat(packed.ts, float("inf"), torch.float32)
    seed = scat(packed.seed, 0, torch.int64)
    pay = scat(packed.payload, 0.0, torch.float32)
    cnt = torch.zeros((n_rows + 1,), dtype=torch.int32, device=dev)
    cnt.index_add_(0, torch.where(packed.valid, packed.row, n_rows).long(),
                   torch.ones_like(packed.row))
    return ts, seed, pay, cnt[:n_rows]
