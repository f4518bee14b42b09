"""The calendar multi-queue (paper §II-B), as dense device-resident rings.

Port of ``repro/core/calendar.py``.  Per device, for its local objects, a
calendar of ``n_buckets`` epoch buckets with a static capacity each:

    ts/seed/payload : [n_local, n_buckets, cap]     (compact: slots [0, cnt) live)
    cnt             : [n_local, n_buckets]

Stacked replications hand these functions the ``[R * n_local, ...]`` view
of their calendars: rows are rows, each at its replication's epoch.

Bucket ``e % n_buckets`` holds epoch ``e`` and is reused once drained.
Insertion sorts incoming events by (object, bucket) and ranks them inside
each group by a binary search for the group's start, so every event lands
at ``cnt + rank`` — a conflict-free scatter.  Overflow is counted and
returned, never silent.

Whole rows move with :func:`take_rows` / :func:`put_rows` /
:func:`clear_rows` (the adaptive rebalance's migration).

Torch has no ``mode="drop"`` scatter: dropped entries are scattered into one
extra sentinel slot that is sliced off afterwards.  The functions here
return new tensors and leave their inputs unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .events import EventBatch, compact, concat_batches, empty_batch


class Calendar(NamedTuple):
    ts: torch.Tensor       # f32 [n_local, n_buckets, cap]
    seed: torch.Tensor     # u32 in i64 [n_local, n_buckets, cap]
    payload: torch.Tensor  # f32 [n_local, n_buckets, cap]
    cnt: torch.Tensor      # i32 [n_local, n_buckets]

    @property
    def n_local(self) -> int:
        return self.ts.shape[0]

    @property
    def n_buckets(self) -> int:
        return self.ts.shape[1]

    @property
    def cap(self) -> int:
        return self.ts.shape[2]


def make_calendar(n_local: int, n_buckets: int, cap: int, device) -> Calendar:
    shape = (n_local, n_buckets, cap)
    return Calendar(
        ts=torch.full(shape, float("inf"), dtype=torch.float32, device=device),
        seed=torch.zeros(shape, dtype=torch.int64, device=device),
        payload=torch.zeros(shape, dtype=torch.float32, device=device),
        cnt=torch.zeros((n_local, n_buckets), dtype=torch.int32,
                        device=device),
    )


def group_ranks(key: torch.Tensor, valid: torch.Tensor, sentinel: int):
    """Sort events by group key; return (order, sorted_key, rank-in-group).

    rank[i] is the position of sorted element i inside its contiguous key
    group — the prefix-sum replacement for fetch-and-add slot assignment.
    A group starts where a binary search for its key lands (the reference
    takes a prefix max of the group starts: the same integers, but a scan
    with indices runs in one thread block on the card).
    """
    k = torch.where(valid, key.to(torch.int64), sentinel)
    ks, order = torch.sort(k, stable=True)
    idx = torch.arange(k.shape[0], dtype=torch.int64, device=k.device)
    return order, ks, idx - torch.searchsorted(ks, ks)


def _scatter_drop(dst: torch.Tensor, flat: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``dst.reshape(-1).at[flat].set(src, mode="drop")`` where every dropped
    entry carries ``flat == dst.numel()`` (the sentinel slot)."""
    n = dst.numel()
    buf = torch.empty(n + 1, dtype=dst.dtype, device=dst.device)
    buf[:n] = dst.reshape(-1)
    buf[flat] = src
    return buf[:n].view(dst.shape)


def insert(cal: Calendar, local_idx: torch.Tensor, epoch: torch.Tensor,
           ts: torch.Tensor, seed: torch.Tensor, payload: torch.Tensor,
           valid: torch.Tensor):
    """Insert a flat batch of events destined to local objects.

    ``epoch`` must already be within the calendar horizon (the caller splits
    off the fallback).  Returns (calendar, n_overflow).
    """
    n_local, n_buckets, cap = cal.ts.shape
    sentinel = n_local * n_buckets
    bucket = epoch.to(torch.int64) % n_buckets
    key = local_idx.to(torch.int64) * n_buckets + bucket
    order, ks, rank = group_ranks(key, valid, sentinel)

    ts_s, seed_s, pay_s = ts[order], seed[order], payload[order]
    valid_s = ks < sentinel

    base = cal.cnt.reshape(-1)[torch.where(valid_s, ks, 0)].to(torch.int64)
    slot = base + rank
    ok = valid_s & (slot < cap)
    n_overflow = (valid_s & ~ok).sum()

    flat = torch.where(ok, ks * cap + slot, n_local * n_buckets * cap)
    new_ts = _scatter_drop(cal.ts, flat, ts_s)
    new_seed = _scatter_drop(cal.seed, flat, seed_s)
    new_pay = _scatter_drop(cal.payload, flat, pay_s)

    cnt_flat = torch.zeros(sentinel + 1, dtype=torch.int32,
                           device=cal.cnt.device)
    cnt_flat[:sentinel] = cal.cnt.reshape(-1)
    cnt_flat.index_add_(0, torch.where(ok, ks, sentinel),
                        torch.ones_like(ks, dtype=torch.int32))
    new_cnt = cnt_flat[:sentinel].view(cal.cnt.shape)
    return Calendar(new_ts, new_seed, new_pay, new_cnt), n_overflow


def _bucket(cal: Calendar, epoch: torch.Tensor) -> torch.Tensor:
    """Bucket index of ``epoch`` for every row, i64 [n_local, 1], on the
    device (no host read).  ``epoch`` is one epoch or one per row (the rows
    of stacked replications, each at its own epoch)."""
    b = epoch.to(torch.int64).reshape(-1) % cal.n_buckets
    return b.expand(cal.n_local)[:, None]


def bucket_occupancy(cal: Calendar, epoch: torch.Tensor) -> torch.Tensor:
    """Per-row event count of the bucket holding ``epoch`` — no drain."""
    return torch.gather(cal.cnt, 1, _bucket(cal, epoch)).squeeze(1)


def extract_sorted(cal: Calendar, epoch: torch.Tensor,
                   take: torch.Tensor | None = None):
    """Drain the bucket for ``epoch`` (one epoch, or one per row):
    per-object events sorted by (ts, seed).

    ``take`` (bool [n_local]) masks the extract per row: a row it leaves
    out reads a count of 0 and keeps its bucket as it was, so that the
    engine can skip an epoch for some rows without a host read (the
    speculative step's sub-epochs past a replication's window, or a
    replication at its bound).

    Returns (calendar-with-cleared-bucket, ts, seed, payload, cnt_b), the
    event arrays [n_local, cap] with invalid slots at ts=+inf.
    """
    n_local, n_buckets, cap = cal.ts.shape
    b = _bucket(cal, epoch)
    slots = b[:, :, None].expand(n_local, 1, cap)
    raw_ts = torch.gather(cal.ts, 1, slots).squeeze(1)
    seed = torch.gather(cal.seed, 1, slots).squeeze(1)
    pay = torch.gather(cal.payload, 1, slots).squeeze(1)
    raw_cnt = torch.gather(cal.cnt, 1, b).squeeze(1)
    cnt_b = raw_cnt if take is None else torch.where(take, raw_cnt, 0)
    ts = raw_ts

    live = torch.arange(cap, device=ts.device)[None, :] < cnt_b[:, None]
    ts = torch.where(live, ts, float("inf"))

    # lexicographic (ts, seed): two stable argsorts composed.  Seeds are
    # non-negative int64, so their order is the unsigned u32 order.
    p1 = torch.sort(seed, dim=1, stable=True).indices
    ts1 = torch.gather(ts, 1, p1)
    p2 = torch.sort(ts1, dim=1, stable=True).indices
    order = torch.gather(p1, 1, p2)

    ts = torch.gather(ts, 1, order)
    seed = torch.gather(seed, 1, order)
    pay = torch.gather(pay, 1, order)

    # clear the bucket for reuse (epoch + n_buckets); a row left out keeps
    # its own.
    if take is None:
        new_cnt = cal.cnt.scatter(1, b, 0)
        new_ts = cal.ts.scatter(1, slots, float("inf"))
    else:
        new_cnt = cal.cnt.scatter(1, b, (raw_cnt - cnt_b)[:, None])
        new_ts = cal.ts.scatter(1, slots, torch.where(
            take[:, None], float("inf"), raw_ts)[:, None, :])
    return cal._replace(ts=new_ts, cnt=new_cnt), ts, seed, pay, cnt_b


def take_rows(cal: Calendar, idx: torch.Tensor) -> Calendar:
    """Whole per-object calendar rows (every bucket and slot) at ``idx``:
    the bulk extract of a migration (:mod:`.pipeline.rebalance`).  Bucket
    indices are absolute epochs modulo ``n_buckets`` on every device, so a
    row stays valid wherever it lands."""
    idx = idx.long()
    return Calendar(cal.ts[idx], cal.seed[idx], cal.payload[idx],
                    cal.cnt[idx])


def put_rows(cal: Calendar, idx: torch.Tensor, rows: Calendar,
             mask: torch.Tensor) -> Calendar:
    """Overwrite the calendar rows at ``idx`` where ``mask`` holds with
    ``rows`` (the reinsert of a migration); masked-off rows go to a
    sentinel row that is sliced off."""
    safe = torch.where(mask, idx.long(), cal.n_local)

    def put(dst, src):
        buf = torch.cat([dst, dst[:1]])
        buf[safe] = src
        return buf[:-1]
    return Calendar(put(cal.ts, rows.ts), put(cal.seed, rows.seed),
                    put(cal.payload, rows.payload), put(cal.cnt, rows.cnt))


def clear_rows(cal: Calendar, dead: torch.Tensor) -> Calendar:
    """Deaden the rows where ``dead`` holds: counts 0, timestamps +inf
    (slots that no longer back a live object)."""
    cnt = torch.where(dead[:, None], 0, cal.cnt)
    ts = torch.where(dead[:, None, None], float("inf"), cal.ts)
    return cal._replace(ts=ts, cnt=cnt)


def _window(cal: Calendar, first_epoch: torch.Tensor, n: int) -> torch.Tensor:
    """Bucket indices of epochs ``first_epoch .. first_epoch + n - 1``,
    i64 [n_local, n] (``first_epoch``: one epoch, or one per row)."""
    e = first_epoch.to(torch.int64).reshape(-1, 1) + torch.arange(
        n, dtype=torch.int64, device=cal.cnt.device)
    return (e % cal.n_buckets).expand(cal.n_local, n)


def take_buckets(cal: Calendar, first_epoch: torch.Tensor, n: int
                 ) -> Calendar:
    """Snapshot ``n`` consecutive epoch buckets from ``first_epoch`` (one
    epoch, or one per row): a Calendar [n_local, n, cap] in window order
    (bucket index w holds epoch ``first_epoch + w``).  The shadow copy of
    the speculative step (:mod:`.pipeline.speculate`)."""
    idx = _window(cal, first_epoch, n)
    slots = idx[:, :, None].expand(-1, -1, cal.cap)
    return Calendar(torch.gather(cal.ts, 1, slots),
                    torch.gather(cal.seed, 1, slots),
                    torch.gather(cal.payload, 1, slots),
                    torch.gather(cal.cnt, 1, idx))


def put_buckets(cal: Calendar, first_epoch: torch.Tensor, shadow: Calendar
                ) -> Calendar:
    """Restore a :func:`take_buckets` snapshot wholesale (the rollback):
    every slot of the window's buckets is overwritten from the shadow, the
    other buckets are untouched."""
    idx = _window(cal, first_epoch, shadow.n_buckets)
    slots = idx[:, :, None].expand(-1, -1, cal.cap)
    return Calendar(cal.ts.scatter(1, slots, shadow.ts),
                    cal.seed.scatter(1, slots, shadow.seed),
                    cal.payload.scatter(1, slots, shadow.payload),
                    cal.cnt.scatter(1, idx, shadow.cnt))


class Fallback(NamedTuple):
    """The per-thread TLS fallback list (paper §II-B) → per-device buffer.

    Events beyond the calendar horizon (or that missed the route capacity)
    park here with their global dst and are re-offered every epoch.
    """

    events: EventBatch  # flat [cap]

    @property
    def cap(self) -> int:
        return self.events.capacity


def make_fallback(cap: int, device) -> Fallback:
    return Fallback(empty_batch(cap, device=device))


def fallback_put(fb: Fallback, new: EventBatch):
    """Append valid events of ``new`` into free slots of the fallback buffer
    (per replication along the last dim of a stacked [R, cap] buffer).

    Returns (fallback, n_overflow).  Compaction keeps live events in front.
    """
    merged = compact(concat_batches(fb.events, new))
    cap = fb.cap
    keep = EventBatch(*(x[..., :cap] for x in merged))
    return Fallback(keep), merged.valid[..., cap:].sum(-1)
