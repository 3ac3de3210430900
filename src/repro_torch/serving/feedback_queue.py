"""Fixed-capacity pending-duels ring: the async-feedback subsystem
(counterpart of ``repro/serving/feedback_queue.py``).

Votes never arrive in lockstep with routing: users answer seconds to
hours later, out of order, twice or never. ``route_batch`` *issues* duels
into ``PendingDuels`` (one scatter per field, one int32 ticket per duel);
``resolve`` looks returned tickets up (one gather), validates them against
the live slots and hands the (x, a1, a2, y, age) batch to the policy's
update. Slots are ``ticket % capacity``, so the buffer is a ring: with
more than ``capacity`` duels in flight the oldest are overwritten and
their tickets stop validating (expiry by overwrite); ``expire`` adds
age-based expiry.

Two addressing modes share the ``PendingDuels`` tuple: **global**
(``enqueue`` / ``resolve``: one ticket counter, slot = ticket % capacity;
the tick-batch service) and **shard-local** (``enqueue_stream`` /
``resolve_stream``: a ``(shards,)`` counter, strided tickets ``seq *
n_shards + shard``, a padding mask; the streaming service, which passes
one shard).

Tickets, slots and ages are modular int32: a ticket or a tick that
crosses 2^31 wraps, and every comparison stays right across the wrap as
long as the capacity divides 2^32 (``init_pending`` enforces a power of
two). Everything is tensor math of fixed shapes with no host read, so the
hot path never synchronises with the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.fgts import ring_slots, scatter_drop
from repro_torch.device import resolve_device


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(n - 1, 0).bit_length()


class PendingDuels(NamedTuple):
    """Ring of issued-but-unresolved duels (slot = ticket % C)."""
    x: torch.Tensor            # (C, d) float32: query features at issue
    a1: torch.Tensor           # (C,)  int32: routed pair
    a2: torch.Tensor           # (C,)  int32
    ticket: torch.Tensor       # (C,)  int32: ticket holding the slot
    issued_at: torch.Tensor    # (C,)  int32: service tick at issue
    valid: torch.Tensor        # (C,)  bool: slot holds an unresolved duel
    next_ticket: torch.Tensor  # ()    int32: tickets issued so far; in
    #                            the shard-local mode a (S,) per-shard
    #                            sequence counter (see enqueue_stream)
    pref: torch.Tensor | None = None  # (C,) f32: per-duel preference
    prop: torch.Tensor | None = None  # (C,) f32: act-time pair propensity
    cat: torch.Tensor | None = None   # (C,) int32: query category (-1)


class ResolvedDuels(NamedTuple):
    """Gathered feedback batch: rows with ``ok`` False are stale or unknown
    tickets (already resolved, expired, or overwritten)."""
    x: torch.Tensor            # (B, d)
    a1: torch.Tensor           # (B,)
    a2: torch.Tensor           # (B,)
    y: torch.Tensor            # (B,)  the caller's votes, passed through
    age: torch.Tensor          # (B,)  int32: now - issued_at (modular)
    ok: torch.Tensor           # (B,)  bool
    pref: torch.Tensor | None = None
    prop: torch.Tensor | None = None
    cat: torch.Tensor | None = None


def wrap32(v: int) -> int:
    """A Python int reduced into int32's range, as int32 arithmetic wraps."""
    return ((int(v) + 2 ** 31) % 2 ** 32) - 2 ** 31


def as_i32(v, device) -> torch.Tensor:
    """An int32 tensor on ``device``: a tensor is cast in place on the
    device; a Python int enters as a fill (``torch.full``), not a host copy,
    so a card run does not synchronise."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32)
    return torch.full((), wrap32(v), dtype=torch.int32, device=device)


def init_pending(capacity: int, dim: int, device=None,
                 shards: int | None = None) -> PendingDuels:
    """Empty ring. ``capacity`` must be a power of two: only then does
    slot = ticket % capacity stay injective on live tickets across the
    int32 wrap. ``shards`` switches to the shard-local streaming layout, a
    (shards,) ``next_ticket`` for ``enqueue_stream``'s strided tickets
    (a power of two that divides the capacity)."""
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(
            f"PendingDuels capacity must be a power of two for "
            f"collision-free slot addressing across the int32 ticket wrap "
            f"(slot = ticket % capacity only stays injective on live "
            f"tickets when capacity divides 2^32); got {capacity} — round "
            f"up with feedback_queue.next_pow2")
    if shards is not None:
        if shards < 1 or shards & (shards - 1):
            raise ValueError(
                f"shard-local ring: shards must be a power of two so the "
                f"strided ticket encoding (ticket = seq * shards + shard) "
                f"is exactly invertible across the int32 wrap; got "
                f"{shards}")
        if capacity % shards:
            raise ValueError(
                f"shard-local ring: capacity {capacity} must divide over "
                f"{shards} shards")
    dev = resolve_device(device)

    def z(*shape, dt=torch.int32):
        return torch.zeros(shape, dtype=dt, device=dev)
    return PendingDuels(
        x=z(capacity, dim, dt=torch.float32),
        a1=z(capacity),
        a2=z(capacity),
        ticket=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        issued_at=z(capacity),
        valid=z(capacity, dt=torch.bool),
        next_ticket=z() if shards is None else z(shards),
        pref=z(capacity, dt=torch.float32),
        prop=torch.ones((capacity,), dtype=torch.float32, device=dev),
        cat=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
    )


def enqueue(q: PendingDuels, x: torch.Tensor, a1: torch.Tensor,
            a2: torch.Tensor, now, pref: torch.Tensor | None = None,
            prop: torch.Tensor | None = None,
            cat: torch.Tensor | None = None, *,
            share: tuple[int, int] | None = None):
    """Issue B duels: one scatter per field; returns (ring', tickets (B,)).

    A full ring overwrites its oldest duels. When B itself exceeds the
    capacity only the last C rows survive: the earlier tickets are issued
    already expired (as ``fgts.ring_slots`` keeps the indices unique).
    ``pref`` is the preference each duel was served under (None = zeros).

    ``share=(lo, capacity)``: ``q`` holds only slots [lo, lo + len(q.x))
    of a ring of ``capacity`` slots (a mesh rank's share); the tickets are
    the whole ring's and only the rows whose slots lie in the share are
    written."""
    b, dev = x.shape[0], q.x.device
    n_local = q.x.shape[0]
    cap = n_local if share is None else share[1]
    tickets = q.next_ticket + torch.arange(b, dtype=torch.int32, device=dev)
    drop, idx = ring_slots(q.next_ticket, cap, b)
    now = as_i32(now, dev)
    if pref is None:
        pref = torch.zeros((b,), dtype=torch.float32, device=dev)
    if prop is None:
        prop = torch.ones((b,), dtype=torch.float32, device=dev)
    if cat is None:
        cat = torch.full((b,), -1, dtype=torch.int32, device=dev)
    if share is None:
        def put(buf, v):
            return None if buf is None else \
                buf.index_put((idx,), v[drop:].to(buf.dtype))
    else:
        local = idx - share[0]
        local = torch.where((local >= 0) & (local < n_local), local, n_local)

        def put(buf, v):                          # index n_local: dropped
            return None if buf is None else \
                scatter_drop(buf, local, v[drop:])
    return q._replace(
        x=put(q.x, x), a1=put(q.a1, a1), a2=put(q.a2, a2),
        ticket=put(q.ticket, tickets),
        issued_at=put(q.issued_at, now.expand(b)),
        valid=put(q.valid, torch.ones((b,), dtype=torch.bool, device=dev)),
        next_ticket=q.next_ticket + b,
        pref=put(q.pref, pref), prop=put(q.prop, prop), cat=put(q.cat, cat),
    ), tickets


def resolve(q: PendingDuels, tickets: torch.Tensor, y: torch.Tensor, now,
            max_age: int | None = None, *,
            share: tuple[int, int] | None = None):
    """Look up a batch of tickets and clear the slots that validate;
    returns (ring', ``ResolvedDuels``).

    A ticket validates iff its slot still holds it (``valid`` and the same
    ticket id) and, with ``max_age``, its duel has not aged out. Every
    *matched* ticket is consumed: a vote that comes too late clears its
    slot (``ok`` False) instead of leaving a duel that can never be
    redeemed. Duplicate tickets in one call fold at most once: a scatter-min
    over slot collisions keeps the first matching row per slot. Ages are
    modular int32 differences, so a duel issued before the 2^31 tick
    boundary ages normally across it; a negative age means older than 2^31
    ticks, and such a row never validates.

    ``share=(lo, capacity)``: ``q`` is a mesh rank's share of the ring (as
    in ``enqueue``). Rows whose slots lie outside it never validate and
    come back all zeros (``y`` aside), so summing the ranks' batches word
    by word gives the whole ring's batch."""
    n_local, dev = q.x.shape[0], q.x.device
    tickets = tickets.to(torch.int32)
    now = as_i32(now, dev)
    own = None
    if share is None:
        slots = torch.remainder(tickets, n_local).long()  # floors, as jnp's %
    else:
        slots = torch.remainder(tickets, share[1]) - share[0]
        own = (slots >= 0) & (slots < n_local)
        slots = torch.where(own, slots, 0).long()
    age = now - q.issued_at[slots]                  # int32: wraps
    matched = q.valid[slots] & (q.ticket[slots] == tickets)
    if own is not None:
        matched = matched & own
    b = tickets.shape[0]
    rows = torch.arange(b, dtype=torch.int32, device=dev)
    first = torch.full((n_local,), b, dtype=torch.int32, device=dev) \
        .scatter_reduce(0, slots, torch.where(matched, rows, b), "amin",
                        include_self=True)
    matched = matched & (first[slots] == rows)
    ok = matched & (age >= 0)
    if max_age is not None:
        ok = ok & (age <= max_age)
    # scatter-max marks consumed slots, whatever the order of collisions
    hit = torch.zeros((n_local,), dtype=torch.int32, device=dev) \
        .scatter_reduce(0, slots, matched.to(torch.int32), "amax",
                        include_self=True)

    def take(buf):
        if buf is None:
            return None
        v = buf[slots]
        if own is None:
            return v
        return torch.where(own if v.dim() == 1 else own[:, None], v,
                           torch.zeros((), dtype=v.dtype, device=dev))
    batch = ResolvedDuels(
        x=take(q.x), a1=take(q.a1), a2=take(q.a2), y=y,
        age=age if own is None else torch.where(own, age, 0), ok=ok,
        pref=take(q.pref), prop=take(q.prop), cat=take(q.cat))
    return q._replace(valid=q.valid & (hit == 0)), batch


def expire(q: PendingDuels, now, max_age: int):
    """Drop every pending duel older than ``max_age`` ticks (or with a
    negative, wrapped age); returns (ring', the count dropped as a 0-d
    int32 tensor)."""
    age = as_i32(now, q.x.device) - q.issued_at
    keep = (age >= 0) & (age <= max_age)
    dropped = torch.sum(q.valid & ~keep, dtype=torch.int32)
    return q._replace(valid=q.valid & keep), dropped


def pending_count(q: PendingDuels) -> torch.Tensor:
    """In-flight (issued, unresolved, unexpired) duels, a 0-d int32."""
    return torch.sum(q.valid, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Shard-local streaming mode: masked enqueue, strided tickets, local resolve
# ---------------------------------------------------------------------------
#
# Every array these functions touch is one shard's: the (C/S, d) rows of
# the ring it owns, its element of the per-shard counter, the rows of the
# batch it routed. ``shard`` is the shard's index and ``n_shards`` the
# shard count (a power of two); one device passes 0 and 1. A ticket encodes
# its issuing shard (ticket = seq * n_shards + shard), so enqueue and
# resolve never address another shard's rows.

def enqueue_stream(q: PendingDuels, x: torch.Tensor, a1: torch.Tensor,
                   a2: torch.Tensor, now, pref: torch.Tensor,
                   mask: torch.Tensor, shard, n_shards: int,
                   prop: torch.Tensor | None = None,
                   cat: torch.Tensor | None = None):
    """Masked shard-local issue; returns (ring', tickets (B,)). Rows where
    ``mask`` is False (bucket padding) are never written and get ticket -1.

    Live rows take consecutive sequence numbers (a cumsum rank, so the
    slots written are those a compacted batch would write) and their
    tickets are strided by the shard count; slot = seq % cap. When more
    live rows than slots arrive in one call only the last ``cap``
    survive, as ``enqueue``'s expiry by overwrite."""
    cap, dev = q.x.shape[0], q.x.device
    mask = mask.to(torch.bool)
    mask_i = mask.to(torch.int32)
    rank = torch.cumsum(mask_i, dim=0, dtype=torch.int32) - 1
    n = torch.sum(mask_i, dtype=torch.int32)
    seq = (q.next_ticket[0] if q.next_ticket.dim() else q.next_ticket) \
        + rank
    shard = as_i32(shard, dev)
    tickets = torch.where(mask, seq * n_shards + shard, -1)
    write = mask & (rank >= n - cap)              # over capacity: last C
    idx = torch.where(write, torch.remainder(seq, cap), cap).long()
    now = as_i32(now, dev)
    b = mask.shape[0]
    if prop is None:
        prop = torch.ones((b,), dtype=torch.float32, device=dev)
    if cat is None:
        cat = torch.full((b,), -1, dtype=torch.int32, device=dev)

    def put(buf, v):                              # index cap: dropped
        return None if buf is None else scatter_drop(buf, idx, v)
    return q._replace(
        x=put(q.x, x), a1=put(q.a1, a1), a2=put(q.a2, a2),
        ticket=put(q.ticket, tickets), issued_at=put(q.issued_at,
                                                     now.expand(b)),
        valid=put(q.valid, torch.ones((b,), dtype=torch.bool, device=dev)),
        next_ticket=q.next_ticket + n, pref=put(q.pref, pref),
        prop=put(q.prop, prop), cat=put(q.cat, cat)), tickets


def resolve_stream(q: PendingDuels, tickets: torch.Tensor, y: torch.Tensor,
                   mask: torch.Tensor, now, shard, n_shards: int,
                   max_age: int | None = None):
    """Shard-local twin of ``resolve`` with a padding mask; returns
    (ring', ``ResolvedDuels``).

    A ticket is owned by shard ``ticket % n_shards``; rows this shard does
    not own, and padding rows, never validate. The sequence number is
    recovered exactly, ``(ticket - shard) // n_shards``, and the full
    stored ticket compared, so stale, overwritten, over-age and duplicate
    deliveries behave as in ``resolve`` (first delivery wins)."""
    cap, dev = q.x.shape[0], q.x.device
    tickets = tickets.to(torch.int32)
    now = as_i32(now, dev)
    shard = as_i32(shard, dev)
    owner = torch.remainder(tickets, n_shards) == shard
    seq = torch.div(tickets - shard, n_shards, rounding_mode="floor")
    slots = torch.remainder(seq, cap).long()
    age = now - q.issued_at[slots]                  # int32: wraps
    matched = (owner & mask.to(torch.bool) & q.valid[slots]
               & (q.ticket[slots] == tickets))
    b = tickets.shape[0]
    rows = torch.arange(b, dtype=torch.int32, device=dev)
    first = torch.full((cap,), b, dtype=torch.int32, device=dev) \
        .scatter_reduce(0, slots, torch.where(matched, rows, b), "amin",
                        include_self=True)
    matched = matched & (first[slots] == rows)
    ok = matched & (age >= 0)
    if max_age is not None:
        ok = ok & (age <= max_age)
    hit = torch.zeros((cap,), dtype=torch.int32, device=dev) \
        .scatter_reduce(0, slots, matched.to(torch.int32), "amax",
                        include_self=True)
    batch = ResolvedDuels(
        x=q.x[slots], a1=q.a1[slots], a2=q.a2[slots], y=y, age=age, ok=ok,
        pref=None if q.pref is None else q.pref[slots],
        prop=None if q.prop is None else q.prop[slots],
        cat=None if q.cat is None else q.cat[slots])
    return q._replace(valid=q.valid & (hit == 0)), batch
