"""Exportable duel-log ring: the data side of the online representation
loop (counterpart of ``repro/refresh/duel_log.py``).

The replay ring (``fgts.FGTSState``) keeps what the posterior's likelihood
needs. The refresh loop needs more: to re-run CCFT on live traffic and
calibrate it against the router's own selection bias, every logged duel
carries its query features, the routed pair, the outcome, the preference
it was served under, the act-time selection propensity and (when known)
the query's category. ``DuelLog`` is a fixed-capacity ring of that tuple,
folded inside the service's feedback programs (one masked scatter per
field, no host sync) and exported to the host for the offline job.

Capacity must be a power of two: the write head is ``count % capacity`` on
a wrapping int32 counter, consistent across the 2^31 wrap only for a
power of two (the contract of the pending and replay rings).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.fgts import scatter_drop
from repro_torch.device import resolve_device


class DuelLog(NamedTuple):
    """Ring of resolved live duels with their causal-logging companions."""
    x: torch.Tensor          # (C, d) float32: query features
    a1: torch.Tensor         # (C,)  int32: routed pair
    a2: torch.Tensor         # (C,)  int32
    y: torch.Tensor          # (C,)  float32: preference outcome (+1/-1)
    pref: torch.Tensor       # (C,)  float32: per-duel preference weight
    prop: torch.Tensor       # (C,)  float32: act-time pair propensity
    cat: torch.Tensor        # (C,)  int32: query category (-1 = unknown)
    issued_at: torch.Tensor  # (C,)  int32: service tick of the issue
    valid: torch.Tensor      # (C,)  bool: slot holds a folded duel
    count: torch.Tensor      # ()    int32: duels folded so far (write head)


def init_log(capacity: int, dim: int, device=None) -> DuelLog:
    """Empty log; ``capacity`` must be a power of two."""
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(
            f"DuelLog capacity must be a power of two (slot = count % "
            f"capacity on a wrapping int32 counter); got {capacity} — "
            f"round up with feedback_queue.next_pow2")
    dev = resolve_device(device)

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=dev)
    i32, f32 = torch.int32, torch.float32
    return DuelLog(
        x=full((capacity, dim), 0.0, f32),
        a1=full((capacity,), 0, i32), a2=full((capacity,), 0, i32),
        y=full((capacity,), 0.0, f32), pref=full((capacity,), 0.0, f32),
        prop=full((capacity,), 1.0, f32), cat=full((capacity,), -1, i32),
        issued_at=full((capacity,), 0, i32),
        valid=full((capacity,), False, torch.bool),
        count=full((), 0, i32))


def fold(log: DuelLog, x, a1, a2, y, pref, prop, cat, issued_at,
         mask) -> DuelLog:
    """Masked append of a resolved batch with one scatter per field (fixed
    shapes). Rows where ``mask`` is False (stale votes, bucket padding) are
    never written; kept row i lands at slot (count + rank_i) % C, rank
    over kept rows only, and a batch with more kept rows than slots keeps
    its last C, as a sequential append would."""
    cap = log.x.shape[0]
    mask = mask.to(torch.bool)
    rank = torch.cumsum(mask.to(torch.int32), dim=0, dtype=torch.int32) - 1
    n = torch.sum(mask, dtype=torch.int32)
    write = mask & (rank >= n - cap)          # over capacity: keep last C
    idx = torch.where(write, torch.remainder(log.count + rank, cap),
                      cap).long()

    def put(buf, v):
        return scatter_drop(buf, idx, v)
    return DuelLog(
        x=put(log.x, x), a1=put(log.a1, a1), a2=put(log.a2, a2),
        y=put(log.y, y), pref=put(log.pref, pref), prop=put(log.prop, prop),
        cat=put(log.cat, cat), issued_at=put(log.issued_at, issued_at),
        valid=put(log.valid, torch.ones_like(mask)),
        count=log.count + n)


def export(log: DuelLog) -> dict:
    """Device -> host export of the logged duels for the offline refresh
    job: one deliberate transfer of the whole ring (the refresh cadence is
    hundreds of batches, off the serving hot path). Returns the valid rows
    as numpy arrays and the write head as ``count``."""
    host = DuelLog(*(t.cpu() for t in log))
    keep = host.valid
    out = {f: getattr(host, f)[keep].numpy()
           for f in ("x", "a1", "a2", "y", "pref", "prop", "cat",
                     "issued_at")}
    out["count"] = int(host.count)
    return out
