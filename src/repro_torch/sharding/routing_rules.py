"""Sharding rules of the routing service (counterpart of
``repro/sharding/routing_rules.py``): which dimension of every tensor the
mesh service and the router dry-run split over the batch ranks, and the
collectives that move rows between them.

Policy (mesh axes ("data", "model") or ("pod", "data", "model")):

* the **query batch** is the scale dimension: (B, d) features, (B,) arms,
  tickets and votes split over the batch axes ("pod", "data"), flattened
  in row-major order (``shard_index``). The "model" axis idles: ranks that
  differ only along it route the same rows.
* the **pending ring** splits its capacity axis over the batch axes: rank
  s holds slots [s C/S, (s+1) C/S) of the tick-batch ring (slot = ticket
  % C) and the shard-local ring's rows and sequence counter of the
  streaming service. Capacity must divide over the shards
  (``round_capacity``).
* **policy state is replicated**: every rank holds the posterior chains,
  the replay ring and the counters, recomputes the SGLD refresh from the
  same draws and folds the same resolved batch, gathered over the batch
  ranks (``gather_rows`` / ``sum_rows``) in the unsharded row order.

The port has no ``PartitionSpec``; ``P`` is its stand-in: entry i names
the mesh axes dimension i splits over, None a replicated dimension.
``local_shape`` turns a spec and a global shape into one rank's shape (the
dry-run's bytes held).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.refresh.duel_log import DuelLog
from repro_torch.serving.feedback_queue import (PendingDuels, ResolvedDuels,
                                                next_pow2)


class P(tuple):
    """A partition spec: one entry per dimension, the mesh axes (a name or
    a tuple of names) it splits over, or None (replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, or of any object with
    ``axis_names`` and a ``shape`` mapping names to sizes."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def batch_axes(mesh) -> tuple:
    """Mesh axes that split the routing batch dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def n_batch_shards(mesh) -> int:
    """Number of shards the batch (and the pending ring) is split into."""
    sizes = _sizes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


def round_capacity(capacity: int, mesh) -> int:
    """Smallest pending-ring capacity >= requested that the mesh divides.

    The ring's slot addressing is modular on a wrapping int32 ticket, so
    the capacity must be a power of two; for it to divide over the mesh
    the batch-shard count must be one too. Other meshes fail here."""
    n = n_batch_shards(mesh)
    if n & (n - 1):
        raise ValueError(
            f"mesh has {n} batch shards ({_sizes(mesh)}): the pending "
            f"ring needs a power-of-two capacity (wrapping int32 slot "
            f"arithmetic) that divides over the shards, which requires a "
            f"power-of-two batch-shard count — reshape the mesh")
    return next_pow2(max(capacity, n))


def shard_index(mesh) -> int:
    """This rank's flat batch-shard index: its row-major position along
    the batch axes (the order rows and ring slots are laid out in)."""
    sizes = _sizes(mesh)
    i = 0
    for a in batch_axes(mesh):
        i = i * sizes[a] + mesh.get_local_rank(a)
    return i


def batch_group(mesh):
    """The process group of the ranks that share this rank's position on
    every axis but the batch axes, in ``shard_index`` order."""
    bx = batch_axes(mesh)
    if len(bx) == 1:
        return mesh.get_group(bx[0])
    return mesh[bx]._flatten("batch").get_group()


# ---------------------------------------------------------------------------
# Spec trees
# ---------------------------------------------------------------------------

def query_batch_spec(mesh) -> P:
    """(B, d) query features."""
    return P(batch_axes(mesh), None)


def per_query_spec(mesh) -> P:
    """(B,) per-query vectors: arms, tickets, votes, ages, ok masks."""
    return P(batch_axes(mesh))


def pref_spec(mesh) -> P:
    """(B,) per-request preference weights: split like every per-query
    vector, so each rank tilts only the rows it scores."""
    return per_query_spec(mesh)


def policy_state_spec(mesh) -> P:
    """Replicated policy state (posterior chains, replay ring, counters,
    the dynamic pool and the autopilot's controller): a spec for every
    leaf. A hot add/retire/swap and a control tick are replicated data
    updates."""
    return P()


def pending_specs(mesh) -> PendingDuels:
    """The tick-batch ring split over its capacity axis (rank s holds
    slots [s C/S, (s+1) C/S)); the ticket counter is replicated."""
    bx = batch_axes(mesh)
    return PendingDuels(x=P(bx, None), a1=P(bx), a2=P(bx), ticket=P(bx),
                        issued_at=P(bx), valid=P(bx), next_ticket=P(),
                        pref=P(bx), prop=P(bx), cat=P(bx))


def resolved_specs(mesh) -> ResolvedDuels:
    """A resolved batch as a rank resolves it: split over the batch axes.
    The fold reads its gather over the batch ranks, replicated."""
    bx = batch_axes(mesh)
    return ResolvedDuels(x=P(bx, None), a1=P(bx), a2=P(bx), y=P(bx),
                         age=P(bx), ok=P(bx), pref=P(bx), prop=P(bx),
                         cat=P(bx))


def stream_pending_specs(mesh) -> PendingDuels:
    """The shard-local streaming ring: the capacity axis splits as in
    ``pending_specs`` and so does the (S,) per-shard sequence counter, so
    every rank holds a (C/S)-row ring and its own counter, and enqueue and
    resolve need no collective (ticket = seq * S + shard)."""
    bx = batch_axes(mesh)
    return PendingDuels(x=P(bx, None), a1=P(bx), a2=P(bx), ticket=P(bx),
                        issued_at=P(bx), valid=P(bx), next_ticket=P(bx),
                        pref=P(bx), prop=P(bx), cat=P(bx))


def duel_log_specs(mesh) -> DuelLog:
    """The exportable duel log is replicated like the policy state: every
    rank folds the same gathered resolved batch into it."""
    return DuelLog(x=P(), a1=P(), a2=P(), y=P(), pref=P(), prop=P(),
                   cat=P(), issued_at=P(), valid=P(), count=P())


def local_shape(spec: P, shape: tuple, mesh) -> tuple:
    """One rank's share of a tensor of global ``shape`` under ``spec``."""
    sizes = _sizes(mesh)
    out = list(shape)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        for a in (axes,) if isinstance(axes, str) else axes:
            if out[i] % sizes[a]:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                                 f"divide over mesh axis {a!r} "
                                 f"({sizes[a]})")
            out[i] //= sizes[a]
    return tuple(out)


# ---------------------------------------------------------------------------
# Step-level spec tuples (the router dry-run)
# ---------------------------------------------------------------------------

def route_step_specs(mesh) -> tuple:
    """(x, a_emb, theta1, theta2, costs, active): the batch split, the
    rest replicated (K and d are small; the batch is the scale axis)."""
    return (query_batch_spec(mesh), P(None, None), P(None), P(None), P(None),
            P(None))


def update_step_specs(mesh) -> tuple:
    """(theta, replay x/a1/a2/y, t, a_emb) of one posterior refresh. The
    port replicates the replay ring with the rest of the policy state
    (every rank refreshes from its own copy); the reference splits the
    replay rows over the batch axes."""
    return (P(None), P(None, None), P(None), P(None), P(None), P(),
            P(None, None))


def resolve_step_specs(mesh) -> tuple:
    """(ring fields..., tickets, y, now) of a tick-batch resolve: the ring
    split over its capacity, the delivered votes (the host program's
    global batch) on every rank."""
    return tuple(pending_specs(mesh)) + (P(None), P(None), P())


# ---------------------------------------------------------------------------
# Collectives over the batch ranks
# ---------------------------------------------------------------------------

_TALLY: dict | None = None


@contextlib.contextmanager
def tally():
    """Count the bytes each collective of ``gather_rows`` / ``sum_rows``
    moves per rank (its output), by operation, inside the block."""
    global _TALLY
    outer, _TALLY = _TALLY, {}
    try:
        yield _TALLY
    finally:
        _TALLY = outer


def _count(op: str, t: torch.Tensor) -> None:
    if _TALLY is not None:
        rec = _TALLY.setdefault(op, {"bytes": 0, "count": 0})
        rec["bytes"] += t.numel() * t.element_size()
        rec["count"] += 1


def gather_rows(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """All-gather a (b, ...) tensor over the ``n`` ranks of ``group`` along
    dim 0: (n b, ...), shard s's rows at [s b, (s+1) b)."""
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    _count("all_gather", out)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def sum_rows(t: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) ``t`` in place over ``group``. On int32 words
    where one rank holds each row and the others zeros, the sum is that
    rank's row bit for bit."""
    _count("all_reduce", t)
    dist.all_reduce(t, group=group)
    return t


def pack_rows(cols) -> torch.Tensor:
    """Columns (B,) or (B, w) of float32, int32 or bool -> one (B, W)
    int32 tensor of their 4-byte words (floats by bit view)."""
    words = []
    for c in cols:
        c = c if c.dim() == 2 else c[:, None]
        words.append(c.view(torch.int32) if c.dtype == torch.float32
                     else c.to(torch.int32))
    return torch.cat(words, dim=1)


def unpack_rows(packed: torch.Tensor, like) -> list:
    """The inverse of ``pack_rows``: the columns ``like`` give each
    column's dtype and trailing width."""
    out, at = [], 0
    for c in like:
        dt, w = c.dtype, c.shape[1] if c.dim() == 2 else 0
        v = packed[:, at:at + max(w, 1)]
        at += max(w, 1)
        if dt == torch.float32:
            v = v.contiguous().view(torch.float32)
        elif dt == torch.bool:
            v = v != 0
        else:
            v = v.to(dt)
        out.append(v if w else v[:, 0])
    return out
