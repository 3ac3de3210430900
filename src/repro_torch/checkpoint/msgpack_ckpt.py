"""Msgpack pytree checkpoints, byte-compatible with the reference's
``repro/checkpoint/msgpack_ckpt.py`` (atomic write, step-indexed).

A checkpoint is one msgpack map: ``treedef``, the tree's structure as JAX
prints it, and ``leaves``, one ``{"dtype", "shape", "data"}`` record per
leaf (numpy dtype name, shape, raw bytes) in ``jax.tree.flatten`` order.
So a checkpoint the reference saved restores here and the reverse.

Trees are nested dicts (keys sorted, as JAX flattens them), lists,
tuples and NamedTuples (fields in declared order; a None field is an
empty node and holds no leaf), with tensors or numpy arrays as leaves:
the encoder's parameters, and a routing service's state, pending ring,
PRNG key and counters. Each leaf keeps its dtype (bool, int32, uint32,
float32, ...).
"""
from __future__ import annotations

import os
import tempfile

import msgpack
import numpy as np
import torch

from repro_torch.models.layers import tree_leaves as _leaves
from repro_torch.models.layers import tree_unflatten


def _treedef(tree) -> str:
    """The structure as ``str(jax.tree.flatten(tree)[1])`` prints it."""
    def spec(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {spec(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple) and hasattr(t, "_fields"):    # NamedTuple
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(spec(v) for v in t) + "])")
        if isinstance(t, tuple):
            inner = ", ".join(spec(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(spec(v) for v in t) + "]"
        return "*"
    return f"PyTreeDef({spec(tree)})"


def _record(leaf) -> dict:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def _encode(tree) -> bytes:
    payload = {"treedef": _treedef(tree),
               "leaves": [_record(leaf) for leaf in _leaves(tree)]}
    return msgpack.packb(payload, use_bin_type=True)


def save_checkpoint(path: str, step: int, tree) -> str:
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step:08d}.msgpack")
    fd, tmp = tempfile.mkstemp(dir=path)
    with os.fdopen(fd, "wb") as f:
        f.write(_encode(tree))
    os.replace(tmp, fname)
    return fname


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:13]) for f in os.listdir(path)
             if f.startswith("ckpt_") and f.endswith(".msgpack")]
    return max(steps) if steps else None


def restore_checkpoint(path: str, step: int, like):
    """Restore into the structure of ``like``: each leaf must have its
    shape; it comes back as a tensor of the stored dtype, on the device of
    the ``like`` leaf when that is a tensor (else on the CPU)."""
    fname = os.path.join(path, f"ckpt_{step:08d}.msgpack")
    with open(fname, "rb") as f:
        payload = msgpack.unpackb(f.read(), raw=False)
    refs, stored = _leaves(like), payload["leaves"]
    if len(stored) != len(refs):
        raise ValueError(f"checkpoint structure mismatch: {len(stored)} "
                         f"leaves stored, {len(refs)} expected")
    out = []
    for rec, ref in zip(stored, refs):
        arr = np.frombuffer(rec["data"], dtype=rec["dtype"])
        t = torch.from_numpy(arr.reshape(rec["shape"]).copy())
        if tuple(t.shape) != tuple(np.shape(ref)):
            raise ValueError(f"leaf shape {tuple(t.shape)} stored, "
                             f"{tuple(np.shape(ref))} expected")
        out.append(t.to(ref.device) if isinstance(ref, torch.Tensor) else t)
    return tree_unflatten(like, out)
