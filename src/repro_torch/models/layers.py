"""Shared primitive layers: RMSNorm, RoPE, gated MLP, embeddings, the
depthwise causal conv of the recurrent blocks
(counterpart of ``repro/models/layers.py``).

Initializers draw from an explicit ``torch.Generator`` on the generator's
device (a CPU generator gives a card run and a CPU run the same weights)
and move the result to ``device``.
"""
from __future__ import annotations

import numpy as np
import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in float32, back to x's
    dtype (the gain is ``1 + scale``: a zero scale is the identity)."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Rotary frequencies, computed in numpy float32 as the reference does."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotates the
    two halves of the head dim against each other (not interleaved
    pairs)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., seq, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                     # (..., seq, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gated_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: w2( silu(w1 x) * w3 x )."""
    h = torch.nn.functional.silu(x @ params["w1"]) * (x @ params["w3"])
    return h @ params["w2"]


def normal(gen: torch.Generator, shape, std: float, dtype,
           device) -> torch.Tensor:
    """std * N(0, 1) of ``shape`` from ``gen`` (on its own device), cast to
    ``dtype`` and moved to ``device``."""
    z = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    # in place: one fp32 temporary (arctic-480b's stacked experts are 18 GB
    # of fp32 each)
    return z.mul_(std).to(dtype=dtype, device=device)


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             device) -> dict:
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    return {
        "w1": normal(gen, (d_model, d_ff), s_in, dtype, device),
        "w3": normal(gen, (d_model, d_ff), s_in, dtype, device),
        "w2": normal(gen, (d_ff, d_model), s_ff, dtype, device),
    }


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype,
                   device) -> torch.Tensor:
    return normal(gen, (vocab, d_model), d_model ** -0.5, dtype, device)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def causal_conv(w: torch.Tensor, u: torch.Tensor,
                conv_state: torch.Tensor | None = None):
    """Depthwise causal conv of width W = ``w.shape[0]`` over u (B,S,C) in
    float32, its taps summed in the order k = 0..W-1 as the reference sums
    them; ``conv_state`` holds the W-1 inputs before u (zeros when None).
    Returns (out (B,S,C) float32, the last W-1 inputs in u's dtype)."""
    width = w.shape[0]
    wf = w.to(torch.float32)
    uf = u.to(torch.float32)
    if conv_state is None:
        pad = uf.new_zeros((u.shape[0], width - 1, u.shape[-1]))
    else:
        pad = conv_state.to(torch.float32)
    up = torch.cat([pad, uf], dim=1)                   # (B, S+W-1, C)
    s = u.shape[1]
    out = up[:, 0:s] * wf[0]
    for k in range(1, width):
        out = out + up[:, k:k + s] * wf[k]
    return out, up[:, -(width - 1):].to(u.dtype)


def tree_map(fn, *trees):
    """``fn`` on every tensor leaf of a nested dict (on the matching leaves
    of several equally shaped ones)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists, tuples and NamedTuples in
    ``jax.tree.leaves`` order: dict keys sorted, sequence and NamedTuple
    fields in order, None an empty node (no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` whose leaves are ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):    # NamedTuple
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def stack_trees(trees: list):
    """Stack the leaves of equally shaped nested dicts along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)
