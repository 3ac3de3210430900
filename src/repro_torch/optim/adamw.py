"""AdamW with decoupled weight decay and global-norm clipping over nested
dicts of tensors (counterpart of ``repro/optim/adamw.py``).

Leaves are visited in ``jax.tree.leaves`` order (dict keys sorted), which
decides the order of ``global_norm``'s sum. The update is plain tensor
math, functional as the reference's: it returns new parameters and a new
state.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import tree_leaves, tree_map


def adamw_init(params) -> dict:
    """Zero moments (float32) and step 0, on the parameters' device."""
    zeros = lambda t: tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), t)
    device = tree_leaves(params)[0].device
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (sorted-key order) of their sums of
    squares, in float32."""
    total = 0
    for leaf in tree_leaves(tree):
        leaf = leaf.to(torch.float32)
        total = total + torch.sum(leaf * leaf)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


def adamw_update(params, grads, state, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.0, max_grad_norm=1.0):
    """One AdamW step: (new params, new state {"mu", "nu", "step"})."""
    if max_grad_norm:
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(p, g, mu, nu):
        g = g.to(torch.float32)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * (g * g)
        delta = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), {"mu": pick(1), "nu": pick(2), "step": step}
