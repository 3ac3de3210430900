"""AdamW with decoupled weight decay and global-norm clipping over nested
dicts of tensors (counterpart of ``repro/optim/adamw.py``).

Leaves are visited in ``jax.tree.leaves`` order (dict keys sorted), which
decides the order of ``global_norm``'s sum. ``adamw_update_`` holds the
arithmetic: it writes the step into the parameters and moments in place,
for the LMs, where a second copy of the parameters and both moments (25 GB
at granite-3-2b) would not fit beside the first, and it works on slices of
each large leaf, so its fp32 temporaries stay small. ``adamw_update`` is
the reference's functional form: ``adamw_update_`` on copies, returning new
parameters and a new state.

A bf16 gradient times the clip scale (an fp32 0-d tensor) would stay bf16
in torch, where JAX promotes it to fp32 before the update; the gradient is
widened first, as JAX does.
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
    """One AdamW step: (new params, new state {"mu", "nu", "step"}), the
    inputs left as they are (``adamw_update_`` on copies of them)."""
    with torch.no_grad():
        copy = lambda tree: tree_map(torch.clone, tree)
        new = {"mu": copy(state["mu"]), "nu": copy(state["nu"]),
               "step": state["step"].clone()}
        return adamw_update_(copy(params), grads, new, lr, b1=b1, b2=b2,
                             eps=eps, weight_decay=weight_decay,
                             max_grad_norm=max_grad_norm)


# elements per slice of a leaf that adamw_update_ updates at once
INPLACE_SLICE = 1 << 26


def _slices(n: int, numel: int) -> int:
    """How many slices of axis 0 (of length n) keep each near
    ``INPLACE_SLICE`` elements."""
    return max(1, min(n, numel // INPLACE_SLICE))


@torch.no_grad()
def adamw_update_(params, grads, state, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                  weight_decay=0.0, max_grad_norm=1.0):
    """One AdamW step in place: the parameters and ``state``'s moments and
    step are written over, and (params, state) are returned. The
    arithmetic is the reference's, operation for operation (each product
    and sum rounded where the reference rounds it), applied to slices of
    axis 0 of each large leaf, which an elementwise update does not
    notice."""
    scale = None
    if max_grad_norm:
        norm = global_norm(grads)
        scale = torch.clamp_max(max_grad_norm / (norm + 1e-9), 1.0)
    state["step"] += 1
    t = state["step"].to(torch.float32)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(p, g, mu, nu):
        # a new fp32 tensor: g is squared in place below
        g = (g.to(torch.float32) * scale if scale is not None
             else g.to(torch.float32, copy=True))
        mu.mul_(b1).add_((1 - b1) * g)
        g.mul_(g).mul_(1 - b2)
        nu.mul_(b2).add_(g)
        del g
        den = torch.sqrt(nu / c2).add_(eps)
        delta = (mu / c1).div_(den)
        del den
        p32 = p.to(torch.float32)
        if weight_decay:
            delta.add_(weight_decay * p32)
        p.copy_(p32.sub_(lr * delta))

    leaves = [tree_leaves(x) for x in (params, grads, state["mu"],
                                       state["nu"])]
    for p, g, mu, nu in zip(*leaves):
        if p.dim() == 0:
            upd(p, g, mu, nu)
            continue
        n = _slices(p.shape[0], p.numel())
        for parts in zip(*(x.chunk(n, 0) for x in (p, g, mu, nu))):
            upd(*parts)
    return params, state
