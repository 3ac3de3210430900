"""Step functions for training, prefill and decode (counterpart of the
step functions of ``repro/launch/steps.py``).

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``, as the reference's does, with ``metrics``
{"loss", "nll", "aux"}: the gradient of ``lm.loss_fn`` by autograd (each
unit rematerialised), then AdamW at a fixed learning rate with weight
decay 0.1. The update is written into ``params`` and ``opt_state`` in
place (``optim.adamw_update_``), so the trees returned are the ones passed
in: a functional update would hold two copies of the parameters and both
moments at once. ``make_prefill_step`` and ``make_decode_step`` wrap
``lm.prefill`` and ``lm.decode_step``.

The reference's ``ShapeDtypeStruct`` and sharding helpers (``batch_specs``
through ``input_specs``) lower the steps onto TPU pod meshes for its
dry-runs; they belong to the dry-run port (ROADMAP Queue 1 item 5) and are
not here.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.optim import adamw_update_


def loss_and_grads(params: dict, batch: dict, cfg: ModelConfig,
                   moe_impl=None, unroll: bool = False):
    """(loss, {"nll", "aux"}, grads): ``lm.loss_fn`` and its gradient
    with respect to every parameter leaf, as a tree shaped as ``params``
    (each leaf's gradient in the leaf's dtype). The gradient is taken at
    detached views of the leaves, so ``params`` itself is left as it was
    (no leaf is marked as requiring grad)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = lm.loss_fn(tree_unflatten(params, leaves), batch,
                                   cfg, moe_impl=moe_impl, unroll=unroll)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def train_update(params, opt_state, batch, cfg: ModelConfig, lr,
                 moe_impl=None, unroll: bool = False):
    """One training step at learning rate ``lr`` (a float or a 0-d
    tensor): ``loss_and_grads``, then AdamW (weight decay 0.1) in place.
    Returns (params, opt_state, {"loss", "nll", "aux"})."""
    loss, metrics, grads = loss_and_grads(params, batch, cfg,
                                          moe_impl=moe_impl, unroll=unroll)
    params, opt_state = adamw_update_(params, grads, opt_state, lr,
                                      weight_decay=0.1)
    return params, opt_state, {"loss": loss, **metrics}


def make_train_step(cfg: ModelConfig, lr: float = 3e-4, moe_impl=None,
                    unroll: bool = False):
    def train_step(params, opt_state, batch):
        return train_update(params, opt_state, batch, cfg, lr,
                            moe_impl=moe_impl, unroll=unroll)
    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int, moe_impl=None,
                      unroll: bool = False):
    """``prefill_step(params, batch) -> (last_logits, cache)``. ``unroll``
    is accepted and changes nothing (``lm.forward`` says why)."""
    del unroll

    @torch.no_grad()
    def prefill_step(params, batch):
        return lm.prefill(params, batch, cfg, cache_len, moe_impl=moe_impl)
    return prefill_step


def make_decode_step(cfg: ModelConfig, unroll: bool = False):
    """``decode_step(params, cache, tokens, pos) -> (logits, cache)``; the
    cache is written in place (``lm.decode_step``)."""
    del unroll

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        return lm.decode_step(params, cache, tokens, pos, cfg)
    return decode_step
