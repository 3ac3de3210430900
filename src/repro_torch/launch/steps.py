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

The input specs (``batch_specs`` through ``input_specs``) are the
reference's ``ShapeDtypeStruct`` trees as tensors on the ``meta`` device:
shapes and dtypes, no storage. ``input_specs`` returns each step's
arguments, their ``sharding/rules.py`` spec trees and the port's step
function, the currency of ``launch/dryrun.py``. The reference's
``tree_shardings`` (``NamedSharding`` trees for ``jax.jit``) has no
counterpart: the dry-run reads the specs through
``routing_rules.local_shape``.

VLM note: for ``train_4k`` the 4096-token budget includes the anyres patch
prefix (2880 patch embeddings + 1216 text tokens); decode shapes assume
the image prefix is already in the KV cache. Audio note: the encoder
consumes ``cfg.enc_frames`` frame embeddings; decoder length = the shape's
seq_len.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch

from repro_torch.configs.shapes import InputShape
from repro_torch.models import blocks as blk
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw_init, adamw_update_
from repro_torch.sharding import rules
from repro_torch.sharding.routing_rules import P


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


# ---------------------------------------------------------------------------
# Input specs on the meta device (no allocation: the dry-run's currency)
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    """A shape and dtype without storage (``jax.ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The model inputs of a train or prefill step: tokens (and labels),
    a vision model's patches, an encoder-decoder model's frames."""
    b, s = shape.global_batch, shape.seq_len
    dt = lm._dtype(cfg)
    out: dict[str, Any] = {}
    text = s
    if cfg.frontend == "vision":
        text = s - cfg.n_frontend_tokens
        out["patches"] = _sds((b, cfg.n_frontend_tokens, cfg.d_model), dt)
    if cfg.is_encdec:
        out["frames"] = _sds((b, cfg.enc_frames, cfg.d_model), dt)
    out["tokens"] = _sds((b, text), torch.int32)
    if shape.kind == "train":
        out["labels"] = _sds((b, text), torch.int32)
    return out


def _meta(tree):
    return tree_map(lambda t: _sds(t.shape, t.dtype), tree)


@functools.lru_cache(maxsize=32)
def _unit_sds(cfg: ModelConfig, specs: tuple) -> dict:
    """One unit of ``specs``' parameters (``blocks.init_unit`` under
    ``FakeTensorMode``: shapes only) on the meta device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        unit = blk.init_unit(torch.Generator(), cfg, specs, lm._dtype(cfg),
                             "cpu")
    return _meta(unit)


def unit_params_specs(cfg: ModelConfig, specs) -> dict:
    """One unit's parameter tree on the meta device (no stacked axis)."""
    return _meta(_unit_sds(cfg, tuple(specs)))


def _stacked(unit: dict, n: int) -> dict:
    return tree_map(lambda t: _sds((n, *t.shape), t.dtype), unit)


def params_specs(cfg: ModelConfig) -> dict:
    """``lm.init_params``' tree on the meta device, reckoned from one unit
    of each stack (``init_params`` itself would draw every weight)."""
    dt = lm._dtype(cfg)
    d, f32 = cfg.d_model, torch.float32
    p: dict = {
        "embed": _sds((cfg.vocab_size, d), dt),
        "units": _stacked(_unit_sds(cfg, cfg.pattern), cfg.n_units),
        "final_norm": _sds((d,), f32),
    }
    if cfg.remainder:
        p["remainder"] = unit_params_specs(cfg, cfg.remainder)
    if not cfg.tie_embeddings:
        p["lm_head"] = _sds((cfg.vocab_size, d), dt)
    if cfg.frontend == "vision":
        p["vis_proj"] = _sds((d, d), dt)
    if cfg.is_encdec:
        p["enc_units"] = _stacked(_unit_sds(cfg, cfg.enc_pattern),
                                  cfg.enc_n_units)
        p["enc_norm"] = _sds((d,), f32)
    return p


def opt_specs(params_sds) -> dict:
    """``optim.adamw_init``'s state on the meta device."""
    return adamw_init(params_sds)


def cache_sds(cfg: ModelConfig, batch: int, cache_len: int,
              enc_len: int = 0) -> dict:
    """``lm.init_cache``'s tree on the meta device."""
    return lm.init_cache(batch, cfg, cache_len, enc_len, device="meta")


def step_batch_axes(shape: InputShape, mesh) -> tuple:
    """The batch axes of ``shape``'s inputs on ``mesh``: a global batch
    that does not divide over them (long_500k's batch 1) is replicated."""
    bx = rules.batch_axes(mesh)
    sizes = rules.mesh_axis_sizes(mesh)
    if shape.global_batch % math.prod(sizes[a] for a in bx):
        return ()
    return bx


def _batch_spec_tree(batch: dict, bx: tuple) -> dict:
    return {k: P(bx, *((None,) * (t.dim() - 1))) for k, t in batch.items()}


def input_specs(cfg: ModelConfig, shape: InputShape, mesh,
                unroll: bool = False):
    """(args, in_specs, out_specs, step_fn) of ``shape``'s step on
    ``mesh``: the step's arguments on the meta device, the spec trees of
    its inputs and outputs, and the port's step function. ``unroll`` is
    handed to the step, which accepts it and changes nothing."""
    psp = rules.param_specs(cfg, mesh)
    params = params_specs(cfg)
    bx = step_batch_axes(shape, mesh)
    if shape.kind == "train":
        batch = batch_specs(cfg, shape)
        osp = rules.opt_state_specs(psp)
        args = (params, opt_specs(params), batch)
        in_sh = (psp, osp, _batch_spec_tree(batch, bx))
        out_sh = (psp, osp, {"loss": P(), "nll": P(), "aux": P()})
        return args, in_sh, out_sh, make_train_step(cfg, unroll=unroll)
    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape)
        csp = rules.cache_specs(cfg, mesh, bx=bx)
        step = make_prefill_step(cfg, cache_len=shape.seq_len, unroll=unroll)
        return ((params, batch), (psp, _batch_spec_tree(batch, bx)),
                (P(bx, None), csp), step)
    enc_len = cfg.enc_frames if cfg.is_encdec else 0
    cache = cache_sds(cfg, shape.global_batch, shape.seq_len, enc_len)
    csp = rules.cache_specs(cfg, mesh, bx=bx)
    tokens = _sds((shape.global_batch,), torch.int32)
    pos = _sds((), torch.int32)
    step = make_decode_step(cfg, unroll=unroll)
    return ((params, cache, tokens, pos), (psp, csp, P(bx), P()),
            (P(bx, None), csp), step)
