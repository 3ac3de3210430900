"""The candidate LMs: decoder-only (dense, MoE, SSM, hybrid, VLM) and
encoder-decoder (audio); full-sequence forward, prefill and one-token
decode (counterpart of ``repro/models/lm.py``).

The parameter tree is the reference's: ``units`` holds the pattern's
blocks with every leaf stacked over a leading ``n_units`` axis (the
reference scans that axis; here a Python loop takes views ``t[i]``),
then ``remainder``, ``final_norm`` and the head (``embed`` when tied),
``vis_proj`` for the vision front end, and for an encoder-decoder model
``enc_units`` (stacked over ``enc_n_units``) and ``enc_norm``. The caches
stack the same way. So the reference's parameters and caches map
onto the port's leaf for leaf (``convert.lm_params_from_numpy``,
``convert.lm_cache_from_numpy``). ``decode_step`` updates the cache in
place rather than returning a new one, as the reference's functional
update does.

The embedding is scaled by sqrt(d_model) rounded to the weights' type
first, as ``jnp.asarray(d_model ** 0.5, dtype)`` is (45.25 for d_model
2048 in bf16, not 45.2548). The vision front end prepends
``batch["patches"] @ vis_proj`` to the token embeddings, with positions
running over patches and text together; an encoder-decoder model encodes
``batch["frames"]`` once (bidirectional units, then ``enc_norm``) and its
cross-attention layers attend to that memory, whose K/V prefill writes
into the cache, so decode needs no memory.

Training: ``loss_fn`` is the reference's masked next-token loss plus the
MoE load-balance term. ``forward`` rematerialises each unit of ``units``
(``remat=True``, the default, as the reference's ``jax.checkpoint`` of
``_unit_fwd``): with grad mode on, each unit runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which keeps
only the unit's input and runs the unit again in the backward. The
encoder's units are always rematerialised, as the reference's ``_encode``
does; the remainder never is. Units are taken from the stacked leaves by
``unbind``, whose backward stacks the units' gradients once, where a view
``t[i]`` per unit would add a full-size zero tensor into the leaf's
gradient per unit.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from . import blocks as blk
from .config import ModelConfig
from .layers import (init_embedding, normal, rms_norm, softcap, stack_trees,
                     tree_map)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _stacked_unit_init(gen, cfg, specs, n_units, dtype, device):
    """``n_units`` units stacked leaf by leaf, written into the stack one
    unit at a time (the peak is the stack plus one unit)."""
    first = blk.init_unit(gen, cfg, specs, dtype, device)
    out = tree_map(lambda t: t.new_empty((n_units, *t.shape)), first)

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v
    put(out, first, 0)
    for i in range(1, n_units):
        put(out, blk.init_unit(gen, cfg, specs, dtype, device), i)
    return out


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random weights from ``gen``, drawn on the generator's device (a
    generator on the card draws a 9 B-parameter model in seconds) and
    moved to ``device``."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    p: dict = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype, dev),
        "units": _stacked_unit_init(gen, cfg, cfg.pattern, cfg.n_units,
                                    dtype, dev),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=dev),
    }
    if cfg.remainder:
        p["remainder"] = blk.init_unit(gen, cfg, cfg.remainder, dtype, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype,
                                      dev)
    if cfg.frontend == "vision":
        p["vis_proj"] = normal(gen, (cfg.d_model, cfg.d_model),
                               cfg.d_model ** -0.5, dtype, dev)
    if cfg.is_encdec:
        p["enc_units"] = _stacked_unit_init(gen, cfg, cfg.enc_pattern,
                                            cfg.enc_n_units, dtype, dev)
        p["enc_norm"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                    device=dev)
    return p


def _embed(params, tokens, cfg):
    """Token embeddings times sqrt(d_model) in the weights' type."""
    emb = params["embed"]
    # a fill on the device: a tensor made from a Python number would be
    # copied from the host and wait for the card on every decode step
    scale = torch.full((), cfg.d_model ** 0.5, dtype=_dtype(cfg),
                       device=emb.device)
    return emb[tokens.long()] * scale


def _embed_inputs(params, batch, cfg):
    """The decoder input sequence and its positions from the batch: the
    patches' projection before the token embeddings for the vision front
    end, positions over both."""
    x = _embed(params, batch["tokens"], cfg)
    if cfg.frontend == "vision" and "patches" in batch:
        vis = batch["patches"].to(_dtype(cfg)) @ params["vis_proj"]
        x = torch.cat([vis, x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    return x, positions


def _units(params, stack="units"):
    """Views of each unit of the stacked ``params[stack]`` (``unbind``)."""
    n = params[stack]["0"]["norm1"].shape[0]
    parts = tree_map(lambda t: t.unbind(0), params[stack])
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def _unit_fwd(uparams, x, positions, cfg, specs, enc_memory=None,
              moe_impl=None):
    """One unit's blocks in order. Returns (x, the unit's aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, spec in enumerate(specs):
        x, a = blk.block_fwd(uparams[str(i)], x, positions, cfg, spec,
                             enc_memory=enc_memory, moe_impl=moe_impl)
        aux = aux + a
    return x, aux


def _stack_fwd(params, stack, x, positions, cfg, specs, enc_memory=None,
               moe_impl=None, remat=True):
    """The units of ``params[stack]`` in order, each under
    ``checkpoint(use_reentrant=False)`` when ``remat`` and grad mode is on.
    Returns (x, the units' summed aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    for u in _units(params, stack):
        if remat:
            x, a = checkpoint(_unit_fwd, u, x, positions, cfg, specs,
                              enc_memory, moe_impl, use_reentrant=False)
        else:
            x, a = _unit_fwd(u, x, positions, cfg, specs, enc_memory,
                             moe_impl)
        aux = aux + a
    return x, aux


def _encode(params, frames, cfg):
    """The encoder's memory (B,T,d) of ``frames`` (B,T,d): the
    bidirectional units (rematerialised under grad, as the reference's
    are), then ``enc_norm``."""
    x = frames.to(_dtype(cfg))
    b, t, _ = x.shape
    pos = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    x, _ = _stack_fwd(params, "enc_units", x, pos, cfg, cfg.enc_pattern)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _memory(params, batch, cfg):
    return _encode(params, batch["frames"], cfg) if cfg.is_encdec else None


def _logits(params, x, cfg):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return softcap((x @ head.T).to(torch.float32), cfg.logit_softcap)


def forward(params: dict, batch: dict, cfg: ModelConfig,
            moe_impl: str | None = None, remat: bool = True,
            unroll: bool = False):
    """Full-sequence logits. Returns (logits (B,S,V) float32, aux_loss, the
    sum of the MoE layers' load-balance losses). For vision inputs the
    logits cover patches and text; ``moe_impl`` None defers to
    ``cfg.moe_impl``. ``remat`` rematerialises each unit under grad (see
    the module's notes). ``unroll`` is accepted and changes nothing: the
    reference unrolls its ``lax.scan`` over units so that XLA's cost model
    counts every layer; here the units always run as a Python loop."""
    del unroll
    enc_memory = _memory(params, batch, cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    x, aux = _stack_fwd(params, "units", x, positions, cfg, cfg.pattern,
                        enc_memory=enc_memory, moe_impl=moe_impl,
                        remat=remat)
    for i, spec in enumerate(cfg.remainder):
        x, a = blk.block_fwd(params["remainder"][str(i)], x, positions, cfg,
                             spec, enc_memory=enc_memory, moe_impl=moe_impl)
        aux = aux + a
    return _logits(params, x, cfg), aux


def loss_fn(params: dict, batch: dict, cfg: ModelConfig,
            moe_impl: str | None = None, aux_coef: float = 0.01,
            unroll: bool = False):
    """The mean next-token negative log-likelihood over the labels that
    are >= 0, plus ``aux_coef`` times the MoE load-balance loss. For vision
    inputs the logits of the text (the last ``labels.shape[1]`` positions)
    are scored. Returns (loss, {"nll", "aux"}). A label below 0 is masked
    out; it is gathered at index 0 (the reference's ``take_along_axis``
    wraps it instead), which the zero mask makes no difference to."""
    logits, aux = forward(params, batch, cfg, moe_impl=moe_impl,
                          unroll=unroll)
    labels = batch["labels"].long()
    if cfg.frontend == "vision" and "patches" in batch:
        logits = logits[:, -labels.shape[1]:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return loss + aux_coef * aux, {"nll": loss, "aux": aux}


def init_cache(batch: int, cfg: ModelConfig, cache_len: int,
               enc_len: int = 0, device=None) -> dict:
    """An empty decode cache; a cross-attention layer's memory K/V take
    ``enc_len`` slots."""
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    cache: dict = {"units": stack_trees([
        blk.init_unit_cache(batch, cfg, cfg.pattern, cache_len, dtype, dev,
                            enc_len)
        for _ in range(cfg.n_units)])}
    if cfg.remainder:
        cache["remainder"] = blk.init_unit_cache(batch, cfg, cfg.remainder,
                                                 cache_len, dtype, dev,
                                                 enc_len)
    return cache


def prefill(params: dict, batch: dict, cfg: ModelConfig, cache_len: int,
            moe_impl: str | None = None):
    """Full-context prefill (an encoder-decoder model encodes its frames
    once). Returns (last_logits (B,V), cache)."""
    enc_memory = _memory(params, batch, cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    kw = dict(enc_memory=enc_memory, moe_impl=moe_impl)
    caches = []
    for u in _units(params):
        c = {}
        for i, spec in enumerate(cfg.pattern):
            x, c[str(i)] = blk.block_prefill(u[str(i)], x, positions, cfg,
                                             spec, cache_len, **kw)
        caches.append(c)
    cache: dict = {"units": stack_trees(caches)}
    if cfg.remainder:
        rc = {}
        for i, spec in enumerate(cfg.remainder):
            x, rc[str(i)] = blk.block_prefill(params["remainder"][str(i)], x,
                                              positions, cfg, spec, cache_len,
                                              **kw)
        cache["remainder"] = rc
    return _logits(params, x[:, -1], cfg), cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos,
                cfg: ModelConfig):
    """One-token decode. tokens: (B,) integer; pos: the absolute position
    (an int or a 0-d integer tensor). The step is written into ``cache``
    in place, through views ``t[i]`` of its stacked leaves (the reference
    returns a new cache; here that would copy every cache leaf on every
    token). The cross-attention layers read the memory's K/V from the
    cache. Returns (logits (B,V), cache)."""
    x = _embed(params, tokens, cfg)[:, None]
    for i, u in enumerate(_units(params)):
        uc = tree_map(lambda t: t[i], cache["units"])
        for j, spec in enumerate(cfg.pattern):
            x, _ = blk.block_step(u[str(j)], x, uc[str(j)], pos, cfg, spec)
    for j, spec in enumerate(cfg.remainder):
        x, _ = blk.block_step(params["remainder"][str(j)], x,
                              cache["remainder"][str(j)], pos, cfg, spec)
    return _logits(params, x[:, 0], cfg), cache
