"""Mixture-of-Experts FFN: top-k token-choice routing (counterpart of
``repro/models/moe.py``).

Two dispatch implementations, as in the reference:

* ``sparse`` (default): capacity-bucketed dispatch. Assignments are sorted
  by expert, packed into an (E, C, d) buffer, each expert runs one batched
  product over its bucket, and the results are gathered back weighted by
  the gate. Assignments past an expert's capacity C are dropped
  (Switch / GShard semantics): they land on a sentinel row E*C of the
  buffer, which is cut off, so that row is the only one written more than
  once.
* ``dense``: every expert processes every token, combined with the gate
  weights of the chosen experts. Exact (no drops); the reference's
  numerics oracle and its default decode dispatch (``moe_decode_impl``).

Arctic's ``moe_dense`` adds a parallel dense residual MLP
(``layers.gated_mlp``). The reference computes all of this with plain
``jnp`` einsums, sorts and scatters, outside any Pallas kernel, so the
expert products here are ``torch.bmm`` / ``torch.matmul``.

Carry-over hazards, each kept here:

* ``jax.lax.top_k`` returns tied values lowest index first and
  ``torch.topk`` does not: the top k are the first k of a stable
  descending sort.
* ``jnp.argsort`` is stable, ``torch.argsort`` only with ``stable=True``.
* ``jnp.mean`` rounds as the sum times 1/n.
* No host sync anywhere in ``moe_ffn``: the capacity comes from static
  shapes, the tokens per expert are counted with ``index_add_`` into a
  fixed (E,) tensor (``torch.bincount`` reads its maximum back to the
  host), and every gather and scatter takes an index tensor (no boolean
  mask, no ``nonzero``), so a decode step can be captured in a CUDA graph.
"""
from __future__ import annotations

import math

import torch

from .config import ModelConfig
from .layers import gated_mlp, init_mlp, normal


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    p = {
        "router": normal(gen, (d, e), d ** -0.5, torch.float32, device),
        "w1": normal(gen, (e, d, f), d ** -0.5, dtype, device),
        "w3": normal(gen, (e, d, f), d ** -0.5, dtype, device),
        "w2": normal(gen, (e, f, d), f ** -0.5, dtype, device),
    }
    if cfg.dense_residual_ff:
        p["dense"] = init_mlp(gen, d, cfg.dense_residual_ff, dtype, device)
    return p


def _route(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (N,d) -> (gate (N,K) float32, expert_idx (N,K) int64, aux_loss):
    fp32 router logits, the top k experts lowest index first among ties,
    their softmax as the gate, and the Switch load-balance loss
    E * sum_e frac_tokens_e * mean_prob_e."""
    n, e, k = x.shape[0], cfg.n_experts, cfg.top_k
    logits = x.to(torch.float32) @ params["router"]              # (N,E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    gate = torch.softmax(topv, dim=-1)
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device)
    counts.index_add_(0, topi.reshape(-1),
                      torch.ones((n * k,), dtype=torch.float32,
                                 device=x.device))
    frac_tokens = counts / (n * k)
    mean_prob = torch.sum(probs, dim=0) * (1.0 / n)
    aux = e * torch.sum(frac_tokens * mean_prob)
    return gate, topi, aux


def _expert_mlp(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E,C,d) -> (E,C,d), each expert's SwiGLU over its bucket."""
    h = torch.bmm(xe, params["w1"])
    g = torch.bmm(xe, params["w3"])
    return torch.bmm(torch.nn.functional.silu(h) * g, params["w2"])


def capacity(n_tokens: int, cfg: ModelConfig, factor: float = 1.25) -> int:
    """Slots per expert: ceil(N K / E * factor), rounded up to a multiple
    of 8, at least 8."""
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * factor))
    return max(8, -(-c // 8) * 8)


def dispatch(expert_idx: torch.Tensor, e: int, c: int):
    """Where each assignment goes, in the reference's order. Returns
    (dest (N*K,) int64, the row of the flattened (E*C + 1) buffer each
    assignment writes in expert-sorted order, E*C for a dropped one;
    sort_idx, the assignment (token * K + slot) at each sorted place;
    slot (N*K,), the row each assignment reads back, in token order)."""
    flat_e = expert_idx.reshape(-1)
    nk = flat_e.shape[0]
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, dtype=sorted_e.dtype,
                               device=sorted_e.device))           # (E,)
    arange = torch.arange(nk, dtype=torch.int64, device=flat_e.device)
    pos_in_e = arange - starts.index_select(0, sorted_e)
    dest = torch.where(pos_in_e < c, sorted_e * c + pos_in_e, e * c)
    inv = torch.empty_like(sort_idx).scatter_(0, sort_idx, arange)
    return dest, sort_idx, dest.index_select(0, inv)


def moe_ffn_sparse(params: dict, x: torch.Tensor, cfg: ModelConfig,
                   capacity_factor: float = 1.25):
    """Capacity-bucketed dispatch of x (B,S,d). Returns (out (B,S,d),
    aux_loss)."""
    b, s, d = x.shape
    n, k, e = b * s, cfg.top_k, cfg.n_experts
    c = capacity(n, cfg, capacity_factor)
    xf = x.reshape(n, d)
    gate, topi, aux = _route(params, xf, cfg)
    dest, sort_idx, slot = dispatch(topi, e, c)
    buf = xf.new_zeros((e * c + 1, d))
    # dropped assignments all land on the sentinel row E*C, cut off below
    buf.index_copy_(0, dest, xf.index_select(0, sort_idx // k))
    ye = _expert_mlp(params, buf[:-1].reshape(e, c, d))           # (E,C,d)
    ye = torch.cat([ye.reshape(e * c, d), xf.new_zeros((1, d))])
    y_assign = ye.index_select(0, slot).reshape(n, k, d)
    out = torch.bmm(gate.to(x.dtype)[:, None, :], y_assign)[:, 0]
    out = out.reshape(b, s, d)
    if "dense" in params:
        out = out + gated_mlp(params["dense"], x)
    return out, aux


def moe_ffn_dense(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Every expert over every token of x (B,S,d), combined with the
    chosen experts' gates. Returns (out (B,S,d), aux_loss)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    gate, topi, aux = _route(params, xf, cfg)
    combine = torch.zeros((b * s, cfg.n_experts), dtype=torch.float32,
                          device=x.device).scatter_add_(1, topi, gate)
    # (N,d) against (E,d,f) broadcasts to (E,N,f) without copying w
    h = torch.matmul(xf, params["w1"])
    g = torch.matmul(xf, params["w3"])
    y = torch.bmm(torch.nn.functional.silu(h) * g, params["w2"])  # (E,N,d)
    out = torch.einsum("end,ne->nd", y, combine.to(y.dtype)).reshape(b, s, d)
    if "dense" in params:
        out = out + gated_mlp(params["dense"], x)
    return out, aux


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig,
            impl: str = "sparse"):
    if impl == "dense":
        return moe_ffn_dense(params, x, cfg)
    return moe_ffn_sparse(params, x, cfg)
