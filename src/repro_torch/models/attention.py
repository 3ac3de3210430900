"""Full-sequence attention: GQA, causal / sliding-window / bidirectional
/ cross, with the Gemma-2 logit soft cap and RoPE (counterpart of
``repro/models/attention.py``).

The reference computes this contraction with XLA einsums and keeps its
Pallas flash kernel as the TPU drop-in; here the core always runs on the
flash wrapper (``kernels/flash_attention.py``), which dispatches by device:
the hand-written CUDA kernel on the card, the plain version on the CPU.
The projections stay ``torch.einsum``, as the reference leaves them to XLA
outside any kernel. Two things follow from the kernel's interface:

* the mask is by sequence index, where the reference's ``_mask`` compares
  positions. The two agree whenever each row's positions run
  consecutively (``arange(S)`` plus a per-row offset, kv positions equal
  to query positions), which is every full-sequence caller's case (the
  encoder, prefill from position 0). Cross attention (mode 'cross': K/V
  from ``kv_src``, the encoder's memory, no RoPE on either side, no mask)
  runs on the same wrapper unmasked, with S queries over T != S keys;
* bf16 attention rounds p in three different places. The card's bf16
  kernel rounds the unnormalised p to bf16 before P.V (fp32 scores, sums
  and accumulator); the CPU plain version keeps p in fp32 throughout; the
  reference's einsum path rounds the normalised p to the weights' type.
  No test compares bf16 LM outputs across the three: the LM parity tests
  and the card-vs-CPU phase run in fp32.

``cfg.gqa_impl`` does not matter here: the kernel maps each query head to
its kv head itself. One-token decode (``decode_attention``) is plain
PyTorch, as the reference has no kernel there: a full-context cache for
mode 'causal', a ring buffer of ``window`` slots for mode 'local', each
slot's absolute position in ``slot_pos`` (-1 = empty). It writes the
token into the given cache in place, where the reference's functional
update makes a new one (eager PyTorch would copy every K/V cache on every
token). Decoding at a position at or past the end of a full-context cache
raises (``ValueError`` for an int position; for a tensor position an
asynchronous assert, which needs no host sync: ``RuntimeError`` on the
CPU, a device-side assert on the card); the reference clamps the slot and
overwrites the last key. Decode mode 'cross' attends to the encoder's
memory, projected anew (soft cap applied) and leaves the cache untouched,
as the reference's does.

``cfg.attn_q_chunk`` is accepted and changes nothing: the reference's
blockwise loop over query chunks is its XLA stand-in for a flash kernel,
bounding the live scores at (B, H, q_chunk, T); the flash kernel here
bounds them already, and chunking the rows of a row-wise softmax leaves
every row's value as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention

from .config import ModelConfig
from .hooks import LOCAL
from .layers import apply_rope, normal, softcap


def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": normal(gen, (d, h, hd), d ** -0.5, dtype, device),
        "wk": normal(gen, (d, kv, hd), d ** -0.5, dtype, device),
        "wv": normal(gen, (d, kv, hd), d ** -0.5, dtype, device),
        "wo": normal(gen, (h, hd, d), (h * hd) ** -0.5, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=dtype, device=device)
    return p


def _project_qkv(params, x, kv_src, cfg):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_src, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_src, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return q, k, v


def _mask(mode: str, window: int) -> tuple[bool, int]:
    """The reference's mask of ``mode`` as the kernel's index mask:
    (causal, window)."""
    if mode == "causal":
        return True, 0
    if mode == "local":
        if window <= 0:
            raise ValueError("mode 'local' needs window > 0")
        return True, window
    if mode == "bidir":
        return False, 0
    raise ValueError(f"unknown attention mode {mode!r}")


def _attend(params, q, k, v, cfg, hooks, *, causal, window):
    """The flash wrapper over q, k, v (B,S,heads,hd), then ``wo``."""
    out = hooks.impl(flash_attention)(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=cfg.attn_softcap,
        scale=cfg.hd ** -0.5)
    out = torch.einsum("bshk,hkd->bsd", hooks.head_out(out.transpose(1, 2)),
                       params["wo"])
    return hooks.leave(out, "wo")


def self_attention_kv(params: dict, x: torch.Tensor,
                      positions: torch.Tensor, cfg: ModelConfig, *,
                      mode: str, window: int = 0, hooks=LOCAL):
    """Self-attention of x (B,S,d) at ``positions`` (B,S) on the flash
    wrapper. Returns (out (B,S,d), k, v): the roped keys and the values
    (B,S,KV,hd) it attended to, which prefill writes into the cache."""
    causal, win = _mask(mode, window)
    x = hooks.enter(x, "wq")
    q, k, v = hooks.heads(*_project_qkv(params, x, x, cfg))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _attend(params, q, k, v, cfg, hooks, causal=causal, window=win)
    return out, k, v


def cross_attention_kv(params: dict, x: torch.Tensor,
                       kv_src: torch.Tensor, cfg: ModelConfig, *,
                       hooks=LOCAL):
    """Attention of x (B,S,d) over the memory ``kv_src`` (B,T,d) on the
    flash wrapper: no RoPE, no mask, the soft cap. Returns (out (B,S,d),
    k, v): the memory's keys and values (B,T,KV,hd), biases included,
    which prefill writes into the cross cache."""
    x, kv_src = hooks.enter(x, "wq"), hooks.enter(kv_src, "wk")
    q, k, v = hooks.heads(*_project_qkv(params, x, kv_src, cfg))
    out = _attend(params, q, k, v, cfg, hooks, causal=False, window=0)
    return out, k, v


def full_attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, *, mode: str, window: int = 0,
                   kv_src: torch.Tensor | None = None,
                   kv_positions: torch.Tensor | None = None,
                   hooks=LOCAL) -> torch.Tensor:
    """Full-sequence attention of x (B,S,d) at ``positions`` (B,S); mode
    'causal' | 'local' | 'bidir' (self-attention) or 'cross' (over the
    memory ``kv_src`` (B,T,d), whose ``kv_positions`` mask nothing).
    ``hooks``: ``models/hooks.py``. Returns (B,S,d)."""
    if mode == "cross":
        if kv_src is None:
            raise ValueError("mode 'cross' needs kv_src")
        return cross_attention_kv(params, x, kv_src, cfg, hooks=hooks)[0]
    if kv_src is not None or kv_positions is not None:
        raise ValueError(f"mode {mode!r} is self-attention: kv_src and "
                         f"kv_positions belong to mode 'cross'")
    return self_attention_kv(params, x, positions, cfg, mode=mode,
                             window=window, hooks=hooks)[0]


def _gqa_scores(q, k):
    """q: (B,S,H,hd) k: (B,T,KV,hd) -> (B,KV,H//KV,S,T)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    return torch.einsum("bskgh,btkh->bkgst",
                        q.reshape(b, s, kvh, h // kvh, hd), k)


def _gqa_out(p, v):
    """p: (B,KV,H//KV,S,T) v: (B,T,KV,hd) -> (B,S,H,hd)."""
    out = torch.einsum("bkgst,btkh->bskgh", p, v)
    b, s, kvh, g, hd = out.shape
    return out.reshape(b, s, kvh * g, hd)


def init_kv_cache(batch: int, cache_len: int, cfg: ModelConfig, dtype,
                  device) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, cache_len, kv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, kv, hd), dtype=dtype,
                         device=device),
        # per-slot absolute position, -1 = empty (ring-buffer validity)
        "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                               device=device),
    }


def _check_in_cache(pos, cache_len: int) -> None:
    """Refuse a causal decode position at or past ``cache_len``: at once
    for an int, without a host sync for a tensor (``torch._assert_async``:
    raises on the CPU, trips a device-side assert on the card)."""
    what = (f"decode position past the end of the full-context cache of "
            f"{cache_len} slots: a position must be below cache_len")
    if isinstance(pos, torch.Tensor):
        torch._assert_async(pos < cache_len, what)
    elif pos >= cache_len:
        raise ValueError(f"{what}, got {pos}")


def decode_attention(params: dict, x: torch.Tensor, cache: dict, pos,
                     cfg: ModelConfig, *, mode: str, window: int = 0,
                     enc_memory: torch.Tensor | None = None):
    """One-token decode of x (B,1,d) at absolute position ``pos`` (an int
    or a 0-d integer tensor). Mode 'causal': the cache holds the whole
    context; mode 'local': a ring buffer, slot ``pos % cache_len``. The
    token's K/V and position are written into ``cache`` in place. Mode
    'cross': attend to ``enc_memory`` (B,T,d), the cache untouched.
    Returns (out (B,1,d), cache)."""
    if mode == "cross":
        q, k, v = _project_qkv(params, x, enc_memory, cfg)
        scores = _gqa_scores(q, k).to(torch.float32) * (cfg.hd ** -0.5)
        scores = softcap(scores, cfg.attn_softcap)
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bshk,hkd->bsd", _gqa_out(p, v), params["wo"])
        return out, cache
    if mode not in ("causal", "local"):
        raise ValueError(f"unknown decode mode {mode!r}")
    b = x.shape[0]
    cache_len = cache["k"].shape[1]
    if mode == "causal":
        _check_in_cache(pos, cache_len)
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), pos, dtype=torch.int64, device=x.device)
    pos = pos.to(device=x.device, dtype=torch.int64).reshape(())
    positions = pos.expand(b, 1)
    q, k1, v1 = _project_qkv(params, x, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k1 = apply_rope(k1, positions, cfg.rope_theta)

    slot = (pos % cache_len if mode == "local" else pos).reshape(1)
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    k.index_copy_(1, slot, k1.to(k.dtype))
    v.index_copy_(1, slot, v1.to(v.dtype))
    slot_pos.index_copy_(0, slot, pos.reshape(1).to(torch.int32))

    scores = _gqa_scores(q, k).to(torch.float32) * (cfg.hd ** -0.5)
    scores = softcap(scores, cfg.attn_softcap)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if mode == "local":
        valid &= slot_pos > pos - window
    scores = torch.where(valid, scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bshk,hkd->bsd", _gqa_out(p, v), params["wo"])
    return out, cache
