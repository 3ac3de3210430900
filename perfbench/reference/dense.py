"""Plain PyTorch reference of the dense models the cells run: the router's
bidirectional text encoder and the causal LM (granite-3-2b), in float32
with TF32 off. It imports nothing of the program: every operation is
written out here from the models' definitions (RMSNorm with gain
1 + scale, RoPE rotating the two halves of the head, grouped-query
attention, the gated SiLU MLP, the embedding times sqrt(d) rounded to the
weights' type, the tied head; the encoder's masked mean pooling and L2
norm). Weights are read one layer at a time and widened to float32.

The control's arithmetic is a ``mode`` of the products: ``"tf32"``
rounds both operands of every matrix product to TF32 (10 mantissa bits,
to nearest) and accumulates in float32, as the tensor cores' TF32 does,
the same on any device; ``"fp8"`` rounds both operands of every
projection and MLP product to float8 e4m3 with a per-tensor scale.
``precision`` turns the device's own TF32 off around the reference.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def precision():
    """The device's TF32 off for the body (float32 products in float32)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest (ties away
    from zero), kept in float32."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def rounded(t: torch.Tensor, mode: str) -> torch.Tensor:
    """An operand of a product as ``mode`` computes it."""
    if mode == "tf32":
        return tf32(t)
    if mode == "fp8":
        return _fp8(t)
    return t


def _mm(eq: str, x, w, mode: str):
    return torch.einsum(eq, rounded(x, mode), rounded(w, mode))


def rms(x, scale, eps: float):
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale.float())


def rope(x, positions, theta: float):
    """x (B, S, heads, hd), positions (S,): the two halves rotated."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    ang = positions.float()[:, None] * torch.from_numpy(freqs).to(x.device)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def block(p: dict, i: int, x, positions, m: dict, causal: bool, mode: str):
    """Layer ``i`` of the stacked tree ``p`` on x (B, S, d) float32."""
    att, ffn = p["units"]["0"]["mixer"], p["units"]["0"]["ffn"]
    w = lambda t: t[i].to(torch.float32)
    h = rms(x, p["units"]["0"]["norm1"][i], m["eps"])
    q = _mm("bsd,dhk->bshk", h, w(att["wq"]), mode)
    k = _mm("bsd,dhk->bshk", h, w(att["wk"]), mode)
    v = _mm("bsd,dhk->bshk", h, w(att["wv"]), mode)
    q, k = rope(q, positions, m["rope_theta"]), rope(k, positions,
                                                      m["rope_theta"])
    b, s, nh, hd = q.shape
    g = nh // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    attn_mode = "tf32" if mode == "tf32" else "fp32"
    sc = _mm("bqhd,bkhd->bhqk", q, k, attn_mode) * hd ** -0.5
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        sc = sc.masked_fill(~keep, -torch.inf)
    o = _mm("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v, attn_mode)
    x = x + _mm("bshk,hkd->bsd", o, w(att["wo"]), mode)
    h = rms(x, p["units"]["0"]["norm2"][i], m["eps"])
    a = torch.nn.functional.silu(_mm("bsd,df->bsf", h, w(ffn["w1"]), mode))
    a = a * _mm("bsd,df->bsf", h, w(ffn["w3"]), mode)
    return x + _mm("bsf,fd->bsd", a, w(ffn["w2"]), mode)


def _layers(p) -> int:
    return p["units"]["0"]["norm1"].shape[0]


def encode(p: dict, tokens, mask, m: dict, mode: str = "fp32"):
    """The router encoder: tokens (B, L), mask (B, L) -> L2-normed
    (B, d). Padding tokens attend; the pooling leaves them out."""
    x = p["embed"][tokens.long()].to(torch.float32)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(_layers(p)):
        x = block(p, i, x, positions, m, False, mode)
    x = rms(x, p["final_norm"], m["eps"])
    mk = mask[..., None].to(torch.float32)
    pooled = (x * mk).sum(1) / mk.sum(1).clamp_min(1.0)
    return pooled / torch.linalg.vector_norm(pooled, dim=-1,
                                             keepdim=True).clamp_min(1e-12)


def lm_logits(p: dict, tokens, at, m: dict, mode: str = "fp32"):
    """The causal LM over tokens (B, S); float32 logits (B, len(at), V)
    at positions ``at`` (the logits that predict the token after each)."""
    dt = p["embed"].dtype
    scale = float(torch.tensor(m["d"] ** 0.5, dtype=dt))
    x = p["embed"][tokens.long()].to(torch.float32) * scale
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(_layers(p)):
        x = block(p, i, x, positions, m, True, mode)
    h = rms(x[:, at], p["final_norm"], m["eps"])
    return _mm("bsd,vd->bsv", h, p["embed"].to(torch.float32), mode)
