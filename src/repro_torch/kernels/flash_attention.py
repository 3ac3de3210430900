"""Flash attention: causal / sliding-window / bidirectional GQA attention
with the Gemma-2 logit soft cap (counterpart of
``repro/kernels/flash_attention.py``; the plain version is the arithmetic
of ``repro/kernels/ref.py::attention_ref``).

q is (B,H,S,D), k and v are (B,KV,T,D) with H % KV == 0; head h reads kv
head h // (H/KV). Scores are scaled (D^-0.5 by default), soft-capped
(cap*tanh(s/cap)) and masked by index: key j < T, then ``causal`` j <= i,
then ``window`` j > i - window. A query row with no live key gives the
mean of v over the T keys, as the dense oracle's uniform softmax over its
-1e30 fill does (the TPU kernel's value there depends on its tiling; it is
not copied).

Dispatch goes by the device of ``q``: a CPU tensor runs the plain version,
a CUDA tensor a hand-written kernel of ``csrc/flash_attention.cu`` or an
error, chosen by dtype; head dims 32, 64, 128 and 256. Both kernels count
their launches in ``flash_attention.launches`` and read every tensor
through its batch, head and sequence strides (the head dim must be
contiguous), so the model's (B,S,H,D) projections go in as
``transpose(1, 2)`` views without a copy, and the output takes q's layout.

* fp32: the parity path, fp32 FMAs on the CUDA cores, accumulating in
  fp32 (within 2e-5 of the dense oracle).
* bf16: the Hopper kernel (wgmma for both products, fed by TMA through an
  mbarrier ring); scores and sums in fp32, p rounded to bf16 before P.V.
  TMA needs q, k and v each at a 16-byte aligned address with batch, head
  and sequence strides that are multiples of 16 bytes (8 elements); a
  tensor that breaks the rule raises ``ValueError`` (there is no fallback).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
MASKED = -1e30          # the oracle's fill for masked scores


def live_mask(s: int, t: int, *, causal: bool, window: int,
              device) -> torch.Tensor:
    """(S, T) bool: key j is live for query row i."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0,
                          scale: float | None = None) -> torch.Tensor:
    """Dense masked softmax attention in float32, cast back to q's type
    (``attention_ref``'s arithmetic)."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    g = h // kvh
    scale = d ** -0.5 if scale is None else scale
    f32 = torch.float32
    qr = q.reshape(b, kvh, g, s, d).to(f32)
    scores = torch.einsum("bkgsd,bktd->bkgst", qr, k.to(f32)) * scale
    if softcap:
        scores = softcap * torch.tanh(scores / softcap)
    mask = live_mask(s, t, causal=causal, window=window, device=q.device)
    scores = torch.where(mask, scores, MASKED)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.to(f32))
    return out.reshape(b, h, s, d).to(q.dtype)


def _inner_contiguous(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(-1) == 1 else x.contiguous()


def _outer_strides(x: torch.Tensor, tma: bool, axes: int = 3) -> list[int]:
    """The strides of the ``axes`` outer axes in elements (batch, head and
    sequence here). TMA reads the stride of a size-1 axis only through
    coordinate 0, so there it is given the last dim, which keeps the
    tensor map's 16-byte rule."""
    st = list(x.stride()[:axes])
    if tma:
        st = [s if n > 1 else x.shape[-1]
              for s, n in zip(st, x.shape[:axes])]
    return st


def _check_tma(name: str, x: torch.Tensor, axes: int = 3) -> None:
    """Raise unless TMA can load ``x``: a 16-byte aligned address and
    strides of its ``axes`` outer axes (those longer than 1) of a multiple
    of 16 bytes."""
    size = x.element_size()
    if x.data_ptr() % 16 or any(s * size % 16 for s, n in
                                zip(x.stride()[:axes], x.shape[:axes])
                                if n > 1):
        raise ValueError(
            f"bf16 {name} at address {x.data_ptr():#x} with strides "
            f"{tuple(x.stride())}: the bf16 kernel loads through TMA, which "
            f"needs a 16-byte aligned address and outer (batch, head, "
            f"sequence) strides of a multiple of 8 elements")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    scale: float | None = None) -> torch.Tensor:
    """Attention (B,H,S,D) of q (B,H,S,D) over k, v (B,KV,T,D). CPU tensors
    take the plain version; CUDA tensors launch the fp32 or the bf16 kernel
    and count the launch in ``flash_attention.launches``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B,H,S,D), (B,KV,T,D) x2")
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)} do "
                         f"not agree (H % KV == 0 needed)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want one "
                         f"of {DTYPES} for all three")
    if t < 1 or s < 1 or b > 65535 or h > 65535 or window < 0:
        raise ValueError(f"unsupported S {s}, T {t}, B {b}, H {h} or "
                         f"window {window}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    q, k, v = (_inner_contiguous(x) for x in (q, k, v))
    tma = q.dtype == torch.bfloat16
    if tma:
        for name, x in (("q", q), ("k", k), ("v", v)):
            _check_tma(name, x)
    out = torch.empty_like(q)
    scale = d ** -0.5 if scale is None else scale
    lib = _build.library("flash_attention")
    launch = (lib.flash_attention_sm90_launch if tma
              else lib.flash_attention_launch)
    P = _build.ptr
    strides = [ctypes.c_longlong(st) for x in (q, k, v, out)
               for st in _outer_strides(x, tma)]
    with torch.cuda.device(q.device):
        code = launch(P(q), P(k), P(v), P(out), b, h, kvh, s, t, d, *strides,
                      float(scale), float(softcap), int(bool(causal)),
                      int(window), _build.stream(q.device))
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
