"""Batched duel-pair selection: the router's serving hot path.

Counterpart of ``repro/kernels/dueling_score.py::dueling_select``. For a
batch of queries x (B,d), the arm table A (K,d) and two posterior samples
thetas (2,d), each query's scores are

    s_j[k] = ((x*theta_j) . a_k) / sqrt(max((x*x) . (a_k*a_k), 1e-24)) - tilt[k]

with inactive arms at -inf; a1 = argmax s_1, a2 = argmax s_2 (without a1
when ``distinct``), and (a1, a1) when no candidate of a2 is left.

Dispatch goes by the device of ``x``: a CPU tensor runs the plain PyTorch
version, a CUDA tensor the hand-written kernel ``csrc/dueling_select.cu``
(or raises). The kernel streams K with a running argmax, so it has no K
ceiling and needs no large-K fallback.
"""
from __future__ import annotations

import torch

from . import _build


def mask_fallback_pair(s2: torch.Tensor, a1: torch.Tensor,
                       a2: torch.Tensor) -> torch.Tensor:
    """Single-survivor degeneration: where every candidate of a2 is -inf
    (one active arm and ``distinct``), duel (a1, a1). Reduces over the last
    (arm) axis of ``s2``."""
    return torch.where(s2.amax(dim=-1) == -torch.inf, a1, a2)


def dueling_select_plain(x: torch.Tensor, a: torch.Tensor,
                         thetas: torch.Tensor, *,
                         tilt: torch.Tensor | None = None,
                         mask: torch.Tensor | None = None,
                         distinct: bool = False):
    """The plain PyTorch version: two matmuls per sample, then argmax.

    ``torch.argmax`` returns the first index on ties and 0 on an all -inf
    row, as ``jnp.argmax`` does."""
    k = a.shape[0]
    den = torch.sqrt(torch.clamp_min((x * x) @ (a * a).T, 1e-24))
    s = torch.stack([((x * thetas[j][None, :]) @ a.T) / den
                     for j in range(2)])                       # (2, B, K)
    if tilt is not None:
        s = s - torch.atleast_2d(tilt)[None]
    if mask is not None:
        s = torch.where(torch.atleast_2d(mask)[None], s, -torch.inf)
    a1 = torch.argmax(s[0], dim=-1)
    s2 = s[1]
    if distinct:
        cols = torch.arange(k, device=x.device)
        s2 = torch.where(cols[None, :] == a1[:, None], -torch.inf, s2)
    a2 = torch.argmax(s2, dim=-1)
    return a1.to(torch.int32), mask_fallback_pair(s2, a1, a2).to(torch.int32)


def _row_stride(v: torch.Tensor | None, b: int, k: int, name: str) -> int:
    if v is None or v.dim() == 1:
        if v is not None and v.shape != (k,):
            raise ValueError(f"{name} shape {tuple(v.shape)} is not ({k},)")
        return 0
    if v.shape != (b, k):
        raise ValueError(f"{name} shape {tuple(v.shape)} is neither ({k},) "
                         f"nor ({b}, {k})")
    return k


def dueling_select(x: torch.Tensor, a: torch.Tensor, thetas: torch.Tensor, *,
                   tilt: torch.Tensor | None = None,
                   mask: torch.Tensor | None = None,
                   distinct: bool = False):
    """Route a batch: (a1, a2) int32 (B,) from x (B,d), a (K,d), thetas
    (2,d), an optional (K,) or (B,K) float tilt and an optional (K,) or
    (B,K) bool arm mask. CPU tensors take the plain version; CUDA tensors
    launch the kernel and count the launch in ``dueling_select.launches``."""
    if x.device.type == "cpu":
        return dueling_select_plain(x, a, thetas, tilt=tilt, mask=mask,
                                    distinct=distinct)
    if x.device.type != "cuda":
        raise ValueError(f"dueling_select runs on cpu or cuda, not {x.device}")
    b, d = x.shape
    k = a.shape[0]
    if a.shape != (k, d) or thetas.shape != (2, d):
        raise ValueError(f"shapes x {tuple(x.shape)}, a {tuple(a.shape)}, "
                         f"thetas {tuple(thetas.shape)} do not agree")
    for name, v in (("a", a), ("thetas", thetas), ("tilt", tilt),
                    ("mask", mask)):
        if v is not None and v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    t_stride = _row_stride(tilt, b, k, "tilt")
    m_stride = _row_stride(mask, b, k, "mask")
    f32 = torch.float32
    x_c = x.to(f32).contiguous()
    a_c = a.to(f32).contiguous()
    th_c = thetas.to(f32).contiguous()
    tilt_c = None if tilt is None else tilt.to(f32).contiguous()
    mask_c = None if mask is None else mask.to(torch.bool).contiguous()
    a1 = torch.empty((b,), dtype=torch.int32, device=x.device)
    a2 = torch.empty((b,), dtype=torch.int32, device=x.device)
    lib = _build.library("dueling_select")
    P = _build.ptr
    with torch.cuda.device(x.device):
        code = lib.dueling_select_launch(
            P(x_c), P(a_c), P(th_c), P(tilt_c), P(mask_c), P(a1), P(a2),
            b, k, d, t_stride, m_stride, int(bool(distinct)),
            _build.stream(x.device))
    _build.check(code, "dueling_select")
    dueling_select.launches += 1
    return a1, a2


dueling_select.launches = 0
