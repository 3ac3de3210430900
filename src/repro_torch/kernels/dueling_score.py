"""Dueling scores and batched duel-pair selection (counterpart of
``repro/kernels/dueling_score.py``).

For a batch of queries x (B,d), the arm table A (K,d) and posterior samples
thetas (J,d), the scores are

    s_j[b,k] = ((x_b*theta_j) . a_k) / sqrt(max((x_b*x_b) . (a_k*a_k), 1e-24))

``dueling_score`` returns them all, (J,B,K); ``posterior_scores`` drives it
with the all-ones query, (C,K) = theta_c . a_k / ||a_k||, the autopilot's
dominance readout. ``dueling_select`` (J = 2) reduces each query's scores,
minus a tilt and with inactive arms at -inf, to the routed pair: a1 =
argmax s_1, a2 = argmax s_2 (without a1 when ``distinct``), and (a1, a1)
when no candidate of a2 is left.

Dispatch goes by the device of ``x`` (``a`` for ``posterior_scores``): a
CPU tensor runs the plain PyTorch version, a CUDA tensor the hand-written
kernel (``csrc/dueling_score.cu``, ``csrc/dueling_select.cu``) or raises.
The select kernel streams K with a running argmax, so it has no K ceiling
and needs no large-K fallback.
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


def _same_device(x: torch.Tensor, **ops) -> None:
    for name, v in ops.items():
        if v is not None and v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")


def dueling_score_plain(x: torch.Tensor, a: torch.Tensor,
                        thetas: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: (J,B,K) scores by the reference kernel's
    identity, one denominator matmul and one numerator matmul per sample."""
    den = torch.sqrt(torch.clamp_min((x * x) @ (a * a).T, 1e-24))
    return torch.stack([((x * thetas[j][None, :]) @ a.T) / den
                        for j in range(thetas.shape[0])])


def dueling_score(x: torch.Tensor, a: torch.Tensor,
                  thetas: torch.Tensor) -> torch.Tensor:
    """Scores (J,B,K) float32 of x (B,d), a (K,d), thetas (J,d). CPU
    tensors take the plain version; CUDA tensors launch the kernel and
    count the launch in ``dueling_score.launches``."""
    if x.device.type == "cpu":
        return dueling_score_plain(x, a, thetas)
    if x.device.type != "cuda":
        raise ValueError(f"dueling_score runs on cpu or cuda, not {x.device}")
    b, d = x.shape
    k, j = a.shape[0], thetas.shape[0]
    if a.shape != (k, d) or thetas.shape != (j, d):
        raise ValueError(f"shapes x {tuple(x.shape)}, a {tuple(a.shape)}, "
                         f"thetas {tuple(thetas.shape)} do not agree")
    _same_device(x, a=a, thetas=thetas)
    f32 = torch.float32
    x_c, a_c, th_c = (v.to(f32).contiguous() for v in (x, a, thetas))
    out = torch.empty((j, b, k), dtype=f32, device=x.device)
    lib = _build.library("dueling_score")
    P = _build.ptr
    with torch.cuda.device(x.device):
        code = lib.dueling_score_launch(P(x_c), P(a_c), P(th_c), P(out), b, k,
                                        d, j, _build.stream(x.device))
    _build.check(code, "dueling_score")
    dueling_score.launches += 1
    return out


dueling_score.launches = 0


def _ones_query(a: torch.Tensor) -> torch.Tensor:
    return torch.ones((1, a.shape[1]), dtype=torch.float32, device=a.device)


def posterior_scores(a: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
    """Context-free arm scores (C,K) = theta_c . a_k / ||a_k|| of a (K,d)
    and thetas (C,d): ``dueling_score`` on the all-ones query (phi(1, a) =
    a / ||a||), as the reference drives its score kernel."""
    return dueling_score(_ones_query(a), a, thetas)[:, 0, :]


def posterior_scores_plain(a: torch.Tensor,
                           thetas: torch.Tensor) -> torch.Tensor:
    """``posterior_scores`` through the plain version on any device."""
    return dueling_score_plain(_ones_query(a), a, thetas)[:, 0, :]


def dueling_select_plain(x: torch.Tensor, a: torch.Tensor,
                         thetas: torch.Tensor, *,
                         tilt: torch.Tensor | None = None,
                         mask: torch.Tensor | None = None,
                         distinct: bool = False):
    """The plain PyTorch version: the two samples' scores, then argmax.

    ``torch.argmax`` returns the first index on ties and 0 on an all -inf
    row, as ``jnp.argmax`` does."""
    k = a.shape[0]
    s = dueling_score_plain(x, a, thetas)                      # (2, B, K)
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
    _same_device(x, a=a, thetas=thetas, tilt=tilt, mask=mask)
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
