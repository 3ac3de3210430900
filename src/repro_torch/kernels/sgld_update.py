"""The FGTS minibatch potential of SGLD chains and its theta-gradient.

Counterpart of ``repro/kernels/sgld_update.py`` ("fgts" mode). For C chains
theta (C,d) and a minibatch of m replayed duels per chain,

    U_c = sum_i valid_ci * [eta*softplus(-y_i (s_i,a1 - s_i,a2))
          - mu_i * (max_{k live}(s_ik - pref_i cost_k) - (s_i,opp - pref_i cost_opp))]

with s_ik = ((x_i*theta_c) . a_k) / sqrt(max((x_i*x_i) . (a_k*a_k), 1e-24)),
mu_i = mu / (1 + max(pref_i, 0)) and opp = a2 for j = 1, a1 for j = 2. The
gradient is g_c * sum_i x_i * ((W_i / den_i) @ A), W holding the logistic
slope on a1 and a2, the tie-split one-hot of the feel-good max and +mu_i
on the opponent.

The row-level entry points (``potential_rows``, ``potential_grad_rows``)
take the minibatch as ring-row indices ``rows`` (C,m) into tables x (N,d),
a1/a2/y/pref (N,): the SGLD loop hands them the replay ring and its drawn
indices, and the CUDA kernel (``csrc/sgld_potential.cu``) gathers the rows
itself. Dispatch goes by the device of ``theta``: CPU -> the plain PyTorch
version, CUDA -> the kernel (or an error). ``sgld_potential`` is the
``torch.autograd.Function`` form, whose backward is the gradient kernel.

Backends (``resolve_sgld_backend``): "auto" and "fused" dispatch by device
as above, "xla" forces the plain version on any device, "autodiff" is
``torch.autograd`` through ``core.fgts.likelihood_batch``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build

SGLD_BACKENDS = ("auto", "fused", "xla", "autodiff")


def resolve_sgld_backend(backend: str = "auto") -> str:
    """"auto" -> "fused"; explicit names pass through; others raise."""
    if backend not in SGLD_BACKENDS:
        raise ValueError(f"sgld_backend {backend!r} not in {SGLD_BACKENDS}")
    return "fused" if backend == "auto" else backend


class PotentialSpec(NamedTuple):
    """Static parameters of one potential evaluation."""
    j: int              # which posterior sample (opponent = a^{3-j})
    eta: float
    mu: float
    plain: bool = False  # force the plain version (the "xla" backend)


def softplus(v: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(v)) as ``jnp.logaddexp(v, 0)`` computes it (no cut-off
    threshold, unlike ``torch.nn.functional.softplus``)."""
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-torch.abs(v)))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _gathered(theta, x, a1, a2, y, pref, rows, a_emb, costs):
    """Scores (C,m,K), den (C,m,K) and the gathered per-row operands."""
    r = rows.long()
    xg = x[r]                                              # (C, m, d)
    num = (xg * theta[:, None, :]) @ a_emb.T
    den = torch.sqrt(torch.clamp_min((xg * xg) @ (a_emb * a_emb).T, 1e-24))
    p = torch.zeros_like(y[r]) if pref is None else pref[r]
    c = torch.zeros_like(a_emb[:, 0]) if costs is None else costs
    return (num / den, den, xg, a1[r].long(), a2[r].long(), y[r], p,
            p[..., None] * c)


def _live(mask, k, device):
    cols = torch.ones((k,), dtype=torch.bool, device=device)
    return cols if mask is None else mask.to(torch.bool)


def _pick(v, idx):
    return torch.gather(v, -1, idx[..., None])[..., 0]


def potential_rows_plain(theta, x, a1, a2, y, pref, rows, valid, a_emb,
                         mask=None, costs=None, *, j: int, eta: float,
                         mu: float) -> torch.Tensor:
    """(C,) potentials; mirrors ``_tile_terms`` of the Pallas kernel."""
    s, _, _, ia1, ia2, yg, p, t = _gathered(theta, x, a1, a2, y, pref, rows,
                                            a_emb, costs)
    s1, s2 = _pick(s, ia1), _pick(s, ia2)
    pref_ll = eta * softplus(-(yg * (s1 - s2)))
    live = _live(mask, a_emb.shape[0], s.device)
    smax = torch.where(live, s - t, -torch.inf).amax(dim=-1)
    opp_idx = ia2 if j == 1 else ia1
    opp = (s2 if j == 1 else s1) - _pick(t, opp_idx)
    mu_row = mu / (1.0 + torch.clamp_min(p, 0.0))
    terms = pref_ll - mu_row * (smax - opp)
    return torch.sum(terms * valid, dim=-1)


def potential_grad_rows_plain(theta, x, a1, a2, y, pref, rows, valid, a_emb,
                              mask=None, costs=None, g=None, *, j: int,
                              eta: float, mu: float) -> torch.Tensor:
    """(C,d) gradients g_c * dU_c/dtheta_c; mirrors ``_tile_grad``."""
    s, den, xg, ia1, ia2, yg, p, t = _gathered(theta, x, a1, a2, y, pref,
                                               rows, a_emb, costs)
    k = a_emb.shape[0]
    s1, s2 = _pick(s, ia1), _pick(s, ia2)
    z = yg * (s1 - s2)
    dz = eta * (-torch.sigmoid(-z)) * yg
    oh1 = torch.nn.functional.one_hot(ia1, k).to(s.dtype)
    oh2 = torch.nn.functional.one_hot(ia2, k).to(s.dtype)
    w = dz[..., None] * (oh1 - oh2)
    live = _live(mask, k, s.device)
    sm = torch.where(live, s - t, -torch.inf)
    smax = sm.amax(dim=-1)
    # tie-split one-hot of the feel-good max (jnp.max's VJP)
    eq = ((sm == smax[..., None]) & live).to(s.dtype)
    cnt = torch.clamp_min(eq.sum(dim=-1), 1.0)
    mu_row = mu / (1.0 + torch.clamp_min(p, 0.0))
    w = w - mu_row[..., None] * (eq / cnt[..., None])
    w = w + mu_row[..., None] * (oh2 if j == 1 else oh1)
    w = w * valid[..., None]
    r = (w / den) @ a_emb                                  # (C, m, d)
    grad = torch.sum(xg * r, dim=1)
    return grad if g is None else g[:, None] * grad


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

def _launch(fn_name, theta, x, a1, a2, y, pref, rows, valid, a_emb, mask,
            costs, g, *, j, eta, mu):
    dev = theta.device
    c, d = theta.shape
    m = rows.shape[1]
    k = a_emb.shape[0]
    n = x.shape[0]
    if x.shape != (n, d) or a_emb.shape != (k, d) or rows.shape != (c, m) \
            or valid.shape != (c, m):
        raise ValueError(
            f"shapes theta {tuple(theta.shape)}, x {tuple(x.shape)}, rows "
            f"{tuple(rows.shape)}, valid {tuple(valid.shape)}, a_emb "
            f"{tuple(a_emb.shape)} do not agree")
    ops = dict(theta=theta, x=x, a1=a1, a2=a2, y=y, pref=pref, rows=rows,
               valid=valid, a_emb=a_emb, mask=mask, costs=costs, g=g)
    for name, v in ops.items():
        if v is not None and v.device != dev:
            raise ValueError(f"{name} is on {v.device}, theta on {dev}")
    for name, v, shape in (("a1", a1, (n,)), ("a2", a2, (n,)), ("y", y, (n,)),
                           ("pref", pref, (n,)), ("mask", mask, (k,)),
                           ("costs", costs, (k,)), ("g", g, (c,))):
        if v is not None and tuple(v.shape) != shape:
            raise ValueError(f"{name} shape {tuple(v.shape)} is not {shape}")
    f32 = torch.float32

    def cont(v, dtype):
        return None if v is None else v.to(dtype).contiguous()

    args = [cont(theta, f32), cont(x, f32), cont(a1, torch.int32),
            cont(a2, torch.int32), cont(y, f32), cont(pref, f32),
            cont(rows, torch.int64), cont(valid, f32), cont(a_emb, f32),
            cont(mask, torch.bool), cont(costs, f32), cont(g, f32)]
    grad = fn_name == "sgld_potential_grad_launch"
    width = d if grad else 1
    nblk = -(-m // 8)
    partials = torch.empty((c, nblk, width), dtype=f32, device=dev)
    out = torch.empty((c, width), dtype=f32, device=dev)
    lib = _build.library("sgld_potential")
    P = _build.ptr
    with torch.cuda.device(dev):
        code = getattr(lib, fn_name)(
            *[P(v) for v in args], P(partials), P(out), c, m, k, d, int(j),
            float(eta), float(mu), _build.stream(dev))
    _build.check(code, fn_name)
    return out if grad else out[:, 0]


def _dispatch(theta, plain, what):
    if plain or theta.device.type == "cpu":
        return True
    if theta.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {theta.device}")
    return False


def potential_rows(theta, x, a1, a2, y, pref, rows, valid, a_emb, mask=None,
                   costs=None, *, j: int, eta: float, mu: float,
                   plain: bool = False) -> torch.Tensor:
    """(C,) potentials of the chains theta (C,d) on the minibatch ``rows``
    (C,m) of the tables x (N,d), a1/a2/y/pref (N,). ``pref``, ``mask``
    (K,) bool and ``costs`` (K,) may be None (zeros / all live). CUDA
    tensors launch the forward kernel (``potential_rows.launches``)."""
    if _dispatch(theta, plain, "potential_rows"):
        return potential_rows_plain(theta, x, a1, a2, y, pref, rows, valid,
                                    a_emb, mask, costs, j=j, eta=eta, mu=mu)
    out = _launch("sgld_potential_fwd_launch", theta, x, a1, a2, y, pref,
                  rows, valid, a_emb, mask, costs, None, j=j, eta=eta, mu=mu)
    potential_rows.launches += 1
    return out


def potential_grad_rows(theta, x, a1, a2, y, pref, rows, valid, a_emb,
                        mask=None, costs=None, g=None, *, j: int, eta: float,
                        mu: float, plain: bool = False) -> torch.Tensor:
    """(C,d) gradients g_c * dU_c/dtheta_c (``g`` (C,) or None = 1) on the
    same operands as ``potential_rows``; all chains in one launch on CUDA
    (``potential_grad_rows.launches``)."""
    if _dispatch(theta, plain, "potential_grad_rows"):
        return potential_grad_rows_plain(theta, x, a1, a2, y, pref, rows,
                                         valid, a_emb, mask, costs, g, j=j,
                                         eta=eta, mu=mu)
    out = _launch("sgld_potential_grad_launch", theta, x, a1, a2, y, pref,
                  rows, valid, a_emb, mask, costs, g, j=j, eta=eta, mu=mu)
    potential_grad_rows.launches += 1
    return out


potential_rows.launches = 0
potential_grad_rows.launches = 0


class _Potential(torch.autograd.Function):
    """Forward: the potentials (C,); backward: the gradient kernel's
    theta-gradient. Every other operand gets a None gradient."""

    @staticmethod
    def forward(ctx, theta, x, a1, a2, y, pref, rows, valid, a_emb, mask,
                costs, spec: PotentialSpec):
        ctx.save_for_backward(theta, x, a1, a2, y, pref, rows, valid, a_emb,
                              mask, costs)
        ctx.spec = spec
        return potential_rows(theta, x, a1, a2, y, pref, rows, valid, a_emb,
                              mask, costs, j=spec.j, eta=spec.eta,
                              mu=spec.mu, plain=spec.plain)

    @staticmethod
    def backward(ctx, g):
        spec = ctx.spec
        dtheta = potential_grad_rows(*ctx.saved_tensors, g.contiguous(),
                                     j=spec.j, eta=spec.eta, mu=spec.mu,
                                     plain=spec.plain)
        return (dtheta,) + (None,) * 11


def sgld_potential(theta, x, a1, a2, y, valid, a_emb, arm_mask=None, *,
                   pref=None, costs=None, j: int = 1, eta: float = 1.0,
                   mu: float = 0.2, backend: str = "fused") -> torch.Tensor:
    """FGTS data potential sum_i valid_i * L^j_i, differentiable in theta.

    theta (d,) with x (m,d), a1/a2/y/valid/pref (m,) gives a scalar, as the
    JAX function does; theta (C,d) gives (C,) potentials, with x either
    shared (m,d) or per chain (C,m,d) (and its rows (C,m)). ``backend`` is
    "fused" (kernel on CUDA, plain on CPU) or "xla" (plain, forced)."""
    if backend not in ("fused", "xla"):
        raise ValueError(f"sgld kernel backend {backend!r} (use "
                         f"resolve_sgld_backend for 'auto'/'autodiff')")
    single = theta.dim() == 1
    th = theta[None] if single else theta
    c = th.shape[0]
    if x.dim() == 3:
        m = x.shape[1]
        flat = lambda v: None if v is None else v.reshape(c * m, *v.shape[2:])
        x, a1, a2, y, pref = map(flat, (x, a1, a2, y, pref))
        rows = torch.arange(c * m, device=x.device).reshape(c, m)
    else:
        m = x.shape[0]
        rows = torch.arange(m, device=x.device).expand(c, m)
    valid = valid.to(torch.float32).expand(c, m) if valid.dim() == 1 \
        else valid.to(torch.float32)
    spec = PotentialSpec(j, float(eta), float(mu), backend == "xla")
    out = _Potential.apply(th, x, a1, a2, y, pref, rows, valid, a_emb,
                           arm_mask, costs, spec)
    return out[0] if single else out
