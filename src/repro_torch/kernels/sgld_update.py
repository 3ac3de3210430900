"""The minibatch potential of SGLD chains and its theta-gradient.

Counterpart of ``repro/kernels/sgld_update.py``, in its two modes. "fgts":
for C chains theta (C,d) and a minibatch of m replayed duels per chain,

    U_c = sum_i valid_ci * [eta*softplus(-y_i (s_i,a1 - s_i,a2))
          - mu_i * (max_{k live}(s_ik - pref_i cost_k) - (s_i,opp - pref_i cost_opp))]

with s_ik = ((x_i*theta_c) . a_k) / sqrt(max((x_i*x_i) . (a_k*a_k), 1e-24)),
mu_i = mu / (1 + max(pref_i, 0)) and opp = a2 for j = 1, a1 for j = 2. The
gradient is g_c * sum_i x_i * ((W_i / den_i) @ A), W holding the logistic
slope on a1 and a2, the tie-split one-hot of the feel-good max and +mu_i
on the opponent.

"mixed" (``sgld_mixed_potential``, the mixed duel + click estimator): duel
rows (is_duel > 0) take eta*softplus(-y_i (s_i,a1 - s_i,a2)), click rows
eta*softplus(-s_i,a1) when y_i > 0.5 and eta*softplus(s_i,a1) otherwise;
no feel-good term, so only the one or two scored arms enter and the
gradient is x_i * (w1/den1 a_a1 + w2/den2 a_a2), O(m d) whatever K is.

The row-level entry points (``potential_rows``, ``potential_grad_rows``)
take the minibatch as ring-row indices ``rows`` (C,m) into tables x (N,d),
a1/a2/y/pref (N,): the SGLD loop hands them the replay ring and its drawn
indices, and the CUDA kernel (``csrc/sgld_potential.cu``) gathers the rows
itself; ``mixed_potential_rows``/``mixed_potential_grad_rows`` are the
mixed mode's, with an ``is_duel`` (N,) table beside ``y``. Dispatch goes
by the device of ``theta``: CPU -> the plain PyTorch version, CUDA -> the
kernel (or an error). ``sgld_potential`` and ``sgld_mixed_potential`` are
the ``torch.autograd.Function`` forms, whose backward is the gradient
kernel.

Backends (``resolve_sgld_backend``): "auto" and "fused" dispatch by device
as above, "xla" forces the plain version on any device, "autodiff" is
``torch.autograd`` through ``core.fgts.likelihood_batch``.
"""
from __future__ import annotations

import torch

from . import _build

SGLD_BACKENDS = ("auto", "fused", "xla", "autodiff")


def resolve_sgld_backend(backend: str = "auto") -> str:
    """"auto" -> "fused"; explicit names pass through; others raise."""
    if backend not in SGLD_BACKENDS:
        raise ValueError(f"sgld_backend {backend!r} not in {SGLD_BACKENDS}")
    return "fused" if backend == "auto" else backend


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


def _arm_scores(xt, xx, a_emb, arms):
    """Scores (C,m), den (C,m) and gathered rows (C,m,d) of one arm per
    row: the two sums of the identity over d, nothing over K."""
    ag = a_emb[arms]
    den = torch.sqrt(torch.clamp_min(torch.sum(xx * (ag * ag), dim=-1),
                                     1e-24))
    return torch.sum(xt * ag, dim=-1) / den, den, ag


def _mixed_gathered(theta, x, a1, a2, y, is_duel, rows, a_emb):
    r = rows.long()
    xg = x[r]                                              # (C, m, d)
    xt, xx = xg * theta[:, None, :], xg * xg
    ia1, ia2 = a1[r].long(), a2[r].long()
    return (xg, _arm_scores(xt, xx, a_emb, ia1),
            _arm_scores(xt, xx, a_emb, ia2), y[r], is_duel[r] > 0,
            ia1 == ia2)


def mixed_potential_rows_plain(theta, x, a1, a2, y, is_duel, rows, valid,
                               a_emb, *, eta: float) -> torch.Tensor:
    """(C,) mixed potentials; mirrors ``_tile_terms``' "mixed" branch."""
    _, (s1, _, _), (s2, _, _), yg, duel, _ = _mixed_gathered(
        theta, x, a1, a2, y, is_duel, rows, a_emb)
    pref_ll = eta * softplus(-(yg * (s1 - s2)))
    click = eta * torch.where(yg > 0.5, softplus(-s1), softplus(s1))
    return torch.sum(torch.where(duel, pref_ll, click) * valid, dim=-1)


def mixed_potential_grad_rows_plain(theta, x, a1, a2, y, is_duel, rows,
                                    valid, a_emb, g=None, *,
                                    eta: float) -> torch.Tensor:
    """(C,d) gradients g_c * dU_c/dtheta_c of the mixed potentials;
    mirrors ``_tile_grad``' "mixed" branch (a self-duel's one-hot
    difference cancels: weight 0)."""
    xg, (s1, den1, ag1), (s2, den2, ag2), yg, duel, self_duel = \
        _mixed_gathered(theta, x, a1, a2, y, is_duel, rows, a_emb)
    z = yg * (s1 - s2)
    dz = eta * (-torch.sigmoid(-z)) * yg
    dclick = eta * torch.where(yg > 0.5, -torch.sigmoid(-s1),
                               torch.sigmoid(s1))
    w1 = torch.where(duel, torch.where(self_duel, 0.0, dz), dclick) * valid
    w2 = torch.where(duel & ~self_duel, -dz, 0.0) * valid
    r = (w1 / den1)[..., None] * ag1 + (w2 / den2)[..., None] * ag2
    grad = torch.sum(xg * r, dim=1)
    return grad if g is None else g[:, None] * grad


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

def _launch(fn_name, grad, theta, rows, valid, x, a_emb, per_row, per_arm,
            g, scalars):
    """Check the operands of a row kernel, launch it (grid over minibatch
    blocks and chains, then the ordered partials reduction) and return
    (C,d) for a gradient, (C,) for a potential. ``per_row`` and
    ``per_arm``: (name, tensor or None, dtype) of the (N,) and (K,) tables,
    in the C entry point's order after x; ``scalars``: its trailing ints
    and floats after the partials and out pointers."""
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
    f32 = torch.float32
    ops = [("theta", theta, f32, (c, d)), ("x", x, f32, (n, d))]
    ops += [(nm, v, dt, (n,)) for nm, v, dt in per_row]
    ops += [("rows", rows, torch.int64, (c, m)), ("valid", valid, f32, (c, m)),
            ("a_emb", a_emb, f32, (k, d))]
    ops += [(nm, v, dt, (k,)) for nm, v, dt in per_arm]
    ops.append(("g", g, f32, (c,)))
    args = []
    for name, v, dtype, shape in ops:
        if v is not None and v.device != dev:
            raise ValueError(f"{name} is on {v.device}, theta on {dev}")
        if v is not None and tuple(v.shape) != shape:
            raise ValueError(f"{name} shape {tuple(v.shape)} is not {shape}")
        args.append(None if v is None else v.to(dtype).contiguous())
    width = d if grad else 1
    partials = torch.empty((c, -(-m // 8), width), dtype=f32, device=dev)
    out = torch.empty((c, width), dtype=f32, device=dev)
    lib = _build.library("sgld_potential")
    P = _build.ptr
    with torch.cuda.device(dev):
        code = getattr(lib, fn_name)(
            *[P(v) for v in args], P(partials), P(out), *scalars,
            _build.stream(dev))
    _build.check(code, fn_name)
    return out if grad else out[:, 0]


def _fgts_launch(grad, theta, x, a1, a2, y, pref, rows, valid, a_emb, mask,
                 costs, g, *, j, eta, mu):
    i32 = torch.int32
    c, m = rows.shape
    return _launch(
        "sgld_potential_grad_launch" if grad else "sgld_potential_fwd_launch",
        grad, theta, rows, valid, x, a_emb,
        [("a1", a1, i32), ("a2", a2, i32), ("y", y, torch.float32),
         ("pref", pref, torch.float32)],
        [("mask", mask, torch.bool), ("costs", costs, torch.float32)], g,
        (c, m, a_emb.shape[0], theta.shape[1], int(j), float(eta),
         float(mu)))


def _mixed_launch(grad, theta, x, a1, a2, y, is_duel, rows, valid, a_emb, g,
                  *, eta):
    f32, i32 = torch.float32, torch.int32
    c, m = rows.shape
    return _launch(
        "sgld_mixed_grad_launch" if grad else "sgld_mixed_fwd_launch",
        grad, theta, rows, valid, x, a_emb,
        [("a1", a1, i32), ("a2", a2, i32), ("y", y, f32),
         ("is_duel", is_duel, f32)], [], g,
        (c, m, theta.shape[1], float(eta)))


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
    out = _fgts_launch(False, theta, x, a1, a2, y, pref, rows, valid, a_emb,
                       mask, costs, None, j=j, eta=eta, mu=mu)
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
    out = _fgts_launch(True, theta, x, a1, a2, y, pref, rows, valid, a_emb,
                       mask, costs, g, j=j, eta=eta, mu=mu)
    potential_grad_rows.launches += 1
    return out


def mixed_potential_rows(theta, x, a1, a2, y, is_duel, rows, valid, a_emb, *,
                         eta: float, plain: bool = False) -> torch.Tensor:
    """(C,) mixed potentials of the chains theta (C,d) on the minibatch
    ``rows`` (C,m) of the tables x (N,d), a1/a2/y/is_duel (N,). CUDA
    tensors launch the mixed forward kernel
    (``mixed_potential_rows.launches``)."""
    if _dispatch(theta, plain, "mixed_potential_rows"):
        return mixed_potential_rows_plain(theta, x, a1, a2, y, is_duel, rows,
                                          valid, a_emb, eta=eta)
    out = _mixed_launch(False, theta, x, a1, a2, y, is_duel, rows, valid,
                        a_emb, None, eta=eta)
    mixed_potential_rows.launches += 1
    return out


def mixed_potential_grad_rows(theta, x, a1, a2, y, is_duel, rows, valid,
                              a_emb, g=None, *, eta: float,
                              plain: bool = False) -> torch.Tensor:
    """(C,d) gradients g_c * dU_c/dtheta_c of the mixed potentials; all
    chains in one launch on CUDA (``mixed_potential_grad_rows.launches``)."""
    if _dispatch(theta, plain, "mixed_potential_grad_rows"):
        return mixed_potential_grad_rows_plain(theta, x, a1, a2, y, is_duel,
                                               rows, valid, a_emb, g,
                                               eta=eta)
    out = _mixed_launch(True, theta, x, a1, a2, y, is_duel, rows, valid,
                        a_emb, g, eta=eta)
    mixed_potential_grad_rows.launches += 1
    return out


potential_rows.launches = 0
potential_grad_rows.launches = 0
mixed_potential_rows.launches = 0
mixed_potential_grad_rows.launches = 0


class _RowsPotential(torch.autograd.Function):
    """Forward: a row entry point's potentials (C,); backward: its gradient
    entry point's theta-gradient (the gradient kernel on CUDA). ``fns`` is
    the (forward, gradient) pair, ``kw`` their keyword arguments; every
    operand but theta gets a None gradient."""

    @staticmethod
    def forward(ctx, fns, kw, theta, *ops):
        ctx.save_for_backward(theta, *ops)
        ctx.fns, ctx.kw = fns, kw
        return fns[0](theta, *ops, **kw)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        dtheta = ctx.fns[1](*saved, g.contiguous(), **ctx.kw)
        return (None, None, dtheta) + (None,) * (len(saved) - 1)


def _chain_rows(theta, x, valid, *per_row):
    """theta (d,) or (C,d), x shared (m,d) or per chain (C,m,d): the
    chains (C,d), the flat row tables, rows (C,m) and valid (C,m)."""
    th = theta[None] if theta.dim() == 1 else theta
    c = th.shape[0]
    if x.dim() == 3:
        m = x.shape[1]
        flat = lambda v: None if v is None else v.reshape(c * m, *v.shape[2:])
        x, per_row = flat(x), [flat(v) for v in per_row]
        rows = torch.arange(c * m, device=x.device).reshape(c, m)
    else:
        m = x.shape[0]
        rows = torch.arange(m, device=x.device).expand(c, m)
    valid = valid.to(torch.float32).expand(c, m) if valid.dim() == 1 \
        else valid.to(torch.float32)
    return th, x, per_row, rows, valid


def _kernel_backend(backend):
    if backend not in ("fused", "xla"):
        raise ValueError(f"sgld kernel backend {backend!r} (use "
                         f"resolve_sgld_backend for 'auto'/'autodiff')")
    return backend == "xla"


def sgld_potential(theta, x, a1, a2, y, valid, a_emb, arm_mask=None, *,
                   pref=None, costs=None, j: int = 1, eta: float = 1.0,
                   mu: float = 0.2, backend: str = "fused") -> torch.Tensor:
    """FGTS data potential sum_i valid_i * L^j_i, differentiable in theta.

    theta (d,) with x (m,d), a1/a2/y/valid/pref (m,) gives a scalar, as the
    JAX function does; theta (C,d) gives (C,) potentials, with x either
    shared (m,d) or per chain (C,m,d) (and its rows (C,m)). ``backend`` is
    "fused" (kernel on CUDA, plain on CPU) or "xla" (plain, forced)."""
    plain = _kernel_backend(backend)
    th, x, (a1, a2, y, pref), rows, valid = _chain_rows(theta, x, valid, a1,
                                                        a2, y, pref)
    kw = dict(j=j, eta=float(eta), mu=float(mu), plain=plain)
    out = _RowsPotential.apply((potential_rows, potential_grad_rows), kw, th,
                               x, a1, a2, y, pref, rows, valid, a_emb,
                               arm_mask, costs)
    return out[0] if theta.dim() == 1 else out


def sgld_mixed_potential(theta, x, a1, a2, y, is_duel, valid, a_emb, *,
                         eta: float = 1.0,
                         backend: str = "fused") -> torch.Tensor:
    """Mixed duel + click data potential sum_i valid_i * term_i (no
    feel-good), differentiable in theta; shapes and ``backend`` as for
    ``sgld_potential``. Duel rows (is_duel > 0) take the BTL term on
    (a1, a2), click rows the Bernoulli term on a1 with y in {0, 1}."""
    plain = _kernel_backend(backend)
    th, x, (a1, a2, y, is_duel), rows, valid = _chain_rows(
        theta, x, valid, a1, a2, y, is_duel.to(torch.float32))
    kw = dict(eta=float(eta), plain=plain)
    out = _RowsPotential.apply((mixed_potential_rows,
                                mixed_potential_grad_rows), kw, th, x, a1, a2,
                               y, is_duel, rows, valid, a_emb)
    return out[0] if theta.dim() == 1 else out
