"""Parity of the port's kernel modules with the JAX package.

The same numpy inputs (seeded) go through the JAX function, run as its own
tests run it on the CPU (``dueling_select``, ``dueling_score`` and
``posterior_scores`` in Pallas interpret mode, ``sgld_potential`` and
``sgld_mixed_potential`` with ``backend="xla"`` — the Pallas lowering — and
``jax.grad`` through them), and through the port on CPU tensors, where each
wrapper takes its plain PyTorch version.

Tolerances: routed pairs are exact. Scores match to rtol = atol = 1e-5.
Potentials match to rtol 1e-5 / atol 1e-6 and gradients to rtol 1e-4 /
atol 1e-5: both sides compute in fp32, but the matmuls and row sums add in
different orders, and the gradient is a longer chain of such sums.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py``, which imports no JAX.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dueling_score import dueling_score as jax_score
from repro.kernels.dueling_score import dueling_select as jax_select
from repro.kernels.dueling_score import posterior_scores as jax_post_scores
from repro.kernels.sgld_update import sgld_mixed_potential as jax_mixed
from repro.kernels.sgld_update import sgld_potential as jax_potential
from repro_torch import kernels as tk
from repro_torch.core import fgts as tfgts
from repro_torch.kernels import dueling_score as tds
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import sgld_update as tsu
from repro_torch.kernels.ref import dueling_score_ref

torch.set_num_threads(2)

POT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
D = 32


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# dueling_select
# ---------------------------------------------------------------------------

# one jitted interpret-mode program per (shape, distinct): tilt and mask
# reach it as (B,K) operands, which the JAX wrapper builds from None / (K,)
# operands anyway, so every variant reuses one trace
_jax_select = jax.jit(jax_select, static_argnames=("distinct", "interpret"))


def _select_inputs(b, k, mask_kind, tilt_kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, D)).astype(np.float32)
    a = rng.standard_normal((k, D)).astype(np.float32)
    th = rng.standard_normal((2, D)).astype(np.float32)
    mask = {"none": None,
            "k": rng.random(k) > 0.3,
            "bk": rng.random((b, k)) > 0.3}[mask_kind]
    tilt = {"none": None,
            "k": (0.3 * rng.random(k)).astype(np.float32),
            "bk": (0.3 * rng.random((b, k))).astype(np.float32)}[tilt_kind]
    return x, a, th, mask, tilt


def _jax_pair(x, a, th, mask, tilt, distinct):
    b, k = x.shape[0], a.shape[0]
    m = np.ones((b, k), bool) if mask is None \
        else np.broadcast_to(mask, (b, k))
    tl = np.zeros((b, k), np.float32) if tilt is None \
        else np.broadcast_to(tilt, (b, k))
    a1, a2 = _jax_select(x, a, th, tilt=jnp.asarray(tl), mask=jnp.asarray(m),
                         distinct=distinct, interpret=True)
    return np.asarray(a1), np.asarray(a2)


@pytest.mark.parametrize("k", [1, 3, 11, 130, 1100])
@pytest.mark.parametrize("b", [1, 5, 130])
@pytest.mark.parametrize("tilt_kind", ["none", "k", "bk"])
@pytest.mark.parametrize("mask_kind", ["none", "k", "bk"])
@pytest.mark.parametrize("distinct", [False, True])
def test_dueling_select_matches_jax(distinct, mask_kind, tilt_kind, b, k):
    """Exact pairs over the shape/option grid, K > 1024 (the reference's
    score-then-argmax fallback) included."""
    x, a, th, mask, tilt = _select_inputs(b, k, mask_kind, tilt_kind,
                                          seed=b * 7919 + k)
    ref1, ref2 = _jax_pair(x, a, th, mask, tilt, distinct)
    a1, a2 = tds.dueling_select(
        t(x), t(a), t(th), tilt=None if tilt is None else t(tilt),
        mask=None if mask is None else t(mask), distinct=distinct)
    assert a1.dtype == torch.int32 and a2.dtype == torch.int32
    np.testing.assert_array_equal(a1.numpy(), ref1)
    np.testing.assert_array_equal(a2.numpy(), ref2)


@pytest.mark.parametrize("distinct", [False, True])
def test_dueling_select_single_survivor_and_all_inactive(distinct):
    """Rows with one live arm duel (k, k) under distinct; rows with no live
    arm return (0, 0) — both exactly as the reference."""
    b, k = 6, 11
    x, a, th, _, tilt = _select_inputs(b, k, "none", "bk", seed=3)
    mask = np.zeros((b, k), bool)
    mask[0, 4] = True                         # single survivor
    mask[1, [2, 9]] = True                    # two survivors
    mask[3, 10] = True
    mask[4] = True                            # rows 2 and 5 all inactive
    ref1, ref2 = _jax_pair(x, a, th, mask, tilt, distinct)
    a1, a2 = tds.dueling_select(t(x), t(a), t(th), tilt=t(tilt), mask=t(mask),
                                distinct=distinct)
    np.testing.assert_array_equal(a1.numpy(), ref1)
    np.testing.assert_array_equal(a2.numpy(), ref2)
    assert (a1[0].item(), a2[0].item()) == (4, 4)
    assert (a1[2].item(), a2[2].item()) == (0, 0)


def test_dueling_select_ties_take_first_index():
    """Duplicate arms score bitwise equal: the argmax takes the first."""
    x, a, th, _, _ = _select_inputs(40, 8, "none", "none", seed=5)
    a[4:] = a[:4]
    a1, a2 = tds.dueling_select(t(x), t(a), t(th), distinct=False)
    assert int(a1.max()) < 4 and int(a2.max()) < 4
    ref1, ref2 = _jax_pair(x, a, th, None, None, False)
    np.testing.assert_array_equal(a1.numpy(), ref1)
    np.testing.assert_array_equal(a2.numpy(), ref2)


def test_dueling_score_ref_matches_identity():
    """The explicit-feature oracle agrees with the two-matmul identity that
    the plain selection uses."""
    x, a, th, _, _ = _select_inputs(9, 13, "none", "none", seed=8)
    s = dueling_score_ref(t(x), t(a), t(th[0]), t(th[1]))
    xt, at = t(x), t(a)
    den = torch.sqrt(torch.clamp_min((xt * xt) @ (at * at).T, 1e-24))
    ident = torch.stack([((xt * t(th[j])) @ at.T) / den for j in range(2)])
    np.testing.assert_allclose(s.numpy(), ident.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# dueling_score and posterior_scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,k,d,j", [(100, 11, 384, 2), (7, 3, 64, 2),
                                     (130, 40, 256, 2), (9, 5, 32, 1),
                                     (9, 5, 32, 17)])
def test_dueling_score_matches_jax(b, k, d, j):
    """(J,B,K) scores against the Pallas kernel (interpret mode) and the
    explicit-feature oracle, J a runtime size."""
    rng = np.random.default_rng(b + k + j)
    x = rng.standard_normal((b, d)).astype(np.float32)
    a = rng.standard_normal((k, d)).astype(np.float32)
    th = rng.standard_normal((j, d)).astype(np.float32)
    want = np.asarray(jax_score(x, a, th, interpret=True))
    got = tds.dueling_score(t(x), t(a), t(th))
    assert got.shape == (j, b, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if j == 2:
        ref = dueling_score_ref(t(x), t(a), t(th[0]), t(th[1]))
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("k,c,d", [(4, 2, 32), (11, 6, 64), (40, 3, 128)])
def test_posterior_scores_matches_jax(k, c, d):
    """The all-ones query reduction: theta . a / ||a||, zero arm included
    (the 1e-24 clamp)."""
    rng = np.random.default_rng(k * c)
    a = rng.standard_normal((k, d)).astype(np.float32)
    a[1] = 0.0
    th = rng.standard_normal((c, d)).astype(np.float32)
    want = np.asarray(jax_post_scores(a, th, interpret=True))
    for fn in (tds.posterior_scores, tds.posterior_scores_plain):
        np.testing.assert_allclose(fn(t(a), t(th)).numpy(), want, rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# sgld_potential: forward and gradient
# ---------------------------------------------------------------------------

C = 3


def _sgld_inputs(m, k, variant, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, m, D)).astype(np.float32)
    a1 = rng.integers(0, k, (C, m)).astype(np.int32)
    a2 = ((a1 + rng.integers(1, k, (C, m))) % k).astype(np.int32)
    if variant == "self_duels":
        a2[:, ::3] = a1[:, ::3]
    y = np.where(rng.random((C, m)) < 0.5, 1.0, -1.0).astype(np.float32)
    valid = (rng.random((C, m)) < 0.8).astype(np.float32)
    a_emb = rng.standard_normal((k, D)).astype(np.float32)
    if variant == "ties":
        a_emb[k // 2:2 * (k // 2)] = a_emb[:k // 2]
    theta = rng.standard_normal((C, D)).astype(np.float32)
    mask = None
    if variant in ("mask", "mask_pref"):
        mask = np.ones(k, bool)
        mask[[1, k - 2]] = False
    pref = costs = None
    if variant in ("pref", "mask_pref", "ties"):
        pref = rng.choice([0.0, 0.5, 2.0], (C, m)).astype(np.float32)
        costs = rng.random(k).astype(np.float32)
    return theta, x, a1, a2, y, valid, a_emb, mask, pref, costs


@functools.lru_cache(maxsize=None)
def _jax_fns(j, eta, mu):
    def pot(th, x, a1, a2, y, v, a, mask, pref, costs):
        return jax_potential(th, x, a1, a2, y, v, a, mask, pref=pref,
                             costs=costs, j=j, eta=eta, mu=mu, backend="xla")
    return (jax.jit(jax.vmap(pot, in_axes=(0,) * 6 + (None,) * 2 + (0, None))),
            jax.jit(jax.vmap(jax.grad(pot),
                             in_axes=(0,) * 6 + (None,) * 2 + (0, None))))


def _jax_potential_and_grad(theta, x, a1, a2, y, valid, a_emb, mask, pref,
                            costs, j, eta, mu):
    k = a_emb.shape[0]
    m = np.ones(k, bool) if mask is None else mask
    p = np.zeros(valid.shape, np.float32) if pref is None else pref
    c = np.zeros(k, np.float32) if costs is None else costs
    fwd, grad = _jax_fns(j, eta, mu)
    args = (theta, x, a1, a2, y, valid, a_emb, m, p, c)
    return np.asarray(fwd(*args)), np.asarray(grad(*args))


VARIANTS = ["plain", "mask", "pref", "mask_pref", "ties", "self_duels"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("j", [1, 2])
def test_sgld_potential_matches_jax(j, variant):
    """Forward and hand gradient of the plain version against JAX's Pallas
    lowering and jax.grad, C=3 chains, ragged m, masks, prefs/costs, tied
    feel-good maxima and self-duels."""
    m, k, eta, mu = 37, 11, 1.5, 0.3
    ins = _sgld_inputs(m, k, variant, seed=11 * j + VARIANTS.index(variant))
    theta, x, a1, a2, y, valid, a_emb, mask, pref, costs = ins
    ref_u, ref_g = _jax_potential_and_grad(*ins, j, eta, mu)

    th = t(theta).requires_grad_(True)
    u = tsu.sgld_potential(th, t(x), t(a1), t(a2), t(y), t(valid), t(a_emb),
                           None if mask is None else t(mask),
                           pref=None if pref is None else t(pref),
                           costs=None if costs is None else t(costs), j=j,
                           eta=eta, mu=mu, backend="fused")
    (g,) = torch.autograd.grad(u.sum(), th)
    np.testing.assert_allclose(u.detach().numpy(), ref_u, **POT_TOL)
    np.testing.assert_allclose(g.numpy(), ref_g, **GRAD_TOL)


@pytest.mark.parametrize("variant", ["plain", "mask_pref", "ties"])
@pytest.mark.parametrize("j", [1, 2])
def test_sgld_potential_matches_port_autodiff(j, variant):
    """The hand gradient equals torch.autograd through the port's
    independent ``likelihood_batch`` (the "autodiff" backend's oracle)."""
    m, k = 29, 9
    theta, x, a1, a2, y, valid, a_emb, mask, pref, costs = _sgld_inputs(
        m, k, variant, seed=100 + j)
    cfg = tfgts.FGTSConfig(n_models=k, dim=D, horizon=m, eta=1.3, mu=0.27)
    th = t(theta).requires_grad_(True)
    terms = tfgts.likelihood_batch(
        th, t(x), t(a1), t(a2), t(y), t(a_emb), j, cfg,
        arm_mask=None if mask is None else t(mask),
        pref=None if pref is None else t(pref),
        costs=None if costs is None else t(costs))
    u_ref = torch.sum(terms * t(valid), dim=-1)
    (g_ref,) = torch.autograd.grad(u_ref.sum(), th)
    rows = torch.arange(C * m).reshape(C, m)
    flat = lambda v: None if v is None else t(v).reshape(C * m, *v.shape[2:])
    ops = (t(theta), flat(x), flat(a1), flat(a2), flat(y), flat(pref), rows,
           t(valid), t(a_emb), None if mask is None else t(mask),
           None if costs is None else t(costs))
    u = tsu.potential_rows(*ops, j=j, eta=cfg.eta, mu=cfg.mu)
    g = tsu.potential_grad_rows(*ops, j=j, eta=cfg.eta, mu=cfg.mu)
    np.testing.assert_allclose(u.numpy(), u_ref.detach().numpy(), **POT_TOL)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), **GRAD_TOL)


def test_sgld_potential_single_theta_and_shared_rows():
    """theta (d,) gives a scalar as in JAX; a shared (m,d) minibatch
    broadcasts over (C,d) chains."""
    theta, x, a1, a2, y, valid, a_emb, _, _, _ = _sgld_inputs(16, 6, "plain",
                                                              seed=7)
    u1 = tsu.sgld_potential(t(theta[0]), t(x[0]), t(a1[0]), t(a2[0]),
                            t(y[0]), t(valid[0]), t(a_emb))
    ref = jax_potential(theta[0], x[0], a1[0], a2[0], y[0], valid[0], a_emb,
                        backend="xla")
    assert u1.dim() == 0
    np.testing.assert_allclose(u1.numpy(), np.asarray(ref), **POT_TOL)
    uc = tsu.sgld_potential(t(theta), t(x[0]), t(a1[0]), t(a2[0]), t(y[0]),
                            t(valid[0]), t(a_emb), backend="xla")
    assert uc.shape == (C,)
    np.testing.assert_allclose(uc[0].numpy(), u1.numpy(), **POT_TOL)


# ---------------------------------------------------------------------------
# the mixed mode: duel and click rows
# ---------------------------------------------------------------------------

MIXED_VARIANTS = ["half", "duels", "clicks", "self_duels", "invalid"]


def _mixed_inputs(m, k, variant, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, m, D)).astype(np.float32)
    a1 = rng.integers(0, k, (C, m)).astype(np.int32)
    a2 = ((a1 + rng.integers(1, k, (C, m))) % k).astype(np.int32)
    duel = {"duels": np.ones((C, m), bool), "clicks": np.zeros((C, m), bool)
            }.get(variant, rng.random((C, m)) < 0.5)
    if variant == "self_duels":
        a2[:, ::2] = a1[:, ::2]
    y = np.where(duel, np.where(rng.random((C, m)) < 0.5, 1.0, -1.0),
                 (rng.random((C, m)) < 0.5).astype(np.float64))
    valid = (rng.random((C, m)) < 0.8).astype(np.float32)
    if variant == "invalid":
        valid[:, :m // 2] = 0.0
    a_emb = rng.standard_normal((k, D)).astype(np.float32)
    theta = rng.standard_normal((C, D)).astype(np.float32)
    return (theta, x, a1, a2, y.astype(np.float32),
            duel.astype(np.float32), valid, a_emb)


@functools.lru_cache(maxsize=None)
def _jax_mixed_fns(eta):
    def pot(th, x, a1, a2, y, du, v, a):
        return jax_mixed(th, x, a1, a2, y, du, v, a, eta=eta, backend="xla")
    axes = (0,) * 7 + (None,)
    return jax.jit(jax.vmap(pot, axes)), jax.jit(jax.vmap(jax.grad(pot),
                                                          axes))


@pytest.mark.parametrize("variant", MIXED_VARIANTS)
def test_sgld_mixed_potential_matches_jax(variant):
    """Forward and hand gradient of the mixed mode's plain version (through
    ``sgld_mixed_potential``'s autograd) against JAX's Pallas lowering and
    jax.grad: C = 3 chains, ragged m, duels and clicks mixed, all duels,
    all clicks, self-duels, invalid rows."""
    ins = _mixed_inputs(37, 11, variant, MIXED_VARIANTS.index(variant))
    fwd, grad = _jax_mixed_fns(1.5)
    ref_u, ref_g = np.asarray(fwd(*ins)), np.asarray(grad(*ins))
    theta, x, a1, a2, y, duel, valid, a_emb = ins
    th = t(theta).requires_grad_(True)
    u = tsu.sgld_mixed_potential(th, t(x), t(a1), t(a2), t(y), t(duel),
                                 t(valid), t(a_emb), eta=1.5)
    (g,) = torch.autograd.grad(u.sum(), th)
    np.testing.assert_allclose(u.detach().numpy(), ref_u, **POT_TOL)
    np.testing.assert_allclose(g.numpy(), ref_g, **GRAD_TOL)
    u1 = tsu.sgld_mixed_potential(t(theta[0]), t(x[0]), t(a1[0]), t(a2[0]),
                                  t(y[0]), t(duel[0] > 0), t(valid[0]),
                                  t(a_emb), eta=1.5, backend="xla")
    assert u1.dim() == 0
    np.testing.assert_allclose(u1.numpy(), ref_u[0], **POT_TOL)


def test_mixed_rows_match_port_autodiff():
    """The mixed rows' hand gradient equals torch.autograd through the
    port's phi-feature terms (the "autodiff" backend's oracle), with g."""
    from repro_torch.core.extensions import _mixed_terms_autodiff
    theta, x, a1, a2, y, duel, valid, a_emb = _mixed_inputs(29, 9, "half", 9)
    th = t(theta).requires_grad_(True)
    terms = _mixed_terms_autodiff(th, t(x), t(a1).long(), t(a2).long(), t(y),
                                  t(duel) > 0, t(a_emb), 1.3)
    g_in = torch.tensor([0.5, 1.0, 2.0])
    u_ref = torch.sum(terms * t(valid), dim=-1)
    (g_ref,) = torch.autograd.grad((u_ref * g_in).sum(), th)
    rows = torch.arange(C * 29).reshape(C, 29)
    flat = lambda v: t(v).reshape(C * 29, *v.shape[2:])
    ops = (t(theta), flat(x), flat(a1), flat(a2), flat(y), flat(duel), rows,
           t(valid), t(a_emb))
    u = tsu.mixed_potential_rows(*ops, eta=1.3)
    g = tsu.mixed_potential_grad_rows(*ops, g_in, eta=1.3)
    np.testing.assert_allclose(u.numpy(), u_ref.detach().numpy(), **POT_TOL)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), **GRAD_TOL)


def test_backend_resolution():
    assert tsu.resolve_sgld_backend("auto") == "fused"
    for b in ("fused", "xla", "autodiff"):
        assert tsu.resolve_sgld_backend(b) == b
    with pytest.raises(ValueError):
        tsu.resolve_sgld_backend("mosaic")
    with pytest.raises(ValueError):
        tsu.sgld_potential(torch.zeros(4), torch.zeros(2, 4),
                           torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32), torch.ones(2),
                           torch.ones(2), torch.ones(3, 4), backend="autodiff")


def test_cpu_tensors_never_count_launches():
    tk.reset_launch_counts()
    x, a, th, mask, tilt = _select_inputs(4, 5, "k", "k", seed=1)
    tds.dueling_select(t(x), t(a), t(th), tilt=t(tilt), mask=t(mask))
    theta, xs, a1, a2, y, valid, a_emb, _, _, _ = _sgld_inputs(8, 5, "plain",
                                                               seed=2)
    th = t(theta).requires_grad_(True)
    u = tsu.sgld_potential(th, t(xs), t(a1), t(a2), t(y), t(valid), t(a_emb))
    u.sum().backward()
    tds.dueling_score(t(x), t(a), t(th.detach()))
    tk.posterior_scores(t(a), t(th.detach()))
    ins = _mixed_inputs(8, 5, "half", seed=3)
    thm = t(ins[0]).requires_grad_(True)
    u = tsu.sgld_mixed_potential(thm, *map(t, ins[1:]))
    u.sum().backward()
    q = t(np.ones((1, 2, 4, 32), np.float32))
    tfa.flash_attention(q, q[:, :1], q[:, :1], causal=True, window=2)
    z = torch.zeros
    tk.WRAPPERS["ssd_scan"](z((1, 5, 2, 8)), z((1, 5, 4)), z((1, 5, 4)),
                            z((1, 5, 2)), z((1, 5, 2)), chunk=16)
    tk.WRAPPERS["rglru_scan"](z((1, 5, 8)), z((1, 5, 8)))
    assert tk.launch_counts() == {"dueling_select": 0,
                                  "sgld_potential_fwd": 0,
                                  "sgld_potential_grad": 0,
                                  "dueling_score": 0,
                                  "sgld_mixed_fwd": 0,
                                  "sgld_mixed_grad": 0,
                                  "flash_attention": 0,
                                  "ssd_scan": 0,
                                  "rglru_scan": 0}
