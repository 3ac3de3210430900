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


def _fma(a, b, c):
    """fmaf in float32: the product exact in float64, one sum, then one
    rounding to float32 (the double rounding can differ from fmaf in the
    last place, rarely)."""
    return (a.double() * b.double() + c.double()).float()


def _lane_sums(u, v, width):
    """sum_t u[..., t] * v[..., t] (float32) in the order of a warp whose
    lane l takes d's loads l, l + 32, ... of ``width`` elements each (4:
    float4s, 1: single floats), one fma per element in increasing t, and
    then the xor tree: lane l adds lane l ^ o's sum for o = 16, 8, 4, 2, 1.
    Elements past d add nothing."""
    d = u.shape[-1]
    lanes = torch.arange(32)
    acc = torch.zeros(torch.broadcast_shapes(u.shape, v.shape)[:-1] + (32,))
    for step in range(-(-d // (32 * width)) * width):
        t = (step // width) * 32 * width + lanes * width + step % width
        live = t < d
        tc = torch.where(live, t, 0)
        acc = torch.where(live, _fma(u[..., tc], v[..., tc], acc), acc)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def _emulated_small_scores(x, a, th, width):
    """(J,B,K) scores in the order of ``csrc/dueling_score.cu``'s Small
    configuration: a warp per output, numerator and denominator by
    ``_lane_sums``, the denominator the same for every sample."""
    xt = x[None] * th[:, None]                             # (J, B, d)
    num = _lane_sums(xt[:, :, None], a[None, None], width)
    den = _lane_sums((x * x)[:, None], (a * a)[None], width)
    return num / torch.sqrt(torch.clamp_min(den, 1e-24))[None]


@pytest.mark.parametrize("b,k,d,j,width", [(1, 16, 768, 16, 4),
                                           (7, 3, 64, 2, 4),
                                           (9, 5, 30, 17, 1),
                                           (5, 37, 100, 3, 1),
                                           (5, 37, 100, 3, 4)])
def test_small_score_order_matches_jax(b, k, d, j, width):
    """The Small score kernel's lane-strided sums and xor tree (emulated)
    against the Pallas kernel (interpret mode) within 1e-5 of max|s|, both
    load widths (ragged d takes the 4-byte rule); duplicated arms give
    bitwise equal columns, a zero arm and a zero query score exactly 0."""
    rng = np.random.default_rng(b * k + d + j)
    x = rng.standard_normal((b, d)).astype(np.float32)
    a = rng.standard_normal((k, d)).astype(np.float32)
    th = rng.standard_normal((j, d)).astype(np.float32)
    if k > 2:
        a[k - 1] = a[0]
        a[1] = 0.0
    if b > 2:
        x[2] = 0.0
    want = np.asarray(jax_score(x, a, th, interpret=True))
    got = _emulated_small_scores(t(x), t(a), t(th), width)
    assert tds.score_plan(b, k, j, d)[0] == 0
    assert float(np.abs(got.numpy() - want).max()) <= \
        1e-5 * float(np.abs(want).max())
    if k > 2:
        assert torch.equal(got[..., k - 1], got[..., 0])
        assert not bool(got[..., 1].any())
    if b > 2:
        assert not bool(got[:, 2].any())
    if b == 1:                      # posterior_scores: the all-ones query
        ones = np.ones((1, d), np.float32)
        post = np.asarray(jax_post_scores(a, th, interpret=True))
        got = _emulated_small_scores(t(ones), t(a), t(th), width)[:, 0]
        assert float(np.abs(got.numpy() - post).max()) <= \
            1e-5 * float(np.abs(post).max())
        assert torch.equal(got[:, k - 1], got[:, 0])


@pytest.mark.parametrize("b,k,j,d", [(1, 16, 16, 768), (63, 16, 16, 768),
                                     (256, 16, 16, 768), (170, 1024, 1, 768),
                                     (171, 1024, 1, 768), (4096, 1024, 2, 768),
                                     (5, 37, 3, 100), (1, 1, 1, 1),
                                     (131072, 1, 1, 1024), (200, 1, 1, 8)])
def test_score_plan_covers_every_output(b, k, j, d):
    """Small exactly within the B*K*J*d cap (B 170 and 171 at K 1024, J 1,
    d 768 are its two sides), its grid a warp for every output and no
    block without one; Large's tiles cover every (b, k) and sample pair
    with no empty edge tile; a grid past CUDA's 65535 blocks in y or z
    raises."""
    cfg, grid = tds.score_plan(b, k, j, d)
    assert cfg == (0 if b * k * j * d <= tds.SMALL_WORK else 1)
    if cfg == 0:
        n, w = j * b * k, tds.SMALL_WARPS
        assert grid[1:] == (1, 1) and grid[0] * w >= n > (grid[0] - 1) * w
    else:
        for g, size, tile in zip(grid, (k, b, j), (64, 64, 2)):
            assert g * tile >= size > (g - 1) * tile
    with pytest.raises(ValueError, match="grid"):
        tds.score_plan(64 * 65535 + 1, k, j, 1 << 10)
    with pytest.raises(ValueError, match="grid"):
        tds.score_plan(64, k, 2 * 65535 + 1, 1 << 10)


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
# the fgts CUDA kernel's order of operations, emulated on the CPU
# ---------------------------------------------------------------------------

def _fold_blocks(rows_terms, m, cl, rpb):
    """The kernel's reduction: each block sums its rows (rank b holds rows
    b*rpb .. (b+1)*rpb - 1) in row order from 0, then the chain's result
    is the blocks' partials summed in rank order from 0."""
    out = torch.zeros_like(rows_terms[:, 0])
    for b in range(cl):
        acc = torch.zeros_like(rows_terms[:, 0])
        for i in range(b * rpb, min(m, (b + 1) * rpb)):
            acc = acc + rows_terms[:, i]
        out = out + acc
    return out


def _emulated_fgts(theta, x, a1, a2, y, pref, rows, valid, a_emb, mask,
                   costs, g, *, j, eta, mu):
    """(U (C,), g * dU (C,d), scores (C,m,K)) in the order of
    ``csrc/sgld_potential.cu``'s fgts kernel: each score's numerator and
    denominator one fma per t in increasing t within each of
    ``fgts_order``'s segments, the segments added in order, then the
    running max with
    its first index and tie count, the gradient rows fma'd on a1, a2 and
    each tied maximum in arm order, and ``_fold_blocks`` over
    ``fgts_plan``'s blocks."""
    c, d = theta.shape
    m, k = rows.shape[1], a_emb.shape[0]
    cfg, cl, rpb = tsu.fgts_plan(m, k, d)
    n_seg, seg_len = tsu.fgts_order(cfg, k, d)
    r = rows.long()
    xg = x[r]
    xt, xx, aa = xg * theta[:, None, :], xg * xg, a_emb * a_emb
    num = den = None
    for s0 in range(0, n_seg * seg_len, seg_len):
        sn = torch.zeros((c, m, k))
        sd = torch.zeros((c, m, k))
        for i in range(s0, min(s0 + seg_len, d)):
            sn = _fma(xt[..., i, None], a_emb[:, i], sn)
            sd = _fma(xx[..., i, None], aa[:, i], sd)
        num = sn if num is None else num + sn
        den = sd if den is None else den + sd
    dn = torch.sqrt(torch.clamp_min(den, 1e-24))
    s = num / dn
    ia1, ia2, yv, v = a1[r].long(), a2[r].long(), y[r], valid
    pr = torch.zeros_like(yv) if pref is None else pref[r]
    cost = torch.zeros(k) if costs is None else costs
    live = torch.ones(k, dtype=torch.bool) if mask is None else mask
    tv = s - pr[..., None] * cost
    smax = torch.where(live, tv, -torch.inf).amax(dim=-1)
    eq = (tv == smax[..., None]) & live
    cnt = eq.sum(dim=-1)
    kmax = torch.argmax(eq.int(), dim=-1)
    pick = lambda v_, idx: torch.gather(v_, -1, idx[..., None])[..., 0]
    s1, s2, den1, den2 = pick(s, ia1), pick(s, ia2), pick(dn, ia1), \
        pick(dn, ia2)
    opp = ia2 if j == 1 else ia1
    s_opp = (s2 if j == 1 else s1) - pr * cost[opp]
    z = yv * (s1 - s2)
    mu_row = mu / (1.0 + torch.clamp_min(pr, 0.0))
    terms = (eta * tsu.softplus(-z) - mu_row * (smax - s_opp)) * v
    u = _fold_blocks(terms, m, cl, rpb)

    dz = (eta * (-1.0 / (1.0 + torch.exp(z)))) * yv
    self_duel = ia1 == ia2
    w1 = torch.where(self_duel, 0.0, dz)
    w2 = torch.where(self_duel, 0.0, -dz)
    if j == 1:
        w2 = w2 + mu_row
    else:
        w1 = w1 + mu_row
    c1, c2 = (w1 * v) / den1, (w2 * v) / den2
    wt = (-mu_row / torch.clamp_min(cnt, 1).float()) * v
    gr = _fma(c2[..., None], a_emb[ia2], (c1[..., None] * a_emb[ia1]))
    one = (cnt == 1)[..., None]
    gr = torch.where(one, _fma((wt / pick(dn, kmax))[..., None],
                               a_emb[kmax], gr), gr)
    for kk in range(k):
        tied = ((cnt > 1) & eq[..., kk])[..., None]
        gr = torch.where(tied, _fma((wt / dn[..., kk])[..., None], a_emb[kk],
                                    gr), gr)
    grad = _fold_blocks(xg * gr, m, cl, rpb)
    return u, (grad if g is None else g[:, None] * grad), s


@pytest.mark.parametrize("m,k", [(37, 11), (70, 40)])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("j", [1, 2])
def test_sgld_kernel_order_matches_jax_and_plain(j, variant, m, k):
    """The fgts kernel's order of operations (emulated) against the JAX
    potential and its jax.grad, and against the plain version; duplicated
    arms (the ``ties`` variant) score bitwise equal in it."""
    eta, mu = 1.5, 0.3
    ins = _sgld_inputs(m, k, variant, seed=31 * j + VARIANTS.index(variant))
    theta, x, a1, a2, y, valid, a_emb, mask, pref, costs = ins
    ref_u, ref_g = _jax_potential_and_grad(*ins, j, eta, mu)
    rows = torch.arange(C * m).reshape(C, m)
    flat = lambda v: None if v is None else t(v).reshape(C * m, *v.shape[2:])
    ops = (t(theta), flat(x), flat(a1), flat(a2), flat(y), flat(pref), rows,
           t(valid), t(a_emb), None if mask is None else t(mask),
           None if costs is None else t(costs))
    u, g, s = _emulated_fgts(*ops, None, j=j, eta=eta, mu=mu)
    np.testing.assert_allclose(u.numpy(), ref_u, **POT_TOL)
    np.testing.assert_allclose(g.numpy(), ref_g, **GRAD_TOL)
    kw = dict(j=j, eta=eta, mu=mu)
    np.testing.assert_allclose(u.numpy(), tsu.potential_rows(*ops, **kw),
                               **POT_TOL)
    gs = torch.rand(C) + 0.5
    _, g2, _ = _emulated_fgts(*ops, gs, j=j, eta=eta, mu=mu)
    np.testing.assert_allclose(g2.numpy(),
                               tsu.potential_grad_rows(*ops, gs, **kw),
                               **GRAD_TOL)
    if variant == "ties":
        h = k // 2
        assert torch.equal(s[..., h:2 * h], s[..., :h])


@pytest.mark.parametrize("m,k,d", [(64, 16, 768), (1024, 1024, 768),
                                   (37, 1, 100), (300, 130, 200),
                                   (37, 300, 64), (10, 5, 2600),
                                   (5, 2000, 3680), (0, 4, 8)])
def test_fgts_plan_fits_and_covers_every_row(m, k, d):
    """Every configuration the plan picks fits a block's shared memory,
    Small only for K <= 32; the cluster holds 1-8 blocks, each with rows,
    and they cover the chain's m rows exactly."""
    cfg, cl, rpb = tsu.fgts_plan(m, k, d)
    assert tsu.fgts_smem(cfg, d) <= tsu.FGTS_SMEM_BYTES
    assert (cfg == 0) == (k <= 32 and tsu.fgts_smem(0, d)
                          <= tsu.FGTS_SMEM_BYTES)
    assert 1 <= cl <= tsu.MAX_CLUSTER
    assert cl * rpb >= m and (cl - 1) * rpb < max(m, 1)
    with pytest.raises(ValueError, match="shared memory"):
        tsu.fgts_plan(m, k, 3681)


# ---------------------------------------------------------------------------
# the mixed mode: duel and click rows
# ---------------------------------------------------------------------------

MIXED_VARIANTS = ["half", "duels", "clicks", "self_duels", "invalid"]


def _mixed_inputs(m, k, variant, seed, d=D):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, m, d)).astype(np.float32)
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
    a_emb = rng.standard_normal((k, d)).astype(np.float32)
    theta = rng.standard_normal((C, d)).astype(np.float32)
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


def _emulated_mixed(theta, x, a1, a2, y, is_duel, rows, valid, a_emb, g,
                    *, eta, width):
    """(U (C,), g * dU (C,d)) in the order of ``csrc/sgld_potential.cu``'s
    mixed kernel: each row's sums for a1 (and a2 on a duel) by
    ``_lane_sums`` (``width`` 4: 16-byte loads, 1: 4-byte), then its term
    or its gradient row x_r * (c1 a_a1 + c2 a_a2), and ``_fold_blocks``
    over ``mixed_plan``'s blocks."""
    c, d = theta.shape
    m = rows.shape[1]
    cl, rpb, _ = tsu.mixed_plan(m, d)
    r = rows.long()
    xg, yv, duel = x[r], y[r], is_duel[r] > 0
    ia1 = a1[r].long()
    ia2 = torch.where(duel, a2[r].long(), ia1)
    u, w = a_emb[ia1], a_emb[ia2]
    xt, xx = xg * theta[:, None], xg * xg
    den1 = torch.sqrt(torch.clamp_min(_lane_sums(xx, u * u, width), 1e-24))
    den2 = torch.sqrt(torch.clamp_min(_lane_sums(xx, w * w, width), 1e-24))
    s1 = _lane_sums(xt, u, width) / den1
    s2 = _lane_sums(xt, w, width) / den2
    z = yv * (s1 - s2)
    term = torch.where(duel, tsu.softplus(-z),
                       torch.where(yv > 0.5, tsu.softplus(-s1),
                                   tsu.softplus(s1)))
    u_c = _fold_blocks((eta * term) * valid, m, cl, rpb)
    dz = (eta * (-1.0 / (1.0 + torch.exp(z)))) * yv
    w1 = torch.where(ia1 == ia2, 0.0, dz)
    wc = eta * torch.where(yv > 0.5, -1.0 / (1.0 + torch.exp(s1)),
                           1.0 / (1.0 + torch.exp(-s1)))
    c1 = torch.where(duel, w1 * valid / den1, wc * valid / den1)
    c2 = torch.where(duel, (-w1) * valid / den2, 0.0)
    gr = xg * _fma(c2[..., None], w, c1[..., None] * u)
    grad = _fold_blocks(gr, m, cl, rpb)
    return u_c, (grad if g is None else g[:, None] * grad)


@pytest.mark.parametrize("m,d", [(37, 32), (70, 30), (5, 32)])
@pytest.mark.parametrize("variant", MIXED_VARIANTS)
def test_mixed_kernel_order_matches_jax_and_plain(variant, m, d):
    """The mixed kernel's order (emulated): lane-strided row sums and the
    xor tree, rows in order inside each block and blocks in rank order
    from ``mixed_plan`` (m 37: 5 blocks of 8; m 70: 8 of 9, so two groups
    a block; m 5: one block; d 30: the 4-byte loads), against JAX's Pallas
    lowering and jax.grad within 1e-5 of the largest magnitude, and
    against the plain version."""
    ins = _mixed_inputs(m, 11, variant, 7 + MIXED_VARIANTS.index(variant),
                        d=d)
    fwd, grad = _jax_mixed_fns(1.5)
    ref_u, ref_g = np.asarray(fwd(*ins)), np.asarray(grad(*ins))
    theta, x, a1, a2, y, duel, valid, a_emb = ins
    rows = torch.arange(C * m).reshape(C, m)
    flat = lambda v: t(v).reshape(C * m, *v.shape[2:])
    ops = (t(theta), flat(x), flat(a1), flat(a2), flat(y), flat(duel), rows,
           t(valid), t(a_emb))
    width = 4 if d % 4 == 0 else 1
    u, g = _emulated_mixed(*ops, None, eta=1.5, width=width)
    for got, want in ((u, ref_u), (g, ref_g)):
        assert float(np.abs(got.numpy() - want).max()) <= \
            1e-5 * float(np.abs(want).max())
    gs = torch.rand(C) + 0.5
    _, g2 = _emulated_mixed(*ops, gs, eta=1.5, width=width)
    np.testing.assert_allclose(u.numpy(),
                               tsu.mixed_potential_rows(*ops, eta=1.5),
                               **POT_TOL)
    np.testing.assert_allclose(g2.numpy(),
                               tsu.mixed_potential_grad_rows(*ops, gs,
                                                             eta=1.5),
                               **GRAD_TOL)


@pytest.mark.parametrize("m,d", [(64, 768), (1024, 768), (1, 768), (5, 768),
                                 (45, 768), (37, 100), (9, 3056), (9, 3057),
                                 (300, 6200), (9, 13760), (0, 8)])
def test_mixed_plan_fits_and_covers_every_row(m, d):
    """The group size is the largest of 8, 4, 2, 1 rows whose two buffers
    of gradient rows fit a block's shared memory; the cluster holds 1-8
    blocks, each with rows, and they cover the chain's m rows exactly; a d
    no group size fits raises."""
    cl, rpb, rb = tsu.mixed_plan(m, d)
    fits = [n for n in tsu.MIXED_ROWS
            if tsu.mixed_smem(n, d) <= tsu.MIXED_SMEM_BYTES]
    assert rb == fits[0]
    assert 1 <= cl <= tsu.MAX_CLUSTER
    assert cl * rpb >= m and (cl - 1) * rpb < max(m, 1)
    with pytest.raises(ValueError, match="shared"):
        tsu.mixed_plan(m, 13761)


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
