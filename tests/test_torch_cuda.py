"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test takes the ``cuda_device`` fixture, which skips when no CUDA card
is present (decided inside the fixture, never at import). The file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Pairs must be exact (the inputs are random, so near-ties are vanishingly
rare at these sizes); scores match to 1e-5 of their largest magnitude,
duplicated arms bitwise; potentials match to rtol 1e-5 and gradients to
rtol 1e-4 (fp32 with another summation order on the card).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import dueling_score as tds
from repro_torch.kernels import sgld_update as tsu

POT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: holds a CUDA kernel against its "
                    "plain version")
    return torch.device("cuda")


def _select_inputs(b, k, d, mask_kind, tilt_kind, seed, dev):
    rng = np.random.default_rng(seed)
    on = lambda v: None if v is None else torch.from_numpy(v).to(dev)
    mask = {"none": None, "k": rng.random(k) > 0.3,
            "bk": rng.random((b, k)) > 0.3}[mask_kind]
    tilt = {"none": None,
            "k": (0.3 * rng.random(k)).astype(np.float32),
            "bk": (0.3 * rng.random((b, k))).astype(np.float32)}[tilt_kind]
    return (on(rng.standard_normal((b, d)).astype(np.float32)),
            on(rng.standard_normal((k, d)).astype(np.float32)),
            on(rng.standard_normal((2, d)).astype(np.float32)),
            on(mask), on(tilt))


@pytest.mark.parametrize("k,d", [(1, 64), (11, 768), (37, 100), (1100, 96)])
@pytest.mark.parametrize("mask_kind,tilt_kind", [("none", "none"),
                                                 ("k", "bk"), ("bk", "k")])
@pytest.mark.parametrize("distinct", [False, True])
def test_dueling_select_kernel_matches_plain(cuda_device, distinct,
                                             mask_kind, tilt_kind, k, d):
    x, a, th, mask, tilt = _select_inputs(130, k, d, mask_kind, tilt_kind,
                                          seed=k, dev=cuda_device)
    before = tds.dueling_select.launches
    a1, a2 = tds.dueling_select(x, a, th, tilt=tilt, mask=mask,
                                distinct=distinct)
    torch.cuda.synchronize()
    assert tds.dueling_select.launches == before + 1
    p1, p2 = tds.dueling_select_plain(x, a, th, tilt=tilt, mask=mask,
                                      distinct=distinct)
    np.testing.assert_array_equal(a1.cpu().numpy(), p1.cpu().numpy())
    np.testing.assert_array_equal(a2.cpu().numpy(), p2.cpu().numpy())


def test_dueling_select_kernel_edges(cuda_device):
    """Single survivor -> (k, k); all-inactive row -> (0, 0); duplicated
    arms -> the first copy wins."""
    x, a, th, _, tilt = _select_inputs(6, 11, 64, "none", "bk", 3,
                                       cuda_device)
    mask = torch.zeros((6, 11), dtype=torch.bool, device=cuda_device)
    mask[0, 4] = True
    mask[1, [2, 9]] = True
    mask[4] = True
    a1, a2 = tds.dueling_select(x, a, th, tilt=tilt, mask=mask, distinct=True)
    p1, p2 = tds.dueling_select_plain(x, a, th, tilt=tilt, mask=mask,
                                      distinct=True)
    assert a1.tolist() == p1.tolist() and a2.tolist() == p2.tolist()
    assert (a1[0].item(), a2[0].item()) == (4, 4)
    assert (a1[2].item(), a2[2].item()) == (0, 0)
    a[6:] = a[:5]
    d1, d2 = tds.dueling_select(x, a, th)
    assert int(d1.max()) < 6 and int(d2.max()) < 6


VARIANTS = ["plain", "mask", "pref", "ties", "self_duels"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("j", [1, 2])
@pytest.mark.parametrize("m,k,d", [(37, 11, 64), (300, 130, 200)])
def test_sgld_kernels_match_plain(cuda_device, j, variant, m, k, d):
    rng = np.random.default_rng(j)
    c, n = 3, 500
    on = lambda v: torch.from_numpy(np.asarray(v)).to(cuda_device)
    x = on(rng.standard_normal((n, d)).astype(np.float32))
    a1 = rng.integers(0, k, n).astype(np.int32)
    a2 = ((a1 + rng.integers(1, k, n)) % k).astype(np.int32)
    if variant == "self_duels":
        a2[::3] = a1[::3]
    y = on(np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32))
    a_emb = rng.standard_normal((k, d)).astype(np.float32)
    if variant == "ties":
        a_emb[k // 2:2 * (k // 2)] = a_emb[:k // 2]
    rows = on(rng.integers(0, n, (c, m)))
    valid = on((rng.random((c, m)) < 0.8).astype(np.float32))
    mask = on(np.arange(k) % 5 != 1) if variant == "mask" else None
    pref = costs = None
    if variant in ("pref", "ties"):
        pref = on(rng.choice([0.0, 0.5, 2.0], n).astype(np.float32))
        costs = on(rng.random(k).astype(np.float32))
    theta = on(rng.standard_normal((c, d)).astype(np.float32))
    ops = (theta, x, on(a1), on(a2), y, pref, rows, valid, on(a_emb), mask,
           costs)
    g = torch.rand(c, device=cuda_device) + 0.5
    kw = dict(j=j, eta=1.5, mu=0.3)
    before = kernels.launch_counts()
    u_k = tsu.potential_rows(*ops, **kw)
    g_k = tsu.potential_grad_rows(*ops, g, **kw)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["sgld_potential_fwd"] == before["sgld_potential_fwd"] + 1
    assert after["sgld_potential_grad"] == before["sgld_potential_grad"] + 1
    u_p = tsu.potential_rows(*ops, **kw, plain=True)
    g_p = tsu.potential_grad_rows(*ops, g, **kw, plain=True)
    np.testing.assert_allclose(u_k.cpu().numpy(), u_p.cpu().numpy(),
                               **POT_TOL)
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(),
                               **GRAD_TOL)


def test_autograd_backward_is_the_gradient_kernel(cuda_device):
    rng = np.random.default_rng(0)
    on = lambda v: torch.from_numpy(np.asarray(v)).to(cuda_device)
    th = on(rng.standard_normal((2, 32)).astype(np.float32))
    th.requires_grad_(True)
    x = on(rng.standard_normal((2, 20, 32)).astype(np.float32))
    a1 = on(rng.integers(0, 6, (2, 20)).astype(np.int32))
    a2 = on(((a1.cpu().numpy() + 1) % 6).astype(np.int32))
    y = on(np.ones((2, 20), np.float32))
    v = on(np.ones((2, 20), np.float32))
    a = on(rng.standard_normal((6, 32)).astype(np.float32))
    before = kernels.launch_counts()
    u = tsu.sgld_potential(th, x, a1, a2, y, v, a)
    u.sum().backward()
    after = kernels.launch_counts()
    assert after["sgld_potential_fwd"] == before["sgld_potential_fwd"] + 1
    assert after["sgld_potential_grad"] == before["sgld_potential_grad"] + 1
    th2 = th.detach().requires_grad_(True)
    u2 = tsu.sgld_potential(th2, x, a1, a2, y, v, a, backend="xla")
    u2.sum().backward()
    np.testing.assert_allclose(th.grad.cpu().numpy(), th2.grad.cpu().numpy(),
                               **GRAD_TOL)


@pytest.mark.parametrize("b,k,d,j", [(1, 1, 64, 1), (130, 37, 100, 17),
                                     (1, 16, 768, 16), (300, 130, 200, 2)])
def test_dueling_score_kernel_matches_plain(cuda_device, b, k, d, j):
    """Ragged tiles in every dimension, J odd and above one pair;
    duplicated arms give bitwise equal columns; a zero query row and a zero
    arm take the 1e-24 clamp."""
    rng = np.random.default_rng(b + k + j)
    on = lambda v: torch.from_numpy(v).to(cuda_device)
    x = rng.standard_normal((b, d)).astype(np.float32)
    a = rng.standard_normal((k, d)).astype(np.float32)
    if k > 2:
        a[k - 1] = a[0]
        a[1] = 0.0
    if b > 2:
        x[2] = 0.0
    th = on(rng.standard_normal((j, d)).astype(np.float32))
    x, a = on(x), on(a)
    before = tds.dueling_score.launches
    s = tds.dueling_score(x, a, th)
    torch.cuda.synchronize()
    assert tds.dueling_score.launches == before + 1
    p = tds.dueling_score_plain(x, a, th)
    scale = float(p.abs().max())
    assert float((s - p).abs().max()) <= 1e-5 * scale
    if k > 2:
        assert torch.equal(s[..., k - 1], s[..., 0])
        assert not bool(s[..., 1].any())
    if b > 2:
        assert not bool(s[:, 2].any())


def test_posterior_scores_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((16, 768)).astype(np.float32))
    th = torch.from_numpy(rng.standard_normal((16, 768)).astype(np.float32))
    a, th = a.to(cuda_device), th.to(cuda_device)
    s = tds.posterior_scores(a, th)
    p = tds.posterior_scores_plain(a, th)
    assert s.shape == (16, 16)
    assert float((s - p).abs().max()) <= 1e-5 * float(p.abs().max())


MIXED = ["half", "duels", "clicks", "invalid", "self_duels"]


@pytest.mark.parametrize("variant", MIXED)
@pytest.mark.parametrize("m,k,d", [(37, 11, 64), (300, 130, 200)])
def test_sgld_mixed_kernels_match_plain(cuda_device, variant, m, k, d):
    rng = np.random.default_rng(m + MIXED.index(variant))
    c, n = 3, 500
    on = lambda v: torch.from_numpy(np.asarray(v)).to(cuda_device)
    a1 = rng.integers(0, k, n).astype(np.int32)
    a2 = ((a1 + rng.integers(1, k, n)) % k).astype(np.int32)
    if variant == "self_duels":
        a2[::2] = a1[::2]
    duel = {"duels": np.ones(n, bool), "clicks": np.zeros(n, bool)}.get(
        variant, rng.random(n) < 0.5)
    y = np.where(duel, np.where(rng.random(n) < 0.5, 1.0, -1.0),
                 (rng.random(n) < 0.5).astype(np.float64)).astype(np.float32)
    valid = (rng.random((c, m)) < 0.8).astype(np.float32)
    if variant == "invalid":
        valid[:, ::2] = 0.0
    ops = (on(rng.standard_normal((c, d)).astype(np.float32)),
           on(rng.standard_normal((n, d)).astype(np.float32)), on(a1), on(a2),
           on(y), on(duel.astype(np.float32)), on(rng.integers(0, n, (c, m))),
           on(valid), on(rng.standard_normal((k, d)).astype(np.float32)))
    g = torch.rand(c, device=cuda_device) + 0.5
    before = kernels.launch_counts()
    u_k = tsu.mixed_potential_rows(*ops, eta=1.5)
    g_k = tsu.mixed_potential_grad_rows(*ops, g, eta=1.5)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["sgld_mixed_fwd"] == before["sgld_mixed_fwd"] + 1
    assert after["sgld_mixed_grad"] == before["sgld_mixed_grad"] + 1
    u_p = tsu.mixed_potential_rows(*ops, eta=1.5, plain=True)
    g_p = tsu.mixed_potential_grad_rows(*ops, g, eta=1.5, plain=True)
    np.testing.assert_allclose(u_k.cpu().numpy(), u_p.cpu().numpy(),
                               **POT_TOL)
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(),
                               **GRAD_TOL)


def test_mixed_autograd_backward_is_the_gradient_kernel(cuda_device):
    rng = np.random.default_rng(1)
    on = lambda v: torch.from_numpy(np.asarray(v)).to(cuda_device)
    th = on(rng.standard_normal((2, 32)).astype(np.float32))
    th.requires_grad_(True)
    x = on(rng.standard_normal((2, 20, 32)).astype(np.float32))
    a1 = on(rng.integers(0, 6, (2, 20)).astype(np.int32))
    a2 = on(((a1.cpu().numpy() + 1) % 6).astype(np.int32))
    y = on(np.ones((2, 20), np.float32))
    du = on((rng.random((2, 20)) < 0.5).astype(np.float32))
    v = on(np.ones((2, 20), np.float32))
    a = on(rng.standard_normal((6, 32)).astype(np.float32))
    before = kernels.launch_counts()
    u = tsu.sgld_mixed_potential(th, x, a1, a2, y, du, v, a)
    u.sum().backward()
    after = kernels.launch_counts()
    assert after["sgld_mixed_fwd"] == before["sgld_mixed_fwd"] + 1
    assert after["sgld_mixed_grad"] == before["sgld_mixed_grad"] + 1
    th2 = th.detach().requires_grad_(True)
    u2 = tsu.sgld_mixed_potential(th2, x, a1, a2, y, du, v, a, backend="xla")
    u2.sum().backward()
    np.testing.assert_allclose(th.grad.cpu().numpy(), th2.grad.cpu().numpy(),
                               **GRAD_TOL)
