"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test takes the ``cuda_device`` fixture, which skips when no CUDA card
is present (decided inside the fixture, never at import). The file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Pairs must be exact (the inputs are random, so near-ties are vanishingly
rare at these sizes); scores match to 1e-5 of their largest magnitude,
duplicated arms bitwise; potentials match to rtol 1e-5 and gradients to
rtol 1e-4 (fp32 with another summation order on the card); each SGLD
call, fgts and mixed mode, is one launch of one kernel and repeats
bitwise, and duplicated arms that tie across its arm tiles split the
gradient as the plain version does; each score call runs the configuration
``score_plan`` names and repeats bitwise. Attention
matches to rtol = atol = 2e-5 in fp32 (the SIMT kernel, at the encoder's
shape, across its double-buffered kv tiles with ragged S/T, and through
its 4-byte copies for unaligned views) and 2e-2 in bf16 (the Hopper
kernel; the reference's own kernel tolerances), bf16 rows with no live
key are the mean of v, and a bf16 tensor that TMA cannot load raises; the
encoder on the card matches its CPU run to atol 1e-5. The SSD scan
matches to rtol = atol = 2e-4 and the RG-LRU scan to 1e-5 (the
reference's kernel tolerances); each SSD case proves by the profiler's
kernel names which kernel ran (bf16 at P 64, N 128, chunk 128: the Hopper
kernels; the rest: the SIMT kernel), and a misaligned bf16 slice raises;
each RG-LRU case proves which kernel ran (the TMA kernel where
``rglru_scan.uses_tma`` holds, else the first one).
A reduced mamba2-1.3b and recurrentgemma-9b prefill and decode on the
card match their CPU run to 2e-4. Decoding past the end of a full-context
cache raises ``ValueError`` for an int position; a tensor position trips
the asynchronous assert, which poisons the CUDA context, so that case runs
in a subprocess.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import ARCHS
from repro_torch.encoder import model as tenc
from repro_torch.kernels import dueling_score as tds
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import sgld_update as tsu
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models import lm as tlm

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


# (37, 1) and (45, 33): K 1, and one arm past a Small tile; m not a
# multiple of the rows per block; (301, 300): K past one Large tile of 256
# arms, so the ``ties`` variant's duplicated arms (150-299 copy 0-149) tie
# across tiles; d 37 (no multiple of 4): the 4-byte copies instead of the
# bulk and 16-byte ones, in Small and Large
SGLD_SHAPES = [(37, 11, 64), (300, 130, 200), (37, 1, 64), (45, 33, 100),
               (301, 300, 64), (37, 11, 37), (70, 130, 37)]


def _sgld_ops(variant, m, k, d, seed, dev):
    rng = np.random.default_rng(seed)
    c, n = 3, 500
    on = lambda v: torch.from_numpy(np.asarray(v)).to(dev)
    x = on(rng.standard_normal((n, d)).astype(np.float32))
    a1 = rng.integers(0, k, n).astype(np.int32)
    a2 = ((a1 + rng.integers(1, max(k, 2), n)) % k).astype(np.int32)
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
    return (theta, x, on(a1), on(a2), y, pref, rows, valid, on(a_emb), mask,
            costs)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("j", [1, 2])
@pytest.mark.parametrize("m,k,d", SGLD_SHAPES)
def test_sgld_kernels_match_plain(cuda_device, j, variant, m, k, d):
    ops = _sgld_ops(variant, m, k, d, j, cuda_device)
    c = ops[0].shape[0]
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


def _misaligned(v):
    """A contiguous copy of v that starts 4 bytes past a 16-byte boundary
    (a view into a larger buffer): the kernels' 16-byte rule fails."""
    buf = torch.empty(v.numel() + 4, dtype=v.dtype, device=v.device)
    out = buf[1:1 + v.numel()].view(v.shape)
    out.copy_(v)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


def _device_kernels(fn):
    """(name, launches) of every device kernel ``fn`` runs, from
    ``torch.profiler`` (taken again, up to 3 times, if a profile records
    none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = [(e.key, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        if out:
            break
    return out


@pytest.mark.parametrize("m,k,d", [(64, 16, 768), (301, 300, 64)])
def test_sgld_fgts_is_one_deterministic_launch(cuda_device, m, k, d):
    """Each fgts entry point is one launch of one kernel, and repeated calls
    give bitwise equal results (a fixed summation order, no atomics); the
    ``ties`` data ties across arm tiles at (301, 300)."""
    ops = _sgld_ops("ties", m, k, d, 5, cuda_device)
    g = torch.rand(ops[0].shape[0], device=cuda_device) + 0.5
    kw = dict(j=1, eta=1.5, mu=0.3)
    fwd = lambda: tsu.potential_rows(*ops, **kw)
    grad = lambda: tsu.potential_grad_rows(*ops, g, **kw)
    for fn in (fwd, grad):
        first = fn()
        for _ in range(5):
            assert torch.equal(fn(), first)
        ran = _device_kernels(fn)
        assert len(ran) == 1 and ran[0][1] == 1, ran
        assert "fgts_kernel" in ran[0][0], ran


def test_sgld_duplicate_arms_split_the_gradient(cuda_device):
    """Duplicated arms across arm tiles (K 300: arms 150-299 copy 0-149)
    make the feel-good max tie on most rows; the kernel's gradient splits
    it as the plain version does."""
    ops = _sgld_ops("ties", 301, 300, 64, 9, cuda_device)
    theta, x, _, _, _, pref, rows, _, a_emb, _, costs = ops
    s = (x[rows] * theta[:, None]) @ a_emb.T / torch.sqrt(torch.clamp_min(
        (x[rows] ** 2) @ (a_emb ** 2).T, 1e-24))
    tv = s - pref[rows][..., None] * costs
    ties = (tv == tv.amax(-1, keepdim=True)).sum(-1)
    assert int((ties > 1).sum()) > 0
    g = torch.rand(theta.shape[0], device=cuda_device) + 0.5
    for j in (1, 2):
        kw = dict(j=j, eta=1.5, mu=0.3)
        np.testing.assert_allclose(
            tsu.potential_grad_rows(*ops, g, **kw).cpu().numpy(),
            tsu.potential_grad_rows(*ops, g, **kw, plain=True).cpu().numpy(),
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


@pytest.mark.parametrize("b,k,d,j,misalign", [
    (170, 1024, 768, 1, False),   # Small, at the edge of its B*K*J*d cap
    (171, 1024, 768, 1, False),   # Large, just past it
    (63, 16, 768, 16, False),     # Small at a batch of 63
    (5, 37, 100, 3, False),       # Small, ragged d, 16-byte loads
    (5, 37, 98, 3, False),        # Small, d % 4 != 0: 4-byte loads
    (5, 37, 96, 3, True),         # Small, misaligned tables: 4-byte loads
    (300, 130, 200, 2, False),    # Large, ragged tiles
])
def test_dueling_score_plans_match_plain(cuda_device, b, k, d, j, misalign):
    """Both configurations at the two sides of ``score_plan``'s bounds:
    the kernel the plan names runs (one launch), scores match the plain
    version to 1e-5 of max|s|, duplicated arms are bitwise equal, a zero
    arm and a zero query score 0, and repeated calls agree bitwise."""
    rng = np.random.default_rng(b + k + d + j)
    x = rng.standard_normal((b, d)).astype(np.float32)
    a = rng.standard_normal((k, d)).astype(np.float32)
    a[k - 1] = a[0]
    a[1] = 0.0
    x[2] = 0.0
    on = lambda v: torch.from_numpy(v).to(cuda_device)
    x, a, th = on(x), on(a), on(rng.standard_normal((j, d)).astype(
        np.float32))
    if misalign:
        x, a, th = _misaligned(x), _misaligned(a), _misaligned(th)
    cfg, _ = tds.score_plan(b, k, j, d)
    s = tds.dueling_score(x, a, th)
    torch.cuda.synchronize()
    p = tds.dueling_score_plain(x, a, th)
    assert float((s - p).abs().max()) <= 1e-5 * float(p.abs().max())
    assert torch.equal(s[..., k - 1], s[..., 0])
    assert not bool(s[..., 1].any()) and not bool(s[:, 2].any())
    for _ in range(3):
        assert torch.equal(tds.dueling_score(x, a, th), s)
    ran = _device_kernels(lambda: tds.dueling_score(x, a, th))
    assert len(ran) == 1 and ran[0][1] == 1, ran
    name = "dueling_score_small" if cfg == 0 else "dueling_score_kernel"
    assert name in ran[0][0], ran


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


def _mixed_ops(variant, c, m, k, d, seed, dev, n=500):
    """Operands of the mixed row entry points: C chains, m minibatch rows
    of a ring of n, K arms, width d."""
    rng = np.random.default_rng(seed)
    on = lambda v: torch.from_numpy(np.asarray(v)).to(dev)
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
    return (on(rng.standard_normal((c, d)).astype(np.float32)),
            on(rng.standard_normal((n, d)).astype(np.float32)), on(a1),
            on(a2), on(y), on(duel.astype(np.float32)),
            on(rng.integers(0, n, (c, m))), on(valid),
            on(rng.standard_normal((k, d)).astype(np.float32)))


@pytest.mark.parametrize("variant", MIXED)
@pytest.mark.parametrize("m,k,d", [(37, 11, 64), (300, 130, 200)])
def test_sgld_mixed_kernels_match_plain(cuda_device, variant, m, k, d):
    c = 3
    ops = _mixed_ops(variant, c, m, k, d, m + MIXED.index(variant),
                     cuda_device)
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


@pytest.mark.parametrize("c,m,k,d,misalign", [
    (3, 1, 11, 768, False),       # m 1: one block, one row
    (3, 3, 11, 768, False),       # m below the cluster size: one block
    (3, 45, 11, 768, False),      # 6 blocks of 8 rows, the last with 5
    (1, 64, 16, 768, False),      # C 1
    (2, 1024, 1024, 768, False),  # 16 groups a block through the ring
    (3, 37, 11, 100, False),      # d 100: 16-byte loads (d % 4 == 0)
    (3, 37, 11, 98, False),       # d % 4 != 0: 4-byte loads
    (3, 300, 130, 200, True),     # misaligned tables: 4-byte loads
    (2, 700, 11, 3300, False),    # groups of 4 rows (d past 3056)
])
def test_sgld_mixed_is_one_deterministic_launch(cuda_device, c, m, k, d,
                                                misalign):
    """Each mixed entry point is one launch of one cluster kernel
    (``mixed_plan``), matches the plain version and repeats bitwise on
    repeated calls, across ragged m and d, C 1, rows per block that are no
    multiple of the group and both load rules."""
    ops = list(_mixed_ops("half", c, m, k, d, m + d, cuda_device))
    if misalign:
        ops[1], ops[8] = _misaligned(ops[1]), _misaligned(ops[8])
    g = torch.rand(c, device=cuda_device) + 0.5
    fwd = lambda: tsu.mixed_potential_rows(*ops, eta=1.5)
    grad = lambda: tsu.mixed_potential_grad_rows(*ops, g, eta=1.5)
    u_p = tsu.mixed_potential_rows(*ops, eta=1.5, plain=True)
    g_p = tsu.mixed_potential_grad_rows(*ops, g, eta=1.5, plain=True)
    for fn, want, tol in ((fwd, u_p, POT_TOL), (grad, g_p, GRAD_TOL)):
        first = fn()
        torch.cuda.synchronize()
        np.testing.assert_allclose(first.cpu().numpy(), want.cpu().numpy(),
                                   **tol)
        for _ in range(3):
            assert torch.equal(fn(), first)
        ran = _device_kernels(fn)
        assert len(ran) == 1 and ran[0][1] == 1, ran
        assert "mixed_kernel" in ran[0][0], ran


ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
            torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
ATTN_CASES = [
    # b, h, kv, s, t, d, causal, window, cap: tests/test_kernels.py:23-29,
    # rows with no live key, the encoder's heads, head dims 32 and 256
    (2, 4, 2, 256, 256, 64, True, 0, 0.0),
    (1, 4, 1, 200, 200, 64, True, 64, 0.0),
    (2, 2, 2, 128, 384, 128, False, 0, 50.0),
    (1, 8, 8, 64, 64, 128, True, 0, 30.0),
    (1, 2, 1, 384, 130, 64, True, 0, 0.0),
    (1, 2, 1, 300, 100, 64, True, 4, 0.0),
    (16, 4, 4, 64, 64, 64, False, 0, 0.0),
    (1, 4, 2, 100, 70, 32, False, 16, 0.0),
    (1, 4, 2, 300, 300, 256, True, 96, 50.0),
    # ragged S and T at D 256 (the bf16 kernel's 64-key tiles), GQA at D 32
    (1, 4, 2, 300, 130, 256, True, 0, 0.0),
    (2, 4, 1, 300, 130, 256, False, 64, 30.0),
    (1, 8, 2, 300, 300, 32, True, 0, 0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(cuda_device, b, h, kv, s, t,
                                              d, causal, window, cap, dtype):
    rng = np.random.default_rng(s + t + d)
    on = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device, dtype)
    q, k, v = on(b, h, s, d), on(b, kv, t, d), on(b, kv, t, d)
    kw = dict(causal=causal, window=window, softcap=cap)
    before = tfa.flash_attention.launches
    o = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert o.dtype == dtype and o.shape == (b, h, s, d)
    p = tfa.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               p.float().cpu().numpy(), **ATTN_TOL[dtype])


def test_flash_attention_kernel_reads_strided_views(cuda_device):
    """(B,S,H,D) tensors passed as transpose(1, 2) views, as the model
    passes its projections: no copy, the output in q's layout."""
    rng = np.random.default_rng(5)
    on = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
    q, k, v = on(3, 50, 4, 64), on(3, 50, 2, 64), on(3, 50, 2, 64)
    o = tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=False)
    assert o.transpose(1, 2).is_contiguous()
    p = tfa.flash_attention_plain(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(),
                                  causal=False)
    np.testing.assert_allclose(o.cpu().numpy(), p.cpu().numpy(),
                               **ATTN_TOL[torch.float32])


def test_flash_attention_kernel_refuses_what_it_cannot_run(cuda_device):
    x = torch.zeros((1, 2, 8, 48), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(x, x, x)
    y = torch.zeros((1, 2, 8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_attention(y, y.half(), y.half())


def _kernel_names(fn, family="flash_attention_kernel"):
    """Names of the ``family`` kernels ``fn`` launches, from
    ``torch.profiler`` (taken again, up to 3 times, if a profile records no
    device kernel)."""
    from torch.profiler import ProfilerActivity, profile
    names = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages() if family in e.key]
        if names:
            break
    return names


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap", [
    (256, 4, 4, 64, 64, 64, False, 0, 0.0),    # the encoder's shape
    (2, 4, 2, 333, 517, 64, False, 0, 0.0),    # 17 kv tiles, ragged
    (1, 4, 2, 300, 461, 128, True, 100, 0.0),  # D 128: 16-key tiles
    (2, 2, 1, 97, 250, 32, False, 0, 30.0),
    (1, 2, 2, 70, 90, 256, False, 40, 0.0),
])
def test_flash_attention_fp32_crosses_the_double_buffer(
        cuda_device, b, h, kv, s, t, d, causal, window, cap):
    """fp32 on the SIMT kernel: K and V tiles double-buffered over many kv
    tiles with ragged S and T, the fp32 tolerance throughout."""
    rng = np.random.default_rng(s * t + d)
    on = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
    q, k, v = on(b, h, s, d), on(b, kv, t, d), on(b, kv, t, d)
    kw = dict(causal=causal, window=window, softcap=cap)
    names = _kernel_names(lambda: tfa.flash_attention(q, k, v, **kw))
    assert names and all("flash_attention_kernel<float" in n
                         for n in names), names
    o = tfa.flash_attention(q, k, v, **kw)
    p = tfa.flash_attention_plain(q, k, v, **kw)
    np.testing.assert_allclose(o.cpu().numpy(), p.cpu().numpy(),
                               **ATTN_TOL[torch.float32])


def test_flash_attention_fp32_reads_unaligned_views(cuda_device):
    """fp32 views one element off a 16-byte boundary (and a sequence
    stride of 67 floats) go through the kernel's 4-byte copies."""
    rng = np.random.default_rng(4)
    def off(*shape, pad=0):
        n = int(np.prod(shape[:-1])) * (shape[-1] + pad)
        buf = torch.from_numpy(rng.standard_normal(
            n + 1, dtype=np.float32)).to(cuda_device)
        return buf[1:].view(*shape[:-1], shape[-1] + pad)[..., :shape[-1]]
    q, k, v = off(2, 4, 90, 64, pad=3), off(2, 2, 150, 64), off(2, 2, 150, 64)
    assert q.data_ptr() % 16 and q.stride(2) == 67
    o = tfa.flash_attention(q, k, v, causal=False, window=30)
    p = tfa.flash_attention_plain(q, k, v, causal=False, window=30)
    np.testing.assert_allclose(o.cpu().numpy(), p.cpu().numpy(),
                               **ATTN_TOL[torch.float32])


def test_flash_attention_dispatches_by_dtype(cuda_device):
    """fp32 launches the SIMT kernel and still matches the plain version to
    2e-5; bf16 launches the Hopper kernel. One launch count each."""
    rng = np.random.default_rng(11)
    on = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
    q, k, v = on(2, 4, 200, 128), on(2, 2, 200, 128), on(2, 2, 200, 128)
    for dtype, kernel in ((torch.float32, "flash_attention_kernel<float"),
                          (torch.bfloat16, "flash_attention_kernel_sm90")):
        x = [t.to(dtype) for t in (q, k, v)]
        before = tfa.flash_attention.launches
        names = _kernel_names(lambda: tfa.flash_attention(*x, window=50))
        assert tfa.flash_attention.launches == before + 1
        assert names and all(kernel in n for n in names), names
    o = tfa.flash_attention(q, k, v, window=50)
    p = tfa.flash_attention_plain(q, k, v, window=50)
    np.testing.assert_allclose(o.cpu().numpy(), p.cpu().numpy(),
                               **ATTN_TOL[torch.float32])


@pytest.mark.parametrize("d,window,cap", [(64, 0, 0.0), (128, 0, 0.0),
                                          (256, 40, 0.0), (256, 0, 50.0)])
def test_flash_attention_bf16_kernel_reads_strided_views(cuda_device, d,
                                                         window, cap):
    """bf16 (B,S,H,D) tensors passed as transpose(1, 2) views, as the model
    passes its projections: TMA reads them in place (4-D tensor maps over
    (D, S, H, B)), the output takes q's layout."""
    rng = np.random.default_rng(d + window)
    on = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = on(2, 150, 8, d), on(2, 150, 2, d), on(2, 150, 2, d)
    kw = dict(causal=True, window=window, softcap=cap)
    o = tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), **kw)
    assert o.transpose(1, 2).is_contiguous()
    p = tfa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), **kw)
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               p.float().cpu().numpy(),
                               **ATTN_TOL[torch.bfloat16])


@pytest.mark.parametrize("d", [64, 256])
def test_flash_attention_bf16_rows_without_live_key_are_mean_of_v(
        cuda_device, d):
    """S 300, T 100, causal, window 4: rows i >= 103 have no live key (two
    whole 128-row q tiles among them); they are the mean of v over the T
    keys of their kv head."""
    rng = np.random.default_rng(d)
    on = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = on(1, 4, 300, d), on(1, 2, 100, d), on(1, 2, 100, d)
    o = tfa.flash_attention(q, k, v, causal=True, window=4).float()
    live = 100 + 4 - 1
    mean_v = v[0].float().mean(dim=1).repeat_interleave(2, dim=0)  # (H, D)
    np.testing.assert_allclose(
        o[0, :, live:].cpu().numpy(),
        mean_v[:, None].expand(4, 300 - live, d).cpu().numpy(),
        **ATTN_TOL[torch.bfloat16])
    p = tfa.flash_attention_plain(q, k, v, causal=True, window=4)
    np.testing.assert_allclose(o.cpu().numpy(), p.float().cpu().numpy(),
                               **ATTN_TOL[torch.bfloat16])


def test_flash_attention_bf16_refuses_misaligned_tensors(cuda_device):
    """TMA needs 16-byte aligned addresses and strides: a view whose base is
    one element off, or whose sequence stride is not a multiple of 8
    elements, raises ValueError and launches nothing."""
    buf = torch.zeros(2 * 4 * 64 * 64 + 1, device=cuda_device,
                      dtype=torch.bfloat16)
    off = buf[1:].view(2, 4, 64, 64)
    ok = torch.zeros((2, 4, 64, 64), device=cuda_device, dtype=torch.bfloat16)
    padded = torch.zeros((2, 4, 64, 68), device=cuda_device,
                         dtype=torch.bfloat16)[..., :64]
    before = tfa.flash_attention.launches
    for q, k, v in ((off, ok, ok), (ok, off, ok), (ok, ok, off),
                    (padded, ok, ok)):
        with pytest.raises(ValueError, match="16-byte"):
            tfa.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == before
    # the same values, aligned, run
    o = tfa.flash_attention(off.clone(), ok, ok)
    assert tfa.flash_attention.launches == before + 1
    assert bool(torch.isfinite(o.float()).all())


@pytest.mark.parametrize("name,mode", [("recurrentgemma-9b", "local"),
                                       ("qwen2-7b", "causal"),
                                       ("gemma2-9b", "local")])
def test_model_attention_passes_the_tma_rule(cuda_device, monkeypatch, name,
                                             mode):
    """``models.attention.self_attention_kv`` at the model's full widths in
    bf16 hands the flash wrapper q, k and v that meet the bf16 kernel's
    alignment rule, and the kernel matches the plain version there."""
    from repro_torch.models import attention as tattn
    cfg = ARCHS[name]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = tattn.init_attn(gen, cfg, torch.bfloat16, cuda_device)
    x = torch.randn((2, 260, cfg.d_model), generator=gen,
                    device=cuda_device).bfloat16()
    pos = torch.arange(260, device=cuda_device)[None].expand(2, 260)
    seen = []

    def spy(q, k, v, **kw):
        for t in (q, k, v):
            assert t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0
            assert all(st * 2 % 16 == 0 for st in t.stride()[:3]), t.stride()
        o = tfa.flash_attention(q, k, v, **kw)
        p = tfa.flash_attention_plain(q, k, v, **kw)
        seen.append(float((o.float() - p.float()).abs().max()))
        np.testing.assert_allclose(o.float().cpu().numpy(),
                                   p.float().cpu().numpy(),
                                   **ATTN_TOL[torch.bfloat16])
        return o

    monkeypatch.setattr(tattn, "flash_attention", spy)
    before = tfa.flash_attention.launches
    out, _, _ = tattn.self_attention_kv(params, x, pos, cfg, mode=mode,
                                        window=cfg.window)
    assert tfa.flash_attention.launches == before + 1 and len(seen) == 1
    assert out.shape == x.shape and bool(torch.isfinite(out.float()).all())


def test_encode_on_the_card_matches_the_cpu(cuda_device):
    """``EncoderConfig()`` from one CPU generator, 8 queries with padded
    tails: one attention launch per layer, embeddings to atol 1e-5."""
    cfg = tenc.EncoderConfig()
    params = tenc.init_encoder(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    rng = np.random.default_rng(6)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 64)))
    mask = torch.ones((8, 64))
    mask[3, 40:] = 0.0
    want = tenc.encode(params, tok, mask, cfg)
    card = tenc.tree_map(lambda w: w.to(cuda_device), params)
    before = tfa.flash_attention.launches
    got = tenc.encode(card, tok.to(cuda_device), mask.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5,
                               rtol=0)


SSD_TOL = dict(rtol=2e-4, atol=2e-4)
RG_TOL = dict(rtol=1e-5, atol=1e-5)


def _ssd_inputs(b, s, h, p, n, with_h0, dev, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev)
    dt = torch.nn.functional.softplus(f(b, s, h))
    return dict(x=f(b, s, h, p), bt=f(b, s, n), ct=f(b, s, n),
                log_a=-0.1 * dt, dt=dt, h0=f(b, h, p, n) if with_h0 else None)


def _ssd_kernels_ran(fn, sm90):
    """``fn``'s SSD kernels by their profiler names: the two Hopper kernels
    when ``sm90``, else the SIMT kernel alone."""
    names = _kernel_names(fn, family="ssd_kernel")
    assert names, "no ssd kernel in the profile"
    if sm90:
        assert len(names) == 2, names
        for kernel in ("ssd_kernel_cb_sm90(", "ssd_kernel_sm90("):
            assert any(kernel in n for n in names), names
    else:
        assert all("sm90" not in n for n in names), names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", [
    (2, 200, 4, 64, 32, 64, True),
    (1, 256, 2, 32, 64, 128, False),
    (2, 96, 8, 64, 128, 32, True),
    (2, 300, 3, 64, 128, 128, True),    # ragged tail, mamba2's P, N, L
    (1, 50, 2, 48, 16, 128, False),     # S < chunk, P not a tile multiple
    (2, 1, 2, 32, 8, 32, True),         # S = 1
    (1, 100, 2, 64, 128, 128, False),   # S < chunk at mamba2's P, N, L
    (2, 1, 3, 64, 128, 128, True),      # S = 1 at mamba2's P, N, L
    (1, 640, 2, 64, 128, 128, True),    # 5 chunks: the ring turns twice
])
def test_ssd_scan_kernel_matches_plain(cuda_device, b, s, h, p, n, chunk,
                                       with_h0, dtype):
    inp = _ssd_inputs(b, s, h, p, n, with_h0, cuda_device, s + p + n)
    for k in ("x", "bt", "ct"):
        inp[k] = inp[k].to(dtype)
    _ssd_kernels_ran(lambda: tss.ssd_scan(**inp, chunk=chunk),
                     tss.uses_sm90(dtype, p, n, chunk))
    before = tss.ssd_scan.launches
    y, hl = tss.ssd_scan(**inp, chunk=chunk)
    torch.cuda.synchronize()
    assert tss.ssd_scan.launches == before + 1
    assert y.dtype == hl.dtype == torch.float32
    py, phl = tss.ssd_scan_plain(**inp, chunk=chunk)
    np.testing.assert_allclose(y.cpu().numpy(), py.cpu().numpy(), **SSD_TOL)
    np.testing.assert_allclose(hl.cpu().numpy(), phl.cpu().numpy(),
                               **SSD_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk,dtype", [
    (2, 140, 4, 32, 64, 32, torch.float32),
    (2, 140, 4, 32, 64, 32, torch.bfloat16),
    (2, 300, 4, 64, 128, 128, torch.bfloat16),   # mamba2's slices
    (1, 130, 2, 64, 128, 128, torch.bfloat16),   # B 1: size-1 batch axis
])
def test_ssd_scan_kernel_reads_strided_column_slices(cuda_device, b, s, h,
                                                     p, n, chunk, dtype):
    """x, B and C as column slices of one (B,S,di+2n) tensor, as the
    model hands them over: read through their strides (through TMA's
    tensor maps for the Hopper kernels)."""
    rng = np.random.default_rng(7)
    di = h * p
    xbc = torch.from_numpy(rng.standard_normal(
        (b, s, di + 2 * n), dtype=np.float32)).to(cuda_device, dtype)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, h), dtype=np.float32)).to(cuda_device))
    x = xbc[..., :di].reshape(b, s, h, p)
    bt, ct = xbc[..., di:di + n], xbc[..., di + n:]
    assert not bt.is_contiguous()
    _ssd_kernels_ran(lambda: tss.ssd_scan(x, bt, ct, -0.1 * dt, dt,
                                          chunk=chunk),
                     tss.uses_sm90(dtype, p, n, chunk))
    y, hl = tss.ssd_scan(x, bt, ct, -0.1 * dt, dt, chunk=chunk)
    py, phl = tss.ssd_scan_plain(x.contiguous(), bt.contiguous(),
                                 ct.contiguous(), -0.1 * dt, dt, chunk=chunk)
    np.testing.assert_allclose(y.cpu().numpy(), py.cpu().numpy(), **SSD_TOL)
    np.testing.assert_allclose(hl.cpu().numpy(), phl.cpu().numpy(),
                               **SSD_TOL)


def test_ssd_scan_bf16_refuses_misaligned_slices(cuda_device):
    """The Hopper kernels load x, B and C through TMA: a bf16 slice at an
    address off a 16-byte boundary, or with a sequence stride that is not a
    multiple of 8 elements, raises ValueError and launches nothing."""
    b, s, h, p, n = 1, 64, 2, 64, 128
    width = h * p + 2 * n
    rng = np.random.default_rng(9)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, h), dtype=np.float32)).to(cuda_device))
    xbc = torch.zeros((b, s, width + 4), device=cuda_device,
                      dtype=torch.bfloat16)
    shifted = xbc[..., 1:1 + width]            # every base 2 bytes off
    padded = xbc[..., :width]                  # row stride width + 4
    before = tss.ssd_scan.launches
    for t in (shifted, padded):
        x = t[..., :h * p].unflatten(-1, (h, p))
        with pytest.raises(ValueError, match="16-byte"):
            tss.ssd_scan(x, t[..., h * p:h * p + n], t[..., h * p + n:],
                         -0.1 * dt, dt)
    assert tss.ssd_scan.launches == before


# ragged S against the ring's 32-step tiles (200, 65, 77, 33, 40), D 96
# (three 32-channel tiles), S 1 with h0, B 1, D 4100 (a ragged channel
# tile); D 98 is no multiple of 4, so it runs the first kernel
@pytest.mark.parametrize("b,s,d,with_h0", [
    (2, 200, 512, True), (1, 128, 512, False), (3, 65, 1024, True),
    (2, 77, 96, False), (2, 1, 96, True), (1, 40, 4100, True),
    (1, 33, 96, True), (2, 50, 98, True),
])
def test_rglru_scan_kernel_matches_plain(cuda_device, b, s, d, with_h0):
    rng = np.random.default_rng(s + d)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
    log_a, x = -f(b, s, d).abs() * 0.1, f(b, s, d)
    h0 = f(b, d) if with_h0 else None
    before = trg.rglru_scan.launches
    h, hl = trg.rglru_scan(log_a, x, h0)
    torch.cuda.synchronize()
    assert trg.rglru_scan.launches == before + 1
    ph, phl = trg.rglru_scan_plain(log_a, x, h0)
    np.testing.assert_allclose(h.cpu().numpy(), ph.cpu().numpy(), **RG_TOL)
    np.testing.assert_allclose(hl.cpu().numpy(), phl.cpu().numpy(),
                               **RG_TOL)
    names = _kernel_names(lambda: trg.rglru_scan(log_a, x, h0),
                          family="rglru_kernel")
    assert len(names) == 1, names
    assert ("rglru_kernel_sm90" in names[0]) == (d % 4 == 0), names


def test_rglru_scan_misaligned_view_takes_the_first_kernel(cuda_device):
    """A view 4 bytes off a 16-byte boundary breaks TMA's rule: the wrapper
    runs the first kernel, and both agree with the plain version."""
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.standard_normal(
        (2 * 64 * 128 + 1,), dtype=np.float32)).to(cuda_device)
    x = buf[1:].view(2, 64, 128)
    log_a = -0.1 * x.abs()
    assert not trg.uses_tma(log_a, x)
    assert trg.uses_tma(log_a, log_a)
    names = _kernel_names(lambda: trg.rglru_scan(log_a, x),
                          family="rglru_kernel")
    assert len(names) == 1 and "sm90" not in names[0], names
    h, hl = trg.rglru_scan(log_a, x)
    ph, phl = trg.rglru_scan_plain(log_a, x)
    np.testing.assert_allclose(h.cpu().numpy(), ph.cpu().numpy(), **RG_TOL)
    np.testing.assert_allclose(hl.cpu().numpy(), phl.cpu().numpy(),
                               **RG_TOL)


def test_scan_kernels_refuse_what_they_cannot_run(cuda_device):
    inp = _ssd_inputs(1, 40, 2, 32, 16, False, cuda_device, 0)
    with pytest.raises(ValueError, match="chunk"):
        tss.ssd_scan(**inp, chunk=40)
    with pytest.raises(ValueError, match="N"):
        big = _ssd_inputs(1, 40, 2, 32, 160, False, cuda_device, 0)
        tss.ssd_scan(**big, chunk=32)
    with pytest.raises(ValueError, match="float32"):
        tss.ssd_scan(**dict(inp, dt=inp["dt"].double()), chunk=32)
    with pytest.raises(ValueError, match="dtypes"):
        tss.ssd_scan(**dict(inp, bt=inp["bt"].half()), chunk=32)
    x = torch.zeros((1, 4, 8), device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        trg.rglru_scan(x.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError, match="h0"):
        trg.rglru_scan(x, x, torch.zeros((1, 9), device=cuda_device))


@pytest.mark.parametrize("name", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_lm_prefill_and_decode_on_the_card_match_the_cpu(cuda_device,
                                                         name):
    """A reduced fp32 model from one CPU generator: prefill of 200 tokens
    (past the reduced window) and 2 greedy decode steps, logits and every
    cache leaf to 2e-4; one scan launch per recurrent layer, attention
    once per local layer, none from decode."""
    cfg = ARCHS[name].reduced(max_units=2)
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    card = tenc.tree_map(lambda w: w.to(cuda_device), params)
    tok = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 200)))
    runs = {}
    for where, p in ((torch.device("cpu"), params), (cuda_device, card)):
        kernels.reset_launch_counts()
        last, cache = tlm.prefill(p, {"tokens": tok.to(where)}, cfg,
                                  cache_len=210)
        counts = kernels.launch_counts()
        logits = [last]
        nxt = last.argmax(-1).cpu()
        for step in range(2):
            lg, cache = tlm.decode_step(p, cache, nxt.to(where), 200 + step,
                                        cfg)
            logits.append(lg)
            nxt = lg.argmax(-1).cpu()
        assert kernels.launch_counts() == counts
        runs[where.type] = (logits, cache, counts)
    torch.cuda.synchronize()
    specs = cfg.all_specs()
    counts = runs["cuda"][2]
    assert counts["ssd_scan"] == sum(s.mixer == "ssd" for s in specs)
    assert counts["rglru_scan"] == sum(s.mixer == "rglru" for s in specs)
    assert counts["flash_attention"] == sum(s.mixer == "lattn"
                                            for s in specs)
    assert all(n == 0 for n in runs["cpu"][2].values())
    for g, c in zip(runs["cuda"][0], runs["cpu"][0]):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=2e-4,
                                   atol=2e-4)
    flat_g, flat_c = [], []
    tenc.tree_map(flat_g.append, runs["cuda"][1])
    tenc.tree_map(flat_c.append, runs["cpu"][1])
    for g, c in zip(flat_g, flat_c):
        if c.dtype == torch.int32:
            assert torch.equal(g.cpu(), c)
        else:
            np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=2e-4,
                                       atol=2e-4)


def _decode_setup(dev):
    from repro_torch.models import attention as tattn
    cfg = ARCHS["qwen2-7b"].reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tattn.init_attn(gen, cfg, torch.float32, dev)
    x = torch.randn((2, 1, cfg.d_model), generator=gen, device=dev)
    cache = tattn.init_kv_cache(2, 4, cfg, torch.float32, dev)
    return tattn, cfg, params, x, cache


def test_decode_past_a_full_cache_raises_on_the_card(cuda_device):
    """cache_len 4: positions 0-3 decode on the card; the int position 4
    raises ValueError before anything is written."""
    tattn, cfg, params, x, cache = _decode_setup(cuda_device)
    for i in range(4):
        out, cache = tattn.decode_attention(params, x, cache, i, cfg,
                                            mode="causal")
    before = {k: v.clone() for k, v in cache.items()}
    with pytest.raises(ValueError, match="past the end"):
        tattn.decode_attention(params, x, cache, 4, cfg, mode="causal")
    torch.cuda.synchronize()
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    assert bool(torch.isfinite(out).all())


def test_decode_past_a_full_cache_trips_the_device_assert(cuda_device):
    """A tensor position on the card is checked without a host sync
    (``torch._assert_async``): position 4 of a 4-slot cache trips a
    device-side assert, which poisons the CUDA context, so the decode runs
    in a subprocess that must fail with it; position 3 runs clean."""
    import os
    import subprocess
    import sys
    script = (
        "import sys, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_cuda import _decode_setup\n"
        "dev = torch.device('cuda')\n"
        "tattn, cfg, params, x, cache = _decode_setup(dev)\n"
        "pos = torch.tensor(int(sys.argv[1]), device=dev)\n"
        "tattn.decode_attention(params, x, cache, pos, cfg, mode='causal')\n"
        "torch.cuda.synchronize()\n"
        "print('clean')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    run = lambda pos: subprocess.run(
        [sys.executable, "-c", script, str(pos)], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    ok = run(3)
    assert ok.returncode == 0 and "clean" in ok.stdout, ok.stderr[-2000:]
    bad = run(4)
    assert bad.returncode != 0 and "clean" not in bad.stdout
    assert "device-side assert" in bad.stderr or "past the end" in \
        bad.stderr, bad.stderr[-2000:]
