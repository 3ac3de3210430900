"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test takes the ``cuda_device`` fixture, which skips when no CUDA card
is present (decided inside the fixture, never at import). The file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Pairs must be exact (the inputs are random, so near-ties are vanishingly
rare at these sizes); scores match to 1e-5 of their largest magnitude,
duplicated arms bitwise; potentials match to rtol 1e-5 and gradients to
rtol 1e-4 (fp32 with another summation order on the card). Attention
matches to rtol = atol = 2e-5 in fp32 and 2e-2 in bf16 (the reference's
own kernel tolerances); the encoder on the card matches its CPU run to
atol 1e-5. The SSD scan matches to rtol = atol = 2e-4 and the RG-LRU scan
to 1e-5 (the reference's kernel tolerances); a reduced mamba2-1.3b and
recurrentgemma-9b prefill and decode on the card match their CPU run to
2e-4.
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", [
    (2, 200, 4, 64, 32, 64, True),
    (1, 256, 2, 32, 64, 128, False),
    (2, 96, 8, 64, 128, 32, True),
    (2, 300, 3, 64, 128, 128, True),    # ragged tail, mamba2's P, N, L
    (1, 50, 2, 48, 16, 128, False),     # S < chunk, P not a tile multiple
    (2, 1, 2, 32, 8, 32, True),         # S = 1
])
def test_ssd_scan_kernel_matches_plain(cuda_device, b, s, h, p, n, chunk,
                                       with_h0, dtype):
    inp = _ssd_inputs(b, s, h, p, n, with_h0, cuda_device, s + p + n)
    for k in ("x", "bt", "ct"):
        inp[k] = inp[k].to(dtype)
    before = tss.ssd_scan.launches
    y, hl = tss.ssd_scan(**inp, chunk=chunk)
    torch.cuda.synchronize()
    assert tss.ssd_scan.launches == before + 1
    assert y.dtype == hl.dtype == torch.float32
    py, phl = tss.ssd_scan_plain(**inp, chunk=chunk)
    np.testing.assert_allclose(y.cpu().numpy(), py.cpu().numpy(), **SSD_TOL)
    np.testing.assert_allclose(hl.cpu().numpy(), phl.cpu().numpy(),
                               **SSD_TOL)


def test_ssd_scan_kernel_reads_strided_column_slices(cuda_device):
    """x, B and C as column slices of one (B,S,di+2n) tensor, as the
    model hands them over: read through their strides."""
    rng = np.random.default_rng(7)
    b, s, h, p, n = 2, 140, 4, 32, 64
    di = h * p
    xbc = torch.from_numpy(rng.standard_normal(
        (b, s, di + 2 * n), dtype=np.float32)).to(cuda_device)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, h), dtype=np.float32)).to(cuda_device))
    x = xbc[..., :di].reshape(b, s, h, p)
    bt, ct = xbc[..., di:di + n], xbc[..., di + n:]
    assert not bt.is_contiguous()
    y, hl = tss.ssd_scan(x, bt, ct, -0.1 * dt, dt, chunk=32)
    py, phl = tss.ssd_scan_plain(x.contiguous(), bt.contiguous(),
                                 ct.contiguous(), -0.1 * dt, dt, chunk=32)
    np.testing.assert_allclose(y.cpu().numpy(), py.cpu().numpy(), **SSD_TOL)
    np.testing.assert_allclose(hl.cpu().numpy(), phl.cpu().numpy(),
                               **SSD_TOL)


@pytest.mark.parametrize("b,s,d,with_h0", [
    (2, 200, 512, True), (1, 128, 512, False), (3, 65, 1024, True),
    (2, 77, 96, False), (2, 1, 96, True), (1, 40, 4100, True),
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
