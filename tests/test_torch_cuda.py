"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test takes the ``cuda_device`` fixture, which skips when no CUDA card
is present (decided inside the fixture, never at import) and otherwise
builds every kernel library before the test runs. The file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Pairs must be exact (the inputs are random, so near-ties are vanishingly
rare at these sizes); scores match to 1e-5 of their largest magnitude,
duplicated arms bitwise; potentials match to rtol 1e-5 and gradients to
rtol 1e-4 (fp32 with another summation order on the card); each SGLD
call, fgts and mixed mode, is one launch of one kernel and repeats
bitwise, and duplicated arms that tie across its arm tiles split the
gradient as the plain version does; each score call runs the configuration
``score_plan`` names and repeats bitwise; each select call, in either
configuration forced, is one launch of that configuration's kernel,
repeats bitwise and routes duplicated arms to the first copy. Attention
matches to rtol = atol = 2e-5 in fp32 (the SIMT kernel, at the encoder's
shape, across its double-buffered kv tiles with ragged S/T, and through
its 4-byte copies for unaligned views) and 2e-2 in bf16 (the Hopper
kernel; the reference's own kernel tolerances), bf16 rows with no live
key are the mean of v, and a bf16 tensor that TMA cannot load raises; the
encoder on the card matches its CPU run to atol 1e-5. fp32 attention takes
head dims 8 to 30 on the kernel built for 32. The backward kernels match
``flash_attention_bwd_plain`` to 1e-4 of each gradient's largest
magnitude under each ``bwd_plan`` configuration forced (Small raises
``ValueError`` past its key tile), count one launch per call, repeat
bitwise and run the plan's kernels by profiler name (Small one); the bf16
backward (the Hopper design, ``bwd_q_kernel_sm90`` then
``bwd_kv_kernel_sm90``, at head dims 64, 128 and 256; the SIMT kernels
built for bf16 at 32, and wherever a SIMT configuration is forced)
matches it to 2e-2 of each gradient's largest magnitude at each bf16 head
dim, repeats bitwise and runs the plan's kernels by profiler name, the
bf16 forward's lse matches the plain version's, and bf16 autograd goes
through both kernels; the encoder's gradients on the card match the CPU's
to 1e-4 of each leaf's largest magnitude. The RG-LRU gradient (its
backward kernels: the TMA ring read in reverse where ``uses_tma`` holds,
else the first design, each by profiler name) matches autograd of the
plain recurrence and ``rglru_scan_bwd_plain`` to 1e-5, with the same
non-finite values at a log_a = 0 channel, and repeats bitwise. The SSD
backward (``ssd_scan_bwd``: three kernels by profiler name) matches
``ssd_scan_bwd_plain`` to 1e-4 of each gradient's max (bf16-rounded
gradients to 1e-2) at decays drawn as mamba2-1.3b draws them, finite
where the reference's overflow, and repeats bitwise; a grad-requiring
``ssd_scan`` input runs one forward and one backward launch (two forward
under ``torch.utils.checkpoint``), and ``models/ssd.py::ssd_fwd``'s
gradient on the card matches the CPU's. Two training steps of reduced
granite-3-2b, recurrentgemma-9b and mamba2-1.3b on the card match the
CPU's. The SSD scan
matches to rtol = atol = 2e-4 and the RG-LRU scan to 1e-5 (the
reference's kernel tolerances); each SSD case proves by the profiler's
kernel names which kernel ran (bf16 at P 64, N 128, chunk 128: the Hopper
kernels; the rest: the SIMT kernel), and a misaligned bf16 slice raises;
each RG-LRU case proves which kernel ran (the TMA kernel where
``rglru_scan.uses_tma`` holds, else the first one).
A reduced mamba2-1.3b and recurrentgemma-9b prefill and decode on the
card match their CPU run to 2e-4, and so do the four architectures of the
MoE, cross-attention and vision paths, with one attention launch per
attention layer (seamless: encoder, self and cross) and none from decode.
The MoE FFN (sparse and dense) matches its CPU run to 1e-4 of the output's
largest magnitude with the same experts and the same dropped assignments,
and runs with no host sync; bf16 attention with S != T and no mask (cross
attention) matches the plain version, and the cross projections at
seamless's widths meet the TMA rule. Decoding past the end of a full-context
cache raises ``ValueError`` for an int position; a tensor position trips
the asynchronous assert, which poisons the CUDA context, so that case runs
in a subprocess. A streaming service's CUDA graphs (one per bucket and
program) route bitwise as a tick-batch twin's eager ``route_batch``
(with refresh: the duel logs alike, propensities to rtol 1e-6), padded
buckets route bitwise as tight ones for FGTS and eps-greedy, control-plane
calls capture nothing anew, and ``route_stream`` / ``feedback_stream``
replay with no host sync.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import ARCHS
from repro_torch.kernels import _build
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
    # every library built (nvcc in subprocesses) before the first test, so
    # no build runs between profiler sessions: on a fresh machine, builds
    # after the first session left the profiler seeing no device activity
    # for the rest of the process
    _build.build_all()
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


def _force_select(monkeypatch, cfg):
    """Make ``dueling_select`` launch configuration ``cfg`` (0 Small, 1
    Large) whatever ``select_plan`` would pick."""
    plan = tds.select_plan
    monkeypatch.setattr(tds, "select_plan",
                        lambda b, k, d: plan(b, k, d, cfg=cfg))


# b, k, d, mask, layout: K 1; K 33 (Large only) and K 32 at d 98 (4-byte
# loads); a row-slice view off a 16-byte boundary (d 98) and tables one
# element off it (d 96); the routing shape; 8-row Small blocks (B 1024)
SELECT_EDGES = [(64, 1, 768, "bk", None), (70, 33, 98, "bk", None),
                (130, 32, 98, "bk", None), (130, 11, 98, "k", "row_slice"),
                (130, 11, 96, "bk", "misaligned"), (256, 16, 768, "k", None),
                (1024, 16, 768, "bk", None)]


@pytest.mark.parametrize("cfg,b,k,d,mask_kind,layout", [
    (cfg, *edge) for cfg in (0, 1) for edge in SELECT_EDGES
    if cfg == 1 or edge[1] <= 32])
def test_dueling_select_configurations_match_plain(
        cuda_device, monkeypatch, cfg, b, k, d, mask_kind, layout):
    """Both configurations forced at the edge shapes: pairs equal to the
    plain version's, a (B,K) mask's all-inactive row routes (0, 0) and its
    single survivor duels itself, each call counts one launch, and
    repeated calls agree bitwise."""
    x, a, th, mask, tilt = _select_inputs(b, k, d, mask_kind, "bk", b + k,
                                          cuda_device)
    if mask_kind == "bk":
        mask[0] = False
        mask[1] = False
        mask[1, k - 1] = True
    if layout == "row_slice":
        base = torch.randn((b + 1, d), device=cuda_device)
        base[1:] = x
        x = base[1:]
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    elif layout == "misaligned":
        x, a, th = _misaligned(x), _misaligned(a), _misaligned(th)
    _force_select(monkeypatch, cfg)
    assert tds.select_plan(b, k, d)[0] == cfg
    kw = dict(tilt=tilt, mask=mask, distinct=True)
    before = tds.dueling_select.launches
    a1, a2 = tds.dueling_select(x, a, th, **kw)
    torch.cuda.synchronize()
    assert tds.dueling_select.launches == before + 1
    p1, p2 = tds.dueling_select_plain(x, a, th, **kw)
    assert a1.tolist() == p1.tolist() and a2.tolist() == p2.tolist()
    if mask_kind == "bk":
        assert (a1[0].item(), a2[0].item()) == (0, 0)
        assert (a1[1].item(), a2[1].item()) == (k - 1, k - 1)
    for _ in range(3):
        r1, r2 = tds.dueling_select(x, a, th, **kw)
        assert torch.equal(r1, a1) and torch.equal(r2, a2)


@pytest.mark.parametrize("cfg", [0, 1])
def test_dueling_select_is_one_kernel(cuda_device, monkeypatch, cfg):
    """At the routing shape, a call of either configuration runs exactly
    one device kernel, once: the configuration's own."""
    x, a, th, mask, tilt = _select_inputs(256, 16, 768, "k", "bk", 5,
                                          cuda_device)
    _force_select(monkeypatch, cfg)
    ran = _device_kernels(lambda: tds.dueling_select(
        x, a, th, tilt=tilt, mask=mask, distinct=True))
    assert len(ran) == 1 and ran[0][1] == 1, ran
    assert ("select_small" if cfg == 0 else "select_large") in ran[0][0], ran


@pytest.mark.parametrize("cfg,b,k,d", [(0, 256, 16, 768), (1, 256, 16, 768),
                                       (1, 70, 300, 64), (0, 130, 11, 98)])
def test_dueling_select_duplicate_arms_take_the_first(cuda_device,
                                                      monkeypatch, cfg, b, k,
                                                      d):
    """Arms n.. copy arms 0.. (across arm groups, and across tiles and
    cluster ranks at K 300): they score bitwise equal, so every pair goes
    to the first copies, the plain version's pair up to its copy."""
    x, a, th, _, _ = _select_inputs(b, k, d, "none", "none", k, cuda_device)
    n = k - k // 2
    a[n:] = a[:k // 2]
    _force_select(monkeypatch, cfg)
    a1, a2 = tds.dueling_select(x, a, th)
    p1, p2 = tds.dueling_select_plain(x, a, th)
    first = lambda v: torch.where(v >= n, v - n, v)
    assert int(a1.max()) < n and int(a2.max()) < n
    assert torch.equal(a1, first(p1)) and torch.equal(a2, first(p2))
    for _ in range(3):
        r1, r2 = tds.dueling_select(x, a, th)
        assert torch.equal(r1, a1) and torch.equal(r2, a2)


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


def _profiled_events(fn):
    """The device events of one run of ``fn`` under ``torch.profiler``, in
    a whole window (``repro_torch.profiling.whole_profile``: padded at
    both ends by a marker kernel, drained, followed by an empty session,
    taken again while it records no kernel or not its closing marker),
    the markers left out."""
    from repro_torch import profiling
    return profiling.device_events(profiling.whole_profile(fn))


def _device_kernels(fn):
    """(name, launches) of every device kernel ``fn`` runs, from
    ``torch.profiler`` (``_profiled_events``)."""
    return [(e.key, e.count) for e in _profiled_events(fn)]


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
    """Head dims past 256 (any dtype) and bf16 head dims outside the four
    built ones raise; fp32 takes every head dim up to 256."""
    x = torch.zeros((1, 2, 8, 264), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(x, x, x)
    x = torch.zeros((1, 2, 8, 48), device=cuda_device,
                    dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(x, x, x)
    y = torch.zeros((1, 2, 8, 64), device=cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_attention(y, y.half(), y.half())


def _kernel_names(fn, family="flash_attention_kernel"):
    """Names of the ``family`` kernels ``fn`` launches, from
    ``torch.profiler`` (``_profiled_events``)."""
    return [e.key for e in _profiled_events(fn) if family in e.key]


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


@pytest.mark.parametrize("d,causal,window", [(8, False, 0), (16, False, 0),
                                             (24, False, 0), (24, True, 16),
                                             (30, False, 9)])
def test_flash_attention_fp32_small_head_dims(cuda_device, d, causal,
                                              window):
    """Head dims below 32 run on the kernel built for 32 (columns past D
    loaded as zeros, never stored): the minilm encoder's shape (B 64, H 4,
    S = T = 32) and ragged S/T with a window; D 30 through the 4-byte
    copies. fp32 to 2e-5, one launch."""
    rng = np.random.default_rng(d + window)
    on = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
    b, s, t = (64, 32, 32) if not window else (2, 45, 77)
    q, k, v = on(b, 4, s, d), on(b, 4, t, d), on(b, 4, t, d)
    before = tfa.flash_attention.launches
    o = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    assert o.shape == (b, 4, s, d)
    p = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(o.cpu().numpy(), p.cpu().numpy(),
                               **ATTN_TOL[torch.float32])


BWD_CASES = [
    # b, h, kv, s, t, d, causal, window, cap, strided
    (64, 4, 4, 64, 64, 64, False, 0, 0.0, False),    # the training step
    (1, 4, 2, 300, 130, 256, True, 64, 30.0, False),  # rows with no live key
    (64, 4, 4, 32, 32, 24, False, 0, 0.0, False),    # minilm's head dim
    (64, 4, 4, 32, 32, 16, False, 0, 0.0, False),
    (64, 4, 4, 32, 32, 8, False, 0, 0.0, False),
    (2, 4, 2, 45, 77, 30, False, 9, 0.0, False),      # 4-byte copies
    (1, 8, 2, 200, 333, 128, False, 0, 0.0, False),   # GQA, ragged S/T
    (2, 8, 2, 150, 150, 64, True, 40, 0.0, True),     # strided views
    (1, 28, 4, 512, 512, 128, True, 0, 0.0, False),   # qwen2-7b's heads
    (64, 4, 4, 32, 32, 32, False, 0, 0.0, False),    # the e5b encoder
    (8, 8, 2, 64, 64, 64, True, 16, 30.0, False),    # GQA, window, cap
    (1, 4, 1, 100, 40, 32, True, 8, 0.0, False),      # dead rows, 2 tiles
    (2, 4, 2, 70, 64, 128, False, 0, 0.0, True),      # Small's last T
    (2, 4, 2, 70, 65, 128, False, 0, 0.0, True),      # the first past it
    (2, 4, 4, 40, 32, 256, True, 0, 20.0, False),     # Small at D 256
]


def _force_bwd(monkeypatch, cfg):
    """Make ``flash_attention_bwd`` launch configuration ``cfg`` (0 Small,
    1 Large, 2 the Hopper design) whatever ``bwd_plan`` would pick."""
    plan = tfa.bwd_plan
    monkeypatch.setattr(tfa, "bwd_plan",
                        lambda *args: plan(*args, cfg=cfg))


def _bwd_inputs(b, h, kv, s, t, d, causal, window, cap, strided, dev):
    rng = np.random.default_rng(s + t + d)
    shape_q, shape_kv = (((b, s, h, d), (b, t, kv, d)) if strided
                         else ((b, h, s, d), (b, kv, t, d)))
    on = lambda shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(dev)
    q, k, v, do = on(shape_q), on(shape_kv), on(shape_kv), on(shape_q)
    if strided:
        q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
    kw = dict(causal=causal, window=window, softcap=cap)
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    return (q, k, v, o, lse, do), kw


@pytest.mark.parametrize("cfg", [0, 1])
@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap,strided",
                         BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, monkeypatch,
                                                  cfg, b, h, kv, s, t, d,
                                                  causal, window, cap,
                                                  strided):
    """Each configuration forced, against ``flash_attention_bwd_plain``
    from the kernel forward's o and lse: dq, dk and dv to 1e-4 of their
    largest magnitude (rtol = atol), one counted launch per call, a bitwise
    repeat, and dq exactly 0 on rows with no live key. Small raises
    ``ValueError`` where T is past its key tile, before any launch."""
    ins, kw = _bwd_inputs(b, h, kv, s, t, d, causal, window, cap, strided,
                          cuda_device)
    _force_bwd(monkeypatch, cfg)
    before = tfa.flash_attention_bwd.launches
    if cfg == 0 and t > tfa.bwd_small_keys(tfa.kernel_head_dim(d)):
        with pytest.raises(ValueError, match="Small takes at most"):
            tfa.flash_attention_bwd(*ins, **kw)
        assert tfa.flash_attention_bwd.launches == before
        return
    got = tfa.flash_attention_bwd(*ins, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 1
    want = tfa.flash_attention_bwd_plain(*ins, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        top = float(w.abs().max())
        assert bool(((g - w).abs() <= 1e-4 * (top + w.abs())).all())
    for _ in range(2):
        again = tfa.flash_attention_bwd(*ins, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
    if window and s > t + window - 1:
        assert not bool(got[0][:, :, t + window - 1:].any())


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window", [
    (64, 4, 4, 64, 64, 64, False, 0),       # the training step: Small
    (64, 4, 4, 32, 32, 32, False, 0),       # e5b: Small
    (64, 4, 4, 32, 32, 24, False, 0),       # minilm: Small
    (2, 4, 2, 70, 65, 64, False, 0),        # Large, no walk cut
    (1, 28, 4, 2048, 2048, 128, True, 0),   # bench: Large, cut walks
    (1, 4, 2, 300, 130, 256, True, 64),     # Large with dead rows
])
def test_flash_attention_bwd_kernels_per_call(cuda_device, b, h, kv, s, t,
                                              d, causal, window):
    """The kernels a call runs, by profiler name, are the plan's: Small is
    one ``bwd_kv_kernel`` launch (the encoders' shapes take it); Large runs
    ``delta_kernel``, ``bwd_kv_kernel``, ``bwd_reduce_kernel`` where a key
    tile's walk was cut, and ``bwd_q_kernel``, each once."""
    ins, kw = _bwd_inputs(b, h, kv, s, t, d, causal, window, 0.0, False,
                          cuda_device)
    plan = tfa.bwd_plan(b, h, kv, s, t, d, causal, window)
    assert plan.cfg == (0 if t <= 64 and s <= 64 else 1)
    ran = _device_kernels(lambda: tfa.flash_attention_bwd(*ins, **kw))
    names = sorted(m.group(0) for n, count in ran for _ in range(count)
                   for m in [re.search(r"delta_kernel|bwd_kv_kernel|"
                                       r"bwd_reduce_kernel|bwd_q_kernel", n)]
                   if m)
    want = (["bwd_kv_kernel"] if plan.cfg == 0 else sorted(
        ["delta_kernel", "bwd_kv_kernel", "bwd_q_kernel"] +
        ["bwd_reduce_kernel"] * (plan.launches == 4)))
    assert names == want, ran
    assert len(names) == plan.launches


# bf16 backward cases: causal, window, soft cap, GQA / MQA, S != T, rows
# with no live key, strided views, at each of bf16's head dims
BF16_BWD_CASES = [
    # b, h, kv, s, t, d, causal, window, cap, strided
    (2, 4, 2, 64, 64, 64, True, 0, 0.0, False),       # Small, GQA
    (2, 4, 1, 300, 300, 64, True, 0, 0.0, True),      # MQA, strided
    (1, 4, 2, 200, 333, 128, False, 0, 0.0, False),   # S != T
    (1, 4, 1, 300, 130, 256, True, 64, 30.0, False),  # dead rows, cap
    (2, 8, 8, 100, 100, 32, True, 40, 0.0, True),     # window, D 32
    (2, 4, 4, 40, 32, 256, False, 0, 50.0, False),    # Small at D 256
    (1, 2, 2, 90, 1000, 64, False, 0, 0.0, True),     # cross, T > S
    # the Hopper design's tile edges: its dQ blocks of 128 rows, its key
    # tiles of 128 (dQ at D 128: 64) walked in rows of 64
    (1, 8, 2, 129, 129, 64, True, 0, 0.0, False),     # one past, group 4
    (2, 4, 1, 255, 257, 128, False, 0, 0.0, True),    # MQA, S != T
    (1, 4, 1, 65, 700, 128, False, 0, 20.0, False),   # T > S, cap, MQA
    (1, 8, 2, 384, 384, 64, True, 100, 0.0, True),    # window over tiles
    (1, 4, 2, 260, 100, 64, True, 30, 0.0, False),    # rows 129.. dead
    # causal at D 128, whose dQ pass walks key tiles of 64
    (1, 8, 2, 333, 333, 128, True, 0, 0.0, True),     # group 4, ragged
    (2, 4, 1, 300, 200, 128, True, 50, 0.0, False),   # MQA, rows 249.. dead
    (2, 16, 1, 333, 333, 256, True, 100, 0.0, True),  # D 256: MQA, window
    (1, 4, 2, 97, 700, 256, False, 0, 50.0, True),    # D 256: T > S, cap
]


def _bf16_bwd_inputs(b, h, kv, s, t, d, causal, window, cap, strided, dev):
    ins, kw = _bwd_inputs(b, h, kv, s, t, d, causal, window, cap, strided,
                          dev)
    q, k, v, _, _, do = (x.to(torch.bfloat16) for x in ins)
    if strided:   # keep the (B,S,H,D) layout the casts dropped
        q, k, v, do = (x.transpose(1, 2).contiguous().transpose(1, 2)
                       for x in (q, k, v, do))
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    return (q, k, v, o, lse, do), kw


@pytest.mark.parametrize("cfg", [None, 0, 1, 2])
@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap,strided",
                         BF16_BWD_CASES)
def test_flash_attention_bwd_bf16_matches_plain(cuda_device, monkeypatch,
                                                cfg, b, h, kv, s, t, d,
                                                causal, window, cap,
                                                strided):
    """The bf16 backward (the plan's configuration, and each forced where it
    runs: Small up to its key tile, the Hopper design at head dims 64, 128
    and 256) against ``flash_attention_bwd_plain`` from the bf16 forward's o
    and lse: bf16 dq, dk and dv within 2e-2 of their largest magnitude,
    one counted launch per call, a bitwise repeat, dq exactly 0 on rows
    with no live key."""
    ins, kw = _bf16_bwd_inputs(b, h, kv, s, t, d, causal, window, cap,
                               strided, cuda_device)
    if cfg is not None:
        if cfg == 0 and t > tfa.bwd_small_keys(tfa.kernel_head_dim(d)):
            return
        if cfg == 2 and d not in tfa.BWD_SM90_HEAD_DIMS:
            return
        _force_bwd(monkeypatch, cfg)
    before = tfa.flash_attention_bwd.launches
    got = tfa.flash_attention_bwd(*ins, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention_bwd.launches == before + 1
    want = tfa.flash_attention_bwd_plain(*ins, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        top = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 2e-2 * top
    again = tfa.flash_attention_bwd(*ins, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if window and s > t + window - 1:
        assert not bool(got[0][:, :, t + window - 1:].any())


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap", [
    (2, 4, 2, 256, 256, 64, True, 0, 0.0),
    (1, 4, 1, 300, 100, 256, True, 4, 0.0),      # rows with no live key
    (2, 2, 2, 128, 384, 128, False, 0, 50.0),
    (1, 8, 2, 300, 300, 32, True, 100, 20.0),
])
def test_flash_attention_bf16_lse_matches_plain(cuda_device, b, h, kv, s, t,
                                                d, causal, window, cap):
    """The bf16 forward's row log-sum-exp (kept in log2 units inside the
    kernel, written as (m + log2 l) ln 2) against the plain version's
    natural one on the same bf16 inputs: within 1e-4 + 1e-5 |lse|, and -inf
    on exactly the rows with no live key."""
    rng = np.random.default_rng(s + d)
    on = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device).to(torch.bfloat16)
    q, k, v = on(b, h, s, d), on(b, kv, t, d), on(b, kv, t, d)
    kw = dict(causal=causal, window=window, softcap=cap)
    o, lse = tfa.flash_attention_fwd(q, k, v, **kw)
    _, want = tfa._plain_forward(q, k, v, scale=None, want_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    dead = ~torch.isfinite(want)
    assert torch.equal(~torch.isfinite(lse), dead)
    assert bool((lse[dead] == -torch.inf).all())
    err = (lse[~dead] - want[~dead]).abs()
    assert bool((err <= 1e-4 + 1e-5 * want[~dead].abs()).all()), err.max()
    np.testing.assert_allclose(
        o.float().cpu().numpy(),
        tfa.flash_attention_plain(q, k, v, **kw).float().cpu().numpy(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window", [
    (2, 4, 2, 200, 333, 64, False, 0),      # the Hopper design at D 64
    (1, 8, 2, 300, 300, 128, True, 64),     # ... at D 128, a window
    (1, 4, 2, 300, 130, 256, True, 64),     # ... at D 256, dead rows
    (2, 8, 8, 100, 100, 32, True, 40),      # D 32: the SIMT kernels
])
def test_flash_attention_bwd_bf16_kernels_per_call(cuda_device, b, h, kv, s,
                                                   t, d, causal, window):
    """The kernels a bf16 call runs, by profiler name, are the plan's: at
    head dims 64, 128 and 256 ``bwd_q_kernel_sm90`` (which also writes the
    rows' lse and Delta) then ``bwd_kv_kernel_sm90``, once each and
    nothing else; at 32 the SIMT configuration the plan picks."""
    ins, kw = _bf16_bwd_inputs(b, h, kv, s, t, d, causal, window, 0.0,
                               False, cuda_device)
    plan = tfa.bwd_plan(b, h, kv, s, t, d, causal, window, torch.bfloat16)
    ran = _device_kernels(lambda: tfa.flash_attention_bwd(*ins, **kw))
    names = sorted(m.group(0) for n, count in ran for _ in range(count)
                   for m in [re.search(r"(delta_kernel|bwd_kv_kernel|"
                                       r"bwd_reduce_kernel|bwd_q_kernel)"
                                       r"(_sm90)?", n)] if m)
    if d in tfa.BWD_SM90_HEAD_DIMS:
        assert plan.cfg == tfa.BWD_SM90
        assert names == ["bwd_kv_kernel_sm90", "bwd_q_kernel_sm90"], ran
        assert len(names) == plan.launches == 2
    else:
        assert plan.cfg in (tfa.BWD_SMALL, tfa.BWD_LARGE)
        assert not any(n.endswith("_sm90") for n in names), ran
        assert len(names) == plan.launches


def test_flash_attention_bf16_autograd(cuda_device):
    """A bf16 ``flash_attention`` with inputs that require grad runs through
    ``FlashAttention`` (the forward kernel keeps lse, the backward is the
    bf16 backward, at head dim 64 the Hopper design: one launch each) and
    gives autograd of the plain version's gradients within 2e-2 of their
    largest magnitude."""
    rng = np.random.default_rng(7)
    on = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device).to(torch.bfloat16)
    q, k, v, g = on(2, 8, 200, 64), on(2, 2, 200, 64), on(2, 2, 200, 64), \
        on(2, 8, 200, 64)
    kw = dict(causal=True, window=50, softcap=30.0)
    assert tfa.bwd_plan(2, 8, 2, 200, 200, 64, True, 50,
                        torch.bfloat16).cfg == tfa.BWD_SM90
    before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tfa.flash_attention(*ins, **kw)
    assert out.grad_fn is not None and out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, ins, g)
    assert (tfa.flash_attention.launches - before[0],
            tfa.flash_attention_bwd.launches - before[1]) == (1, 1)
    ref = [x.float().clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(tfa.flash_attention_plain(*ref, **kw), ref,
                               g.float())
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        top = float(w.abs().max())
        assert float((a.float() - w).abs().max()) <= 2e-2 * top


# the RG-LRU gradient: ragged S against the prefetch of 16 steps, h0, D 98
# (no multiple of 4), S 1, and a channel with log_a = 0 (the clamp)
@pytest.mark.parametrize("b,s,d,with_h0,clamp", [
    (2, 200, 512, True, False), (1, 33, 96, False, False),
    (2, 1, 96, True, False), (2, 50, 98, True, False),
    (1, 77, 64, True, True),
])
def test_rglru_scan_grad_matches_plain_autograd(cuda_device, b, s, d,
                                                with_h0, clamp):
    """With inputs that require grad, ``rglru_scan`` runs through
    ``RglruScan`` (one forward and one ``rglru_scan_bwd`` launch) and its
    gradients for log_a, x and h0 match autograd of the plain recurrence
    to 1e-5 of each one's largest finite magnitude; at a log_a = 0
    channel both give the same non-finite values."""
    rng = np.random.default_rng(s + d)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
    log_a, x = -f(b, s, d).abs() * 0.1, f(b, s, d)
    if clamp:
        log_a[:, :, 3] = 0.0
    h0 = f(b, d) if with_h0 else None
    wh, wl = f(b, s, d), f(b, d)
    leaves = [t for t in (log_a, x, h0) if t is not None]
    mine = [t.clone().requires_grad_(True) for t in leaves]
    plain = [t.clone().requires_grad_(True) for t in leaves]
    before = (trg.rglru_scan.launches, trg.rglru_scan_bwd.launches)
    h, hl = trg.rglru_scan(*mine[:2], mine[2] if with_h0 else None)
    assert h.requires_grad and hl.requires_grad
    got = torch.autograd.grad((h * wh).sum() + (hl * wl).sum(), mine)
    assert (trg.rglru_scan.launches - before[0],
            trg.rglru_scan_bwd.launches - before[1]) == (1, 1)
    ph, phl = trg.rglru_scan_plain(*plain[:2],
                                   plain[2] if with_h0 else None)
    want = torch.autograd.grad((ph * wh).sum() + (phl * wl).sum(), plain)
    for a, w in zip(got, want):
        fin = torch.isfinite(w)
        assert torch.equal(torch.isfinite(a), fin)
        assert torch.equal(a[~fin].isnan(), w[~fin].isnan())
        assert torch.equal(a[~fin & ~w.isnan()], w[~fin & ~w.isnan()])
        top = float(w[fin].abs().max())
        assert float((a[fin] - w[fin]).abs().max()) <= 1e-5 * top
    assert bool(torch.isfinite(got[1]).all())


# the RG-LRU backward by the dispatch rule: the TMA ring read in reverse
# (D a multiple of 4, aligned) across ragged tiles (S 77, 33, 300, 1),
# D 4100 (a ragged channel tile), a log_a = 0 channel; D 98 and a
# misaligned view take the first design
@pytest.mark.parametrize("b,s,d,with_h0,clamp,misalign", [
    (1, 77, 64, True, True, False), (2, 300, 512, True, False, False),
    (1, 33, 4100, False, False, False), (2, 1, 96, True, False, False),
    (2, 50, 98, True, True, False), (1, 65, 128, True, False, True),
])
def test_rglru_scan_bwd_kernels_match_plain(cuda_device, b, s, d, with_h0,
                                            clamp, misalign):
    """``rglru_scan_bwd`` from the forward kernel's h against
    ``rglru_scan_bwd_plain``: the same non-finite values (log_a = 0), the
    rest within 1e-5 of each gradient's largest finite magnitude, a second
    call bitwise equal, one launch, and the kernel ``uses_tma`` names by
    its profiler name."""
    rng = np.random.default_rng(s + d)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
    log_a, x = -f(b, s, d).abs() * 0.1, f(b, s, d)
    if clamp:
        log_a[:, :, 3] = 0.0
    if misalign:
        log_a = _misaligned(log_a)
    h0 = f(b, d) if with_h0 else None
    with torch.no_grad():
        h, _ = trg.rglru_scan(log_a, x, h0)
    dh, dl = f(b, s, d), f(b, d)
    args = (log_a, x, h0, h, dh, dl)
    before = trg.rglru_scan_bwd.launches
    got = trg.rglru_scan_bwd(*args)
    torch.cuda.synchronize()
    assert trg.rglru_scan_bwd.launches == before + 1
    again = trg.rglru_scan_bwd(*args)
    want = trg.rglru_scan_bwd_plain(*args)
    for a, a2, w in zip(got, again, want):
        if w is None:
            assert a is None and a2 is None
            continue
        assert torch.equal(a.isnan(), a2.isnan())
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(a2))
        fin = torch.isfinite(w)
        assert torch.equal(torch.isfinite(a), fin)
        assert torch.equal(a[~fin].isnan(), w[~fin].isnan())
        assert torch.equal(a[~fin & ~w.isnan()], w[~fin & ~w.isnan()])
        top = float(w[fin].abs().max())
        assert float((a[fin] - w[fin]).abs().max()) <= 1e-5 * top
    tma = trg.uses_tma(log_a, x, h, dh)
    assert tma == (d % 4 == 0 and not misalign)
    names = _kernel_names(lambda: trg.rglru_scan_bwd(*args),
                          family="rglru_bwd_kernel")
    assert len(names) == 1, names
    assert ("rglru_bwd_kernel_sm90" in names[0]) == tma, names


def _model_decays(rng, b, s, h, dev):
    """(log_a, dt) as mamba2-1.3b draws them at its init: A ~ U(1, 16) and
    dt_bias = log(expm1(U(1e-3, 0.1))) per head, dt = softplus(normal +
    dt_bias), log_a = -A dt (chunks of 128 past a mean |log_a| of 0.7
    overflow exp(cum_i - cum_j) above the diagonal)."""
    a = rng.uniform(1.0, 16.0, h).astype(np.float32)
    bias = np.log(np.expm1(rng.uniform(1e-3, 0.1, h))).astype(np.float32)
    raw = rng.standard_normal((b, s, h), dtype=np.float32)
    dt = np.logaddexp(raw + bias, 0.0).astype(np.float32)
    return (torch.from_numpy(-a * dt).to(dev), torch.from_numpy(dt).to(dev))


SSD_BWD_CASES = [
    (2, 200, 4, 64, 32, 64, True, "ref"),
    (1, 256, 2, 32, 64, 128, False, "ref"),
    (2, 96, 8, 64, 128, 32, True, "ref"),
    (2, 300, 3, 64, 128, 128, True, "model"),   # ragged, mamba2's P, N, L
    (1, 50, 2, 48, 16, 128, False, "ref"),      # S < chunk, P 48
    (2, 1, 2, 32, 8, 32, True, "ref"),          # S = 1
    (1, 640, 4, 64, 128, 128, True, "model"),   # 5 chunks
    (1, 130, 3, 32, 64, 16, False, "model"),    # chunk 16
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0,decay", SSD_BWD_CASES)
def test_ssd_scan_bwd_kernel_matches_plain(cuda_device, b, s, h, p, n, chunk,
                                           with_h0, decay, dtype):
    """``ssd_scan_bwd`` against ``ssd_scan_bwd_plain`` on the same inputs,
    x, B and C as column slices of one (B,S,H*P+2N) tensor in ``dtype``:
    every gradient finite, fp32 ones within 1e-4 of their max |g|, the
    bf16-rounded dx, dB, dC within 1e-2, a second call bitwise equal, one
    counted launch of the route's kernels by profiler name (bf16 at P 64,
    N 128, chunk 128: the five of ``csrc/ssd_scan_bwd_sm90.cu``, the
    states kernel twice; else the three of ``csrc/ssd_scan_bwd.cu``);
    decays as the reference's test draws them or as mamba2-1.3b's init
    does (the overflow regime)."""
    rng = np.random.default_rng(s + p + n + chunk)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
    xbc = f(b, s, h * p + 2 * n).to(dtype)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bt, ct = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    if decay == "model":
        log_a, dt = _model_decays(rng, b, s, h, cuda_device)
    else:
        dt = torch.nn.functional.softplus(f(b, s, h))
        log_a = -0.1 * dt
    h0 = f(b, h, p, n) if with_h0 else None
    args = (x, bt, ct, log_a, dt, h0, f(b, s, h, p), f(b, h, p, n))
    before = tss.ssd_scan_bwd.launches
    got = tss.ssd_scan_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert tss.ssd_scan_bwd.launches == before + 1
    again = tss.ssd_scan_bwd(*args, chunk=chunk)
    want = tss.ssd_scan_bwd_plain(*args, chunk=chunk)
    for a, a2, w, like in zip(got, again, want, (x, bt, ct, log_a, dt, h0)):
        if like is None:
            assert a is None and w is None
            continue
        assert a.dtype == w.dtype == like.dtype and a.shape == like.shape
        assert torch.equal(a, a2)
        assert bool(torch.isfinite(a).all()) and bool(
            torch.isfinite(w).all())
        tol = 1e-2 if a.dtype == torch.bfloat16 else 1e-4
        top = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= tol * max(
            top, 1e-30)
    names = _kernel_names(lambda: tss.ssd_scan_bwd(*args, chunk=chunk),
                          family="ssd_bwd_")
    if tss.uses_sm90(dtype, p, n, chunk):
        want = {"ssd_bwd_cb_sm90": 1, "ssd_bwd_states_sm90": 2,
                "ssd_bwd_dc_sm90": 1, "ssd_bwd_dx_sm90": 1,
                "ssd_bwd_reduce_sm90": 1}
    else:
        want = {"ssd_bwd_states_kernel": 1, "ssd_bwd_chunk_kernel": 1,
                "ssd_bwd_reduce_kernel": 1}
    assert len(names) == sum(want.values()), names
    for kernel, count in want.items():
        assert sum(kernel in n for n in names) == count, names


@pytest.mark.parametrize("b,s,h,with_h0", [
    (1, 700, 20, True),     # 6 chunks, head groups of 16 and 4
    (2, 260, 3, False),     # one ragged group, a ragged last chunk
])
def test_ssd_scan_bwd_hopper_route_matches_plain(cuda_device, b, s, h,
                                                 with_h0):
    """The Hopper backward (``csrc/ssd_scan_bwd_sm90.cu``) at mamba2-1.3b's
    P 64, N 128, chunk 128 in bf16, at a reduced S and H with ragged head
    groups: against ``ssd_scan_bwd_plain`` (fp32 gradients to 1e-4 of
    their max, bf16 ones to 1e-2), finite, and a second call bitwise
    equal; a slice one element off TMA's 16-byte rule raises
    ``ValueError`` and launches nothing."""
    p, n = 64, 128
    rng = np.random.default_rng(s + h)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
    xbc = f(b, s, h * p + 2 * n + 8).to(torch.bfloat16)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bt, ct = xbc[..., h * p:h * p + n], xbc[..., h * p + n:h * p + 2 * n]
    log_a, dt = _model_decays(rng, b, s, h, cuda_device)
    h0 = f(b, h, p, n) if with_h0 else None
    args = (x, bt, ct, log_a, dt, h0, f(b, s, h, p), f(b, h, p, n))
    assert tss.uses_sm90(x.dtype, p, n, 128)
    got = tss.ssd_scan_bwd(*args, chunk=128)
    again = tss.ssd_scan_bwd(*args, chunk=128)
    want = tss.ssd_scan_bwd_plain(*args, chunk=128)
    for a, a2, w in zip(got, again, want):
        if w is None:
            assert a is None
            continue
        assert torch.equal(a, a2)
        assert bool(torch.isfinite(a).all())
        tol = 1e-2 if a.dtype == torch.bfloat16 else 1e-4
        top = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= tol * top
    off = xbc[..., 1:1 + h * p + 2 * n]
    before = tss.ssd_scan_bwd.launches
    with pytest.raises(ValueError, match="TMA"):
        tss.ssd_scan_bwd(off[..., :h * p].reshape(b, s, h, p),
                         off[..., h * p:h * p + n], off[..., h * p + n:],
                         *args[3:], chunk=128)
    assert tss.ssd_scan_bwd.launches == before


def test_ssd_scan_grad_goes_through_both_kernels(cuda_device):
    """With an input that requires grad, ``ssd_scan`` on the card runs
    through ``SsdScan``: one forward and one backward launch, and every
    gradient (x, B, C, log_a, dt, h0) within 1e-4 of autograd of the plain
    version, finite at decays past the overflow (one head at A = 16). A
    ``None`` cotangent of h_last is zero; under ``torch.no_grad`` no
    backward is recorded."""
    rng = np.random.default_rng(5)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
    b, s, h, p, n = 1, 300, 2, 64, 128
    log_a, dt = _model_decays(rng, b, s, h, cuda_device)
    log_a[..., 0] = -16.0 * dt[..., 0]
    leaves = (f(b, s, h, p), f(b, s, n), f(b, s, n), log_a, dt,
              f(b, h, p, n))
    wy = f(b, s, h, p)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in leaves]
        y, _ = fn(*ins, chunk=128)
        return torch.autograd.grad((y * wy).sum(), ins)
    before = (tss.ssd_scan.launches, tss.ssd_scan_bwd.launches)
    got = grads(tss.ssd_scan)
    torch.cuda.synchronize()
    assert (tss.ssd_scan.launches - before[0],
            tss.ssd_scan_bwd.launches - before[1]) == (1, 1)
    want = grads(tss.ssd_scan_plain)
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all())
        top = float(w.abs().max())
        assert float((a - w).abs().max()) <= 1e-4 * top
    with torch.no_grad():
        y, _ = tss.ssd_scan(*[t.clone().requires_grad_(True)
                              for t in leaves], chunk=128)
    assert y.grad_fn is None


def test_ssd_scan_under_checkpoint_runs_forward_twice(cuda_device):
    """``torch.utils.checkpoint`` (non-reentrant, as ``lm.forward``'s
    remat) around a unit with one SSD scan launches the forward kernel
    twice (the forward, then the recompute) and the backward once, and the
    gradient equals the unrematerialised one bitwise."""
    from torch.utils.checkpoint import checkpoint
    rng = np.random.default_rng(6)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device)
    b, s, h, p, n = 2, 200, 2, 32, 64
    log_a, dt = _model_decays(rng, b, s, h, cuda_device)
    x, bt, ct = f(b, s, h, p), f(b, s, n), f(b, s, n)

    def unit(xx):
        y, _ = tss.ssd_scan(xx * 2.0, bt, ct, log_a, dt, chunk=64)
        return (y * y).sum()

    def grad(remat):
        xx = x.clone().requires_grad_(True)
        before = (tss.ssd_scan.launches, tss.ssd_scan_bwd.launches)
        loss = (checkpoint(unit, xx, use_reentrant=False) if remat
                else unit(xx))
        g, = torch.autograd.grad(loss, xx)
        torch.cuda.synchronize()
        return g, (tss.ssd_scan.launches - before[0],
                   tss.ssd_scan_bwd.launches - before[1])
    g_remat, n_remat = grad(True)
    g_plain, n_plain = grad(False)
    assert n_remat == (2, 1) and n_plain == (1, 1)
    assert torch.equal(g_remat, g_plain)


def test_ssd_fwd_gradient_on_the_card_matches_the_cpu(cuda_device):
    """``models/ssd.py::ssd_fwd`` (in_proj, conv, the scan through
    ``SsdScan``, the gated norm, out_proj) at a reduced width with mamba2's
    chunk of 128, from its own init (one CPU generator) and a unit-RMS
    input of 256 tokens: the gradient of every parameter and of the input
    on the card within 1e-4 of each one's max |g| on the CPU, all finite,
    one forward and one backward SSD launch."""
    import dataclasses
    from repro_torch.models import ssd as tssd
    cfg = dataclasses.replace(ARCHS["mamba2-1.3b"].reduced(), ssm_chunk=128,
                              ssm_head_dim=64, ssm_state=128)
    params = tssd.init_ssd(torch.Generator().manual_seed(3), cfg,
                           torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 256, cfg.d_model), dtype=np.float32))

    def grads(dev):
        p = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
        xx = x.to(dev).requires_grad_(True)
        out = tssd.ssd_fwd(p, xx, cfg)
        g = torch.autograd.grad((out * out).sum(), [*p.values(), xx])
        return [t.cpu() for t in g]
    before = (tss.ssd_scan.launches, tss.ssd_scan_bwd.launches)
    got = grads(cuda_device)
    torch.cuda.synchronize()
    assert (tss.ssd_scan.launches - before[0],
            tss.ssd_scan_bwd.launches - before[1]) == (1, 1)
    want = grads("cpu")
    for a, w in zip(got, want):
        assert bool(torch.isfinite(a).all()) and bool(
            torch.isfinite(w).all())
        top = float(w.abs().max())
        assert float((a - w).abs().max()) <= 1e-4 * max(top, 1e-30)


@pytest.mark.parametrize("name", ["granite-3-2b", "recurrentgemma-9b",
                                  "mamba2-1.3b"])
def test_train_steps_on_the_card_match_the_cpu(cuda_device, name):
    """Two ``make_train_step``s of a reduced model (fp32, 2 units; the
    attention backward, the RG-LRU backward for recurrentgemma, the SSD
    backward for mamba2, on the card) from the same weights on the same batches as the CPU: the first
    step's gradients within 1e-4 of each leaf's largest magnitude, both
    steps' losses within 1e-5 relative, finite."""
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch import train as ttrain
    from repro_torch.core.draws import HostDraws
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import adamw_init
    cfg = ARCHS[name].reduced(max_units=2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = tlm.init_params(gen, cfg, device=cuda_device)
    cparams = tree_map(lambda t: t.cpu(), params)
    batches = [ttrain.synthetic_batch(HostDraws(i), cfg, 2, 64, "cpu")
               for i in range(2)]
    _, _, g = tsteps.loss_and_grads(params, {k: v.to(cuda_device) for k, v
                                             in batches[0].items()}, cfg)
    _, _, cg = tsteps.loss_and_grads(cparams, batches[0], cfg)
    for a, w in zip(tree_leaves(g), tree_leaves(cg)):
        top = float(w.abs().max())
        assert float((a.cpu() - w).abs().max()) <= 1e-4 * max(top, 1e-30)
    step = tsteps.make_train_step(cfg, lr=1e-4)
    opt, copt = adamw_init(params), adamw_init(cparams)
    for bt in batches:
        params, opt, m = step(params, opt, {k: v.to(cuda_device)
                                            for k, v in bt.items()})
        cparams, copt, cm = step(cparams, copt, bt)
        assert np.isfinite(float(m["loss"]))
        assert abs(float(m["loss"]) - float(cm["loss"])) <= 1e-5 * abs(
            float(cm["loss"]))


def test_encoder_gradients_on_the_card_match_the_cpu(cuda_device):
    """The cosine loss of 16 pairs through ``EncoderConfig()`` and its
    gradient by autograd (attention through ``FlashAttention``: the fp32
    forward kernel and the backward kernel, once per layer per encode),
    against the CPU's from the same weights and pairs: the loss to rtol
    1e-5, every leaf's gradient to 1e-4 of its largest magnitude."""
    from repro_torch.contrastive import finetune as ft
    from repro_torch.models.layers import tree_leaves
    cfg = tenc.EncoderConfig()
    params = tenc.init_encoder(torch.Generator().manual_seed(2), cfg,
                               device="cpu")
    rng = np.random.default_rng(8)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (32, 64)))
    mask = torch.ones((32, 64))
    mask[5, 30:] = 0.0
    batch = {"tok_a": tok[:16], "mask_a": mask[:16], "tok_b": tok[16:],
             "mask_b": mask[16:],
             "target": torch.from_numpy(rng.random(16).astype(np.float32))}

    def grads(where):
        p = tenc.tree_map(lambda w: w.to(where), params)
        b = {k: x.to(where) for k, x in batch.items()}
        loss, g = ft.loss_and_grads(p, b, cfg)
        return float(loss), [x.cpu() for x in tree_leaves(g)]
    before = (tfa.flash_attention.launches, tfa.flash_attention_bwd.launches)
    g_loss, g_grads = grads(cuda_device)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches - before[0],
            tfa.flash_attention_bwd.launches - before[1]) == (
                2 * cfg.n_layers, 2 * cfg.n_layers)
    c_loss, c_grads = grads("cpu")
    assert abs(g_loss - c_loss) <= 1e-5 * abs(c_loss)
    for g, c in zip(g_grads, c_grads):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())


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


# ---------------------------------------------------------------------------
# the routing service
# ---------------------------------------------------------------------------

def _service(dev, draws, autopilot=False, d=32, k=5, k_max=8, **cfg_kw):
    from repro_torch.autopilot import AutopilotConfig
    from repro_torch.core.fgts import FGTSConfig
    from repro_torch.data.pool import build_entries
    from repro_torch.serving import RouterService, RouterServiceConfig
    rng = np.random.default_rng(0)
    entries = build_entries([f"m{i}" for i in range(k)],
                            rng.standard_normal((k, d)),
                            (0.1 + rng.random(k)).tolist())
    cfg = RouterServiceConfig(
        fgts=FGTSConfig(n_models=k_max, dim=d, horizon=64, eta=2.0, mu=0.3,
                        sgld_steps=4, sgld_minibatch=16, n_chains=4,
                        force_distinct=True),
        k_max=k_max, feedback_capacity=64, feedback_expiry=3,
        autopilot=AutopilotConfig(every=2, quota=0.5, budget=0.5)
        if autopilot else None, **cfg_kw)
    return RouterService(entries, None, None, cfg, device=dev, draws=draws)


def _serve_inputs(dev, rounds=5, b=16, d=32, seed=1):
    """The queries of every round and the pref grid, made on ``dev``
    before any timed or guarded region (a host copy syncs)."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((rounds, b, d), generator=gen).to(dev),
            torch.tensor([0.0, 0.5, 2.0], device=dev))


def _serve_rounds(svc, dev, inputs, host_votes, seed=1):
    """Route with cycling prefs; each round delivers the previous batch's
    votes shuffled with two duplicates (drawn on the host, or on the
    device with ``host_votes`` False). Returns the pairs, tickets and
    folded counts of every round."""
    from repro_torch.core.draws import KeyedDraws
    xs, grid = inputs
    rounds, b = xs.shape[:2]
    votes = KeyedDraws(seed + 1, host=host_votes)
    out, prev = [], None
    for r in range(rounds):
        prefs = grid[(torch.arange(b, device=dev) + r) % 3]
        a1, a2, tk = svc.route_batch(xs[r], prefs=prefs)
        y = torch.where(votes.fold_in(r).uniform((b,), dev) < 0.5, 1.0, -1.0)
        n = None
        if prev is not None:
            perm = torch.argsort(votes.fold_in(100 + r).uniform((b,), dev))
            idx = torch.cat([perm, perm[:2]])
            n = svc.feedback_batch(prev[0][idx], prev[1][idx])
        prev = (tk, y)
        out.append((a1, a2, tk, n))
    return out


def test_router_service_on_the_card_matches_the_cpu(cuda_device):
    """Host-mode ``KeyedDraws`` give both runs the same numbers: pairs,
    tickets and folded counts equal, the posterior chains to rtol 1e-4."""
    from repro_torch.core.draws import KeyedDraws
    runs = {}
    for dev in (cuda_device, torch.device("cpu")):
        svc = _service(dev, KeyedDraws(3, host=True))
        runs[dev.type] = (svc, _serve_rounds(svc, dev, _serve_inputs(dev),
                                             True))
    (g_svc, g), (c_svc, c) = runs["cuda"], runs["cpu"]
    for (ga1, ga2, gt, gn), (ca1, ca2, ct, cn) in zip(g, c):
        assert torch.equal(ga1.cpu(), ca1) and torch.equal(ga2.cpu(), ca2)
        assert torch.equal(gt.cpu(), ct)
        assert (gn is None) == (cn is None) and (gn is None
                                                 or int(gn) == int(cn))
    for f in ("theta1", "theta2"):
        torch.testing.assert_close(getattr(g_svc.state.inner, f).cpu(),
                                   getattr(c_svc.state.inner, f),
                                   rtol=1e-4, atol=1e-5)
    assert g_svc.service_stats() | {"duel_cost": 0} == \
        c_svc.service_stats() | {"duel_cost": 0}


@pytest.mark.parametrize("autopilot", [False, True])
def test_router_service_hot_path_does_not_sync(cuda_device, autopilot):
    """``route_batch`` and ``feedback_batch`` under
    ``set_sync_debug_mode("error")`` with device-mode draws and device
    votes: no host sync anywhere inside them."""
    from repro_torch.core.draws import KeyedDraws
    svc = _service(cuda_device, KeyedDraws(4), autopilot=autopilot)
    inputs = _serve_inputs(cuda_device)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _serve_rounds(svc, cuda_device, inputs, False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = kernels.launch_counts()
    assert counts["dueling_select"] == 5
    assert counts["sgld_potential_grad"] == 2 * 4 * 5
    assert counts["dueling_score"] == (5 if autopilot else 0)
    assert [int(n) for *_, n in out[1:]] == [16] * 4


# ---------------------------------------------------------------------------
# streaming: one CUDA graph per padding bucket
# ---------------------------------------------------------------------------

STREAM_SIZES = (16, 5, 8, 11, 16, 1)


def _stream_rounds(svc, dev, xs, grid, sizes=STREAM_SIZES, seed=2,
                   between=None, top=16):
    """Route formed batches of ``sizes`` rows (prefs cycling, categories
    cycling) and deliver each batch's votes a batch late, shuffled with up
    to two duplicates (``top`` rows at most); ``between(r)`` runs control-plane
    calls before round r.
    Returns the pairs, tickets and folded counts of every round."""
    from repro_torch.core.draws import KeyedDraws
    votes = KeyedDraws(seed)
    out, prev = [], None
    for r, n in enumerate(sizes):
        if between is not None:
            between(r)
        rows = torch.arange(n, device=dev)
        a1, a2, tk = svc.route_batch(xs[r, :n], prefs=grid[(rows + r) % 3],
                                     cats=(rows + r) % 3)
        y = torch.where(votes.fold_in(r).uniform((n,), dev) < 0.5, 1.0, -1.0)
        got = None
        if prev is not None:
            m = prev[0].shape[0]
            perm = torch.argsort(votes.fold_in(100 + r).uniform((m,), dev))
            idx = torch.cat([perm, perm[:min(2, top - m)]])
            got = svc.feedback_batch(prev[0][idx], prev[1][idx])
        prev = (tk, y)
        out.append((a1, a2, tk, got))
    return out


def _same_rounds(got, want, what):
    for r, ((a1, a2, tk, n), (b1, b2, tb, m)) in enumerate(zip(got, want)):
        assert torch.equal(a1, b1) and torch.equal(a2, b2), (what, r)
        assert torch.equal(tk, tb), (what, r)
        assert (n is None) == (m is None) and (n is None
                                               or int(n) == int(m)), (what, r)


def _same_state(a, b):
    from repro_torch.models.layers import tree_leaves
    for u, v in zip(tree_leaves(a.state), tree_leaves(b.state)):
        assert torch.equal(u, v)
    for f in ("x", "a1", "a2", "ticket", "issued_at", "valid", "pref"):
        assert torch.equal(getattr(a.pending, f), getattr(b.pending, f)), f


@pytest.mark.parametrize("refresh", [False, True])
def test_stream_graphs_route_as_the_tick_batch_service(cuda_device,
                                                       refresh):
    """The streaming service's captured graphs (buckets 8 and 16, formed
    batches of 1 to 16 rows) route bitwise as a tick-batch twin's eager
    ``route_batch`` on the same device-mode ``KeyedDraws``: pairs,
    tickets, folded counts, the posterior and the ring; under refresh the
    duel logs agree (propensities, a cuBLAS product of the padded batch,
    to rtol 1e-6)."""
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.refresh import RefreshConfig
    kw = dict(refresh=RefreshConfig(capacity=64, n_categories=3)) \
        if refresh else {}
    gen = torch.Generator().manual_seed(7)
    xs = torch.randn((len(STREAM_SIZES), 16, 32), generator=gen) \
        .to(cuda_device)
    grid = torch.tensor([0.0, 0.5, 2.0], device=cuda_device)
    svc = _service(cuda_device, KeyedDraws(5), buckets=(8, 16), **kw)
    twin = _service(cuda_device, KeyedDraws(5), **kw)
    counts = svc.compiled_program_counts()
    assert counts["captures"] == 8 and counts["s_route"] == 2
    got = _stream_rounds(svc, cuda_device, xs, grid)
    want = _stream_rounds(twin, cuda_device, xs, grid)
    _same_rounds(got, want, "stream vs tick-batch")
    _same_state(svc, twin)
    assert svc.tick == twin.tick == int(svc._tick_dev)
    assert svc.compiled_program_counts() == counts
    if refresh:
        a, b = svc.export_log(), twin.export_log()
        assert a["count"] == b["count"] > 0
        for f in ("x", "a1", "a2", "y", "pref", "cat", "issued_at"):
            np.testing.assert_array_equal(a[f], b[f])
        np.testing.assert_allclose(a["prop"], b["prop"], rtol=1e-6)


@pytest.mark.parametrize("policy", ["fgts", "eps_greedy"])
def test_stream_padding_identity_on_the_card(cuda_device, policy):
    """The same formed batches through a ladder of (8,) and of (16,) (8
    rows of padding): pairs, tickets, folded counts and the posterior
    bitwise equal under device-mode ``KeyedDraws``."""
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.launch.serve import POLICIES
    gen = torch.Generator().manual_seed(8)
    sizes = (8, 3, 8, 5)
    xs = torch.randn((len(sizes), 8, 32), generator=gen).to(cuda_device)
    grid = torch.tensor([0.0, 0.5, 2.0], device=cuda_device)
    runs = []
    for buckets in ((8,), (16,)):
        svc = _service(cuda_device, KeyedDraws(6), buckets=buckets,
                       policy_factory=POLICIES[policy])
        runs.append((svc, _stream_rounds(svc, cuda_device, xs, grid,
                                         sizes, top=8)))
    _same_rounds(runs[0][1], runs[1][1], f"{policy}: bucket 8 vs 16")
    _same_state(runs[0][0], runs[1][0])


def test_stream_control_plane_captures_nothing(cuda_device):
    """``add_model``, ``retire_model``, ``apply_table``, ``seed_replay``
    and ``expire_pending`` between streamed batches write the live tensors
    in place: no graph is captured again, and the service keeps routing
    bitwise as its tick-batch twin doing the same calls."""
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.data.pool import PoolEntry
    gen = torch.Generator().manual_seed(9)
    xs = torch.randn((len(STREAM_SIZES), 16, 32), generator=gen) \
        .to(cuda_device)
    grid = torch.tensor([0.0, 0.5, 2.0], device=cuda_device)
    table = torch.randn((8, 32), generator=gen).to(cuda_device)
    new = PoolEntry("new", "new", 0.3, torch.randn(32, generator=gen)
                    .numpy())
    x_off = torch.randn((8, 32), generator=gen).to(cuda_device)

    def control(svc):
        def between(r):
            if r == 2:
                svc.add_model(new)
                svc.retire_model(0)
            if r == 3:
                svc.apply_table(table)
                svc.seed_replay(x_off, torch.full((8,), 5, device=cuda_device),
                                torch.arange(8, device=cuda_device) % 4 + 1,
                                torch.ones(8, device=cuda_device))
            svc.expire_pending()
        return between
    svc = _service(cuda_device, KeyedDraws(4), buckets=(8, 16))
    twin = _service(cuda_device, KeyedDraws(4))
    counts = svc.compiled_program_counts()
    got = _stream_rounds(svc, cuda_device, xs, grid, between=control(svc))
    want = _stream_rounds(twin, cuda_device, xs, grid,
                          between=control(twin))
    assert svc.compiled_program_counts() == counts
    _same_rounds(got, want, "after control-plane calls")
    _same_state(svc, twin)


@pytest.mark.parametrize("autopilot", [False, True])
def test_stream_hot_path_does_not_sync(cuda_device, autopilot):
    """``route_stream`` and the fused ``feedback_stream`` replay their
    graphs with no host sync (``set_sync_debug_mode("error")``); a replay
    adds nothing to the launch counters (they count Python calls)."""
    from repro_torch.core.draws import KeyedDraws
    svc = _service(cuda_device, KeyedDraws(4), autopilot=autopilot,
                   buckets=(8, 16))
    gen = torch.Generator().manual_seed(3)
    xs = torch.randn((len(STREAM_SIZES), 16, 32), generator=gen) \
        .to(cuda_device)
    grid = torch.tensor([0.0, 0.5, 2.0], device=cuda_device)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _stream_rounds(svc, cuda_device, xs, grid)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sum(kernels.launch_counts().values()) == 0
    assert [int(n) for *_, n in out[1:]] == list(STREAM_SIZES[:-1])


def _malloc_from_another_thread(dev, nbytes=(300 << 20) + 4096):
    """A device allocation larger than anything cached (so ``cudaMalloc``,
    a call a capture in the global error mode forbids to every thread) on
    a thread of its own, joined; the errors it raised."""
    import threading
    errors = []

    def malloc():
        try:
            torch.empty(nbytes, dtype=torch.uint8, device=dev)
        except RuntimeError as e:
            errors.append(e)
    th = threading.Thread(target=malloc)
    th.start()
    th.join()
    return errors


def test_stream_capture_error_mode_is_thread_local(cuda_device):
    """A ``cudaMalloc`` from another thread during the service's graph
    capture leaves it whole: the graph replays the body. The same call
    from another thread is refused, or breaks the capture, in the global
    error mode. A host sync on the capturing thread still raises (no
    eager retry); it comes last, as a broken capture leaves its memory
    pool recording. (A device-wide sync from another thread waits on the
    capturing stream and breaks a capture in either mode.)"""
    from repro_torch.core.draws import KeyedDraws
    svc = _service(cuda_device, KeyedDraws(4), buckets=(8,))
    x = torch.arange(8.0, device=cuda_device)
    out = torch.zeros_like(x)

    def other_thread_mallocs(_):
        torch.mul(x, 2.0, out=out)
        errors = _malloc_from_another_thread(cuda_device)
        torch.add(out, 1.0, out=out)
        return errors
    prog = svc._capture(other_thread_mallocs, 8, 8, False)
    assert prog.outs == []
    out.zero_()
    prog()
    torch.cuda.synchronize()
    assert torch.equal(out, 2.0 * x + 1.0)

    errors, broken = [], False
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph(),
                              capture_error_mode="global"):
            errors = other_thread_mallocs(None)
    except RuntimeError:
        broken = True
    torch.cuda.synchronize()
    assert errors or broken

    def host_sync(_):
        torch.mul(x, 2.0, out=out)
        return float(out.sum())

    with pytest.raises(RuntimeError):
        svc._capture(host_sync, 8, 8, False)


def test_stream_capture_holds_with_a_dropped_service_in_the_garbage(
        cuda_device):
    """A dropped streaming service is cyclic garbage that holds captured
    graphs, and destroying them inside another capture breaks it
    (``tools/capture_gc.py``). ``_capture`` keeps the cyclic collector off
    while it captures: a body that collects whenever the collector is on,
    as an automatic collection may, captures whole and replays with
    another service's graphs waiting in the garbage; the collector is on
    again after, and frees that service."""
    import gc
    import weakref
    from repro_torch.core.draws import KeyedDraws
    # no automatic collection may free the dropped service before the
    # capture, whose body collects in its place
    threshold = gc.get_threshold()
    gc.set_threshold(1 << 30)
    try:
        dropped = _service(cuda_device, KeyedDraws(5), buckets=(8,))
        alive = weakref.ref(dropped)
        del dropped
        svc = _service(cuda_device, KeyedDraws(4), buckets=(8,))
        x = torch.arange(8.0, device=cuda_device)
        out = torch.zeros_like(x)
        seen = []

        def collects_when_on(_):
            torch.mul(x, 2.0, out=out)
            if torch.cuda.is_current_stream_capturing():
                seen.append(gc.isenabled())
                if gc.isenabled():
                    gc.collect()
            torch.add(out, 1.0, out=out)
            return []
        assert gc.isenabled() and alive() is not None
        prog = svc._capture(collects_when_on, 8, 8, False)
        assert seen == [False] and gc.isenabled()
        out.zero_()
        prog()
        torch.cuda.synchronize()
        assert torch.equal(out, 2.0 * x + 1.0)
        gc.collect()
        assert alive() is None
    finally:
        gc.set_threshold(*threshold)


# ---------------------------------------------------------------------------
# the MoE FFN, cross attention and the new LM paths
# ---------------------------------------------------------------------------

def _moe_setup(name, dev, n_tok=256, seed=0):
    from repro_torch.models import moe as tmoe
    cfg = ARCHS[name].reduced()
    gen = torch.Generator().manual_seed(seed)
    params = tmoe.init_moe(gen, cfg, torch.float32, "cpu")
    x = torch.randn((2, n_tok // 2, cfg.d_model), generator=gen)
    card = tenc.tree_map(lambda w: w.to(dev), params)
    return tmoe, cfg, params, card, x


@pytest.mark.parametrize("impl", ["sparse", "dense"])
@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "arctic-480b"])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda_device, name, impl):
    """Reduced widths, 256 tokens at capacity factor 0.5 (so the sparse
    dispatch drops): the same experts and drops, outputs to 1e-4 of the
    largest magnitude, the aux loss to 1e-5."""
    tmoe, cfg, params, card, x = _moe_setup(name, cuda_device)
    if impl == "sparse":
        run = lambda p, xx: tmoe.moe_ffn_sparse(p, xx, cfg, 0.5)
    else:
        run = lambda p, xx: tmoe.moe_ffn(p, xx, cfg, impl="dense")
    want, waux = run(params, x)
    got, aux = run(card, x.to(cuda_device))
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    assert abs(float(aux) - float(waux)) <= 1e-5
    xf = x.reshape(-1, cfg.d_model)
    _, wi, _ = tmoe._route(params, xf, cfg)
    _, gi, _ = tmoe._route(card, xf.to(cuda_device), cfg)
    assert torch.equal(gi.cpu(), wi)
    c = tmoe.capacity(xf.shape[0], cfg, 0.5)
    wd = tmoe.dispatch(wi, cfg.n_experts, c)[0]
    gd = tmoe.dispatch(gi, cfg.n_experts, c)[0]
    assert torch.equal(gd.cpu(), wd)
    assert bool((wd == cfg.n_experts * c).any())


@pytest.mark.parametrize("impl", ["sparse", "dense"])
def test_moe_ffn_does_not_sync(cuda_device, impl):
    """``moe_ffn`` under ``set_sync_debug_mode("error")``: a host sync
    anywhere inside raises."""
    tmoe, cfg, _, card, x = _moe_setup("arctic-480b", cuda_device)
    x = x.to(cuda_device)
    tmoe.moe_ffn(card, x, cfg, impl=impl)        # warm (allocator, cuBLAS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = tmoe.moe_ffn(card, x, cfg, impl=impl)
        out1, _ = tmoe.moe_ffn(card, x[:, :1], cfg, impl=impl)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.shape == x.shape and out1.shape == (2, 1, cfg.d_model)
    assert bool(torch.isfinite(out).all()) and float(aux) > 0.0


@pytest.mark.parametrize("b,h,kv,s,t,d", [
    (2, 16, 16, 333, 1000, 64),       # ragged, T > S
    (2, 16, 16, 1000, 333, 64),       # S > T
    (1, 24, 8, 130, 257, 64),         # GQA, both ragged
    (1, 8, 8, 64, 1024, 128),
])
def test_flash_attention_bf16_cross_shapes_match_plain(cuda_device, b, h,
                                                       kv, s, t, d):
    """Cross attention's call: no mask, S queries over T != S keys."""
    rng = np.random.default_rng(s * t + d)
    on = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = on(b, h, s, d), on(b, kv, t, d), on(b, kv, t, d)
    before = tfa.flash_attention.launches
    o = tfa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    p = tfa.flash_attention_plain(q, k, v, causal=False)
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               p.float().cpu().numpy(),
                               **ATTN_TOL[torch.bfloat16])


def test_cross_attention_passes_the_tma_rule(cuda_device):
    """``cross_attention_kv`` at seamless-m4t-medium's widths in bf16 (S
    260 over a memory of 1000 frames) hands the kernel views that TMA
    loads, and matches the plain version."""
    from repro_torch.models import attention as tattn
    cfg = ARCHS["seamless-m4t-medium"]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = tattn.init_attn(gen, cfg, torch.bfloat16, cuda_device)
    x = torch.randn((2, 260, cfg.d_model), generator=gen,
                    device=cuda_device).bfloat16()
    mem = torch.randn((2, 1000, cfg.d_model), generator=gen,
                      device=cuda_device).bfloat16()
    before = tfa.flash_attention.launches
    out, k, v = tattn.cross_attention_kv(params, x, mem, cfg)
    assert tfa.flash_attention.launches == before + 1
    assert k.shape == (2, 1000, cfg.n_kv_heads, cfg.hd)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    want = tfa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=False)
    want = torch.einsum("bshk,hkd->bsd", want.transpose(1, 2), params["wo"])
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=2e-2)


def _lm_batch(cfg, n_tok, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, n_tok)))}
    if cfg.frontend == "vision":
        out["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32))
    if cfg.is_encdec:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_frames, cfg.d_model), dtype=np.float32))
    return out


@pytest.mark.parametrize("name, n_tok", [
    ("granite-moe-3b-a800m", 120), ("arctic-480b", 120),
    ("seamless-m4t-medium", 120), ("llava-next-34b", 120),
    ("granite-3-2b", 120), ("qwen2-7b", 120), ("gemma2-9b", 200),
    ("mistral-large-123b", 120)])
def test_lm_new_paths_on_the_card_match_the_cpu(cuda_device, name, n_tok):
    """A reduced fp32 model from one CPU generator: prefill of 120 tokens
    (llava: 16 patches before them; gemma2: 200, past its reduced window
    of 128, with both soft caps, so the local ring wraps) and 2 greedy
    decode steps, logits and every cache leaf to 2e-4; one attention
    launch per attention layer of the prefill (seamless: 2 encoder, 2
    self, 2 cross), none from decode."""
    cfg = ARCHS[name].reduced(max_units=2)
    if name == "gemma2-9b":
        assert cfg.window == 128 < n_tok
        assert cfg.attn_softcap and cfg.logit_softcap
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    card = tenc.tree_map(lambda w: w.to(cuda_device), params)
    batch = _lm_batch(cfg, n_tok, 9)
    s = n_tok + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    runs = {}
    for where, p in ((torch.device("cpu"), params), (cuda_device, card)):
        kernels.reset_launch_counts()
        last, cache = tlm.prefill(p, {k: v.to(where) for k, v in
                                      batch.items()}, cfg, cache_len=s + 2)
        counts = kernels.launch_counts()
        logits = [last]
        nxt = last.argmax(-1).cpu()
        for step in range(2):
            lg, cache = tlm.decode_step(p, cache, nxt.to(where), s + step,
                                        cfg)
            logits.append(lg)
            nxt = lg.argmax(-1).cpu()
        assert kernels.launch_counts() == counts
        runs[where.type] = (logits, cache, counts)
    torch.cuda.synchronize()
    n_attn = cfg.n_layers + cfg.n_enc_layers + sum(
        sp.mixer == "xattn" for sp in cfg.all_specs())
    assert runs["cuda"][2]["flash_attention"] == n_attn
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


@pytest.mark.parametrize("buckets", [None, (16, 32)])
def test_mesh_world_of_one_matches_unsharded_on_the_card(cuda_device,
                                                         buckets):
    """``RouterService(mesh=...)`` on an NCCL world of one (a (1, 1) mesh)
    routes, resolves and folds bitwise as the unsharded service on the
    card, tick batch and streaming (its CUDA graphs) alike; the world is
    destroyed after."""
    import torch.distributed as dist
    from repro_torch.core import fgts
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.data.pool import PoolEntry
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.layers import tree_leaves
    from repro_torch.serving import RouterService, RouterServiceConfig
    d, k, b = 64, 6, 32
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((k, d)).astype(np.float32)
    entries = [PoolEntry(f"m{i}", "granite-3-2b", 0.1 * (i + 1), emb[i])
               for i in range(k)]
    cfg = RouterServiceConfig(
        fgts=fgts.FGTSConfig(n_models=k, dim=d, horizon=256, sgld_steps=4,
                             sgld_minibatch=16, n_chains=4),
        feedback_capacity=128, buckets=buckets)
    mesh_lib.init_world(cuda_device)
    try:
        assert dist.get_backend() == "nccl"
        mesh = mesh_lib.make_debug_mesh(1, 1, cuda_device)
        svcs = [RouterService(entries, None, None, cfg, device=cuda_device,
                              draws=KeyedDraws(3), mesh=m)
                for m in (None, mesh)]
        lag = None
        for r in range(5):
            x = torch.from_numpy(rng.standard_normal((b - r, d))
                                 .astype(np.float32)).to(cuda_device)
            if buckets is None:
                x = x[:16]
            outs = [s.route_batch(x) for s in svcs]
            for p, q in zip(*outs):
                assert torch.equal(p, q)
            y = torch.ones(outs[0][0].shape, device=cuda_device)
            if lag is not None:
                n = [s.feedback_batch(*lag) for s in svcs]
                assert torch.equal(n[0], n[1]) and int(n[0]) > 0
            lag = (outs[0][2], y)
        for u, v in zip(tree_leaves(svcs[0].state),
                        tree_leaves(svcs[1].state)):
            assert torch.equal(u, v)
        assert svcs[0].pending_count() == svcs[1].pending_count()
    finally:
        mesh_lib.close_world()
    assert not dist.is_initialized()


# the LM dry-run's shares: one unit of the rank program forward and
# backward on the card, at a cut batch and length with the local heads,
# widths and head dims of the train_4k shares on 16 x 16
SHARE_CUT = dict(batch=2, seq=512)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "seamless-m4t-medium",
                                  "mamba2-1.3b", "recurrentgemma-9b"])
def test_lm_dryrun_share_matches_its_plain_version(cuda_device, arch,
                                                   dtype):
    """A dry-run share (``launch/dryrun.py::build_share``: the model's
    unit through the rank's hooks, its collectives stood in for) launches
    the kernels its plan names, as many times (``unit_plan`` at the same
    shapes), and matches itself on the plain versions on the card
    (``compare_share``): outputs and every gradient within 1e-4 of their
    largest magnitude in fp32, 2e-2 in bf16 (the bf16 attention and its
    backward's tolerance)."""
    from repro_torch.configs import SHAPES as TSHAPES
    from repro_torch.launch import dryrun as tdr
    run, _, _ = tdr.build_share(arch, cuda_device, dtype=dtype, **SHARE_CUT)
    kernels.reset_launch_counts()
    got = tdr.compare_share(run)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    cfg = tdr.share_config(arch, dtype)
    shape = TSHAPES[tdr.SHARE_SHAPE]
    cut = type(shape)("cut", SHARE_CUT["seq"], 16 * SHARE_CUT["batch"],
                      "train")
    assert launches == tdr.plan_launches(
        tdr.unit_plan(cfg, cut, tdr.plain_mesh(tdr.SHARE_MESH)))
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert got["finite"], got
    assert got["out_rel_err"] <= tol and got["grad_rel_err"] <= tol, got
