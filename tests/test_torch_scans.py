"""The port's scan kernels' plain versions against the JAX package, on the
CPU.

* ``ssd_scan_plain`` (the chunked arithmetic of the Pallas SSD kernel)
  against the JAX ``ssd_scan`` in interpret mode and the sequential oracle
  ``ref.ssd_ref``: the reference's three test shapes
  (``tests/test_kernels.py::test_ssd_scan``), S not a multiple of the
  chunk, S < chunk, S = 1, with and without h0, and bf16 x/B/C.
* ``rglru_scan_plain`` (the sequential recurrence) against the JAX
  ``rglru_scan`` in interpret mode and ``ref.rglru_ref``: the reference's
  three test shapes, D = 96 (which the TPU kernel's 512-wide blocks do not
  divide), S = 1, with and without h0.
* The port's sequential oracle ``ref.ssd_ref`` against the reference's
  ``ref.ssd_ref``.
* The arithmetic of the card's bf16 SSD kernel (``ssd_kernel_sm90`` in
  ``csrc/ssd_scan.cu``), emulated here: C.B^T once per (batch, chunk) in
  fp32, the in-order cumsum, W and x * dec split into three bf16 pieces
  (exactly), the state split likewise for C.state^T, every product exact
  and summed in fp32. It matches ``ssd_ref`` (the port's and the
  reference's) and the JAX kernel on the reference's shapes and at
  mamba2-1.3b's P 64, N 128, chunk 128 in bf16.
* The wrappers run the plain versions on CPU tensors and count no launch.

Tolerances are the reference's own: 2e-4 for the SSD, 1e-5 for the RG-LRU.
Inputs are made with numpy from a seed and handed to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as jax_rglru
from repro.kernels.ssd_scan import ssd_scan as jax_ssd
from repro_torch import kernels
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as trg
from repro_torch.kernels import ssd_scan as tss

torch.set_num_threads(2)
SSD_TOL = dict(rtol=2e-4, atol=2e-4)
RG_TOL = dict(rtol=1e-5, atol=1e-5)


def ssd_inputs(b, s, h, p, n, with_h0, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    dt = np.logaddexp(f(b, s, h), 0.0).astype(np.float32)
    return dict(x=f(b, s, h, p), bt=f(b, s, n), ct=f(b, s, n),
                log_a=(-0.1 * dt).astype(np.float32), dt=dt,
                h0=f(b, h, p, n) if with_h0 else None)


def rglru_inputs(b, s, d, with_h0, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    return dict(log_a=(-np.abs(f(b, s, d)) * 0.1).astype(np.float32),
                x_in=f(b, s, d), h0=f(b, d) if with_h0 else None)


def as_jax(d):
    return {k: None if v is None else jnp.asarray(v) for k, v in d.items()}


def as_torch(d):
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in d.items()}


SSD_SHAPES = [
    (2, 200, 4, 64, 32, 64, True),      # tests/test_kernels.py:62-66
    (1, 256, 2, 32, 64, 128, False),
    (2, 96, 8, 64, 128, 32, True),
    (1, 130, 3, 32, 64, 32, False),     # ragged tail
    (2, 50, 2, 32, 16, 128, True),      # S < chunk
    (1, 1, 2, 16, 8, 32, True),         # S = 1
]


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", SSD_SHAPES)
def test_ssd_plain_matches_jax_kernel_and_oracle(b, s, h, p, n, chunk,
                                                 with_h0):
    inp = ssd_inputs(b, s, h, p, n, with_h0)
    y, hl = tss.ssd_scan_plain(**as_torch(inp), chunk=chunk)
    assert y.shape == (b, s, h, p) and hl.shape == (b, h, p, n)
    assert y.dtype == hl.dtype == torch.float32
    jy, jhl = jax_ssd(**as_jax(inp), chunk=chunk)
    ry, rhl = jref.ssd_ref(**as_jax(inp))
    for want, got in ((jy, y), (jhl, hl), (ry, y), (rhl, hl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)


def test_ssd_plain_widens_bf16_inputs_as_the_jax_kernel():
    """bf16 x, B and C, widened to float32 on load on both sides."""
    inp = ssd_inputs(2, 100, 2, 32, 32, True, seed=3)
    jin = as_jax(inp)
    tin = as_torch(inp)
    for k in ("x", "bt", "ct"):
        jin[k] = jin[k].astype(jnp.bfloat16)
        tin[k] = tin[k].to(torch.bfloat16)
    y, hl = tss.ssd_scan_plain(**tin, chunk=32)
    jy, jhl = jax_ssd(**jin, chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(hl.numpy(), np.asarray(jhl), **SSD_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", SSD_SHAPES[:3] + [
    (1, 37, 2, 16, 8, 32, False)])
def test_ssd_ref_matches_the_reference_oracle(b, s, h, p, n, chunk,
                                              with_h0):
    inp = ssd_inputs(b, s, h, p, n, with_h0, seed=s)
    y, hl = tref.ssd_ref(**as_torch(inp))
    ry, rhl = jref.ssd_ref(**as_jax(inp))
    assert y.shape == (b, s, h, p) and hl.shape == (b, h, p, n)
    # the same recurrence; the einsums over N sum in another order
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **SSD_TOL)
    np.testing.assert_allclose(hl.numpy(), np.asarray(rhl), **SSD_TOL)


def split3(v: torch.Tensor):
    """fp32 -> three bf16 pieces hi + mid + lo, each the bf16 rounding of
    what the pieces before it leave (the residuals are exact in fp32)."""
    hi = v.to(torch.bfloat16)
    r = v - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def split_product(a: torch.Tensor, b: torch.Tensor, which: str):
    """a @ b with the fp32 operand (``which``: "a" or "b") as three bf16
    pieces: each piece's product with the bf16 operand is exact, the
    three are summed in fp32."""
    pieces = split3(a if which == "a" else b)
    exact = sum(t.double() for t in pieces)
    assert torch.equal(exact, (a if which == "a" else b).double()), \
        "the three bf16 pieces do not sum to the fp32 operand"
    out = 0.0
    for t in pieces:
        out = out + (t.float() @ b.float() if which == "a"
                     else a.float() @ t.float())
    return out


def sm90_ssd_emulation(x, bt, ct, log_a, dt, h0=None, *, chunk):
    """The bf16 Hopper kernel's arithmetic on the CPU. Per chunk of L
    steps (padded steps past S: zeros, log_a = dt = 0):

        CB     = C B^T                     (fp32, once per (batch, chunk))
        cum    = in-order running sum of log_a in fp32, as the kernel's
                 helper warp sums it
        W      = CB exp(cum_i - cum_j) dt_j  (j <= i), split in 3 pieces
        y      = W x + exp(cum_i) (C state^T), the state split in 3 pieces
        state' = exp(cum_L) state + (x dec)^T B, x dec split in 3 pieces,
                 dec_j = exp(cum_L - cum_j) dt_j
    """
    b, s, h, p = x.shape
    n = bt.shape[-1]
    f32 = torch.float32
    l = chunk
    nc = -(-s // l)
    pad = nc * l - s
    x, bt, ct = (tss._pad_seq(t, pad) for t in (x, bt, ct))
    log_a, dt = (tss._pad_seq(t.to(f32), pad) for t in (log_a, dt))
    state = (torch.zeros((b, h, p, n), dtype=f32) if h0 is None
             else h0.to(f32))
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool))
    ys = []
    for c in range(nc):
        sl = slice(c * l, (c + 1) * l)
        xc = x[:, sl].permute(0, 2, 1, 3)                  # (b,h,L,p) bf16
        bc, cc = bt[:, sl], ct[:, sl]                      # (b,L,n) bf16
        la, d = log_a[:, sl].transpose(1, 2), dt[:, sl].transpose(1, 2)
        cum = torch.zeros_like(la)
        acc = torch.zeros_like(la[..., 0])
        for j in range(l):
            acc = acc + la[..., j]
            cum[..., j] = acc
        cb = cc.float() @ bc.float().transpose(1, 2)       # (b,L,L)
        w = torch.where(causal, cb[:, None] * torch.exp(
            cum[..., :, None] - cum[..., None, :]) * d[..., None, :], 0.0)
        y_intra = split_product(w, xc, "a")
        y_inter = split_product(cc[:, None],
                                state.transpose(-1, -2), "b")
        ys.append(y_intra + torch.exp(cum)[..., None] * y_inter)
        dec = torch.exp(cum[..., -1:] - cum) * d           # (b,h,L)
        xw = xc.float() * dec[..., None]
        s_new = split_product(xw.transpose(-1, -2), bc[:, None], "a")
        state = torch.exp(cum[..., -1])[..., None, None] * state + s_new
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :s]
    return y.contiguous(), state


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", SSD_SHAPES + [
    (1, 300, 2, 64, 128, 128, True)])   # mamba2-1.3b's P, N and chunk
def test_sm90_ssd_numerics_plan_fits_the_reference_tolerance(
        b, s, h, p, n, chunk, with_h0):
    inp = ssd_inputs(b, s, h, p, n, with_h0, seed=s + p)
    jin, tin = as_jax(inp), as_torch(inp)
    for k in ("x", "bt", "ct"):
        jin[k] = jin[k].astype(jnp.bfloat16)
        tin[k] = tin[k].to(torch.bfloat16)
    y, hl = sm90_ssd_emulation(**tin, chunk=chunk)
    ty, thl = tref.ssd_ref(**tin)
    ry, rhl = jref.ssd_ref(**jin)
    jy, jhl = jax_ssd(**jin, chunk=chunk)
    for want, got in ((ry, y), (rhl, hl), (jy, y), (jhl, hl),
                      (ty.numpy(), y), (thl.numpy(), hl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)


@pytest.mark.parametrize("b,s,d,with_h0", [
    (2, 200, 512, True),                # tests/test_kernels.py:43-45
    (1, 128, 512, False),
    (3, 65, 1024, True),
    (2, 77, 96, False),                 # D = 96: no 512-wide block divides
    (2, 1, 96, True),                   # S = 1
])
def test_rglru_plain_matches_jax_kernel_and_oracle(b, s, d, with_h0):
    inp = rglru_inputs(b, s, d, with_h0)
    h, hl = trg.rglru_scan_plain(**as_torch(inp))
    assert h.shape == (b, s, d) and hl.shape == (b, d)
    rh, rhl = jref.rglru_ref(**as_jax(inp))
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), **RG_TOL)
    np.testing.assert_allclose(hl.numpy(), np.asarray(rhl), **RG_TOL)
    if d % min(512, d) == 0:
        jh, jhl = jax_rglru(**as_jax(inp))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **RG_TOL)
        np.testing.assert_allclose(hl.numpy(), np.asarray(jhl), **RG_TOL)


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    kernels.reset_launch_counts()
    ti = as_torch(ssd_inputs(1, 70, 2, 16, 8, True))
    y, hl = tss.ssd_scan(**ti, chunk=32)
    py, phl = tss.ssd_scan_plain(**ti, chunk=32)
    assert torch.equal(y, py) and torch.equal(hl, phl)
    ri = as_torch(rglru_inputs(2, 9, 40, True))
    h, hl = trg.rglru_scan(**ri)
    ph, phl = trg.rglru_scan_plain(**ri)
    assert torch.equal(h, ph) and torch.equal(hl, phl)
    assert kernels.launch_counts()["ssd_scan"] == 0
    assert kernels.launch_counts()["rglru_scan"] == 0


def test_scan_wrappers_refuse_other_devices():
    m = lambda *shape: torch.zeros(shape, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tss.ssd_scan(m(1, 4, 2, 8), m(1, 4, 8), m(1, 4, 8), m(1, 4, 2),
                     m(1, 4, 2))
    with pytest.raises(ValueError, match="cpu or cuda"):
        trg.rglru_scan(m(1, 4, 8), m(1, 4, 8))


def test_scan_bwd_refuses_other_devices():
    m = lambda *shape: torch.zeros(shape, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tss.ssd_scan_bwd(m(1, 4, 2, 8), m(1, 4, 8), m(1, 4, 8), m(1, 4, 2),
                         m(1, 4, 2), None, m(1, 4, 2, 8), None, chunk=16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        trg.rglru_scan_bwd(m(1, 4, 8), m(1, 4, 8), None, m(1, 4, 8),
                           m(1, 4, 8), m(1, 8))


@pytest.mark.parametrize("variant", ["stores_batched", "stores_in_line",
                                     "chain_in_line", "gates4", "stages8",
                                     "no_gate_math", "no_stores"])
def test_scan_bwd_variant_anchors_occur_once(variant):
    """``tools/scan_bwd_variants.py`` patches the RG-LRU backward's source
    at text anchors: each must occur exactly once in the source as it
    stands, applied in order, or the tool stops on the card."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "variant_build.py"
    spec = importlib.util.spec_from_file_location("variant_build", path)
    vb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vb)
    tool = vb.load("scan_bwd_variants")
    vb.patched(vb.source_text(tool.SOURCE), tool.PATCHES[variant], variant)
