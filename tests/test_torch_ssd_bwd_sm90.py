"""The arithmetic of the card's bf16 SSD backward, emulated on the CPU.

``csrc/ssd_scan_bwd_sm90.cu`` (bf16 x, B, C at P 64, N 128, chunk 128) runs
every product of the SSD scan's gradient on bf16 wgmma with fp32
accumulation. This file does the same arithmetic in fp32 on bf16-valued
tensors, in the kernels' order, and holds it to three references:

* ``jax.vjp`` of ``test_torch_ssd_grad.py::ssd_chunked_masked`` (the
  reference's ``ssd_chunked`` with the mask on the exponent) in float64;
* ``jax.vjp`` of the reference's ``ssd_chunked`` itself, where that is
  finite (its unmasked exponent overflows at mamba2-1.3b's decays);
* ``ssd_scan_bwd_plain``, the port's backward written out.

What the kernels do, and this emulation with them:

* C.B^T in fp32 once per (batch, chunk), never per head (exact bf16
  products); cum = the in-order running sum of log_a in fp32;
* the chunk states on the tensor cores: H^T walks forwards as
  B^T (x dec) and dH^T backwards as C^T (e^cum dy), the fp32 operand
  (x dec, e^cum dy) split into three bf16 pieces (exact products); the
  entry states are kept as three bf16 pieces each;
* products with one fp32 operand take its three pieces: dy x^T, dCB B,
  dCB^T C, x dH, B dH^T;
* the two products with two fp32 operands, M^T dy (M = C.B^T e^{cum_i -
  cum_j}) and dy H, split both operands and keep the six pairs of pieces
  whose products reach fp32's precision (hi hi, hi mid, mid hi, hi lo,
  mid mid, lo hi); a one-sided split of M^T dy (dy's pieces against M
  rounded once to bf16, or M's against dy rounded once) falls outside the
  tolerance, which is why the kernel pays for six;
* dB and dC summed over the heads of a group in order, then the groups'
  partials in order; dlog_a the reverse cumsum of dcum in each chunk.

bf16 inputs at P 64, N 128, chunk 128, ragged S, with and without h0, at
small B, S and H (groups of 2 heads, one of them ragged). Every gradient,
before the bf16 rounding of dx, dB and dC, within ``SSD_BWD_TOL`` (1e-4)
of its largest magnitude, as ``chip_smoke.py`` holds the kernel on the
card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssd as jssd
from repro_torch.kernels import ssd_scan as tss

import test_torch_ssd_grad as grad_tests

torch.set_num_threads(2)
SSD_BWD_TOL = 1e-4
NAMES = ("dx", "dB", "dC", "dlog_a", "ddt", "dh0")
P, N, L = 64, 128, 128


def split3(v: torch.Tensor):
    """fp32 -> three bf16 pieces (as fp32 tensors) hi + mid + lo, each the
    bf16 rounding of what the pieces before it leave; they sum to v exactly
    (where |v| >= 2^-100: below it the last pieces are subnormal and lose
    bits, at magnitudes no gradient here feels)."""
    hi = v.to(torch.bfloat16).float()
    r = v - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    big = v.abs() >= 2.0 ** -100
    assert torch.equal((hi.double() + mid.double() + lo.double())[big],
                       v.double()[big])
    return hi, mid, lo


# the pairs of pieces (of the first and the second operand) the kernel
# multiplies where both operands are fp32: every pair whose product is
# within 2^-16 of hi hi
SIX = ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))


def prod(a, b, split="a"):
    """a @ b on bf16 wgmma with fp32 sums: ``split`` "a" or "b" takes the
    named fp32 operand's three pieces against the other, a bf16 value (one
    sided, exact); "both" the six pairs of pieces above; "a1" and "b1" the
    one-sided forms of a two-sided product: that operand's three pieces
    against the other rounded once to bf16."""
    bf = lambda t: t.to(torch.bfloat16).float()
    if split == "a":
        assert torch.equal(bf(b), b)
        return sum(t @ b for t in split3(a))
    if split == "b":
        assert torch.equal(bf(a), a)
        return sum(a @ t for t in split3(b))
    if split == "a1":
        return sum(t @ bf(b) for t in split3(a))
    if split == "b1":
        return sum(bf(a) @ t for t in split3(b))
    pa, pb = split3(a), split3(b)
    return sum(pa[k] @ pb[m] for k, m in SIX)


def cumsum_in_order(la):
    """The running sum over the last axis, one step at a time in fp32 (as
    the kernels' scalar warp sums a chunk)."""
    out = torch.empty_like(la)
    acc = torch.zeros_like(la[..., 0])
    for j in range(la.shape[-1]):
        acc = acc + la[..., j]
        out[..., j] = acc
    return out


def sm90_ssd_bwd_emulation(x, bt, ct, log_a, dt, h0, dy, dh_last, *,
                           group=2, mt_split="both"):
    """(dx, dB, dC, dlog_a, ddt, dh0) as the Hopper kernels compute them,
    in fp32 (dx, dB, dC before their bf16 rounding); x, bt, ct bf16 at P
    64, N 128, chunk 128. ``group`` heads a block; ``mt_split`` the form of
    M^T dy (``prod``'s)."""
    b, s, h, p = x.shape
    f32 = torch.float32
    nc = -(-s // L)
    pad = nc * L - s
    xs, bs, cs = (tss._pad_seq(t.float(), pad) for t in (x, bt, ct))
    las, dts, dys = (tss._pad_seq(t.to(f32), pad) for t in (log_a, dt, dy))
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool))
    sl = lambda c: slice(c * L, (c + 1) * L)
    # the per-chunk scalars, (b, h, L) each
    cum = [cumsum_in_order(las[:, sl(c)].transpose(1, 2)) for c in range(nc)]
    dtc = [dts[:, sl(c)].transpose(1, 2) for c in range(nc)]
    e_in = [torch.exp(cm) for cm in cum]
    e_out = [torch.exp(cm[..., -1:] - cm) for cm in cum]
    e_last = [torch.exp(cm[..., -1]) for cm in cum]

    # 1. the states (transposed: (b, h, N, P)): H^T forwards, dH^T
    #    backwards; the kernels keep each chunk's entry state as three
    #    bf16 pieces, whose sum is the fp32 state
    ht = (torch.zeros((b, h, N, p), dtype=f32) if h0 is None
          else h0.to(f32).transpose(-1, -2).contiguous())
    h_in = []
    for c in range(nc):
        h_in.append(ht)
        xc = xs[:, sl(c)].permute(0, 2, 1, 3)             # (b,h,L,P)
        v = xc * (e_out[c] * dtc[c])[..., None]
        ht = e_last[c][..., None, None] * ht + prod(
            bs[:, sl(c)].transpose(1, 2)[:, None], v, "b")
    dht = (torch.zeros((b, h, N, p), dtype=f32) if dh_last is None
           else dh_last.to(f32).transpose(-1, -2).contiguous())
    dh_out = [None] * nc
    for c in range(nc - 1, -1, -1):
        dh_out[c] = dht
        dyc = dys[:, sl(c)].permute(0, 2, 1, 3)
        v = dyc * e_in[c][..., None]
        dht = e_last[c][..., None, None] * dht + prod(
            cs[:, sl(c)].transpose(1, 2)[:, None], v, "b")
    dh0 = None if h0 is None else dht.transpose(-1, -2).contiguous()

    # 2. per (batch, chunk, group of heads)
    dx = torch.zeros((b, nc * L, h, p), dtype=f32)
    dbt = torch.zeros((b, nc * L, N), dtype=f32)
    dct = torch.zeros((b, nc * L, N), dtype=f32)
    dla = torch.zeros((b, nc * L, h), dtype=f32)
    ddt = torch.zeros((b, nc * L, h), dtype=f32)
    for c in range(nc):
        bc, cc = bs[:, sl(c)], cs[:, sl(c)]               # (b,L,N)
        cb = cc @ bc.transpose(1, 2)                      # (b,L,L) once
        dc_groups, db_groups = [], []
        for g0 in range(0, h, group):
            dc_part = torch.zeros((b, L, N), dtype=f32)
            db_part = torch.zeros((b, L, N), dtype=f32)
            for hh in range(g0, min(h, g0 + group)):
                xc = xs[:, sl(c), hh]                     # (b,L,P) bf16
                dyc = dys[:, sl(c), hh]
                cm, d = cum[c][:, hh], dtc[c][:, hh]      # (b,L)
                ei, eo = e_in[c][:, hh], e_out[c][:, hh]
                hp = h_in[c][:, hh].transpose(-1, -2)     # (b,P,N) H
                dhp = dh_out[c][:, hh].transpose(-1, -2)  # dH
                diff = cm[:, :, None] - cm[:, None, :]
                e = torch.exp(torch.where(causal, diff, float("-inf")))
                # the dC kernel: G = dy x^T by rows i, dC over the group
                g = prod(dyc, xc.transpose(1, 2), "a")
                dcb = g * e * d[:, None, :]
                rows = (dcb * cb).sum(-1)
                dc_part = dc_part + prod(dcb, bc, "a")
                t = prod(dyc, hp, "both")                 # (b,L,N)
                inter = ei * (cc * t).sum(-1)
                dc_part = dc_part + ei[..., None] * t
                rowpart = rows + inter
                # the dB / dx kernel, by rows j
                gt = prod(xc, dyc.transpose(1, 2), "b")   # G^T
                et = e.transpose(1, 2)
                dcbt = gt * et * d[:, :, None]
                cols = (dcbt * cb.transpose(1, 2)).sum(-1)
                mt = cb.transpose(1, 2) * et
                bracket = prod(mt, dyc, mt_split)
                db_part = db_part + prod(dcbt, cc, "a")
                t = prod(xc, dhp, "b")                    # (b,L,N)
                db_part = db_part + (eo * d)[..., None] * t
                t2 = prod(bc, dhp.transpose(1, 2), "b")   # (b,L,P)
                u = eo * d * (xc * t2).sum(-1)
                bracket = bracket + eo[..., None] * t2
                dx[:, sl(c), hh] = d[..., None] * bracket
                ddt[:, sl(c), hh] = (xc * bracket).sum(-1)
                dcum = rowpart - cols - u
                hd = (h_in[c][:, hh] * dh_out[c][:, hh]).sum((-1, -2))
                dcum[:, -1] += u.sum(-1) + e_last[c][:, hh] * hd
                dla[:, sl(c), hh] = dcum.flip(-1).cumsum(-1).flip(-1)
            dc_groups.append(dc_part)
            db_groups.append(db_part)
        dct[:, sl(c)] = sum(dc_groups[1:], dc_groups[0])
        dbt[:, sl(c)] = sum(db_groups[1:], db_groups[0])
    cut = lambda t: t[:, :s].contiguous()
    return cut(dx), cut(dbt), cut(dct), cut(dla), cut(ddt), dh0


def inputs(b, s, h, with_h0, seed, decay):
    """bf16-valued x, B, C (fp32 tensors), log_a and dt (``decay`` "ref":
    log_a = -0.1 softplus(normal); "model": mamba2-1.3b's draws at its
    init, whose chunks overflow exp(cum_i - cum_j) above the diagonal),
    h0, dy and dh_last, as numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    bf = lambda a: np.asarray(torch.from_numpy(a).to(torch.bfloat16).float())
    if decay == "model":
        a = rng.uniform(1.0, 16.0, h).astype(np.float32)
        bias = np.log(np.expm1(rng.uniform(1e-3, 0.1, h))).astype(np.float32)
        dt = np.logaddexp(f(b, s, h) + bias, 0.0).astype(np.float32)
        log_a = (-a * dt).astype(np.float32)
    else:
        dt = np.logaddexp(f(b, s, h), 0.0).astype(np.float32)
        log_a = (-0.1 * dt).astype(np.float32)
    return dict(x=bf(f(b, s, h, P)), bt=bf(f(b, s, N)), ct=bf(f(b, s, N)),
                log_a=log_a, dt=dt, h0=f(b, h, P, N) if with_h0 else None,
                dy=f(b, s, h, P), dh_last=f(b, h, P, N))


def torch_inputs(d):
    return {k: None if v is None else torch.from_numpy(v) for k, v in d.items()}


def emulate(d, **kw):
    t = torch_inputs(d)
    return sm90_ssd_bwd_emulation(
        t["x"].to(torch.bfloat16), t["bt"].to(torch.bfloat16),
        t["ct"].to(torch.bfloat16), t["log_a"], t["dt"], t["h0"], t["dy"],
        t["dh_last"], **kw)


def oracle(d):
    """jax.vjp of the masked ``ssd_chunked`` in float64."""
    with grad_tests._x64():
        d64 = {k: None if v is None else v.astype(np.float64)
               for k, v in d.items()}
        return grad_tests.jax_grads(grad_tests.ssd_chunked_masked, d64, L,
                                    dtype=jnp.float64)


def errors(got, want):
    """Each gradient's largest error over its largest magnitude."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape and np.isfinite(g).all(), name
        out[name] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    return out


# (b, s, h, h0, decay): ragged S over 3 chunks, S below one chunk, a ragged
# head group; decays as the reference's test and as mamba2-1.3b's init
CASES = [
    (1, 300, 3, True, "ref"),
    (2, 200, 2, False, "ref"),
    (1, 100, 3, True, "model"),
    (1, 260, 2, False, "model"),
]


@pytest.mark.parametrize("b,s,h,with_h0,decay", CASES)
def test_emulation_matches_the_masked_reference_in_float64(b, s, h, with_h0,
                                                           decay):
    d = inputs(b, s, h, with_h0, seed=s + h, decay=decay)
    errs = errors(emulate(d), oracle(d))
    assert max(errs.values()) <= SSD_BWD_TOL, errs


@pytest.mark.parametrize("b,s,h,with_h0,decay", CASES)
def test_emulation_matches_the_plain_backward(b, s, h, with_h0, decay):
    d = inputs(b, s, h, with_h0, seed=s + h, decay=decay)
    t = torch_inputs(d)
    # the plain version on the bf16 values held in fp32: no rounding of dx,
    # dB, dC, as the emulation returns them
    want = tss.ssd_scan_bwd_plain(t["x"], t["bt"], t["ct"], t["log_a"],
                                  t["dt"], t["h0"], t["dy"], t["dh_last"],
                                  chunk=L)
    errs = errors(emulate(d), [w.numpy() if w is not None else None
                               for w in want])
    assert max(errs.values()) <= SSD_BWD_TOL, errs


@pytest.mark.parametrize("b,s,h,with_h0,decay", CASES)
def test_emulation_matches_the_reference_vjp_where_finite(b, s, h, with_h0,
                                                          decay):
    """The reference's own ``ssd_chunked`` (fp32, mask after the exponent):
    its gradients where they are all finite (at the model's decays its
    dlog_a is NaN, and that case checks the finite ones), within its own
    kernel tolerance of 2e-4."""
    d = inputs(b, s, h, with_h0, seed=s + h, decay=decay)
    want = grad_tests.jax_grads(jssd.ssd_chunked, d, L)
    got = emulate(d)
    finite = [w is None or np.isfinite(w).all() for w in want]
    if decay == "ref":
        assert all(finite)
    kept = [(g, w) if ok else (None, None)
            for g, w, ok in zip(got, want, finite)]
    errs = errors(*zip(*kept))
    assert errs and max(errs.values()) <= 2e-4, errs


def test_groups_sum_in_order_whatever_the_group_size():
    """dB and dC summed by groups of 1, 2 or 3 heads agree to fp32's
    rounding, and the other gradients do not depend on the grouping."""
    d = inputs(1, 200, 3, True, seed=5, decay="ref")
    runs = [emulate(d, group=g) for g in (1, 2, 3)]
    for other in runs[1:]:
        for name, a, o in zip(NAMES, runs[0], other):
            if name in ("dB", "dC"):
                top = float(a.abs().max())
                assert float((a - o).abs().max()) <= 1e-6 * top, name
            else:
                assert torch.equal(a, o), name


@pytest.mark.parametrize("mt_split", ["a1", "b1"])
def test_a_one_sided_split_of_mt_dy_misses_the_tolerance(mt_split):
    """M^T dy with only one operand split (M's pieces against dy rounded
    once to bf16, or dy's against M rounded once) puts ddt and dlog_a
    outside ``SSD_BWD_TOL``: the kernel's six pairs of pieces are
    needed."""
    d = inputs(1, 300, 3, True, seed=303, decay="ref")
    want = oracle(d)
    assert max(errors(emulate(d), want).values()) <= SSD_BWD_TOL
    errs = errors(emulate(d, mt_split=mt_split), want)
    assert max(errs["ddt"], errs["dlog_a"]) > SSD_BWD_TOL, errs


@pytest.mark.parametrize("variant", ["no_state_products", "no_piece_stores",
                                     "no_hd", "one_pair", "no_intra",
                                     "no_piece_loads"])
def test_ssd_bwd_variant_anchors_occur_once(variant):
    """``tools/ssd_bwd_variants.py`` patches the Hopper SSD backward's
    source at text anchors: each must occur exactly once in the source as
    it stands, applied in order, or the tool stops on the card."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "variant_build.py"
    spec = importlib.util.spec_from_file_location("variant_build", path)
    vb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vb)
    tool = vb.load("ssd_bwd_variants")
    vb.patched(vb.source_text(tool.SOURCE), tool.PATCHES[variant], variant)
