"""The SSD scan's gradient in the port against the JAX package, on the CPU.

The reference trains through XLA's autodiff of
``repro/models/ssd.py::ssd_chunked``; the port's backward kernel
(``csrc/ssd_scan_bwd.cu``) has a plain twin, ``ssd_scan_bwd_plain``, which
these tests hold to the reference. Inputs are made with numpy from a seed
and handed to both sides; the reference's gradients are jitted.

* ``ssd_scan_bwd_plain`` against ``jax.vjp`` of ``ssd_chunked`` and
  against autograd of ``ssd_scan_plain``: the reference's three test
  shapes, a ragged S, S < chunk, S = 1, with and without h0, with a
  non-zero cotangent of h_last, and bf16 x/B/C. fp32 gradients within
  1e-5 of each one's max |g|; the bf16 ones (dx, dB, dC of bf16 inputs,
  rounded once from fp32 on both sides) within 1e-2.
* The overflow regime (chunk 128, log_a = -1 and -2): the reference forms
  exp(cum_i - cum_j) above the diagonal too, where it overflows, and its
  masked-out inf makes dlog_a NaN (0 times inf); the port masks the
  exponent, and its dlog_a is finite and equals a float64 oracle, this
  file's JAX rewrite of ``ssd_chunked`` with the exponent masked, within
  1e-5 of its max.
* One Mamba-2 layer (``ssd_fwd``) at a reduced width with mamba2-1.3b's
  chunk of 128, from the reference's init: the reference's gradients of
  a_log, dt_bias, in_proj and the input are non-finite, the port's are all
  finite, and the leaves the overflow does not reach agree to 1e-4.
* ``ssd_scan_plain``'s forward is bitwise what it was before the mask
  moved onto the exponent.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import ssd as jssd
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models import ssd as tssd

torch.set_num_threads(2)
GRAD_TOL, BF16_TOL = 1e-5, 1e-2
NAMES = ("dx", "dB", "dC", "dlog_a", "ddt", "dh0")

# (b, s, h, p, n, chunk, h0)
SHAPES = [
    (2, 200, 4, 64, 32, 64, True),      # tests/test_kernels.py:62-66
    (1, 256, 2, 32, 64, 128, False),
    (2, 96, 8, 64, 128, 32, True),
    (1, 130, 3, 32, 64, 32, False),     # ragged tail
    (2, 50, 2, 32, 16, 128, True),      # S < chunk
    (1, 1, 2, 16, 8, 32, True),         # S = 1
    (1, 300, 2, 16, 32, 128, True),     # 3 chunks of 128, ragged
]


def inputs(b, s, h, p, n, with_h0, seed=0, decay=0.1):
    """x, B, C, log_a = -decay * dt, dt = softplus(normal), h0 and the
    cotangents dy, dh_last, as numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    dt = np.logaddexp(f(b, s, h), 0.0).astype(np.float32)
    return dict(x=f(b, s, h, p), bt=f(b, s, n), ct=f(b, s, n),
                log_a=(-decay * dt).astype(np.float32), dt=dt,
                h0=f(b, h, p, n) if with_h0 else None,
                dy=f(b, s, h, p), dh_last=f(b, h, p, n))


def jax_grads(fn, d, chunk, dtype=jnp.float32):
    """The vjp of ``fn`` (``ssd_chunked`` or a rewrite with its signature)
    at d's inputs (x, B, C in ``dtype``) for d's cotangents, jitted:
    (dx, dB, dC, dlog_a, ddt, dh0 or None) as numpy."""
    with_h0 = d["h0"] is not None

    def run(x, bt, ct, la, dt, h0, dy, dhl):
        def f(x, bt, ct, la, dt, h0):
            return fn(x, bt, ct, la, dt, chunk, h0 if with_h0 else None)
        _, vjp = jax.vjp(f, x, bt, ct, la, dt, h0)
        return vjp((dy, dhl))
    h0 = d["h0"] if with_h0 else np.zeros((1,), np.float32)
    args = [jnp.asarray(d[k]).astype(dtype) for k in ("x", "bt", "ct")]
    args += [jnp.asarray(v) for v in (d["log_a"], d["dt"], h0, d["dy"],
                                      d["dh_last"])]
    out = jax.jit(run)(*args)
    out = [np.asarray(g.astype(jnp.float32)) for g in out]
    return (*out[:5], out[5] if with_h0 else None)


def port_grads(d, chunk, dtype=torch.float32):
    t = {k: None if v is None else torch.from_numpy(v) for k, v in d.items()}
    for k in ("x", "bt", "ct"):
        t[k] = t[k].to(dtype)
    return tss.ssd_scan_bwd_plain(t["x"], t["bt"], t["ct"], t["log_a"],
                                  t["dt"], t["h0"], t["dy"], t["dh_last"],
                                  chunk=chunk)


def assert_close(got, want, tols):
    for name, g, w, tol in zip(NAMES, got, want, tols):
        if w is None:
            assert g is None, name
            continue
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all() and np.isfinite(w).all(), name
        top = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol * max(top, 1e-30), (name, err, top)


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", SHAPES)
def test_bwd_plain_matches_jax_vjp(b, s, h, p, n, chunk, with_h0):
    d = inputs(b, s, h, p, n, with_h0, seed=s + p)
    want = jax_grads(jssd.ssd_chunked, d, chunk)
    got = port_grads(d, chunk)
    assert_close(got, want, [GRAD_TOL] * 6)


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", [SHAPES[0], SHAPES[3],
                                                     SHAPES[6]])
def test_bwd_plain_matches_jax_vjp_in_bf16(b, s, h, p, n, chunk, with_h0):
    """bf16 x, B, C: the reference widens them with ``astype`` and its
    vjp rounds their gradients back to bf16; the port rounds its fp32
    gradients once, as the kernel does."""
    d = inputs(b, s, h, p, n, with_h0, seed=s + n)
    want = jax_grads(jssd.ssd_chunked, d, chunk, dtype=jnp.bfloat16)
    got = port_grads(d, chunk, dtype=torch.bfloat16)
    assert all(g.dtype == torch.bfloat16 for g in got[:3])
    assert_close(got, want, [BF16_TOL] * 3 + [GRAD_TOL] * 3)


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", SHAPES)
def test_bwd_plain_matches_autograd_of_the_plain_forward(b, s, h, p, n,
                                                         chunk, with_h0):
    d = inputs(b, s, h, p, n, with_h0, seed=s + h)
    leaves = [torch.from_numpy(d[k]).requires_grad_(True)
              for k in ("x", "bt", "ct", "log_a", "dt", "h0")
              if d[k] is not None]
    y, hl = tss.ssd_scan_plain(*leaves[:5],
                               leaves[5] if with_h0 else None, chunk=chunk)
    want = torch.autograd.grad(
        (y * torch.from_numpy(d["dy"])).sum()
        + (hl * torch.from_numpy(d["dh_last"])).sum(), leaves)
    want = [*want, None] if not with_h0 else want
    assert_close(port_grads(d, chunk), want, [GRAD_TOL] * 6)


def test_bwd_plain_takes_no_dh_last_as_zero():
    d = inputs(2, 130, 2, 16, 32, True, seed=4)
    got = port_grads(dict(d, dh_last=None), 64)
    want = port_grads(dict(d, dh_last=np.zeros_like(d["dh_last"])), 64)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _x64():
    """A context with JAX's 64-bit types on (``jax.enable_x64`` here,
    ``jax.experimental.enable_x64`` in older JAX)."""
    ctx = getattr(jax, "enable_x64", None)
    if ctx is not None:
        return ctx(True)
    from jax.experimental import enable_x64
    return enable_x64()


def ssd_chunked_masked(xh, bt, ct, log_a, dt, chunk, h0=None):
    """``repro/models/ssd.py::ssd_chunked`` with the mask on the exponent
    (exp(where(mask, decay, -inf)) in place of where(mask, exp(decay),
    0)), in the dtype of its inputs: this file's oracle."""
    b, s, h, p = xh.shape
    n = bt.shape[-1]
    l = chunk
    pad = -s % l
    if pad:
        z = lambda t: jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
        y, h_last = ssd_chunked_masked(z(xh), z(bt), z(ct), z(log_a), z(dt),
                                       l, h0)
        return y[:, :s], h_last
    nc = s // l
    xh = xh.reshape(b, nc, l, h, p)
    bt = bt.reshape(b, nc, l, n)
    ct = ct.reshape(b, nc, l, n)
    log_a = log_a.reshape(b, nc, l, h)
    dt = dt.reshape(b, nc, l, h)
    cum = jnp.cumsum(log_a, axis=2)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = jnp.tril(jnp.ones((l, l), bool))[None, None, :, :, None]
    m = jnp.exp(jnp.where(mask, decay, -jnp.inf))
    cb = jnp.einsum("bcin,bcjn->bcij", ct, bt)
    y_intra = jnp.einsum("bcijh,bcjh,bcjhp->bcihp", cb[..., None] * m, dt, xh)
    dec_out = jnp.exp(cum[:, :, -1:, :] - cum)
    s_c = jnp.einsum("bclh,bclh,bclhp,bcln->bchpn", dec_out, dt, xh, bt)
    a_c = jnp.exp(cum[:, :, -1, :])
    state = (jnp.zeros((b, h, p, n), xh.dtype) if h0 is None else h0)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = a_c[:, c, :, None, None] * state + s_c[:, c]
    h_prev = jnp.stack(prev, axis=1)
    y_inter = jnp.einsum("bclh,bchpn,bcln->bclhp", jnp.exp(cum), h_prev, ct)
    return (y_intra + y_inter).reshape(b, s, h, p), state


@pytest.mark.parametrize("log_a", [-1.0, -2.0])
def test_overflow_regime_reference_nan_port_finite(log_a):
    """Chunk 128 at a constant log_a: above the diagonal cum_i - cum_j
    reaches 127 |log_a|, past exp's float32 range from |log_a| ~ 0.7. The
    reference's dlog_a is non-finite; the port's is finite and matches the
    float64 oracle within 1e-5 of its max, and so do its other
    gradients."""
    b, s, h, p, n, chunk = 1, 256, 2, 16, 32, 128
    d = inputs(b, s, h, p, n, True, seed=11)
    d["log_a"] = np.full((b, s, h), log_a, np.float32)
    ref = jax_grads(jssd.ssd_chunked, d, chunk)
    assert not np.isfinite(ref[3]).all()
    got = port_grads(d, chunk)
    with _x64():
        d64 = {k: v.astype(np.float64) for k, v in d.items()}
        oracle = jax_grads(ssd_chunked_masked, d64, chunk,
                           dtype=jnp.float64)
    assert_close(got, oracle, [GRAD_TOL] * 6)
    # where the reference is finite it agrees too
    for g, w in zip(got, ref):
        w = np.asarray(w)
        if np.isfinite(w).all():
            top = float(np.abs(w).max())
            assert float(np.abs(g.numpy() - w).max()) <= GRAD_TOL * top


def test_mamba2_layer_gradient_finite_where_reference_is_not():
    """One ``ssd_fwd`` layer of mamba2-1.3b cut to d_model 256 (P 64, N
    128, chunk 128 kept), parameters from the reference's ``init_ssd`` (A
    in [1, 16], dt_bias in [-6.9, -2.25]) over a unit-normal input of 256
    tokens: its chunks reach a mean |log_a| past 1. The reference's
    gradients of a_log, dt_bias, in_proj and the input are non-finite; the
    port's are finite everywhere, and conv, d_skip, norm_z and out_proj
    (which the overflow does not reach) agree within 1e-4 of their max."""
    jc = dataclasses.replace(JARCHS["mamba2-1.3b"].reduced(), ssm_chunk=128,
                             ssm_head_dim=64, ssm_state=128)
    tc = dataclasses.replace(TARCHS["mamba2-1.3b"].reduced(), ssm_chunk=128,
                             ssm_head_dim=64, ssm_state=128)
    jp = jax.device_get(jssd.init_ssd(jax.random.PRNGKey(3), jc,
                                      jnp.float32))
    x = np.random.default_rng(4).standard_normal(
        (2, 256, jc.d_model)).astype(np.float32)

    def jloss(params, xx):
        out = jssd.ssd_fwd(params, xx, jc)
        return jnp.sum(out * out)
    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tssd.ssd_fwd(tp, tx, tc)
    tg = torch.autograd.grad((out * out).sum(), [*tp.values(), tx])
    tg = dict(zip([*tp, "x"], tg))
    jg = dict(jg, x=jgx)
    for k in ("a_log", "dt_bias", "in_proj", "x"):
        assert not np.isfinite(np.asarray(jg[k])).all(), k
    for k, g in tg.items():
        assert bool(torch.isfinite(g).all()), k
    for k in ("conv", "d_skip", "norm_z", "out_proj"):
        w = np.asarray(jg[k])
        assert np.isfinite(w).all(), k
        top = float(np.abs(w).max())
        assert float(np.abs(tg[k].numpy() - w).max()) <= 1e-4 * top, k


@pytest.mark.parametrize("b,s,h,p,n,chunk,with_h0", [SHAPES[0], SHAPES[4],
                                                     SHAPES[6]])
def test_plain_forward_is_bitwise_the_unmasked_exponent(monkeypatch, b, s, h,
                                                        p, n, chunk,
                                                        with_h0):
    """exp(where(mask, d, -inf)) equals where(mask, exp(d), 0) bitwise
    (exp(-inf) = 0), so moving the mask left the forward as it was."""
    d = inputs(b, s, h, p, n, with_h0, seed=7, decay=1.0)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in d.items()}
    args = (t["x"], t["bt"], t["ct"], t["log_a"], t["dt"], t["h0"])
    y, hl = tss.ssd_scan_plain(*args, chunk=chunk)

    def unmasked(cum, mask):
        return torch.where(mask, torch.exp(cum[..., :, None]
                                           - cum[..., None, :]), 0.0)
    monkeypatch.setattr(tss, "_causal_decay", unmasked)
    y0, hl0 = tss.ssd_scan_plain(*args, chunk=chunk)
    assert torch.equal(y, y0) and torch.equal(hl, hl0)
