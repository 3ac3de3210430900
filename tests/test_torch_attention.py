"""The port's attention against the JAX package's, on the CPU.

* The plain flash version (``repro_torch.kernels.flash_attention``) against
  the JAX Pallas kernel in interpret mode, at the five shapes of
  ``tests/test_kernels.py::test_flash_attention``: fp32 to rtol = atol =
  2e-5, bf16 to 2e-2 (the same tolerances as the reference's own test).
* Rows with no live key (S > T with a causal window): the port gives the
  dense oracle's value, the mean of v over the T keys, on every row; the
  JAX kernel agrees on the rows that have a live key and gives a value
  that depends on its tiling on the others (a reference caveat).
* The arithmetic of the card's bf16 kernel, emulated here (kv tiles of
  128 keys, 64 at D 256; online softmax in fp32; p rounded to bf16 before
  P.V; a row whose keys are all masked so far takes 0 as its reference),
  against the JAX kernel in interpret mode in bf16 at the five shapes and
  at D 256 with a window and with a soft cap, to the bf16 tolerance: the
  rounding of p fits the tolerance the card tests hold the kernel to.
* ``models.attention.full_attention`` for modes bidir / causal / local
  (GQA, with and without a soft cap) against the reference's from the same
  parameters, to 2e-5.
* ``decode_attention`` at a position past the end of a full-context cache
  raises (the reference clamps the slot: a reference caveat, not copied),
  for an int and for a tensor position, and leaves the cache untouched;
  the local ring takes the same position.
* The backward: ``flash_attention_bwd_plain`` (P recomputed from the
  forward's row log-sum-exp) against ``jax.vjp`` of
  ``repro/kernels/ref.py::attention_ref`` at bidir, causal, windowed
  (with rows that have no live key), soft-capped, GQA and ragged S/T
  shapes, head dims 8, 24 and 64, to 2e-5 of each gradient's largest
  magnitude; ``lse`` against a logsumexp of the reference's scores;
  ``torch.autograd.grad`` through ``flash_attention`` (its
  ``autograd.Function``, no kernel launch on the CPU) equal to autograd
  through ``flash_attention_plain`` to 1e-6 of the largest magnitude.
* The forward at the head dims the card now also takes (8, 16, 24) and at
  ``benchmarks/common.py``'s ``minilm`` encoder shape (B 64, H 4, S = T =
  32, D 24) against the JAX kernel in interpret mode.

Inputs are made with numpy from a seed and handed to both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jattn
from repro.models import config as jconfig
from repro_torch import kernels
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import config as tconfig

torch.set_num_threads(2)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SHAPES = [
    # b, h, kv, s, t, d, causal, window, cap (tests/test_kernels.py:23-29)
    (2, 4, 2, 256, 256, 64, True, 0, 0.0),
    (1, 4, 1, 200, 200, 64, True, 64, 0.0),
    (2, 2, 2, 128, 384, 128, False, 0, 50.0),
    (1, 8, 8, 64, 64, 128, True, 0, 30.0),
    (1, 2, 1, 384, 130, 64, True, 0, 0.0),
]


def qkv(b, h, kv, s, t, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, s, d), dtype=np.float32),
            rng.standard_normal((b, kv, t, d), dtype=np.float32),
            rng.standard_normal((b, kv, t, d), dtype=np.float32))


def both(arrays, dtype):
    """The same numpy inputs as JAX arrays and torch tensors of ``dtype``
    (both round float32 to bf16 to nearest even)."""
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap", SHAPES)
def test_plain_flash_matches_jax_kernel(b, h, kv, s, t, d, causal, window,
                                        cap, dtype):
    (jq, jk, jv), (tq, tk, tv) = both(qkv(b, h, kv, s, t, d), dtype)
    want = jax_flash(jq, jk, jv, causal=causal, window=window, softcap=cap)
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window,
                              softcap=cap)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, h, s, d)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


def test_rows_without_live_key_take_the_mean_of_v():
    """S 300, T 100, causal, window 4: rows i >= T + window - 1 = 103 have
    no live key. The port gives the oracle's mean of v there and matches
    the oracle on every row; the JAX kernel matches on rows 0-102 only."""
    b, h, kv, s, t, d, window = 1, 2, 1, 300, 100, 64, 4
    (jq, jk, jv), (tq, tk, tv) = both(qkv(b, h, kv, s, t, d, seed=3),
                                      "float32")
    got = f32(tfa.flash_attention(tq, tk, tv, causal=True, window=window))
    oracle = f32(jref.attention_ref(jq, jk, jv, causal=True, window=window))
    kern = f32(jax_flash(jq, jk, jv, causal=True, window=window))
    np.testing.assert_allclose(got, oracle, **TOL["float32"])
    live = t + window - 1
    np.testing.assert_allclose(got[:, :, :live], kern[:, :, :live],
                               **TOL["float32"])
    mean_v = f32(tv).mean(axis=2)                       # (b, kv, d)
    np.testing.assert_allclose(got[0, :, live:],
                               np.broadcast_to(mean_v[0, 0],
                                               (h, s - live, d)),
                               **TOL["float32"])
    # the reference caveat: the TPU kernel's value there is not the mean
    assert np.abs(kern[:, :, live:] - got[:, :, live:]).max() > 0.05


def test_plain_flash_counts_no_launch_and_keeps_dtype():
    kernels.reset_launch_counts()
    _, (tq, tk, tv) = both(qkv(1, 2, 1, 8, 8, 32), "bfloat16")
    out = tfa.flash_attention(tq, tk, tv, causal=False)
    assert out.dtype == torch.bfloat16
    assert kernels.launch_counts()["flash_attention"] == 0


def bf16_p_attention(q, k, v, *, causal, window, softcap):
    """The bf16 kernel's arithmetic (``csrc/flash_attention.cu``,
    ``flash_attention_kernel_sm90``) on the CPU, in fp32 on bf16 inputs:
    scores per kv tile, then scale, soft cap and the index mask; running
    max and sum in fp32 (the sum of the unrounded p); p rounded to bf16
    for P.V, accumulated in fp32; rows with no live key the mean of v."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    g = h // kvh
    bk = 64 if d >= 256 else 128
    q, k, v = q.float(), k.float().repeat_interleave(g, 1), \
        v.float().repeat_interleave(g, 1)
    mask = tfa.live_mask(s, t, causal=causal, window=window, device="cpu")
    m = torch.full((b, h, s), -torch.inf)
    l = torch.zeros((b, h, s))
    o = torch.zeros((b, h, s, d))
    for k0 in range(0, t, bk):
        sc = torch.einsum("bhsd,bhtd->bhst", q, k[:, :, k0:k0 + bk]) \
            * d ** -0.5
        if softcap:
            sc = softcap * torch.tanh(sc / softcap)
        sc = torch.where(mask[:, k0:k0 + bk], sc, -torch.inf)
        m_new = torch.maximum(m, sc.amax(-1))
        ref = torch.where(m_new == -torch.inf, 0.0, m_new)
        p = torch.exp(sc - ref[..., None])
        alpha = torch.exp(m - ref)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum(
            "bhst,bhtd->bhsd", p.to(torch.bfloat16).float(),
            v[:, :, k0:k0 + bk])
        m = m_new
    out = o / l[..., None]
    dead = ~mask.any(-1)
    out[:, :, dead] = v.mean(dim=2)[:, :, None]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap", SHAPES + [
    (1, 4, 2, 300, 300, 256, True, 96, 0.0),
    (1, 4, 2, 200, 260, 256, False, 0, 50.0)])
def test_bf16_kernel_numerics_plan_fits_the_bf16_tolerance(b, h, kv, s, t,
                                                           d, causal,
                                                           window, cap):
    (jq, jk, jv), (tq, tk, tv) = both(qkv(b, h, kv, s, t, d, seed=d + s),
                                      "bfloat16")
    want = jax_flash(jq, jk, jv, causal=causal, window=window, softcap=cap)
    got = bf16_p_attention(tq, tk, tv, causal=causal, window=window,
                           softcap=cap)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["bfloat16"])


def test_bf16_numerics_plan_gives_dead_rows_the_mean_of_v():
    """S 300, T 100, window 4: the emulation's rows with no live key are
    the oracle's mean of v, and every row matches the oracle in bf16."""
    (jq, jk, jv), (tq, tk, tv) = both(qkv(1, 2, 1, 300, 100, 64, seed=3),
                                      "bfloat16")
    got = f32(bf16_p_attention(tq, tk, tv, causal=True, window=4,
                               softcap=0.0))
    oracle = f32(jref.attention_ref(jq, jk, jv, causal=True, window=4))
    np.testing.assert_allclose(got, oracle, **TOL["bfloat16"])


def port_config(jc):
    """The port's ``ModelConfig`` from the reference's, field for field."""
    fields = {f.name: getattr(jc, f.name)
              for f in dataclasses.fields(jconfig.ModelConfig)}
    for f in ("pattern", "remainder", "enc_pattern"):
        fields[f] = tuple(tconfig.LayerSpec(s.mixer, s.ffn)
                          for s in fields[f])
    return tconfig.ModelConfig(**fields)


def attn_config(cap):
    return jconfig.ModelConfig(
        name="attn-test", family="dense", d_model=96, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=0, vocab_size=8,
        pattern=(jconfig.LayerSpec(jconfig.MIXER_GLOBAL_ATTN,
                                   jconfig.FFN_MLP),),
        n_units=1, window=5, attn_softcap=cap, dtype="float32")


def attn_params(cfg, seed):
    rng = np.random.default_rng(seed)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    shapes = dict(wq=(d, h, hd), wk=(d, kv, hd), wv=(d, kv, hd),
                  wo=(h, hd, d))
    return {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("cap", [0.0, 20.0])
@pytest.mark.parametrize("mode", ["bidir", "causal", "local"])
def test_full_attention_matches_reference(mode, cap):
    jc = attn_config(cap)
    tc = port_config(jc)
    assert tc.hd == jc.hd == 32
    params = attn_params(jc, seed=7)
    rng = np.random.default_rng(8)
    b, s = 2, 24
    x = rng.standard_normal((b, s, jc.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    want = jattn.full_attention({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(x), jnp.asarray(pos), jc,
                                mode=mode, window=jc.window)
    got = tattn.full_attention({k: torch.from_numpy(v)
                                for k, v in params.items()},
                               torch.from_numpy(x), torch.from_numpy(pos),
                               tc, mode=mode, window=tc.window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_full_attention_raises_for_later_slices():
    tc = port_config(attn_config(0.0))
    p = {k: torch.from_numpy(v) for k, v in attn_params(tc, 0).items()}
    x = torch.zeros((1, 4, tc.d_model))
    pos = torch.arange(4)[None]
    with pytest.raises(NotImplementedError):
        tattn.full_attention(p, x, pos, tc, mode="cross", kv_src=x)
    with pytest.raises(NotImplementedError):
        tattn.full_attention(p, x, pos,
                             dataclasses.replace(tc, attn_q_chunk=2),
                             mode="causal")
    with pytest.raises(ValueError, match="window"):
        tattn.full_attention(p, x, pos, tc, mode="local", window=0)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_decode_past_a_full_cache_raises(as_tensor):
    """cache_len 4: positions 0-3 decode, position 4 raises one clear error
    (ValueError for an int; the asynchronous assert's RuntimeError for a
    tensor, on the CPU) before anything is written; mode 'local' wraps."""
    tc = port_config(attn_config(0.0))
    p = {k: torch.from_numpy(v) for k, v in attn_params(tc, 1).items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 1, tc.d_model)).astype(np.float32))
    cache = tattn.init_kv_cache(2, 4, tc, torch.float32, "cpu")
    at = (lambda i: torch.tensor(i)) if as_tensor else (lambda i: i)
    for i in range(4):
        out, cache = tattn.decode_attention(p, x, cache, at(i), tc,
                                            mode="causal")
        assert bool(torch.isfinite(out).all())
    before = {k: v.clone() for k, v in cache.items()}
    with pytest.raises(RuntimeError if as_tensor else ValueError,
                       match="past the end"):
        tattn.decode_attention(p, x, cache, at(4), tc, mode="causal")
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    ring = tattn.init_kv_cache(2, 4, tc, torch.float32, "cpu")
    _, ring = tattn.decode_attention(p, x, ring, at(4), tc, mode="local",
                                     window=4)
    assert ring["slot_pos"].tolist() == [4, -1, -1, -1]


BWD_SHAPES = [
    # b, h, kv, s, t, d, causal, window, cap
    (2, 4, 2, 40, 40, 8, False, 0, 0.0),      # bidir, GQA
    (1, 4, 1, 37, 53, 24, True, 0, 0.0),      # causal, ragged S/T
    (1, 2, 1, 70, 30, 64, True, 5, 0.0),      # window: rows 34.. no live key
    (1, 2, 2, 50, 20, 8, False, 4, 0.0),      # bidir window: rows 23.. dead
    (2, 2, 2, 33, 45, 24, False, 9, 30.0),    # window and soft cap
    (1, 4, 2, 48, 48, 64, True, 0, 20.0),     # causal, soft cap, GQA
]


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap", BWD_SHAPES)
def test_plain_backward_matches_jax_vjp_of_attention_ref(b, h, kv, s, t, d,
                                                         causal, window,
                                                         cap):
    arrays = qkv(b, h, kv, s, t, d, seed=s + d)
    do = np.random.default_rng(7).standard_normal((b, h, s, d),
                                                  dtype=np.float32)
    (jq, jk, jv), (tq, tk, tv) = both(arrays, "float32")
    kw = dict(causal=causal, window=window, softcap=cap)
    want, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(q, k, v, **kw),
                        jq, jk, jv)
    grads = vjp(jnp.asarray(do))
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, **kw)
    np.testing.assert_allclose(f32(o), f32(want), **TOL["float32"])
    # lse: logsumexp over the live keys of the scaled, capped scores
    qr = np.asarray(jq).reshape(b, kv, h // kv, s, d)
    sc = np.einsum("bkgsd,bktd->bkgst", qr, np.asarray(jk)) * d ** -0.5
    if cap:
        sc = cap * np.tanh(sc / cap)
    mask = tfa.live_mask(s, t, causal=causal, window=window,
                         device="cpu").numpy()
    with np.errstate(divide="ignore"):
        ref_lse = np.log(np.where(mask, np.exp(sc), 0.0).sum(-1))
    got_lse = lse.numpy().reshape(ref_lse.shape)
    np.testing.assert_allclose(got_lse, ref_lse, rtol=1e-5, atol=1e-5)
    dead = ~mask.any(-1)
    assert (dead.any() == bool(window and s > t + window - 1))
    assert np.isneginf(got_lse[..., dead]).all()
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse,
                                        torch.from_numpy(do), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, grads):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        err = np.abs(g.numpy() - w).max()
        assert err <= 2e-5 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap", BWD_SHAPES[1:4])
def test_autograd_through_flash_attention_equals_plain_autograd(
        b, h, kv, s, t, d, causal, window, cap):
    """On the CPU, gradients through ``flash_attention`` go through its
    ``autograd.Function`` and the plain backward, launch no kernel, and
    equal autograd through the plain forward; (B,S,H,D) views in, as the
    model passes them."""
    kernels.reset_launch_counts()
    rng = np.random.default_rng(9)
    mk = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape, dtype=np.float32)).transpose(1, 2).requires_grad_(True)
    q, k, v = mk(b, s, h, d), mk(b, t, kv, d), mk(b, t, kv, d)
    kw = dict(causal=causal, window=window, softcap=cap)
    out = tfa.flash_attention(q, k, v, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    do = torch.from_numpy(rng.standard_normal(out.shape, dtype=np.float32))
    got = torch.autograd.grad(out, (q, k, v), do)
    ref = tfa.flash_attention_plain(q, k, v, **kw)
    want = torch.autograd.grad(ref, (q, k, v), do)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max())
    assert kernels.launch_counts()["flash_attention"] == 0
    assert kernels.launch_counts()["flash_attention_bwd"] == 0
    with torch.no_grad():                  # no graph: the plain forward
        assert tfa.flash_attention(q, k, v, **kw).grad_fn is None


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window", [
    (2, 4, 2, 40, 40, 8, False, 0),
    (1, 4, 2, 50, 50, 16, True, 7),
    (1, 4, 1, 37, 53, 24, True, 0),
    (64, 4, 4, 32, 32, 24, False, 0),      # the minilm encoder's attention
])
def test_plain_flash_matches_jax_kernel_at_small_head_dims(b, h, kv, s, t, d,
                                                           causal, window):
    (jq, jk, jv), (tq, tk, tv) = both(qkv(b, h, kv, s, t, d), "float32")
    got = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = jax_flash(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])
    assert tfa.kernel_head_dim(d) == 32
