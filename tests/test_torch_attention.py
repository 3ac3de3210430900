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
  parameters, to 2e-5; mode 'cross' over a memory of T 37 keys for S 24
  queries (no RoPE, no mask) and ``decode_attention``'s mode 'cross' the
  same; ``cfg.attn_q_chunk`` 16 at S 64 against the reference's blockwise
  loop with the same config.
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
* The backward kernel's plans (``bwd_plan``): Small at the encoders'
  shapes (``EncoderConfig()``, e5b, minilm), Large at qwen2-7b's heads; a
  forced Small past its key tile raises ``ValueError``; the part table
  the kernels read is ``bwd_parts``, a partition of each key tile's walk;
  the dK/dV blocks of each plan (and Small's fused dQ) meet every live
  (head, row, key) pair exactly once (causal, windows with dead rows,
  GQA, ragged S/T); and Large's split walk with its ordered sum of
  partials, emulated here from the table, against
  ``flash_attention_bwd_plain`` and ``jax.vjp`` of ``attention_ref``.
* The Hopper design (``BWD_SM90``, ``csrc/flash_attention_bwd_sm90.cu``):
  the plan takes it at every model's bf16 heads (head dims 64, 128 and
  256) and nowhere else, refuses it where it cannot run, and its two passes
  meet every live pair exactly once; its arithmetic, emulated here in fp32
  on bf16 inputs (its tiles and summation order, P and dS rounded to bf16
  before their products, dP and every sum in fp32), against ``jax.vjp`` of
  the reference's ``_attend`` in bf16 and against the fp32 gradients, to
  2e-2 of each gradient's largest magnitude (the card tests' tolerance).

Inputs are made with numpy from a seed and handed to both sides.
"""
import dataclasses
import types
from pathlib import Path

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
from repro_torch.configs import ARCHS as TARCHS
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


def test_full_attention_local_mode_needs_a_window():
    tc = port_config(attn_config(0.0))
    p = {k: torch.from_numpy(v) for k, v in attn_params(tc, 0).items()}
    x = torch.zeros((1, 4, tc.d_model))
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="window"):
        tattn.full_attention(p, x, pos, tc, mode="local", window=0)


def test_full_attention_refuses_a_memory_outside_mode_cross():
    """A memory belongs to mode 'cross', which needs one."""
    tc = port_config(attn_config(0.0))
    p = {k: torch.from_numpy(v) for k, v in attn_params(tc, 0).items()}
    x = torch.zeros((1, 4, tc.d_model))
    pos = torch.arange(4)[None]
    with pytest.raises(ValueError, match="kv_src"):
        tattn.full_attention(p, x, pos, tc, mode="causal", kv_src=x)
    with pytest.raises(ValueError, match="kv_src"):
        tattn.full_attention(p, x, pos, tc, mode="cross")


def cross_inputs(jc, s=24, t=37, seed=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, t, jc.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    kv_pos = np.tile(np.arange(t, dtype=np.int32), (2, 1))
    return x, mem, pos, kv_pos


def with_bias(params, cfg, seed):
    """The projections with non-zero QKV biases, as a qkv_bias model's."""
    rng = np.random.default_rng(seed)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return dict(params, **{k: (0.1 * rng.standard_normal(s)).astype(
        np.float32) for k, s in (("bq", (h, hd)), ("bk", (kv, hd)),
                                 ("bv", (kv, hd)))})


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("cap", [0.0, 20.0])
def test_cross_attention_matches_reference(cap, bias):
    """Mode 'cross', S 24 queries over T 37 memory keys, GQA."""
    jc = attn_config(cap)
    tc = port_config(jc)
    params = attn_params(jc, seed=10)
    if bias:
        params = with_bias(params, jc, 11)
    x, mem, pos, kv_pos = cross_inputs(jc)
    want = jattn.full_attention({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(x), jnp.asarray(pos), jc,
                                mode="cross", kv_src=jnp.asarray(mem),
                                kv_positions=jnp.asarray(kv_pos))
    got = tattn.full_attention({k: torch.from_numpy(v)
                                for k, v in params.items()},
                               torch.from_numpy(x), torch.from_numpy(pos), tc,
                               mode="cross", kv_src=torch.from_numpy(mem),
                               kv_positions=torch.from_numpy(kv_pos))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


@pytest.mark.parametrize("cap", [0.0, 20.0])
def test_cross_decode_attention_matches_reference(cap):
    """Decode mode 'cross': one token over the memory, soft cap applied,
    the cache returned untouched."""
    jc = attn_config(cap)
    tc = port_config(jc)
    params = with_bias(attn_params(jc, seed=12), jc, 13)
    x, mem, _, _ = cross_inputs(jc, s=1)
    jcache = jattn.init_kv_cache(2, 4, jc, jnp.float32)
    tcache = tattn.init_kv_cache(2, 4, tc, torch.float32, "cpu")
    want, wc = jattn.decode_attention(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jcache, jnp.int32(3), jc, mode="cross", enc_memory=jnp.asarray(mem))
    got, gc = tattn.decode_attention(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), tcache, 3, tc, mode="cross",
        enc_memory=torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    assert gc is tcache and bool((gc["slot_pos"] == -1).all())
    assert not bool(gc["k"].any()) and not bool(gc["v"].any())


@pytest.mark.parametrize("mode", ["bidir", "causal", "local"])
def test_attn_q_chunk_matches_reference(mode):
    """``attn_q_chunk`` 16 at S 64: the reference attends in 4 query
    blocks; the port's flash path gives the same rows."""
    jc = dataclasses.replace(attn_config(20.0), attn_q_chunk=16)
    tc = port_config(jc)
    assert tc.attn_q_chunk == 16
    params = attn_params(jc, seed=14)
    x, _, pos, _ = cross_inputs(jc, s=64, seed=15)
    want = jattn.full_attention({k: jnp.asarray(v) for k, v in params.items()},
                                jnp.asarray(x), jnp.asarray(pos), jc,
                                mode=mode, window=jc.window)
    got = tattn.full_attention({k: torch.from_numpy(v)
                                for k, v in params.items()},
                               torch.from_numpy(x), torch.from_numpy(pos), tc,
                               mode=mode, window=tc.window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


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


# ---------------------------------------------------------------------------
# the backward's plans (csrc/flash_attention_bwd.cu), emulated on the CPU
# ---------------------------------------------------------------------------

ENCODERS = {
    # b, h, kv, s, t, d: benchmarks/common.py's encoders at 64 pairs a step
    "main": (64, 4, 4, 64, 64, 64),      # EncoderConfig()
    "e5b": (64, 4, 4, 32, 32, 32),
    "minilm": (64, 4, 4, 32, 32, 24),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_bwd_plan_takes_small_at_the_encoders(name):
    plan = tfa.bwd_plan(*ENCODERS[name], False, 0)
    assert plan.cfg == tfa.BWD_SMALL and plan.launches == 1
    assert plan.parts == 1 and plan.keys >= ENCODERS[name][4]


def test_bwd_plan_takes_large_at_qwen2_heads():
    plan = tfa.bwd_plan(1, 28, 4, 2048, 2048, 128, True, 0)
    assert plan.cfg == tfa.BWD_LARGE and (plan.keys, plan.rows) == (64, 64)
    # the causal walks are cut: more parts than key tiles, so four launches
    assert plan.parts > 2048 // 64 and plan.launches == 4
    parts = tfa.bwd_parts(2048, 2048, 7, plan, causal=True, window=0)
    assert len(parts) == plan.parts
    assert max(row[4] - row[3] for row in parts) <= plan.steps_per_part


@pytest.mark.parametrize("b,h,kv,s,t,d,cfg", [
    (1, 4, 1, 64, 64, 64, 1),       # a 4-step walk on one block: Large
    (64, 4, 1, 64, 64, 64, 1),      # 64 blocks: still Large
    (128, 4, 1, 64, 64, 64, 0),     # 128 blocks, about one an SM: Small
    (1, 2, 1, 64, 64, 128, 0),      # a 2-step walk: Small on any grid
    (1, 16, 1, 32, 32, 64, 0),      # T <= 32: Large would pad its 64 keys
    (1, 16, 1, 32, 32, 256, 1),     # ... but not at head dim 256
    (256, 32, 1, 64, 64, 64, 1),    # a 32-step walk: past the sweep
    (128, 4, 1, 100, 40, 32, 0),    # two row tiles a head, 8 steps
])
def test_bwd_plan_small_where_the_sweep_found_it_faster(b, h, kv, s, t, d,
                                                        cfg):
    """Small's bounds, set by ``tools/bwd_variants.py --sweep``: its walk
    at most 16 steps, and T <= 32 below head dim 256, or a walk of at most
    2 steps, or at least 128 blocks."""
    assert tfa.bwd_plan(b, h, kv, s, t, d, False, 0).cfg == cfg


@pytest.mark.parametrize("t,d,ok", [(64, 64, True), (65, 64, False),
                                    (64, 128, True), (65, 128, False),
                                    (32, 256, True), (33, 256, False),
                                    (1, 8, True)])
def test_bwd_plan_forced_small_raises_where_it_cannot_run(t, d, ok):
    """Small holds every key in one tile: 64 up to head dim 128, 32 at
    256; forced past that it raises ``ValueError``, as does an unknown
    configuration. Large takes every shape."""
    if ok:
        assert tfa.bwd_plan(2, 4, 2, 40, t, d, True, 0, cfg=0).cfg == 0
    else:
        with pytest.raises(ValueError, match="Small takes at most"):
            tfa.bwd_plan(2, 4, 2, 40, t, d, True, 0, cfg=0)
        assert tfa.bwd_plan(2, 4, 2, 40, t, d, True, 0).cfg == 1
    assert tfa.bwd_plan(2, 4, 2, 40, t, d, True, 0, cfg=1).cfg == 1
    with pytest.raises(ValueError, match="no configuration"):
        tfa.bwd_plan(2, 4, 2, 40, t, d, True, 0, cfg=3)


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_bwd_part_table_partitions_each_walk(d):
    """The table the kernels read (``_part_table``; here on the CPU) is
    ``bwd_parts`` as int32 rows of ``BWD_PART_INTS``: each key tile's
    parts are contiguous, name their first part and their count, and cut
    its walk of (group heads x row tiles) steps into consecutive pieces
    that cover it once; a key tile no row reaches has one empty part."""
    s, t, group = 200, 330, 3           # key tiles past row 199 see no row
    plan = tfa.bwd_plan(1, group * 2, 2, s, t, d, True, 0, cfg=1,
                        steps_per_part=5)
    parts = tfa.bwd_parts(s, t, group, plan, causal=True, window=0)
    table = tfa._part_table(s, t, group, plan, True, 0, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.is_contiguous()
    assert table.shape == (plan.parts, tfa.BWD_PART_INTS) == \
        (len(parts), tfa.BWD_PART_INTS)
    assert table[:, :7].tolist() == [list(r) for r in parts]
    assert not table[:, 7:].any()
    n_tiles = -(-t // plan.keys)
    assert [r[0] for r in parts] == sorted(r[0] for r in parts)
    assert {r[0] for r in parts} == set(range(n_tiles))
    for jt in range(n_tiles):
        rows = [(i, r) for i, r in enumerate(parts) if r[0] == jt]
        first = rows[0][0]
        assert [i for i, _ in rows] == list(range(first, first + len(rows)))
        assert all(r[5] == first and r[6] == len(rows) for _, r in rows)
        t_lo, n_rows = rows[0][1][1], rows[0][1][2]
        assert all((r[1], r[2]) == (t_lo, n_rows) for _, r in rows)
        assert t_lo == jt * plan.keys // plan.rows      # causal: from the diagonal
        assert n_rows > 0 or len(rows) == 1
        steps = [n for _, r in rows for n in range(r[3], r[4])]
        assert steps == list(range(group * n_rows))
        assert all(r[4] - r[3] <= plan.steps_per_part for _, r in rows)


COVER_SHAPES = [
    # b, h, kv, s, t, d, causal, window
    (1, 4, 2, 130, 130, 32, True, 0),     # causal GQA
    (1, 2, 2, 97, 150, 64, False, 0),     # ragged S < T
    (1, 6, 2, 150, 70, 64, True, 0),      # S > T, group 3
    (1, 4, 1, 200, 90, 128, True, 20),    # window: rows 109.. dead
    (1, 2, 1, 70, 33, 256, False, 9),     # bidir window, D 256 tiles
    (2, 8, 2, 64, 64, 64, False, 0),      # the encoders' shape, group 4
    (1, 4, 2, 400, 300, 128, True, 150),  # causal window over 3 key tiles
    (1, 2, 1, 300, 260, 64, False, 40),   # bidir window: row 299 dead
]


def _sm90_q_tiles(s, t, d, causal, window):
    """The Hopper design's dQ pass as its kernel walks it: (rows, keys) of
    each key tile a block of ``BWD_SM90_QUERY_ROWS`` rows visits (the keys
    [k_lo, k_hi) live for some row of the block, in tiles of 128 keys at
    head dim 64, 64 at 128, 32 at 256)."""
    qr, qk = tfa.BWD_SM90_QUERY_ROWS, {64: 128, 128: 64, 256: 32}[d]
    out = []
    for q0 in range(0, s, qr):
        q_last = min(q0 + qr, s) - 1
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        k_hi = min(t, q_last + 1) if causal else t
        if k_hi <= k_lo:
            continue
        for n in range(k_lo // qk, -(-k_hi // qk)):
            out.append((slice(q0, min(s, q0 + qr)),
                        slice(n * qk, min(t, n * qk + qk))))
    return out


def _cover(s, t, group, causal, window, plan, d=64):
    """How many times each (head of the group, row, key) pair is met by
    the plan's dK/dV parts, read from its part table as the kernel reads
    it, and (Small) by its fused dQ or (the Hopper design) its dQ pass."""
    kv_hits = np.zeros((group, s, t), np.int32)
    q_hits = np.zeros((group, s, t), np.int32)
    live = tfa.live_mask(s, t, causal=causal, window=window,
                         device="cpu").numpy()
    for jt, t_lo, n_rows, lo, hi, _, _ in tfa.bwd_parts(
            s, t, group, plan, causal=causal, window=window):
        keys = slice(jt * plan.keys, min(t, jt * plan.keys + plan.keys))
        for n in range(lo, hi):
            gi, rt = n // n_rows, t_lo + n % n_rows
            rows = slice(rt * plan.rows, min(s, rt * plan.rows + plan.rows))
            kv_hits[gi, rows, keys] += live[rows, keys]
            if plan.cfg == tfa.BWD_SMALL:
                q_hits[gi, rows, keys] += live[rows, keys]
    if plan.cfg == tfa.BWD_SM90:
        for rows, keys in _sm90_q_tiles(s, t, d, causal, window):
            q_hits[:, rows, keys] += live[rows, keys]
    return kv_hits, q_hits, live


@pytest.mark.parametrize("cfg", [0, 1, 2])
@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window", COVER_SHAPES)
def test_bwd_blocks_cover_every_live_pair_once(cfg, b, h, kv, s, t, d,
                                               causal, window):
    """The dK/dV blocks of a plan (Large: cut into parts) meet every live
    (head, row, key) pair of a kv head exactly once, and so does Small's
    fused dQ and the Hopper design's dQ pass (bf16 at head dims 64, 128 and
    256; a key tile of 128 keys, 64 at 256, walked in rows of 64, one part
    each); Large's parts
    are no longer than ``steps_per_part`` and, as the Hopper design's,
    come longest walk first under a causal mask."""
    dp = tfa.kernel_head_dim(d)
    dtype = torch.bfloat16 if cfg == 2 else torch.float32
    if (cfg == 0 and t > tfa.bwd_small_keys(dp)) or (
            cfg == 2 and d not in tfa.BWD_SM90_HEAD_DIMS):
        with pytest.raises(ValueError):
            tfa.bwd_plan(b, h, kv, s, t, d, causal, window, dtype, cfg=cfg)
        return
    # Large: walks cut finer than the plan would cut them here
    plan = tfa.bwd_plan(b, h, kv, s, t, d, causal, window, dtype, cfg=cfg,
                        steps_per_part=3 if cfg == 1 else None)
    if cfg == 2:
        assert plan == tfa.bwd_plan(b, h, kv, s, t, d, causal, window, dtype)
        assert (plan.keys, plan.rows, plan.launches) == (
            64 if d == 256 else 128, 64, 2)
    kv_hits, q_hits, live = _cover(s, t, h // kv, causal, window, plan, d)
    want = np.broadcast_to(live, kv_hits.shape).astype(np.int32)
    np.testing.assert_array_equal(kv_hits, want)
    if cfg != 1:
        np.testing.assert_array_equal(q_hits, want)
    parts = tfa.bwd_parts(s, t, h // kv, plan, causal=causal, window=window)
    assert len(parts) == plan.parts
    assert all(r[4] - r[3] <= plan.steps_per_part for r in parts)
    if cfg == 2:                                  # one part a key tile
        assert [r[0] for r in parts] == list(range(-(-t // plan.keys)))
    if causal and cfg != 0:
        lengths = [sum(r[4] - r[3] for r in parts if r[0] == jt)
                   for jt in range(-(-t // plan.keys))]
        assert lengths == sorted(lengths, reverse=True)


def _emulated_large_bwd(q, k, v, o, lse, do, plan, *, causal, window, cap):
    """(dq, dk, dv) in the order of the Large configuration's kernels,
    read from its part table: each dK/dV part sums its steps' P^T dO and
    dS^T Q in step order, a key tile's first part adds the rows with no
    live key (dO / T per head), its parts are summed in part order and dK
    scaled once; dQ sums dS K over each 64-row tile's keys."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    group, scale = h // kvh, d ** -0.5
    live = tfa.live_mask(s, t, causal=causal, window=window, device="cpu")
    delta = (do * o).sum(-1)
    dead_from = t + window - 1 if window else s

    def block(bb, hh, rows, keys):
        """P and dS of rows x keys for head hh of batch bb."""
        x = q[bb, hh, rows] @ k[bb, hh // group, keys].T * scale
        dcap = torch.ones_like(x)
        if cap:
            th = torch.tanh(x / cap)
            x, dcap = cap * th, 1.0 - th * th
        m = live[rows, keys]
        p = torch.where(m, torch.exp(x - lse[bb, hh, rows, None]), 0.0)
        dp = do[bb, hh, rows] @ v[bb, hh // group, keys].T
        return p, torch.where(m, p * (dp - delta[bb, hh, rows, None]) * dcap,
                              0.0)

    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    parts = tfa.bwd_parts(s, t, group, plan, causal=causal, window=window)
    for bb in range(b):
        for kh in range(kvh):
            sums = {}
            for i, (jt, t_lo, n_rows, lo, hi, first, _) in enumerate(parts):
                keys = slice(jt * plan.keys, min(t, jt * plan.keys +
                                                 plan.keys))
                pk = torch.zeros_like(k[bb, kh, keys])
                pv = torch.zeros_like(pk)
                for n in range(lo, hi):
                    hh = kh * group + n // n_rows
                    rt = t_lo + n % n_rows
                    rows = slice(rt * plan.rows,
                                 min(s, rt * plan.rows + plan.rows))
                    p, ds = block(bb, hh, rows, keys)
                    pv = pv + p.T @ do[bb, hh, rows]
                    pk = pk + ds.T @ q[bb, hh, rows]
                if i == first:                  # the key tile's first part
                    for gi in range(group):
                        pv = pv + do[bb, kh * group + gi,
                                     dead_from:].sum(0) / t
                    sums[jt] = (keys, pk, pv)
                else:
                    _, ak, av = sums[jt]
                    sums[jt] = (keys, ak + pk, av + pv)
            for keys, ak, av in sums.values():
                dk[bb, kh, keys], dv[bb, kh, keys] = ak * scale, av
    dq = torch.zeros_like(q)
    for i0 in range(0, s, 64):
        rows = slice(i0, min(s, i0 + 64))
        for bb in range(b):
            for hh in range(h):
                dq[bb, hh, rows] = block(bb, hh, rows, slice(0, t))[1] @ \
                    k[bb, hh // group] * scale
    return dq, dk, dv


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap", [
    (1, 4, 2, 150, 150, 16, True, 0, 0.0),      # causal GQA, cut walks
    (1, 2, 1, 120, 70, 24, True, 10, 20.0),     # window, cap, dead rows
    (2, 2, 2, 90, 130, 8, False, 0, 0.0),       # bidir, ragged S < T
])
def test_large_split_walk_matches_plain_and_jax_vjp(b, h, kv, s, t, d,
                                                    causal, window, cap):
    """Large's split dK/dV walk (parts of 1 step) with its ordered sum of
    partials, and its dQ walk, emulated on the CPU: against
    ``flash_attention_bwd_plain`` to 1e-5 and against ``jax.vjp`` of
    ``attention_ref`` to 2e-5 of each gradient's largest magnitude."""
    arrays = qkv(b, h, kv, s, t, d, seed=3 * s + d)
    do = np.random.default_rng(11).standard_normal((b, h, s, d),
                                                   dtype=np.float32)
    (jq, jk, jv), (tq, tk, tv) = both(arrays, "float32")
    kw = dict(causal=causal, window=window, softcap=cap)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(q, k, v, **kw),
                     jq, jk, jv)
    ref = vjp(jnp.asarray(do))
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, **kw)
    tdo = torch.from_numpy(do)
    plan = tfa.bwd_plan(b, h, kv, s, t, d, causal, window, cfg=1,
                        steps_per_part=1)
    parts = tfa.bwd_parts(s, t, h // kv, plan, causal=causal, window=window)
    assert len(parts) > -(-t // plan.keys)           # some walk is cut
    got = _emulated_large_bwd(tq, tk, tv, o, lse, tdo, plan, causal=causal,
                              window=window, cap=cap)
    plain = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, **kw)
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        r = np.asarray(r)
        top = np.abs(r).max()
        assert np.abs(g.numpy() - p.numpy()).max() <= 1e-5 * top, name
        assert np.abs(g.numpy() - r).max() <= 2e-5 * top, name


# ---------------------------------------------------------------------------
# the Hopper design (csrc/flash_attention_bwd_sm90.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TARCHS))
def test_bwd_plan_takes_sm90_at_the_models_bf16_heads(name):
    """Each model's heads at its training length (B 2, S = T 4096, causal,
    its window): bf16 takes the Hopper design at every model's head dim
    (64: granite-3-2b, granite-moe, seamless, mamba2's; 128: qwen2, arctic,
    mistral, llava; 256: gemma2, recurrentgemma), in one part a key tile
    of 128 keys (64 at 256), and fp32 never takes it."""
    cfg = TARCHS[name]
    args = (2, cfg.n_heads, cfg.n_kv_heads, 4096, 4096, cfg.hd, True,
            cfg.window)
    plan = tfa.bwd_plan(*args, torch.bfloat16)
    assert cfg.hd in tfa.BWD_SM90_HEAD_DIMS
    assert plan.cfg == tfa.BWD_SM90 and plan.launches == 2
    assert plan.keys == tfa.bwd_sm90_keys(cfg.hd) == (
        64 if cfg.hd == 256 else 128)
    assert plan.parts == 4096 // plan.keys
    assert tfa.bwd_plan(*args).cfg != tfa.BWD_SM90
    assert tfa.bwd_plan(*args, torch.float32).cfg != tfa.BWD_SM90


@pytest.mark.parametrize("dtype,d,cfg,ok", [
    (torch.bfloat16, 64, 2, True), (torch.bfloat16, 128, 2, True),
    (torch.bfloat16, 256, 2, True), (torch.bfloat16, 32, 2, False),
    (torch.bfloat16, 48, 2, False), (torch.float32, 64, 2, False),
    (torch.bfloat16, 64, 0, True), (torch.bfloat16, 128, 1, True),
    (torch.bfloat16, 256, 1, True)])
def test_bwd_plan_forced_sm90_runs_where_it_can(dtype, d, cfg, ok):
    """The Hopper design is forced only for bf16 at head dims 64, 128 and
    256, else ``ValueError``; it takes no part length (one part a key
    tile); the SIMT configurations stay reachable in bf16 by a forced
    ``cfg``, and bf16 at head dim 32 takes them by default."""
    args = (2, 4, 2, 64, 64, d, True, 0, dtype)
    if not ok:
        with pytest.raises(ValueError, match="no configuration 2"):
            tfa.bwd_plan(*args, cfg=cfg)
        return
    assert tfa.bwd_plan(*args, cfg=cfg).cfg == cfg
    if cfg == 2:
        with pytest.raises(ValueError, match="one part"):
            tfa.bwd_plan(*args, cfg=cfg, steps_per_part=4)
    assert tfa.bwd_plan(2, 4, 2, 64, 64, 32, True, 0,
                        torch.bfloat16).cfg != tfa.BWD_SM90


def _variants_tool(name):
    """``tools/<name>.py`` through the variant tools' harness, which
    also applies a variant's patches as the tool does."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "tools" / "variant_build.py"
    spec = importlib.util.spec_from_file_location("variant_build", path)
    vb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vb)
    return vb, vb.load(name)


@pytest.mark.parametrize("variant", ["libm_exp2", "no_exp", "no_math"])
def test_sm90_variant_anchors_occur_once(variant):
    """``tools/bwd_sm90_variants.py`` patches the Hopper backward's source
    at text anchors: each must occur exactly once in the source as it
    stands, applied in order, or the tool stops on the card."""
    vb, tool = _variants_tool("bwd_sm90_variants")
    assert set(tool.PATCHES) == {"default", "libm_exp2", "no_exp",
                                 "no_math"}
    vb.patched(vb.source_text(tool.SOURCE), tool.PATCHES[variant], variant)


@pytest.mark.parametrize("variant", ["split_scores", "unroll_d2",
                                     "large_double_buffer",
                                     "dq_natural_order"])
def test_simt_variant_anchors_occur_once(variant):
    """``tools/bwd_variants.py`` patches the SIMT backward's source
    (``csrc/flash_attention_bwd.cu``) at text anchors: each must occur
    exactly once in the source as it stands, applied in order, or its
    default run stops on the card."""
    vb, tool = _variants_tool("bwd_variants")
    assert set(tool.PATCHES) == {"default", "split_scores", "unroll_d2",
                                 "large_double_buffer", "dq_natural_order"}
    vb.patched(vb.source_text("flash_attention_bwd"), tool.PATCHES[variant],
               variant)


LOG2E = 1.4426950408889634


def _emulated_sm90_bwd(q, k, v, o, lse, do, *, causal, window, cap):
    """(dq, dk, dv) as ``csrc/flash_attention_bwd_sm90.cu`` computes them,
    in fp32 on bf16 inputs, in its tiles and summation order: the dQ pass
    walks each 128-row block's key tiles (``_sm90_q_tiles``) over the keys
    live for some row of the block; the dK/dV pass walks each key tile's
    (head, 64-row tile) steps as the plan's part table orders them, then
    adds the rows with no live key (dO / T over the group's heads).
    P = 2^(s log2 e - lse log2 e) on live pairs (rows past S have lse
    +inf there), Delta = rowsum(dO o); P is rounded to bf16
    before dV += P^T dO, dS = P dcap (dP - Delta) to bf16 before dQ += dS K
    and dK += dS^T Q; S, dP and every sum fp32; dq, dk, dv rounded to bf16
    after the scale."""
    b, h, s, d = q.shape
    kvh, t = k.shape[1], k.shape[2]
    group, scale = h // kvh, d ** -0.5
    bf = lambda x: x.to(torch.bfloat16).float()
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, o, do))
    live = tfa.live_mask(s, t, causal=causal, window=window, device="cpu")
    delta = (gf * of).sum(-1)                             # (b, h, s)
    lse2 = lse.float() * LOG2E

    def tile(bb, hh, rows, keys):
        """P and P dcap (dS / (dP - Delta)) of rows x keys, and dP."""
        x = qf[bb, hh, rows] @ kf[bb, hh // group, keys].T
        if cap:
            th = torch.tanh(x * scale / cap)
            y, dcap = cap * th * LOG2E, 1.0 - th * th
        else:
            y, dcap = x * (scale * LOG2E), 1.0
        m = live[rows, keys]
        pr = torch.where(m, torch.exp2(y - lse2[bb, hh, rows, None]), 0.0)
        dp = gf[bb, hh, rows] @ vf[bb, hh // group, keys].T
        return pr, pr * dcap, dp

    dq = torch.zeros_like(qf)
    for bb in range(b):
        for hh in range(h):
            for rows, keys in _sm90_q_tiles(s, t, d, causal, window):
                _, pd, dp = tile(bb, hh, rows, keys)
                ds = bf(pd * (dp - delta[bb, hh, rows, None]))
                dq[bb, hh, rows] += ds @ kf[bb, hh // group, keys]
    plan = tfa.bwd_plan(b, h, kvh, s, t, d, causal, window, torch.bfloat16)
    assert plan.cfg == tfa.BWD_SM90
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    dead_from = t + window - 1 if window else s
    for bb in range(b):
        for kh in range(kvh):
            for jt, t_lo, n_rows, lo, hi, _, _ in tfa.bwd_parts(
                    s, t, group, plan, causal=causal, window=window):
                keys = slice(jt * plan.keys, min(t, jt * plan.keys +
                                                 plan.keys))
                for n in range(lo, hi):
                    hh = kh * group + n // n_rows
                    rt = t_lo + n % n_rows
                    rows = slice(rt * plan.rows,
                                 min(s, rt * plan.rows + plan.rows))
                    pr, pd, dp = tile(bb, hh, rows, keys)
                    dv[bb, kh, keys] += bf(pr).T @ gf[bb, hh, rows]
                    ds = bf(pd * (dp - delta[bb, hh, rows, None]))
                    dk[bb, kh, keys] += ds.T @ qf[bb, hh, rows]
            if dead_from < s:
                dv[bb, kh] += gf[bb, kh * group:(kh + 1) * group,
                                 dead_from:].sum((0, 1)) / t
    return bf(dq * scale), bf(dk * scale), bf(dv)


_attend_vjp = jax.jit(
    lambda q, k, v, mask, do, cap: jax.vjp(
        lambda q, k, v: jattn._attend(
            q, k, v, mask, types.SimpleNamespace(
                gqa_impl="grouped", hd=q.shape[-1], attn_softcap=cap)),
        q, k, v)[1](do), static_argnums=5)

SM90_SHAPES = [
    # b, h, kv, s, t, d, causal, window, cap
    (1, 4, 2, 200, 200, 64, True, 0, 0.0),     # GQA causal, ragged tiles
    (1, 4, 1, 130, 130, 128, True, 0, 30.0),   # MQA, soft cap, D 128
    (1, 2, 2, 70, 300, 64, False, 0, 0.0),     # S < T, ragged
    (1, 4, 2, 300, 130, 64, True, 40, 0.0),    # window: rows 169.. dead
    (1, 2, 1, 150, 90, 128, False, 9, 20.0),   # bidir window, cap, dead
    (2, 8, 2, 96, 96, 64, True, 16, 0.0),      # window, group 4, B 2
    (1, 4, 2, 130, 130, 256, True, 40, 30.0),  # D 256: window, cap, GQA
    (1, 4, 1, 90, 200, 256, False, 0, 0.0),    # D 256: MQA, S < T
]


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,cap", SM90_SHAPES)
def test_sm90_bwd_numerics_match_jax_grad_in_bf16(b, h, kv, s, t, d, causal,
                                                   window, cap):
    """The emulated Hopper design on bf16 inputs (from the bf16 forward's
    emulated o and the plain forward's lse) against ``jax.vjp`` of the
    reference's ``_attend`` in bf16 (it rounds P before P.V, the scores and
    dP at its einsums' outputs) and against the fp32 gradients
    (``jax.vjp`` of ``attention_ref`` on the same bf16-rounded inputs):
    each within 2e-2 of the gradient's largest magnitude."""
    arrays = qkv(b, h, kv, s, t, d, seed=5 * s + d)
    do = np.random.default_rng(13).standard_normal((b, h, s, d),
                                                   dtype=np.float32)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = both([*arrays, do], "bfloat16")
    kw = dict(causal=causal, window=window, softcap=cap)
    o = bf16_p_attention(tq, tk, tv, **kw)
    _, lse = tfa._plain_forward(tq, tk, tv, scale=None, want_lse=True, **kw)
    got = _emulated_sm90_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                             window=window, cap=cap)
    mask = jnp.asarray(tfa.live_mask(s, t, causal=causal, window=window,
                                     device="cpu").numpy())[None, None]
    t_bshd = lambda x: jnp.swapaxes(x, 1, 2)             # (B,H,S,D) <-> (B,S,H,D)
    ref16 = [t_bshd(g) for g in _attend_vjp(t_bshd(jq), t_bshd(jk),
                                            t_bshd(jv), mask, t_bshd(jdo),
                                            float(cap))]
    f = lambda x: jnp.asarray(x, jnp.float32)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(q, k, v, **kw),
                     f(jq), f(jk), f(jv))
    ref32 = vjp(f(jdo))
    if window and s > t + window - 1:
        assert not got[0][:, :, t + window - 1:].any()
    for name, g, r16, r32 in zip(("dq", "dk", "dv"), got, ref16, ref32):
        assert g.dtype == torch.float32 and g.shape == r32.shape
        for r in (r16, r32):
            r = f32(r)
            top = np.abs(r).max()
            err = np.abs(g.numpy() - r).max()
            assert err <= 2e-2 * top, (name, err / top)
