"""The port's candidate-LM substrate against the JAX package, on the CPU.

From the reference's parameters, carried over with
``convert.lm_params_from_numpy``, at ``reduced(max_units=2)`` (fp32,
d_model 256):

* the SSD and RG-LRU cores (``ssd_chunked`` with h0 and a ragged tail,
  ``linear_scan``) and the mixers (``ssd_fwd``, ``rglru_fwd``);
* ``lm.forward``; ``lm.prefill`` at S 200 (past the reduced window of 128,
  so the local-attention cache is filled as a ring) with every cache leaf;
  then 3 ``lm.decode_step``s; for mamba2-1.3b and recurrentgemma-9b, for
  qwen2-7b (global attention, QKV bias), gemma2-9b (local and global
  attention, soft caps), granite-3-2b and mistral-large-123b, and for granite-moe-3b-a800m
  (MoE FFNs, sparse prefill, dense decode), arctic-480b (MoE beside a
  dense residual MLP), seamless-m4t-medium (the encoder over ``frames``,
  cross attention, the memory's K/V in the cache) and llava-next-34b
  (``patches`` before the text): every architecture of ``configs``;
* the MoE models with ``moe_impl="dense"``, llava with and without
  patches, seamless's encoder memory and its cross K/V cache leaves;
* a decode continued from the reference's own prefill cache
  (``convert.lm_cache_from_numpy``).

Tolerance 2e-4, as ``tests/test_archs_smoke.py`` holds prefill and decode
to the full forward. Two carry-over hazards have their own tests: GELU in
its tanh form (``jax.nn.gelu``'s default), and the bf16 embedding scale
rounded to the weights' type first (bitwise). ``ModelConfig``'s
``reduced()``, ``param_count()`` and derived widths equal the reference's
for every architecture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import lm as jlm
from repro.models import rglru as jrglru
from repro.models import ssd as jssd
from repro_torch import convert
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import long_ctx_supported
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as trglru
from repro_torch.models import ssd as tssd
from repro_torch.models.layers import tree_map

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
PORTED = ("mamba2-1.3b", "recurrentgemma-9b", "qwen2-7b", "gemma2-9b",
          "granite-3-2b", "mistral-large-123b", "granite-moe-3b-a800m",
          "arctic-480b", "seamless-m4t-medium", "llava-next-34b")
MOE = ("granite-moe-3b-a800m", "arctic-480b")
S, CACHE_LEN, STEPS = 200, 208, 3


def cfgs(name):
    return (JARCHS[name].reduced(max_units=2),
            TARCHS[name].reduced(max_units=2))


_PARAMS = {}


def params(name):
    """The reference's random parameters of the reduced arch, and the
    port's copy of them."""
    if name not in _PARAMS:
        jc, _ = cfgs(name)
        jp = jlm.init_params(jax.random.PRNGKey(1), jc)
        _PARAMS[name] = (jp, convert.lm_params_from_numpy(
            jax.device_get(jp), "cpu"))
    return _PARAMS[name]


def tokens(cfg, b=2, s=S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def batch(cfg, b=2, s=S, seed=0, patches=True):
    """Tokens, and the front end's inputs: ``patches`` (B, 16, d) for the
    vision model, ``frames`` (B, 32, d) for the encoder-decoder one."""
    out = {"tokens": tokens(cfg, b, s, seed)}
    rng = np.random.default_rng(seed + 100)
    if cfg.frontend == "vision" and patches:
        out["patches"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (b, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def seq_len(cfg, b):
    """The decoder's sequence length of a batch: patches and text."""
    return b["tokens"].shape[1] + (b["patches"].shape[1]
                                   if "patches" in b else 0)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def compare_trees(got, want, path=""):
    """Every leaf of the reference's tree against the port's: the same
    shape, integer leaves equal, float leaves to TOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            compare_trees(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, path
    if np.issubdtype(want.dtype, np.integer):
        assert got.dtype == torch.int32, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=path)
    else:
        close(got, want, err_msg=path, **TOL)


# ---------------------------------------------------------------------------
# the scan cores and the mixers
# ---------------------------------------------------------------------------

def test_ssd_chunked_matches_reference_with_h0_and_ragged_tail():
    rng = np.random.default_rng(2)
    b, s, h, p, n = 2, 130, 4, 32, 64
    f = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    dt = np.logaddexp(f(b, s, h), 0.0).astype(np.float32)
    args = [f(b, s, h, p), f(b, s, n), f(b, s, n), -0.1 * dt, dt]
    h0 = f(b, h, p, n)
    wy, wh = jssd.ssd_chunked(*map(jnp.asarray, args), 64, jnp.asarray(h0))
    ty, th = tssd.ssd_chunked(*map(torch.from_numpy, args), 64,
                              torch.from_numpy(h0))
    close(ty, wy)
    close(th, wh)


def test_linear_scan_matches_reference():
    rng = np.random.default_rng(3)
    b, s, d = 2, 77, 96
    log_a = (-np.abs(rng.standard_normal((b, s, d))) * 0.2).astype(np.float32)
    x_in = rng.standard_normal((b, s, d), dtype=np.float32)
    wh, wl = jrglru.linear_scan(jnp.asarray(log_a), jnp.asarray(x_in))
    th, tl = trglru.linear_scan(torch.from_numpy(log_a),
                                torch.from_numpy(x_in))
    close(th, wh, rtol=1e-5, atol=1e-5)
    close(tl, wl, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,mixer", [("mamba2-1.3b", "ssd"),
                                        ("recurrentgemma-9b", "rglru")])
def test_mixer_forward_matches_reference(name, mixer):
    jc, tc = cfgs(name)
    jp, tp = params(name)
    x = np.random.default_rng(4).standard_normal((2, S, jc.d_model),
                                                 dtype=np.float32)
    jmod, tmod = (jssd, tssd) if mixer == "ssd" else (jrglru, trglru)
    fwd = f"{mixer}_fwd"
    jleaf = jax.tree.map(lambda t: t[0], jp["units"]["0"]["mixer"])
    tleaf = {k: v[0] for k, v in tp["units"]["0"]["mixer"].items()}
    want = getattr(jmod, fwd)(jleaf, jnp.asarray(x), jc)
    got = getattr(tmod, fwd)(tleaf, torch.from_numpy(x), tc)
    close(got, want)


# ---------------------------------------------------------------------------
# the whole LM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PORTED)
def test_forward_matches_reference(name):
    jc, tc = cfgs(name)
    jp, tp = params(name)
    jb, tb = batch(jc)
    want, waux = jlm.forward(jp, jb, jc, remat=False)
    got, aux = tlm.forward(tp, tb, tc)
    assert got.dtype == torch.float32 and got.shape[1] == seq_len(jc, jb)
    close(got, want)
    close(aux, waux)
    assert (float(aux) > 0.0) == (name in MOE)


@pytest.mark.parametrize("name", PORTED)
def test_prefill_and_decode_match_reference(name):
    """Prefill at S 200 (every cache leaf), then 3 greedy decode steps."""
    jc, tc = cfgs(name)
    jp, tp = params(name)
    jb, tb = batch(jc)
    s = seq_len(jc, jb)
    cache_len = CACHE_LEN + s - S
    jlast, jcache = jlm.prefill(jp, jb, jc, cache_len=cache_len)
    tlast, tcache = tlm.prefill(tp, tb, tc, cache_len=cache_len)
    close(tlast, jlast)
    compare_trees(tcache, jax.device_get(jcache))
    nxt = np.array(jnp.argmax(jlast, axis=-1), np.int32)
    for step in range(STEPS):
        pos = s + step
        jl, jcache = jlm.decode_step(jp, jcache, jnp.asarray(nxt),
                                     jnp.int32(pos), jc)
        tl, tcache = tlm.decode_step(tp, tcache, torch.from_numpy(nxt), pos,
                                     tc)
        close(tl, jl)
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    compare_trees(tcache, jax.device_get(jcache))


def test_local_ring_cache_after_prefill_past_the_window():
    """recurrentgemma's local layer keeps the last ``window`` tokens at
    slots pos % window after a 200-token prompt (window 128)."""
    _, tc = cfgs("recurrentgemma-9b")
    _, tp = params("recurrentgemma-9b")
    _, cache = tlm.prefill(tp, {"tokens": torch.from_numpy(
        tokens(tc))}, tc, cache_len=CACHE_LEN)
    slot_pos = cache["units"]["2"]["kv"]["slot_pos"]
    w = tc.window
    assert slot_pos.shape == (tc.n_units, w)
    want = torch.tensor([p for p in range(S - w, S)])
    want = want[torch.argsort(want % w)].to(torch.int32)
    assert torch.equal(slot_pos[0], want)


def test_decode_continues_from_the_reference_cache():
    name = "recurrentgemma-9b"
    jc, tc = cfgs(name)
    jp, tp = params(name)
    tok = tokens(jc, seed=5)
    _, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(tok)}, jc,
                            cache_len=CACHE_LEN)
    tcache = convert.lm_cache_from_numpy(jax.device_get(jcache), "cpu")
    nxt = tok[:, -1]
    jl, _ = jlm.decode_step(jp, jcache, jnp.asarray(nxt), jnp.int32(S), jc)
    tl, _ = tlm.decode_step(tp, tcache, torch.from_numpy(nxt), S, tc)
    close(tl, jl)


def test_decode_step_writes_the_cache_in_place():
    """Each step lands in the stacked cache's own storage: the returned
    cache is the one passed in, and decoding from a copy of the prefill
    cache gives the same logits and the same state."""
    name = "recurrentgemma-9b"
    _, tc = cfgs(name)
    _, tp = params(name)
    _, cache = tlm.prefill(tp, {"tokens": torch.from_numpy(tokens(tc))}, tc,
                           cache_len=CACHE_LEN)
    copy = tree_map(torch.clone, cache)
    ptrs = [t.data_ptr() for t in leaves(cache)]
    nxt = torch.zeros((2,), dtype=torch.int32)
    lg, out = tlm.decode_step(tp, cache, nxt, S, tc)
    assert out is cache
    assert [t.data_ptr() for t in leaves(out)] == ptrs
    assert not all(torch.equal(a, b)
                   for a, b in zip(leaves(out), leaves(copy)))
    lg2, again = tlm.decode_step(tp, copy, nxt, S, tc)
    assert torch.equal(lg2, lg)
    for a, b in zip(leaves(again), leaves(out)):
        assert torch.equal(a, b)


def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", ["ssd", "rglru"])
def test_causal_conv_matches_reference(mixer, dtype):
    """The one causal conv of ``layers`` under each block's
    ``_causal_conv`` (SiLU for the SSD) equals the reference's, output and
    conv state, from a zero and from a given state: bitwise, but for the
    SSD's SiLU, where torch and XLA differ by an ulp of fp32 (so by up to
    one ulp of the output type)."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 24)).astype(np.float32) * 0.3
    u = rng.standard_normal((2, 9, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jw, ju, jst = (jnp.asarray(a).astype(jdt) for a in (w, u, st))
    tw, tu, tst = (torch.from_numpy(a).to(tdt) for a in (w, u, st))
    for state in (False, True):
        if mixer == "ssd":
            want = jssd._causal_conv(jw, ju, jst if state else None)
            got = tssd._causal_conv(tw, tu, tst if state else None)
        else:
            want = jrglru._causal_conv({"conv": jw}, ju,
                                       jst if state else None)
            got = trglru._causal_conv({"conv": tw}, tu,
                                      tst if state else None)
        ulp = 2.0 ** -23 if dtype == "float32" else 2.0 ** -7
        tol = dict(rtol=2 * ulp, atol=2 * ulp) if mixer == "ssd" else {}
        for g, wnt in zip(got, want):
            assert g.dtype == tdt
            want32 = np.asarray(wnt.astype(jnp.float32))
            if tol and g is got[0]:
                np.testing.assert_allclose(g.float().numpy(), want32, **tol)
            else:
                np.testing.assert_array_equal(g.float().numpy(), want32)


def test_init_cache_matches_reference_layout():
    for name in PORTED:
        jc, tc = cfgs(name)
        want = jax.device_get(jlm.init_cache(2, jc, CACHE_LEN,
                                             jc.enc_frames))
        compare_trees(tlm.init_cache(2, tc, CACHE_LEN, tc.enc_frames,
                                     device="cpu"), want)


@pytest.mark.parametrize("name", ["seamless-m4t-medium",
                                  "granite-moe-3b-a800m", "arctic-480b",
                                  "llava-next-34b"])
def test_new_models_decode_from_the_reference_cache(name):
    """The reference's prefill cache (seamless: its cross K/V leaves) in
    the port's decode."""
    jc, tc = cfgs(name)
    jp, tp = params(name)
    jb, _ = batch(jc, seed=5)
    s = seq_len(jc, jb)
    _, jcache = jlm.prefill(jp, jb, jc, cache_len=s + 1)
    tcache = convert.lm_cache_from_numpy(jax.device_get(jcache), "cpu")
    nxt = np.array(jb["tokens"])[:, -1]
    jl, _ = jlm.decode_step(jp, jcache, jnp.asarray(nxt), jnp.int32(s), jc)
    tl, _ = tlm.decode_step(tp, tcache, torch.from_numpy(nxt), s, tc)
    close(tl, jl)


@pytest.mark.parametrize("name", MOE)
def test_moe_dense_dispatch_matches_reference(name):
    """``moe_impl="dense"`` through ``forward`` and ``prefill``."""
    jc, tc = cfgs(name)
    jp, tp = params(name)
    jb, tb = batch(jc, s=40, seed=6)
    want, waux = jlm.forward(jp, jb, jc, moe_impl="dense", remat=False)
    got, aux = tlm.forward(tp, tb, tc, moe_impl="dense")
    close(got, want)
    close(aux, waux)
    jlast, jcache = jlm.prefill(jp, jb, jc, cache_len=48, moe_impl="dense")
    tlast, tcache = tlm.prefill(tp, tb, tc, cache_len=48, moe_impl="dense")
    close(tlast, jlast)
    compare_trees(tcache, jax.device_get(jcache))


@pytest.mark.parametrize("with_patches", [True, False])
def test_vision_patches_come_before_the_text(with_patches):
    """llava: ``patches @ vis_proj`` then the tokens, positions over both;
    without patches, the text alone."""
    name = "llava-next-34b"
    jc, tc = cfgs(name)
    jp, tp = params(name)
    assert tp["vis_proj"].shape == (tc.d_model, tc.d_model)
    jb, tb = batch(jc, s=24, seed=7, patches=with_patches)
    wx, wpos = jlm._embed_inputs(jp, jb, jc)
    gx, gpos = tlm._embed_inputs(tp, tb, tc)
    close(gx, wx)
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))
    assert gx.shape[1] == 24 + (tc.n_frontend_tokens if with_patches else 0)
    want, _ = jlm.forward(jp, jb, jc, remat=False)
    got, _ = tlm.forward(tp, tb, tc)
    close(got, want)


def test_encoder_memory_and_cross_cache_match_reference():
    """seamless: ``_encode`` of the frames (bidirectional units, then
    ``enc_norm``), and the cross K/V prefill writes: (units, B, frames,
    KV, hd), the memory's projections with their biases."""
    name = "seamless-m4t-medium"
    jc, tc = cfgs(name)
    jp, tp = params(name)
    assert set(tp) >= {"enc_units", "enc_norm"}
    jb, tb = batch(jc, s=30, seed=8)
    want = jlm._encode(jp, jb["frames"], jc)
    got = tlm._encode(tp, tb["frames"], tc)
    assert got.shape == (2, tc.enc_frames, tc.d_model)
    close(got, want)
    _, jcache = jlm.prefill(jp, jb, jc, cache_len=32)
    _, tcache = tlm.prefill(tp, tb, tc, cache_len=32)
    for leaf in ("xk", "xv"):
        g = tcache["units"]["0"][leaf]
        assert g.shape == (tc.n_units, 2, tc.enc_frames, tc.n_kv_heads,
                           tc.hd)
        close(g, jax.device_get(jcache["units"]["0"][leaf]))
    w = tp["units"]["0"]["xattn"]
    xk0 = torch.einsum("btd,dhk->bthk", got, w["wk"][0])
    if "bk" in w:
        xk0 = xk0 + w["bk"][0]
    close(tcache["units"]["0"]["xk"][0], xk0.numpy())


# ---------------------------------------------------------------------------
# carry-over hazards and the configs
# ---------------------------------------------------------------------------

def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the exact erf
    form differs from it by up to 4e-4 on [-3, 3]."""
    x = np.linspace(-3, 3, 1001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = trglru.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_bf16_embedding_scale_rounds_like_jnp():
    """sqrt(2048) is 45.25 in bf16; the port scales by that, bitwise as
    ``params["embed"][tokens] * jnp.asarray(d ** 0.5, bf16)``."""
    cfg = dataclasses.replace(TARCHS["mamba2-1.3b"], vocab_size=1000)
    rng = np.random.default_rng(6)
    emb = rng.standard_normal((1000, cfg.d_model), dtype=np.float32)
    tok = rng.integers(0, 1000, (2, 64)).astype(np.int32)
    jemb = jnp.asarray(emb, jnp.bfloat16)
    want = jemb[jnp.asarray(tok)] * jnp.asarray(cfg.d_model ** 0.5,
                                                jnp.bfloat16)
    temb = convert.lm_params_from_numpy({"e": jax.device_get(jemb)},
                                        "cpu")["e"]
    assert temb.dtype == torch.bfloat16
    got = tlm._embed({"embed": temb}, torch.from_numpy(tok), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))


@pytest.mark.parametrize("name", sorted(JARCHS))
def test_config_reduced_and_counts_match_reference(name):
    jc, tc = JARCHS[name], TARCHS[name]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for kw in ({}, dict(max_units=2), dict(d_model=128, n_experts=2)):
        assert dataclasses.asdict(tc.reduced(**kw)) == dataclasses.asdict(
            jc.reduced(**kw))
    for c_t, c_j in ((tc, jc), (tc.reduced(), jc.reduced())):
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
        for prop in ("d_inner", "ssm_heads", "d_rnn", "is_encdec",
                     "n_enc_layers", "sub_quadratic", "n_layers", "hd"):
            assert getattr(c_t, prop) == getattr(c_j, prop), prop


def test_long_ctx_flags_match_reference():
    from repro.configs import long_ctx_supported as jlong
    for name in JARCHS:
        assert long_ctx_supported(name) == jlong(name), name
