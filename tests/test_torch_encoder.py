"""The port's encoder stack against the JAX package's, on the CPU, from the
same parameters (the reference's, carried over with
``convert.encoder_params_from_numpy``) and the same numpy inputs.

* the layers: ``rms_norm`` (gain 1 + scale, eps 1e-6), ``rope_freqs`` and
  ``apply_rope`` (split halves, numpy float32 frequencies), ``gated_mlp``;
* ``block_fwd`` for the three attention mixers with the gated MLP; a
  cross-attention block (causal self-attention, then attention to an
  encoder memory of T != S) through ``block_fwd``, ``block_prefill``
  (its cache: the self K/V and the memory's ``xk`` / ``xv``) and
  ``block_step`` (the cached memory, no soft cap), with a soft cap set;
* ``encode`` at a tiny configuration, at ``EncoderConfig()`` (the repo's
  widest encoder) and at the paper benchmarks' ``minilm`` encoder (head
  dim 24), to atol 2e-5, with padded positions;
* msgpack checkpoints: the port writes the reference's bytes, a reference
  checkpoint restores into the port and a port checkpoint into the
  reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import msgpack_ckpt as jckpt
from repro.encoder import model as jenc
from repro.models import blocks as jblocks
from repro.models import config as jconfig
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.checkpoint import msgpack_ckpt as tckpt
from repro_torch.encoder import model as tenc
from repro_torch.models import blocks as tblocks
from repro_torch.models import config as tconfig
from repro_torch.models import layers as tlayers
from test_torch_attention import port_config

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-5)
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_len=16)


def rng_f32(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def test_rms_norm_matches():
    x, scale = rng_f32(0, 3, 5, 64, scale=3.0), rng_f32(1, 64, scale=0.1)
    want = jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a zero scale is the identity gain, not a zero one
    unit = tlayers.rms_norm(torch.from_numpy(x), torch.zeros(64))
    np.testing.assert_allclose(
        unit.pow(2).mean(-1).numpy(), np.ones((3, 5)), rtol=1e-5)


@pytest.mark.parametrize("hd,theta", [(16, 10000.0), (64, 500000.0)])
def test_rope_matches(hd, theta):
    np.testing.assert_array_equal(tlayers.rope_freqs(hd, theta),
                                  jlayers.rope_freqs(hd, theta))
    x = rng_f32(2, 2, 9, 3, hd)
    pos = np.tile(np.arange(9, dtype=np.int32) + 5, (2, 1))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gated_mlp_matches():
    p = {"w1": rng_f32(3, 32, 48, scale=0.2),
         "w3": rng_f32(4, 32, 48, scale=0.2),
         "w2": rng_f32(5, 48, 32, scale=0.15)}
    x = rng_f32(6, 4, 7, 32)
    want = jlayers.gated_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got = tlayers.gated_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mixer", [jconfig.MIXER_BIDIR_ATTN,
                                   jconfig.MIXER_GLOBAL_ATTN,
                                   jconfig.MIXER_LOCAL_ATTN])
def test_block_fwd_matches(mixer):
    spec = jconfig.LayerSpec(mixer, jconfig.FFN_MLP)
    jc = jconfig.ModelConfig(
        name="block-test", family="dense", d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=96, vocab_size=8, pattern=(spec,),
        n_units=1, window=6, dtype="float32")
    params = jax.device_get(jblocks.init_block(jax.random.PRNGKey(1), jc,
                                               spec, jnp.float32))
    # non-zero norm scales, so the (1 + scale) gain is exercised
    params = dict(params, norm1=rng_f32(7, 64, scale=0.3),
                  norm2=rng_f32(8, 64, scale=0.3))
    x = rng_f32(9, 2, 20, 64)
    pos = np.tile(np.arange(20, dtype=np.int32), (2, 1))
    want, _ = jblocks.block_fwd(params, jnp.asarray(x), jnp.asarray(pos), jc,
                                spec)
    tc = port_config(jc)
    got, aux = tblocks.block_fwd(
        convert.encoder_params_from_numpy(params, device="cpu"),
        torch.from_numpy(x), torch.from_numpy(pos), tc, tc.pattern[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0


def _close_trees(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_trees(got[k], want[k])
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_cross_attention_block_matches(cap):
    spec = jconfig.LayerSpec(jconfig.MIXER_CROSS_ATTN, jconfig.FFN_MLP)
    jc = jconfig.ModelConfig(
        name="xblock-test", family="audio", d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=8, pattern=(spec,),
        n_units=1, qkv_bias=True, attn_softcap=cap, dtype="float32")
    params = jax.device_get(jblocks.init_block(jax.random.PRNGKey(3), jc,
                                               spec, jnp.float32))
    params = dict(params, norm_x=rng_f32(10, 64, scale=0.3),
                  xattn=dict(params["xattn"], bk=rng_f32(11, 2, 16,
                                                         scale=0.1)))
    tc = port_config(jc)
    tp = convert.lm_params_from_numpy(params, "cpu")
    assert set(tp) == {"norm1", "mixer", "norm_x", "xattn", "norm2", "ffn"}
    s, t = 12, 19
    x, mem = rng_f32(12, 2, s, 64), rng_f32(13, 2, t, 64)
    pos = np.tile(np.arange(s, dtype=np.int32), (2, 1))
    want, _ = jblocks.block_fwd(params, jnp.asarray(x), jnp.asarray(pos), jc,
                                spec, enc_memory=jnp.asarray(mem))
    got, aux = tblocks.block_fwd(tp, torch.from_numpy(x),
                                 torch.from_numpy(pos), tc, tc.pattern[0],
                                 enc_memory=torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0
    want, jcache = jblocks.block_prefill(params, jnp.asarray(x),
                                         jnp.asarray(pos), jc, spec, s + 1,
                                         enc_memory=jnp.asarray(mem))
    got, tcache = tblocks.block_prefill(tp, torch.from_numpy(x),
                                        torch.from_numpy(pos), tc,
                                        tc.pattern[0], s + 1,
                                        enc_memory=torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tcache["xk"].shape == (2, t, 2, 16)
    _close_trees(tcache, jax.device_get(jcache))
    x1 = rng_f32(14, 2, 1, 64)
    want, jcache = jblocks.block_step(params, jnp.asarray(x1), jcache,
                                      jnp.int32(s), jc, spec)
    got, tcache = tblocks.block_step(tp, torch.from_numpy(x1), tcache, s, tc,
                                     tc.pattern[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close_trees(tcache, jax.device_get(jcache))


def _tokens(cfg, b, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, cfg.max_len)).astype(np.int32)
    mask = np.ones((b, cfg.max_len), np.float32)
    mask[1, cfg.max_len // 2:] = 0.0        # padded tail
    mask[2, :] = 0.0                        # all padding: denominator 1
    return tok, mask


# benchmarks/common.py's "minilm" encoder: head dim 24 (d 96 over 4 heads)
MINILM = dict(vocab_size=2048, d_model=96, n_layers=2, n_heads=4, d_ff=384,
              max_len=32, name="minilm-repro")


@pytest.mark.parametrize("size", ["tiny", "default", "minilm"])
def test_encode_matches(size):
    kw = {"tiny": TINY, "default": {}, "minilm": MINILM}[size]
    jc, tc = jenc.EncoderConfig(**kw), tenc.EncoderConfig(**kw)
    params = jax.device_get(jenc.init_encoder(jax.random.PRNGKey(3), jc))
    tok, mask = _tokens(jc, 4, seed=4)
    want = jenc.encode(params, jnp.asarray(tok), jnp.asarray(mask), jc)
    got = tenc.encode(convert.encoder_params_from_numpy(params, device="cpu"),
                      torch.from_numpy(tok), torch.from_numpy(mask), tc)
    assert got.shape == (4, jc.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[2].any()                 # no live position: zero vector


def test_init_encoder_has_the_reference_tree():
    jc, tc = jenc.EncoderConfig(**TINY), tenc.EncoderConfig(**TINY)
    ref = jax.device_get(jenc.init_encoder(jax.random.PRNGKey(0), jc))
    got = tenc.init_encoder(torch.Generator().manual_seed(0), tc,
                            device="cpu")
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat = tckpt._leaves(got)
    assert len(flat) == len(ref_leaves)
    for (path, r), g in zip(ref_leaves, flat):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32, path
    wq = got["units"]["0"]["mixer"]["wq"]
    assert abs(float(wq.std()) - TINY["d_model"] ** -0.5) < 0.01
    assert not got["final_norm"].any()


def test_checkpoints_cross_restore(tmp_path):
    jc = jenc.EncoderConfig(**TINY)
    jp = jenc.init_encoder(jax.random.PRNGKey(5), jc)
    host = jax.device_get(jp)
    tp = convert.encoder_params_from_numpy(host, device="cpu")
    # the same tree encodes to the same bytes (treedef string and leaves)
    assert tckpt._encode(tp) == jckpt._encode(host)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, jp)
    like = tenc.init_encoder(torch.Generator().manual_seed(1),
                             tenc.EncoderConfig(**TINY), device="cpu")
    assert tckpt.latest_step(str(tmp_path / "ref")) == 3
    got = tckpt.restore_checkpoint(str(tmp_path / "ref"), 3, like)
    for a, b in zip(tckpt._leaves(got), jax.tree.leaves(host)):
        np.testing.assert_array_equal(a.numpy(), b)
    tckpt.save_checkpoint(str(tmp_path / "port"), 7, got)
    back = jckpt.restore_checkpoint(str(tmp_path / "port"), 7, jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="structure"):
        tckpt.restore_checkpoint(str(tmp_path / "ref"), 3, {"embed": like[
            "embed"]})
