"""The port's encoder stack against the JAX package's, on the CPU, from the
same parameters (the reference's, carried over with
``convert.encoder_params_from_numpy``) and the same numpy inputs.

* the layers: ``rms_norm`` (gain 1 + scale, eps 1e-6), ``rope_freqs`` and
  ``apply_rope`` (split halves, numpy float32 frequencies), ``gated_mlp``;
* ``block_fwd`` for the three attention mixers with the gated MLP;
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


@pytest.mark.parametrize("mixer,ffn,match", [
    (tconfig.MIXER_CROSS_ATTN, tconfig.FFN_MLP, "encoder-decoder"),
    (tconfig.MIXER_GLOBAL_ATTN, tconfig.FFN_MOE, "MoE"),
])
def test_block_fwd_raises_for_later_slices(mixer, ffn, match):
    """The layers no slice has ported yet (cross attention, MoE FFNs)."""
    spec = tconfig.LayerSpec(mixer, ffn)
    tc = tconfig.ModelConfig(
        name="later", family="moe", d_model=8, n_heads=1, n_kv_heads=1,
        d_ff=8, vocab_size=8, n_units=1, pattern=(spec,))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match=match):
        tblocks.init_block(gen, tc, spec, torch.float32, "cpu")
    x = torch.zeros((1, 2, 8))
    with pytest.raises(NotImplementedError, match=match):
        tblocks.block_fwd({}, x, torch.zeros((1, 2), dtype=torch.int32), tc,
                          spec)


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
