"""The port's encoder training (``repro_torch.contrastive``) against the
JAX package's, on the CPU, at a reduced encoder (2 layers, d 32, 4 heads)
from the reference's parameters carried over with
``convert.encoder_params_from_numpy``.

* ``cosine_loss`` and its gradient (autograd through ``encode``, the
  attention through ``flash_attention``'s ``autograd.Function`` and its
  plain backward) against ``jax.value_and_grad``: the loss to rtol 1e-6,
  every gradient leaf to 1e-5 of its largest magnitude;
* one ``train_step`` (AdamW, weight decay 0.01, clipping at norm 1), and a
  second one from the reference's optimizer state
  (``convert.adamw_state_from_numpy``). Adam's update is about
  lr * sign(g) where |g| >> eps, so an entry whose gradient is near zero
  may move by up to 2 lr on one side against the other when the two
  gradients differ there by rounding. The rule: entries whose reference
  gradient is above 1e-3 of its leaf's largest and above 1e-4 (so eps is
  negligible and the sign is fixed) must agree to atol 1e-6 + rtol 1e-6
  in the new parameters; every other entry may differ by at most
  2 lr + 1e-6. The moments agree everywhere: mu to 1e-5 of its leaf's
  largest, nu to 2e-5 (nu is quadratic in g);
* the pair builders under ``JaxDraws`` (which replays ``jax.random``'s
  ``randint`` and weighted ``choice``): indices, tokens, masks and
  targets equal exactly, with and without ``row_weights``; Jaccard
  targets equal exactly; ``_distinct_partner`` never pairs a row with
  itself;
* ``pretrain_generic`` (3 steps) and ``finetune_categorical`` (3 epochs of
  1 step) under ``JaxDraws``: each returned mean loss to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.contrastive import finetune as jft
from repro.encoder import model as jenc
from repro import optim as jopt
from repro_torch import convert
from repro_torch.contrastive import finetune as tft
from repro_torch.core.draws import HostDraws
from repro_torch.encoder import model as tenc
from repro_torch import optim as topt
from repro_torch.models.layers import tree_leaves
from test_torch_env import JaxDraws

torch.set_num_threads(2)
SMALL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_len=12)
JC, TC = jenc.EncoderConfig(**SMALL), tenc.EncoderConfig(**SMALL)
LR = 2e-3


def _params(seed=1):
    return jax.device_get(jenc.init_encoder(jax.random.PRNGKey(seed), JC))


def _corpus(n=24, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, SMALL["vocab_size"],
                       (n, SMALL["max_len"])).astype(np.int32)
    mask = np.ones(tok.shape, np.float32)
    mask[1, 5:] = 0.0                        # a padded tail
    cats = rng.integers(0, 4, n).astype(np.int32)
    return tok, mask, cats


def _batch(seed=2, b=16):
    tok, mask, _ = _corpus(2 * b, seed)
    rng = np.random.default_rng(seed + 1)
    return {"tok_a": tok[:b], "mask_a": mask[:b], "tok_b": tok[b:],
            "mask_b": mask[b:], "target": rng.random(b).astype(np.float32)}


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _port(params):
    return convert.encoder_params_from_numpy(params, device="cpu")


def _grads_match(tg, jg):
    for a, b in zip(tg, jax.tree.leaves(jg)):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-5 * np.abs(b).max(), (a.shape, err)


def _step_matches(tp, ts, jp, js, jg):
    """The rule of the module docstring, leaf by leaf."""
    leaves = zip(tree_leaves(tp), tree_leaves(ts["mu"]), tree_leaves(ts["nu"]),
                 jax.tree.leaves(jp), jax.tree.leaves(js["mu"]),
                 jax.tree.leaves(js["nu"]), jax.tree.leaves(jg))
    n_loose = 0
    for p, mu, nu, rp, rmu, rnu, g in leaves:
        rp, rmu, rnu, g = map(np.asarray, (rp, rmu, rnu, g))
        diff = np.abs(p.numpy() - rp)
        fixed = np.abs(g) > np.maximum(1e-3 * np.abs(g).max(), 1e-4)
        assert (diff[fixed] <= 1e-6 + 1e-6 * np.abs(rp[fixed])).all()
        assert (diff <= 2 * LR + 1e-6).all()
        n_loose += int((~fixed).sum())
        np.testing.assert_allclose(mu.numpy(), rmu, rtol=0,
                                   atol=1e-5 * np.abs(rmu).max())
        np.testing.assert_allclose(nu.numpy(), rnu, rtol=0,
                                   atol=2e-5 * np.abs(rnu).max())
    assert int(ts["step"]) == int(js["step"])
    return n_loose


def test_cosine_loss_and_gradients_match_reference():
    params = _params()
    jb, tb = _both(_batch())
    jl, jg = jax.value_and_grad(jft.cosine_loss)(params, jb, JC)
    tl, tg = tft.loss_and_grads(_port(params), tb, TC)
    assert tl.shape == () and not tl.requires_grad
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    _grads_match(tree_leaves(tg), jg)


def test_train_step_matches_reference_then_a_second_step_from_its_state():
    params = _params()
    jp, js = params, jopt.adamw_init(params)
    tp, ts = _port(params), topt.adamw_init(_port(params))
    for step, seed in enumerate((2, 7)):
        jb, tb = _both(_batch(seed))
        jg = jax.grad(jft.cosine_loss)(jp, jb, JC)
        jp2, js2, jl = jft.train_step(jp, js, jb, JC, LR)
        tp2, ts2, tl = tft.train_step(tp, ts, tb, TC, LR)
        assert tl.shape == () and not tl.requires_grad
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        _step_matches(tp2, ts2, jp2, js2, jg)
        # the next step starts from the reference's own params and state
        jp, js = jax.device_get(jp2), jax.device_get(js2)
        tp = _port(jp)
        ts = convert.adamw_state_from_numpy(js, device="cpu")
    assert int(ts["step"]) == 2


@pytest.mark.parametrize("kind", ["category", "category_weighted",
                                  "generic"])
def test_pair_builders_match_reference_exactly(kind):
    tok, mask, cats = _corpus()
    key = jax.random.PRNGKey(11)
    if kind == "generic":
        want = jft.make_generic_pairs(key, jnp.asarray(tok),
                                      jnp.asarray(mask), 128, 40)
        got = tft.make_generic_pairs(JaxDraws(key), torch.from_numpy(tok),
                                     torch.from_numpy(mask), 128, 40)
    else:
        w = None
        if kind == "category_weighted":
            # a zero and a negative weight: both clamp to the 1e-9 floor
            w = np.random.default_rng(3).random(len(cats)).astype(np.float32)
            w[2], w[5] = 0.0, -1.0
        want = jft.make_category_pairs(key, jnp.asarray(tok),
                                       jnp.asarray(mask), jnp.asarray(cats),
                                       40, row_weights=w)
        got = tft.make_category_pairs(JaxDraws(key), torch.from_numpy(tok),
                                      torch.from_numpy(mask),
                                      torch.from_numpy(cats), 40,
                                      row_weights=w)
    for k in ("tok_a", "mask_a", "tok_b", "mask_b", "target"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert not (got["tok_a"] == got["tok_b"]).all(dim=1).any()


def test_jaccard_targets_match_reference_exactly():
    tok, _, _ = _corpus(30, seed=4)
    tok[3] = tok[4]                          # an identical pair: target 1
    want = jft.jaccard_targets(jnp.asarray(tok[:15]), jnp.asarray(tok[15:]),
                               128)
    got = tft.jaccard_targets(torch.from_numpy(tok[:15]),
                              torch.from_numpy(tok[15:]), 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same = tft.jaccard_targets(torch.from_numpy(tok[3:4]),
                               torch.from_numpy(tok[4:5]), 128)
    assert float(same) == 1.0


@pytest.mark.parametrize("n", [2, 3, 7])
def test_distinct_partner_never_pairs_a_row_with_itself(n):
    for src in (JaxDraws(jax.random.PRNGKey(n)), HostDraws(n)):
        ia = torch.arange(n).repeat(200)
        ib = tft._distinct_partner(src, ia, n)
        assert ib.dtype == torch.int64 and bool((ib != ia).all())
        assert int(ib.min()) >= 0 and int(ib.max()) < n
        assert set(ib.tolist()) == set(range(n))


def test_pretrain_and_finetune_losses_match_reference():
    params = _params(seed=3)
    tok, mask, cats = _corpus(seed=5)
    jtok, jmask, jcats = map(jnp.asarray, (tok, mask, cats))
    ttok, tmask, tcats = map(torch.from_numpy, (tok, mask, cats))
    key = jax.random.PRNGKey(21)
    jp, jl = jft.pretrain_generic(key, params, jtok, jmask, JC, steps=3,
                                  batch=16)
    tp, tl = tft.pretrain_generic(JaxDraws(key), _port(params), ttok, tmask,
                                  TC, steps=3, batch=16)
    assert len(tl) == 1
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    key = jax.random.PRNGKey(22)
    _, jl = jft.finetune_categorical(key, jax.device_get(jp), jtok, jmask,
                                     jcats, JC, epochs=3, steps_per_epoch=1,
                                     batch=16)
    _, tl = tft.finetune_categorical(JaxDraws(key), tp, ttok, tmask, tcats,
                                     TC, epochs=3, steps_per_epoch=1,
                                     batch=16)
    assert len(tl) == 3 and all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
