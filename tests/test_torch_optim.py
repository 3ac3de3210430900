"""The port's optimizer (``repro_torch.optim``) against the JAX package's,
on the CPU, from the same numpy parameters, gradients and state.

* ``adamw_update``: two steps, with and without weight decay and gradient
  clipping, on identical gradients (the second step from the first step's
  state), new parameters and both moments to rtol 1e-6;
* ``global_norm`` over a nested dict in ``jax.tree.leaves`` order (sorted
  keys), and ``clip_by_global_norm`` on both sides of its threshold;
* ``adamw_init``'s tree and ``convert.adamw_state_from_numpy``;
* ``cosine_schedule`` and ``linear_warmup_cosine`` at steps across their
  warm-up, decay and floor, to rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.models.layers import tree_leaves

torch.set_num_threads(2)
TIGHT = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, scale=1.0):
    """A nested dict of float32 arrays with keys out of sorted order, as
    the encoder's tree has them."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return {"units": {"0": {"norm1": f(2, 8), "mixer": {"wq": f(2, 8, 4),
                                                        "wk": f(2, 8, 4)}}},
            "embed": f(16, 8), "final_norm": f(8)}


def _torch(tree):
    return convert.encoder_params_from_numpy(tree, device="cpu")


def _assert_tree_close(got, want, **tol):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("weight_decay,max_grad_norm,grad_scale", [
    (0.0, 0.0, 1.0),        # plain Adam, no clipping
    (0.01, 1.0, 1.0),       # the encoder's training step: clipped (norm > 1)
    (0.01, 1.0, 0.01),      # under the clip threshold: unclipped
    (0.1, 0.5, 3.0),
])
def test_adamw_update_matches_reference_for_two_steps(weight_decay,
                                                      max_grad_norm,
                                                      grad_scale):
    params = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    kw = dict(weight_decay=weight_decay, max_grad_norm=max_grad_norm)
    for step in range(2):
        grads = _tree(10 + step, grad_scale)
        jp, js = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, grads), js,
                                   2e-3, **kw)
        tp, ts = topt.adamw_update(tp, _torch(grads), ts, 2e-3, **kw)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        _assert_tree_close(tp, jp, **TIGHT)
        _assert_tree_close(ts["mu"], js["mu"], **TIGHT)
        _assert_tree_close(ts["nu"], js["nu"], **TIGHT)


def test_global_norm_sums_in_sorted_leaf_order():
    tree = _tree(3)
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = topt.global_norm(_torch(tree))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # the leaf order is the reference's: sorted keys at every level
    order = [a.shape for a in tree_leaves(_torch(tree))]
    assert order == [a.shape for a in jax.tree.leaves(tree)]


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches(max_norm):
    tree = _tree(4)
    jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                      max_norm)
    tg, tn = topt.clip_by_global_norm(_torch(tree), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_tree_close(tg, jg, **TIGHT)


def test_adamw_init_and_state_transfer():
    params = _tree(5)
    js = jopt.adamw_init(jax.tree.map(jnp.asarray, params))
    ts = topt.adamw_init(_torch(params))
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for a, b in zip(tree_leaves(ts["mu"]), jax.tree.leaves(js["mu"])):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert not a.any()
    _, js = jopt.adamw_update(jax.tree.map(jnp.asarray, params),
                              jax.tree.map(jnp.asarray, _tree(6)), js, 1e-3)
    back = convert.adamw_state_from_numpy(jax.device_get(js), device="cpu")
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 1
    _assert_tree_close(back["mu"], js["mu"], rtol=0, atol=0)
    _assert_tree_close(back["nu"], js["nu"], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["cosine", "warmup_cosine"])
def test_schedules_match(kind):
    if kind == "cosine":
        jf, tf = (jopt.cosine_schedule(3e-3, 100, 0.2),
                  topt.cosine_schedule(3e-3, 100, 0.2))
    else:
        jf, tf = (jopt.linear_warmup_cosine(3e-3, 10, 100),
                  topt.linear_warmup_cosine(3e-3, 10, 100))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = tf(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jf(step)), rtol=1e-6)
    steps = np.arange(0, 120, 7, dtype=np.int32)
    np.testing.assert_allclose(tf(torch.from_numpy(steps)).numpy(),
                               np.asarray(jf(jnp.asarray(steps))), rtol=1e-6)
