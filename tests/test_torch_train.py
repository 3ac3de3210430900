"""LM training in the port against the JAX package, on the CPU.

From the reference's parameters of each architecture's ``reduced()``
config (fp32, d_model 256, one unit), carried over with
``convert.lm_params_from_numpy``, and batches made with numpy (labels
include -1, which the loss masks out):

* ``lm.loss_fn``'s loss, nll and aux, and the gradient of every parameter
  leaf, against ``jax.value_and_grad(repro.models.lm.loss_fn,
  has_aux=True)``, for all ten architectures (S 136: past the reduced
  window of 128; seamless's encoder over 32 frames, llava's 16 patches
  before the text). Loss to rtol 1e-5, gradients to 1e-4 of each leaf's
  largest magnitude;
* ``lm.forward`` with ``remat=True`` against ``remat=False``: the same
  logits and gradients (rematerialising a unit recomputes it exactly);
* autograd of ``rglru_scan_plain`` and ``rglru_scan_bwd_plain`` (the
  backward kernel's plain version) against ``jax.grad`` of
  ``repro.models.rglru.linear_scan``, with h0 and a channel whose log_a
  is exactly 0, where the reference's gradient through the clamp's square
  root is +-inf for log_a (NaN where the incoming gradient times x is 0):
  the port gives the same values there;
* the MoE FFN's gradient (sparse with drops, and dense) against the
  reference's;
* ``launch.steps.make_train_step``'s metrics over two steps against the
  reference's ``make_train_step``; ``optim.adamw_update_`` (in place)
  against ``adamw_update`` bitwise in fp32 and against the reference's in
  bf16 (a bf16 gradient is widened before the clip scale, as JAX does);
* ``launch.train.synthetic_batch`` under ``JaxDraws``, bitwise equal to
  the reference's;
* ``launch.train.train`` for 3 steps from a step-0 checkpoint written from
  the reference's init, in both packages: the losses within rtol 1e-3
  (Adam moves a parameter by about lr sign(g), so parameters are never
  compared elementwise after a step), each package restores the other's
  final checkpoint, and a longer run resumes from it.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import ARCHS as JARCHS
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.optim import adamw as jadamw
from repro_torch import checkpoint as tckpt
from repro_torch import convert
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels import rglru_scan as trg
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw as tadamw
from test_torch_env import JaxDraws

torch.set_num_threads(2)
ARCH_NAMES = sorted(TARCHS)
B, S = 2, 136
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def cfgs(name):
    return JARCHS[name].reduced(), TARCHS[name].reduced()


def params(name, seed=1):
    jc, _ = cfgs(name)
    jp = jax.device_get(jlm.init_params(jax.random.PRNGKey(seed), jc))
    return jp, convert.lm_params_from_numpy(jp, "cpu")


def batch(jc, seed=0, b=B, s=S):
    """Tokens and labels (a quarter of them -1), the vision patches and
    the encoder's frames, as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    text = s
    if jc.frontend == "vision":
        text = s - jc.n_frontend_tokens
        out["patches"] = rng.standard_normal(
            (b, jc.n_frontend_tokens, jc.d_model)).astype(np.float32)
    if jc.is_encdec:
        out["frames"] = rng.standard_normal(
            (b, jc.enc_frames, jc.d_model)).astype(np.float32)
    out["tokens"] = rng.integers(0, jc.vocab_size, (b, text)).astype(
        np.int32)
    labels = rng.integers(0, jc.vocab_size, (b, text)).astype(np.int32)
    labels[rng.random((b, text)) < 0.25] = -1
    out["labels"] = labels
    return out


def to_torch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def grads_close(got_tree, want_tree, tol=GRAD_TOL):
    got, want = tree_leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == w.shape
        top = float(np.abs(w).max())
        assert float(np.abs(g - w).max()) <= tol * max(top, 1e-30)


# ---------------------------------------------------------------------------
# loss_fn and its gradient, every architecture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_and_grads_match_reference(name):
    jc, tc = cfgs(name)
    jp, tp = params(name)
    nb = batch(jc)
    # jitted: eagerly, the reference's associative scans take ~20 s
    (wloss, wm), wgrads = jax.jit(
        jax.value_and_grad(jlm.loss_fn, has_aux=True), static_argnums=2)(
        jp, jax.tree.map(jnp.asarray, nb), jc)
    loss, metrics, grads = tsteps.loss_and_grads(tp, to_torch(nb), tc)
    # the caller's leaves are not marked as requiring grad
    assert not any(t.requires_grad for t in tree_leaves(tp))
    np.testing.assert_allclose(float(loss), float(wloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["nll"]), float(wm["nll"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(wm["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    grads_close(grads, wgrads)


@pytest.mark.parametrize("name", ["granite-3-2b", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m",
                                  "seamless-m4t-medium"])
def test_remat_changes_nothing(name):
    """Rematerialised units (and seamless's encoder units, always
    rematerialised under grad) give the logits and gradients of the plain
    forward."""
    tc = TARCHS[name].reduced(max_units=2)
    gen = torch.Generator().manual_seed(0)
    tp = tlm.init_params(gen, tc, device="cpu")
    tb = to_torch(batch(tc, s=40))
    w = torch.randn((B, 40, tc.vocab_size), generator=gen)
    out = []
    for remat in (True, False):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in tree_leaves(tp)]
        p = tree_unflatten(tp, leaves)
        logits, aux = tlm.forward(p, tb, tc, remat=remat)
        g = torch.autograd.grad((logits * w).sum() + aux, leaves,
                                allow_unused=True)
        out.append((logits.detach(), g))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the RG-LRU scan's gradient
# ---------------------------------------------------------------------------

def _same_nonfinite(got, want):
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got[np.isinf(want)], want[np.isinf(want)])
    return fin


@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_grad_matches_jax(with_h0):
    rng = np.random.default_rng(3)
    b, s, d = 2, 37, 8
    log_a = (-0.1 * np.abs(rng.standard_normal((b, s, d)))).astype(
        np.float32)
    log_a[:, :, 2] = 0.0                      # the clamp: a = 1, b = 0
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    x[0, 5, 2] = 0.0                          # g x = 0 there: NaN
    h0 = rng.standard_normal((b, d)).astype(np.float32) if with_h0 else None
    wh = rng.standard_normal((b, s, d)).astype(np.float32)
    wl = rng.standard_normal((b, d)).astype(np.float32)

    def jloss(la, xx, hh):
        h, hl = jrglru.linear_scan(la, xx, hh)
        return jnp.sum(h * wh) + jnp.sum(hl * wl)
    argnums = (0, 1, 2) if with_h0 else (0, 1)
    want = jax.jit(jax.grad(jloss, argnums=argnums))(log_a, x, h0)
    want = [np.asarray(w) for w in want]
    # the reference there: +-inf for log_a, NaN where g x = 0, finite x
    assert np.isinf(want[0][:, 1:, 2]).any()
    assert np.isnan(want[0][0, 5, 2])
    assert np.isfinite(want[1]).all()

    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (log_a, x, h0) if a is not None]
    h, hl = trg.rglru_scan(ts[0], ts[1], ts[2] if with_h0 else None)
    got = torch.autograd.grad((h * torch.from_numpy(wh)).sum()
                              + (hl * torch.from_numpy(wl)).sum(), ts)
    plain = trg.rglru_scan_bwd_plain(
        torch.from_numpy(log_a), torch.from_numpy(x),
        None if h0 is None else torch.from_numpy(h0), h.detach(),
        torch.from_numpy(wh), torch.from_numpy(wl))
    for mine in (got, plain[:len(want)]):
        for g, w in zip(mine, want):
            g = g.detach().numpy()
            fin = _same_nonfinite(g, w)
            top = float(np.abs(w[fin]).max())
            assert float(np.abs(g[fin] - w[fin]).max()) <= 1e-5 * top
    if not with_h0:
        assert plain[2] is None


# ---------------------------------------------------------------------------
# the MoE FFN's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl,factor", [("sparse", 0.25), ("sparse", 1.25),
                                         ("dense", None)])
def test_moe_grad_matches_reference(impl, factor):
    """The gradient of a weighted sum of the MoE FFN's output plus its aux
    loss, for the input and every parameter: sparse at capacity factor
    0.25 (drops) and 1.25, and dense."""
    jc, tc = cfgs("granite-moe-3b-a800m")
    jp = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(3), jc,
                                      jnp.float32))
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 24, jc.d_model)).astype(np.float32)

    def jf(p, xx):
        out, aux = (jmoe.moe_ffn_sparse(p, xx, jc, factor) if impl ==
                    "sparse" else jmoe.moe_ffn_dense(p, xx, jc))
        return jnp.sum(out * w) + aux
    wgp, wgx = jax.jit(jax.grad(jf, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = convert.lm_params_from_numpy(jp, "cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = (tmoe.moe_ffn_sparse(tp, tx, tc, factor) if impl == "sparse"
                else tmoe.moe_ffn_dense(tp, tx, tc))
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                              leaves + [tx])
    grads_close(list(got[:-1]), jax.tree.leaves(wgp))
    grads_close([got[-1]], [wgx])


# ---------------------------------------------------------------------------
# the optimizer and the train step
# ---------------------------------------------------------------------------

def test_adamw_in_place_matches_functional_and_reference():
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 5), "b": {"c": (70,), "d": (2, 4, 3)}, "e": ()}

    def tree(scale):
        draw = lambda s: np.asarray(scale * rng.standard_normal(s),
                                    np.float32)
        return {k: ({kk: draw(ss) for kk, ss in v.items()}
                    if isinstance(v, dict) else draw(v))
                for k, v in shapes.items()}
    p, g = tree(1.0), tree(3.0)
    tp = tree_map(torch.from_numpy, p)
    tg = tree_map(torch.from_numpy, g)
    st = tadamw.adamw_init(tp)
    st["mu"] = tree_map(lambda t: t + 0.1, st["mu"])
    st["nu"] = tree_map(lambda t: t + 0.2, st["nu"])
    want_p, want_s = tadamw.adamw_update(tp, tg, st, 1e-2, weight_decay=0.1)
    ip = tree_map(torch.clone, tp)
    ist = {k: (tree_map(torch.clone, v) if isinstance(v, dict)
               else v.clone()) for k, v in st.items()}
    old = tadamw.INPLACE_SLICE
    tadamw.INPLACE_SLICE = 8           # slice the leaves of this tree too
    try:
        got_p, got_s = tadamw.adamw_update_(ip, tg, ist, 1e-2,
                                            weight_decay=0.1)
    finally:
        tadamw.INPLACE_SLICE = old
    assert got_p is ip and got_s is ist
    for a, b in zip(tree_leaves((got_p, got_s["mu"], got_s["nu"])),
                    tree_leaves((want_p, want_s["mu"], want_s["nu"]))):
        assert torch.equal(a, b)
    assert int(got_s["step"]) == 1
    # bf16 parameters and gradients, clipped: the reference widens the
    # gradient before the clip scale
    pb = tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    gb = tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
    jnew, _ = jadamw.adamw_update(pb, gb, jadamw.adamw_init(pb), 1e-2,
                                  weight_decay=0.1)
    tpb = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), p)
    tgb = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), g)
    tadamw.adamw_update_(tpb, tgb, tadamw.adamw_init(tpb), 1e-2,
                         weight_decay=0.1)
    for a, b in zip(tree_leaves(tpb), jax.tree.leaves(jnew)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("name", ["granite-3-2b", "granite-moe-3b-a800m"])
def test_train_step_metrics_match_reference(name):
    jc, tc = cfgs(name)
    jp, tp = params(name)
    jstep = jax.jit(jsteps.make_train_step(jc, lr=1e-3))
    tstep = tsteps.make_train_step(tc, lr=1e-3)
    jopt, topt = jadamw.adamw_init(jp), tadamw.adamw_init(tp)
    for i in range(2):
        nb = batch(jc, seed=10 + i, s=48)
        jp, jopt, wm = jstep(jp, jopt, jax.tree.map(jnp.asarray, nb))
        tp_out, topt, m = tstep(tp, topt, to_torch(nb))
        assert tp_out is tp
        # the first step from equal parameters is tight; the second
        # follows Adam's sign steps, which rounding may flip
        rtol = LOSS_RTOL if i == 0 else 1e-3
        for k in ("loss", "nll", "aux"):
            np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=rtol,
                                       atol=1e-7)
    assert int(topt["step"]) == 2


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["granite-3-2b", "llava-next-34b",
                                  "seamless-m4t-medium"])
def test_synthetic_batch_matches_reference(name):
    jc, tc = cfgs(name)
    key = jax.random.PRNGKey(5)
    want = jtrain.synthetic_batch(key, jc, 2, 40)
    got = ttrain.synthetic_batch(JaxDraws(key), tc, 2, 40, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_train_restores_resumes_and_matches_reference(tmp_path, capsys):
    name, seed = "granite-3-2b", 0
    jc, _ = cfgs(name)
    key = jax.random.PRNGKey(seed)
    k_init, _ = jax.random.split(key)
    jp0 = jlm.init_params(k_init, jc)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jckpt.save_checkpoint(str(jdir), 0, jp0)
    shutil.copytree(jdir, tdir)
    want = jtrain.train(name, 3, 2, 32, True, ckpt_dir=str(jdir), seed=seed)
    got = ttrain.train(name, 3, 2, 32, True, ckpt_dir=str(tdir), seed=seed,
                       device="cpu", draws=JaxDraws(key))
    assert "restored step 0" in capsys.readouterr().out
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert np.isfinite(got).all()
    # each package restores the other's step-3 checkpoint
    assert tckpt.latest_step(str(tdir)) == 3
    like = convert.lm_params_from_numpy(jax.device_get(jp0), "cpu")
    from_jax = tckpt.restore_checkpoint(str(jdir), 3, like)
    from_torch = jckpt.restore_checkpoint(str(tdir), 3, jp0)
    for a, b in zip(tree_leaves(from_jax), jax.tree.leaves(from_torch)):
        assert a.shape == b.shape
    # and the port resumes from its own: steps 3 and 4 only
    more = ttrain.train(name, 5, 2, 32, True, ckpt_dir=str(tdir), seed=seed,
                        device="cpu", draws=JaxDraws(key))
    assert len(more) == 2 and "restored step 3" in capsys.readouterr().out
    assert tckpt.latest_step(str(tdir)) == 5


def test_main_runs_on_the_cpu(capsys):
    losses = ttrain.main(["--device", "cpu", "--arch", "mamba2-1.3b",
                          "--steps", "2", "--batch", "1", "--seq", "24"])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert "[train] done" in capsys.readouterr().out
