"""The slice as a whole: the JAX ``env.run`` against the port's ``run`` on
the same draws.

``JaxDraws`` below is a draw source (``repro_torch.core.draws``) that
replays the reference's key tree with ``jax.random``: ``split`` is
``jax.random.split`` (``fold_in`` and ``gumbel`` replay the calls of the
same names, ``distinct_pair`` the static baselines' per-row
``jax.random.choice(..., replace=False)``, ``randint`` and ``choice`` the
calls of the same names that build the encoder's training pairs,
``key_leaf`` / ``from_leaf`` the key itself, as a service checkpoint
holds it), and
``sgld(C, steps)`` hands out, per SGLD step, the
``randint``/``normal`` draws of every chain exactly as ``policy._act`` ->
``sgld_sample`` -> ``sgld_loop`` derive them (``sgld(None, steps)`` those
of one unbatched chain, as ``fgts_round`` draws them). So the port sees the
reference's numbers, and routed pairs must match exactly and the
cumulative regret to 1e-5. Both sides run at small shapes on the CPU (the
reference's Pallas kernels in interpret mode, the port's plain versions).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import fgts as jfgts
from repro.core import model_pool as jmp
from repro.core import policy as jpol
from repro_torch import convert
from repro_torch.core import env as tenv
from repro_torch.core import fgts as tfgts
from repro_torch.core import model_pool as tmp
from repro_torch.core import policy as tpol
from repro_torch.core.draws import HostDraws, TorchDraws

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _step_draws(keys, m, d, hi):
    """One SGLD step of every chain: split(k) -> (k_idx, k_noise)."""
    sub = jax.vmap(jax.random.split)(keys)
    idx = jax.vmap(lambda k: jax.random.randint(k, (m,), 0, hi))(sub[:, 0])
    noise = jax.vmap(lambda k: jax.random.normal(k, (d,)))(sub[:, 1])
    return idx, noise


class JaxSgldDraws:
    """Per-step keys of each chain: ``split(key, C)`` then ``split(k,
    steps)`` per chain, or for one unbatched chain (``n_chains`` None)
    ``split(key, steps)`` itself."""

    def __init__(self, key, n_chains, n_steps):
        if n_chains is None:
            self.keys = jax.random.split(key, n_steps)[None]
            return
        ks = jax.random.split(key, n_chains)
        self.keys = jax.vmap(lambda k: jax.random.split(k, n_steps))(ks)

    def step(self, i, m, hi, d, device):
        idx, noise = _step_draws(self.keys[:, i], m, d, jnp.int32(int(hi)))
        return t(idx).long().to(device), t(noise).to(device)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _distinct_pairs(key, b, n):
    """Per row ``jax.random.choice(k, n, (2,), replace=False)`` over
    ``split(key, b)``, as the static baselines draw."""
    return jax.vmap(lambda k: jax.random.choice(k, n, (2,), replace=False))(
        jax.random.split(key, b))


class JaxDraws:
    """Draw source replaying ``jax.random`` under one key."""

    def __init__(self, key):
        self.key = key

    def split(self, n):
        return [JaxDraws(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, i):
        return JaxDraws(jax.random.fold_in(self.key, i))

    def normal(self, shape, device):
        return t(jax.random.normal(self.key, shape)).to(device)

    def uniform(self, shape, device):
        return t(jax.random.uniform(self.key, shape)).to(device)

    def gumbel(self, shape, device):
        return t(jax.random.gumbel(self.key, shape)).to(device)

    def distinct_pair(self, b, n, device):
        return t(_distinct_pairs(self.key, b, n)).long().to(device)

    def randint(self, shape, lo, hi, device):
        return t(jax.random.randint(self.key, shape, lo, int(hi))).long().to(
            device)

    def choice(self, n, shape, p, device):
        p = jnp.asarray(np.asarray(p.detach().cpu(), np.float32))
        return t(jax.random.choice(self.key, n, shape, p=p)).long().to(device)

    def sgld(self, n_chains, n_steps):
        return JaxSgldDraws(self.key, n_chains, n_steps)

    def key_leaf(self):
        return np.asarray(self.key, np.uint32)

    def from_leaf(self, leaf):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.numpy()
        return JaxDraws(jnp.asarray(np.asarray(leaf, np.uint32)))


K, D, T = 5, 16, 48
GRID = np.array([0.0, 0.5, 2.0], np.float32)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return dict(a=rng.standard_normal((K, D)).astype(np.float32),
                x=rng.standard_normal((T, D)).astype(np.float32),
                u=rng.random((T, 8)).astype(np.float32),
                costs=rng.random(K).astype(np.float32))


def _cfgs(**kw):
    base = dict(n_models=8, dim=D, horizon=T, eta=2.0, mu=0.3, sgld_steps=3,
                sgld_minibatch=8, n_chains=2, force_distinct=True)
    base.update(kw)
    return jfgts.FGTSConfig(**base), tfgts.FGTSConfig(**base)


EVENTS = [(1, 1, None, None), (2, 6, "new", 0.4)]


def _both_runs(pooled, batch, delay, pref, seed=0):
    dat = _data(seed)
    jcfg, tcfg = _cfgs()
    if pooled:
        jp = jmp.init_pool(dat["a"], dat["costs"], 8)
        tp = tmp.init_pool(dat["a"], dat["costs"], 8, device="cpu")
        jpolicy, tpolicy = jpol.fgts_policy(jp, jcfg), tpol.fgts_policy(tp,
                                                                       tcfg)
        ev = [(s, sl, None if e is None else dat["a"][0] * 0.5, c)
              for s, sl, e, c in EVENTS]
        jsched, tsched = jmp.schedule(ev, D), tmp.schedule(ev, D,
                                                            device="cpu")
        u = dat["u"]
    else:
        jcfg, tcfg = _cfgs(n_models=K)
        jpolicy = jpol.fgts_policy(jnp.asarray(dat["a"]), jcfg,
                                   costs=jnp.asarray(dat["costs"]))
        tpolicy = tpol.fgts_policy(t(dat["a"]), tcfg, costs=t(dat["costs"]))
        jsched = tsched = None
        u = dat["u"][:, :K]
    jpref = tpref = None
    if pref:
        jpref = lambda s, xb: jnp.asarray(GRID)[(s + jnp.arange(batch)) % 3]
        tpref = lambda s, xb: t(GRID)[(s + torch.arange(batch)) % 3]
    key = jax.random.PRNGKey(seed)
    ref = jenv.run(key, jenv.EnvData(jnp.asarray(dat["x"]), jnp.asarray(u)),
                   jpolicy, batch=batch, delay=delay, pool_schedule=jsched,
                   aux_fn=lambda s, a1, a2: (a1, a2), pref_fn=jpref)
    tdelay = delay if not isinstance(delay, jenv.DelaySpec) else \
        tenv.DelaySpec(**dataclasses.asdict(delay))
    got = tenv.run(JaxDraws(key), tenv.EnvData(t(dat["x"]), t(u)), tpolicy,
                   batch=batch, delay=tdelay, pool_schedule=tsched,
                   aux_fn=lambda s, a1, a2: (a1, a2), pref_fn=tpref)
    return ref, got


def _inner(state):
    return state.inner if hasattr(state, "inner") else state


CASES = [
    # (pooled, batch, delay, pref)
    (False, 1, 0, False),
    (False, 8, 0, False),
    (True, 1, 0, False),
    (True, 8, 0, False),
    (True, 8, 2, False),
    (False, 8, 2, True),
    (True, 4, "per_item", False),
    (True, 8, "per_item", True),
    (True, 8, 0, True),
]


@pytest.mark.parametrize("pooled,batch,delay,pref", CASES)
def test_env_run_matches_reference(pooled, batch, delay, pref):
    if delay == "per_item":
        delay = jenv.DelaySpec(delay=2, per_item=True)
    ref, got = _both_runs(pooled, batch, delay, pref)
    (j_cum, j_state, (j_a1, j_a2)), (t_cum, t_state, (t_a1, t_a2)) = ref, got
    np.testing.assert_array_equal(t_a1.numpy(), np.asarray(j_a1))
    np.testing.assert_array_equal(t_a2.numpy(), np.asarray(j_a2))
    np.testing.assert_allclose(t_cum.numpy(), np.asarray(j_cum), rtol=1e-5,
                               atol=1e-5)
    ji, ti = _inner(j_state), _inner(t_state)
    assert int(ti.t) == int(ji.t)
    for f in ("a1", "a2", "y", "pref"):
        np.testing.assert_array_equal(getattr(ti, f).numpy(),
                                      np.asarray(getattr(ji, f)), err_msg=f)
    np.testing.assert_array_equal(ti.x.numpy(), np.asarray(ji.x))
    for f in ("theta1", "theta2"):
        np.testing.assert_allclose(getattr(ti, f).numpy(),
                                   np.asarray(getattr(ji, f)), rtol=1e-4,
                                   atol=1e-5, err_msg=f)
    if pooled:
        np.testing.assert_array_equal(t_state.pool.active.numpy(),
                                      np.asarray(j_state.pool.active))


def test_state_carried_mid_run_continues_alike():
    """A mid-run JAX state moved into the port through ``convert`` and
    continued on both sides routes the same pairs."""
    dat = _data(3)
    jcfg, tcfg = _cfgs()
    jp = jmp.init_pool(dat["a"], dat["costs"], 8)
    jpolicy = jpol.fgts_policy(jp, jcfg)
    key = jax.random.PRNGKey(7)
    _, jstate = jenv.run(key, jenv.EnvData(jnp.asarray(dat["x"][:24]),
                                           jnp.asarray(dat["u"][:24])),
                         jpolicy, batch=4)
    host = jax.device_get(jstate)
    inner = {f: getattr(host.inner, f) for f in jfgts.FGTSState._fields}
    pool = {f: getattr(host.pool, f) for f in jmp.ModelPool._fields}
    tstate = convert.pooled_state_from_numpy(inner, pool, device="cpu")
    back = convert.state_to_numpy(tstate)
    np.testing.assert_array_equal(back["inner"]["x"], np.asarray(host.inner.x))
    tpolicy = tpol.fgts_policy(tstate.pool, tcfg)
    ticks = jax.random.split(jax.random.PRNGKey(8), 3)
    rng = np.random.default_rng(0)
    j_act = jax.jit(jpolicy.act)
    for s, k in enumerate(ticks):
        xb = dat["x"][24 + 4 * s:28 + 4 * s]
        jstate, j1, j2 = j_act(k, jstate, jnp.asarray(xb))
        tstate, t1, t2 = tpolicy.act(JaxDraws(k), tstate, t(xb))
        np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
        np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))
        y = np.where(rng.random(4) < 0.5, 1.0, -1.0).astype(np.float32)
        jstate = jpolicy.update(jstate, jnp.asarray(xb), j1, j2,
                                jnp.asarray(y))
        tstate = tpolicy.update(tstate, t(xb), t1, t2, t(y))
    np.testing.assert_allclose(tstate.inner.theta1.numpy(),
                               np.asarray(jstate.inner.theta1), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "autodiff"])
def test_sgld_backends_agree_under_replay(backend):
    """The forced-plain and autograd backends replay the same chains as the
    default one (the JAX side uses its own default)."""
    dat = _data(1)
    jcfg, tcfg = _cfgs(n_models=K)
    key = jax.random.PRNGKey(2)
    runs = []
    for be in ("auto", backend):
        pol = tpol.fgts_policy(t(dat["a"]),
                               dataclasses.replace(tcfg, sgld_backend=be))
        runs.append(tenv.run(JaxDraws(key), tenv.EnvData(
            t(dat["x"][:16]), t(dat["u"][:16, :K])), pol, batch=4))
    np.testing.assert_allclose(runs[1][0].numpy(), runs[0][0].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runs[1][1].theta1.numpy(),
                               runs[0][1].theta1.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_chain_energy_is_the_windowed_potential():
    """``chain_energy`` is U(theta) on the newest minibatch-sized window:
    equal to the JAX potential on the same rows."""
    dat = _data(2)
    jcfg, tcfg = _cfgs(n_models=K, sgld_minibatch=6)
    pol = tpol.fgts_policy(t(dat["a"]), tcfg)
    _, st = tenv.run(HostDraws(0), tenv.EnvData(t(dat["x"][:12]),
                                                t(dat["u"][:12, :K])),
                     pol, batch=4)
    e = tfgts.chain_energy(st, t(dat["a"]), tcfg)
    assert e.shape == (2, 2)
    js = jfgts.FGTSState(**{f: jnp.asarray(convert.state_to_numpy(st)[f])
                            for f in jfgts.FGTSState._fields})
    rows = jnp.asarray([11, 10, 9, 8, 7, 6])
    for j, th in ((1, js.theta1), (2, js.theta2)):
        for c in range(2):
            ref = jfgts._potential(th[c], rows, js, jnp.asarray(dat["a"]), j,
                                   jcfg)
            np.testing.assert_allclose(e[j - 1, c].item(), float(ref),
                                       rtol=1e-5)


def test_averaged_runs_and_torch_draws():
    dat = _data(4)
    _, tcfg = _cfgs(n_models=K)
    pol = tpol.fgts_policy(t(dat["a"]), tcfg)
    envd = tenv.EnvData(t(dat["x"][:16]), t(dat["u"][:16, :K]))
    mean, curves = tenv.averaged_runs(
        lambda d: tenv.run(d, envd, pol, batch=4), TorchDraws(0, "cpu"), 3)
    assert curves.shape == (3, 16) and mean.shape == (16,)
    assert not torch.equal(curves[0], curves[1])   # a stream, not a replay
    with pytest.raises(ValueError):
        tenv.run(TorchDraws(0, "cpu"), envd, pol, batch=17)
