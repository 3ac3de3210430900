"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's, on the CPU.

From the reference's parameters (``init_moe`` at granite-moe-3b-a800m's
and arctic-480b's ``reduced()`` widths: d 256, 4 experts, top 2, fp32),
carried over with ``convert.lm_params_from_numpy``, and inputs made with
numpy from a seed:

* ``_route``: the gate and the aux loss to 2e-4, the expert indices
  exactly; a deliberate tie (duplicated router columns, integer-valued
  inputs, so tied logits are bitwise equal, with k straddling the tie)
  picks the experts ``jax.lax.top_k`` picks, lowest index first;
* ``moe_ffn_sparse`` at capacity factor 1.25 (no drops), at 0.25 and with
  the router biased to one expert (both drop): outputs to 2e-4 and the set
  of dropped (token, slot) assignments equal, and no kept buffer row
  written twice; the tie case's drops too;
* ``moe_ffn_dense`` and ``moe_ffn(impl=...)``; sparse equals dense where
  nothing drops;
* arctic's ``FFN_MOE_DENSE`` block (the dense residual MLP beside the
  experts): ``block_fwd`` (with its aux loss), ``block_prefill`` and
  ``block_step`` (``moe_decode_impl``);
* ``capacity`` over a grid of N, K, E and factor, equal to the
  reference's;
* the module holds none of the calls that sync the host with the card.

Tolerance 2e-4, as ``tests/test_torch_lm.py``'s.
"""
import ast
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import blocks as jblocks
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import convert
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.models import blocks as tblocks
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TModelConfig

torch.set_num_threads(2)
TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 24


def cfgs(name="granite-moe-3b-a800m"):
    return JARCHS[name].reduced(), TARCHS[name].reduced()


def moe_params(jc, seed=3):
    jp = jax.device_get(jmoe.init_moe(jax.random.PRNGKey(seed), jc,
                                      jnp.float32))
    return jp, convert.lm_params_from_numpy(jp, "cpu")


def inputs(jc, seed=4, b=B, s=S):
    return np.random.default_rng(seed).standard_normal(
        (b, s, jc.d_model)).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def ref_drops(jp, x, jc, factor):
    """The reference's dropped (token, slot) assignments, by its own
    lines (``repro/models/moe.py:73-86``)."""
    n, k, e = x.shape[0] * x.shape[1], jc.top_k, jc.n_experts
    c = jmoe.capacity(n, jc, factor)
    _, topi, _ = jmoe._route(jp, jnp.asarray(x.reshape(n, -1)), jc)
    flat_e = topi.reshape(-1)
    sort_idx = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    starts = jnp.searchsorted(sorted_e, jnp.arange(e))
    pos_in_e = jnp.arange(n * k) - starts[sorted_e]
    dropped = np.asarray(sort_idx)[np.asarray(pos_in_e >= c)]
    return {(int(a) // k, int(a) % k) for a in dropped}


def port_drops(tp, x, tc, factor):
    """The port's dropped (token, slot) assignments and its kept buffer
    rows, from ``moe.dispatch``."""
    n, k, e = x.shape[0] * x.shape[1], tc.top_k, tc.n_experts
    c = tmoe.capacity(n, tc, factor)
    _, topi, _ = tmoe._route(tp, torch.from_numpy(x.reshape(n, -1)), tc)
    dest, sort_idx, slot = tmoe.dispatch(topi, e, c)
    dropped = sort_idx[dest == e * c].tolist()
    kept = dest[dest < e * c]
    assert torch.equal(slot, dest[torch.argsort(sort_idx)])
    return {(a // k, a % k) for a in dropped}, kept, c


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "arctic-480b"])
def test_route_matches_reference(name):
    jc, tc = cfgs(name)
    jp, tp = moe_params(jc)
    x = inputs(jc).reshape(B * S, -1)
    wg, wi, wa = jmoe._route(jp, jnp.asarray(x), jc)
    gate, idx, aux = tmoe._route(tp, torch.from_numpy(x), tc)
    assert gate.dtype == torch.float32 and aux.dtype == torch.float32
    close(gate, wg)
    close(aux, wa)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))


def tie_case(e=8, k=3):
    """Integer-valued x and router with columns 1, 2, 4 and 6 equal: the
    logits are exact integers, so those four tie bitwise on every row; with
    k 3 on top of a larger column 0, the top k straddles the tie."""
    jc = JModelConfig(name="tie", family="moe", d_model=16, n_heads=2,
                      n_kv_heads=2, d_ff=32, vocab_size=8, pattern=(),
                      n_units=1, n_experts=e, top_k=k, dtype="float32")
    tc = TModelConfig(**{f: getattr(jc, f) for f in (
        "name", "family", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab_size", "pattern", "n_units", "n_experts", "top_k", "dtype")})
    rng = np.random.default_rng(9)
    x = rng.integers(1, 4, (B, S, 16)).astype(np.float32)
    router = rng.integers(-2, 3, (16, e)).astype(np.float32)
    router[:, [2, 4, 6]] = router[:, [1]]
    router[:, 0] = router[:, 1] + 1.0          # column 0 above the tie
    router[:, [3, 5, 7]] = router[:, [1]] - 1.0
    jp, _ = moe_params(jc)
    jp = dict(jp, router=router)
    return jc, tc, jp, convert.lm_params_from_numpy(jp, "cpu"), x


def test_tied_logits_pick_the_experts_top_k_picks():
    jc, tc, jp, tp, x = tie_case()
    xf = x.reshape(B * S, -1)
    _, wi, _ = jmoe._route(jp, jnp.asarray(xf), jc)
    _, idx, _ = tmoe._route(tp, torch.from_numpy(xf), tc)
    want = np.asarray(wi)
    assert (want == [0, 1, 2]).all()            # lowest index first
    np.testing.assert_array_equal(idx.numpy(), want)
    _, top_i = jax.lax.top_k(jnp.asarray(xf) @ jnp.asarray(jp["router"]), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(top_i))


@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_tie_case_drops_what_the_reference_drops(factor):
    jc, tc, jp, tp, x = tie_case()
    want_out, _ = jmoe.moe_ffn_sparse(jp, jnp.asarray(x), jc, factor)
    got_out, _ = tmoe.moe_ffn_sparse(tp, torch.from_numpy(x), tc, factor)
    close(got_out, want_out)
    got, kept, _ = port_drops(tp, x, tc, factor)
    assert got == ref_drops(jp, x, jc, factor)
    assert kept.unique().numel() == kept.numel()
    assert len(got) > 0         # every token picks experts 0, 1 and 2


# ---------------------------------------------------------------------------
# sparse and dense dispatch
# ---------------------------------------------------------------------------

def test_sparse_without_drops_matches_reference():
    jc, tc = cfgs()
    jp, tp = moe_params(jc)
    x = inputs(jc)
    want, waux = jmoe.moe_ffn_sparse(jp, jnp.asarray(x), jc, 1.25)
    got, aux = tmoe.moe_ffn_sparse(tp, torch.from_numpy(x), tc, 1.25)
    close(got, want)
    close(aux, waux)
    drops, kept, c = port_drops(tp, x, tc, 1.25)
    assert drops == set() == ref_drops(jp, x, jc, 1.25)
    assert kept.numel() == B * S * tc.top_k
    assert kept.unique().numel() == kept.numel()
    # nothing dropped: the sparse dispatch is the dense one
    close(got, tmoe.moe_ffn_dense(tp, torch.from_numpy(x), tc)[0].numpy())


@pytest.mark.parametrize("case", ["low_capacity", "biased_router"])
def test_sparse_with_drops_matches_reference(case):
    jc, tc = cfgs()
    jp, tp = moe_params(jc)
    x = inputs(jc, seed=5)
    factor = 0.25 if case == "low_capacity" else 1.25
    if case == "biased_router":
        # every token's first choice is expert 0: half its assignments
        # overflow a capacity of N K / E * 1.25
        router = np.array(jp["router"])
        router[:, 0] += 10.0 * np.sign(x.reshape(B * S, -1).sum(0))
        jp = dict(jp, router=router)
        tp = convert.lm_params_from_numpy(jp, "cpu")
    want, waux = jmoe.moe_ffn_sparse(jp, jnp.asarray(x), jc, factor)
    got, aux = tmoe.moe_ffn_sparse(tp, torch.from_numpy(x), tc, factor)
    close(got, want)
    close(aux, waux)
    drops, kept, c = port_drops(tp, x, tc, factor)
    assert drops == ref_drops(jp, x, jc, factor)
    assert len(drops) > 0
    assert kept.numel() + len(drops) == B * S * tc.top_k
    assert kept.unique().numel() == kept.numel()       # no slot twice
    assert int(kept.max()) < tc.n_experts * c


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "arctic-480b"])
def test_dense_matches_reference(name):
    jc, tc = cfgs(name)
    jp, tp = moe_params(jc)
    x = inputs(jc, seed=6)
    want, waux = jmoe.moe_ffn_dense(jp, jnp.asarray(x), jc)
    got, aux = tmoe.moe_ffn_dense(tp, torch.from_numpy(x), tc)
    close(got, want)
    close(aux, waux)
    if name == "arctic-480b":
        assert "dense" in tp


@pytest.mark.parametrize("impl", ["sparse", "dense"])
def test_moe_ffn_dispatches_by_impl(impl):
    jc, tc = cfgs("arctic-480b")
    jp, tp = moe_params(jc)
    x = inputs(jc, seed=7, s=5)
    want, _ = jmoe.moe_ffn(jp, jnp.asarray(x), jc, impl=impl)
    got, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), tc, impl=impl)
    close(got, want)


def test_arctic_moe_dense_block_matches_reference():
    """arctic-480b's FFN_MOE_DENSE block: block_fwd (and its aux loss),
    block_prefill (sparse) and block_step (dense decode)."""
    jc, tc = cfgs("arctic-480b")
    jspec, tspec = jc.pattern[0], tc.pattern[0]
    assert tspec.ffn == "moe_dense"
    jp = jax.device_get(jblocks.init_block(jax.random.PRNGKey(2), jc, jspec,
                                           jnp.float32))
    tp = convert.lm_params_from_numpy(jp, "cpu")
    x = inputs(jc, seed=8)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    want, waux = jblocks.block_fwd(jp, jnp.asarray(x), jnp.asarray(pos), jc,
                                   jspec)
    got, aux = tblocks.block_fwd(tp, torch.from_numpy(x),
                                 torch.from_numpy(pos), tc, tspec)
    close(got, want)
    close(aux, waux)
    assert float(aux) > 0.0
    want, jcache = jblocks.block_prefill(jp, jnp.asarray(x), jnp.asarray(pos),
                                         jc, jspec, S + 1)
    got, tcache = tblocks.block_prefill(tp, torch.from_numpy(x),
                                        torch.from_numpy(pos), tc, tspec,
                                        S + 1)
    close(got, want)
    x1 = inputs(jc, seed=9, s=1)
    want, _ = jblocks.block_step(jp, jnp.asarray(x1), jcache, jnp.int32(S),
                                 jc, jspec)
    got, _ = tblocks.block_step(tp, torch.from_numpy(x1), tcache, S, tc,
                                tspec)
    close(got, want)


@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 2.0])
def test_capacity_matches_reference(factor):
    for n in (1, 7, 8, 48, 200, 4096, 8192):
        for k, e in ((1, 4), (2, 4), (2, 128), (8, 40), (3, 7)):
            jc, tc = (dataclasses.replace(c, top_k=k, n_experts=e)
                      for c in cfgs())
            want = jmoe.capacity(n, jc, factor)
            got = tmoe.capacity(n, tc, factor)
            assert got == want and got % 8 == 0 and got >= 8, (n, k, e)


def test_moe_holds_no_host_sync():
    """No call in the module that reads a device value back to the host
    (the card test runs ``moe_ffn`` under ``set_sync_debug_mode("error")``
    as well), and no ``torch.topk`` (its tie order is not ``top_k``'s)."""
    calls = set()
    for node in ast.walk(ast.parse(inspect.getsource(tmoe))):
        if isinstance(node, ast.Call):
            f = node.func
            calls.add(f.attr if isinstance(f, ast.Attribute) else
                      getattr(f, "id", None))
    assert "sort" in calls and "index_add_" in calls
    for bad in ("item", "tolist", "nonzero", "bincount", "repeat_interleave",
                "topk", "cpu", "numpy", "masked_select"):
        assert bad not in calls, bad
