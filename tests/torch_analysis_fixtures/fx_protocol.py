"""Seeded protocol-conformance violations + clean twins, over the port's
``RoutingPolicy`` slots.

Parsed by tests/test_torch_analysis.py, never executed. The RoutingPolicy
defined here shadows the real one only inside the fixture context.
"""
from typing import Any, Callable, NamedTuple


class RoutingPolicy(NamedTuple):  # PLANT: protocol/registry-drift
    init: Callable
    act: Callable
    update: Callable
    name: str = "policy"
    update_delayed: Any = None
    update_masked: Any = None
    act_masked: Any = None
    act_pref: Any = None
    update_pref: Any = None
    propensity: Any = None
    act_greedy: Any = None   # rogue slot the lint's arity table doesn't know


def _init(draws):
    return {"t": 0}


def _act_ok(draws, state, x):
    return state, 0, 1


def _act_bad(state, x):
    # missing the draw source: 2 positional args where the protocol wants 3
    return state, 0, 1


def _update(state, x, a1, a2, y):
    return state


def make_bad_policy(temperature, a_emb):  # PLANT: protocol/pool-first
    return RoutingPolicy(  # PLANT: protocol/arity
        init=_init,
        act=_act_bad,
        update=_update,
        name="bad",
    )


# --------------------------- clean twins -----------------------------------

def make_ok_policy(a_emb, temperature=1.0):
    return RoutingPolicy(init=_init, act=_act_ok, update=_update, name="ok")


def with_logging(inner: RoutingPolicy):
    # combinator over an existing policy: exempt from pool-first
    return RoutingPolicy(init=inner.init, act=inner.act,
                         update=inner.update, name="logged")
