"""Seeded draw-source reuse violations + clean twins.

Parsed by tests/test_torch_analysis.py, never executed. ``KeyedDraws``
gives the same numbers for the same key however often it is asked, as a
JAX key does: asking one source twice correlates the draws.
"""
import torch

from repro_torch.core.draws import KeyedDraws


def bad_double_normal(draws, n):
    a = draws.normal((n,), "cpu")
    b = draws.normal((n,), "cpu")  # PLANT: prng/key-reuse
    return a + b


def bad_keyed_twice(seed, n):
    src = KeyedDraws(seed)
    noise = src.normal((n,), "cpu")
    pick = src.uniform((n,), "cpu")  # PLANT: prng/key-reuse
    return noise, pick


def bad_loop_sample(draws, xs):
    out = []
    for x in xs:
        out.append(x + draws.gumbel(x.shape, "cpu"))  # PLANT: prng/key-reuse
    return out


def bad_split_then_reuse(source: KeyedDraws, n):
    k1, k2 = source.split(2)
    a = k1.normal((n,), "cpu")
    b = source.normal((n,), "cpu")  # PLANT: prng/key-reuse
    return a, b, k2


def bad_handed_twice(policy, state, x, draws):
    state, a1, a2 = policy.act(draws, state, x)
    state, b1, b2 = policy.act(draws, state, x)  # PLANT: prng/key-reuse
    return a1, a2, b1, b2


def bad_reseeded_generator(seed, n):
    g = torch.Generator()
    g.manual_seed(seed)
    a = torch.randn(n, generator=g)
    g.manual_seed(seed)
    b = torch.randn(n, generator=g)  # PLANT: prng/key-reuse
    return a, b


def bad_generator_in_loop(seed, xs):
    g = torch.Generator()
    out = []
    for x in xs:
        g.manual_seed(seed)
        out.append(x + torch.rand(x.shape, generator=g))  # PLANT: prng/key-reuse
    return out


# --------------------------- clean twins -----------------------------------

def ok_fold_in(draws, steps):
    # fold_in's base source is the blessed non-consuming reuse
    total = 0.0
    for i in range(steps):
        total += draws.fold_in(i).uniform((1,), "cpu")
    return total


def ok_split_iteration(draws, n):
    # each loop iteration re-binds a fresh child from the split
    out = []
    for sub in draws.split(n):
        out.append(sub.normal((2,), "cpu"))
    return out


def ok_children(draws, n):
    k_idx, k_noise = draws.split(2)
    return k_idx.randint((n,), 0, 10, "cpu"), k_noise.normal((n,), "cpu")


def ok_early_return(draws, flag):
    # the early-return branch never reaches the fall-through draw
    if flag:
        return draws.normal((2,), "cpu")
    return draws.uniform((2,), "cpu")


def ok_none_guard(draws, x):
    if draws is not None and isinstance(draws, KeyedDraws):
        x = x + draws.normal(x.shape, "cpu")
    return x


def ok_flag(capture, bodies, draws: bool):
    # named like a source, annotated as a host flag
    return [capture(body, draws) for body in bodies] + [capture(None, draws)]


def ok_generator_stream(seed, n):
    # one seeding, many draws: the generator advances between them
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g), torch.rand(n, generator=g)


def ok_generator_per_seed(seeds, n):
    # every iteration seeds anew from a re-bound name
    g = torch.Generator()
    out = []
    for s in seeds:
        g.manual_seed(s)
        out.append(torch.randn(n, generator=g))
    return out
