"""Weights from the seed, on the device, in the type they are served in, in
two large draws (one for the matrices, one for the norm scales) cut into
the parameter tree the port's dense attention + gated-MLP models take:
``embed`` (V, d), ``units["0"]`` with every leaf stacked over the layers
(``norm1``, ``mixer`` wq / wk / wv / wo, ``norm2``, ``ffn`` w1 / w3 / w2),
``final_norm``. Matrices are N(0, 1 / fan_in) as the port initialises
them; the norm scales (float32, gain 1 + scale) are N(0, 0.05^2) so that
the comparison sees them.
"""
from __future__ import annotations

import torch

ALIGN = 128          # elements: every leaf starts 256-byte aligned or more


def layout(d, h, kv, hd, ff, layers, vocab) -> list:
    """(path, shape, std) of every matrix leaf."""
    return [
        (("embed",), (vocab, d), d ** -0.5),
        (("units", "0", "mixer", "wq"), (layers, d, h, hd), d ** -0.5),
        (("units", "0", "mixer", "wk"), (layers, d, kv, hd), d ** -0.5),
        (("units", "0", "mixer", "wv"), (layers, d, kv, hd), d ** -0.5),
        (("units", "0", "mixer", "wo"), (layers, h, hd, d), (h * hd) ** -0.5),
        (("units", "0", "ffn", "w1"), (layers, d, ff), d ** -0.5),
        (("units", "0", "ffn", "w3"), (layers, d, ff), d ** -0.5),
        (("units", "0", "ffn", "w2"), (layers, ff, d), ff ** -0.5),
    ]


def _put(tree: dict, path: tuple, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def make_params(sizes: dict, seed: int, dtype, device) -> dict:
    """The parameter tree of ``sizes`` (d, h, kv, hd, ff, layers, vocab)
    drawn from ``seed`` on ``device``."""
    d, layers = sizes["d"], sizes["layers"]
    leaves = layout(**sizes)
    offsets, total = [], 0
    for _, shape, _ in leaves:
        offsets.append(total)
        n = 1
        for s in shape:
            n *= s
        total += -(-n // ALIGN) * ALIGN
    gen = torch.Generator(device=device).manual_seed(int(seed) & (2**63 - 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    norms = torch.randn(2 * layers * d + d, generator=gen, device=device,
                        dtype=torch.float32).mul_(0.05)
    tree: dict = {}
    for (path, shape, std), off in zip(leaves, offsets):
        n = 1
        for s in shape:
            n *= s
        _put(tree, path, flat[off:off + n].view(shape).mul_(std))
    _put(tree, ("units", "0", "norm1"), norms[:layers * d].view(layers, d))
    _put(tree, ("units", "0", "norm2"),
         norms[layers * d:2 * layers * d].view(layers, d))
    tree["final_norm"] = norms[2 * layers * d:]
    return tree
