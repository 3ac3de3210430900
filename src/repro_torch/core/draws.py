"""Random sources for the port: every draw of the online loop goes through
one object, passed where the JAX package passes a PRNG key.

JAX's threefry streams cannot be reproduced in torch, so the loop never
calls a torch sampler itself. It asks a *draw source* (any object with the
methods of ``Draws``) and mirrors the JAX key tree through ``split``: a
source that replays ``jax.random`` (the parity tests carry one) gives the
port exactly the reference's numbers, while the two sources here draw
sequentially and ignore the tree (``split`` and ``fold_in`` hand back
the same source).

The draws the loop makes:
  * the initial chain thetas (``normal``);
  * per SGLD step of every chain: the minibatch indices in [0, hi) and the
    Langevin noise (``sgld(...).step``), all chains of a step at once;
  * per tick: the BTL uniforms (``uniform``) and, on the geometric delay
    path, the lag uniforms;
  * Gumbel noise (``gumbel``) for uniform random pairs over active arms
    (``model_pool.masked_pair_choice``) and Plackett-Luce rankings;
  * a uniform distinct pair per row over a fixed arm count
    (``distinct_pair``), the static baselines' ``jax.random.choice(...,
    replace=False)``;
  * ``fold_in(i)``, a derived source, where the reference folds a
    constant into its key.

``hi`` is passed at call time (a Python int or a 0-d device tensor), so a
ring that fills data-dependently still replays exactly, and a CUDA run
draws its indices without a host sync.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from repro_torch.device import resolve_device


class SgldDraws(Protocol):
    def step(self, i: int, m: int, hi, d: int, device) -> tuple:
        """(indices (C,m) int64 in [0, hi), noise (C,d) float32) of step i."""


class Draws(Protocol):
    def split(self, n: int) -> list["Draws"]: ...
    def fold_in(self, i: int) -> "Draws": ...
    def normal(self, shape: tuple, device) -> torch.Tensor: ...
    def uniform(self, shape: tuple, device) -> torch.Tensor: ...
    def gumbel(self, shape: tuple, device) -> torch.Tensor: ...
    def distinct_pair(self, b: int, n: int, device) -> torch.Tensor:
        """(b, 2) int64: per row an ordered pair of distinct ints in
        [0, n), uniform."""
    def sgld(self, n_chains: int, n_steps: int) -> SgldDraws: ...


def scaled_index(u: torch.Tensor, hi) -> torch.Tensor:
    """floor(u * hi) for uniforms u in [0, 1), clamped into [0, hi)."""
    hi = torch.as_tensor(hi, device=u.device)
    idx = torch.floor(u * hi).to(torch.int64)
    return torch.minimum(idx, (hi - 1).to(torch.int64))


class _Sequential:
    """Shared shape of the two sequential sources: ``split`` returns the
    source itself, and an SGLD step draws its indices then its noise."""

    def split(self, n: int):
        return [self] * n

    def fold_in(self, i: int):
        return self

    def randint(self, shape, hi, device):
        return scaled_index(self.uniform(shape, device), hi)

    def distinct_pair(self, b: int, n: int, device):
        """Gumbel top-2: a uniform ordered pair without replacement."""
        return torch.topk(self.gumbel((b, n), device), 2, dim=-1).indices

    def sgld(self, n_chains: int, n_steps: int):
        return _SequentialSgld(self, n_chains)


class _SequentialSgld:
    def __init__(self, src, n_chains):
        self.src, self.c = src, n_chains

    def step(self, i, m, hi, d, device):
        idx = self.src.randint((self.c, m), hi, device)
        return idx, self.src.normal((self.c, d), device)


class TorchDraws(_Sequential):
    """A seeded ``torch.Generator`` on the run's device (standalone runs)."""

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def normal(self, shape, device):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32).to(device)

    def uniform(self, shape, device):
        return torch.rand(shape, generator=self.gen, device=self.device,
                          dtype=torch.float32).to(device)

    def gumbel(self, shape, device):
        e = torch.empty(shape, device=self.device, dtype=torch.float32)
        return -torch.log(e.exponential_(generator=self.gen)).to(device)


class HostDraws(_Sequential):
    """Draws made on the host by a seeded numpy generator and copied to
    the run's device: a CPU run and a CUDA run of the same seed consume
    identical numbers (card-against-CPU checks)."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def normal(self, shape, device):
        v = self.rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(v).to(device)

    def uniform(self, shape, device):
        v = self.rng.random(shape, dtype=np.float32)
        return torch.from_numpy(v).to(device)

    def gumbel(self, shape, device):
        v = self.rng.gumbel(size=shape).astype(np.float32)
        return torch.from_numpy(v).to(device)
