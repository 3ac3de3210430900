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
    constant into its key;
  * and for encoder training (``contrastive/finetune.py``): uniform ints
    in [lo, hi) (``randint``, the reference's ``jax.random.randint``) and
    weighted draws with replacement (``choice``, its
    ``jax.random.choice(..., p=...)``).

``hi`` is passed at call time (a Python int or a 0-d device tensor), so a
ring that fills data-dependently still replays exactly, and a CUDA run
draws its indices without a host sync.

A third source, ``KeyedDraws``, follows the key tree instead: its
position is a (2,) uint32 key, ``split`` derives the children's keys by a
fixed integer hash, and each draw comes from a generator seeded from its
key, so the same key always gives the same numbers. ``key_leaf()`` and
``from_leaf(leaf)`` carry that position through a checkpoint (the routing
service saves it as the reference saves its PRNG key); a source that
replays ``jax.random`` implements both with the real key.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from repro_torch.device import resolve_device


class SgldDraws(Protocol):
    def step(self, i: int, m: int, hi, d: int, device) -> tuple:
        """(indices (C,m) int64 in [0, hi), noise (C,d) float32) of step i
        (C = 1 for a single chain)."""


class Draws(Protocol):
    def split(self, n: int) -> list["Draws"]: ...
    def fold_in(self, i: int) -> "Draws": ...
    def normal(self, shape: tuple, device) -> torch.Tensor: ...
    def uniform(self, shape: tuple, device) -> torch.Tensor: ...
    def gumbel(self, shape: tuple, device) -> torch.Tensor: ...
    def distinct_pair(self, b: int, n: int, device) -> torch.Tensor:
        """(b, 2) int64: per row an ordered pair of distinct ints in
        [0, n), uniform."""
    def randint(self, shape: tuple, lo: int, hi, device) -> torch.Tensor:
        """int64 of ``shape``, uniform in [lo, hi)."""
    def choice(self, n: int, shape: tuple, p: torch.Tensor,
               device) -> torch.Tensor:
        """int64 of ``shape`` in [0, n), drawn with replacement with the
        probabilities ``p`` (n,)."""
    def sgld(self, n_chains: int | None, n_steps: int) -> SgldDraws:
        """Per-step draws of ``n_chains`` chains; ``None``: one chain drawn
        from this source's own stream (the reference's unbatched theta
        (d,), whose key is not split per chain)."""
    def key_leaf(self) -> np.ndarray:
        """The source's position as a (2,) uint32 array (checkpoints)."""
    def from_leaf(self, leaf) -> "Draws":
        """A source of the same kind positioned at ``leaf``."""


def scaled_index(u: torch.Tensor, hi) -> torch.Tensor:
    """floor(u * hi) for uniforms u in [0, 1), clamped into [0, hi)."""
    hi = torch.as_tensor(hi, device=u.device)
    idx = torch.floor(u * hi).to(torch.int64)
    return torch.minimum(idx, (hi - 1).to(torch.int64))


class _Derived:
    """The draws every source builds from its ``uniform`` and ``gumbel``."""

    def randint(self, shape, lo, hi, device):
        return lo + scaled_index(self.uniform(shape, device), hi - lo)

    def choice(self, n: int, shape, p, device):
        """Inverse CDF: the first index whose cumulative weight exceeds a
        uniform share of the total."""
        cum = torch.cumsum(torch.as_tensor(p, dtype=torch.float32,
                                           device=device), dim=0)
        u = self.uniform(tuple(shape), device) * cum[-1]
        idx = torch.searchsorted(cum, u.reshape(-1), right=True)
        return torch.clamp_max(idx, n - 1).reshape(tuple(shape))

    def distinct_pair(self, b: int, n: int, device):
        """Gumbel top-2: a uniform ordered pair without replacement."""
        return torch.topk(self.gumbel((b, n), device), 2, dim=-1).indices


class _Sequential(_Derived):
    """Shared shape of the two sequential sources: ``split`` returns the
    source itself, and an SGLD step draws its indices then its noise. Their
    position is a generator state, not a key, so they do not checkpoint."""

    def split(self, n: int):
        return [self] * n

    def fold_in(self, i: int):
        return self

    def sgld(self, n_chains: int | None, n_steps: int):
        return _SequentialSgld(self, 1 if n_chains is None else n_chains)

    def key_leaf(self):
        raise TypeError(
            f"{type(self).__name__} draws sequentially and has no key to "
            f"checkpoint; serve with KeyedDraws")

    def from_leaf(self, leaf):
        raise TypeError(
            f"{type(self).__name__} draws sequentially and cannot be "
            f"positioned at a key; serve with KeyedDraws")


class _SequentialSgld:
    def __init__(self, src, n_chains):
        self.src, self.c = src, n_chains

    def step(self, i, m, hi, d, device):
        idx = self.src.randint((self.c, m), 0, hi, device)
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


_M64 = (1 << 64) - 1

# one generator per device, re-seeded from the key before every draw of a
# KeyedDraws: the numbers depend on the key alone, and no object is built
# per draw
_GENERATORS: dict[torch.device, torch.Generator] = {}


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijective 64-bit integer hash."""
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class KeyedDraws(_Derived):
    """A draw source positioned by a (2,) uint32 key, like a JAX key.

    ``KeyedDraws(seed)`` starts at the key ``jax.random.PRNGKey(seed)``
    holds, ``[seed >> 32, seed & 0xffffffff]``. ``split(n)`` hands out n
    children whose keys are a fixed hash of (key, i); each draw re-seeds
    the device's one generator from the hash of its key, so a key gives
    the same numbers however often it is asked, and a source rebuilt from
    ``key_leaf()`` continues exactly (service checkpoints).

    Device mode (``host=False``) draws on a generator of the device the
    tensor is asked for: on a card, no host copy and so no sync. Host mode
    draws with numpy and copies to the device, so a CPU run and a card run
    of one key see the same numbers (card-against-CPU checks)."""

    def __init__(self, seed: int = 0, *, host: bool = False, key=None):
        self.host = host
        if key is None:
            seed = int(seed) & _M64
            key = (seed >> 32, seed & 0xFFFFFFFF)
        self.key = (int(key[0]) & 0xFFFFFFFF, int(key[1]) & 0xFFFFFFFF)

    def _word(self) -> int:
        return (self.key[0] << 32) | self.key[1]

    def _child(self, z: int) -> "KeyedDraws":
        return KeyedDraws(host=self.host, key=(z >> 32, z & 0xFFFFFFFF))

    def split(self, n: int):
        base = _mix64(self._word())
        return [self._child(_mix64(base + i + 1)) for i in range(n)]

    def fold_in(self, i: int):
        return self._child(_mix64(_mix64(self._word()) ^ _mix64(
            0xF01D0000_00000000 | (int(i) & 0xFFFFFFFF))))

    def key_leaf(self) -> np.ndarray:
        return np.array(self.key, dtype=np.uint32)

    def from_leaf(self, leaf) -> "KeyedDraws":
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.cpu().numpy()
        k = np.asarray(leaf).astype(np.uint32)
        return KeyedDraws(host=self.host, key=(int(k[0]), int(k[1])))

    def _seed(self) -> int:
        return _mix64(self._word() ^ 0x5EED5EED5EED5EED)

    def _gen(self, device) -> torch.Generator:
        device = torch.device(device)
        g = _GENERATORS.get(device)
        if g is None:
            g = _GENERATORS[device] = torch.Generator(device=device)
        g.manual_seed(self._seed())
        return g

    def _rng(self) -> np.random.Generator:
        return np.random.default_rng(self._seed())

    def normal(self, shape, device):
        if self.host:
            v = self._rng().standard_normal(shape, dtype=np.float32)
            return torch.from_numpy(v).to(device)
        return torch.randn(shape, generator=self._gen(device), device=device,
                           dtype=torch.float32)

    def uniform(self, shape, device):
        if self.host:
            v = self._rng().random(shape, dtype=np.float32)
            return torch.from_numpy(v).to(device)
        return torch.rand(shape, generator=self._gen(device), device=device,
                          dtype=torch.float32)

    def gumbel(self, shape, device):
        if self.host:
            v = self._rng().gumbel(size=shape).astype(np.float32)
            return torch.from_numpy(v).to(device)
        e = torch.empty(shape, device=device, dtype=torch.float32)
        return -torch.log(e.exponential_(generator=self._gen(device)))

    def sgld(self, n_chains: int | None, n_steps: int):
        return _KeyedSgld(self, 1 if n_chains is None else n_chains)


class _KeyedSgld:
    """Step i of every chain at once: the indices from the step's first
    child key, the noise from its second."""

    def __init__(self, src: KeyedDraws, n_chains: int):
        self.src, self.c = src, n_chains

    def step(self, i, m, hi, d, device):
        k_idx, k_noise = self.src.fold_in(i).split(2)
        return (k_idx.randint((self.c, m), 0, hi, device),
                k_noise.normal((self.c, d), device))
