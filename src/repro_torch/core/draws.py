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


def _fill(seed: int, kind: str, out: torch.Tensor,
          host: bool) -> torch.Tensor:
    """Draw ``kind`` ("normal", "uniform" or "gumbel") numbers from
    ``seed`` into the float32 tensor ``out``: the one place a
    ``KeyedDraws`` draws, so a draw plan's buffers hold exactly the numbers
    of a direct draw. ``host``: numpy, copied to ``out``'s device; else the
    device's one generator, re-seeded."""
    if host:
        rng, shape = np.random.default_rng(seed), tuple(out.shape)
        if kind == "normal":
            v = rng.standard_normal(shape, dtype=np.float32)
        elif kind == "uniform":
            v = rng.random(shape, dtype=np.float32)
        else:
            v = rng.gumbel(size=shape).astype(np.float32)
        return out.copy_(torch.from_numpy(v))
    g = _GENERATORS.get(out.device)
    if g is None:
        g = _GENERATORS[out.device] = torch.Generator(device=out.device)
    g.manual_seed(seed)
    if kind == "normal":
        return out.normal_(generator=g)
    if kind == "uniform":
        return out.uniform_(generator=g)
    return out.exponential_(generator=g).log_().neg_()


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

    def fill(self, kind: str, out: torch.Tensor) -> torch.Tensor:
        """Draw this key's ``kind`` ("normal", "uniform" or "gumbel")
        numbers into the float32 tensor ``out`` (its shape and device) and
        return it."""
        return _fill(_mix64(self._word() ^ 0x5EED5EED5EED5EED), kind, out,
                     self.host)

    def _draw(self, kind, shape, device):
        return self.fill(kind, torch.empty(tuple(shape), dtype=torch.float32,
                                           device=device))

    def normal(self, shape, device):
        return self._draw("normal", shape, device)

    def uniform(self, shape, device):
        return self._draw("uniform", shape, device)

    def gumbel(self, shape, device):
        return self._draw("gumbel", shape, device)

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


# ---------------------------------------------------------------------------
# Draw plans: replaying KeyedDraws through a captured CUDA graph
# ---------------------------------------------------------------------------
#
# A graph replays its kernels, not the host code around them, so it cannot
# re-seed the card's generator from a new key before every draw as
# ``KeyedDraws`` does. A ``DrawPlan`` records, from one eager run of a
# program, each raw draw it makes: the path of ``split``/``fold_in`` steps
# from the program's root source to the drawing key, the kind and the
# shape. Before each replay ``DrawPlan.fill`` walks that plan from the
# call's own root key and draws every entry into a static buffer with
# ``KeyedDraws.fill``; inside the graph a ``TapeDraws`` hands the buffers
# out in recorded order. Derived draws (``randint``'s scaling by a ``hi``
# that lives on the device, ``choice``, ``distinct_pair``'s top-2) run
# inside the graph on the raw buffers, so the numbers are bitwise those
# of ``KeyedDraws`` drawing directly.

class DrawPlan:
    """The raw draws of one program run, in order: (path, kind, shape);
    a path's steps are ("split", n, i) and ("fold", i)."""

    def __init__(self):
        self.entries: list[tuple] = []

    def buffers(self, device) -> list[torch.Tensor]:
        """One static float32 buffer per entry."""
        return [torch.empty(shape, dtype=torch.float32, device=device)
                for _, _, shape in self.entries]

    def fill(self, root: "KeyedDraws", bufs: list[torch.Tensor]) -> None:
        """Draw every entry into ``bufs`` from the key its path reaches
        from ``root`` (``root``'s own ``split`` / ``fold_in``)."""
        if not isinstance(root, KeyedDraws):
            raise TypeError(
                f"a draw plan replays KeyedDraws; got {type(root).__name__}")
        for (path, kind, _), buf in zip(self.entries, bufs):
            src = root
            for step in path:
                src = (src.split(step[1])[step[2]] if step[0] == "split"
                       else src.fold_in(step[1]))
            src.fill(kind, buf)


class PlanRecorder(_Derived):
    """A ``KeyedDraws`` that records its raw draws into a ``DrawPlan``
    while drawing them (the eager run a plan is taken from)."""

    def __init__(self, src: "KeyedDraws", plan: DrawPlan | None = None,
                 path: tuple = ()):
        self.src, self.path = src, path
        self.plan = DrawPlan() if plan is None else plan

    def split(self, n: int):
        return [PlanRecorder(c, self.plan, self.path + (("split", n, i),))
                for i, c in enumerate(self.src.split(n))]

    def fold_in(self, i: int):
        return PlanRecorder(self.src.fold_in(i), self.plan,
                            self.path + (("fold", int(i)),))

    def _raw(self, kind, shape, device):
        self.plan.entries.append((self.path, kind, tuple(shape)))
        return getattr(self.src, kind)(shape, device)

    def normal(self, shape, device):
        return self._raw("normal", shape, device)

    def uniform(self, shape, device):
        return self._raw("uniform", shape, device)

    def gumbel(self, shape, device):
        return self._raw("gumbel", shape, device)

    def sgld(self, n_chains: int | None, n_steps: int):
        return _KeyedSgld(self, 1 if n_chains is None else n_chains)


class TapeDraws(_Derived):
    """The replay side of a ``DrawPlan``: hands out its filled buffers in
    recorded order (``split`` and ``fold_in`` return the tape itself). A
    draw of another kind or shape than the plan's raises: the program's
    draws must not depend on its data."""

    def __init__(self, plan: DrawPlan, bufs: list[torch.Tensor]):
        self.plan, self.bufs, self.pos = plan, bufs, 0

    def split(self, n: int):
        return [self] * n

    def fold_in(self, i: int):
        return self

    def _raw(self, kind, shape, device):
        if self.pos >= len(self.bufs):
            raise RuntimeError(f"draw plan exhausted: an extra {kind} "
                               f"draw of shape {tuple(shape)}")
        _, want_kind, want_shape = self.plan.entries[self.pos]
        if (want_kind, want_shape) != (kind, tuple(shape)):
            raise RuntimeError(
                f"draw plan entry {self.pos}: {kind} {tuple(shape)} drawn, "
                f"{want_kind} {want_shape} recorded")
        self.pos += 1
        return self.bufs[self.pos - 1]

    def normal(self, shape, device):
        return self._raw("normal", shape, device)

    def uniform(self, shape, device):
        return self._raw("uniform", shape, device)

    def gumbel(self, shape, device):
        return self._raw("gumbel", shape, device)

    def sgld(self, n_chains: int | None, n_steps: int):
        return _KeyedSgld(self, 1 if n_chains is None else n_chains)


class BucketDraws:
    """The draws of a batch padded to ``rows`` rows from a ladder whose top
    bucket is ``top``: a per-row draw (leading dimension ``rows``) is made
    at ``top`` rows and cut to ``rows``, so a live row draws the same
    numbers in every bucket, whatever the generator's layout. SGLD draws
    (per chain, not per row) pass through unchanged. It carries the draws
    an act makes (the raw kinds, ``distinct_pair``, ``sgld``)."""

    def __init__(self, src, rows: int, top: int):
        self.src, self.rows, self.top = src, rows, top

    def _wide(self, shape) -> tuple | None:
        shape = tuple(shape)
        if shape and shape[0] == self.rows and self.rows != self.top:
            return (self.top,) + shape[1:]
        return None

    def split(self, n: int):
        return [BucketDraws(c, self.rows, self.top)
                for c in self.src.split(n)]

    def fold_in(self, i: int):
        return BucketDraws(self.src.fold_in(i), self.rows, self.top)

    def _per_row(self, name, shape, device):
        wide = self._wide(shape)
        if wide is None:
            return getattr(self.src, name)(shape, device)
        return getattr(self.src, name)(wide, device)[:self.rows]

    def normal(self, shape, device):
        return self._per_row("normal", shape, device)

    def uniform(self, shape, device):
        return self._per_row("uniform", shape, device)

    def gumbel(self, shape, device):
        return self._per_row("gumbel", shape, device)

    def distinct_pair(self, b: int, n: int, device):
        if b == self.rows and b != self.top:
            return self.src.distinct_pair(self.top, n, device)[:b]
        return self.src.distinct_pair(b, n, device)

    def sgld(self, n_chains: int | None, n_steps: int):
        return self.src.sgld(n_chains, n_steps)


class ShardDraws:
    """The draws of one mesh rank's rows [lo, lo + rows) of a batch of
    ``total`` rows: a per-row draw (leading dimension ``rows``) is made for
    all ``total`` rows and cut to the rank's, so every rank draws the
    numbers the unsharded batch gives its rows, whatever the mesh size.
    SGLD draws (per chain) pass through unchanged, so every rank refreshes
    the posterior from the same numbers. It carries the draws an act makes,
    as ``BucketDraws`` does."""

    def __init__(self, src, rows: int, total: int, lo: int):
        self.src, self.rows, self.total, self.lo = src, rows, total, lo

    def _cut(self, v):
        return v[self.lo:self.lo + self.rows]

    def split(self, n: int):
        return [ShardDraws(c, self.rows, self.total, self.lo)
                for c in self.src.split(n)]

    def fold_in(self, i: int):
        return ShardDraws(self.src.fold_in(i), self.rows, self.total,
                          self.lo)

    def _per_row(self, name, shape, device):
        shape = tuple(shape)
        if not shape or shape[0] != self.rows:
            return getattr(self.src, name)(shape, device)
        wide = (self.total,) + shape[1:]
        return self._cut(getattr(self.src, name)(wide, device))

    def normal(self, shape, device):
        return self._per_row("normal", shape, device)

    def uniform(self, shape, device):
        return self._per_row("uniform", shape, device)

    def gumbel(self, shape, device):
        return self._per_row("gumbel", shape, device)

    def distinct_pair(self, b: int, n: int, device):
        if b != self.rows:
            return self.src.distinct_pair(b, n, device)
        return self._cut(self.src.distinct_pair(self.total, n, device))

    def sgld(self, n_chains: int | None, n_steps: int):
        return self.src.sgld(n_chains, n_steps)
