"""The offline half of the online representation loop: causal CCFT
refresh (counterpart of ``repro/refresh/trainer.py``).

Given an exported ``DuelLog`` and the offline corpus CCFT was fine-tuned
on, ``refresh_table`` re-runs the paper's representation pipeline against
live evidence:

1. **Encoder refresh**: ``contrastive.finetune_categorical`` on the
   offline corpus, anchors re-weighted to the live traffic's category mix
   (``row_weights``).
2. **Causal duel scores**: per-(arm, category) win rates from the logged
   duels, inverse-propensity-weighted (a win logged under propensity p
   counts 1/p, clipped at ``prop_floor``); ``causal=False`` is the naive
   estimator.
3. **Table rebuild**: ``ccft.model_embeddings`` on the refreshed category
   embeddings and duel scores, a (K_max, d) table for
   ``RouterService.apply_table`` / ``model_pool.set_table``.

All of it runs off the serving path; the serving side holds only the log
fold and the table swap.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import ccft
from repro_torch.core.model_pool import ModelPool
from repro_torch.device import as_f32, resolve_device


@dataclasses.dataclass(frozen=True)
class RefreshConfig:
    """Knobs of the standing refresh cycle (the reference's fields).

    ``every``: ``RouterService.refresh_due()`` turns True once that many
    duels were folded into the log since the last ``apply_table`` (0 =
    manual refreshes only). ``capacity`` sizes the duel log (rounded up to
    a power of two by the service). ``causal`` inverse-propensity-weights
    the logged outcomes; False is the naive estimator."""
    every: int = 0
    capacity: int = 1024
    n_categories: int = 8
    weighting: str = "excel_perf_cost"   # one of ccft.WEIGHTINGS
    tau: int = 3
    causal: bool = True
    prop_floor: float = 0.05             # IPW clip: w = 1 / max(p, floor)
    lam: float = 0.05                    # perf-cost blend for *_cost variants
    epochs: int = 2
    steps_per_epoch: int = 20
    batch: int = 64
    lr: float = 1e-3
    reseed: bool = False                 # re-warm-start posterior after swap

    def __post_init__(self):
        if self.weighting not in ccft.WEIGHTINGS:
            raise ValueError(f"refresh weighting {self.weighting!r} not in "
                             f"{ccft.WEIGHTINGS}")
        if self.capacity < 1:
            raise ValueError(f"refresh capacity must be >= 1, "
                             f"got {self.capacity}")
        if not 0.0 < self.prop_floor <= 1.0:
            raise ValueError(f"prop_floor must be in (0, 1], "
                             f"got {self.prop_floor}")


def _i32(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32)
    return torch.as_tensor(v, dtype=torch.int32, device=device)


def category_mix(cat, n_categories: int, device=None) -> torch.Tensor:
    """(M,) live-traffic category weights from logged labels (-1 = unknown
    rows are ignored; an empty or unlabelled log gives uniform weights).
    ``device`` None keeps a tensor's device, else the default device."""
    if device is None and isinstance(cat, torch.Tensor):
        device = cat.device
    cat = _i32(cat, resolve_device(device))
    known = (cat >= 0) & (cat < n_categories)
    counts = torch.zeros((n_categories + 1,), dtype=torch.float32,
                         device=cat.device).index_add(
        0, torch.where(known, cat, n_categories).long(),
        torch.ones(cat.shape, dtype=torch.float32, device=cat.device))
    counts = counts[:n_categories]
    return torch.where(torch.sum(counts) > 0, counts,
                       torch.ones_like(counts))


def assign_categories(x: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Nearest-category-prototype labels for unlabelled log rows: x (N, d)
    query features, xi (d, M) category embeddings; cosine argmax."""
    xn = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1,
                                                      keepdim=True), 1e-12)
    cn = xi / torch.clamp_min(torch.linalg.vector_norm(xi, dim=0,
                                                       keepdim=True), 1e-12)
    return torch.argmax(xn @ cn, dim=-1).to(torch.int32)


def duel_scores(a1, a2, y, cat, prop, k_max: int, n_categories: int, *,
                causal: bool = True, prop_floor: float = 0.05,
                smoothing: float = 1.0, device=None) -> torch.Tensor:
    """(K_max, M) per-(arm, category) duel win rates from logged outcomes.

    Each duel is one Bernoulli observation for both arms in its category
    column (a1 wins on y > 0, ties split); under ``causal`` weighted by
    1 / clip(propensity, floor, 1). Laplace smoothing pulls unseen cells to
    0.5. Rows with an out-of-range category (and arms outside [0, K_max))
    are dropped: they scatter into a spare cell that is cut off."""
    if device is None and isinstance(a1, torch.Tensor):
        device = a1.device
    dev = resolve_device(device)
    a1, a2, cat = _i32(a1, dev), _i32(a2, dev), _i32(cat, dev)
    y = as_f32(y, dev)
    w = (1.0 / torch.clamp(as_f32(prop, dev), prop_floor, 1.0)) if causal \
        else torch.ones(y.shape, dtype=torch.float32, device=dev)
    ok = (cat >= 0) & (cat < n_categories)
    col = torch.where(ok, cat, n_categories)      # out of range: dropped
    w = torch.where(ok, w, 0.0)
    win1 = torch.where(y > 0, 1.0, torch.where(y < 0, 0.0, 0.5))
    width = n_categories + 1
    spare = k_max * width

    def cell(a):
        inside = (a >= 0) & (a < k_max)
        return torch.where(inside, a * width + col, spare).long()
    c1, c2 = cell(a1), cell(a2)

    def table(v1, v2):
        t = torch.zeros((spare + 1,), dtype=torch.float32, device=dev)
        t = t.index_add(0, c1, v1).index_add(0, c2, v2)
        return t[:spare].reshape(k_max, width)[:, :n_categories]
    wins = table(w * win1, w * (1.0 - win1))
    plays = table(w, w)
    return (wins + 0.5 * smoothing) / (plays + smoothing)


def refresh_table(draws, log_data: dict, enc_params, enc_cfg, offline,
                  cfg: RefreshConfig, k_max: int, costs=None):
    """One refresh cycle: logged duels -> refreshed (K_max, d) table.

    ``draws`` is the fine-tuning's draw source (the reference takes a
    key); ``log_data`` a ``duel_log.export`` dict (host arrays);
    ``offline`` the (tokens, mask, cats) corpus CCFT was fine-tuned on,
    whose device the cycle runs on; ``costs`` (K_max,) switches the *_cost
    weightings to perf - lam * cost. Returns (table, info): the refreshed
    encoder params, per-epoch losses, the live category mix and the duel
    scores."""
    from repro_torch.contrastive import finetune_categorical
    from repro_torch.encoder.model import encode

    tokens, mask, cats = offline
    dev = tokens.device
    cats = _i32(cats, dev)
    m = cfg.n_categories
    mix = category_mix(log_data["cat"], m, device=dev)
    row_w = mix[cats.long()]                      # live-mix anchor weights
    params, losses = finetune_categorical(
        draws, enc_params, tokens, mask, cats, enc_cfg, epochs=cfg.epochs,
        steps_per_epoch=cfg.steps_per_epoch, batch=cfg.batch, lr=cfg.lr,
        row_weights=row_w)
    emb = encode(params, tokens, mask, enc_cfg)
    xi = ccft.category_embeddings(emb, cats, m)

    cat = _i32(log_data["cat"], dev)
    if cat.shape[0]:
        inferred = assign_categories(as_f32(log_data["x"], dev), xi)
        cat = torch.where(cat >= 0, cat, inferred)
    scores = duel_scores(log_data["a1"], log_data["a2"], log_data["y"], cat,
                         log_data["prop"], k_max, m, causal=cfg.causal,
                         prop_floor=cfg.prop_floor, device=dev)
    if costs is not None and cfg.weighting.endswith("cost"):
        scores = ccft.perf_cost_scores(scores, as_f32(costs, dev)[:, None],
                                       cfg.lam)
    table = ccft.model_embeddings(xi, scores, cfg.weighting, tau=cfg.tau)
    return table, dict(params=params, losses=losses, mix=mix, scores=scores,
                       n_duels=int(log_data["x"].shape[0]))


# ---------------------------------------------------------------------------
# Refresh schedules for the env loop (precomputed tables, swaps per step)
# ---------------------------------------------------------------------------

class RefreshSchedule(NamedTuple):
    """E table swaps for ``env.run``: at step ``step[e]`` the pool's whole
    embedding table becomes ``table[e]`` (fixed shapes, as
    ``PoolSchedule``)."""
    step: torch.Tensor     # (E,) int32
    table: torch.Tensor    # (E, K_max, d) float32


def schedule(events, device=None) -> RefreshSchedule:
    """A RefreshSchedule from host (step, table) tuples."""
    dev = resolve_device(device)
    steps = [int(s) for s, _ in events]
    return RefreshSchedule(
        step=torch.tensor(steps, dtype=torch.int32, device=dev),
        table=torch.stack([as_f32(t, dev) for _, t in events]))


def apply_refresh(pool: ModelPool, sched: RefreshSchedule, s) -> ModelPool:
    """Fold the table swap due at step ``s`` into the pool (at most one
    event a step; none leaves the pool bit-unchanged)."""
    hit = sched.step == int(s)                               # (E,)
    n_hit = torch.sum(hit, dtype=torch.int32)
    mixed = torch.einsum("e,ekd->kd", hit.to(sched.table.dtype),
                         sched.table)
    return pool._replace(
        a_emb=torch.where(n_hit > 0, mixed, pool.a_emb),
        generation=pool.generation + n_hit)
