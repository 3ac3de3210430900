"""MixInstruct-style pairwise-preference data, paper §5.2 (counterpart of
``repro/data/mixinstruct.py``).

Queries carry a latent category the dataset does not expose; latent
per-model utilities generate a full K x K pairwise comparison table per
query (with judge noise and ties). The pipeline then scores models from
the comparisons (win 1, tie 0.5, loss 0, a Condorcet bonus), scores query
ambiguity and drops the most ambiguous share, and labels each query with
its best LLM for the score-free embedding of eq. 6.

Draws come from a CPU ``torch.Generator`` (the reference uses
``jax.random``: the port matches its distribution, not its numbers); the
dataset is moved to ``device``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device

from .synth import sample_queries

N_MODELS = 11
MODELS = ["Vicuna", "MOSS", "Open Assistant", "Alpaca", "Baize", "ChatGLM",
          "MPT", "Koala", "Dolly V2", "StableLM", "FLAN-T5"]

# Tab. 2: % of examples where each model ranks first.
FIRST_RANK_PCT = np.array([21.22, 12.91, 12.61, 11.61, 11.61, 8.51, 7.61,
                           6.71, 4.50, 1.90, 0.80], np.float32)


@dataclasses.dataclass(frozen=True)
class MixInstructConfig:
    n_latent_cats: int = 8
    n_queries: int = 1200
    utility_noise: float = 0.12
    tie_margin: float = 0.03
    comparison_noise: float = 0.10


def latent_skills(gen: torch.Generator, cfg: MixInstructConfig):
    """(K, M) per-category skills whose best-model distribution tracks
    Tab. 2: a calibrated base per model plus category deviations centred
    per model (population std, as ``jnp.std``)."""
    base = torch.from_numpy(np.log(FIRST_RANK_PCT / FIRST_RANK_PCT.sum()))
    base = 0.55 + 0.22 * (base - base.mean()) / base.std(correction=0)
    dev = 0.18 * torch.randn((N_MODELS, cfg.n_latent_cats), generator=gen,
                             device=gen.device)
    dev = dev - dev.mean(dim=1, keepdim=True)
    return base.to(gen.device)[:, None] + dev


def make_dataset(gen: torch.Generator, corpus_cfg, cfg: MixInstructConfig,
                 device=None) -> dict:
    """tokens/mask, latent cats, utilities and the pairwise table
    pairwise[t, i, j] = 1 if i beats j, 0.5 tie, 0 loss (0.5 on i == j)."""
    dev = resolve_device(device)
    cc = dataclasses.replace(corpus_cfg, n_categories=cfg.n_latent_cats)
    cats = torch.randint(0, cfg.n_latent_cats, (cfg.n_queries,),
                         generator=gen, device=gen.device, dtype=torch.int32)
    tokens, mask = sample_queries(gen, cats, cc, dev)
    skills = latent_skills(gen, cfg)                          # (K, M)
    utils = skills.T[cats.long()]                             # (T, K)
    utils = utils + cfg.utility_noise * torch.randn(
        utils.shape, generator=gen, device=gen.device)
    # one antisymmetric judge noise per pair: win/loss complement, ties shared
    diff = utils[:, :, None] - utils[:, None, :]
    eps = torch.randn(diff.shape, generator=gen, device=gen.device)
    eps = (eps - eps.transpose(1, 2)) / math.sqrt(2.0)
    noisy = diff + cfg.comparison_noise * eps
    table = torch.where(noisy > cfg.tie_margin, 1.0,
                        torch.where(noisy < -cfg.tie_margin, 0.0, 0.5))
    eye = torch.eye(N_MODELS, dtype=torch.bool, device=gen.device)
    table = torch.where(eye[None], 0.5, table)
    return {"tokens": tokens, "mask": mask, "cats": cats.to(dev),
            "utils": utils.to(dev), "pairwise": table.to(dev)}


def scores_from_pairwise(table: torch.Tensor,
                         condorcet_bonus: float = 0.25) -> torch.Tensor:
    """Win 1 / tie 0.5 / loss 0, summed per model (self excluded) and
    normalized; a Condorcet winner gets ``condorcet_bonus`` on top."""
    k = table.shape[-1]
    raw = (table.sum(dim=-1) - 0.5) / (k - 1)
    eye = torch.eye(k, dtype=torch.bool, device=table.device)
    beats_all = torch.where(eye[None], True, table > 0.5).all(dim=-1)
    return raw + condorcet_bonus * beats_all.to(raw.dtype)


def ambiguity_scores(table: torch.Tensor) -> torch.Tensor:
    """Mean distance of the off-diagonal outcomes from a decisive one:
    0 when every pair is won or lost, 1 when everything ties."""
    k = table.shape[-1]
    eye = torch.eye(k, dtype=torch.bool, device=table.device)[None]
    decisiveness = torch.where(eye, 0.0, 1.0 - 2.0 * torch.abs(table - 0.5))
    return decisiveness.sum(dim=(-1, -2)) / (k * (k - 1))


def remove_ambiguous(data: dict, frac: float) -> dict:
    """Drop the top-``frac`` most ambiguous queries (paper's _8 / _15);
    among equally ambiguous ones the earlier goes first (a stable sort, as
    ``jnp.argsort``)."""
    amb = ambiguity_scores(data["pairwise"])
    n_drop = int(data["tokens"].shape[0] * frac)
    order = torch.argsort(-amb, stable=True)
    keep = torch.sort(order[n_drop:]).values
    return {k: v[keep] for k, v in data.items()}


def best_model_labels(table: torch.Tensor) -> torch.Tensor:
    """Label = best-matching LLM per query (first index on ties)."""
    return torch.argmax(scores_from_pairwise(table), dim=-1).to(torch.int32)
