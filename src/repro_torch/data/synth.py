"""Synthetic category-structured query corpus (counterpart of
``repro/data/synth.py``).

Each category m draws tokens from a mixture of a shared "common-word" pool
and a category-specific vocabulary block, so raw token overlap gives a
weak generic similarity signal and category membership is learnable by
contrastive fine-tuning.

The reference samples with ``jax.random``; the port samples the same
distribution (each token of a category-m query from softmax(logits[m]))
with a ``torch.Generator``. Pass a CPU generator: sampling runs on the
generator's device and the result moves to ``device``, so a card run and
a CPU run of one seed get the same tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_categories: int = 7
    vocab_size: int = 2048
    seq_len: int = 32
    common_frac: float = 0.35     # fraction of tokens from the shared pool
    common_pool: int = 256        # tokens [0, common_pool) are shared
    block_size: int = 192         # category-specific vocab block width
    block_overlap: float = 0.0    # fraction of a block shared with the next
    topic_temp: float = 1.2


def category_token_logits(cfg: CorpusConfig) -> np.ndarray:
    """(M, V) unnormalized token logits per category."""
    rng = np.random.RandomState(1234)
    stride = max(int(cfg.block_size * (1.0 - cfg.block_overlap)), 1)
    logits = np.full((cfg.n_categories, cfg.vocab_size), -12.0, np.float32)
    logits[:, :cfg.common_pool] = np.log(cfg.common_frac / cfg.common_pool)
    for m in range(cfg.n_categories):
        start = cfg.common_pool + m * stride
        end = min(start + cfg.block_size, cfg.vocab_size)
        logits[m, start:end] = (np.log((1 - cfg.common_frac) / cfg.block_size)
                                + cfg.topic_temp
                                * rng.randn(end - start).astype(np.float32))
    return logits


def token_probs(cfg: CorpusConfig) -> torch.Tensor:
    """(M, V) float32: the distribution a category-m token is drawn from."""
    return torch.softmax(torch.from_numpy(category_token_logits(cfg)), dim=-1)


def sample_queries(gen: torch.Generator, categories: torch.Tensor,
                   cfg: CorpusConfig, device=None):
    """Token sequences for category labels (N,). Returns (tokens (N, L)
    int32, mask (N, L) float32 of ones) on ``device``."""
    probs = token_probs(cfg).to(gen.device)
    cats = categories.to(gen.device).long()
    tokens = torch.multinomial(probs[cats], cfg.seq_len, replacement=True,
                               generator=gen)
    dev = resolve_device(device)
    tokens = tokens.to(device=dev, dtype=torch.int32)
    return tokens, torch.ones(tokens.shape, dtype=torch.float32, device=dev)


def make_split(gen: torch.Generator, n_per_category: int, cfg: CorpusConfig,
               device=None):
    """Balanced split in shuffled order: (tokens, mask, categories)."""
    m = cfg.n_categories
    cats = torch.arange(m, dtype=torch.int32).repeat_interleave(n_per_category)
    cats = cats[torch.randperm(cats.numel(), generator=gen,
                               device=gen.device).cpu()]
    tokens, mask = sample_queries(gen, cats, cfg, device)
    return tokens, mask, cats.to(tokens.device)
