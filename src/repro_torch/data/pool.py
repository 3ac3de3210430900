"""Candidate-pool registry: the 10 architectures as router arms
(counterpart of ``repro/data/pool.py``).

Each architecture gets a per-category skill vector derived from its
published character (long-context archs score higher on long-doc
categories, the VLM on multimodal, ...) and a relative serving cost from
its active-parameter count. ``PoolEntry`` is the serving layer's
per-model record; ``build_entries`` and ``synthetic_pool`` are the two
ways the drivers (``launch/serve.py``, the routed-serving example) build
their entry lists.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PoolEntry:
    """One candidate model as the router sees it (re-exported by
    ``repro_torch.serving``)."""
    name: str
    arch: str                      # architecture id (repro_torch.configs)
    cost_per_1k_tokens: float
    embedding: np.ndarray          # CCFT model embedding a_k
    generate_fn: Optional[Callable] = None   # (tokens) -> response


def build_entries(names: Sequence[str], embeddings, costs,
                  archs: Sequence[str] | None = None) -> list[PoolEntry]:
    """(names, (K, d) embeddings, (K,) costs) -> ``PoolEntry`` rows;
    ``archs`` defaults to ``names``."""
    if isinstance(embeddings, torch.Tensor):
        embeddings = embeddings.detach().cpu().numpy()
    embeddings = np.asarray(embeddings, np.float32)
    if len(names) != embeddings.shape[0] or len(names) != len(costs):
        raise ValueError(
            f"pool shapes disagree: {len(names)} names, "
            f"{embeddings.shape[0]} embeddings, {len(costs)} costs")
    archs = list(names) if archs is None else list(archs)
    return [PoolEntry(name=n, arch=a, cost_per_1k_tokens=float(c),
                      embedding=embeddings[i])
            for i, (n, a, c) in enumerate(zip(names, archs, costs))]


def synthetic_pool(draws, arch_names: Sequence[str], n_cats: int,
                   emb_dim: int, cost_step: float = 0.1, device=None):
    """Pool entries with latent per-category skills and CCFT-style
    embeddings (categorical weighting of unit category prototypes).

    ``draws`` is a draw source (``core.draws``) where the reference takes
    a key. Returns ``(entries, skills (K, M), protos (M, d))`` as tensors
    on ``device``."""
    dev = resolve_device(device)
    ks = draws.split(len(arch_names) + 1)
    protos = ks[-1].normal((n_cats, emb_dim), dev)
    protos = protos / torch.linalg.vector_norm(protos, dim=-1, keepdim=True)
    skills = torch.stack([
        torch.softmax(3.0 * ks[i].normal((n_cats,), dev), dim=-1)
        for i in range(len(arch_names))])
    embs = skills @ protos                         # categorical weighting
    entries = build_entries(
        [f"{n}-pool" for n in arch_names], embs,
        [cost_step * (i + 1) for i in range(len(arch_names))],
        archs=list(arch_names))
    return entries, skills, protos


CATEGORIES = ["reasoning", "code", "long-doc", "multilingual", "chat",
              "multimodal", "summarize"]

# Hand-specified skill profiles in [0,1] (rows: arch; cols: CATEGORIES),
# simulation ground truth only.
SKILLS = {
    "recurrentgemma-9b":    [0.62, 0.55, 0.85, 0.55, 0.65, 0.10, 0.75],
    "qwen2-7b":             [0.68, 0.72, 0.45, 0.80, 0.70, 0.10, 0.65],
    "granite-moe-3b-a800m": [0.50, 0.60, 0.35, 0.50, 0.55, 0.05, 0.55],
    "arctic-480b":          [0.85, 0.88, 0.55, 0.75, 0.80, 0.10, 0.80],
    "gemma2-9b":            [0.72, 0.65, 0.60, 0.65, 0.78, 0.10, 0.72],
    "granite-3-2b":         [0.48, 0.55, 0.30, 0.45, 0.58, 0.05, 0.52],
    "mistral-large-123b":   [0.88, 0.85, 0.60, 0.82, 0.85, 0.10, 0.82],
    "llava-next-34b":       [0.70, 0.55, 0.40, 0.55, 0.68, 0.90, 0.62],
    "mamba2-1.3b":          [0.40, 0.42, 0.80, 0.35, 0.45, 0.05, 0.60],
    "seamless-m4t-medium":  [0.35, 0.20, 0.30, 0.90, 0.50, 0.70, 0.45],
}


def skill_matrix() -> np.ndarray:
    """(K, M) in registry order (sorted arch ids)."""
    return np.asarray([SKILLS[a] for a in sorted(SKILLS)], np.float32)


def arch_ids() -> list[str]:
    return sorted(SKILLS)


def serving_cost_per_1k() -> np.ndarray:
    """Relative $ / 1k tokens ~ active params (normalized to granite-3-2b)."""
    base = ARCHS["granite-3-2b"].active_param_count()
    return np.asarray(
        [0.05 * ARCHS[a].active_param_count() / base for a in sorted(SKILLS)],
        np.float32)


def utilities(categories: np.ndarray, lam: float = 0.0) -> np.ndarray:
    """(T, K) ground-truth utilities for a category stream, optionally
    cost-tilted (perf - lam * cost)."""
    s = skill_matrix().T[categories]                     # (T, K)
    if lam:
        s = s - lam * serving_cost_per_1k()[None, :]
    return s
