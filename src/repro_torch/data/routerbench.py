"""RouterBench metadata (Hu et al. 2024) and the paper's §5.1 split
(counterpart of ``repro/data/routerbench.py``).

``PERF``/``COST`` are the paper's Tab. 3 (= Table 1 of Hu et al. 2024),
copied verbatim. Queries are synthesized per benchmark category
(``data/synth.py``); the utility of an LLM on a query is its performance
metadata on the query's benchmark. Splits are drawn from a CPU
``torch.Generator`` and moved to ``device``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

from .synth import make_split as synth_split, sample_queries

BENCHMARKS = ["MMLU", "MT-Bench", "MBPP", "HellaSwag", "Winogrande", "GSM8k",
              "ARC"]

LLMS = ["WizardLM 13B", "Mistral 7B", "Mixtral 8x7B", "Code Llama 34B",
        "Yi 34B", "GPT-3.5", "Claude Instant V1", "Llama 70B", "Claude V1",
        "Claude V2", "GPT-4"]

# Tab. 3 — Performance (rows: LLMs, cols: benchmarks).
PERF = np.array([
    [0.568, 0.796, 0.364, 0.636, 0.512, 0.510, 0.660],   # WizardLM 13B
    [0.562, 0.779, 0.349, 0.541, 0.562, 0.409, 0.642],   # Mistral 7B
    [0.733, 0.921, 0.573, 0.707, 0.677, 0.515, 0.844],   # Mixtral 8x7B
    [0.569, 0.796, 0.465, 0.525, 0.617, 0.462, 0.644],   # Code Llama 34B
    [0.743, 0.938, 0.333, 0.931, 0.748, 0.552, 0.882],   # Yi 34B
    [0.720, 0.908, 0.651, 0.816, 0.630, 0.601, 0.855],   # GPT-3.5
    [0.384, 0.863, 0.550, 0.801, 0.512, 0.626, 0.821],   # Claude Instant V1
    [0.647, 0.854, 0.302, 0.736, 0.504, 0.529, 0.794],   # Llama 70B
    [0.475, 0.938, 0.527, 0.841, 0.570, 0.653, 0.889],   # Claude V1
    [0.619, 0.854, 0.605, 0.421, 0.446, 0.664, 0.546],   # Claude V2
    [0.828, 0.971, 0.682, 0.923, 0.858, 0.654, 0.921],   # GPT-4
], np.float32)

# Tab. 3 — Cost.
COST = np.array([
    [0.122, 0.006, 0.011, 0.727, 0.040, 0.354, 0.068],
    [0.081, 0.003, 0.006, 0.485, 0.027, 0.210, 0.046],
    [0.245, 0.012, 0.023, 1.455, 0.081, 0.594, 0.137],
    [0.317, 0.015, 0.021, 1.882, 0.104, 0.752, 0.177],
    [0.326, 0.018, 0.031, 1.938, 0.107, 0.867, 0.182],
    [0.408, 0.026, 0.044, 2.426, 0.134, 1.170, 0.228],
    [0.327, 0.030, 0.064, 1.943, 0.108, 1.300, 0.183],
    [0.367, 0.022, 0.039, 2.183, 0.121, 0.870, 0.205],
    [3.269, 0.361, 0.607, 19.43, 1.077, 11.09, 1.829],
    [3.270, 0.277, 0.770, 19.50, 1.081, 13.49, 1.833],
    [4.086, 0.721, 1.235, 24.29, 1.346, 19.08, 2.286],
], np.float32)

N_MODELS = len(LLMS)
N_BENCHMARKS = len(BENCHMARKS)
LAMBDA_COST = 0.05   # paper's balance parameter


@dataclasses.dataclass(frozen=True)
class RouterBenchSplit:
    """Offline (embedding-learning) + online (bandit) data."""
    offline_tokens: torch.Tensor  # (N_off, L)
    offline_mask: torch.Tensor
    offline_cats: torch.Tensor    # (N_off,)
    online_tokens: torch.Tensor   # (T, L)
    online_mask: torch.Tensor
    online_cats: torch.Tensor     # (T,)
    perf: torch.Tensor            # (K, M) possibly restricted
    cost: torch.Tensor
    benchmarks: tuple


def scores(perf=PERF, cost=COST, lam: float = LAMBDA_COST):
    """Tab. 1 column (i): Perf_cost = Perf - lambda * Cost."""
    return perf - lam * cost


def utilities_for_stream(cats: torch.Tensor,
                         perf: torch.Tensor) -> torch.Tensor:
    """(T, K): utility of model k on query t = perf on its benchmark."""
    return perf.T[cats.long()]


def _metadata(bidx, dev):
    return (torch.from_numpy(PERF[:, bidx]).to(dev),
            torch.from_numpy(COST[:, bidx]).to(dev))


def make_split(gen: torch.Generator, corpus_cfg, n_offline_per_cat: int = 5,
               t_online: int = 700, benchmarks=None,
               device=None) -> RouterBenchSplit:
    """Paper §5.1: 5 offline queries per benchmark (excluded from online)."""
    dev = resolve_device(device)
    bidx = (list(range(N_BENCHMARKS)) if benchmarks is None
            else [BENCHMARKS.index(b) for b in benchmarks])
    m = len(bidx)
    cc = dataclasses.replace(corpus_cfg, n_categories=m)
    off_tok, off_mask, off_cats = synth_split(gen, n_offline_per_cat, cc, dev)
    on_cats = torch.randint(0, m, (t_online,), generator=gen,
                            device=gen.device, dtype=torch.int32)
    on_tok, on_mask = sample_queries(gen, on_cats, cc, dev)
    return RouterBenchSplit(off_tok, off_mask, off_cats, on_tok, on_mask,
                            on_cats.to(dev), *_metadata(bidx, dev),
                            tuple(BENCHMARKS[i] for i in bidx))


def _shuffled(gen, cats):
    return cats[torch.randperm(cats.numel(), generator=gen,
                               device=gen.device).cpu()]


def make_generalization_split(gen: torch.Generator, corpus_cfg,
                              n_offline_per_cat: int = 15, device=None):
    """§5.1.1 robust-generalization pipeline: MT-Bench dropped; ARC hidden
    offline and in section 1 (300 shuffled queries from the 5 seen
    benchmarks); section 2 is 120 ARC + 300 seen queries shuffled together.
    Returns (split, index of the unseen category)."""
    dev = resolve_device(device)
    seen = ["MMLU", "MBPP", "HellaSwag", "Winogrande", "GSM8k"]
    all_b = seen + ["ARC"]
    bidx = [BENCHMARKS.index(b) for b in all_b]
    cc = dataclasses.replace(corpus_cfg, n_categories=len(all_b))
    n_seen = len(seen)
    seen_ids = torch.arange(n_seen, dtype=torch.int32)

    off_cats = _shuffled(gen, seen_ids.repeat_interleave(n_offline_per_cat))
    off_tok, off_mask = sample_queries(gen, off_cats, cc, dev)
    s1_cats = _shuffled(gen, seen_ids.repeat_interleave(60))
    s1_tok, s1_mask = sample_queries(gen, s1_cats, cc, dev)
    s2_cats = _shuffled(gen, torch.cat([
        torch.full((120,), n_seen, dtype=torch.int32),
        seen_ids.repeat_interleave(60)]))
    s2_tok, s2_mask = sample_queries(gen, s2_cats, cc, dev)

    split = RouterBenchSplit(
        off_tok, off_mask, off_cats.to(dev), torch.cat([s1_tok, s2_tok]),
        torch.cat([s1_mask, s2_mask]), torch.cat([s1_cats, s2_cats]).to(dev),
        *_metadata(bidx, dev), tuple(all_b))
    return split, n_seen
