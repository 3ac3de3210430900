"""Glue: encoder -> CCFT embeddings -> online ``EnvData`` (counterpart of
``repro/data/pipeline.py``), the paper's §5.1/§5.2 recipes end to end:

  offline queries --encode--> xi_m --categorical weighting--> a_k
  (+ metadata appended to a_k, ones appended to x: §5.1)
  online queries  --encode--> x_t ; utils from metadata -> EnvData

Everything runs on the device of the tokens and the encoder's parameters;
the encoder's attention is the flash kernel on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import ccft
from repro_torch.core.env import EnvData
from repro_torch.encoder.model import EncoderConfig, encode

from . import mixinstruct as mi
from . import routerbench as rb

ENCODE_BATCH = 256


def _batched_encode(params, tokens, mask, enc_cfg,
                    batch: int = ENCODE_BATCH):
    return torch.cat([encode(params, tokens[i:i + batch], mask[i:i + batch],
                             enc_cfg)
                      for i in range(0, tokens.shape[0], batch)])


def routerbench_model_embeddings(enc_params, enc_cfg: EncoderConfig,
                                 split: rb.RouterBenchSplit, weighting: str,
                                 tau: int = 3, lam: float = rb.LAMBDA_COST,
                                 with_metadata: bool = True,
                                 perf_override=None):
    """CCFT §5.1: category embeddings from the offline split, categorical
    weighting from Tab. 3 scores, metadata appended. Returns (K, d[+2M])."""
    m = len(split.benchmarks)
    off_emb = _batched_encode(enc_params, split.offline_tokens,
                              split.offline_mask, enc_cfg)
    xi = ccft.category_embeddings(off_emb, split.offline_cats, m)   # (d, M)
    perf = split.perf if perf_override is None else perf_override
    if weighting == "perf":
        s = perf
    else:
        s = ccft.perf_cost_scores(perf, split.cost, lam)
    a = ccft.model_embeddings(xi, s, weighting, tau)                # (K, d)
    if with_metadata:
        a = ccft.append_metadata(a, _std_meta(perf, split.cost))
    return a


def _std_meta(perf, cost):
    """Per-column standardized metadata (population std, as ``jnp.std``):
    raw costs span 0.003-24.29 and would otherwise drown phi's semantic
    dims."""
    meta = torch.cat([perf, cost], dim=-1)                          # (K, 2M)
    mu = meta.mean(dim=0, keepdim=True)
    sd = torch.clamp_min(meta.std(dim=0, keepdim=True, correction=0), 1e-6)
    return 0.3 * (meta - mu) / sd


def routerbench_env(enc_params, enc_cfg: EncoderConfig,
                    split: rb.RouterBenchSplit, *,
                    with_metadata: bool = True,
                    feedback_scale: float = 8.0,
                    cost_aware: bool = True) -> EnvData:
    """The online environment: encoded online queries (ones appended for
    the metadata slots) and utilities perf - lambda*cost of each model on
    each query's benchmark (raw perf with ``cost_aware=False``)."""
    x = _batched_encode(enc_params, split.online_tokens, split.online_mask,
                        enc_cfg)
    if with_metadata:
        x = ccft.pad_queries(x, 2 * len(split.benchmarks))
    u = rb.scores(split.perf, split.cost) if cost_aware else split.perf
    utils = rb.utilities_for_stream(split.online_cats, u)
    return EnvData(x=x, utils=utils, feedback_scale=float(feedback_scale))


def openai_prompt_embeddings(enc_params, enc_cfg: EncoderConfig,
                             split: rb.RouterBenchSplit, n_queries: int = 5,
                             with_metadata: bool = True):
    """OpenAItext_n emulation (§5.1 / App. D): the model description prompt
    is the first n offline queries of the LLM's strongest benchmark
    (index 0 fills the prompt up to n when the benchmark has fewer, as the
    reference's ``jnp.where(..., size=n, fill_value=0)``), concatenated and
    cut to ``max_len`` tokens, encoded as one sequence."""
    k_models = split.perf.shape[0]
    best_cat = torch.argmax(split.perf, dim=-1)                    # (K,)
    dev = split.offline_tokens.device
    embs = []
    for k in range(k_models):
        hits = torch.nonzero(split.offline_cats == best_cat[k])[:n_queries, 0]
        idx = torch.zeros((n_queries,), dtype=torch.long, device=dev)
        idx[:hits.numel()] = hits
        toks = split.offline_tokens[idx].reshape(1, -1)[:, :enc_cfg.max_len]
        msk = torch.ones(toks.shape, dtype=torch.float32, device=dev)
        embs.append(encode(enc_params, toks, msk, enc_cfg)[0])
    a = torch.stack(embs)
    if with_metadata:
        a = ccft.append_metadata(a, _std_meta(split.perf, split.cost))
    return a


def mean_embeddings(enc_params, enc_cfg: EncoderConfig,
                    split: rb.RouterBenchSplit, with_metadata: bool = True):
    """OpenAItext_mean emulation (§4.1): a_k = mean offline-query embedding
    of the LLM's strongest benchmark."""
    best_cat = torch.argmax(split.perf, dim=-1)
    off_emb = _batched_encode(enc_params, split.offline_tokens,
                              split.offline_mask, enc_cfg)
    xi = ccft.category_embeddings(off_emb, split.offline_cats,
                                  len(split.benchmarks))            # (d, M)
    a = xi.T[best_cat]
    if with_metadata:
        a = ccft.append_metadata(a, _std_meta(split.perf, split.cost))
    return a


def mixinstruct_env_and_embeddings(enc_params, enc_cfg: EncoderConfig,
                                   data: dict, n_offline: int = 110,
                                   feedback_scale: float = 8.0):
    """§5.2: the offline prefix gives the eq. 6 label-proportion embeddings
    (labels = best-matching LLM); the rest is the online stream with
    utilities from the pairwise tables. Returns (EnvData, a (K, d))."""
    emb = _batched_encode(enc_params, data["tokens"], data["mask"], enc_cfg)
    labels = mi.best_model_labels(data["pairwise"])
    a = ccft.label_proportion_embeddings(emb[:n_offline], labels[:n_offline],
                                         mi.N_MODELS)
    utils = mi.scores_from_pairwise(data["pairwise"])[n_offline:]
    env = EnvData(x=emb[n_offline:], utils=utils,
                  feedback_scale=float(feedback_scale))
    return env, a
