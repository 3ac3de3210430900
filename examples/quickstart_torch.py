"""Quickstart on the PyTorch port: route queries across 11 LLMs with
FGTS.CDB + CCFT (the counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
        [--rounds 300] [--epochs 4] [--steps-per-epoch 30] [--seed 0]

Builds the RouterBench world (synthetic queries + the paper's Tab. 3
metadata), fine-tunes the encoder on 35 offline queries (5 per benchmark,
the paper's entire offline budget), derives excel_perf_cost model
embeddings, and runs 300 online rounds of preference-feedback routing.

It runs on the CUDA card by default (the encoder's attention forward and
backward, the SGLD gradient and the pair selection on the port's
kernels); ``--device cpu`` runs the plain PyTorch versions. The world and
the encoder's weights come from a CPU ``torch.Generator``, every draw of
the fine-tuning and of the online loop from ``KeyedDraws``, both seeded
with ``--seed``.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.contrastive import finetune_categorical
from repro_torch.core import env, fgts, policy, regret
from repro_torch.core.ccft import scores_all
from repro_torch.core.draws import KeyedDraws
from repro_torch.data import pipeline, routerbench as rb
from repro_torch.data.synth import CorpusConfig
from repro_torch.device import resolve_device
from repro_torch.encoder import EncoderConfig, init_encoder

ENC_CFG = EncoderConfig(d_model=128, n_layers=2, n_heads=4, d_ff=512)
CORPUS = CorpusConfig(seq_len=32)
N_PICKS = 10
SGLD_STEPS = 20


def make_world(seed, device, rounds=300):
    """The world (the RouterBench split: 5 offline queries per benchmark,
    ``rounds`` online ones, the Tab. 3 perf / cost metadata) and the
    encoder's weights, from one CPU ``torch.Generator`` of ``seed``, on
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    split = rb.make_split(gen, CORPUS, n_offline_per_cat=5, t_online=rounds,
                          device=device)
    return split, init_encoder(gen, ENC_CFG, device=device)


def run(split, enc, draws, *, epochs=4, steps_per_epoch=30,
        sgld_steps=SGLD_STEPS):
    """The example's steps on a given world (``rb.RouterBenchSplit``),
    encoder weights and draw source (split in two: the fine-tuning's, the
    online loop's). Returns a dict of tensors on the world's device: the
    cumulative regret ``cum`` (T,), the routed pairs ``pairs`` (T, 2), the
    chain-mean thetas each round selected with ``thetas`` (T, 2, d), the
    online features ``x`` (T, d), the last ``N_PICKS`` rounds' favoured
    models under the final chain-mean theta ``picks``, the fine-tuning's
    mean loss of each epoch ``losses`` (floats), the model embeddings
    ``a_emb`` and the queries of each encode call ``encoded`` (ints)."""
    k_ft, k_run = draws.split(2)
    # CCFT offline phase: contrastively fine-tune the encoder on the
    # offline queries, grouped by source benchmark
    enc, losses = finetune_categorical(
        k_ft, enc, split.offline_tokens, split.offline_mask,
        split.offline_cats, ENC_CFG, epochs=epochs,
        steps_per_epoch=steps_per_epoch)
    # model embeddings a_k = xi softmax(top_tau(perf - 0.05 cost)) (eq. 4)
    a_emb = pipeline.routerbench_model_embeddings(enc, ENC_CFG, split,
                                                  "excel_perf_cost")
    # online phase: FGTS.CDB with SGLD posterior sampling
    e = pipeline.routerbench_env(enc, ENC_CFG, split)
    t = e.x.shape[0]
    cfg = fgts.FGTSConfig(n_models=rb.N_MODELS, dim=e.x.shape[1], horizon=t,
                          eta=8.0, mu=0.2, sgld_steps=sgld_steps,
                          sgld_eps=5e-4, sgld_minibatch=64)
    cum, state, (a1, a2, th1, th2) = env.run(
        k_run, e, policy.fgts_policy(a_emb, cfg),
        aux_fn=lambda s, a1, a2: (a1, a2, s.theta1.mean(dim=0),
                                  s.theta2.mean(dim=0)))
    theta = state.theta1.mean(dim=0)
    picks = torch.stack([torch.argmax(scores_all(e.x[i], a_emb, theta))
                         for i in range(max(t - N_PICKS, 0), t)])
    return dict(cum=cum, pairs=torch.stack([a1, a2], dim=-1)[:, 0],
                thetas=torch.stack([th1, th2], dim=1), x=e.x, picks=picks,
                losses=losses, a_emb=a_emb,
                encoded=[split.offline_tokens.shape[0], t])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=300,
                    help="online rounds (the stream's length)")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--steps-per-epoch", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    split, enc = make_world(args.seed, dev, rounds=args.rounds)
    out = run(split, enc, KeyedDraws(args.seed), epochs=args.epochs,
              steps_per_epoch=args.steps_per_epoch)
    cum = out["cum"].cpu()
    wall_s = time.perf_counter() - t0
    losses = out["losses"]
    picks = [rb.LLMS[p] for p in out["picks"].tolist()]
    ratio = regret.slope_ratio(cum)
    print(f"[{dev}] contrastive fine-tune: loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")
    print(f"online routing: {len(cum)} rounds, cumulative regret "
          f"{float(cum[-1]):.1f}, slope ratio {ratio:.3f} (<1 means "
          f"converging: paper Fig. 1's success criterion)")
    print(f"last-{len(picks)}-round picks:", picks)
    print(f"wall: {wall_s:.1f} s")
    return dict(regret=cum.tolist(), slope_ratio=ratio, picks=picks,
                losses=losses, wall_s=wall_s, rounds=len(cum),
                encoded=out["encoded"])


if __name__ == "__main__":
    main()
