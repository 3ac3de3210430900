"""MixInstruct-style routing on the PyTorch port: no metadata, pure pairwise
preferences (§5.2; the counterpart of
``examples/mixinstruct_preferences.py``).

    PYTHONPATH=src python examples/mixinstruct_preferences_torch.py
        [--device cpu] [--queries 500] [--epochs 4] [--steps-per-epoch 25]
        [--seed 1]

The score-free path: pairwise comparison tables -> Condorcet scoring ->
best-model labels -> eq. 6 label-proportion embeddings -> FGTS.CDB
online, after the ambiguity-removal pipeline (8% of the queries dropped).

It runs on the CUDA card by default (the encoder's attention forward and
backward, the SGLD gradient and the pair selection on the port's
kernels); ``--device cpu`` runs the plain PyTorch versions. The dataset
and the encoder's weights come from a CPU ``torch.Generator``, every draw
of the fine-tuning and of the online loop from ``KeyedDraws``, both
seeded with ``--seed``.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.contrastive import finetune_categorical
from repro_torch.core import env, fgts, policy, regret
from repro_torch.core.draws import KeyedDraws
from repro_torch.data import mixinstruct as mi, pipeline
from repro_torch.data.synth import CorpusConfig
from repro_torch.device import resolve_device
from repro_torch.encoder import EncoderConfig, init_encoder

ENC_CFG = EncoderConfig(d_model=128, n_layers=2, n_heads=4, d_ff=512)
CORPUS = CorpusConfig(n_categories=8, seq_len=32)
REMOVE = 0.08           # the paper's better setting
N_OFFLINE = 80
SGLD_STEPS = 10


def make_world(seed, device, queries=500):
    """The dataset (``queries`` MixInstruct-style queries and their
    pairwise tables) and the encoder's weights, from one CPU
    ``torch.Generator`` of ``seed``, on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    data = mi.make_dataset(gen, CORPUS,
                           mi.MixInstructConfig(n_queries=queries),
                           device=device)
    return data, init_encoder(gen, ENC_CFG, device=device)


def run(data, enc, draws, *, epochs=4, steps_per_epoch=25,
        sgld_steps=SGLD_STEPS):
    """The example's steps on a given dataset (``mi.make_dataset``'s dict),
    encoder weights and draw source (split in two: the fine-tuning's, the
    online loop's). Returns a dict of tensors on the dataset's device: the
    ambiguity scores ``ambiguity`` (N,), the indices of the queries kept
    after removal ``kept``, their best-model ``labels``, the cumulative
    regret ``cum`` over the online rounds, their routed pairs ``pairs``
    (T, 2), the chain-mean thetas each round selected with ``thetas``
    (T, 2, d) and the online features ``x`` (T, d), the fine-tuning's mean
    loss of each epoch ``losses`` (floats), the model embeddings ``a_emb``
    and the queries of each encode call ``encoded`` (ints)."""
    k_ft, k_run = draws.split(2)
    amb = mi.ambiguity_scores(data["pairwise"])
    n = data["tokens"].shape[0]
    data = mi.remove_ambiguous(dict(data, index=torch.arange(
        n, device=data["tokens"].device)), REMOVE)
    kept = data.pop("index")
    labels = mi.best_model_labels(data["pairwise"])
    enc, losses = finetune_categorical(
        k_ft, enc, data["tokens"][:N_OFFLINE], data["mask"][:N_OFFLINE],
        labels[:N_OFFLINE], ENC_CFG, epochs=epochs,
        steps_per_epoch=steps_per_epoch)
    e, a_emb = pipeline.mixinstruct_env_and_embeddings(enc, ENC_CFG, data,
                                                       n_offline=N_OFFLINE)
    cfg = fgts.FGTSConfig(n_models=mi.N_MODELS, dim=e.x.shape[1],
                          horizon=e.x.shape[0], sgld_steps=sgld_steps,
                          sgld_minibatch=64)
    cum, _, (a1, a2, th1, th2) = env.run(
        k_run, e, policy.fgts_policy(a_emb, cfg),
        aux_fn=lambda s, a1, a2: (a1, a2, s.theta1.mean(dim=0),
                                  s.theta2.mean(dim=0)))
    return dict(ambiguity=amb, kept=kept, labels=labels, cum=cum,
                pairs=torch.stack([a1, a2], dim=-1)[:, 0],
                thetas=torch.stack([th1, th2], dim=1), x=e.x, losses=losses,
                a_emb=a_emb, encoded=[kept.shape[0]])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=500,
                    help="queries in the dataset, before removal")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--steps-per-epoch", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    data, enc = make_world(args.seed, dev, queries=args.queries)
    out = run(data, enc, KeyedDraws(args.seed), epochs=args.epochs,
              steps_per_epoch=args.steps_per_epoch)
    cum = out["cum"].cpu()
    wall_s = time.perf_counter() - t0
    amb = out["ambiguity"].cpu()
    labels = out["labels"].cpu()
    counts = torch.bincount(labels.long(), minlength=mi.N_MODELS).tolist()
    shares = {name: c / len(labels) for name, c in zip(mi.MODELS, counts)}
    ratio = regret.slope_ratio(cum)
    print(f"[{dev}] ambiguity: mean={float(amb.mean()):.3f} "
          f"p95={float(torch.quantile(amb.double(), 0.95)):.3f}")
    print(f"kept {len(labels)} queries after {REMOVE:.0%} removal")
    print("best-model share (Tab. 2 analogue):")
    for name, s in sorted(shares.items(), key=lambda t: -t[1]):
        print(f"  {name:<16} {100 * s:5.1f}%")
    print(f"\nonline: {len(cum)} rounds, regret {float(cum[-1]):.1f}, "
          f"slope ratio {ratio:.3f}")
    print(f"wall: {wall_s:.1f} s")
    return dict(regret=cum.tolist(), slope_ratio=ratio, shares=shares,
                kept=len(labels), labels=labels.tolist(),
                losses=out["losses"], wall_s=wall_s, rounds=len(cum),
                encoded=out["encoded"])


if __name__ == "__main__":
    main()
