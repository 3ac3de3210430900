"""End-to-end encoder TRAINING on the PyTorch port: generic pretraining,
then CCFT categorical fine-tuning of the embedding encoder (d 128, 3
layers, 4 heads), with the category silhouette every 50 steps and
msgpack checkpoints (the counterpart of ``examples/train_encoder_e2e.py``).

    PYTHONPATH=src python examples/train_encoder_e2e_torch.py [--steps 300]
        [--device cpu]

It runs on the CUDA card by default (attention forward and backward on the
port's kernels); ``--device cpu`` runs the plain PyTorch versions. Draws
come from a ``TorchDraws`` source and the corpus from a CPU generator, both
seeded with ``--seed``.
"""
import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.contrastive import (make_category_pairs, make_generic_pairs,
                                     train_step)
from repro_torch.contrastive.finetune import category_silhouette
from repro_torch.core.draws import TorchDraws
from repro_torch.data.synth import CorpusConfig, make_split
from repro_torch.device import resolve_device
from repro_torch.encoder import EncoderConfig, init_encoder
from repro_torch.optim import adamw_init


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ckpt-dir", default="results/encoder_e2e_torch")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(args.seed)
    cfg = EncoderConfig(d_model=128, n_layers=3, n_heads=4, d_ff=512,
                        max_len=32)
    corpus = CorpusConfig(seq_len=32)
    params = init_encoder(gen, cfg, device=dev)
    opt = adamw_init(params)
    pt_tok, pt_mask, _ = make_split(gen, 100, corpus, dev)    # 700 queries
    ev_tok, ev_mask, ev_cats = make_split(gen, 8, corpus, dev)
    draws = TorchDraws(args.seed, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    n_pre = args.steps // 2
    print(f"[e2e] {dev}: phase 1: generic pretraining ({n_pre} steps)")
    sync()
    t0 = time.time()
    for i in range(n_pre):
        b = make_generic_pairs(draws, pt_tok, pt_mask, cfg.vocab_size,
                               args.batch)
        params, opt, loss = train_step(params, opt, b, cfg, 2e-3)
        if i % 50 == 0:
            sil = category_silhouette(params, cfg, ev_tok, ev_mask, ev_cats)
            sync()
            print(f"  step {i}: loss={float(loss):.4f} silhouette={sil:.3f} "
                  f"({(time.time() - t0) / (i + 1):.3f} s/it)")
    save_checkpoint(args.ckpt_dir, n_pre, params)

    print(f"[e2e] phase 2: CCFT categorical fine-tuning "
          f"({args.steps - n_pre} steps)")
    off_tok, off_mask, off_cats = make_split(gen, 5, corpus, dev)
    opt = adamw_init(params)
    for i in range(args.steps - n_pre):
        b = make_category_pairs(draws, off_tok, off_mask, off_cats,
                                args.batch)
        params, opt, loss = train_step(params, opt, b, cfg, 1e-3)
        if i % 50 == 0:
            sil = category_silhouette(params, cfg, ev_tok, ev_mask, ev_cats)
            print(f"  step {i}: loss={float(loss):.4f} silhouette={sil:.3f}")
    save_checkpoint(args.ckpt_dir, args.steps, params)
    sil = category_silhouette(params, cfg, ev_tok, ev_mask, ev_cats)
    assert math.isfinite(sil), "silhouette is not finite"
    print(f"[e2e] done: final silhouette={sil:.3f} "
          f"(checkpoints in {args.ckpt_dir})")


if __name__ == "__main__":
    main()
