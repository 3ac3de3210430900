"""End to end on the PyTorch port: serve a pool of reduced candidate
models with batched routed requests, through every layer (the counterpart
of ``examples/routed_serving_e2e.py``):

    synthetic queries -> encoder (CCFT fine-tuned) -> RouterService
    (FGTS.CDB posterior, the SGLD and selection kernels) -> two candidate
    archs decode tokens (KV cache / recurrent state) -> BTL preference
    feedback -> posterior update -> regret and cost.

    PYTHONPATH=src python examples/routed_serving_e2e_torch.py [--rounds 25]
        [--device cpu]

It runs on the CUDA card by default; ``--device cpu`` runs the plain
PyTorch versions. Draws come from ``KeyedDraws`` and the corpus and
weights from a CPU generator, seeded with ``--seed``.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.contrastive import finetune_categorical
from repro_torch.core import fgts
from repro_torch.core.btl import sample_preference
from repro_torch.core.ccft import category_embeddings
from repro_torch.core.draws import KeyedDraws
from repro_torch.data.pool import build_entries
from repro_torch.data.synth import CorpusConfig, make_split, sample_queries
from repro_torch.device import resolve_device
from repro_torch.encoder import EncoderConfig, encode, init_encoder
from repro_torch.launch.serve import greedy_decode
from repro_torch.models import lm
from repro_torch.serving import RouterService, RouterServiceConfig

POOL_ARCHS = ["granite-3-2b", "qwen2-7b", "mamba2-1.3b", "recurrentgemma-9b",
              "gemma2-9b"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--decode-every", type=int, default=5,
                    help="run real decode for the routed pair every N rounds")
    ap.add_argument("--finetune-steps", type=int, default=20,
                    help="CCFT fine-tuning steps per epoch (3 epochs)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(args.seed)
    ks = KeyedDraws(args.seed).split(4)
    n_cats, emb_dim = 5, 96
    corpus = CorpusConfig(n_categories=n_cats, seq_len=24)

    # --- pool: reduced variants of the archs, with latent skills
    models, skills = {}, []
    for i, name in enumerate(POOL_ARCHS):
        cfg = ARCHS[name].reduced()
        models[name] = (cfg, lm.init_params(gen, cfg, device=dev))
        skills.append(torch.softmax(
            3.0 * ks[0].fold_in(i).normal((n_cats,), dev), dim=-1))
    skills = torch.stack(skills)                   # (K, M)

    # --- encoder fine-tuned on a small offline split (CCFT offline phase)
    enc_cfg = EncoderConfig(d_model=emb_dim, n_layers=2, n_heads=4, d_ff=384,
                            max_len=24)
    enc = init_encoder(gen, enc_cfg, device=dev)
    off_tok, off_mask, off_cats = make_split(gen, 8, corpus, dev)
    enc, _ = finetune_categorical(ks[1], enc, off_tok, off_mask, off_cats,
                                  enc_cfg, epochs=3,
                                  steps_per_epoch=args.finetune_steps)

    # --- CCFT model embeddings: categorical weighting of the prototypes
    xi = category_embeddings(encode(enc, off_tok, off_mask, enc_cfg),
                             off_cats, n_cats)    # (d, M)
    a_emb = skills @ xi.T                          # eq. 3, perf weights

    pool = build_entries(POOL_ARCHS, a_emb,
                         [0.05 * (i + 1) for i in range(len(POOL_ARCHS))])
    fcfg = fgts.FGTSConfig(n_models=len(pool), dim=emb_dim,
                           horizon=args.rounds * args.batch, eta=2.0, mu=0.2,
                           sgld_steps=10, sgld_eps=2e-4, sgld_minibatch=32)
    svc = RouterService(pool, enc, enc_cfg,
                        RouterServiceConfig(fgts=fcfg, seed=args.seed),
                        device=dev)

    regrets = []
    spend = torch.zeros((), device=dev)
    t0 = time.time()
    for r in range(args.rounds):
        cats = torch.randint(0, n_cats, (args.batch,), generator=gen)
        toks, mask = sample_queries(gen, cats, corpus, dev)
        cats = cats.to(dev)
        x = svc.embed(toks, mask)
        a1, a2, tickets = svc.route_batch(x)
        spend = spend + svc.spend(a1) + svc.spend(a2)

        if r % args.decode_every == 0:            # the generation path
            for arm in a1[0].item(), a2[0].item():
                cfg, params = models[POOL_ARCHS[arm]]
                out = greedy_decode(cfg, params,
                                    toks[:1, :16] % cfg.vocab_size, 4)
                print(f"  round {r}: {POOL_ARCHS[arm]:<18} generated {out}")

        utils = skills[:, cats].T                  # (B, K) latent truth
        rows = torch.arange(args.batch, device=dev)
        y = sample_preference(ks[2].fold_in(r), 8.0 * utils[rows, a1.long()],
                              8.0 * utils[rows, a2.long()])
        svc.feedback_batch(tickets, y)
        best = utils.amax(-1)
        regrets.append(torch.mean(best - 0.5 * (
            utils[rows, a1.long()] + utils[rows, a2.long()])).item())

    q = max(args.rounds // 4, 1)
    early, late = np.mean(regrets[:q]), np.mean(regrets[-q:])
    print(f"\nrouted-serving summary ({args.rounds} rounds x {args.batch}):")
    print(f"  regret/round: early={early:.4f} late={late:.4f} "
          f"(adaptive: {late < early})")
    print(f"  total spend: ${spend.item():.2f}  "
          f"wall: {time.time() - t0:.1f}s  routed: {svc.n_routed} requests")
    return dict(regrets=regrets, n_routed=svc.n_routed)


if __name__ == "__main__":
    main()
