"""Training driver: real steps of one candidate LM (counterpart of
``repro/launch/train.py``).

It runs on the CUDA card unless ``--device cpu`` is given (without a card
and without it, it raises). On the CPU it trains the reduced variants
(``--reduced``, the default); on the card ``--full`` trains the full
config.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch granite-3-2b --steps 3 --batch 2 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --full --steps 3 --batch 2 --seq 4096 [--ckpt-dir ckpts/]

As the reference: random weights from ``--seed``, synthetic batches
(random tokens and labels; the vision front end's patches and the
encoder's frames as normals), AdamW with weight decay 0.1 under a linear
warm-up and cosine schedule, a restore from the latest checkpoint in
``--ckpt-dir``, a checkpoint every 50 steps and at the end (the
reference's msgpack format, so either package restores the other's), and
an error if any loss is not finite. The weights come from a
``torch.Generator`` seeded with ``seed``, where the reference splits a
PRNG key; the batches come from a draw source (``draws``; by default
``TorchDraws(seed)``), split as the reference splits its data key.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ARCHS
from repro_torch.core.draws import TorchDraws
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.optim import adamw_init, linear_warmup_cosine

CKPT_EVERY = 50


def synthetic_batch(draws, cfg, batch: int, seq: int, device=None) -> dict:
    """Random tokens and labels (B, text) in [0, vocab), the text being
    ``seq`` less the vision front end's tokens (at least 8), with the
    patches (B, n_frontend_tokens, d) or the encoder's frames
    (B, enc_frames, d) as standard normals in the model's dtype. The draws
    split into three as the reference's key does (tokens, labels, front
    end), the frames from the front end's source folded in with 1."""
    dev = resolve_device(device)
    dt, dl, dp = draws.split(3)
    dtype = getattr(torch, cfg.dtype)
    text = seq
    out = {}
    if cfg.frontend == "vision":
        text = max(seq - cfg.n_frontend_tokens, 8)
        out["patches"] = dp.normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model), dev).to(dtype)
    if cfg.is_encdec:
        out["frames"] = dp.fold_in(1).normal(
            (batch, cfg.enc_frames, cfg.d_model), dev).to(dtype)
    out["tokens"] = dt.randint((batch, text), 0, cfg.vocab_size, dev).to(
        torch.int32)
    out["labels"] = dl.randint((batch, text), 0, cfg.vocab_size, dev).to(
        torch.int32)
    return out


def train(arch: str, steps: int, batch: int, seq: int, reduced: bool,
          lr: float = 3e-4, ckpt_dir: str | None = None, seed: int = 0,
          log_every: int = 1, device=None, draws=None) -> list[float]:
    """Train ``arch`` for ``steps`` steps (from the latest checkpoint's
    step, if any). Returns the losses of the steps run."""
    dev = resolve_device(device)
    cfg = ARCHS[arch]
    if reduced:
        cfg = cfg.reduced()
    draws = TorchDraws(seed, dev) if draws is None else draws
    _, d_data = draws.split(2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_params(gen, cfg, device=dev)
    opt = adamw_init(params)
    sched = linear_warmup_cosine(lr, warmup=min(20, steps // 10 + 1),
                                 total_steps=steps)

    start = 0
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            params = restore_checkpoint(ckpt_dir, last, params)
            start = last
            print(f"[train] restored step {last} from {ckpt_dir}")

    losses = []
    t0 = time.time()
    for i in range(start, steps):
        d_data, d_batch = d_data.split(2)
        b = synthetic_batch(d_batch, cfg, batch, seq, dev)
        params, opt, metrics = steps_lib.train_update(
            params, opt, b, cfg, sched(torch.tensor(i, dtype=torch.float32,
                                                    device=dev)))
        losses.append(float(metrics["loss"]))
        if i % log_every == 0 or i == steps - 1:
            print(f"[train] {arch} step {i}: loss={losses[-1]:.4f} "
                  f"aux={float(metrics['aux']):.4f} "
                  f"({(time.time() - t0) / (i - start + 1):.2f}s/step)")
        if ckpt_dir and (i + 1) % CKPT_EVERY == 0:
            save_checkpoint(ckpt_dir, i + 1, params)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, params)
    if not all(math.isfinite(x) for x in losses):
        raise FloatingPointError(f"[train] non-finite loss: {losses}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions on the CPU (default: "
                         "the CUDA card)")
    args = ap.parse_args(argv)
    losses = train(args.arch, args.steps, args.batch, args.seq, args.reduced,
                   args.lr, args.ckpt_dir, args.seed, device=args.device)
    if losses:
        print(f"[train] done: first={losses[0]:.4f} last={losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
