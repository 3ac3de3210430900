#!/usr/bin/env python3
"""Time the port's timed kernel cases in two checkouts, in turns.

    python3 tools/ab_kernels.py --other DIR [--out FILE] [--prefill] [--paths]

``DIR`` is another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into the ignored ``build/``). Four
worker processes run one after another on the same card: other, this,
this, other. Each builds its own checkout's kernels (into that checkout's
``build/``), then times, with that checkout's ``chip_smoke`` case
functions:

- ``flash_attention`` fp32 ``main`` (the encoder: B 256, H = KV 4,
  S = T 64, D 64, bidirectional) and ``bench`` (qwen2-7b's heads in fp32,
  causal, S = T 2048);
- ``ssd_scan`` ``main`` (mamba2-1.3b's prefill, bf16 strided),
  ``main_fp32`` and ``bench`` (B 1, S 32768);
- ``sgld_potential`` fgts mode, forward and gradient, ``main`` (the
  routing loop's C 8 chains, m 64, K 16, d 768; a control that no kernel
  change of the mixed mode or the scores may move) and ``bench`` (m 1024,
  K 1024);
- ``rglru_scan`` ``main`` (recurrentgemma-9b's prefill, B 2, S 4096,
  D 4096) and ``bench`` (B 4, S 32768);
- ``sgld_mixed``, forward and gradient, ``main`` (the mixed loop's C 8
  chains, m 64, K 16, d 768, half clicks) and ``bench`` (m 1024, K 1024);
- ``dueling_score`` ``main`` (``posterior_scores`` of the autopilot's 16
  chains, K 16, d 768) and ``bench`` (B 4096, K 1024, J 2).

With ``--prefill`` each worker also times mamba2-1.3b's and
recurrentgemma-9b's ``lm.prefill`` (random bf16 weights, B 2 x 4096
tokens; host clock around a synchronised call, median of 3) and the fp32
encoder (``EncoderConfig()``, one 256-query batch of 64 tokens; median of
20). With ``--paths`` it also runs that checkout's ``chip_smoke`` autopilot
and mixed paths (16 ticks at full width, then 2 profiled ticks) and keeps
their ms per tick, device busy ms per tick and idle share. Prints one
JSON line per worker and a summary line of every time (``*ms`` field) by
checkout; every record names the card and its power limit. Needs one
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ATTN = {"main": (256, 4, 4, 64, 64, 64, dict(causal=False)),
        "bench": (1, 28, 4, 2048, 2048, 128, dict())}
SSD = {"main": (2, 4096, 64, 64, 128, 128, dict(dtype="bfloat16")),
       "main_fp32": (2, 4096, 64, 64, 128, 128, dict()),
       "bench": (1, 32768, 64, 64, 128, 128, dict(dtype="bfloat16"))}
SGLD = {"main": (8, 64, 16, 768, 4096), "bench": (8, 1024, 1024, 768, 4096)}
SCORE = {"main": (1, 16, 768, 16, dict(posterior=True, live=11)),
         "bench": (4096, 1024, 768, 2, dict())}
RGLRU = {"main": (2, 4096, 4096), "bench": (4, 32768, 4096)}
KEYS = ("ms", "device_ms", "bound_ms", "max_abs_err", "library_ms",
        "library_device_ms")


def worker(root: Path, prefill: bool, paths: bool) -> dict:
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    out = dict(root=str(root), build_s=time.perf_counter() - t0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (b, h, kv, s, t, d, kw) in ATTN.items():
        r = cs.attn_case(name, b, h, kv, s, t, d, gen, dev, timed=True, **kw)
        out[f"attn_{name}"] = {k: r.get(k) for k in KEYS}
    for name, (b, s, h, p, n, c, kw) in SSD.items():
        r = cs.ssd_case(name, b, s, h, p, n, c, gen, dev, strided=True,
                        timed=True, **kw)
        out[f"ssd_{name}"] = {k: r.get(k) for k in KEYS}
    for name, (c, m, k, d, n) in SGLD.items():
        r = cs.sgld_case(name, c, m, k, d, n, gen, dev, timed=True)
        out[f"sgld_{name}"] = {k: v for k, v in r.items()
                               if k.endswith(("_ms", "_err"))}
    for name, (b, s, d) in RGLRU.items():
        r = cs.rglru_case(name, b, s, d, gen, dev, timed=True)
        out[f"rglru_{name}"] = {k: r.get(k) for k in KEYS}
    for name, (c, m, k, d, n) in SGLD.items():
        r = cs.mixed_case(name, c, m, k, d, n, gen, dev, timed=True)
        out[f"mixed_{name}"] = {k: v for k, v in r.items()
                                if k.endswith(("_ms", "_err"))}
    for name, (b, k, d, j, kw) in SCORE.items():
        r = cs.score_case(name, b, k, d, j, gen, dev, timed=True, **kw)
        out[f"score_{name}"] = {k: v for k, v in r.items()
                                if k.endswith(("_ms", "_err"))}
    if prefill:
        out.update(prefill_times(dev))
    if paths:
        for name, phase in (("autopilot", cs.phase_autopilot),
                            ("mixed", cs.phase_mixed)):
            r = phase(dev, 0)
            out[f"path_{name}"] = dict(
                ms=r["ms_per_tick"],
                device_busy_ms=r["profile"]["device_busy_ms_per_tick"],
                device_idle_share=r["profile"]["device_idle_share"])
    return out


def prefill_times(dev) -> dict:
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.encoder import model as enc
    from repro_torch.models import lm
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        cfg = ARCHS[arch]
        params = lm.init_params(gen, cfg, device=dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4096),
                                         generator=gen, device=dev)}
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.prefill(params, batch, cfg, 4096 + 8)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        out[f"{arch.split('-')[0]}_prefill_ms"] = statistics.median(
            times[1:])
        del params
        torch.cuda.empty_cache()
    ecfg = enc.EncoderConfig()
    eparams = enc.init_encoder(gen, ecfg, device=dev)
    tok = torch.randint(0, ecfg.vocab_size, (256, 64), generator=gen,
                        device=dev)
    mask = torch.ones((256, 64), device=dev)
    etimes = []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode(eparams, tok, mask, ecfg)
        torch.cuda.synchronize()
        etimes.append(1e3 * (time.perf_counter() - t0))
    return dict(out, encode_batch_ms=statistics.median(etimes[1:]))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--out", help="also write the records here (JSON)")
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(Path(args.worker).resolve(), args.prefill,
                                args.paths)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA card", file=sys.stderr)
        return 2
    other = Path(args.other).resolve()
    records = []
    for label, root in (("other", other), ("this", HERE), ("this", HERE),
                        ("other", other)):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
               str(root)] + (["--prefill"] if args.prefill else []) + (
                   ["--paths"] if args.paths else [])
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1500, env=dict(os.environ,
                                                    PYTHONPATH=""))
        if run.returncode:
            print(run.stdout[-3000:], run.stderr[-6000:], file=sys.stderr)
            return 1
        rec = dict(json.loads(run.stdout.strip().splitlines()[-1]),
                   label=label, card=card())
        records.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {}
    for key in records[0]:
        if isinstance(records[0][key], dict):
            for f in records[0][key]:
                if not f.endswith("ms") or f.endswith("bound_ms"):
                    continue
                summary[f"{key}.{f}"] = {
                    lab: [r[key][f] for r in records if r["label"] == lab]
                    for lab in ("other", "this")}
        elif key.endswith("_ms"):
            summary[key] = {lab: [r[key] for r in records
                                  if r["label"] == lab]
                            for lab in ("other", "this")}
    print(json.dumps({"summary": summary, "card": records[0]["card"]}),
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
