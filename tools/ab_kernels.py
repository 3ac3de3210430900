#!/usr/bin/env python3
"""Time the port's timed kernel cases in two checkouts, in turns.

    python3 tools/ab_kernels.py --other DIR [--out FILE] [--prefill] [--paths]
                                [--only attn_bwd | attn_bwd_bf16 |
                                        rglru_bwd | ssd_bwd]

``DIR`` is another checkout of this repository (for example the parent
commit unpacked with ``git archive`` into the ignored ``build/``). Four
worker processes run one after another on the same card: other, this,
this, other. Each builds its own checkout's kernels (into that checkout's
``build/``), then times, with that checkout's ``chip_smoke`` case
functions:

- ``flash_attention`` fp32 ``main`` (the encoder: B 256, H = KV 4,
  S = T 64, D 64, bidirectional) and ``bench`` (qwen2-7b's heads in fp32,
  causal, S = T 2048);
- ``flash_attention_bwd`` ``main`` (the training step: B 64, H = KV 4,
  S = T 64, D 64, bidirectional), ``bench`` (qwen2-7b's heads, causal,
  S = T 2048, D 128), ``e5b`` (B 64, H = KV 4, S = T 32, D 32,
  bidirectional) and ``minilm_d24`` (the same at D 24), each with SDPA's
  backward beside it and its device time split by kernel name
  (``torch.profiler``);
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
  chains, K 16, d 768) and ``bench`` (B 4096, K 1024, J 2);
- ``dueling_select`` ``main`` (the routing batch: B 256, K 16 with 11
  live, d 768), ``bench`` (B 4096, K 1024) and ``serve`` (a RouterService
  batch: B 4096 over the same 16 slots);
- ``rglru_scan_bwd`` ``main`` (recurrentgemma-9b's training shape: B 1,
  S 4096, D 4096) and ``bench`` (B 2), from the forward's h;
- ``ssd_scan_bwd`` ``main`` (mamba2-1.3b's training shape: B 2, S 4096,
  H 64, P 64, N 128, chunk 128, bf16 column slices, decays drawn as the
  model draws them) and ``bench`` (B 1, S 32768), where the checkout has
  it (its ``chip_smoke`` has ``ssd_bwd_case``; absent keys are skipped).

With ``--prefill`` each worker also times mamba2-1.3b's and
recurrentgemma-9b's ``lm.prefill`` (random bf16 weights, B 2 x 4096
tokens; host clock around a synchronised call, median of 3) and the fp32
encoder (``EncoderConfig()``, one 256-query batch of 64 tokens; median of
20). With ``--paths`` it also runs that checkout's ``chip_smoke`` FGTS
slice (its ``sync`` run), autopilot and mixed paths (16 ticks at full
width, then 2 profiled ticks) and keeps
their ms per tick, device busy ms per tick and idle share. Prints one
JSON line per worker and a summary line of every time (``*ms`` field) by
checkout; every record names the card and its power limit. ``--only
attn_bwd`` times the ``flash_attention_bwd`` cases alone; ``--only
attn_bwd_bf16`` times the bf16 backward alone (``transpose(1, 2)`` views
as the models hand them, 10 calls a measurement): granite-3-2b's heads
(``main``: B 2, H 32, KV 8, S = T 4096, D 64, causal), seamless-m4t's
encoder (``seamless_enc``: B 2, H = KV 16, S = T 1024, D 64, bidir) and
cross attention (``seamless_cross``: S 4096 over T 1024), gemma2-9b's
(``bench``: B 1, H 16, KV 8, S = T 8192, D 256, soft cap 50, window 4096),
recurrentgemma-9b's local layer (``recurrentgemma``: B 1, H 16, KV 1,
S = T 4096, D 256, window 2048) and qwen2-7b's (``qwen2``: B 2, H 28,
KV 4, S = T 4096, D 128, causal; these three 3 calls a measurement), each
with SDPA's backward beside it where it computes the same function, its
plan and its device time by kernel name; ``--only rglru_bwd`` and
``--only ssd_bwd`` time those two families alone;
``--worker DIR`` runs one worker on checkout ``DIR`` and prints its
record. Needs one CUDA card.
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
ATTN_BWD = {"main": (64, 4, 4, 64, 64, 64, dict(causal=False)),
            "bench": (1, 28, 4, 2048, 2048, 128, dict()),
            "e5b": (64, 4, 4, 32, 32, 32, dict(causal=False)),
            "minilm_d24": (64, 4, 4, 32, 32, 24, dict(causal=False))}
ATTN_BWD_BF16 = {
    "main": (2, 32, 8, 4096, 4096, 64, dict()),
    "seamless_enc": (2, 16, 16, 1024, 1024, 64, dict(causal=False)),
    "seamless_cross": (2, 16, 16, 4096, 1024, 64, dict(causal=False)),
    "bench": (1, 16, 8, 8192, 8192, 256, dict(window=4096, cap=50.0,
                                              calls=3)),
    "recurrentgemma": (1, 16, 1, 4096, 4096, 256, dict(window=2048,
                                                       calls=3)),
    "qwen2": (2, 28, 4, 4096, 4096, 128, dict(calls=3))}
RGLRU = {"main": (2, 4096, 4096), "bench": (4, 32768, 4096)}
RGLRU_BWD = {"main": (1, 4096, 4096), "bench": (2, 4096, 4096)}
SSD_BWD = {"main": (2, 4096, 64, 64, 128, 128),
           "bench": (1, 32768, 64, 64, 128, 128)}
ONLY = ("attn_bwd", "attn_bwd_bf16", "rglru_bwd", "ssd_bwd")
SELECT = {"main": (256, 16, 768, dict(mask_kind="k", live=11)),
          "bench": (4096, 1024, 768, dict()),
          "serve": (4096, 16, 768, dict(mask_kind="k", live=11))}
KEYS = ("ms", "device_ms", "bound_ms", "max_abs_err", "library_ms",
        "library_device_ms")


def _here_chip_smoke():
    """This checkout's ``chip_smoke`` (for ``device_split``), loaded beside
    the worker checkout's own."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bwd_split(r, b, h, kv, s, t, d, kw, dev) -> dict:
    """Device us per ``flash_attention_bwd`` call by kernel name: the
    case record's own, or, for a checkout whose ``chip_smoke`` does not
    record it, this checkout's ``device_split`` on the same shape."""
    if r.get("device_us_by_kernel") is not None:
        return r["device_us_by_kernel"]
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(1)
    mk = lambda shape: torch.randn(shape, generator=gen, device=dev)
    q, k, v, do = mk((b, h, s, d)), mk((b, kv, t, d)), mk((b, kv, t, d)), \
        mk((b, h, s, d))
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    return _here_chip_smoke().device_split(
        lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw))


def worker(root: Path, prefill: bool, paths: bool, only: str | None) -> dict:
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
    if only in ("rglru_bwd", "ssd_bwd"):
        return dict(out, **scan_bwd(cs, gen, dev, only))
    if only == "attn_bwd_bf16":
        for name, (b, h, kv, s, t, d, kw) in ATTN_BWD_BF16.items():
            r = cs.attn_bwd_case(name, b, h, kv, s, t, d, gen, dev,
                                 timed=True, strided=True, dtype="bfloat16",
                                 **dict(dict(calls=10), **kw))
            out[f"attn_bwd_bf16_{name}"] = dict(
                {k: r.get(k) for k in KEYS}, plan=r.get("plan"),
                kernels_us=r.get("device_us_by_kernel"))
        return out
    for name, (b, h, kv, s, t, d, kw) in ATTN_BWD.items():
        r = cs.attn_bwd_case(name, b, h, kv, s, t, d, gen, dev, timed=True,
                             **kw)
        out[f"attn_bwd_{name}"] = dict(
            {k: r.get(k) for k in KEYS}, plan=r.get("plan"),
            kernels_us=bwd_split(r, b, h, kv, s, t, d, kw, dev))
    if only == "attn_bwd":
        return out
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
    for name, (b, k, d, kw) in SELECT.items():
        r = cs.select_case(name, b, k, d, gen, dev, timed=True, **kw)
        out[f"select_{name}"] = dict(
            {k: v for k, v in r.items() if k.endswith(("_ms", "_err"))},
            plan=r.get("plan"))
    for fam in ("rglru_bwd", "ssd_bwd"):
        out.update(scan_bwd(cs, gen, dev, fam))
    if prefill:
        out.update(prefill_times(dev))
    if paths:
        for name, phase in (("sync", cs.phase_slice),
                            ("autopilot", cs.phase_autopilot),
                            ("mixed", cs.phase_mixed)):
            r = phase(dev, 0)
            run = r.get(name, r)         # the slice returns its two runs
            out[f"path_{name}"] = dict(
                ms=run["ms_per_tick"],
                device_busy_ms=r["profile"]["device_busy_ms_per_tick"],
                device_idle_share=r["profile"]["device_idle_share"])
    return out


def scan_bwd(cs, gen, dev, family: str) -> dict:
    """The timed ``rglru_bwd`` or ``ssd_bwd`` cases of checkout ``cs``
    (empty where its ``chip_smoke`` has no such family)."""
    out = {}
    if family == "rglru_bwd":
        for name, (b, s, d) in RGLRU_BWD.items():
            r = cs.rglru_bwd_case(name, b, s, d, gen, dev, timed=True)
            out[f"rglru_bwd_{name}"] = {k: r.get(k) for k in KEYS}
    elif hasattr(cs, "ssd_bwd_case"):
        for name, (b, s, h, p, n, c) in SSD_BWD.items():
            r = cs.ssd_bwd_case(name, b, s, h, p, n, c, gen, dev,
                                dtype="bfloat16", strided=True,
                                decay="model", timed=True)
            out[f"ssd_bwd_{name}"] = dict(
                {k: r.get(k) for k in KEYS},
                kernels_us=r.get("device_us_by_kernel"))
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
    ap.add_argument("--only", choices=ONLY)
    ap.add_argument("--worker", help="run one worker on this checkout")
    args = ap.parse_args()
    if args.worker:
        rec = dict(worker(Path(args.worker).resolve(), args.prefill,
                          args.paths, args.only), card=card())
        print(json.dumps(rec), flush=True)
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
                   ["--paths"] if args.paths else []) + (
                   ["--only", args.only] if args.only else [])
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1500, env=dict(os.environ,
                                                    PYTHONPATH=""))
        if run.returncode:
            print(run.stdout[-3000:], run.stderr[-6000:], file=sys.stderr)
            return 1
        rec = dict(json.loads(run.stdout.strip().splitlines()[-1]),
                   label=label)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    summary = {}
    keys = list(dict.fromkeys(k for r in records for k in r))
    for key in keys:
        first = next(r[key] for r in records if key in r)
        if isinstance(first, dict):
            for f in first:
                if not f.endswith("ms") or f.endswith("bound_ms"):
                    continue
                summary[f"{key}.{f}"] = {
                    lab: [r[key][f] for r in records
                          if r["label"] == lab and key in r]
                    for lab in ("other", "this")}
        elif key.endswith("_ms"):
            summary[key] = {lab: [r[key] for r in records
                                  if r["label"] == lab and key in r]
                            for lab in ("other", "this")}
    print(json.dumps({"summary": summary, "card": records[0]["card"]}),
          flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
