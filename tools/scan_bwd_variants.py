#!/usr/bin/env python3
"""Variant builds of the RG-LRU backward's Hopper kernel.

    python3 tools/scan_bwd_variants.py [--out FILE] [--rounds N]
                                       [--variants NAME ...]

Builds ``src/repro_torch/kernels/csrc/rglru_scan.cu`` as it stands
(``default``: 8 gate warps; the consumer warp reads a tile's dh and a into
registers, walks the carry, writes dx and dlog_a into the stage and stores
them by TMA) and once per variant of ``rglru_bwd_kernel_sm90``, each a copy
patched by text anchors (when the source changes, the tool stops with the
anchor it did not find): ``stores_batched``, the outputs stored row by row
after the walk, not by TMA; ``stores_in_line``, each step's stores inside
the walk; ``chain_in_line``, the consumer's first form, each step's reads
and stores inside the walk; ``gates4``, 4 gate warps, not 8;
``stages8``, a ring of 8 stages, not 4 (160 KB: one block an SM); and two
knock-outs that are timed but not checked (their gradients are wrong), to
find what paces a block: ``no_gate_math``, the gate warps' exponentials,
square root and division taken out, and ``no_stores``, the TMA stores of
dx and dlog_a taken out. One ``nvcc`` per variant, all started together,
into ``build/scan_bwd_variants/``. Then, ``--rounds`` times, each variant
in turn is loaded in place of the library ``rglru_scan_bwd`` launches,
checked against ``rglru_scan_bwd_plain`` (1e-5 of each gradient's largest
finite magnitude, the same non-finite values, and a bitwise repeat; not
the knock-outs) and timed at ``main`` (recurrentgemma-9b's training
shape: B 1, S 4096, D 4096) and ``bench`` (B 2): device us per call
(``chip_smoke.device_split``).

Prints one JSON line per record and a last line with the card's name and
power limit. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import variant_build

HERE = Path(__file__).resolve().parents[1]
SOURCE = "rglru_scan"

# the consumer's handling of a tile as it stands: its reads into registers,
# the walk, dx and dlog_a written into the stage and stored by TMA
CONSUMER = (
    "    float gv[kSteps], av[kSteps];\n"
    "#pragma unroll\n"
    "    for (int u = 0; u < kSteps; ++u) {\n"
    "      gv[u] = dhs[u * kCh + lane];\n"
    "      av[u] = as[u * kCh + lane];\n"
    "    }\n"
    "#pragma unroll\n"
    "    for (int u = kSteps - 1; u >= 0; --u) {\n"
    "      if (u < n_live) {\n"
    "        gv[u] += carry;           // g_t = dh_t + a_{t+1} g_{t+1}\n"
    "        carry = av[u] * gv[u];\n"
    "      }\n"
    "    }\n"
    "#pragma unroll\n"
    "    for (int u = 0; u < kSteps; ++u) {\n"
    "      const int e = u * kCh + lane;\n"
    "      sqs[e] = gv[u] * sqs[e];    // dx_t\n"
    "      fs[e] = gv[u] * fs[e];      // dlog_a_t\n"
    "    }\n"
    "    sm90::fence_proxy_async();   // the writes, before TMA reads them\n"
    "    __syncwarp();\n"
    "    if (lane == 0) {\n"
    "      sm90::tma_store_4d(&tdx, sqs, d0, t0, b, 0);\n"
    "      sm90::tma_store_4d(&tdla, fs, d0, t0, b, 0);\n"
    "      sm90::bulk_commit();\n"
    "      sm90::bulk_wait_read<1>();  // the previous tile's stores have read its stage\n"
    "      if (k > 0) sm90::mbar_arrive(&empty[(k - 1) % kBwdStages]);\n"
    "    }\n")
# the stores without TMA need the outputs' addresses: passed to the kernel
GLOBAL_OUT = [
    ("    const float* __restrict__ dh_last, float* __restrict__ dh0, int S, int D) {",
     "    const float* __restrict__ dh_last, float* __restrict__ dh0, int S, int D,\n"
     "    float* __restrict__ dlog_a, float* __restrict__ dx) {"),
    ("      (const float*)dh_last, (float*)dh0, S, D);",
     "      (const float*)dh_last, (float*)dh0, S, D, (float*)dlog_a, (float*)dx);")]
READS = (
    "    float gv[kSteps], av[kSteps];\n"
    "#pragma unroll\n"
    "    for (int u = 0; u < kSteps; ++u) {\n"
    "      gv[u] = dhs[u * kCh + lane];\n"
    "      av[u] = as[u * kCh + lane];\n"
    "    }\n")
RELEASE = ("    __syncwarp();\n"
           "    if (lane == 0) sm90::mbar_arrive(&empty[st]);\n")
STORE = ("          const size_t at = ((size_t)b * S + t0 + u) * D + d;\n"
         "          dx[at] = {g} * sqs[e];\n"
         "          dlog_a[at] = {g} * fs[e];\n")

# (anchor, replacement) pairs, applied in order, each anchor once
PATCHES = {
    "default": [],
    # the tile's reads first, then its dx and dlog_a stored row by row
    # after the walk (no TMA stores)
    "stores_batched": GLOBAL_OUT + [(
        CONSUMER,
        READS +
        "#pragma unroll\n"
        "    for (int u = kSteps - 1; u >= 0; --u) {\n"
        "      if (u < n_live) {\n"
        "        gv[u] += carry;\n"
        "        carry = av[u] * gv[u];\n"
        "      }\n"
        "    }\n"
        "    if (live) {\n"
        "#pragma unroll\n"
        "      for (int u = 0; u < kSteps; ++u) {\n"
        "        if (u < n_live) {\n"
        "          const int e = u * kCh + lane;\n"
        + STORE.format(g="gv[u]") +
        "        }\n"
        "      }\n"
        "    }\n" + RELEASE)],
    # the tile's reads first, each step's stores inside the walk
    "stores_in_line": GLOBAL_OUT + [(
        CONSUMER,
        READS +
        "#pragma unroll\n"
        "    for (int u = kSteps - 1; u >= 0; --u) {\n"
        "      if (u < n_live) {\n"
        "        const float g = gv[u] + carry;\n"
        "        carry = av[u] * g;\n"
        "        if (live) {\n"
        "          const int e = u * kCh + lane;\n"
        + STORE.format(g="g") +
        "        }\n"
        "      }\n"
        "    }\n" + RELEASE)],
    # the consumer's first form: each step's reads and stores inside the walk
    "chain_in_line": GLOBAL_OUT + [(
        CONSUMER,
        "#pragma unroll\n"
        "    for (int u = kSteps - 1; u >= 0; --u) {\n"
        "      if (u < n_live) {\n"
        "        const int e = u * kCh + lane;\n"
        "        const float g = dhs[e] + carry;\n"
        "        if (live) {\n"
        + STORE.format(g="g") +
        "        }\n"
        "        carry = as[e] * g;\n"
        "      }\n"
        "    }\n" + RELEASE)],
    "gates4": [("constexpr int kBwdGateWarps = 8;",
                "constexpr int kBwdGateWarps = 4;")],
    "stages8": [("constexpr int kBwdStages = 4;",
                 "constexpr int kBwdStages = 8;")],
    # knock-outs (KNOCKOUTS), timed only
    "no_gate_math": [(
        "        const float a = expf(l);\n"
        "        const float ee = expf(2.f * l);\n"
        "        const float sq = sqrtf(fmaxf(1.f - ee, 0.f));\n"
        "        fs[e] = a * hp - ee * xv / sq;\n",
        "        const float a = l, ee = l, sq = xv;\n"
        "        fs[e] = a * hp - ee;\n")],
    "no_stores": [(
        "      sm90::tma_store_4d(&tdx, sqs, d0, t0, b, 0);\n"
        "      sm90::tma_store_4d(&tdla, fs, d0, t0, b, 0);\n", "")],
}

KNOCKOUTS = ("no_gate_math", "no_stores")
SHAPES = {"main": (1, 4096, 4096), "bench": (2, 4096, 4096)}


def timed(dev, dims, check=True) -> dict:
    """One shape: (``check``) its largest error against the plain version
    in units of each gradient's max |g|, with a bitwise repeat; device us
    per call."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import rglru_scan as rg
    b, s, d = dims
    gen = torch.Generator(device=dev).manual_seed(s + d)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    log_a, x = -0.1 * rn(b, s, d).abs(), rn(b, s, d)
    with torch.no_grad():
        h, _ = rg.rglru_scan(log_a, x)
    args = (log_a, x, None, h, rn(b, s, d), rn(b, d))
    cs.check(rg.uses_tma(log_a, x, h, args[4]), f"{dims}: not the TMA rule")
    run = lambda: rg.rglru_scan_bwd(*args)
    out = {}
    if check:
        # a log_a within an ulp of 0 makes sqrt(1 - e) 0: +-inf / NaN there
        # on both sides, as at the clamp
        got = run()
        want = rg.rglru_scan_bwd_plain(*args)
        errs = []
        for g, w in zip(got[:2], want[:2]):
            fin = torch.isfinite(w)
            cs.check(torch.equal(torch.isfinite(g), fin),
                     f"{dims}: the non-finite values differ")
            errs.append(float((g[fin] - w[fin]).abs().max()
                              / w[fin].abs().max()))
        out["rel_err"] = max(errs)
        cs.check(out["rel_err"] <= 1e-5,
                 f"{dims}: off by {out['rel_err']} of max |g|")
        cs.check(all(torch.equal(torch.nan_to_num(u), torch.nan_to_num(v))
                     for u, v in zip(got[:2], run()[:2])),
                 f"{dims}: a repeated call differs")
        del want, got
    split = cs.device_split(run, calls=20)
    cs.check(split is not None, f"{dims}: no device activity profiled")
    return dict(out, device_us=sum(split.values()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records here (JSON)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", nargs="*", choices=sorted(PATCHES),
                    default=list(PATCHES))
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(HERE / "src")]
    import torch
    if not torch.cuda.is_available():
        print("scan_bwd_variants: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build_all()
    dev = torch.device("cuda")
    libs = variant_build.build("scan_bwd_variants", SOURCE, PATCHES,
                               args.variants)
    records = []
    for rnd in range(args.rounds):
        for name, path in libs.items():
            variant_build.install(SOURCE, path)
            rec = dict(round=rnd, variant=name)
            for shape, dims in SHAPES.items():
                rec[shape] = timed(dev, dims, name not in KNOCKOUTS)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(records=records,
                                                  card=card), indent=1))
    print(json.dumps({"card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
