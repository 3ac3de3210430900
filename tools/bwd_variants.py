#!/usr/bin/env python3
"""Knock-out builds and plan sweeps of the attention backward kernel.

    python3 tools/bwd_variants.py [--out FILE] [--rounds N]
                                  [--variants NAME ...] [--sweep]

Variants: builds ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``
as it stands (``default``) and once per knock-out, each a copy patched by
text anchors (when the source changes, the tool stops with the anchor it
did not find): ``split_scores``, the two warpgroups split the s and dO.v
products between them (a barrier between P and dS); ``unroll_d2``, the s
and dO.v loops over D unrolled 2, not 4; ``large_double_buffer``, Large's
dK/dV blocks double-buffer Q and dO; ``dq_natural_order``, Large's causal
dQ row tiles in natural order, not longest first. One ``nvcc`` per
variant, all started together, into ``build/bwd_variants/``. Then,
``--rounds`` times, each variant in turn is loaded in place of the library
``flash_attention_bwd`` launches, checked against
``flash_attention_bwd_plain`` (1e-4 of each gradient's max |g|, and a
bitwise repeat) and timed at ``main`` (B 64, H = KV 4, S = T 64, D 64,
bidirectional: Small), ``main_large`` (the same forced to Large),
``bench`` (B 1, H 28, KV 4, S = T 2048, D 128, causal: Large),
``bench_uncut`` (``bench`` with no key tile's walk cut into parts: the
balance knocked out, by the plan) and ``e5b`` (B 64, H = KV 4, S = T 32,
D 32: Small): device us per call by kernel name
(``chip_smoke.device_split``).

``--sweep`` times the built library instead, each configuration forced
through ``bwd_plan``: Small against Large at short rows (S = T 32 and 64,
bidirectional, D 32, 64 and 128, one kv head, B 1 to 256, group 1 to 16),
which sets Small's bounds, and Large's part length (``steps_per_part`` 4
to 256 and uncut, against the plan's own) at long causal and windowed
rows, which sets ``BWD_PART_STEPS``.

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

# (anchor, replacement) pairs, applied in order, each anchor once
PATCHES = {
    "default": [],
    "split_scores": [(
        "  using T = Tile<BQ, KP, 1, kWarps>;\n"
        "  float s[T::TM][T::TN];\n"
        "  dots<T, DP>(Qs, Ks, s);\n"
        "  probs<T, KP, WANT_P, DEAD_P>(s, Ls, Ps, Ds, i0, j0, a);\n"
        "  dots<T, DP>(Gs, Vs, s);\n"
        "  dscores<T, KP>(s, Es, Ds);  // the thread's own P dcap\n",
        "  using T = Tile<BQ, KP, 1, kWarps / 2>;\n"
        "  float s[T::TM][T::TN];\n"
        "  const bool second = threadIdx.x >= kBlock / 2;\n"
        "  dots<T, DP>(second ? Gs : Qs, second ? Vs : Ks, s);\n"
        "  if (!second) probs<T, KP, WANT_P, DEAD_P>(s, Ls, Ps, Ds, i0, j0, a);\n"
        "  __syncthreads();  // P dcap is there\n"
        "  if (second) dscores<T, KP>(s, Es, Ds);\n")],
    "unroll_d2": [(
        "#pragma unroll 4\n  for (int d = 0; d < DP / 4; ++d) {\n",
        "#pragma unroll 2\n  for (int d = 0; d < DP / 4; ++d) {\n")],
    "large_double_buffer": [
        ("template <int DP, int KP, int BQ>\nstruct KvPlan {\n"
         "  static constexpr size_t kSmemFloats = 4 * size_t(KP) * DP +\n"
         "                                        2 * size_t(BQ) * (KP + 4)"
         " + 2 * BQ;\n",
         "template <int DP, int KP, int BQ, bool FUSED = true>\n"
         "struct KvPlan {\n"
         "  static constexpr size_t kSmemFloats =\n"
         "      (FUSED ? 4 : 6) * size_t(KP) * DP + 2 * size_t(BQ) * (KP + 4)"
         " + (FUSED ? 2 : 4) * BQ;\n"),
        ("__launch_bounds__(kBlock, (KvPlan<DP, KP, BQ>::kMinBlocks))",
         "__launch_bounds__(kBlock, (KvPlan<DP, KP, BQ, FUSED>::kMinBlocks))"),
        ("  constexpr size_t smem = KvPlan<DP, KP, KP>::kSmemBytes;",
         "  constexpr size_t smem = KvPlan<DP, KP, KP, FUSED>::kSmemBytes;"),
        ("  float* Dead = Ps;             // [DP] after the walk: dead rows' dO / T\n",
         "  float* Dead = Ps;             // [DP] after the walk: dead rows' dO / T\n"
         "  float* Q1 = Es + BQ;          // Large's second stage: Q, dO, lse, Delta\n"
         "  float* G1 = Q1 + BQ * DP;\n"
         "  float* L1 = G1 + BQ * DP;\n"
         "  float* E1 = L1 + BQ;\n"),
        ("  auto issue = [&](int step) {\n"
         "    const int h = head_of(step), i0 = row_of(step);\n"
         "    const long long bh = (long long)b * a.H + h;\n"
         "    stage_rows<DP, kBlock>(Qs, ",
         "  auto issue = [&](int step, int stage = 0) {\n"
         "    const int h = head_of(step), i0 = row_of(step);\n"
         "    const long long bh = (long long)b * a.H + h;\n"
         "    stage_rows<DP, kBlock>(stage ? Q1 : Qs, "),
        ("    stage_rows<DP, kBlock>(Gs, a.g + b * a.st.g[0] + h * a.st.g[1],\n"
         "                           a.st.g[2], i0, BQ, a.S, a.dim, a.vec);\n"
         "    load_col<kBlock>(Ls, a.lse + bh * a.S, i0, BQ, a.S);\n"
         "    if (!FUSED) load_col<kBlock>(Es, a.delta + bh * a.S, i0, BQ, a.S);\n",
         "    stage_rows<DP, kBlock>(stage ? G1 : Gs, a.g + b * a.st.g[0] + h * a.st.g[1],\n"
         "                           a.st.g[2], i0, BQ, a.S, a.dim, a.vec);\n"
         "    load_col<kBlock>(stage ? L1 : Ls, a.lse + bh * a.S, i0, BQ, a.S);\n"
         "    if (!FUSED)\n"
         "      load_col<kBlock>(stage ? E1 : Es, a.delta + bh * a.S, i0, BQ, a.S);\n"),
        ("  for (int s = s_lo; s < s_hi; ++s) {\n"
         "    const int h = head_of(s), i0 = row_of(s);\n"
         "    issue(s);\n",
         "  if (!FUSED && s_lo < s_hi) issue(s_lo, 0);\n"
         "  for (int s = s_lo; s < s_hi; ++s) {\n"
         "    const int h = head_of(s), i0 = row_of(s);\n"
         "    const int stage = FUSED ? 0 : (s - s_lo) & 1;\n"
         "    const bool ahead = !FUSED && s + 1 < s_hi;\n"
         "    if (FUSED) issue(s);\n"
         "    if (ahead) issue(s + 1, stage ^ 1);  // read by step s - 1\n"),
        ("    copy_wait<0>();\n"
         "    __syncthreads();  // the step's tiles (and K, V) landed; Delta written\n"
         "    scores<DP, KP, BQ, true, FUSED>(Qs, Gs, Ks, Vs, Ls, Es, Ps, Ds, i0, j0, a);\n"
         "    accumulate_kv<DP, KP, BQ>(Qs, Gs, Ps, Ds, acc);\n",
         "    if (ahead) copy_wait<1>(); else copy_wait<0>();\n"
         "    __syncthreads();  // the step's tiles (and K, V) landed; Delta written\n"
         "    const float* Qst = stage ? Q1 : Qs;\n"
         "    const float* Gst = stage ? G1 : Gs;\n"
         "    scores<DP, KP, BQ, true, FUSED>(Qst, Gst, Ks, Vs, stage ? L1 : Ls,\n"
         "                                    stage ? E1 : Es, Ps, Ds, i0, j0, a);\n"
         "    accumulate_kv<DP, KP, BQ>(Qst, Gst, Ps, Ds, acc);\n"),
    ],
    "dq_natural_order": [(
        "  if (a.causal) qt = nq - 1 - qt;  // longest first\n", "")],
}
# name: (b, h, kv, s, t, d), mask, forced configuration, whole walks (no
# key tile's dK/dV walk cut into parts: the balance knocked out)
SHAPES = {"main": ((64, 4, 4, 64, 64, 64), dict(causal=False), None, False),
          "main_large": ((64, 4, 4, 64, 64, 64), dict(causal=False), 1,
                         False),
          "bench": ((1, 28, 4, 2048, 2048, 128), dict(causal=True), None,
                    False),
          "bench_uncut": ((1, 28, 4, 2048, 2048, 128), dict(causal=True),
                          1, True),
          "e5b": ((64, 4, 4, 32, 32, 32), dict(causal=False), None, False)}
UNCUT = 1 << 30         # a part length no walk reaches
# Large's part length at long rows: (b, h, kv, s, t, d), mask
LONG = {"bench": ((1, 28, 4, 2048, 2048, 128), dict(causal=True)),
        "bench_s1024": ((1, 28, 4, 1024, 1024, 128), dict(causal=True)),
        "bench_s4096": ((1, 28, 4, 4096, 4096, 128), dict(causal=True)),
        "b4_s512": ((4, 28, 4, 512, 512, 128), dict(causal=True)),
        "d64_gqa": ((1, 32, 8, 2048, 2048, 64), dict(causal=True)),
        "rg_window": ((1, 16, 1, 4096, 4096, 256),
                      dict(causal=True, window=2048))}
PART_STEPS = (4, 8, 16, 32, 64, 128, 256, UNCUT)


def timed(dev, dims, kw, cfg=None, steps_per_part=None, check=True) -> dict:
    """One shape under the plan, or the configuration and part length
    forced: its plan, device us per call by kernel name and in all, and
    (``check``) its largest error against the plain version in units of
    each gradient's max |g|, with a bitwise repeat."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    b, h, kv, s, t, d = dims
    gen = torch.Generator(device=dev).manual_seed(s + d)
    mk = lambda shape: torch.randn(shape, generator=gen, device=dev)
    q, k, v, do = (mk((b, h, s, d)), mk((b, kv, t, d)),
                   mk((b, kv, t, d)), mk((b, h, s, d)))
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    plan = fa.bwd_plan
    fa.bwd_plan = lambda *args: plan(*args, cfg=cfg,
                                     steps_per_part=steps_per_part)
    try:
        run = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        got = run()
        out = dict(plan=fa.bwd_plan(b, h, kv, s, t, d, kw.get("causal", True),
                                    kw.get("window", 0))._asdict())
        if check:
            want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
            err = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))
            cs.check(err <= 1e-4, f"{dims}: off by {err} of max |g|")
            cs.check(all(torch.equal(x, y) for x, y in zip(got, run())),
                     f"{dims}: a repeated call differs")
            out["rel_err"] = err
        split = cs.device_split(run)
        cs.check(split is not None, f"{dims}: no device activity profiled")
    finally:
        fa.bwd_plan = plan
    return dict(out, device_us=sum(split.values()), by_kernel=split)


def variants(dev, names, rounds) -> list[dict]:
    libs = variant_build.build("bwd_variants", "flash_attention_bwd", PATCHES,
                               names)
    records = []
    for rnd in range(rounds):
        for name, path in libs.items():
            variant_build.install("flash_attention_bwd", path)
            rec = dict(round=rnd, variant=name)
            for shape, (dims, kw, cfg, whole) in SHAPES.items():
                rec[shape] = timed(dev, dims, kw, cfg,
                                   UNCUT if whole else None)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    return records


def sweep(dev) -> list[dict]:
    """Small against Large at short rows, then Large's part length at long
    rows; the built library."""
    records = []
    for d in (32, 64, 128):
        for st in (32, 64):
            for b in (1, 2, 4, 8, 16, 32, 64, 128, 256):
                for group in (1, 2, 4, 8, 16):
                    dims = (b, group, 1, st, st, d)
                    kw = dict(causal=False)
                    rec = dict(sweep="small_large", dims=dims, **{
                        f"cfg{cfg}_us": timed(dev, dims, kw, cfg,
                                              check=False)["device_us"]
                        for cfg in (0, 1)})
                    records.append(rec)
                    print(json.dumps(rec), flush=True)
    for name, (dims, kw) in LONG.items():
        rec = dict(sweep="part_steps", shape=name, dims=dims, kw=kw)
        plan = timed(dev, dims, kw, check=False)
        rec["plan"], rec["plan_us"] = plan["plan"], plan["device_us"]
        for n in PART_STEPS:
            r = timed(dev, dims, kw, 1, n, check=False)
            rec[f"steps{n}_us"] = r["device_us"]
            rec[f"steps{n}_parts"] = r["plan"]["parts"]
        records.append(rec)
        print(json.dumps(rec), flush=True)
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records here (JSON)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", nargs="*", choices=sorted(PATCHES),
                    default=list(PATCHES))
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(HERE / "src")]
    import torch
    if not torch.cuda.is_available():
        print("bwd_variants: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    records = []
    if args.sweep:
        records += sweep(dev)
    if args.variants:
        records += variants(dev, args.variants, args.rounds)
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
