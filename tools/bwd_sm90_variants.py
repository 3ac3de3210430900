#!/usr/bin/env python3
"""Variant builds of the bf16 attention backward's Hopper design.

    python3 tools/bwd_sm90_variants.py [--out FILE] [--rounds N]
                                       [--variants NAME ...]

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu`` as it
stands (``default``) and once per variant, each a copy patched by text
anchors (when the source changes, the tool stops with the anchor it did
not find): ``libm_exp2``, P by ``exp2f``, not ``ex2.approx.ftz.f32``
alone; and two knock-outs that are timed but not checked (their gradients
are wrong), to split the time between the arithmetic and the products:
``no_exp``, P without its exponential, and ``no_math``, P and dS taken
from S and dP with no arithmetic but the masks. One ``nvcc`` per variant,
all started together, into ``build/bwd_sm90_variants/``. Then,
``--rounds`` times, each variant in turn is loaded in place of the
library ``flash_attention_bwd`` launches for bf16 at head dims 64 and
128, checked against ``flash_attention_bwd_plain`` (2e-2 of each
gradient's max |g|, and a bitwise repeat; not the knock-outs) and timed
at ``main`` (granite-3-2b's heads: B 2, H 32,
KV 8, S = T 4096, D 64, causal), ``seamless_enc`` (B 2, H = KV 16, S = T
1024, D 64, bidirectional), ``seamless_cross`` (S 4096 over T 1024) and
``qwen2`` (B 2, H 28, KV 4, S = T 4096, D 128, causal), all as
``transpose(1, 2)`` views of (B, S, H, D): device us per call by kernel
name (``chip_smoke.device_split``).

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
SOURCE = "flash_attention_bwd_sm90"

# (anchor, replacement) pairs, applied in order, each anchor once
PATCHES = {
    "default": [],
    "libm_exp2": [(
        "const float pe = live ? ex2(y - lse2) : 0.f;",
        "const float pe = live ? exp2f(y - lse2) : 0.f;")],
    # knock-outs (KNOCKOUTS), timed only: P without the exponential; P and
    # dS without any arithmetic (the products alone)
    "no_exp": [(
        "const float pe = live ? ex2(y - lse2) : 0.f;",
        "const float pe = live ? y - lse2 : 0.f;")],
    "no_math": [(
        "    s[e] = prob<kCap>(s[e], lse2[r], live, p, &pr);",
        "    s[e] = live ? s[e] : 0.f;"), (
        "      s[e + c] = prob<kCap>(s[e + c], c ? l2.y : l2.x, live, p, &pr[c]);",
        "      s[e + c] = pr[c] = live ? s[e + c] : 0.f;")],
}

KNOCKOUTS = ("no_exp", "no_math")

SHAPES = {
    # b, h, kv, s, t, d, keyword arguments
    "main": ((2, 32, 8, 4096, 4096, 64), dict(causal=True)),
    "seamless_enc": ((2, 16, 16, 1024, 1024, 64), dict(causal=False)),
    "seamless_cross": ((2, 16, 16, 4096, 1024, 64), dict(causal=False)),
    "qwen2": ((2, 28, 4, 4096, 4096, 128), dict(causal=True)),
}


def timed(dev, dims, kw, check=True) -> dict:
    """One shape: (``check``) its largest error against the plain version
    in units of each gradient's max |g|, with a bitwise repeat; device us
    per call by kernel name and in all."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    b, h, kv, s, t, d = dims
    gen = torch.Generator(device=dev).manual_seed(s + d)
    mk = lambda shape: torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    q, k, v, do = (mk((b, s, h, d)), mk((b, t, kv, d)), mk((b, t, kv, d)),
                   mk((b, s, h, d)))
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    plan = fa.bwd_plan(b, h, kv, s, t, d, kw["causal"], 0, q.dtype)
    cs.check(plan.cfg == fa.BWD_SM90, f"{dims}: plan {plan}")
    run = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    out = {}
    if check:
        got = run()
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        out["rel_err"] = max(float((g.float() - w.float()).abs().max()
                                   / w.float().abs().max())
                             for g, w in zip(got, want))
        cs.check(out["rel_err"] <= 2e-2,
                 f"{dims}: off by {out['rel_err']} of max |g|")
        cs.check(all(torch.equal(x, y) for x, y in zip(got, run())),
                 f"{dims}: a repeated call differs")
        del want, got
    split = cs.device_split(run, calls=10)
    cs.check(split is not None, f"{dims}: no device activity profiled")
    return dict(out, device_us=sum(split.values()), by_kernel=split)


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
        print("bwd_sm90_variants: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build_all()
    dev = torch.device("cuda")
    libs = variant_build.build("bwd_sm90_variants", SOURCE, PATCHES,
                               args.variants)
    records = []
    for rnd in range(args.rounds):
        for name, path in libs.items():
            variant_build.install(SOURCE, path)
            rec = dict(round=rnd, variant=name)
            for shape, (dims, kw) in SHAPES.items():
                rec[shape] = timed(dev, dims, kw, name not in KNOCKOUTS)
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
