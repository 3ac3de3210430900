#!/usr/bin/env python3
"""Variant builds of the SSD backward's Hopper kernels.

    python3 tools/ssd_bwd_variants.py [--out FILE] [--rounds N]
                                      [--variants NAME ...]

Builds ``src/repro_torch/kernels/csrc/ssd_scan_bwd_sm90.cu`` as it stands
(``default``) and once per variant, each a copy patched by text anchors
(when the source changes, the tool stops with the anchor it did not find):
``group8``, the source as it stands with 8 heads a chunk block, not 16
(``ssd_scan.SM90_BWD_GROUP``: 512 blocks each, partials twice the size);
and knock-outs that are timed but not checked (their gradients are wrong),
to find what paces each kernel: ``no_state_products``, the state walks'
wgmma taken out; ``no_piece_stores``, the walks' bulk stores of the
states' pieces and the backward walk's stores of dy's pieces taken out;
``no_hd``, the backward walk's <H, dH> taken out (its copy of the forward
walk's tile stays); ``one_pair``, the two products with
two fp32 operands (dy H, M^T dy) on their hi hi pair alone, not six;
``no_intra``, dC += dCB B and dB += dCB^T C taken out; ``no_piece_loads``,
the chunk kernels' bulk copies of the pieces taken out (their barriers
still complete; the walks keep theirs). One ``nvcc`` per variant, all started together, into
``build/ssd_bwd_variants/``. Then, ``--rounds`` times, each variant in turn
is loaded in place of the library ``ssd_scan_bwd`` launches at bf16 P 64,
N 128, chunk 128, checked against ``ssd_scan_bwd_plain`` at ``main``
(1e-4 of each fp32 gradient's max, 1e-2 of the bf16 ones', and a bitwise
repeat; not the knock-outs) and timed at ``main`` (mamba2-1.3b's training
shape: B 2, S 4096, H 64, bf16 column slices, the model's decays) and
``bench`` (B 1, S 32768): device us per call by kernel
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
SOURCE = "ssd_scan_bwd_sm90"

# (anchor, replacement) pairs, applied in order, each anchor once
PATCHES = {
    "default": [],
    "group8": [],
    # knock-outs (KNOCKOUTS), timed only
    "no_state_products": [(
        "          sm90::wgmma_rs<1>(acc, a[kk], dpc + ((k * kSlab + kk * 16 * "
        "kRow) >> 4), 1);\n", "")],
    "no_piece_stores": [
        ("        bulk_store(g.out_pieces + tile * kPieces, stage, kPieces);\n",
         ""),
        ("          for (int k = 0; k < 3; ++k) *reinterpret_cast<uint4*>(dyo "
         "+ k * kSlab) = pk[k];\n", "")],
    "no_hd": [(
        "        for (int e4 = 0; e4 < 4; ++e4) {\n"
        "          const int e = tid + kConsumers * e4;\n",
        "        for (int e4 = 0; e4 < 0; ++e4) {\n"
        "          const int e = tid + kConsumers * e4;\n")],
    "one_pair": [
        ("          for (int pr = 0; pr < 6; ++pr)\n"
         "            sm90::wgmma_ss<0>(acc, kdesc(sdy",
         "          for (int pr = 0; pr < 1; ++pr)\n"
         "            sm90::wgmma_ss<0>(acc, kdesc(sdy"),
        ("            for (int pr = 0; pr < 6; ++pr)\n"
         "              sm90::wgmma_rs<1>(\n",
         "            for (int pr = 0; pr < 1; ++pr)\n"
         "              sm90::wgmma_rs<1>(\n")],
    "no_intra": [
        ("              sm90::wgmma_rs<1>(dc, a[kq][pc],\n",
         "              if (false) sm90::wgmma_rs<1>(dc, a[kq][pc],\n"),
        ("              sm90::wgmma_rs<1>(db, a[kq][pc],\n",
         "              if (false) sm90::wgmma_rs<1>(db, a[kq][pc],\n")],
    "no_piece_loads": [
        ("        sm90::mbar_arrive_expect_tx(&full[st], kSlab + kPieces);\n",
         "        sm90::mbar_arrive_expect_tx(&full[st], kSlab);\n"),
        ("          sm90::bulk_load(d + kSlab + p * kSlab,",
         "          if (false) sm90::bulk_load(d + kSlab + p * kSlab,"),
        ("        sm90::mbar_arrive_expect_tx(hfull, kPieces);\n"
         "        for (int p = 0; p < 3; ++p)\n"
         "          sm90::bulk_load(s_h + p * kSlab,",
         "        sm90::mbar_arrive(hfull);\n"
         "        for (int p = 0; p < 3; ++p)\n"
         "          if (false) sm90::bulk_load(s_h + p * kSlab,"),
        ("        sm90::mbar_arrive_expect_tx(yfull, kPieces);\n",
         "        sm90::mbar_arrive(yfull);\n"),
        ("          sm90::bulk_load(s_dy + p * kSlab,",
         "          if (false) sm90::bulk_load(s_dy + p * kSlab,"),
        ("        sm90::mbar_arrive_expect_tx(dfull, kPieces);\n",
         "        sm90::mbar_arrive(dfull);\n"),
        ("          sm90::bulk_load(s_dh + p * kSlab,",
         "          if (false) sm90::bulk_load(s_dh + p * kSlab,")],
}

KNOCKOUTS = ("no_state_products", "no_piece_stores", "no_hd", "one_pair",
             "no_intra", "no_piece_loads")
# heads a chunk block, where a variant sets it
GROUPS = {"group8": 8}
SHAPES = {"main": (2, 4096, 64), "bench": (1, 32768, 64)}


def timed(dev, name, dims, check=True) -> dict:
    """One shape: (``check``) its largest error against the plain version
    in units of each gradient's max |g|, with a bitwise repeat; device us
    per call by kernel."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ssd_scan as ss
    b, s, h = dims
    gen = torch.Generator(device=dev).manual_seed(s + h)
    args = cs.ssd_bwd_inputs(b, s, h, 64, 128, gen, dev, dtype="bfloat16",
                             h0=False, strided=True, decay="model")
    run = lambda: ss.ssd_scan_bwd(*args, chunk=128)
    out = {}
    if check:
        got, again = run(), run()
        want = ss.ssd_scan_bwd_plain(*args, chunk=128)
        errs = []
        for g, g2, w in zip(got, again, want):
            if w is None:
                continue
            tol = (cs.SSD_BWD_BF16_TOL if g.dtype == torch.bfloat16
                   else cs.SSD_BWD_TOL)
            top = float(w.float().abs().max())
            errs.append(float((g.float() - w.float()).abs().max()) / top)
            cs.check(errs[-1] <= tol, f"{name} {dims}: off by {errs[-1]} "
                                      f"of max |g|")
            cs.check(torch.equal(g, g2), f"{name} {dims}: a repeated call "
                                         f"differs")
        out["rel_err"] = max(errs)
        del got, again, want
    split = cs.device_split(run, calls=5)
    cs.check(split is not None, f"{name} {dims}: no device activity "
                                f"profiled")
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
        print("ssd_bwd_variants: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ss
    _build.build_all()
    dev = torch.device("cuda")
    libs = variant_build.build("ssd_bwd_variants", SOURCE, PATCHES,
                               args.variants)
    group = ss.SM90_BWD_GROUP
    records = []
    for rnd in range(args.rounds):
        for name, path in libs.items():
            variant_build.install(SOURCE, path)
            ss.SM90_BWD_GROUP = GROUPS.get(name, group)
            rec = dict(round=rnd, variant=name, group=ss.SM90_BWD_GROUP)
            for shape, dims in SHAPES.items():
                rec[shape] = timed(dev, name, dims,
                                   name not in KNOCKOUTS and shape == "main")
            records.append(rec)
            print(json.dumps(rec), flush=True)
    ss.SM90_BWD_GROUP = group
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
