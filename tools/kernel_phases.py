#!/usr/bin/env python3
"""Phase times inside the mixed-mode SGLD kernel, from clock stamps.

    python3 tools/kernel_phases.py [--out FILE]

Builds a copy of ``src/repro_torch/kernels/csrc/sgld_potential.cu`` in
which thread 0 of every block of chain 0 records ``%clock64`` (its SM's
cycle counter) at the phase boundaries of ``mixed_kernel``, swaps that
library in for the wrapper, and runs the mixed forward and gradient at
``chip_smoke.py``'s ``main`` (C 8, m 64, K 16, d 768, half clicks) and
``bench`` (m 1024, K 1024) shapes. Prints, per shape and entry point, the
cycles from the kernel's start to each stamp for the first and the last
block of the cluster, the block's wall time from ``%globaltimer``, the
call's device time (``chip_smoke.device_ms``; the stamps' own cost is in
it) and the card's name, power limit and SM clock. The stamps (cycles
from stamp 0, the kernel's start):

    1   the rows' table entries read, theta in shared memory
    4k+4, 4k+5   group k scored (its barrier passed), and its rows added
                 (the first 4 groups)
    23, 24, 25   warp 0's row of the last group: loads and fma chain done,
                 xor trees done, scores and den done (gradient)
    20, 22, 21   the cluster reduction: entered, its first cluster barrier
                 passed, done

The stamps are put in by text anchors on the source: when the source
changes, the tool stops with the anchor it did not find. Needs one CUDA
card; the stamped library is built into ``build/kernel_phases``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

HEADER = '''#include "sm90.cuh"
__device__ long long g_stamps[8][32];
__device__ __forceinline__ void STAMP(int i) {
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
    g_stamps[sm90::cluster_rank()][i] = t;
  }
}
__device__ __forceinline__ void GSTAMP(int i) {
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[sm90::cluster_rank()][i] = t;
  }
}
'''

# (anchor, replacement): the anchor followed by its stamp
STAMPS = [
    ('#include "sm90.cuh"\n', HEADER),
    ("  const int i0 = rank * p.rpb, i_end = min(p.m, i0 + p.rpb);\n",
     "  const int i0 = rank * p.rpb, i_end = min(p.m, i0 + p.rpb);\n"
     "  GSTAMP(30);\n  STAMP(0);\n"),
    ("    sm90::cp_async_wait<0>();           // this thread's copies of theta\n"
     "    __syncthreads();\n",
     "    sm90::cp_async_wait<0>();           // this thread's copies of theta\n"
     "    __syncthreads();\n    STAMP(1);\n"),
    ("      // one barrier a group: the other buffer's rows were added before it\n"
     "      __syncthreads();\n",
     "      // one barrier a group: the other buffer's rows were added before it\n"
     "      __syncthreads();\n      if (k < 4) STAMP(4 + 4 * k);\n"),
    ("        part[0] = acc;\n      }\n    }\n",
     "        part[0] = acc;\n      }\n      if (k < 4) STAMP(5 + 4 * k);\n    }\n"),
    ("  reduce_cluster<GRAD>(p.g, p.out, p.d, part, c);\n}\n\n// cl blocks",
     "  STAMP(20);\n  reduce_cluster<GRAD>(p.g, p.out, p.d, part, c);\n"
     "  STAMP(21);\n  GSTAMP(31);\n}\n\n// cl blocks"),
    ("  n1 = xor_tree(n1);\n", "  STAMP(23);\n  n1 = xor_tree(n1);\n"),
    ("  const float den1 = sqrtf(fmaxf(e1, 1e-24f)), s1",
     "  STAMP(24);\n  const float den1 = sqrtf(fmaxf(e1, 1e-24f)), s1"),
    ("  float c1, c2 = 0.f;\n", "  STAMP(25);\n  float c1, c2 = 0.f;\n"),
    ("  sm90::cluster_sync();\n  const int L = GRAD ? d : 1;",
     "  sm90::cluster_sync();\n  STAMP(22);\n  const int L = GRAD ? d : 1;"),
    ('extern "C" int sgld_mixed_fwd_launch',
     'extern "C" int read_stamps(void* host) {\n'
     '  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n'
     '}\n\nextern "C" int clear_stamps() {\n'
     '  static const long long zero[8][32] = {};\n'
     '  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));\n'
     '}\n\nextern "C" int sgld_mixed_fwd_launch'),
]

SHAPES = {"main": (8, 64, 16, 768, 4096), "bench": (8, 1024, 1024, 768, 4096)}


def stamped_library(build):
    """Build the stamped copy of sgld_potential.cu and load it."""
    src = (build.CSRC / "sgld_potential.cu").read_text()
    for anchor, repl in STAMPS:
        if anchor not in src:
            raise SystemExit(f"kernel_phases: anchor not found: {anchor!r}")
        src = src.replace(anchor, repl, 1)
    out = ROOT / "build" / "kernel_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "stamped.cu").write_text(src)
    lib_path = out / "libstamped.so"
    run = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                          str(build.CSRC), "-o", str(lib_path),
                          str(out / "stamped.cu")],
                         capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(f"kernel_phases: nvcc failed:\n{run.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in build.SIGNATURES["sgld_potential"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.read_stamps.argtypes = [ctypes.c_void_p]
    lib.clear_stamps.argtypes = []
    return lib


def mixed_ops(c, m, k, d, n, dev):
    """``chip_smoke.mixed_case``'s operands ("half": duels and clicks)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, d), generator=gen, device=dev)
    a1 = torch.randint(0, k, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    a2 = (a1 + torch.randint(1, max(k, 2), (n,), generator=gen, device=dev,
                             dtype=torch.int32)) % k
    duel = torch.rand((n,), generator=gen, device=dev) < 0.5
    u = torch.rand((n,), generator=gen, device=dev) < 0.5
    y = torch.where(duel, torch.where(u, 1.0, -1.0), u.float())
    rows = torch.randint(0, n, (c, m), generator=gen, device=dev)
    valid = (torch.rand((c, m), generator=gen, device=dev) < 0.9).float()
    a_emb = torch.randn((k, d), generator=gen, device=dev)
    theta = torch.randn((c, d), generator=gen, device=dev)
    g = 4096.0 / valid.sum(-1).clamp_min(1.0)
    return (theta, x, a1, a2, y, duel.float(), rows, valid, a_emb), g


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the records here (JSON)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import sgld_update as su
    _build.build_all()
    lib = stamped_library(_build)
    _build._libs["sgld_potential"] = lib
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    records = []
    for name, (c, m, k, d, n) in SHAPES.items():
        ops, g = mixed_ops(c, m, k, d, n, dev)
        cl = su.mixed_plan(m, d)[0]
        for grad in (False, True):
            fn = ((lambda: su.mixed_potential_grad_rows(*ops, g, eta=8.0))
                  if grad else
                  (lambda: su.mixed_potential_rows(*ops, eta=8.0)))
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            if lib.clear_stamps():
                raise SystemExit("kernel_phases: clearing the stamps failed")
            fn()
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (8 * 32))()
            if lib.read_stamps(ctypes.cast(buf, ctypes.c_void_p)):
                raise SystemExit("kernel_phases: reading the stamps failed")
            rec = dict(shape=name, entry="grad" if grad else "fwd",
                       device_ms=cs.device_ms(fn), card=card)
            for rank in sorted({0, cl - 1}):
                st = buf[rank * 32:(rank + 1) * 32]
                rec[f"rank{rank}_cycles"] = {
                    i: st[i] - st[0] for i in range(1, 26) if st[i]}
                rec[f"rank{rank}_wall_ns"] = st[31] - st[30]
            records.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
