#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed N] [--out FILE]

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, in parallel), lints the port (phase ``lint``: ``python
-m repro_torch.analysis --json --fail-on-new`` over ``src/repro_torch`` on
this machine's Python, whose line counts the modules scanned, the new,
baselined and stale findings and the seconds; any new finding or stale
baseline entry fails the run) and runs three phases, printing one JSON
line per phase (phase 2 prints one per path; the wall time since start is
in each line's ``wall_s``). The streaming, refresh and mesh paths hold
their CUDA graph counts flat through the port's ``assert_flat``
(``repro_torch.analysis.retrace``):

1. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (K = 16 pool slots with 11 live RouterBench
   arms, d = 768, B = 256; SGLD m = 64 rows, C = 8 chains; the autopilot's
   posterior scores of 16 chains; the encoder's attention, B 256, 4 heads
   of 64, S = T = 64) and at the top row of the SGLD bench (K = 1024,
   m = 1024, C = 8; scores and selection B = 4096), plus edge cases (the
   selection, each case recording ``select_plan``'s configuration as
   ``plan``, also at a RouterService batch, B 4096 over the 16 slots
   (``serve``, timed), at K 1, K 32 and K 33 with d 98, K 1100, with row
   masks, a single survivor, an all-inactive row and duplicated arms, and
   the routing shape and its edges forced to the Large configuration, so
   both configurations run there; the
   SGLD potential also at K 1, K 33 and K 300 with duplicated arms tying
   across its 256-arm tiles, m no multiple of its rows per block; the
   scores at B 170 and 171 (K 1024, J 1), the two sides of
   ``score_plan``'s bound, and at d 100 and 98; the mixed SGLD kernels
   at m 1, 3 and 45, C 1 and d 98; every selection, SGLD, mixed and score
   case must repeat bitwise on repeated calls). Pairs must agree outside
   near-ties (top-two gap below 1e-5 * max|s|, counted but not
   failures); scores to 1e-5 of max|s|, with duplicated arms
   bitwise equal and dominance matrices equal outside near-tied arm pairs;
   potentials to rtol 1e-5 and gradients to rtol 1e-4 of the largest
   magnitude. The attn family holds ``flash_attention`` to rtol = atol =
   2e-5 (fp32, the SIMT kernel) and 2e-2 (bf16, the Hopper kernel) on the
   reference's five test shapes in both types, fp32 head dims 8, 16 and 24
   at the minilm encoder's shape (B 64, H 4, S = T = 32) and 24 and 30
   with ragged S/T (the kernel built for D 32, columns past D zero-filled),
   rows with no live key in
   both types (they must be the mean of v), bf16 ``transpose(1, 2)`` views
   of (B,S,H,D) tensors (with a window and soft cap at D 256), ragged S/T
   at D 256, D 32 with GQA, fp32 across the SIMT kernel's double-buffered
   kv tiles (ragged S/T at D 64, 128 and 256) and through its 4-byte copies
   (unaligned views), the encoder's heads, qwen2-7b's (H 28, KV 4,
   D 128, causal, S = T = 2048, fp32 and bf16) and gemma2-9b's (H 16,
   KV 8, D 256, soft cap 50, window 4096, S = T = 8192, bf16) and
   recurrentgemma-9b's at the lm path's prefill (B 2, H 16, KV 1, D 256,
   window 2048, S = T = 4096, bf16), and in bf16 as ``transpose(1, 2)``
   views, the lm path's MoE, vision and encoder-decoder heads:
   granite-moe-3b-a800m's (B 2, H 24, KV 8, D 64, causal, S = T = 4096),
   arctic-480b's and llava-next-34b's (H 56, KV 8, D 128, B 2 and 1),
   seamless-m4t-medium's encoder (B 2, H = KV 16, D 64, bidir, S = T =
   1024), decoder (causal, S = T = 4096) and cross attention (S 4096
   queries over T 1024 keys, no mask), and cross attention at ragged S
   333 and T 1000. The
   ssd family holds ``ssd_scan`` to rtol = atol = 2e-4 and the rglru
   family ``rglru_scan`` to 1e-5 (the reference's tolerances) on the
   reference's test shapes, ragged S,
   S < chunk, S = 1, h0, bf16 x/B/C and strided column slices (rglru:
   D 96, S 1 with h0, B 1 with S no multiple of the ring's 32-step tile,
   and D 98, which takes the first kernel; bf16 at
   P 64, N 128, chunk 128 on the Hopper kernels, other bf16 shapes and
   fp32 on the SIMT kernel; misaligned bf16 slices must raise), at the LM
   path's shapes (mamba2-1.3b: B 2, S 4096, H 64, P 64, N 128, chunk 128;
   recurrentgemma-9b: B 2, S 4096, D 4096) and at the prefill_32k length
   (B 1 and B 4, S 32768). Times are medians of CUDA-event-timed calls
   after a warm-up; the bound is the larger of the bytes over 3.35 TB/s
   and the operations over 67 TFLOP/s in fp32 or 989 TFLOP/s in bf16 (H100
   SXM data sheet; bf16 attention and SSD inputs take the bf16 rate, as
   their kernels run on the tensor cores); attention's library yardstick is
   ``scaled_dot_product_attention`` where it computes the same function
   (no soft cap; a window as a dense boolean mask). The attn_bwd family
   holds ``flash_attention_bwd`` (the fp32 backward kernels) to
   ``flash_attention_bwd_plain`` on the card from the kernel forward's o
   and lse, at rtol = atol = 1e-4 of each gradient's max |g|, repeated
   bitwise, each case recording ``bwd_plan``'s ``plan`` (0 Small, one
   launch; 1 Large): the training step's shape (B 64, H 4, S = T = 64,
   D 64, bidir: ``main``, Small) and the same forced to Large
   (``main_large``), qwen2-7b's heads (causal: ``bench``, Large), the e5b
   encoder (D 32) and the minilm encoder's D 24 at S = T = 32 (Small),
   Small with GQA, a window and a soft cap and with rows that have no
   live key, the last T Small takes (64) and the first past it (65,
   Large), causal + window + soft cap at D 256 with ragged S/T, GQA and
   rows with no live key, D 16 and 8, D 30, ragged GQA at D 128 and
   strided views; timed cases split the device time by kernel name; its
   bound counts 10 D operations per live pair, its library yardstick is
   SDPA's backward (``torch.autograd.grad`` over a kept graph). The
   attn_bwd_bf16 family holds the bf16 backward (at head dims 64, 128 and
   256 the Hopper design, ``csrc/flash_attention_bwd_sm90.cu``,
   configuration 2; at 32 the SIMT kernels built for bf16) and the bf16
   forward's lse (against the plain version's) within 2e-2 of each
   gradient's max |g| at the training paths' heads, timed (granite-3-2b
   ``main``: B 2, H 32, KV 8, S = T 4096, D 64, causal, and the same
   forced to Large, ``main_large``; gemma2-9b ``bench``: B 1, H 16, KV 8,
   S = T 8192, D 256, soft cap 50, window 4096; recurrentgemma-9b's local
   layer; seamless's encoder and cross attention), with rows that have no
   live key, ragged S/T, views, the Hopper design's tile edges and Small
   and Large forced (Large also at D 256 with rows that have no live key);
   its bound is at the bf16 rate, and the Hopper design's own 14 D
   operations a live pair (18 D at head dim 256) stand beside it
   (``design_ops_ms``). The
   rglru_bwd family holds ``rglru_scan``'s gradient (the backward kernel:
   the TMA ring read in reverse, ``rglru_bwd_kernel_sm90``, or the first
   design where TMA cannot load, D 98) to autograd of the plain recurrence
   at 1e-5 of each gradient's max (B 1 and 2, S 4096, D 4096, timed
   against the plain reverse loop; h0, D 98, S 1, a channel with log_a = 0
   and its non-finite values), each case's kernel checked by profiler
   name. The ssd_bwd family holds ``ssd_scan_bwd`` to
   ``ssd_scan_bwd_plain``: fp32 gradients within 1e-4 of each one's max
   |g|, bf16-rounded ones within 1e-2, all finite, repeated bitwise, each
   case's route by profiler name (bf16 at P 64, N 128, chunk 128: the six
   kernels of ``csrc/ssd_scan_bwd_sm90.cu``; fp32 and other shapes: the
   three of ``csrc/ssd_scan_bwd.cu``), on the reference's three test
   shapes, a ragged S with h0 (bf16 strided and fp32), 20 heads (a ragged
   head group), S < chunk at P 48, S 1, mamba2-1.3b's training shape
   (``main``: B 2, S 4096, bf16 column slices) and B 1 x S 32768
   (``bench``), the decays drawn as the model draws them (chunks past a
   mean |log_a| of 1, where the reference's gradient overflows);
   misaligned bf16 slices are refused; and a grad-requiring ``ssd_scan``
   input runs one forward and one backward launch with finite gradients
   equal to plain autograd's.
2. paths, at full width (B = 256, T = H = 4096: 16 ticks, 20 SGLD steps,
   8 chains, minibatch 64):
   - slice: ``env.run`` with the FGTS.CDB policy on a pooled ``ModelPool``
     (one retirement mid-run, the per-tick chain energy as ``aux_fn``),
     then a second run with ``delay=2`` and a per-request ``pref_fn``;
   - autopilot: ``env.run`` with ``autopilot.wrap`` over the pooled FGTS
     policy (the configuration of ``benchmarks/bench_autopilot.py``), a
     dominated overpriced arm and one arrival at tick 4;
   - mixed: ``mixed_feedback_policy`` for 16 ticks of act -> BTL feedback
     -> update -> ``inject_clicks`` on half of each batch, with the mixed
     energy trace;
   - train: ``EncoderConfig()`` (random weights from a seed) trained on
     the card as the paper benchmarks train it: ``pretrain_generic``, 150
     steps of 64 pairs, then ``finetune_categorical``, 4 x 40 steps on the
     RouterBench offline split; every step launches ``flash_attention``
     and ``flash_attention_bwd`` 8 times each (exact counts), and each
     backward call runs the kernels of its plan (by profiler name; one
     under Small); losses
     finite, the category silhouette of held-out queries must rise through
     fine-tuning; ms per step, and device ms and idle share from 2
     profiled steps;
   - ccft: query tokens -> the fine-tuned encoder -> the RouterBench model
     embeddings in all four weightings and
     the online env (4096 queries, d = 256 + 14) -> ``env.run`` over FGTS;
     then MixInstruct (1200 queries) -> eq. 6 embeddings -> ``env.run``.
     The encoder alone is timed per 256-query batch;
   - lm: mamba2-1.3b, recurrentgemma-9b, granite-moe-3b-a800m,
     seamless-m4t-medium and llava-next-34b at their full configs, and
     arctic-480b at one of its 35 units (bf16, random weights made on the
     card from the seed): B 2 prompts of S 4096 random tokens (seamless:
     with 1024 random frames for its encoder; llava: B 1, 2880 random
     patches before 1216 tokens) -> ``lm.prefill`` -> 8 greedy
     ``lm.decode_step``s. The launch counts must be exact per prefill
     (48 ``ssd_scan``; 26 ``rglru_scan`` and 12 ``flash_attention``; 32;
     1; 36: 12 encoder, 12 self, 12 cross; 60) and untouched by decode;
     granite-moe's every ``moe_ffn`` call of the warm-up prefill and
     decode step runs under ``set_sync_debug_mode("error")``; one more
     prefill and two more decode steps run under the profiler for the
     idle share, kernels per prefill or token and each kernel's share of
     the prefill; an MoE model's FFNs run once more on their prefill
     inputs under the profiler (GEMMs, sort, gathers and scatters), and
     each layer reports its tokens per expert (min, max) and the share of
     assignments dropped at capacity factor 1.25.
   - serve: ``RouterService``'s tick-batch path over the slice's world
     (11 live arms in 16 slots, d 768, B 256 per ``route_batch``, 8
     chains x 20 SGLD steps, minibatch 64, ring capacity 4096, expiry 8
     ticks, prefs cycling [0, 0.5, 2.0]) for 16 ticks: votes come back 2
     ticks late, shuffled, 13 of 256 duplicated and 13 never sent; at tick
     6 ``retire_model(BAD)`` and ``add_model`` of slot ARRIVAL with a
     ``warm_start_duels`` replay; at tick 8 ``save``, ``restore`` into a
     fresh service, which must route the next 2 ticks bitwise alike
     (pairs, tickets, folded counts). ``route_batch`` and
     ``feedback_batch`` run under ``set_sync_debug_mode("error")``; the
     launches are exact (``dueling_select`` once and the SGLD gradient 40
     times an act, the restored service's 2 acts included), so are the
     folded, expired and pending counts; ``embed`` of 256 queries equals
     ``encode`` over the fine-tuned encoder. Then 8 ticks under the
     autopilot (``dueling_score`` once an act). Host ms per ``route_batch``
     and ``feedback_batch``, ms per tick, routed queries per second, regret
     per tick, ``service_stats()``, and device ms per act by kernel family
     with the idle share from 2 profiled ticks.
   - stream: the same world with ``buckets=(32, 64, 128, 256)``: one CUDA
     graph per bucket and program (route, pref route, feedback, resolve),
     captured at construction. 4096 requests of ``poisson:12800`` then
     2048 of ``bursty:12800,24``, cut into batches with ``max_wait`` 10 ms,
     votes one batch late: every batch through ``route_stream`` /
     ``feedback_stream`` (under ``set_sync_debug_mode("error")``) and a
     tick-batch twin's ``route_batch`` / ``feedback_batch`` must agree
     bitwise (pairs, tickets, folded counts, posterior, ring); a retire +
     warm-started add at batch 12 on both; at batch 20 ``save`` and a
     restored streaming service that routes 2 batches bitwise alike; the
     graph counts flat throughout. Launches: ``torch.profiler``'s kernel
     names over a pass of every formed batch through ``route_stream`` /
     ``feedback_stream`` (a replay makes no Python call, so the wrappers
     do not count it): 40 ``sgld_potential_grad`` and 1 ``dueling_select``
     per route. Padding
     identity on the card: the same batches through ladders (128, 256)
     and (256,) for FGTS and eps-greedy; 8 batches under the autopilot
     (launches as above, plus 1 ``dueling_score`` per route). Then timed
     passes of the same batches through the graphs and through
     the twin alone (host ms per route by bucket, queries per second,
     p50 / p99 latency: event-time wait plus the measured route time),
     the host time of a replayed route without a sync and its split
     (staging, the draw plan's fill, the graph's launch), and 4 profiled
     full batches (device ms per act, idle share).
   - refresh: a streaming service over RouterBench in the encoder's
     geometry (11 models in 16 slots, d 256, the fine-tuned encoder) with
     ``RefreshConfig(every=2048)``: 4096 Poisson requests with their
     categories; at 2048 logged duels ``export_log`` -> ``refresh_table``
     on the card (2 x 20 steps of 64 pairs, exact attention launches) ->
     ``apply_table``, then streaming goes on with no graph captured anew;
     seconds per cycle. Card against CPU on the exported log:
     ``category_mix`` exactly, ``duel_scores`` to rtol 1e-6, one
     ``refresh_table`` of 1 epoch x 2 steps under ``HostDraws`` (lr 1e-3):
     the table to 1e-4 of its largest magnitude, the encoder's step to
     ``REFRESH_STEP_TOL`` of its own, against a control with uniform row
     weights that must land more than 10 x that limit away.
   - mesh: ``RouterService(mesh=...)`` on an NCCL world of one (the
     ``--mesh 1,1`` of the serving launcher): 16 ticks of B 256 over the
     serve world (prefs, late / shuffled / duplicated / lost votes,
     expiry) and a streaming run of 8 formed batches on buckets (32, 64,
     128, 256), each against an unsharded twin bitwise (pairs, tickets,
     folded counts, posterior, ring); launches per act (1
     ``dueling_select``, 40 ``sgld_potential`` gradients, also in a
     replayed route program); the collectives (``routing_rules.tally``)
     per ``route_batch``, ``feedback_batch``, ``route_stream`` and
     ``feedback_stream``, none called while the streaming programs are
     captured, with or without the autopilot (6 formed batches under it
     against an unsharded twin bitwise, the controller too); host ms per
     call for both services; the world destroyed. Before the world, the
     router dry-run (``launch/router_dryrun.py``): the per-rank reckoning
     of the 16 x 16 and 2 x 16 x 16 meshes on fake worlds, and one rank's
     share of each step timed on the card (device ms by kernel, each
     step's kernel required in its profile, launches, peak memory, the
     kernel beside its bound); phase 1 holds and times
     ``dueling_select``, the SGLD gradient and the fp32 attention at the
     dry-run's per-rank shapes (``DRYRUN_TIMED``).
   Each run resets the launch counts just before it and reads them just
   after: every kernel of its path must have launched (attention exactly
   once per layer per encode batch). Two more ticks of each loop (and two
   encode batches) run under ``torch.profiler`` (device activity only) for
   the device busy time per tick, its idle share against the unprofiled
   run's ms per tick and the kernels per tick.
   - lm_train: ``launch.steps.make_train_step`` (AdamW in place, each
     unit rematerialised) on the card at full width (``LM_TRAIN_RUNS``):
     granite-3-2b at full depth (B 2 x 4096), recurrentgemma-9b (1 unit
     and the remainder, B 1 x 4096), gemma2-9b (1 unit, B 1 x 8192),
     qwen2-7b (4 units), granite-moe-3b-a800m (full depth) and
     seamless-m4t-medium (full depth, 1024 frames) at B 2 x 4096, and
     llava-next-34b (1 unit, 2880 patches + 1216 tokens); a warm-up step,
     then 3 timed steps with exact launch counts per step
     (``LM_TRAIN_PATHS``), finite losses, peak memory, tokens/s, and one
     profiled step's device time by kernel group with the optimizer on its
     own; granite-3-2b's loss and gradients under the bf16 attention
     backward's Hopper design against the same step forced to Large (the
     SIMT kernels): equal losses, every leaf within 2e-2 of its max;
     mamba2-1.3b at full depth (B 2 x 4096) through the SSD backward,
     whose Hopper kernels its profile must show by name.
   - lm_dryrun: ``launch/dryrun.py``'s reckoning of one rank of 16 x 16
     at train_4k for granite-3-2b, seamless-m4t-medium, mamba2-1.3b and
     recurrentgemma-9b (a fake world, destroyed after), each share's
     kernel calls held to the wrappers' shape rules and the Hopper routes
     (``check_plan``), then each share on the card (no world): one unit of
     the rank program forward and backward at the local shapes (B 16,
     S 4096; granite: attention after the head_dim gather, H 32, KV 8,
     D 64; seamless: one head a rank, an encoder and a decoder unit;
     mamba2: the SSD scan whole; recurrentgemma: RG-LRU width 256 and the
     local attention after the gather, H 16, KV 1, D 256), collectives
     stood in for. Launches must equal the plan's, each kernel must show
     device time in a profile window of at least 50 ms of calls, the
     shards' bytes must equal the reckoning's (counted from the model's
     own unit under the whole model's specs), and the share's outputs and
     every gradient must lie within 2e-2 of the same share on the plain
     versions (same inputs, each tensor's largest magnitude; the plain
     attention a few batch rows at a time); device ms by kernel, peak
     memory, each kernel's bound and SDPA's forward and backward time.
3. card vs CPU: 4 ticks at full width on the card and on the CPU (plain
   versions) from one numpy-made draw set, for the FGTS slice, for the
   autopilot (a control tick every 2 acts) and for the ccft path (whose
   embeddings, from the same fine-tuned weights and tokens, must agree to
   atol 1e-5
   first); routed pairs equal outside near-ties, final chains to rtol
   1e-4, controller counters and flags equal, lambda and the cost EMA to
   rtol 1e-5; the service for 4 ticks from one host-mode ``KeyedDraws``
   (tickets equal, pairs equal outside near-ties, chains to rtol 1e-4);
   one ``train_step`` from the fine-tuned weights on one
   ``HostDraws`` pair batch: loss to rtol 1e-5, every gradient leaf to 1e-4
   of its max. Then each LM at full width in fp32 at a cut depth (mamba2
   2 layers, recurrentgemma 3, granite-moe 2, arctic 1 with 16 experts,
   seamless 2 + 2 over 256 frames, llava 1 with 64 patches), B 2 x S 500
   (the recurrent models) or 128 (B 1 for llava), prefill and 4 decode
   steps: logits within 1e-4 of max |logit|, greedy tokens equal outside
   near-ties, cache leaves within 1e-4 of their largest magnitude,
   ``slot_pos`` equal. Every MoE call is checked layer by layer from the
   CPU's input to it: experts and dropped assignments equal, sparse and
   dense outputs within 1e-4, on the tokens without a near-tied router
   decision. Then ``lm.loss_fn`` and its gradient (units rematerialised)
   at the same cut depths in fp32 (granite-3-2b at 2 units too), B 2 x
   32 tokens (llava: 64 patches + 32 tokens): the loss
   within 1e-5 relative, every gradient leaf within 1e-4 of its max.

Before the last line it prints the kernels line and the card's name and
power limit; the last line is the device record. Any failed check exits
non-zero; without a CUDA card the script fails.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM, fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM, bf16 tensor cores, dense
NEAR_TIE = 1e-5
# the kernels of the FGTS slice's path (the sync and delay2_pref runs)
SLICE_KERNELS = ("dueling_select", "sgld_potential_fwd", "sgld_potential_grad")


class CheckFailed(AssertionError):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


T_START = time.perf_counter()
# with --out: each phase's line is also appended here as it is printed
PHASE_LOG = None


def emit(obj):
    print(json.dumps(obj), flush=True)


def emit_phase(record):
    """A phase's line, with the script's wall time so far (also appended
    to ``PHASE_LOG``, so a run that fails later keeps its phases)."""
    record["wall_s"] = time.perf_counter() - T_START
    emit(record)
    if PHASE_LOG is not None:
        with open(PHASE_LOG, "a") as f:
            f.write(json.dumps(record) + "\n")


def phase_lint():
    """The port's repro-lint over ``src/repro_torch`` on this machine's
    Python (``python -m repro_torch.analysis --json --fail-on-new``, the
    gate ``tests/test_torch_analysis.py`` holds on the CPU): no new
    finding, no stale baseline entry."""
    root = Path(__file__).resolve().parent
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(root / "src") + (
        os.pathsep + path if path else ""))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json",
         "--fail-on-new"], cwd=root, env=env, capture_output=True,
        text=True, timeout=600)
    seconds = time.perf_counter() - t0
    check(run.stdout.strip().startswith("{"),
          f"lint: no report (exit {run.returncode}): {run.stderr[-2000:]}")
    out = json.loads(run.stdout)
    new, stale = out["new"], out["stale_baseline_entries"]
    check(run.returncode == 0 and not new,
          f"lint: exit {run.returncode}, {len(new)} new finding(s): "
          + "; ".join(f"{f['path']}:{f['line']}: [{f['rule']}] "
                      f"{f['symbol']}" for f in new[:20]))
    check(not stale, f"lint: stale baseline entries {stale}")
    return dict(modules=out["modules_scanned"], passes=out["passes"],
                new=len(new), baselined=len(out["suppressed"]),
                stale=len(stale), seconds=seconds)


def bound(nbytes, flops, flop_per_s=FP32_FLOP_PER_S):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flop_per_s
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def time_ms(fn, runs=5, calls=20, warmup=3):
    """Per-call time of ``fn``: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``runs`` such runs after a
    warm-up. Host overhead that outlasts the device work shows here."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def device_ms(fn, calls=20, attempts=3):
    """Device time per call of ``fn`` (all the kernels it launches) from
    ``torch.profiler``'s CUDA activity. A profile that records no device
    activity (seen once in a run of this script on an H100), or not its
    closing marker (``profiling.window_whole``), is taken again, up to
    ``attempts`` times; None when none records any."""
    import torch
    from repro_torch import profiling
    fn()
    torch.cuda.synchronize()
    ms = None
    for _ in range(attempts):
        with profiling.cuda_profile() as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(us for _, us, _ in profiling.kernel_events(prof))
        if total > 0:
            ms = total / calls / 1e3
            if profiling.window_whole(prof):
                break
    return ms


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def select_scores(x, a, th, tilt, mask):
    """The plain version's (2, B, K) scores after tilt and mask."""
    import torch
    from repro_torch.kernels import dueling_score as ds
    s = ds.dueling_score_plain(x, a, th)
    if tilt is not None:
        s = s - torch.atleast_2d(tilt)[None]
    if mask is not None:
        s = torch.where(torch.atleast_2d(mask)[None], s, -torch.inf)
    return s


def top2_gap(s):
    """Per row: top-1 minus top-2 (inf when fewer than two are finite)."""
    import torch
    if s.shape[-1] < 2:
        return torch.full(s.shape[:-1], torch.inf, device=s.device)
    v = torch.topk(s, 2, dim=-1).values
    gap = v[..., 0] - v[..., 1]
    return torch.where(torch.isfinite(v[..., 1]), gap, torch.inf)


def compare_pairs(x, a, th, tilt, mask, distinct, k_pair, p_pair):
    """(mismatches outside near-ties, near-tie mismatches, max abs score
    difference at the chosen arms)."""
    import torch
    s = select_scores(x, a, th, tilt, mask)
    scale = torch.nan_to_num(s.abs(), posinf=0.0, neginf=0.0).max()
    thr = NEAR_TIE * float(scale)
    (k1, k2), (p1, p2) = [(u.long(), v.long()) for u, v in (k_pair, p_pair)]
    s2 = s[1]
    if distinct:
        cols = torch.arange(a.shape[0], device=x.device)
        s2 = torch.where(cols[None] == p1[:, None], -torch.inf, s2)
    tie = (top2_gap(s[0]) <= thr) | (top2_gap(s2) <= thr)
    bad = (k1 != p1) | (k2 != p2)
    pick = lambda v, i: torch.gather(v, 1, i[:, None])[:, 0]
    err = torch.nan_to_num(torch.stack([
        (pick(s[0], k1) - pick(s[0], p1)).abs(),
        (pick(s[1], k2) - pick(s[1], p2)).abs()]), nan=0.0, posinf=0.0)
    return int((bad & ~tie).sum()), int((bad & tie).sum()), float(err.max())


def select_case(name, b, k, d, gen, dev, *, mask_kind=None, tilt_kind=None,
                distinct=True, live=None, dup=False, cfg=None, timed=False):
    """One selection case against the plain version, in the configuration
    ``select_plan`` picks or, with ``cfg``, the one it names (recorded as
    ``plan``). ``dup`` copies the first half of the arms into the second,
    so every row's maximum is an exact tie that must go to the first copy;
    every case must repeat bitwise. Timed cases add the bound: 6 d
    operations per live (row, arm) pair, and the bytes of x, of the live
    arms' rows of A, of theta, tilt, mask and the pairs."""
    import torch
    from repro_torch.kernels import dueling_score as ds
    plan = ds.select_plan
    if cfg is not None:
        ds.select_plan = lambda b_, k_, d_: plan(b_, k_, d_, cfg=cfg)
    try:
        return _select_case(name, b, k, d, gen, dev, mask_kind=mask_kind,
                            tilt_kind=tilt_kind, distinct=distinct,
                            live=live, dup=dup, timed=timed)
    finally:
        ds.select_plan = plan


def _select_case(name, b, k, d, gen, dev, *, mask_kind, tilt_kind, distinct,
                 live, dup, timed):
    import torch
    from repro_torch.kernels import dueling_score as ds
    x = torch.randn((b, d), generator=gen, device=dev)
    a = torch.randn((k, d), generator=gen, device=dev)
    if dup:
        a[k // 2:2 * (k // 2)] = a[:k // 2]
    th = torch.randn((2, d), generator=gen, device=dev)
    mask = None
    if mask_kind == "k":
        mask = torch.arange(k, device=dev) < (live or k)
    elif mask_kind == "bk":
        mask = torch.rand((b, k), generator=gen, device=dev) > 0.3
        mask[0] = False                               # all inactive
        mask[1] = False
        mask[1, k - 1] = True                         # single survivor
    tilt = None
    if tilt_kind == "k":
        tilt = 0.3 * torch.rand((k,), generator=gen, device=dev)
    elif tilt_kind == "bk":
        tilt = 0.3 * torch.rand((b, k), generator=gen, device=dev)
    kw = dict(tilt=tilt, mask=mask, distinct=distinct)
    kp = ds.dueling_select(x, a, th, **kw)
    torch.cuda.synchronize()
    pp = ds.dueling_select_plain(x, a, th, **kw)
    bad, ties, err = compare_pairs(x, a, th, tilt, mask, distinct, kp, pp)
    out = dict(case=name, B=b, K=k, d=d, plan=list(ds.select_plan(b, k, d)),
               mismatches=bad, near_ties=ties, max_abs_err=err)
    if mask_kind == "bk" and k > 1:
        check((kp[0][0].item(), kp[1][0].item()) == (0, 0),
              f"{name}: all-inactive row must route (0, 0)")
        check(kp[0][1].item() == kp[1][1].item() == k - 1,
              f"{name}: single survivor must duel itself")
    if dup:
        check(int(kp[0].max()) < k // 2 and int(kp[1].max()) < k // 2,
              f"{name}: a tie went to the second copy")
    check(bad == 0, f"{name}: {bad} pair mismatches outside near-ties")
    # one launch, every (b, k) summed in one fixed order: bitwise the same
    # from call to call
    check(all(all(torch.equal(u, v) for u, v in zip(
        ds.dueling_select(x, a, th, **kw), kp)) for _ in range(3)),
        f"{name}: repeated calls differ")
    if timed:
        live_mask = torch.ones((b, k), dtype=torch.bool, device=dev) \
            if mask is None else torch.broadcast_to(mask, (b, k))
        live_pairs = int(live_mask.sum())
        live_arms = int(live_mask.any(dim=0).sum())
        nbytes = 4 * (b * d + live_arms * d + 2 * d + 2 * b)
        nbytes += 0 if tilt is None else 4 * tilt.numel()
        nbytes += 0 if mask is None else mask.numel()
        kern = lambda: ds.dueling_select(x, a, th, **kw)
        plain = lambda: ds.dueling_select_plain(x, a, th, **kw)
        out["ms"], out["plain_ms"] = time_ms(kern), time_ms(plain)
        out["device_ms"], out["plain_device_ms"] = (device_ms(kern),
                                                    device_ms(plain))
        out["bound_ms"], out["bound_by"] = bound(nbytes,
                                                 6.0 * live_pairs * d)
    return out


def sgld_case(name, c, m, k, d, n, gen, dev, *, j=1, ties=False,
              timed=False):
    import torch
    from repro_torch.kernels import sgld_update as su
    x = torch.randn((n, d), generator=gen, device=dev)
    a1 = torch.randint(0, k, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    a2 = (a1 + torch.randint(1, max(k, 2), (n,), generator=gen, device=dev,
                             dtype=torch.int32)) % k
    y = torch.where(torch.rand((n,), generator=gen, device=dev) < 0.5, 1.0,
                    -1.0)
    grid = torch.tensor([0.0, 0.5, 2.0], device=dev)
    pref = grid[torch.randint(0, 3, (n,), generator=gen, device=dev)]
    a_emb = torch.randn((k, d), generator=gen, device=dev)
    if ties:
        a_emb[k // 2:2 * (k // 2)] = a_emb[:k // 2]
    mask = torch.arange(k, device=dev) < max(1, (11 * k) // 16)
    costs = torch.rand((k,), generator=gen, device=dev)
    rows = torch.randint(0, n, (c, m), generator=gen, device=dev)
    valid = (torch.rand((c, m), generator=gen, device=dev) < 0.9).float()
    theta = torch.randn((c, d), generator=gen, device=dev)
    g = 4096.0 / valid.sum(-1).clamp_min(1.0)
    ops = (theta, x, a1, a2, y, pref, rows, valid, a_emb, mask, costs)
    kw = dict(j=j, eta=8.0, mu=0.2)
    u_k = su.potential_rows(*ops, **kw)
    g_k = su.potential_grad_rows(*ops, g, **kw)
    torch.cuda.synchronize()
    u_p = su.potential_rows(*ops, **kw, plain=True)
    g_p = su.potential_grad_rows(*ops, g, **kw, plain=True)
    du = float((u_k - u_p).abs().max())
    dg = float((g_k - g_p).abs().max())
    su_ = float(u_p.abs().max())
    sg_ = float(g_p.abs().max())
    rel = lambda err, scale: err / scale if scale > 1e-6 else None
    out = dict(case=name, C=c, m=m, K=k, d=d, j=j,
               fwd_max_abs_err=du, fwd_max_rel_err=rel(du, su_),
               grad_max_abs_err=dg, grad_max_rel_err=rel(dg, sg_))
    check(bool(torch.isfinite(u_k).all() and torch.isfinite(g_k).all()),
          f"{name}: non-finite kernel output")
    check(du <= 1e-5 * su_ + 1e-6, f"{name}: potential off by {du}")
    check(dg <= 1e-4 * sg_ + 1e-5, f"{name}: gradient off by {dg}")
    # one cluster launch per call, summed in a fixed order: bitwise the
    # same from call to call
    check(all(torch.equal(su.potential_rows(*ops, **kw), u_k) and
              torch.equal(su.potential_grad_rows(*ops, g, **kw), g_k)
              for _ in range(3)), f"{name}: repeated calls differ")
    out["plan"] = su.fgts_plan(m, k, d)
    if timed:
        rows_bytes = c * m * (4 * d + 4 * 4 + 8 + 4)
        arm_bytes = 4 * k * d + 5 * k + 4 * c * d
        score_flops = 4.0 * c * m * k * d
        fns = dict(
            fwd=lambda: su.potential_rows(*ops, **kw),
            fwd_plain=lambda: su.potential_rows(*ops, **kw, plain=True),
            grad=lambda: su.potential_grad_rows(*ops, g, **kw),
            grad_plain=lambda: su.potential_grad_rows(*ops, g, **kw,
                                                      plain=True))
        for key, fn in fns.items():
            out[key + "_ms"] = time_ms(fn)
            out[key + "_device_ms"] = device_ms(fn)
        out["fwd_bound_ms"], out["fwd_bound_by"] = bound(
            rows_bytes + arm_bytes + 4 * c, score_flops)
        out["grad_bound_ms"], out["grad_bound_by"] = bound(
            rows_bytes + arm_bytes + 4 * c + 4 * c * d,
            score_flops + 7.0 * c * m * d)
    return out


def near_tie_pairs(s):
    """(K, K) bool: arm pairs whose scores (C, K) lie within NEAR_TIE *
    max|s| in some sample (the diagonal included)."""
    thr = NEAR_TIE * float(s.abs().max())
    return ((s[:, :, None] - s[:, None, :]).abs() <= thr).any(dim=0)


def score_case(name, b, k, d, j, gen, dev, *, posterior=False, live=None,
               dup=False, zeros=False, timed=False):
    """One ``dueling_score`` case against the plain version: scores to
    1e-5 of max|s|; ``dup`` copies arm 0 into the last slot (bitwise equal
    columns), ``zeros`` zeroes arm 1 and query row 0 (scores 0 through the
    1e-24 clamp). ``posterior`` drives ``posterior_scores`` (the all-ones
    query, b = 1) and holds the dominance matrices of the first ``live``
    arms equal outside near-tied pairs."""
    import torch
    from repro_torch.autopilot import dominance
    from repro_torch.kernels import dueling_score as ds
    a = torch.randn((k, d), generator=gen, device=dev)
    th = torch.randn((j, d), generator=gen, device=dev)
    if dup:
        a[k - 1] = a[0]
    if zeros:
        a[1] = 0.0
    if posterior:
        kern = lambda: ds.posterior_scores(a, th)
        plain = lambda: ds.posterior_scores_plain(a, th)
    else:
        x = torch.randn((b, d), generator=gen, device=dev)
        if zeros:
            x[0] = 0.0
        kern = lambda: ds.dueling_score(x, a, th)
        plain = lambda: ds.dueling_score_plain(x, a, th)
    s_k = kern()
    torch.cuda.synchronize()
    s_p = plain()
    scale = float(s_p.abs().max())
    err = float((s_k - s_p).abs().max())
    out = dict(case=name, B=b, K=k, d=d, J=j, max_abs_err=err,
               max_rel_err=err / scale if scale > 0 else None)
    check(bool(torch.isfinite(s_k).all()), f"{name}: non-finite scores")
    check(err <= NEAR_TIE * scale, f"{name}: scores off by {err}")
    if dup:
        check(torch.equal(s_k[..., k - 1], s_k[..., 0]),
              f"{name}: duplicated arms not bitwise equal")
    if zeros:
        check(not bool(s_k[..., 1].any()), f"{name}: zero arm scored")
        if not posterior:
            check(not bool(s_k[:, 0].any()), f"{name}: zero query scored")
    # one launch, every output summed in one fixed order: bitwise the same
    # from call to call
    check(all(torch.equal(kern(), s_k) for _ in range(3)),
          f"{name}: repeated calls differ")
    out["plan"] = ds.score_plan(b, k, j, d)[0]
    if posterior:
        live = live or k
        dk = dominance.win_matrix(s_k[:, :live])
        dp = dominance.win_matrix(s_p[:, :live])
        tie = near_tie_pairs(s_p[:, :live])
        diff = dk != dp
        out.update(dominance_mismatches=int((diff & ~tie).sum()),
                   dominance_near_tie_mismatches=int((diff & tie).sum()),
                   near_tied_pairs=int(tie.sum()) - live)
        check(out["dominance_mismatches"] == 0,
              f"{name}: dominance differs outside near-ties")
    if timed:
        nbytes = 4 * (b * d + k * d + j * d + j * b * k)
        out["ms"], out["plain_ms"] = time_ms(kern), time_ms(plain)
        out["device_ms"], out["plain_device_ms"] = (device_ms(kern),
                                                    device_ms(plain))
        out["bound_ms"], out["bound_by"] = bound(nbytes,
                                                 2.0 * (j + 1) * b * k * d)
    return out


def mixed_case(name, c, m, k, d, n, gen, dev, *, kind="half", timed=False):
    """One case of the mixed SGLD kernels against their plain versions.
    ``kind``: "half" (duels and clicks), "duels", "clicks", "invalid"
    (valid = 0 on every other minibatch slot) or "self" (a1 == a2 on every
    row)."""
    import torch
    from repro_torch.kernels import sgld_update as su
    x = torch.randn((n, d), generator=gen, device=dev)
    a1 = torch.randint(0, k, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    a2 = a1.clone() if kind == "self" else (a1 + torch.randint(
        1, max(k, 2), (n,), generator=gen, device=dev,
        dtype=torch.int32)) % k
    coin = torch.rand((n,), generator=gen, device=dev) < 0.5
    duel = {"duels": torch.ones_like(coin),
            "clicks": torch.zeros_like(coin)}.get(kind, coin)
    u = torch.rand((n,), generator=gen, device=dev) < 0.5
    y = torch.where(duel, torch.where(u, 1.0, -1.0), u.float())
    rows = torch.randint(0, n, (c, m), generator=gen, device=dev)
    valid = (torch.rand((c, m), generator=gen, device=dev) < 0.9).float()
    if kind == "invalid":
        valid[:, ::2] = 0.0
    a_emb = torch.randn((k, d), generator=gen, device=dev)
    theta = torch.randn((c, d), generator=gen, device=dev)
    g = 4096.0 / valid.sum(-1).clamp_min(1.0)
    ops = (theta, x, a1, a2, y, duel.float(), rows, valid, a_emb)
    u_k = su.mixed_potential_rows(*ops, eta=8.0)
    g_k = su.mixed_potential_grad_rows(*ops, g, eta=8.0)
    torch.cuda.synchronize()
    u_p = su.mixed_potential_rows(*ops, eta=8.0, plain=True)
    g_p = su.mixed_potential_grad_rows(*ops, g, eta=8.0, plain=True)
    du = float((u_k - u_p).abs().max())
    dg = float((g_k - g_p).abs().max())
    su_, sg_ = float(u_p.abs().max()), float(g_p.abs().max())
    rel = lambda err, scale: err / scale if scale > 1e-6 else None
    out = dict(case=name, C=c, m=m, K=k, d=d, kind=kind,
               fwd_max_abs_err=du, fwd_max_rel_err=rel(du, su_),
               grad_max_abs_err=dg, grad_max_rel_err=rel(dg, sg_))
    check(bool(torch.isfinite(u_k).all() and torch.isfinite(g_k).all()),
          f"mixed {name}: non-finite kernel output")
    check(du <= 1e-5 * su_ + 1e-6, f"mixed {name}: potential off by {du}")
    check(dg <= 1e-4 * sg_ + 1e-5, f"mixed {name}: gradient off by {dg}")
    # one cluster launch per call, summed in a fixed order: bitwise the same
    # from call to call
    check(all(torch.equal(su.mixed_potential_rows(*ops, eta=8.0), u_k) and
              torch.equal(su.mixed_potential_grad_rows(*ops, g, eta=8.0),
                          g_k) for _ in range(3)),
          f"mixed {name}: repeated calls differ")
    out["plan"] = su.mixed_plan(m, d)
    if timed:
        # each gathered row once (x, four per-row scalars, its index and
        # valid flag), each arm it scores once, theta, and the output
        r = rows.long()
        scored = torch.cat([a1[r].flatten(), a2[r][duel[r]].flatten()])
        n_scores = scored.numel()
        arm_bytes = 4 * d * torch.unique(scored).numel() + 4 * c * d
        rows_bytes = c * m * (4 * d + 4 * 4 + 8 + 4)
        score_flops = 7.0 * d * n_scores
        fns = dict(
            fwd=lambda: su.mixed_potential_rows(*ops, eta=8.0),
            fwd_plain=lambda: su.mixed_potential_rows(*ops, eta=8.0,
                                                      plain=True),
            grad=lambda: su.mixed_potential_grad_rows(*ops, g, eta=8.0),
            grad_plain=lambda: su.mixed_potential_grad_rows(
                *ops, g, eta=8.0, plain=True))
        for key, fn in fns.items():
            out[key + "_ms"] = time_ms(fn)
            out[key + "_device_ms"] = device_ms(fn)
        out["fwd_bound_ms"], out["fwd_bound_by"] = bound(
            rows_bytes + arm_bytes + 4 * c, score_flops)
        out["grad_bound_ms"], out["grad_bound_by"] = bound(
            rows_bytes + arm_bytes + 4 * c + 4 * c * d,
            score_flops + 5.0 * c * m * d)
    return out


ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2e-2, 2e-2)}
# SDPA against the kernel: loose enough for a TF32 or bf16-P backend; a
# wrong mask or scale would be off by 0.1 or more
LIB_TOL = {"float32": 1e-2, "bfloat16": 5e-2}


def attn_case(name, b, h, kv, s, t, d, gen, dev, *, dtype="float32",
              causal=True, window=0, cap=0.0, strided=False, unaligned=False,
              timed=False, plain_calls=20):
    """One ``flash_attention`` case against the plain version on the card:
    |kernel - plain| <= atol + rtol * |plain| elementwise (fp32 2e-5, bf16
    2e-2). ``strided`` passes q, k, v as ``transpose(1, 2)`` views of
    (B,S,H,D) tensors, as the model does; ``unaligned`` (fp32) as views one
    element off a 16-byte boundary, which the SIMT kernel loads with 4-byte
    copies. Timed cases add the bound (4 D
    operations per live (row, key) pair, counted from the mask; q, k, v and
    o moved once; bf16 against the bf16 tensor-core peak) and, where no
    soft cap is set, the time of ``scaled_dot_product_attention`` on the
    same inputs as the library yardstick (within ``LIB_TOL`` of the kernel:
    the same function), with a window as a dense boolean mask from
    ``live_mask``. ``plain_calls`` cuts the plain version's timed calls
    where each takes tens of milliseconds."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    dt = getattr(torch, dtype)
    q_shape, kv_shape = (((b, s, h, d), (b, t, kv, d)) if strided
                         else ((b, h, s, d), (b, kv, t, d)))
    q = torch.randn(q_shape, generator=gen, device=dev).to(dt)
    k = torch.randn(kv_shape, generator=gen, device=dev).to(dt)
    v = torch.randn(kv_shape, generator=gen, device=dev).to(dt)
    if strided:
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if unaligned:
        def off(x):
            buf = x.new_empty(x.numel() + 1)
            y = buf[1:].view(x.shape)
            y.copy_(x)
            return y
        q, k, v = off(q), off(k), off(v)
    kw = dict(causal=causal, window=window, softcap=cap)
    o_k = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    o_p = fa.flash_attention_plain(q, k, v, **kw)
    rtol, atol = ATTN_TOL[dtype]
    diff = (o_k.float() - o_p.float()).abs()
    out = dict(case=name, B=b, H=h, KV=kv, S=s, T=t, D=d, dtype=dtype,
               causal=causal, window=window, softcap=cap, strided=strided,
               unaligned=unaligned, max_abs_err=float(diff.max()))
    check(bool(torch.isfinite(o_k.float()).all()),
          f"attn {name}: non-finite kernel output")
    check(bool((diff <= atol + rtol * o_p.float().abs()).all()),
          f"attn {name}: off by {out['max_abs_err']}")
    if window and s > t + window - 1:
        dead = o_k[:, :, t + window - 1:].float()
        mean_v = v.float().mean(dim=2).repeat_interleave(h // kv, dim=1)
        out["dead_rows"] = s - (t + window - 1)
        out["dead_rows_max_abs_err"] = float(
            (dead - mean_v[:, :, None]).abs().max())
        check(out["dead_rows_max_abs_err"] <= atol + rtol,
              f"attn {name}: a row with no live key is not the mean of v")
    del o_p, diff
    if timed:
        mask = fa.live_mask(s, t, causal=causal, window=window, device=dev)
        live = int(mask.sum())
        nbytes = (q.numel() * 2 + k.numel() * 2) * q.element_size()
        peak = BF16_FLOP_PER_S if dtype == "bfloat16" else FP32_FLOP_PER_S
        kern = lambda: fa.flash_attention(q, k, v, **kw)
        plain = lambda: fa.flash_attention_plain(q, k, v, **kw)
        out["ms"] = time_ms(kern)
        out["plain_ms"] = time_ms(plain, calls=plain_calls)
        out["device_ms"] = device_ms(kern)
        out["plain_device_ms"] = device_ms(plain, calls=plain_calls)
        out["bound_ms"], out["bound_by"] = bound(
            nbytes, 4.0 * b * h * live * d, peak)
        out["library_ms"] = None
        if not cap:
            sdpa_kw = (dict(is_causal=causal) if not window
                       else dict(attn_mask=mask))
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, enable_gqa=h != kv, **sdpa_kw)
            o_l = sdpa()
            out["library_max_abs_err"] = float((o_l.float()
                                                - o_k.float()).abs().max())
            check(out["library_max_abs_err"] <= LIB_TOL[dtype],
                  f"attn {name}: SDPA computes another function")
            del o_l
            out["library_mask"] = ("dense bool" if window else
                                   "is_causal" if causal else "none")
            out["library_ms"] = time_ms(sdpa)
            out["library_device_ms"] = device_ms(sdpa)
    return out


def attn_cases(gen, dev):
    """The attn family: the reference's five test shapes in fp32 and bf16,
    rows with no live key, bf16 strided views, ragged S/T at D 256, D 32
    with GQA, then the path's and the LM configs' heads."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        for i, (b, h, kv, s, t, d, causal, window, cap) in enumerate([
                (2, 4, 2, 256, 256, 64, True, 0, 0.0),
                (1, 4, 1, 200, 200, 64, True, 64, 0.0),
                (2, 2, 2, 128, 384, 128, False, 0, 50.0),
                (1, 8, 8, 64, 64, 128, True, 0, 30.0),
                (1, 2, 1, 384, 130, 64, True, 0, 0.0)]):
            cases.append(attn_case(f"ref{i}_{dtype}", b, h, kv, s, t, d, gen,
                                   dev, dtype=dtype, causal=causal,
                                   window=window, cap=cap))
    bf = dict(dtype="bfloat16")
    cases += [
        # the fp32 kernel's double buffer over many kv tiles, ragged S/T,
        # 16-key tiles at D 128, and its 4-byte copies for unaligned views
        attn_case("fp32_double_buffer_ragged", 2, 4, 2, 333, 517, 64, gen,
                  dev, causal=False),
        attn_case("fp32_d128_ragged_window", 1, 4, 2, 300, 461, 128, gen,
                  dev, window=100),
        attn_case("fp32_d256_cap", 1, 2, 2, 70, 90, 256, gen, dev,
                  causal=False, window=40, cap=30.0),
        attn_case("fp32_unaligned", 2, 4, 2, 90, 150, 64, gen, dev,
                  causal=False, window=30, unaligned=True),
    ]
    cases += [
        attn_case("no_live_key_rows", 1, 2, 1, 300, 100, 64, gen, dev,
                  causal=True, window=4),
        attn_case("no_live_key_rows_bf16", 1, 4, 2, 300, 100, 256, gen, dev,
                  causal=True, window=4, **bf),
        attn_case("strided_bf16", 2, 8, 2, 300, 300, 128, gen, dev,
                  strided=True, **bf),
        attn_case("strided_window_cap_bf16", 2, 16, 8, 300, 300, 256, gen,
                  dev, window=100, cap=50.0, strided=True, **bf),
        attn_case("ragged_d256_bf16", 1, 4, 2, 300, 130, 256, gen, dev, **bf),
        attn_case("ragged_d256_window_bf16", 2, 4, 1, 300, 130, 256, gen,
                  dev, causal=False, window=64, **bf),
        attn_case("d32_gqa_bf16", 1, 8, 2, 300, 300, 32, gen, dev, **bf),
        # head dims below 32 on the kernel built for 32 (zero-filled
        # columns): the minilm encoder's attention (d 96 over 4 heads) at
        # its batch, and D 16 and 8 at the same shape; D 24 and D 30 (4-byte
        # copies) with a window and ragged S/T
        attn_case("minilm_d24", 64, 4, 4, 32, 32, 24, gen, dev, causal=False),
        attn_case("minilm_d16", 64, 4, 4, 32, 32, 16, gen, dev, causal=False),
        attn_case("minilm_d8", 64, 4, 4, 32, 32, 8, gen, dev, causal=False),
        attn_case("d24_window_ragged", 1, 4, 2, 100, 70, 24, gen, dev,
                  causal=False, window=16),
        attn_case("d30_causal_ragged", 2, 4, 2, 45, 77, 30, gen, dev),
        # the encoder's attention at the ccft path's batch: EncoderConfig()
        attn_case("main", 256, 4, 4, 64, 64, 64, gen, dev, causal=False,
                  timed=True),
        # the paper examples' encoder (d 128 over 4 heads) at a fine-tuning
        # side's 64 queries, and at mixinstruct's encode of its kept queries
        attn_case("examples_d32", 64, 4, 4, 32, 32, 32, gen, dev,
                  causal=False, timed=True),
        # the router dry-run's encoder (d 768 over 12 heads, 128 tokens)
        # on one rank's rows of the 16 x 16 and 2 x 16 x 16 meshes
        attn_case("dryrun_16x16", 4096, 12, 12, 128, 128, 64, gen, dev,
                  causal=False, timed=True),
        attn_case("dryrun_2x16x16", 2048, 12, 12, 128, 128, 64, gen, dev,
                  causal=False, timed=True),
        attn_case("examples_d32_encode", 148, 4, 4, 32, 32, 32, gen, dev,
                  causal=False),
        # qwen2-7b's heads
        attn_case("bench", 1, 28, 4, 2048, 2048, 128, gen, dev, timed=True),
        attn_case("qwen2_bf16", 1, 28, 4, 2048, 2048, 128, gen, dev,
                  timed=True, **bf),
        # gemma2-9b's heads at the lm path's prefill (B 1 x 8192): soft
        # cap, and in the local layers a window that bites
        attn_case("gemma2_bf16", 1, 16, 8, 8192, 8192, 256, gen, dev,
                  window=4096, cap=50.0, timed=True, strided=True,
                  plain_calls=2, **bf),
        attn_case("gemma2_global_bf16", 1, 16, 8, 8192, 8192, 256, gen, dev,
                  cap=50.0, timed=True, strided=True, plain_calls=2, **bf),
        # recurrentgemma-9b's local layers at the lm path's prefill
        attn_case("recurrentgemma_bf16", 2, 16, 1, 4096, 4096, 256, gen, dev,
                  window=2048, timed=True, **bf),
        # the MoE, vision and encoder-decoder models' layers at the lm
        # path's prefill: granite-moe-3b-a800m, arctic-480b (B 2) and
        # llava-next-34b (B 1, patches and text); seamless-m4t-medium's
        # encoder (bidirectional over 1024 frames), its decoder's causal
        # self-attention, and its cross attention (S 4096 queries over the
        # T 1024 memory keys, no mask), then cross attention at ragged S
        # and T
        attn_case("granite_moe_bf16", 2, 24, 8, 4096, 4096, 64, gen, dev,
                  timed=True, strided=True, **bf),
        attn_case("arctic_bf16", 2, 56, 8, 4096, 4096, 128, gen, dev,
                  timed=True, strided=True, **bf),
        attn_case("llava_bf16", 1, 56, 8, 4096, 4096, 128, gen, dev,
                  timed=True, strided=True, **bf),
        attn_case("seamless_enc_bf16", 2, 16, 16, 1024, 1024, 64, gen, dev,
                  causal=False, timed=True, strided=True, **bf),
        attn_case("seamless_self_bf16", 2, 16, 16, 4096, 4096, 64, gen, dev,
                  timed=True, strided=True, **bf),
        attn_case("seamless_cross_bf16", 2, 16, 16, 4096, 1024, 64, gen, dev,
                  causal=False, timed=True, strided=True, **bf),
        attn_case("cross_ragged_bf16", 2, 16, 16, 333, 1000, 64, gen, dev,
                  causal=False, strided=True, **bf),
        # the dense models' layers at the lm path's prefill (B 2 x 4096):
        # granite-3-2b, qwen2-7b (7 query heads a kv head) and
        # mistral-large-123b (12)
        attn_case("granite_3_2b_bf16", 2, 32, 8, 4096, 4096, 64, gen, dev,
                  timed=True, strided=True, plain_calls=2, **bf),
        attn_case("qwen2_7b_bf16", 2, 28, 4, 4096, 4096, 128, gen, dev,
                  timed=True, strided=True, plain_calls=2, **bf),
        attn_case("mistral_bf16", 2, 96, 8, 4096, 4096, 128, gen, dev,
                  timed=True, strided=True, plain_calls=2, **bf),
    ]
    return cases


ATTN_BWD_TOL = 1e-4     # rtol = atol = 1e-4 of each gradient's max |g|
# bf16: within 2e-2 of each gradient's max |g| (dq, dk, dv are rounded to
# bf16 at the store); the forward's lse within 1e-4 + 1e-5 |lse|
ATTN_BWD_BF16_TOL = 2e-2
# SDPA's backward against the kernel's: the same function, to 1e-2 of max
# |g| in fp32, 5e-2 in bf16 (a wrong mask or scale would be off by far
# more)
LIB_BWD_TOL = {"float32": 1e-2, "bfloat16": 5e-2}


def attn_bwd_case(name, b, h, kv, s, t, d, gen, dev, *, causal=True,
                  window=0, cap=0.0, strided=False, cfg=None, expect=None,
                  timed=False, dtype="float32", calls=20):
    """One ``flash_attention_bwd`` case against ``flash_attention_bwd_plain``
    on the card, both from the kernel forward's o and lse, in the
    configuration ``bwd_plan`` picks or, with ``cfg``, the one it names
    (recorded as ``plan``; ``expect``: the configuration the plan must
    pick): |kernel - plain| <= 1e-4 max|plain| + 1e-4 |plain| for dq, dk
    and dv; two more calls must repeat bitwise, and dq must be exactly 0 on
    rows with no live key. ``strided`` passes q, k, v and dO as
    ``transpose(1, 2)`` views. Timed cases add the device time by kernel
    name, the bound (10 D operations per live (row, key) pair at the fp32
    rate; q, k, v, o, dO, lse, dq, dk and dv moved once) and, without a
    soft cap, the time of SDPA's backward (``torch.autograd.grad`` over a
    kept SDPA graph on the same inputs; the forward is not timed).
    ``dtype`` bfloat16 runs the bf16 forward (its lse is checked against
    the plain version's) and the bf16 backward (at head dims 64, 128 and
    256 the Hopper design, else the SIMT kernels built for bf16), within
    ``ATTN_BWD_BF16_TOL`` of each gradient's max |g|, with the bound at
    the bf16 tensor-core rate and bf16 bytes (and, for the Hopper design,
    ``design_ops_ms``: its 14 D operations a live pair, 18 D at head dim
    256, at that rate); ``calls`` sets the timed calls per measurement
    (fewer for the long rows)."""
    from repro_torch.kernels import flash_attention as fa
    plan = fa.bwd_plan
    if cfg is not None:
        fa.bwd_plan = lambda *args: plan(*args, cfg=cfg)
    try:
        return _attn_bwd_case(name, b, h, kv, s, t, d, gen, dev,
                              causal=causal, window=window, cap=cap,
                              strided=strided, expect=expect, timed=timed,
                              dtype=dtype, calls=calls)
    finally:
        fa.bwd_plan = plan


def device_split(fn, calls=20, attempts=3):
    """Device us per call of ``fn`` by kernel name (``torch.profiler``; a
    profile that records no device activity, or not its closing marker,
    is taken again, as in ``device_ms``)."""
    import torch
    from repro_torch import profiling
    fn()
    torch.cuda.synchronize()
    out = None
    for _ in range(attempts):
        with profiling.cuda_profile() as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        split = {}
        for key, us, _ in profiling.kernel_events(prof):
            name = key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            split[name] = split.get(name, 0.0) + us / calls
        if split:
            out = split
            if profiling.window_whole(prof):
                break
    return out


def _attn_bwd_case(name, b, h, kv, s, t, d, gen, dev, *, causal, window,
                   cap, strided, expect, timed, dtype, calls):
    import torch
    from repro_torch.kernels import flash_attention as fa
    bf16 = dtype == "bfloat16"
    q_shape, kv_shape = (((b, s, h, d), (b, t, kv, d)) if strided
                         else ((b, h, s, d), (b, kv, t, d)))
    mk = lambda shape: torch.randn(shape, generator=gen, device=dev).to(
        getattr(torch, dtype))
    q, k, v, do = mk(q_shape), mk(kv_shape), mk(kv_shape), mk(q_shape)
    if strided:
        q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
    kw = dict(causal=causal, window=window, softcap=cap)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    kern = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    got = kern()
    torch.cuda.synchronize()
    plain = lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    want = plain()
    plan = fa.bwd_plan(b, h, kv, s, t, d, causal, window, q.dtype)
    out = dict(case=name, B=b, H=h, KV=kv, S=s, T=t, D=d, dtype=dtype,
               causal=causal, window=window, softcap=cap, strided=strided,
               plan=plan._asdict())
    if expect is not None:
        check(plan.cfg == expect, f"attn_bwd {name}: plan {plan} is not "
                                  f"configuration {expect}")
    if bf16:
        # the bf16 forward's lse (log2 units inside the kernel) against
        # the plain version's natural one; -inf on rows with no live key
        _, want_lse = fa._plain_forward(q, k, v, scale=None, want_lse=True,
                                        **kw)
        dead = ~torch.isfinite(want_lse)
        check(torch.equal(~torch.isfinite(lse), dead)
              and bool((lse[dead] == -torch.inf).all()),
              f"attn_bwd {name}: the bf16 lse is not -inf exactly on the "
              f"rows with no live key")
        lerr = (lse[~dead] - want_lse[~dead]).abs()
        out["lse_max_abs_err"] = float(lerr.max())
        check(bool((lerr <= 1e-4 + 1e-5 * want_lse[~dead].abs()).all()),
              f"attn_bwd {name}: the bf16 lse is off by "
              f"{out['lse_max_abs_err']}")
        del want_lse, lerr
    errs = []
    for gname, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.dtype == q.dtype and bool(torch.isfinite(g).all()),
              f"attn_bwd {name}: non-finite {gname} or not {dtype}")
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        top = float(w.abs().max())
        errs.append(float(diff.max()))
        ok = (errs[-1] <= ATTN_BWD_BF16_TOL * top if bf16 else
              bool((diff <= ATTN_BWD_TOL * (top + w.abs())).all()))
        check(ok, f"attn_bwd {name}: {gname} off by {errs[-1]} (max |g| "
                  f"{top})")
        out[f"{gname}_max_rel_err"] = errs[-1] / max(top, 1e-30)
        del diff
    out["max_abs_err"] = max(errs)
    for _ in range(2):
        again = kern()
        check(all(bool(torch.equal(x, y)) for x, y in zip(got, again)),
              f"attn_bwd {name}: a repeated call differs")
    if window and s > t + window - 1:
        out["dead_rows"] = s - (t + window - 1)
        check(not bool(got[0][:, :, t + window - 1:].any()),
              f"attn_bwd {name}: dq is not 0 on rows with no live key")
    del want, again
    if timed:
        mask = fa.live_mask(s, t, causal=causal, window=window, device=dev)
        live = int(mask.sum())
        nbytes = (q.element_size() * (4 * q.numel() + 4 * k.numel())
                  + 4 * lse.numel())
        runs = 5 if calls >= 20 else 3
        out["ms"] = time_ms(kern, runs=runs, calls=calls)
        out["plain_ms"] = time_ms(plain, runs=runs, calls=calls)
        # the kernel's device time is the sum of its split by kernel name
        # (one profile, not two)
        out["device_us_by_kernel"] = device_split(kern, calls=calls)
        check(out["device_us_by_kernel"] is not None,
              f"attn_bwd {name}: three profiles recorded no device activity")
        out["device_ms"] = sum(out["device_us_by_kernel"].values()) / 1e3
        out["plain_device_ms"] = device_ms(plain, calls=calls)
        out["bound_ms"], out["bound_by"] = bound(
            nbytes, 10.0 * b * h * live * d,
            BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)
        if plan.cfg == fa.BWD_SM90:
            # the Hopper design's own work, beside the 10 D bound: 14 D a
            # live pair (two passes each recompute S and dP), 18 D at head
            # dim 256 (both dK/dV warpgroups compute S^T and dP^T)
            out["design_ops_ms"] = (18.0 if d == 256 else 14.0) * b * h * \
                live * d / BF16_FLOP_PER_S * 1e3
        out["library_ms"] = None
        if not cap:
            sdpa_kw = (dict(is_causal=causal) if not window
                       else dict(attn_mask=mask))
            ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
            o_l = torch.nn.functional.scaled_dot_product_attention(
                ql, kl, vl, enable_gqa=h != kv, **sdpa_kw)
            lib = lambda: torch.autograd.grad(o_l, (ql, kl, vl), do,
                                              retain_graph=True)
            rel = max(float((x.float() - y.float()).abs().max())
                      / float(y.float().abs().max())
                      for x, y in zip(lib(), got))
            out["library_max_rel_err"] = rel
            check(rel <= LIB_BWD_TOL[dtype],
                  f"attn_bwd {name}: SDPA's backward computes another "
                  f"function (off by {rel} of max |g|)")
            out["library_mask"] = ("dense bool" if window else
                                   "is_causal" if causal else "none")
            out["library_ms"] = time_ms(lib, runs=runs, calls=calls)
            out["library_device_ms"] = device_ms(lib, calls=calls)
            del o_l, ql, kl, vl
    return out


def attn_bwd_cases(gen, dev):
    """The attn_bwd family: the training step's shape (``main``: the
    fine-tuning batch of 64 pairs through ``EncoderConfig()``; Small) and
    the same forced to Large (``main_large``), qwen2-7b's heads (``bench``;
    Large), the e5b encoder (D 32) and the minilm encoder's head dim 24
    (both Small, timed beside SDPA's backward), Small at GQA with a window
    and a soft cap and with rows that have no live key over two row tiles,
    the last T Small takes (64) and the first past it (65, Large), causal +
    window + soft cap at D 256 with ragged S/T, GQA and rows with no live
    key, D 16 and 8, D 30 (4-byte copies), ragged GQA at D 128, and
    strided views."""
    return [
        attn_bwd_case("main", 64, 4, 4, 64, 64, 64, gen, dev, causal=False,
                      expect=0, timed=True),
        attn_bwd_case("bench", 1, 28, 4, 2048, 2048, 128, gen, dev,
                      expect=1, timed=True),
        attn_bwd_case("main_large", 64, 4, 4, 64, 64, 64, gen, dev,
                      causal=False, cfg=1, timed=True),
        attn_bwd_case("e5b", 64, 4, 4, 32, 32, 32, gen, dev, causal=False,
                      expect=0, timed=True),
        attn_bwd_case("minilm_d24", 64, 4, 4, 32, 32, 24, gen, dev,
                      causal=False, expect=0, timed=True),
        attn_bwd_case("small_gqa_window_cap", 64, 8, 2, 64, 64, 64, gen,
                      dev, window=16, cap=30.0, expect=0),
        attn_bwd_case("small_dead_rows", 128, 4, 1, 100, 40, 32, gen, dev,
                      window=8, expect=0),
        attn_bwd_case("small_last_t", 2, 2, 2, 70, 64, 128, gen, dev,
                      causal=False, strided=True, expect=0),
        attn_bwd_case("large_first_t", 2, 2, 2, 70, 65, 128, gen, dev,
                      causal=False, strided=True, expect=1),
        attn_bwd_case("d256_window_cap_dead_rows", 1, 4, 2, 300, 130, 256,
                      gen, dev, window=64, cap=30.0),
        attn_bwd_case("minilm_d16", 64, 4, 4, 32, 32, 16, gen, dev,
                      causal=False),
        attn_bwd_case("minilm_d8", 64, 4, 4, 32, 32, 8, gen, dev,
                      causal=False),
        attn_bwd_case("d30_window_ragged", 2, 4, 2, 45, 77, 30, gen, dev,
                      causal=False, window=9),
        attn_bwd_case("d128_gqa_ragged", 1, 8, 2, 200, 333, 128, gen, dev,
                      causal=False),
        attn_bwd_case("strided_window", 2, 8, 2, 150, 150, 64, gen, dev,
                      window=40, strided=True),
        attn_bwd_case("strided_d32_cap", 2, 4, 4, 90, 90, 32, gen, dev,
                      causal=False, cap=20.0, strided=True),
    ]


def attn_bwd_bf16_cases(gen, dev):
    """The attn_bwd_bf16 family: ``flash_attention_bwd`` in bf16 (and the
    bf16 forward's lse) at the training paths' heads, timed:
    granite-3-2b's (``main``: B 2, H 32, KV 8, S = T 4096, D 64, causal;
    the Hopper design, and ``main_large`` the same forced to the SIMT
    kernels' Large), gemma2-9b's (``bench``: B 1, H 16, KV 8, S = T 8192,
    D 256, soft cap 50, window 4096), recurrentgemma-9b's local layer (B 1,
    H 16, KV 1, S = T 4096, D 256, window 2048), qwen2-7b's (B 2, H 28,
    KV 4, S = T 4096, D 128, causal), seamless-m4t-medium's
    encoder (B 2, H = KV 16, S = T 1024, D 64, bidir) and cross attention
    (S 4096 over T 1024, no mask), all the Hopper design; then the edges:
    rows with no live key, ragged S/T at D 256 and D 32, ``transpose(1,
    2)`` views, the Hopper design's tile edges (MQA with S and T one past
    and one short of its tiles, T > S under a soft cap at D 128, dead rows
    at group 4), and Small and Large forced (Large at D 64 and at D 256
    with dead rows and a cap)."""
    bf = dict(dtype="bfloat16")
    big = dict(bf, timed=True, calls=3)
    return [
        attn_bwd_case("main", 2, 32, 8, 4096, 4096, 64, gen, dev,
                      strided=True, expect=2, **dict(big, calls=10)),
        attn_bwd_case("bench", 1, 16, 8, 8192, 8192, 256, gen, dev,
                      window=4096, cap=50.0, strided=True, expect=2, **big),
        attn_bwd_case("main_large", 2, 32, 8, 4096, 4096, 64, gen, dev,
                      strided=True, cfg=1, **big),
        attn_bwd_case("recurrentgemma", 1, 16, 1, 4096, 4096, 256, gen, dev,
                      window=2048, strided=True, expect=2, **big),
        attn_bwd_case("qwen2", 2, 28, 4, 4096, 4096, 128, gen, dev,
                      strided=True, expect=2, **big),
        attn_bwd_case("seamless_enc", 2, 16, 16, 1024, 1024, 64, gen, dev,
                      causal=False, strided=True, expect=2,
                      **dict(big, calls=10)),
        attn_bwd_case("seamless_cross", 2, 16, 16, 4096, 1024, 64, gen, dev,
                      causal=False, strided=True, expect=2,
                      **dict(big, calls=10)),
        attn_bwd_case("dead_rows_d256_cap", 1, 4, 2, 300, 130, 256, gen, dev,
                      window=64, cap=30.0, **bf),
        attn_bwd_case("dead_rows_d32_small", 8, 4, 1, 100, 40, 32, gen, dev,
                      window=8, cfg=0, **bf),
        attn_bwd_case("ragged_gqa_d128", 1, 8, 2, 200, 333, 128, gen, dev,
                      causal=False, **bf),
        attn_bwd_case("strided_window_d64", 2, 8, 2, 150, 150, 64, gen, dev,
                      window=40, strided=True, **bf),
        attn_bwd_case("sm90_mqa_tile_edges", 2, 4, 1, 255, 257, 128, gen,
                      dev, causal=False, strided=True, expect=2, **bf),
        attn_bwd_case("sm90_t_past_s_cap", 1, 4, 1, 65, 700, 128, gen, dev,
                      causal=False, cap=20.0, expect=2, **bf),
        attn_bwd_case("sm90_dead_rows_group4", 1, 8, 2, 260, 100, 64, gen,
                      dev, window=30, expect=2, **bf),
        attn_bwd_case("small_d128", 4, 4, 2, 64, 64, 128, gen, dev,
                      causal=False, cfg=0, **bf),
        attn_bwd_case("large_forced_d64", 4, 4, 2, 64, 64, 64, gen, dev,
                      cfg=1, **bf),
        attn_bwd_case("large_forced_d256_dead_rows", 1, 4, 2, 300, 130, 256,
                      gen, dev, window=64, cap=30.0, cfg=1, **bf),
    ]


SSD_TOL, RGLRU_TOL = 2e-4, 1e-5       # the reference's kernel tolerances


def within(got, want, tol):
    """max |got - want| and whether every element is within tol + tol *
    |want| (rtol = atol = tol, as the reference's assert_allclose)."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= tol + tol * want.float().abs())
                                   .all())


def ssd_case(name, b, s, h, p, n, chunk, gen, dev, *, dtype="float32",
             h0=False, strided=False, timed=False):
    """One ``ssd_scan`` case against the plain version on the card (y and
    h_last to rtol = atol = 2e-4). Inputs as the reference's test makes
    them: x, B, C normal, dt = softplus(normal), log_a = -0.1 dt.
    ``strided`` passes x, B and C as column slices of one (B,S,H*P+2N)
    tensor, as the model does. Timed cases add the bound: the operations
    the function needs, for a chunk of l live steps l (l + 1) N for the
    causal half of C.B^T once per (batch, chunk) (B and C are shared by
    the heads), and per (batch*head, chunk) l (l + 1) P for the causal
    W x plus 2 l N P each for C.state and the state update; bytes: x, B,
    C, log_a, dt and h0 read once, y and h_last written once; bf16 inputs
    against the bf16 tensor-core peak (the Hopper kernel's route), fp32
    against the CUDA cores'. ``kernel`` records which kernel the wrapper's
    rule picked."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    dt_ = getattr(torch, dtype)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    if strided:
        xbc = rn(b, s, h * p + 2 * n).to(dt_)
        x = xbc[..., :h * p].reshape(b, s, h, p)
        bt, ct = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    else:
        x, bt, ct = (rn(b, s, h, p).to(dt_), rn(b, s, n).to(dt_),
                     rn(b, s, n).to(dt_))
    dt = torch.nn.functional.softplus(rn(b, s, h))
    log_a = -0.1 * dt
    hh = rn(b, h, p, n) if h0 else None
    args = (x, bt, ct, log_a, dt, hh)
    y, hl = ss.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    py, phl = ss.ssd_scan_plain(*args, chunk=chunk)
    ey, oky = within(y, py, SSD_TOL)
    eh, okh = within(hl, phl, SSD_TOL)
    out = dict(case=name, B=b, S=s, H=h, P=p, N=n, chunk=chunk, dtype=dtype,
               h0=h0, strided=strided,
               kernel="sm90" if ss.uses_sm90(dt_, p, n, chunk) else "simt",
               max_abs_err=max(ey, eh), h_last_max_abs_err=eh)
    check(bool(torch.isfinite(y).all()) and bool(torch.isfinite(hl).all()),
          f"ssd {name}: non-finite kernel output")
    check(oky and okh, f"ssd {name}: off by {ey} (y), {eh} (h_last)")
    del py, phl
    if timed:
        lens = [min(chunk, s - c) for c in range(0, s, chunk)]
        flops = float(sum(b * l * (l + 1) * n
                          + b * h * (l * (l + 1) * p + 4 * l * n * p)
                          for l in lens))
        el = x.element_size()
        nbytes = (el * (b * s * h * p + 2 * b * s * n) + 4 * 2 * b * s * h
                  + 4 * b * s * h * p + 4 * b * h * p * n * (1 + bool(h0)))
        kern = lambda: ss.ssd_scan(*args, chunk=chunk)
        plain = lambda: ss.ssd_scan_plain(*args, chunk=chunk)
        out["ms"], out["device_ms"] = time_ms(kern), device_ms(kern)
        out["plain_ms"] = time_ms(plain, runs=3, calls=2, warmup=1)
        out["plain_device_ms"] = device_ms(plain, calls=2)
        peak = BF16_FLOP_PER_S if dtype == "bfloat16" else FP32_FLOP_PER_S
        out["bound_ms"], out["bound_by"] = bound(nbytes, flops, peak)
        out["library_ms"] = None
    return out


def ssd_refuses_misaligned(dev):
    """The Hopper kernels load bf16 x, B and C through TMA: slices of a
    (B,S,H*P+2N) tensor one element off a 16-byte boundary, or with a row
    stride that is not a multiple of 8 elements, raise ValueError and
    launch nothing."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    b, s, h, p, n = 1, 64, 2, 64, 128
    width = h * p + 2 * n
    xbc = torch.zeros((b, s, width + 4), device=dev, dtype=torch.bfloat16)
    dt = torch.ones((b, s, h), device=dev)
    before, refused = ss.ssd_scan.launches, 0
    for t in (xbc[..., 1:1 + width], xbc[..., :width]):
        x = t[..., :h * p].unflatten(-1, (h, p))
        try:
            ss.ssd_scan(x, t[..., h * p:h * p + n], t[..., h * p + n:],
                        -0.1 * dt, dt)
        except ValueError:
            refused += 1
    check(refused == 2 and ss.ssd_scan.launches == before,
          "ssd: a misaligned bf16 slice was not refused")
    return refused


def rglru_case(name, b, s, d, gen, dev, *, h0=False, timed=False,
               time_plain=True):
    """One ``rglru_scan`` case against the plain version on the card (h
    and h_last to rtol = atol = 1e-5); log_a = -0.1 |normal| and x normal,
    as the reference's test. Timed cases add the bound: 12 bytes per
    element (log_a and x read, h written) plus h0 and h_last, against ~8
    operations per element; and, unless ``time_plain`` is False, the
    plain version's times (None then: it walks S in Python, ~1.3 s a call
    at S 32768)."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    log_a = -0.1 * torch.randn((b, s, d), generator=gen, device=dev).abs()
    x = torch.randn((b, s, d), generator=gen, device=dev)
    hh = torch.randn((b, d), generator=gen, device=dev) if h0 else None
    h, hl = rg.rglru_scan(log_a, x, hh)
    torch.cuda.synchronize()
    ph, phl = rg.rglru_scan_plain(log_a, x, hh)
    e1, ok1 = within(h, ph, RGLRU_TOL)
    e2, ok2 = within(hl, phl, RGLRU_TOL)
    out = dict(case=name, B=b, S=s, D=d, h0=h0, max_abs_err=max(e1, e2),
               kernel="sm90" if rg.uses_tma(log_a, x) else "simt")
    check(bool(torch.isfinite(h).all()), f"rglru {name}: non-finite output")
    check(ok1 and ok2, f"rglru {name}: off by {e1} (h), {e2} (h_last)")
    del ph, phl
    if timed:
        nbytes = 12 * b * s * d + 4 * b * d * (1 + bool(h0))
        kern = lambda: rg.rglru_scan(log_a, x, hh)
        plain = lambda: rg.rglru_scan_plain(log_a, x, hh)
        out["ms"], out["device_ms"] = time_ms(kern), device_ms(kern)
        out["plain_ms"] = out["plain_device_ms"] = None
        if time_plain:
            out["plain_ms"] = time_ms(plain, runs=3, calls=1, warmup=1)
            out["plain_device_ms"] = device_ms(plain, calls=1)
        out["bound_ms"], out["bound_by"] = bound(nbytes, 8.0 * b * s * d)
        out["library_ms"] = None
    return out


def rglru_bwd_case(name, b, s, d, gen, dev, *, h0=False, clamp=False,
                   sm90=True, timed=False):
    """The RG-LRU gradient on the card: ``rglru_scan`` with inputs that
    require grad (through ``RglruScan``: the forward kernel, then
    ``rglru_scan_bwd``) against autograd of the plain recurrence on the
    same inputs, for the loss sum(h * wh) + sum(h_last * wl): log_a, x and
    h0 gradients within 1e-5 of each one's largest finite magnitude, the
    same non-finite values where ``clamp`` sets a channel's log_a to 0.
    ``rglru_scan_bwd`` alone then runs, by profiler name, the Hopper kernel
    ``rglru_bwd_kernel_sm90`` (``sm90``) or else the first design
    ``rglru_bwd_kernel``. Timed cases time ``rglru_scan_bwd`` alone (from the forward's h)
    against its plain version ``rglru_scan_bwd_plain``; the bound: 24
    bytes per element (log_a, x, h and dh read; dlog_a and dx written)
    plus dh_last and h0 / dh0."""
    import torch
    from repro_torch.kernels import rglru_scan as rg
    log_a = -0.1 * torch.randn((b, s, d), generator=gen, device=dev).abs()
    if clamp:
        log_a[:, :, 3] = 0.0
    x = torch.randn((b, s, d), generator=gen, device=dev)
    hh = torch.randn((b, d), generator=gen, device=dev) if h0 else None
    wh = torch.randn((b, s, d), generator=gen, device=dev)
    wl = torch.randn((b, d), generator=gen, device=dev)
    leaves = [t for t in (log_a, x, hh) if t is not None]

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in leaves]
        h, hl = fn(ins[0], ins[1], ins[2] if h0 else None)
        return torch.autograd.grad((h * wh).sum() + (hl * wl).sum(), ins)
    before = rg.rglru_scan_bwd.launches
    got = grads(rg.rglru_scan)
    torch.cuda.synchronize()
    check(rg.rglru_scan_bwd.launches == before + 1,
          f"rglru_bwd {name}: the gradient did not run rglru_scan_bwd")
    want = grads(rg.rglru_scan_plain)
    out = dict(case=name, B=b, S=s, D=d, h0=h0, clamp=clamp)
    errs = []
    for gname, g, w in zip(("dlog_a", "dx", "dh0"), got, want):
        fin = torch.isfinite(w)
        check(torch.equal(torch.isfinite(g), fin)
              and torch.equal(g[~fin].isnan(), w[~fin].isnan())
              and torch.equal(g[~fin & ~w.isnan()], w[~fin & ~w.isnan()]),
              f"rglru_bwd {name}: {gname}'s non-finite values differ")
        top = float(w[fin].abs().max())
        errs.append(float((g[fin] - w[fin]).abs().max()))
        check(errs[-1] <= RGLRU_TOL * top,
              f"rglru_bwd {name}: {gname} off by {errs[-1]} (max {top})")
        out[f"{gname}_max_rel_err"] = errs[-1] / max(top, 1e-30)
        out[f"{gname}_nonfinite"] = int((~fin).sum())
    out["max_abs_err"] = max(errs)
    del got, want
    with torch.no_grad():
        h, _ = rg.rglru_scan(log_a, x, hh)
    args = (log_a, x, hh, h, wh, wl)
    kern = lambda: rg.rglru_scan_bwd(*args)
    names = device_split(kern, calls=1) or {}
    hopper = any("rglru_bwd_kernel_sm90" in k for k in names)
    first = any(k.endswith("rglru_bwd_kernel") for k in names)
    check(hopper and not first if sm90 else first and not hopper,
          f"rglru_bwd {name}: want "
          f"{'rglru_bwd_kernel_sm90' if sm90 else 'rglru_bwd_kernel'}, "
          f"profiled {sorted(names)}")
    out["kernel"] = "sm90" if sm90 else "simt"
    if timed:
        plain = lambda: rg.rglru_scan_bwd_plain(*args)
        nbytes = 24 * b * s * d + 4 * b * d * (1 + 2 * bool(h0))
        out["ms"], out["device_ms"] = time_ms(kern), device_ms(kern)
        # the plain version walks S in Python: one call each
        out["plain_ms"] = time_ms(plain, runs=1, calls=1, warmup=0)
        out["plain_device_ms"] = device_ms(plain, calls=1)
        out["bound_ms"], out["bound_by"] = bound(nbytes, 12.0 * b * s * d)
        out["library_ms"] = None
    return out


def rglru_bwd_cases(gen, dev):
    """The rglru_bwd family: recurrentgemma-9b's training shape (``main``:
    B 1, S 4096, D 4096) and B 2 (``bench``), then h0, D 98 (the first
    design: D % 4 != 0), S 1 and a channel with log_a = 0; all but D 98 on
    the Hopper kernel."""
    return [
        rglru_bwd_case("main", 1, 4096, 4096, gen, dev, timed=True),
        rglru_bwd_case("bench", 2, 4096, 4096, gen, dev, timed=True),
        rglru_bwd_case("h0_ragged", 2, 300, 512, gen, dev, h0=True),
        rglru_bwd_case("d98_h0", 2, 300, 98, gen, dev, h0=True, sm90=False),
        rglru_bwd_case("s1_h0", 2, 1, 4096, gen, dev, h0=True),
        rglru_bwd_case("clamp_h0", 1, 77, 64, gen, dev, h0=True, clamp=True),
    ]


# the SSD backward against ssd_scan_bwd_plain: fp32 gradients to 1e-4 of
# each one's max |g| (fp32 on the card in another summation order), those
# rounded to bf16 (dx, dB, dC of bf16 inputs) to 1e-2 (one bf16 rounding
# of values near the max is 2^-8 of it, and the two sides may round a
# tie-close value apart)
SSD_BWD_TOL, SSD_BWD_BF16_TOL = 1e-4, 1e-2
SSD_BWD_KERNELS = ("ssd_bwd_states_kernel", "ssd_bwd_chunk_kernel",
                   "ssd_bwd_reduce_kernel")
# the Hopper route's kernels (bf16 at P 64, N 128, chunk 128)
SSD_BWD_SM90_KERNELS = ("ssd_bwd_cb_sm90", "ssd_bwd_states_sm90",
                        "ssd_bwd_dc_sm90", "ssd_bwd_dx_sm90",
                        "ssd_bwd_reduce_sm90")


def model_decays(b, s, h, gen, dev):
    """(log_a, dt) (B,S,H) as mamba2-1.3b draws them at its init
    (``models/ssd.py::init_ssd``, ``ssd_prefill``): per head A = exp(a_log)
    with a_log = log U(1, 16) and dt_bias = log(expm1(U(1e-3, 0.1))), then
    dt = softplus(dt_raw + dt_bias) over a unit-normal dt_raw (the
    projection of a unit-RMS input) and log_a = -A dt. Chunks whose mean
    |log_a| passes 0.7 overflow exp(cum_i - cum_j) above the diagonal."""
    import torch
    from repro_torch.kernels.sgld_update import softplus
    u = lambda lo, hi: lo + (hi - lo) * torch.rand((h,), generator=gen,
                                                   device=dev)
    a = u(1.0, 16.0)
    bias = torch.log(torch.expm1(u(1e-3, 0.1)))
    dt = softplus(torch.randn((b, s, h), generator=gen, device=dev) + bias)
    return -a * dt, dt


def ssd_bwd_inputs(b, s, h, p, n, gen, dev, *, dtype, h0, strided, decay):
    """x, B, C, log_a, dt, h0, dy, dh_last of one SSD backward case (x, B,
    C as ``ssd_case`` makes them; ``decay`` "ref": log_a = -0.1 dt, dt =
    softplus(normal), as the reference's test; "model": ``model_decays``)."""
    import torch
    dt_ = getattr(torch, dtype)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    if strided:
        xbc = rn(b, s, h * p + 2 * n).to(dt_)
        x = xbc[..., :h * p].reshape(b, s, h, p)
        bt, ct = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    else:
        x, bt, ct = (rn(b, s, h, p).to(dt_), rn(b, s, n).to(dt_),
                     rn(b, s, n).to(dt_))
    if decay == "model":
        log_a, dt = model_decays(b, s, h, gen, dev)
    else:
        dt = torch.nn.functional.softplus(rn(b, s, h))
        log_a = -0.1 * dt
    hh = rn(b, h, p, n) if h0 else None
    return x, bt, ct, log_a, dt, hh, rn(b, s, h, p), rn(b, h, p, n)


def max_chunk_decay(log_a, chunk):
    """The largest mean |log_a| over a chunk of any (batch, head) (steps
    past S count as 0, as the kernels pad them)."""
    import torch
    b, s, h = log_a.shape
    la = torch.nn.functional.pad(log_a.abs(), (0, 0, 0, -s % chunk))
    return float(la.reshape(b, -1, chunk, h).mean(2).max())


def ssd_bwd_case(name, b, s, h, p, n, chunk, gen, dev, *, dtype="float32",
                 h0=False, strided=False, decay="ref", timed=False,
                 sm90=None):
    """``ssd_scan_bwd`` against its plain version ``ssd_scan_bwd_plain`` on
    the same inputs: every gradient finite and within ``SSD_BWD_TOL`` of
    its max |g| (``SSD_BWD_BF16_TOL`` for the bf16-rounded dx, dB, dC), a
    second call bitwise equal, one counted launch, and the route's kernels
    by profiler name: ``sm90`` (None: by ``ssd_scan.uses_sm90``) the
    Hopper kernels ``SSD_BWD_SM90_KERNELS`` (``csrc/ssd_scan_bwd_sm90.cu``)
    and none of the first design's, else the first design's three
    (``csrc/ssd_scan_bwd.cu``) and none of the Hopper's. Timed cases add
    call and device ms (by kernel) and the bound: the operations the
    gradient needs, per (batch, head, chunk) of l live steps 2 l (l + 1)
    (P + N) for the causal L x L products (dy x^T and W^T dy over P, dCB B
    and dCB^T C over N) and 10 l N P for the state products (dH B, the dC
    and dB state terms, the state walks forwards and backwards), plus l
    (l + 1) N per (batch, chunk) for C.B^T. The rate is the inputs'
    dtype's, whatever the kernel's route: bf16 x/B/C against the bf16
    tensor-core peak, with each product that has an fp32 operand (all
    but C.B^T: dy, the decays and the states are fp32) counted three
    times, as fp32-exact products take three bf16 pieces of that operand
    (the forward's Hopper kernel does so); fp32 inputs against the fp32
    CUDA-core rate. Bytes: the inputs read once and the outputs written
    once."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    args = ssd_bwd_inputs(b, s, h, p, n, gen, dev, dtype=dtype, h0=h0,
                          strided=strided, decay=decay)
    before = ss.ssd_scan_bwd.launches
    got = ss.ssd_scan_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    check(ss.ssd_scan_bwd.launches == before + 1,
          f"ssd_bwd {name}: not one counted launch")
    again = ss.ssd_scan_bwd(*args, chunk=chunk)
    want = ss.ssd_scan_bwd_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    out = dict(case=name, B=b, S=s, H=h, P=p, N=n, chunk=chunk, dtype=dtype,
               h0=h0, strided=strided, decay=decay,
               max_chunk_mean_abs_log_a=max_chunk_decay(args[3], chunk))
    errs = []
    for gname, g, g2, w in zip(("dx", "dB", "dC", "dlog_a", "ddt", "dh0"),
                               got, again, want):
        if w is None:
            continue
        check(bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all()),
              f"ssd_bwd {name}: {gname} not finite")
        check(torch.equal(g, g2), f"ssd_bwd {name}: {gname} does not repeat "
                                  f"bitwise")
        tol = SSD_BWD_BF16_TOL if g.dtype == torch.bfloat16 else SSD_BWD_TOL
        top = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max())
        check(err <= tol * max(top, 1e-30),
              f"ssd_bwd {name}: {gname} off by {err} (max {top})")
        out[f"{gname}_max_rel_err"] = err / max(top, 1e-30)
        errs.append(err)
    out["max_abs_err"] = max(errs)
    out["bitwise_repeat"] = True
    del got, again, want
    kern = lambda: ss.ssd_scan_bwd(*args, chunk=chunk)
    split = device_split(kern, calls=5 if timed else 1)
    if sm90 is None:
        sm90 = ss.uses_sm90(args[0].dtype, p, n, chunk)
    want, other = ((SSD_BWD_SM90_KERNELS, SSD_BWD_KERNELS) if sm90
                   else (SSD_BWD_KERNELS, SSD_BWD_SM90_KERNELS))
    check(split is not None
          and all(any(k in key for key in split) for k in want)
          and not any(k in key for key in split for k in other),
          f"ssd_bwd {name}: want the kernels {want} and none of {other}, "
          f"profiled {split}")
    out["kernel"] = "sm90" if sm90 else "simt"
    if timed:
        lens = [min(chunk, s - c) for c in range(0, s, chunk)]
        bf16 = dtype == "bfloat16"
        flops = float(sum(b * l * (l + 1) * n
                          + (3 if bf16 else 1) * b * h * (
                              2 * l * (l + 1) * (p + n) + 10 * l * n * p)
                          for l in lens))
        el = args[0].element_size()
        nbytes = (2 * el * (b * s * h * p + 2 * b * s * n)    # x, B, C; grads
                  + 4 * 4 * b * s * h                         # log_a, dt; grads
                  + 4 * b * s * h * p                         # dy
                  + 4 * b * h * p * n * (1 + 2 * bool(h0)))   # dh_last, h0, dh0
        plain = lambda: ss.ssd_scan_bwd_plain(*args, chunk=chunk)
        out["ms"], out["device_ms"] = time_ms(kern, runs=3, calls=5), sum(
            split.values()) / 1e3
        out["device_us_by_kernel"] = split
        out["plain_ms"] = time_ms(plain, runs=1, calls=1, warmup=1)
        out["plain_device_ms"] = device_ms(plain, calls=1)
        out["bound_ms"], out["bound_by"] = bound(
            nbytes, flops, BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S)
        out["library_ms"] = None
    return out


def ssd_bwd_cases(gen, dev):
    """The ssd_bwd family: the reference's three test shapes
    (``tests/test_kernels.py:62-66``, fp32), a ragged S with h0 and
    model-drawn decays (bf16 strided, and fp32), S < chunk at P 48 (bf16),
    S 1 with h0, then mamba2-1.3b's training shape as the path hands it
    over (``main``: B 2, S 4096, H 64, P 64, N 128, chunk 128, bf16 column
    slices, decays drawn as the model draws them, where chunks pass a mean
    |log_a| of 1) and the prefill_32k length (``bench``: B 1, S 32768)."""
    bf = dict(dtype="bfloat16")
    out = [ssd_bwd_case(f"ref{i}", b, s, h, p, n, c, gen, dev, h0=h0)
           for i, (b, s, h, p, n, c, h0) in enumerate([
               (2, 200, 4, 64, 32, 64, True), (1, 256, 2, 32, 64, 128, False),
               (2, 96, 8, 64, 128, 32, True)])]
    out += [
        ssd_bwd_case("ragged_h0_model_bf16", 2, 300, 8, 64, 128, 128, gen,
                     dev, h0=True, strided=True, decay="model", sm90=True,
                     **bf),
        ssd_bwd_case("ragged_h0_model_fp32", 2, 300, 8, 64, 128, 128, gen,
                     dev, h0=True, decay="model", sm90=False),
        ssd_bwd_case("ragged_groups_h0_bf16", 1, 700, 20, 64, 128, 128, gen,
                     dev, h0=True, strided=True, decay="model", sm90=True,
                     **bf),
        ssd_bwd_case("p48_s_below_chunk_bf16", 1, 50, 2, 48, 16, 128, gen,
                     dev, sm90=False, **bf),
        ssd_bwd_case("s1_h0", 2, 1, 3, 64, 128, 128, gen, dev, h0=True,
                     sm90=False),
        ssd_bwd_case("s1_h0_bf16", 2, 1, 3, 64, 128, 128, gen, dev, h0=True,
                     strided=True, sm90=True, **bf),
        ssd_bwd_case("main", 2, 4096, 64, 64, 128, 128, gen, dev,
                     strided=True, decay="model", timed=True, sm90=True,
                     **bf),
        ssd_bwd_case("bench", 1, 32768, 64, 64, 128, 128, gen, dev,
                     strided=True, decay="model", timed=True, sm90=True,
                     **bf),
    ]
    main = next(r for r in out if r["case"] == "main")
    check(main["max_chunk_mean_abs_log_a"] > 1.0,
          f"ssd_bwd main: no chunk in the overflow regime "
          f"({main['max_chunk_mean_abs_log_a']})")
    out.append(dict(case="autograd", **ssd_grad_check(dev, gen)))
    ssd_bwd_refuses_misaligned(dev)
    return out


def ssd_bwd_refuses_misaligned(dev):
    """The Hopper backward loads bf16 x, B and C through TMA, as the
    forward does: slices one element off a 16-byte boundary, or with a row
    stride that is not a multiple of 8 elements, raise ValueError and
    launch nothing."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    b, s, h, p, n = 1, 64, 2, 64, 128
    width = h * p + 2 * n
    xbc = torch.zeros((b, s, width + 4), device=dev, dtype=torch.bfloat16)
    dt = torch.ones((b, s, h), device=dev)
    dy = torch.zeros((b, s, h, p), device=dev)
    before, refused = ss.ssd_scan_bwd.launches, 0
    for t in (xbc[..., 1:1 + width], xbc[..., :width]):
        x = t[..., :h * p].unflatten(-1, (h, p))
        try:
            ss.ssd_scan_bwd(x, t[..., h * p:h * p + n], t[..., h * p + n:],
                            -0.1 * dt, dt, None, dy, None)
        except ValueError:
            refused += 1
    check(refused == 2 and ss.ssd_scan_bwd.launches == before,
          "ssd_bwd: a misaligned bf16 slice was not refused")
    return refused


def ssd_grad_check(dev, gen):
    """A grad-requiring input to ``ssd_scan`` on the card goes through
    ``SsdScan``: one forward launch (``ssd_scan.launches``), one backward
    launch (``ssd_scan_bwd.launches``) and gradients that are finite in
    the overflow regime (model-drawn decays at chunk 128, one head at A =
    16) and match autograd of the plain version (``SSD_BWD_TOL`` of each
    one's max |g|)."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    b, s, h, p, n = 1, 256, 2, 64, 128
    x, bt, ct, _, _, _, dy, dhl = ssd_bwd_inputs(
        b, s, h, p, n, gen, dev, dtype="float32", h0=False, strided=False,
        decay="ref")
    log_a, dt = model_decays(b, s, h, gen, dev)
    log_a[..., 0] = -16.0 * dt[..., 0]
    leaves = (x, bt, ct, log_a, dt)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in leaves]
        y, hl = fn(*ins, chunk=128)
        return torch.autograd.grad((y * dy).sum() + (hl * dhl).sum(), ins)
    before = (ss.ssd_scan.launches, ss.ssd_scan_bwd.launches)
    got = grads(ss.ssd_scan)
    torch.cuda.synchronize()
    launches = (ss.ssd_scan.launches - before[0],
                ss.ssd_scan_bwd.launches - before[1])
    check(launches == (1, 1), f"ssd grad: launches (forward, backward) "
                              f"{launches}, want (1, 1)")
    want = grads(ss.ssd_scan_plain)
    worst, worst_abs = 0.0, 0.0
    for gname, g, w in zip(("dx", "dB", "dC", "dlog_a", "ddt"), got, want):
        check(bool(torch.isfinite(g).all()), f"ssd grad: {gname} not finite")
        top = float(w.abs().max())
        err = float((g - w).abs().max())
        check(err <= SSD_BWD_TOL * top, f"ssd grad: {gname} off by {err} "
                                        f"(max {top})")
        worst, worst_abs = max(worst, err / top), max(worst_abs, err)
    return dict(launches=list(launches), max_rel_err=worst,
                max_abs_err=worst_abs,
                max_chunk_mean_abs_log_a=max_chunk_decay(log_a, 128))


def scan_cases(gen, dev):
    """The ssd and rglru families: the reference's test shapes
    (``tests/test_kernels.py:43-67``), the edges (ragged S, S < chunk,
    S = 1, h0, bf16 x/B/C, strided views), then the LM path's shapes
    (``main``: mamba2-1.3b's and recurrentgemma-9b's B 2 x S 4096 prefill,
    in the path's bf16 for the SSD, and in fp32 as ``main_fp32``) and the
    prefill_32k length (``bench``)."""
    ssd = [ssd_case(f"ref{i}", b, s, h, p, n, c, gen, dev, h0=h0)
           for i, (b, s, h, p, n, c, h0) in enumerate([
               (2, 200, 4, 64, 32, 64, True), (1, 256, 2, 32, 64, 128, False),
               (2, 96, 8, 64, 128, 32, True)])]
    ssd_refuses_misaligned(dev)
    bf = dict(dtype="bfloat16")
    ssd += [
        ssd_case("ragged_h0_bf16", 2, 300, 8, 64, 128, 128, gen, dev,
                 h0=True, **bf),
        ssd_case("s_below_chunk_strided", 2, 100, 8, 64, 128, 128, gen, dev,
                 strided=True),
        ssd_case("s1_h0", 2, 1, 4, 64, 128, 128, gen, dev, h0=True),
        # the Hopper kernels' edges: S < chunk, S = 1, the ring turning
        # over many chunks with h0 and strided slices
        ssd_case("s_below_chunk_strided_bf16", 2, 100, 8, 64, 128, 128, gen,
                 dev, strided=True, **bf),
        ssd_case("s1_h0_bf16", 2, 1, 4, 64, 128, 128, gen, dev, h0=True,
                 **bf),
        ssd_case("ring_h0_strided_bf16", 1, 1000, 4, 64, 128, 128, gen, dev,
                 h0=True, strided=True, **bf),
        # bf16 outside the Hopper kernels' tile: the SIMT kernel
        ssd_case("simt_bf16", 2, 200, 4, 64, 32, 64, gen, dev, h0=True,
                 **bf),
        # the path's dtype: mamba2-1.3b's bf16 conv output, sliced
        ssd_case("main", 2, 4096, 64, 64, 128, 128, gen, dev,
                 dtype="bfloat16", strided=True, timed=True),
        ssd_case("main_fp32", 2, 4096, 64, 64, 128, 128, gen, dev,
                 strided=True, timed=True),
        ssd_case("bench", 1, 32768, 64, 64, 128, 128, gen, dev,
                 dtype="bfloat16", strided=True, timed=True),
    ]
    rgl = [rglru_case(f"ref{i}", b, s, d, gen, dev, h0=h0)
           for i, (b, s, d, h0) in enumerate([
               (2, 200, 512, True), (1, 128, 512, False),
               (3, 65, 1024, True)])]
    rgl += [
        rglru_case("d96_ragged", 2, 77, 96, gen, dev),
        rglru_case("s1_h0", 2, 1, 4096, gen, dev, h0=True),
        # B 1, S not a multiple of the ring's 32-step tile; D 98 (no
        # multiple of 4) takes the first kernel
        rglru_case("b1_s_ragged", 1, 1001, 96, gen, dev, h0=True),
        rglru_case("d98_simt", 2, 300, 98, gen, dev, h0=True),
        rglru_case("main", 2, 4096, 4096, gen, dev, timed=True),
        # the plain version checks it once, untimed (the script's time)
        rglru_case("bench", 4, 32768, 4096, gen, dev, timed=True,
                   time_plain=False),
    ]
    return ssd, rgl


def phase_kernels(dev, seed):
    """Every family of kernel cases, and the wall seconds each took."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    stamps = [time.perf_counter()]
    sel = [
        select_case("main", 256, 16, 768, gen, dev, mask_kind="k", live=11,
                    timed=True),
        select_case("main_pref_tilt", 256, 16, 768, gen, dev, mask_kind="k",
                    live=11, tilt_kind="bk"),
        select_case("bench", 4096, 1024, 768, gen, dev, timed=True),
        select_case("k1", 64, 1, 768, gen, dev),
        select_case("k_ragged_d_ragged", 100, 37, 100, gen, dev,
                    tilt_kind="k"),
        select_case("row_mask_survivor_inactive", 130, 11, 768, gen, dev,
                    mask_kind="bk", tilt_kind="bk"),
        select_case("row_mask_not_distinct", 130, 11, 768, gen, dev,
                    mask_kind="bk", distinct=False),
        select_case("large_k", 64, 1100, 96, gen, dev, mask_kind="bk"),
        # the 4-byte loads (d % 4 != 0) of both configurations
        select_case("k32_d98_ragged", 130, 32, 98, gen, dev, mask_kind="bk"),
        select_case("k33_d98_ragged", 70, 33, 98, gen, dev, mask_kind="bk",
                    tilt_kind="k"),
        select_case("duplicate_arms_first_index", 256, 16, 768, gen, dev,
                    distinct=False, dup=True),
        # a RouterService batch over the RouterBench pool (Small, 8 rows a
        # block); the routing shape and its edges forced to Large, so both
        # configurations run there
        select_case("serve", 4096, 16, 768, gen, dev, mask_kind="k", live=11,
                    timed=True),
        select_case("main_large", 256, 16, 768, gen, dev, mask_kind="k",
                    live=11, tilt_kind="bk", cfg=1),
        select_case("row_mask_survivor_inactive_large", 130, 11, 768, gen,
                    dev, mask_kind="bk", tilt_kind="bk", cfg=1),
        select_case("duplicate_arms_first_index_large", 256, 16, 768, gen,
                    dev, distinct=False, dup=True, cfg=1),
        select_case("k1_large", 64, 1, 768, gen, dev, cfg=1),
        # the paper examples' act: one query over the 11 models, d 142
        # (quickstart: 128 features, the ones and the metadata) and 128
        # (mixinstruct)
        select_case("examples_quickstart", 1, 11, 142, gen, dev,
                    timed=True),
        select_case("examples_mixinstruct", 1, 11, 128, gen, dev),
        # one rank's act in the router dry-run: K 10 arms at DIM 782, a
        # global batch of 65536 over 16 (2048 over 32) batch shards
        select_case("dryrun_16x16", 4096, 10, 782, gen, dev, timed=True),
        select_case("dryrun_2x16x16", 2048, 10, 782, gen, dev, timed=True),
    ]
    stamps.append(time.perf_counter())
    sg = [
        sgld_case("main", 8, 64, 16, 768, 4096, gen, dev, timed=True),
        sgld_case("main_j2", 8, 64, 16, 768, 4096, gen, dev, j=2),
        sgld_case("bench", 8, 1024, 1024, 768, 4096, gen, dev, timed=True),
        sgld_case("tied_maxima", 8, 64, 16, 768, 4096, gen, dev, ties=True),
        sgld_case("k1_ragged", 3, 37, 1, 100, 500, gen, dev),
        # one arm past the Small tile; duplicated arms tying across the
        # Large configuration's 256-arm tiles (150-299 copy 0-149), m not a
        # multiple of the rows per block
        sgld_case("k33_ragged", 3, 45, 33, 100, 500, gen, dev),
        sgld_case("ties_across_tiles", 3, 301, 300, 64, 500, gen, dev,
                  ties=True),
        sgld_case("ties_across_tiles_j2", 3, 301, 300, 64, 500, gen, dev,
                  ties=True, j=2),
        # the paper examples' SGLD step: one chain, a minibatch of 64 over
        # the 11 models, quickstart's 300-duel ring at d 142 and
        # mixinstruct's 380 at d 128
        sgld_case("examples_quickstart", 1, 64, 11, 142, 300, gen, dev,
                  timed=True),
        sgld_case("examples_mixinstruct", 1, 64, 11, 128, 380, gen, dev),
        # the router dry-run's refresh step: 16 chains, minibatch 256, K
        # 10 at DIM 782 over a 65536-duel replay ring
        sgld_case("dryrun", 16, 256, 10, 782, 65536, gen, dev, timed=True),
    ]
    stamps.append(time.perf_counter())
    sc = [
        score_case("main", 1, K_MAX, DIM, 16, gen, dev, posterior=True,
                   live=K_LIVE, timed=True),
        score_case("bench", 4096, 1024, DIM, 2, gen, dev, timed=True),
        score_case("k1_b1_j1", 1, 1, DIM, 1, gen, dev),
        score_case("j17_d100_ragged", 130, 37, 100, 17, gen, dev, dup=True,
                   zeros=True),
        score_case("posterior_duplicate_zero_arm", 1, K_MAX, DIM, 16, gen,
                   dev, posterior=True, dup=True, zeros=True),
        # the two sides of score_plan's cap on B*K*J*d (Small up to 2^27),
        # and Small with ragged d: 16-byte loads at d 100, 4-byte at d 98
        score_case("small_b170", 170, 1024, DIM, 1, gen, dev, dup=True,
                   zeros=True),
        score_case("large_b171", 171, 1024, DIM, 1, gen, dev, dup=True,
                   zeros=True),
        score_case("small_d100_dup_zero", 5, 37, 100, 3, gen, dev, dup=True,
                   zeros=True),
        score_case("small_d98_dup_zero", 5, 37, 98, 3, gen, dev, dup=True,
                   zeros=True),
    ]
    stamps.append(time.perf_counter())
    mx = [
        mixed_case("main", 8, 64, K_MAX, DIM, 4096, gen, dev, timed=True),
        mixed_case("bench", 8, 1024, 1024, DIM, 4096, gen, dev, timed=True),
        mixed_case("all_duels", 8, 64, K_MAX, DIM, 4096, gen, dev,
                   kind="duels"),
        mixed_case("all_clicks", 8, 64, K_MAX, DIM, 4096, gen, dev,
                   kind="clicks"),
        mixed_case("invalid_rows", 8, 64, K_MAX, DIM, 4096, gen, dev,
                   kind="invalid"),
        mixed_case("self_duels_ragged", 3, 37, 5, 100, 500, gen, dev,
                   kind="self"),
        # mixed_plan's edges: one row, fewer rows than a cluster's blocks,
        # rows per block no multiple of the group, one chain, and d 98 (the
        # 4-byte loads; d 100 above takes the 16-byte loads)
        mixed_case("m1", 8, 1, K_MAX, DIM, 4096, gen, dev),
        mixed_case("m3", 8, 3, K_MAX, DIM, 4096, gen, dev),
        mixed_case("m45", 8, 45, K_MAX, DIM, 4096, gen, dev),
        mixed_case("c1", 1, 64, K_MAX, DIM, 4096, gen, dev),
        mixed_case("d98_ragged", 3, 37, 5, 98, 500, gen, dev),
    ]
    stamps.append(time.perf_counter())
    at = attn_cases(gen, dev)
    stamps.append(time.perf_counter())
    atb = attn_bwd_cases(gen, dev)
    stamps.append(time.perf_counter())
    atb16 = attn_bwd_bf16_cases(gen, dev)
    stamps.append(time.perf_counter())
    # the plain backward at S 8192 reserved tens of GB: hand them back
    # before the paths, whose CUDA graph captures must not meet a full
    # cache (freeing cached blocks is not allowed while capturing)
    torch.cuda.empty_cache()
    ssd, rgl = scan_cases(gen, dev)
    stamps.append(time.perf_counter())
    rgb = rglru_bwd_cases(gen, dev)
    stamps.append(time.perf_counter())
    sbw = ssd_bwd_cases(gen, dev)
    stamps.append(time.perf_counter())
    torch.cuda.empty_cache()
    names = ("dueling_select", "sgld_potential", "dueling_score",
             "sgld_mixed", "flash_attention", "flash_attention_bwd",
             "flash_attention_bwd_bf16", "ssd_scan+rglru_scan",
             "rglru_scan_bwd", "ssd_scan_bwd")
    seconds = {n: b - a for n, a, b in zip(names, stamps, stamps[1:])}
    return sel, sg, sc, mx, at, atb, atb16, ssd, rgl, rgb, sbw, seconds


# ---------------------------------------------------------------------------
# phases 2 and 3: the slice
# ---------------------------------------------------------------------------

K_LIVE, K_MAX, DIM, BATCH, HORIZON = 11, 16, 768, 256, 4096
# the autopilot run: benchmarks/bench_autopilot.py:52-53's configuration,
# a dominated overpriced arm and one arrival
AP_KW = dict(every=3, tau=0.75, window=2, quota=0.25, budget=0.35,
             budget_lr=0.5)
BAD, ARRIVAL, ARRIVAL_TICK = 10, 11, 4


def slice_setup(seed, dev, t_total, dominated=False):
    """Synthetic CCFT world from ``seed``: category embeddings of offline
    queries, the arm table through ``ccft.model_embeddings``, a query
    stream and utilities. Built on the CPU and moved to ``dev``, so a card
    run and a CPU run see bitwise the same world. ``dominated`` halves arm
    BAD's skills (arm 0's, halved) and prices it at 10x the median live
    cost."""
    import numpy as np
    import torch
    from repro_torch.core import ccft, fgts, model_pool as mp, policy
    rng = np.random.default_rng(seed)
    n_cat, n_off = 12, 2048
    centers = rng.standard_normal((n_cat, DIM)).astype(np.float32)
    cats = rng.integers(0, n_cat, n_off)
    off = centers[cats] + 0.3 * rng.standard_normal((n_off, DIM))
    xi = ccft.category_embeddings(torch.tensor(off, dtype=torch.float32),
                                  torch.tensor(cats), n_cat)
    skill = rng.random((K_MAX, n_cat)).astype(np.float32)
    costs = np.linspace(0.1, 1.0, K_MAX).astype(np.float32)
    if dominated:
        skill[BAD] = 0.5 * skill[0]
        costs[BAD] = 10.0 * np.median(costs[:K_LIVE])
    a_emb = ccft.model_embeddings(xi, torch.tensor(skill),
                                  "excel_perf_cost").to(dev)
    q_cat = rng.integers(0, n_cat, t_total)
    x = centers[q_cat] + 0.3 * rng.standard_normal((t_total, DIM))
    utils = skill[:, q_cat].T + 0.05 * rng.standard_normal((t_total, K_MAX))
    pool = mp.init_pool(a_emb[:K_LIVE], costs[:K_LIVE], K_MAX, device=dev)
    pool = pool._replace(a_emb=a_emb.contiguous(),
                         costs=torch.tensor(costs, device=dev))
    cfg = fgts.FGTSConfig(n_models=K_MAX, dim=DIM, horizon=HORIZON, eta=8.0,
                          mu=0.2, sgld_steps=20, sgld_eps=5e-4,
                          sgld_minibatch=64, n_chains=8, force_distinct=True)
    from repro_torch.core import env
    envd = env.EnvData(torch.tensor(x, dtype=torch.float32, device=dev),
                       torch.tensor(utils, dtype=torch.float32, device=dev))
    return envd, pool, cfg, policy.fgts_policy(pool, cfg)


def energy_aux(cfg):
    from repro_torch.core import fgts

    def aux(state, a1, a2):
        pool = state.pool
        return fgts.chain_energy(state.inner, pool.a_emb, cfg,
                                 arm_mask=pool.active, costs=pool.costs)
    return aux


def phase_slice(dev, seed):
    import torch
    from repro_torch import kernels
    from repro_torch.core import env, model_pool as mp, regret
    from repro_torch.core.draws import TorchDraws
    envd, pool, cfg, pol = slice_setup(seed, dev, HORIZON)
    n_ticks = HORIZON // BATCH
    sched = mp.schedule([(n_ticks // 2, 3, None, None)], DIM, device=dev)
    grid = torch.tensor([0.0, 0.5, 2.0], device=dev)
    runs = {}
    for label, kw in (
            ("sync", dict()),
            ("delay2_pref", dict(delay=2, pref_fn=lambda s, xb: grid[
                (torch.arange(BATCH, device=dev) + s) % 3]))):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cum, state, energy = env.run(TorchDraws(seed, dev), envd, pol,
                                     batch=BATCH, pool_schedule=sched,
                                     aux_fn=energy_aux(cfg), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        check(all(counts[k] > 0 for k in SLICE_KERNELS),
              f"slice {label}: a kernel never launched: {counts}")
        check(bool(torch.isfinite(cum).all()) and cum.shape == (HORIZON,),
              f"slice {label}: regret curve not finite / wrong shape")
        check(bool(torch.isfinite(energy).all())
              and energy.shape == (n_ticks, 2, cfg.n_chains),
              f"slice {label}: chain energy not finite / wrong shape")
        check(not bool(state.pool.active[3]) and int(state.inner.t) > 0,
              f"slice {label}: retirement or ring fold missing")
        runs[label] = dict(
            final_regret=float(cum[-1]), slope_ratio=regret.slope_ratio(cum),
            queries_per_s=HORIZON / wall, ms_per_tick=1e3 * wall / n_ticks,
            ticks=n_ticks, launches=counts,
            final_energy_mean=float(energy[-1].mean()))
    runs["profile"] = profile_ticks(
        lambda n: env.run(TorchDraws(seed, dev), short_env(envd, n), pol,
                          batch=BATCH, pool_schedule=sched,
                          aux_fn=energy_aux(cfg)),
        runs["sync"]["ms_per_tick"], 2 * cfg.sgld_steps)
    return runs


def short_env(envd, ticks):
    from repro_torch.core import env
    return env.EnvData(envd.x[:ticks * BATCH], envd.utils[:ticks * BATCH])


def profile_ticks(run, ms_per_tick, sgld_steps=None, ticks=2, groups=None):
    """Device busy time and kernel launches per tick from ``torch.profiler``
    (device activity only) over ``run(ticks)``, a few ticks of a path's
    loop (or a few batches of the encoder, or steps of training). The idle
    share is taken against the path's unprofiled ms per tick, since the
    profiler slows the host. ``groups`` (name -> substrings of kernel
    names, first match wins, the rest "other") adds device ms per tick by
    group."""
    import torch
    from repro_torch import profiling
    torch.cuda.synchronize()
    with profiling.cuda_profile() as prof:
        t0 = time.perf_counter()
        run(ticks)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = sorted(profiling.kernel_events(prof), key=lambda e: -e[1])
    busy_ms = sum(us for _, us, _ in kern) / 1e3 / ticks
    launches = sum(n for _, _, n in kern) / ticks
    by_group = n_group = names = None
    if groups:
        by_group = dict.fromkeys([*groups, "other"], 0.0)
        n_group = dict.fromkeys([*groups, "other"], 0.0)
        names = {g: set() for g in (*groups, "other")}
        for key, us, n in kern:
            g = next((g for g, subs in groups.items()
                      if any(x in key for x in subs)), "other")
            by_group[g] += us / 1e3 / ticks
            n_group[g] += n / ticks
            names[g].add(key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0])
        names = {g: sorted(v) for g, v in names.items()}
    return dict(ticks=ticks, profiled_ms_per_tick=wall_ms / ticks,
                device_ms_per_tick_by_group=by_group,
                device_kernels_per_tick_by_group=n_group,
                kernel_names_by_group=names,
                unprofiled_ms_per_tick=ms_per_tick,
                device_busy_ms_per_tick=busy_ms,
                device_idle_share=1.0 - busy_ms / ms_per_tick,
                device_kernels_per_tick=launches,
                device_kernels_per_sgld_step=(launches / sgld_steps
                                              if sgld_steps else None),
                top_kernels_ms_per_tick=[[k[:60], us / 1e3 / ticks, n / ticks]
                                         for k, us, n in kern[:6]])


def replay_launches(run):
    """Kernel launches by wrapper over ``run()``, counted by
    ``torch.profiler``'s kernel names (``SERVE_GROUPS``: wrapper ->
    substrings of its kernels' names): a CUDA graph's replay makes no
    Python call, so the wrappers do not count it. The window is a whole
    one (``profiling.whole_profile``)."""
    from repro_torch import profiling
    kern = profiling.kernel_events(profiling.whole_profile(run))
    out = dict.fromkeys(SERVE_GROUPS, 0)
    for key, _, n in kern:
        g = next((g for g, subs in SERVE_GROUPS.items()
                  if any(x in key for x in subs)), None)
        if g is not None:
            out[g] += n
    return out


def autopilot_setup(seed, dev, t_total, every):
    from repro_torch import autopilot
    envd, pool, cfg, pol = slice_setup(seed, dev, t_total, dominated=True)
    ap_cfg = autopilot.AutopilotConfig(**dict(AP_KW, every=every))
    return envd, pool, cfg, autopilot.wrap(pol, ap_cfg)


def phase_autopilot(dev, seed):
    """The autopilot over the pooled FGTS policy at full width: arm BAD
    dominated and overpriced, slot ARRIVAL joining at ARRIVAL_TICK."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import env, model_pool as mp, regret
    from repro_torch.core.draws import TorchDraws
    envd, pool, cfg, pol = autopilot_setup(seed, dev, HORIZON,
                                           AP_KW["every"])
    n_ticks = HORIZON // BATCH
    sched = mp.schedule([(ARRIVAL_TICK, ARRIVAL, pool.a_emb[ARRIVAL],
                          float(pool.costs[ARRIVAL]))], DIM, device=dev)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cum, state, (a1, a2, active) = env.run(
        TorchDraws(seed, dev), envd, pol, batch=BATCH, pool_schedule=sched,
        aux_fn=lambda s, a1, a2: (a1, a2, mp.get_pool(s).active))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for k in ("dueling_score", "dueling_select", "sgld_potential_grad"):
        check(counts[k] > 0, f"autopilot: {k} never launched: {counts}")
    rows = torch.arange(n_ticks, device=dev)[:, None]
    check(bool(active[rows, a1.long()].all() and
               active[rows, a2.long()].all()),
          "autopilot: an arm was routed while inactive")
    check(bool(torch.isfinite(cum).all()) and cum.shape == (HORIZON,),
          "autopilot: regret curve not finite / wrong shape")
    off = (~active[:, BAD]).nonzero()
    ctrl, final = state.ctrl, mp.get_pool(state)
    ms_per_tick = 1e3 * wall / n_ticks
    prof = profile_ticks(
        lambda t: env.run(TorchDraws(seed, dev), short_env(envd, t), pol,
                          batch=BATCH, pool_schedule=sched),
        ms_per_tick, 2 * cfg.sgld_steps)
    if bool(ctrl.candidate[ARRIVAL]):
        fate = "candidate"
    elif bool(final.active[ARRIVAL]):
        fate = "promoted"
    else:
        fate = "rolled back"
    return dict(
        final_regret=float(cum[-1]), slope_ratio=regret.slope_ratio(cum),
        queries_per_s=HORIZON / wall, ms_per_tick=ms_per_tick,
        ticks=n_ticks, launches=counts, profile=prof,
        bad_arm_retired_at_tick=int(off[0, 0]) if off.numel() else None,
        final_lambda=float(ctrl.lam), final_cost_ema=float(ctrl.cost_ema),
        arrival_registered=bool(ctrl.known[ARRIVAL]), arrival_fate=fate,
        arrival_wins=float(ctrl.cand_wins[ARRIVAL]),
        arrival_duels=float(ctrl.cand_duels[ARRIVAL]),
        final_active=int(final.active.sum()))


def phase_mixed(dev, seed):
    """The mixed duel + click estimator at full width: act -> BTL feedback
    -> update -> a click on half of the batch's rows (a like when the
    answering arm beats the row's median utility) -> the energy trace."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import extensions, regret
    envd, pool, cfg, _ = slice_setup(seed, dev, HORIZON)
    pol = extensions.mixed_feedback_policy(pool, cfg)
    n_ticks, half = HORIZON // BATCH, BATCH // 2
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, energy, regrets = mixed_ticks(pol, envd, cfg, seed, dev, n_ticks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for k in ("sgld_mixed_fwd", "sgld_mixed_grad", "dueling_select"):
        check(counts[k] > 0, f"mixed: {k} never launched: {counts}")
    h, theta = state.inner
    energy = torch.stack(energy)
    cum = torch.cumsum(torch.stack(regrets).reshape(-1), dim=0)
    check(bool(torch.isfinite(theta).all()) and bool(
        torch.isfinite(energy).all()), "mixed: chains or energy not finite")
    check(int(h.t) == n_ticks * (BATCH + half), "mixed: ring count wrong")
    ms_per_tick = 1e3 * wall / n_ticks
    prof = profile_ticks(
        lambda t: mixed_ticks(pol, envd, cfg, seed, dev, t), ms_per_tick,
        cfg.sgld_steps)
    return dict(ms_per_tick=ms_per_tick, queries_per_s=HORIZON / wall,
                ticks=n_ticks, launches=counts, profile=prof,
                final_regret=float(cum[-1]),
                slope_ratio=regret.slope_ratio(cum),
                click_rows_in_ring=int((~h.is_duel).sum()),
                final_energy_mean=float(energy[-1].mean()))


def mixed_ticks(pol, envd, cfg, seed, dev, n_ticks):
    """``n_ticks`` ticks of the mixed path from a fresh state: (state,
    per-tick energies, per-tick regrets)."""
    import torch
    from repro_torch.core import btl, extensions, regret
    from repro_torch.core.draws import TorchDraws
    draws = TorchDraws(seed, dev)
    half = BATCH // 2
    rows = torch.arange(BATCH, device=dev)
    state = pol.init(draws)
    energy, regrets = [], []
    for s in range(n_ticks):
        k_act, k_fb = draws.split(2)
        xb = envd.x[s * BATCH:(s + 1) * BATCH]
        ub = envd.utils[s * BATCH:(s + 1) * BATCH]
        state, a1, a2 = pol.act(k_act, state, xb)
        y = btl.sample_preference(k_fb, envd.feedback_scale * ub[rows, a1.long()],
                                  envd.feedback_scale * ub[rows, a2.long()])
        state = pol.update(state, xb, a1, a2, y)
        like = ub[rows[:half], a1[:half].long()] \
            > ub[:half].median(dim=-1).values
        state = extensions.inject_clicks(state, xb[:half], a1[:half],
                                         like.float())
        energy.append(extensions.mixed_chain_energy(state.inner,
                                                    state.pool.a_emb, cfg))
        regrets.append(regret.instant_regret(ub, a1, a2,
                                             active=state.pool.active))
    return state, energy, regrets


def ccft_setup(seed, dev, t_online, params=None):
    """The CCFT embedding path's inputs from one CPU generator seeded with
    ``seed``: ``EncoderConfig()`` with random weights (or ``params``, the
    trained ones, moved to ``dev``), a RouterBench split
    (``CorpusConfig(seq_len=64)``, the encoder's max_len; 5 offline queries
    per benchmark; ``t_online`` online queries) and a MixInstruct dataset
    (``MixInstructConfig()``, 1200 queries). A card run and a CPU run get
    the same weights and tokens."""
    import torch
    from repro_torch.data import mixinstruct as mi, routerbench as rb, synth
    from repro_torch.encoder import EncoderConfig, init_encoder
    from repro_torch.models.layers import tree_map
    enc_cfg = EncoderConfig()
    corpus = synth.CorpusConfig(seq_len=enc_cfg.max_len)
    gen = torch.Generator().manual_seed(seed)
    init = init_encoder(gen, enc_cfg, device=dev)
    if params is not None:
        init = tree_map(lambda w: w.to(dev), params)
    split = rb.make_split(gen, corpus, t_online=t_online, device=dev)
    data = mi.make_dataset(gen, corpus, mi.MixInstructConfig(), device=dev)
    return enc_cfg, init, split, data


# encoder training at the paper benchmarks' counts
# (``benchmarks/common.py:63-70``): 150 generic steps, then 4 epochs of 40
# CCFT steps, 64 pairs a step
PRETRAIN_STEPS, FT_EPOCHS, FT_STEPS, PAIRS = 150, 4, 40, 64
# a training step's device time by kernel family (profiler kernel names;
# "bwd_kv_kernel" and "bwd_q_kernel" also match the bf16 Hopper design's
# bwd_kv_kernel_sm90 and bwd_q_kernel_sm90)
STEP_GROUPS = {
    "attention_fwd": ("flash_attention_kernel",),
    "attention_bwd": ("bwd_kv_kernel", "bwd_q_kernel", "bwd_reduce_kernel",
                      "delta_kernel"),
    "gemm": ("gemm", "Kernel2<cutlass"),
    "reduce": ("reduce_kernel",),
    "elementwise": ("elementwise", "foreach", "index", "scatter", "gather",
                    "cat", "copy", "fill"),
}


def phase_train(dev, seed):
    """The CCFT encoder's training on the card at ``EncoderConfig()``
    width: ``pretrain_generic`` (150 steps of 64 pairs over 840 unlabelled
    queries of ``CorpusConfig(seq_len=64)``), then ``finetune_categorical``
    (4 x 40 steps) on the RouterBench split's 35 offline queries, the data
    the ccft path then embeds. Each run has the launch counts reset just
    before it and read just after: every step must launch
    ``flash_attention`` and ``flash_attention_bwd`` once per layer per
    encode (8 each). ms per step on the host clock (synchronised); device
    ms per step, the idle share and the kernels per step from 2 profiled
    steps. Losses must be finite, and the category silhouette of 56 held-out
    queries must rise through fine-tuning. Returns (record, the fine-tuned
    parameters)."""
    import torch
    from repro_torch import kernels
    from repro_torch.contrastive import finetune as ft
    from repro_torch.core.draws import TorchDraws
    from repro_torch.data import synth
    from repro_torch.kernels import flash_attention as fa
    enc_cfg, params0, split, _ = ccft_setup(seed, dev, HORIZON)
    corpus = synth.CorpusConfig(seq_len=enc_cfg.max_len)
    gen = torch.Generator().manual_seed(seed + 1)
    pt_tok, pt_mask, _ = synth.make_split(gen, 120, corpus, dev)
    ev = synth.make_split(gen, 8, corpus, dev)
    off = (split.offline_tokens, split.offline_mask, split.offline_cats)
    sil = {"init": ft.category_silhouette(params0, enc_cfg, *ev)}
    n_layers = enc_cfg.n_layers

    def counted(run, steps):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / steps
        counts = kernels.launch_counts()
        for k in ("flash_attention", "flash_attention_bwd"):
            check(counts[k] == 2 * n_layers * steps,
                  f"train: {counts[k]} {k} launches in {steps} steps of "
                  f"2 x {n_layers} layers")
        return result, ms, counts

    # one uncounted step first (the first backward's one-time costs)
    ft.pretrain_generic(TorchDraws(seed, dev), params0, pt_tok, pt_mask,
                        enc_cfg, steps=1, batch=PAIRS)
    (params_pt, pt_losses), pt_ms, pt_counts = counted(
        lambda: ft.pretrain_generic(TorchDraws(seed, dev), params0, pt_tok,
                                    pt_mask, enc_cfg, steps=PRETRAIN_STEPS,
                                    batch=PAIRS), PRETRAIN_STEPS)
    sil["pretrained"] = ft.category_silhouette(params_pt, enc_cfg, *ev)
    (params_ft, ft_losses), ft_ms, ft_counts = counted(
        lambda: ft.finetune_categorical(TorchDraws(seed + 2, dev), params_pt,
                                        *off, enc_cfg, epochs=FT_EPOCHS,
                                        steps_per_epoch=FT_STEPS,
                                        batch=PAIRS), FT_EPOCHS * FT_STEPS)
    sil["finetuned"] = ft.category_silhouette(params_ft, enc_cfg, *ev)
    losses = pt_losses + ft_losses
    check(all(math.isfinite(x) for x in losses),
          f"train: non-finite losses {losses}")
    check(sil["finetuned"] > sil["pretrained"],
          f"train: fine-tuning did not raise the category silhouette "
          f"{sil}")
    for name, w in zip(*_named_leaves(params_ft)):
        check(bool(torch.isfinite(w).all()), f"train: non-finite {name}")
    prof = profile_ticks(
        lambda n: ft.pretrain_generic(TorchDraws(seed, dev), params_pt,
                                      pt_tok, pt_mask, enc_cfg, steps=n,
                                      batch=PAIRS), pt_ms, groups=STEP_GROUPS)
    # the backward's kernels per call, by profiler name, against its plan
    # at the step's shape (2 profiled steps of 2 x n_layers calls)
    bwd_plan = fa.bwd_plan(PAIRS, enc_cfg.n_heads, enc_cfg.n_heads,
                           enc_cfg.max_len, enc_cfg.max_len,
                           enc_cfg.d_model // enc_cfg.n_heads, False, 0)
    bwd_kernels = (prof["device_kernels_per_tick_by_group"]["attention_bwd"]
                   / (2 * n_layers))
    check(bwd_kernels == bwd_plan.launches,
          f"train: {bwd_kernels} backward kernels a call, the plan "
          f"{bwd_plan} launches {bwd_plan.launches}")
    steps = PRETRAIN_STEPS + FT_EPOCHS * FT_STEPS
    launches = {k: pt_counts[k] + ft_counts[k] for k in pt_counts}
    record = dict(
        config=dict(d_model=enc_cfg.d_model, n_layers=n_layers,
                    n_heads=enc_cfg.n_heads, d_ff=enc_cfg.d_ff,
                    max_len=enc_cfg.max_len, vocab=enc_cfg.vocab_size),
        pairs_per_step=PAIRS, pretrain_steps=PRETRAIN_STEPS,
        finetune_steps=FT_EPOCHS * FT_STEPS, pretrain_ms_per_step=pt_ms,
        finetune_ms_per_step=ft_ms, pretrain_losses=pt_losses,
        finetune_losses=ft_losses, silhouette=sil, launches=launches,
        launches_per_step={k: launches[k] / steps for k in
                           ("flash_attention", "flash_attention_bwd")},
        bwd_plan=bwd_plan._asdict(), bwd_kernels_per_call=bwd_kernels,
        profile=prof)
    return record, params_ft


def _named_leaves(params):
    from repro_torch.models.layers import tree_leaves

    def names(t, pre=""):
        if not isinstance(t, dict):
            return [pre]
        return [n for k in sorted(t) for n in names(t[k], f"{pre}/{k}")]
    return names(params), tree_leaves(params)


def phase_train_card_vs_cpu(dev, seed, params):
    """One ``train_step`` on the card and on the CPU from the same (trained)
    parameters on the same pair batch (``HostDraws``: 64 category pairs of
    the RouterBench offline split): the loss to rtol 1e-5 and every
    gradient leaf to 1e-4 of its largest magnitude on the CPU."""
    import torch
    from repro_torch.contrastive import finetune as ft
    from repro_torch.core.draws import HostDraws
    from repro_torch.optim import adamw_init

    def run(where):
        enc_cfg, p, split, _ = ccft_setup(seed, where, BATCH, params)
        batch = ft.make_category_pairs(
            HostDraws(seed), split.offline_tokens, split.offline_mask,
            split.offline_cats, PAIRS)
        loss, grads = ft.loss_and_grads(p, batch, enc_cfg)
        _, _, step_loss = ft.train_step(p, adamw_init(p), batch, enc_cfg,
                                        2e-3)
        return (float(loss), float(step_loss),
                [g.cpu() for g in _named_leaves(grads)[1]])
    g_loss, g_step, g_grads = run(dev)
    c_loss, c_step, c_grads = run(torch.device("cpu"))
    for a, b in ((g_loss, c_loss), (g_step, c_step)):
        check(abs(a - b) <= 1e-5 * abs(b),
              f"train card vs cpu: loss {a} against {b}")
    worst, worst_leaf = 0.0, None
    for name, g, c in zip(_named_leaves(params)[0], g_grads, c_grads):
        top = float(c.abs().max())
        rel = float((g - c).abs().max()) / max(top, 1e-30)
        check(rel <= 1e-4, f"train card vs cpu: gradient {name} off by "
                           f"{rel} of its max")
        if rel > worst:
            worst, worst_leaf = rel, name
    return dict(pairs=PAIRS, loss_card=g_loss, loss_cpu=c_loss,
                loss_rel_err=abs(g_loss - c_loss) / abs(c_loss),
                step_loss_card=g_step, step_loss_cpu=c_step,
                max_rel_grad_err=worst, worst_leaf=worst_leaf)


def ccft_fgts_cfg(dim):
    """The paper-run FGTS settings (``benchmarks/common.py:79-86``) with the
    phase-2 chains, over the 11 RouterBench / MixInstruct LLMs."""
    from repro_torch.core import fgts
    return fgts.FGTSConfig(n_models=11, dim=dim, horizon=HORIZON, eta=8.0,
                           mu=0.2, sgld_steps=20, sgld_eps=5e-4,
                           sgld_minibatch=64, n_chains=8, force_distinct=True)


def routerbench_embeddings(enc_cfg, params, split):
    """The four weightings' model embeddings (metadata appended) and the
    RouterBench env (online queries, ones appended)."""
    from repro_torch.core import ccft
    from repro_torch.data import pipeline
    embs = {w: pipeline.routerbench_model_embeddings(params, enc_cfg, split,
                                                     w)
            for w in ccft.WEIGHTINGS}
    return embs, pipeline.routerbench_env(params, enc_cfg, split)


def phase_ccft(dev, seed, params):
    """The CCFT embedding path at ``EncoderConfig()`` width over the
    encoder ``phase_train`` fine-tuned: query tokens -> encoder (attention
    on the flash kernel) -> model and query embeddings -> ``env.run`` over
    FGTS.CDB, for RouterBench (routing over the excel_perf_cost
    embeddings, d = 256 + 14) and for MixInstruct (eq. 6 embeddings,
    d = 256). Each is one run with the launch counts reset just before it
    and read just after."""
    import torch
    from repro_torch import kernels
    from repro_torch.core import env, policy, regret
    from repro_torch.core.draws import TorchDraws
    from repro_torch.data import pipeline
    enc_cfg, params, split, data = ccft_setup(seed, dev, HORIZON, params)
    eb = pipeline.ENCODE_BATCH
    n_batches = HORIZON // eb

    def encode_online(n):
        return pipeline._batched_encode(params, split.online_tokens[:n * eb],
                                        split.online_mask[:n * eb], enc_cfg)
    encode_online(1)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_alone = encode_online(n_batches)
    torch.cuda.synchronize()
    enc_ms = 1e3 * (time.perf_counter() - t0) / n_batches
    enc_prof = profile_ticks(encode_online, enc_ms)

    out = {}
    for name in ("routerbench", "mixinstruct"):
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "routerbench":
            embs, envd = routerbench_embeddings(enc_cfg, params, split)
            a = embs["excel_perf_cost"]
            n_encoded = [split.offline_tokens.shape[0]] * len(embs) + [
                split.online_tokens.shape[0]]
            n_meta = 2 * len(split.benchmarks)
        else:
            envd, a = pipeline.mixinstruct_env_and_embeddings(
                params, enc_cfg, data)
            embs = {"label_proportion": a}
            n_encoded, n_meta = [data["tokens"].shape[0]], 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cfg = ccft_fgts_cfg(a.shape[1])
        pol = policy.fgts_policy(a, cfg)
        cum, _ = env.run(TorchDraws(seed, dev), envd, pol, batch=BATCH)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = kernels.launch_counts()
        batches = sum(-(-q // eb) for q in n_encoded)
        check(counts["flash_attention"] == enc_cfg.n_layers * batches,
              f"ccft {name}: {counts['flash_attention']} attention launches "
              f"for {batches} encode batches of {enc_cfg.n_layers} layers")
        for k in ("dueling_select", "sgld_potential_grad"):
            check(counts[k] > 0, f"ccft {name}: {k} never launched: {counts}")
        d = enc_cfg.d_model + n_meta
        for w, e in embs.items():
            check(e.shape == (11, d) and bool(torch.isfinite(e).all()),
                  f"ccft {name}: {w} embeddings {tuple(e.shape)} / not finite")
        x = envd.x
        norms = torch.linalg.vector_norm(x[:, :enc_cfg.d_model], dim=-1)
        check(bool(torch.isfinite(x).all()) and x.shape[1] == d and bool(
            ((norms - 1.0).abs() < 1e-4).all()),
            f"ccft {name}: query embeddings not unit-norm / wrong shape")
        if n_meta:
            check(bool((x[:, enc_cfg.d_model:] == 1.0).all()),
                  f"ccft {name}: metadata slots of x are not ones")
            check(float((x[:, :enc_cfg.d_model] - x_alone).abs().max())
                  <= 1e-6, f"ccft {name}: encode is not repeatable")
        n_ticks = x.shape[0] // BATCH
        check(bool(torch.isfinite(cum).all())
              and cum.shape == (n_ticks * BATCH,),
              f"ccft {name}: regret curve not finite / wrong shape")
        ms_per_tick = 1e3 * (t2 - t1) / n_ticks
        out[name] = dict(
            queries_encoded=sum(n_encoded), encode_batches=batches,
            pipeline_s=t1 - t0, ticks=n_ticks, ms_per_tick=ms_per_tick,
            queries_per_s=n_ticks * BATCH / (t2 - t1), dim=d,
            final_regret=float(cum[-1]), slope_ratio=regret.slope_ratio(cum),
            launches=counts,
            flash_launches_per_encode_batch=counts["flash_attention"]
            / batches)
        if name == "routerbench":
            out[name]["profile"] = profile_ticks(
                lambda t: env.run(TorchDraws(seed, dev), short_env(envd, t),
                                  pol, batch=BATCH),
                ms_per_tick, 2 * cfg.sgld_steps)
    out["encode"] = dict(batch=eb, ms_per_batch=enc_ms,
                         queries_per_s=1e3 * eb / enc_ms, profile=enc_prof)
    return out


def phase_ccft_card_vs_cpu(dev, seed, params):
    """The CCFT path on the card and on the CPU from the same (fine-tuned)
    weights and tokens: every embedding (the four weightings' model
    embeddings, the RouterBench queries, the MixInstruct queries and eq. 6
    embeddings) to atol 1e-5; then 4 RouterBench ticks of ``env.run`` from one HostDraws
    set: pairs equal outside near-ties, final chains to rtol 1e-4."""
    import torch
    from repro_torch.core import env, policy
    from repro_torch.core.draws import HostDraws
    from repro_torch.data import pipeline
    ticks = 4

    def run(where):
        enc_cfg, p, split, data = ccft_setup(seed, where, BATCH * ticks,
                                             params)
        embs, envd = routerbench_embeddings(enc_cfg, p, split)
        menv, m_a = pipeline.mixinstruct_env_and_embeddings(p, enc_cfg, data)
        pol = policy.fgts_policy(embs["excel_perf_cost"],
                                 ccft_fgts_cfg(envd.x.shape[1]))

        def aux(state, a1, a2):
            return (a1, a2, state.theta1.mean(0), state.theta2.mean(0))
        _, state, trace = env.run(HostDraws(seed), envd, pol, batch=BATCH,
                                  aux_fn=aux)
        named = dict({f"a_{w}": e for w, e in embs.items()},
                     routerbench_x=envd.x, mixinstruct_x=menv.x,
                     mixinstruct_a=m_a)
        return named, envd, state, trace
    g_emb, _, g_state, g_trace = run(dev)
    c_emb, envd, c_state, (c1, c2, th1, th2) = run(torch.device("cpu"))
    errs = {}
    for k, c in c_emb.items():
        errs[k] = float((g_emb[k].cpu() - c).abs().max())
        check(errs[k] <= 1e-5, f"ccft card vs cpu: {k} differs by {errs[k]}")
    a = c_emb["a_excel_perf_cost"]
    bad = ties = 0
    for s in range(ticks):
        x = envd.x[s * BATCH:(s + 1) * BATCH]
        b, t_, _ = compare_pairs(
            x, a, torch.stack([th1[s], th2[s]]), None, None, True,
            (g_trace[0][s].cpu(), g_trace[1][s].cpu()), (c1[s], c2[s]))
        bad, ties = bad + b, ties + t_
    check(bad == 0, f"ccft card vs cpu: {bad} pair mismatches outside "
                    f"near-ties")
    for f in ("theta1", "theta2"):
        gc, cc = getattr(g_state, f).cpu(), getattr(c_state, f)
        err = (gc - cc).abs()
        errs[f] = float(err.max())
        check(bool((err <= 1e-5 + 1e-4 * cc.abs()).all()),
              f"ccft card vs cpu: {f} differs by {errs[f]}")
    return dict(ticks=ticks, pair_mismatches=bad, near_ties=ties,
                max_abs_err=errs)


def gate_logged_draws(seed, log):
    """A ``HostDraws`` that also appends each (BATCH,) uniform it hands out
    to ``log``. The first of a tick is the autopilot's quota gate (the
    first draw of its act); the BTL uniforms follow."""
    from repro_torch.core.draws import HostDraws

    class Logged(HostDraws):
        def uniform(self, shape, device):
            v = super().uniform(shape, device)
            if tuple(shape) == (BATCH,):
                log.append(v.cpu())
            return v
    return Logged(seed)


CTRL_TRACE = ("candidate", "cand_wins", "cand_duels", "dominated_ticks")


def phase_autopilot_card_vs_cpu(dev, seed):
    """4 autopilot ticks (a control tick every 2 acts) on the card and on
    the CPU from one HostDraws set. Slot ARRIVAL joins at tick 1, so from
    the second act on a candidate is live: the quota gate masks it out of
    ungated rows, its resolved duels fold into the candidate counters, and
    the control tick at act 4 may promote or roll it back. Pairs are held
    against the plain scores under each row's own mask (from the logged
    gate); the controller's fields after every tick are held exactly."""
    import torch
    from repro_torch.core import env, model_pool as mp
    ticks, arrival_tick = 4, 1

    def run(where):
        envd, pool, _, pol = autopilot_setup(seed, where, BATCH * ticks, 2)
        sched = mp.schedule([(arrival_tick, ARRIVAL, pool.a_emb[ARRIVAL],
                              float(pool.costs[ARRIVAL]))], DIM, device=where)
        log, gates = [], []

        def aux(state, a1, a2):
            gates.append(log[0])
            log.clear()
            inner, ctrl = state.inner.inner, state.ctrl
            return (a1, a2, inner.theta1.mean(0), inner.theta2.mean(0),
                    mp.get_pool(state).active, ctrl.lam,
                    *(getattr(ctrl, f) for f in CTRL_TRACE))
        _, state, trace = env.run(gate_logged_draws(seed, log), envd, pol,
                                  batch=BATCH, pool_schedule=sched,
                                  aux_fn=aux)
        return envd, pool, state, trace, torch.stack(gates)
    _, _, card_state, g_trace, g_gate = run(dev)
    envd, pool, cpu_state, c_trace, gate = run(torch.device("cpu"))
    (g1, g2), (c1, c2, th1, th2, act, lam) = g_trace[:2], c_trace[:6]
    cand = c_trace[6]
    check(torch.equal(g_gate, gate), "autopilot card vs cpu: gate draws differ")
    check(bool(cand[arrival_tick:, ARRIVAL].any()) and not bool(
        cand[:arrival_tick].any()),
        "autopilot card vs cpu: the arrival never became a candidate")
    quota = AP_KW["quota"]
    rows = torch.arange(BATCH)
    bad = ties = cand_rows = 0
    for s in range(ticks):
        x = envd.x[s * BATCH:(s + 1) * BATCH]
        has_full = bool((act[s] & ~cand[s]).any())
        mask = ((gate[s] < quota)[:, None] | ~cand[s][None, :]
                | (not has_full)) & act[s][None, :]
        check(bool(mask[rows, c1[s].long()].all()
                   and mask[rows, c2[s].long()].all()),
              f"autopilot: tick {s} routed an arm outside its row's mask")
        b, t_, _ = compare_pairs(
            x, pool.a_emb, torch.stack([th1[s], th2[s]]), lam[s] * pool.costs,
            mask, True, (g1[s].cpu(), g2[s].cpu()), (c1[s], c2[s]))
        bad, ties = bad + b, ties + t_
        cand_rows += int((cand[s][c1[s].long()]
                          | cand[s][c2[s].long()]).sum())
    check(bad == 0, f"autopilot card vs cpu: {bad} pair mismatches outside "
                    f"near-ties")
    check(cand_rows > 0, "autopilot card vs cpu: the candidate never duelled")
    for f, g, c in zip(CTRL_TRACE, g_trace[6:], c_trace[6:]):
        check(torch.equal(g.cpu(), c),
              f"autopilot card vs cpu: ctrl.{f} differs in some tick")
    gc, cc = card_state.ctrl, cpu_state.ctrl
    for f in ("known", "tick"):
        check(torch.equal(getattr(gc, f).cpu(), getattr(cc, f)),
              f"autopilot card vs cpu: ctrl.{f} differs")
    check(torch.equal(mp.get_pool(card_state).active.cpu(),
                      mp.get_pool(cpu_state).active),
          "autopilot card vs cpu: pool membership differs")
    errs = {}
    for f in ("lam", "cost_ema"):
        g, c = float(getattr(gc, f)), float(getattr(cc, f))
        errs[f] = abs(g - c)
        check(errs[f] <= 1e-5 * abs(c) + 1e-7,
              f"autopilot card vs cpu: {f} {g} vs {c}")
    final = mp.get_pool(cpu_state)
    if bool(cc.candidate[ARRIVAL]):
        fate = "candidate"
    elif bool(final.active[ARRIVAL]):
        fate = "promoted"
    else:
        fate = "rolled back"
    return dict(ticks=ticks, pair_mismatches=bad, near_ties=ties,
                ctrl_abs_err=errs, final_lambda=float(cc.lam),
                dominated_ticks=cc.dominated_ticks.tolist(),
                rows_gated=int((gate < quota).sum()),
                rows_with_candidate=cand_rows, arrival_fate=fate,
                arrival_wins_per_tick=c_trace[7][:, ARRIVAL].tolist(),
                arrival_duels_per_tick=c_trace[8][:, ARRIVAL].tolist(),
                final_active=int(final.active.sum()))


def phase_card_vs_cpu(dev, seed):
    import torch
    from repro_torch.core import env
    from repro_torch.core.draws import HostDraws
    ticks = 4
    out = {}
    for where in (dev, torch.device("cpu")):
        envd, pool, cfg, pol = slice_setup(seed, where, BATCH * ticks)

        def aux(state, a1, a2):
            return (a1, a2, state.inner.theta1.mean(0),
                    state.inner.theta2.mean(0))
        _, state, trace = env.run(HostDraws(seed), envd, pol, batch=BATCH,
                                  aux_fn=aux)
        out[where.type] = (envd, pool, state, trace)
    envd, pool, cpu_state, (c1, c2, th1, th2) = out["cpu"]
    _, _, card_state, (g1, g2, _, _) = out["cuda"]
    bad = ties = 0
    for s in range(ticks):
        x = envd.x[s * BATCH:(s + 1) * BATCH]
        b, t_, e = compare_pairs(
            x, pool.a_emb, torch.stack([th1[s], th2[s]]), None, pool.active,
            True, (g1[s].cpu(), g2[s].cpu()), (c1[s], c2[s]))
        bad, ties = bad + b, ties + t_
    check(bad == 0, f"card vs cpu: {bad} pair mismatches outside near-ties")
    errs = {}
    for f in ("theta1", "theta2"):
        gc = getattr(card_state.inner, f).cpu()
        cc = getattr(cpu_state.inner, f)
        err = (gc - cc).abs()
        errs[f] = float(err.max())
        check(bool((err <= 1e-5 + 1e-4 * cc.abs()).all()),
              f"card vs cpu: {f} differs by {errs[f]}")
    return dict(ticks=ticks, pair_mismatches=bad, near_ties=ties,
                theta_max_abs_err=errs)


# ---------------------------------------------------------------------------
# phases 2 and 3: the routing service
# ---------------------------------------------------------------------------

# RouterService at the slice's width: 16 ticks of B 256, votes SERVE_DELAY
# ticks late (shuffled, SERVE_DUP duplicated, SERVE_LOST never sent), BAD
# retired and ARRIVAL added at SWAP_TICK, a checkpoint at SAVE_TICK restored
# into a fresh service that must route the next RESTORE_TICKS bitwise alike
SERVE_TICKS, SERVE_AP_TICKS, SERVE_CAP, SERVE_EXPIRY = 16, 8, 4096, 8
SERVE_DELAY, SERVE_DUP, SERVE_LOST = 2, 13, 13      # 13 of 256 ~ 5%
SWAP_TICK, SAVE_TICK, RESTORE_TICKS = 6, 8, 2
# an act's device time by kernel family (profiler kernel names)
SERVE_GROUPS = {
    "sgld_potential_grad": ("fgts_kernel",),
    "dueling_select": ("select_small", "select_large"),
    "dueling_score": ("dueling_score",),
}


def serve_setup(seed, dev, draws, params=None, autopilot=False,
                t_total=HORIZON + BATCH, mesh=None, **cfg_kw):
    """A ``RouterService`` over the synthetic CCFT world of ``slice_setup``
    (11 live arms in 16 slots, d 768; the dominated world under the
    autopilot), with ``t_total`` queries: the stream, then the last 256
    as an offline split for the arrival's warm start. ``cfg_kw`` go to
    ``RouterServiceConfig`` (``buckets``, ``policy_factory``). Returns
    (svc, envd, pool, cfg, entries of the live arms and the arrival)."""
    from repro_torch import autopilot as ap
    from repro_torch.data.pool import PoolEntry, build_entries
    from repro_torch.encoder import EncoderConfig
    from repro_torch.serving import RouterService, RouterServiceConfig
    envd, pool, cfg, _ = slice_setup(seed, dev, t_total,
                                     dominated=autopilot)
    entries = build_entries([f"arm{i}" for i in range(K_LIVE)],
                            pool.a_emb[:K_LIVE], pool.costs[:K_LIVE].tolist())
    arrival = PoolEntry("arrival", "arrival",
                        float(pool.costs[ARRIVAL]),
                        pool.a_emb[ARRIVAL].cpu().numpy())
    scfg = RouterServiceConfig(
        fgts=cfg, k_max=K_MAX, seed=seed, feedback_capacity=SERVE_CAP,
        feedback_expiry=SERVE_EXPIRY,
        autopilot=(ap.AutopilotConfig(**AP_KW) if autopilot else None),
        **cfg_kw)
    svc = RouterService(entries, params, EncoderConfig(), scfg, device=dev,
                        draws=draws, mesh=mesh)
    return svc, envd, pool, cfg, entries + [arrival]


def no_sync(what):
    """``torch.cuda.set_sync_debug_mode("error")`` around a call: any
    host sync inside it raises, and fails the phase naming ``what``."""
    import contextlib
    import torch

    @contextlib.contextmanager
    def guard():
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield
        except RuntimeError as e:
            raise CheckFailed(f"serve: {what} synchronised with the card: "
                              f"{e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return guard()


def serve_votes(src, s, u, a1, a2):
    """BTL votes of tick ``s`` made on the device (no sync), on the
    launcher's 8x utility scale."""
    import torch
    from repro_torch.core.btl import sample_preference
    rows = torch.arange(a1.shape[0], device=a1.device)
    return sample_preference(src.fold_in(s), 8.0 * u[rows, a1.long()],
                             8.0 * u[rows, a2.long()])


def late_delivery(src, s, tickets, y):
    """The votes of a batch as they come back: shuffled, the last
    SERVE_LOST of the shuffle never sent, the first SERVE_DUP sent twice;
    fixed shapes, index math on the device."""
    import torch
    b = tickets.shape[0]
    perm = torch.argsort(src.fold_in(10_000 + s).uniform((b,),
                                                         tickets.device))
    idx = torch.cat([perm[:b - SERVE_LOST], perm[:SERVE_DUP]])
    return tickets[idx], y[idx]


def phase_serve(dev, seed, params):
    """``RouterService``'s tick-batch path on the card (see the module
    docstring): the launch counts over the main run (the restored
    service's ticks included), exact fold / expiry / pending counts,
    bitwise restore, no host sync inside ``route_batch`` and
    ``feedback_batch``, ``embed`` equal to ``encode``, then 8 ticks under
    the autopilot. Host ms per call, device ms per act by kernel family
    and the idle share from 2 profiled ticks."""
    import shutil
    import torch
    from repro_torch import kernels
    from repro_torch.core import model_pool as mp
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.data import synth
    from repro_torch.encoder import encode
    fb = KeyedDraws(seed + 101)                   # votes and delivery order
    svc, envd, pool, cfg, entries = serve_setup(seed, dev, None, params)
    grid = torch.tensor([0.0, 0.5, 2.0], device=dev)
    x_off, u_off = envd.x[HORIZON:], envd.utils[HORIZON:]
    ckpt = Path(__file__).resolve().parent / "build" / "serve_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    issued, regrets, n_oks, expired = {}, [], [], 0
    route_ms, feedback_ms, tick_ms, restored = [], [], [], {}
    steady = []          # ticks with no control-plane event and no twin
    twin = None
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    for s in range(SERVE_TICKS):
        t_tick = time.perf_counter()
        if s == SWAP_TICK:
            svc.retire_model(BAD)
            slot = svc.add_model(entries[-1], replay=mp.warm_start_duels(
                KeyedDraws(seed + 7), x_off, u_off, ARRIVAL,
                svc.active_mask(), feedback_scale=8.0))
            check(slot == ARRIVAL, f"serve: the arrival took slot {slot}")
        if s == SAVE_TICK:
            svc.save(str(ckpt))
            twin = serve_setup(seed, dev, None, params)[0]
            twin.restore(str(ckpt))
            check(twin.tick == svc.tick and twin._draws.key == svc._draws.key
                  and twin._ever_used == svc._ever_used,
                  "serve: the restored service's clock, key or slots differ")
        x = envd.x[s * BATCH:(s + 1) * BATCH]
        u = envd.utils[s * BATCH:(s + 1) * BATCH]
        prefs = grid[(torch.arange(BATCH, device=dev) + s) % 3]
        t0 = time.perf_counter()
        with no_sync("route_batch"):
            a1, a2, tk = svc.route_batch(x, prefs=prefs)
        route_ms.append(1e3 * (time.perf_counter() - t0))
        y = serve_votes(fb, s, u, a1, a2)
        issued[s] = (tk, y)
        act = mp.get_pool(svc.state).active
        best = torch.where(act[None, :], u, -torch.inf).amax(-1)
        rows = torch.arange(BATCH, device=dev)
        regrets.append(torch.mean(best - 0.5 * (u[rows, a1.long()]
                                                + u[rows, a2.long()])))
        live = twin is not None and s < SAVE_TICK + RESTORE_TICKS
        if live:
            with no_sync("route_batch (restored)"):
                restored[s] = (a1, a2, tk, *twin.route_batch(x, prefs=prefs))
        if s >= SERVE_DELAY:
            tk_d, y_d = late_delivery(fb, s, *issued.pop(s - SERVE_DELAY))
            t0 = time.perf_counter()
            with no_sync("feedback_batch"):
                n_ok = svc.feedback_batch(tk_d, y_d)
            feedback_ms.append(1e3 * (time.perf_counter() - t0))
            n_oks.append(n_ok)
            if live:
                with no_sync("feedback_batch (restored)"):
                    restored[s] += (n_ok, twin.feedback_batch(tk_d, y_d))
        expired += svc.expire_pending()
        if live:
            twin.expire_pending()
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t_tick))
        if s > 0 and s not in (SWAP_TICK, SAVE_TICK) and not live:
            steady.append(tick_ms[-1])
    wall = time.perf_counter() - t_run
    counts = kernels.launch_counts()
    shutil.rmtree(ckpt, ignore_errors=True)
    del twin
    acts = SERVE_TICKS + RESTORE_TICKS
    check(counts["dueling_select"] == acts
          and counts["sgld_potential_grad"] == 2 * cfg.sgld_steps * acts
          and counts["dueling_score"] == 0,
          f"serve: launch counts {counts} over {acts} acts")
    check(sorted(restored) == [SAVE_TICK + i for i in range(RESTORE_TICKS)],
          "serve: the restored service did not run its ticks")
    for s, (a1, a2, tk, b1, b2, tb, n1, n2) in restored.items():
        check(torch.equal(a1, b1) and torch.equal(a2, b2)
              and torch.equal(tk, tb) and torch.equal(n1, n2),
              f"serve: tick {s} after the restore routes differently")
    folded = [int(n) for n in n_oks]
    n_late = SERVE_TICKS - SERVE_DELAY
    check(folded == [BATCH - SERVE_LOST] * n_late,
          f"serve: folded counts {folded}")
    stats = svc.service_stats()
    # never-sent votes age out after SERVE_EXPIRY ticks; the last
    # SERVE_DELAY batches are still in flight
    n_exp = SERVE_LOST * max(SERVE_TICKS - 1 - SERVE_EXPIRY, 0)
    check(expired == n_exp, f"serve: {expired} duels expired, not {n_exp}")
    pending = SERVE_LOST * (n_late - n_exp // SERVE_LOST) \
        + BATCH * SERVE_DELAY
    check(stats["n_routed"] == SERVE_TICKS * BATCH
          and stats["n_folded"] == sum(folded)
          and stats["pending"] == pending,
          f"serve: service_stats {stats}, {pending} pending expected")
    reg = torch.stack(regrets).tolist()
    check(all(math.isfinite(r) for r in reg), "serve: regret not finite")
    active = svc.active_mask()
    check(not active[BAD] and active[ARRIVAL]
          and int(active.sum()) == K_LIVE,
          f"serve: membership {active.tolist()}")
    # embed: the service's encoder call is the fine-tuned encoder's
    gen = torch.Generator().manual_seed(seed)
    corpus = synth.CorpusConfig(seq_len=svc.enc_cfg.max_len)
    tok, mask = synth.sample_queries(
        gen, torch.randint(0, corpus.n_categories, (BATCH,), generator=gen),
        corpus, dev)
    emb = svc.embed(tok, mask)
    check(emb.shape == (BATCH, svc.enc_cfg.d_model)
          and torch.equal(emb, encode(params, tok, mask, svc.enc_cfg)),
          "serve: embed differs from encode")
    ms_per_tick = statistics.median(steady)
    draws_ab = serve_draws_ab(svc, envd, grid, seed)

    def more(n):
        for i in range(n):
            s = HORIZON // BATCH + i
            x = envd.x[(i % SERVE_TICKS) * BATCH:][:BATCH]
            u = envd.utils[(i % SERVE_TICKS) * BATCH:][:BATCH]
            a1, a2, tk = svc.route_batch(x, prefs=grid[
                (torch.arange(BATCH, device=dev) + s) % 3])
            svc.feedback_batch(tk, serve_votes(fb, s, u, a1, a2))
    prof = profile_ticks(more, ms_per_tick, 2 * cfg.sgld_steps,
                         groups=SERVE_GROUPS)
    record = dict(
        ticks=SERVE_TICKS, batch=BATCH, acts=acts, launches=counts,
        launches_per_act={k: counts[k] / acts for k in
                          ("dueling_select", "sgld_potential_grad")},
        route_batch_ms=statistics.median(route_ms[1:]),
        feedback_batch_ms=statistics.median(feedback_ms[1:]),
        ms_per_tick=ms_per_tick, steady_ticks=len(steady),
        queries_per_s=BATCH * len(steady) / (1e-3 * sum(steady)),
        run_queries_per_s=SERVE_TICKS * BATCH / wall,
        tick_ms=tick_ms, regret_per_tick=reg,
        folded_per_delivery=folded[0], expired=expired,
        restored_ticks_bitwise=RESTORE_TICKS, service_stats=stats,
        profile=prof, draws_ab=draws_ab)
    del svc
    record["autopilot"] = serve_autopilot(dev, seed, params, fb)
    return record


def serve_draws_ab(svc, envd, grid, seed, calls=4):
    """ms per ``route_batch`` with a sync after it (host clock), under the
    service's ``KeyedDraws`` (its generator re-seeded per draw) and under a
    sequential ``TorchDraws``, in turns keyed, torch, torch, keyed: the
    cost of checkpointable draws on the act."""
    import torch
    from repro_torch.core.draws import TorchDraws
    keyed, sequential = svc._draws, TorchDraws(seed, svc.device)
    out = {"keyed": [], "torch": []}
    for name in ("keyed", "torch", "torch", "keyed"):
        svc._draws = keyed if name == "keyed" else sequential
        for i in range(calls):
            x = envd.x[i * BATCH:(i + 1) * BATCH]
            prefs = grid[(torch.arange(BATCH, device=x.device) + i) % 3]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            svc.route_batch(x, prefs=prefs)
            torch.cuda.synchronize()
            out[name].append(1e3 * (time.perf_counter() - t0))
    svc._draws = keyed
    return {k: statistics.median(v) for k, v in out.items()}


def serve_autopilot(dev, seed, params, fb):
    """SERVE_AP_TICKS ticks of a service under the autopilot (the dominated
    world, a control tick every AP_KW["every"] acts), votes at once:
    ``dueling_score`` once per act, no host sync."""
    import torch
    from repro_torch import kernels
    svc, envd, _, cfg, _ = serve_setup(seed, dev, None, params,
                                       autopilot=True)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(SERVE_AP_TICKS):
        x = envd.x[s * BATCH:(s + 1) * BATCH]
        u = envd.utils[s * BATCH:(s + 1) * BATCH]
        with no_sync("route_batch (autopilot)"):
            a1, a2, tk = svc.route_batch(x)
        y = serve_votes(fb, s, u, a1, a2)
        with no_sync("feedback_batch (autopilot)"):
            svc.feedback_batch(tk, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n = SERVE_AP_TICKS
    check(counts["dueling_score"] == n and counts["dueling_select"] == n
          and counts["sgld_potential_grad"] == 2 * cfg.sgld_steps * n,
          f"serve autopilot: launch counts {counts} over {n} acts")
    st = svc.autopilot_status()
    check(int(st["tick"]) == n and math.isfinite(st["lambda"]),
          f"serve autopilot: controller tick {st['tick']}")
    return dict(ticks=n, launches=counts, ms_per_tick=1e3 * wall / n,
                queries_per_s=n * BATCH / wall, status={
                    k: (v.tolist() if hasattr(v, "tolist") else v)
                    for k, v in st.items()},
                service_stats=svc.service_stats())


def phase_serve_card_vs_cpu(dev, seed, params):
    """4 ticks of the service on the card and on the CPU from one
    host-mode ``KeyedDraws`` (prefs cycling, votes at once): pairs equal
    outside near-ties against the CPU's own scores, final chains to rtol
    1e-4."""
    import torch
    from repro_torch.core import model_pool as mp
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.models.layers import tree_map
    ticks = 4
    out = {}
    for where in (dev, torch.device("cpu")):
        p = tree_map(lambda w: w.to(where), params)
        svc, envd, _, _, _ = serve_setup(seed, where,
                                         KeyedDraws(seed, host=True), p)
        grid = torch.tensor([0.0, 0.5, 2.0], device=where)
        trace = []
        for s in range(ticks):
            x = envd.x[s * BATCH:(s + 1) * BATCH]
            u = envd.utils[s * BATCH:(s + 1) * BATCH]
            prefs = grid[(torch.arange(BATCH, device=where) + s) % 3]
            a1, a2, tk = svc.route_batch(x, prefs=prefs)
            inner = svc.state.inner
            trace.append((a1.cpu(), a2.cpu(), tk.cpu(), prefs.cpu(),
                          inner.theta1.mean(0).cpu(),
                          inner.theta2.mean(0).cpu()))
            svc.feedback_batch(tk, serve_votes(
                KeyedDraws(seed + 5, host=True), s, u, a1, a2))
        out[where.type] = (envd, mp.get_pool(svc.state), svc.state, trace)
    envd, pool, cpu_state, c_trace = out["cpu"]
    _, _, card_state, g_trace = out["cuda"]
    bad = ties = 0
    for s in range(ticks):
        c1, c2, ct, pref, th1, th2 = c_trace[s]
        g1, g2, gt = g_trace[s][:3]
        check(torch.equal(ct, gt), f"serve card vs cpu: tick {s} tickets")
        b, t_, _ = compare_pairs(
            envd.x[s * BATCH:(s + 1) * BATCH], pool.a_emb,
            torch.stack([th1, th2]), pref[:, None] * pool.costs[None, :],
            pool.active, True, (g1, g2), (c1, c2))
        bad, ties = bad + b, ties + t_
    check(bad == 0, f"serve card vs cpu: {bad} pair mismatches outside "
                    f"near-ties")
    errs = {}
    for f in ("theta1", "theta2"):
        gc = getattr(card_state.inner, f).cpu()
        cc = getattr(cpu_state.inner, f)
        err = (gc - cc).abs()
        errs[f] = float(err.max())
        check(bool((err <= 1e-5 + 1e-4 * cc.abs()).all()),
              f"serve card vs cpu: {f} differs by {errs[f]}")
    return dict(ticks=ticks, pair_mismatches=bad, near_ties=ties,
                theta_max_abs_err=errs)


# ---------------------------------------------------------------------------
# phase 2: streaming serving (one CUDA graph per bucket) and the refresh loop
# ---------------------------------------------------------------------------

# the ladder, the deadline, and the arrivals: 4096 Poisson requests, then
# 2048 bursty ones (mean bursts of 24), both at 12,800 requests/s; votes
# come back one formed batch late. STREAM_SWAP: retire BAD, add ARRIVAL;
# STREAM_SAVE: save, restore into a fresh streaming service that must
# route the next RESTORE_TICKS batches bitwise alike
STREAM_BUCKETS, STREAM_MAX_WAIT = (32, 64, 128, 256), 0.01
STREAM_ARRIVALS = (("poisson:12800", 4096), ("bursty:12800,24", 2048))
STREAM_SWAP, STREAM_SAVE, STREAM_AP = 12, 20, 8
# padding identity: the same batches through (128, 256) and (256,)
PAD_SIZES = (128, 77, 100, 128, 5, 64)
REFRESH_EVERY, REFRESH_REQUESTS = 2048, 4096
# the card-vs-CPU limit on the refresh fine-tuning's step, a share of its
# largest magnitude (an H100 run: 4.6e-4 seen; the uniform-weights
# control 1.96)
REFRESH_STEP_TOL = 1e-2


def stream_batches(seed, arrivals=None):
    """The formed batches of the arrival streams (``STREAM_ARRIVALS`` by
    default), back to back: (first query row, ``FormedBatch``, the
    stream's arrival times)."""
    from repro_torch.serving import stream
    out, row = [], 0
    for i, (spec, n) in enumerate(arrivals or STREAM_ARRIVALS):
        times = stream.arrival_times(stream.parse_arrival(spec), n,
                                     seed=seed + i)
        for fb in stream.form_batches(times, STREAM_BUCKETS,
                                      STREAM_MAX_WAIT):
            out.append((row + fb.start, fb, times))
        row += n
    return out


def same_service(a, b, what):
    """Posterior and ring of two services bitwise equal (the ring's ticket
    counter aside: a (1,) per-shard counter on the streaming ring)."""
    import torch
    from repro_torch.models.layers import tree_leaves
    for u, v in zip(tree_leaves(a.state), tree_leaves(b.state)):
        check(torch.equal(u, v), f"{what}: the posteriors differ")
    for f in ("x", "a1", "a2", "ticket", "issued_at", "valid", "pref"):
        check(torch.equal(getattr(a.pending, f), getattr(b.pending, f)),
              f"{what}: the rings' {f} differ")


def stream_pass(svc, envd, batches, grid, votes, route, feedback,
                guard=False):
    """Route every formed batch (prefs cycling) and deliver each batch's
    votes one batch late, timing each route with a sync on both sides.
    Returns (route ms per batch, feedback ms per batch, the per-request
    latencies in s: event-time wait plus the measured route time, wall
    s)."""
    import contextlib
    import numpy as np
    import torch
    route_ms, fb_ms, lat, issued = [], [], [], None
    ctx = (lambda w: no_sync(w)) if guard else \
        (lambda w: contextlib.nullcontext())
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    for i, (row, fb, times) in enumerate(batches):
        x, u = envd.x[row:row + fb.n], envd.utils[row:row + fb.n]
        prefs = grid[(torch.arange(fb.n, device=x.device) + i) % 3]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx("route"):
            a1, a2, tk = route(x, prefs=prefs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        route_ms.append(1e3 * (t1 - t0))
        lat.append(fb.t_form - times[fb.start:fb.start + fb.n] + (t1 - t0))
        y = serve_votes(votes, i, u, a1, a2)
        if issued is not None:
            t0 = time.perf_counter()
            with ctx("feedback"):
                feedback(*issued)
            torch.cuda.synchronize()
            fb_ms.append(1e3 * (time.perf_counter() - t0))
        issued = (tk, y)
    torch.cuda.synchronize()
    return route_ms, fb_ms, np.concatenate(lat), time.perf_counter() - t_run


def phase_stream(dev, seed, params):
    """Streaming serving on the card over phase ``serve``'s world (see the
    module docstring): every formed batch through ``route_stream`` (its
    bucket's CUDA graph) and a tick-batch twin's ``route_batch`` (eager)
    must agree bitwise (pairs, tickets, folded counts, posterior, ring);
    no host sync inside ``route_stream`` / ``feedback_stream``; graph
    counts flat across ``add_model`` and a restore; a restored streaming
    service routes bitwise alike; padding identity for FGTS and
    eps-greedy; 8 batches under the autopilot. Then the timed passes: the
    same formed batches through the graphs and through the twin alone
    (host ms per call by bucket, qps, p50 / p99 latency), and 2 profiled
    passes of 4 full batches (device ms per act, idle share)."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.analysis.retrace import assert_flat
    from repro_torch.core import model_pool as mp
    from repro_torch.core.draws import KeyedDraws
    votes = KeyedDraws(seed + 201)
    batches = stream_batches(seed)
    n_req = sum(n for _, n in STREAM_ARRIVALS)
    t0 = time.perf_counter()
    svc, envd, pool, cfg, entries = serve_setup(
        seed, dev, None, params, t_total=n_req + BATCH,
        buckets=STREAM_BUCKETS)
    capture_s = time.perf_counter() - t0
    twin = serve_setup(seed, dev, None, params, t_total=n_req + BATCH)[0]
    graphs = svc.compiled_program_counts()
    nb = len(STREAM_BUCKETS)
    check(graphs == dict(s_route=nb, s_route_pref=nb, s_feedback=nb,
                         s_resolve=nb, captures=4 * nb),
          f"stream: graph counts {graphs}")
    with assert_flat(svc, note="stream: the timed passes") as flat:
        grid = torch.tensor([0.0, 0.5, 2.0], device=dev)
        x_off, u_off = envd.x[n_req:], envd.utils[n_req:]
        ckpt = Path(__file__).resolve().parent / "build" / "stream_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        restored, issued, folded, buckets_used = None, None, [], {}
        for i, (row, fb, _) in enumerate(batches):
            if i == STREAM_SWAP:
                for s in (svc, twin):
                    s.retire_model(BAD)
                    slot = s.add_model(entries[-1], replay=mp.warm_start_duels(
                        KeyedDraws(seed + 7), x_off, u_off, ARRIVAL,
                        s.active_mask(), feedback_scale=8.0))
                    check(slot == ARRIVAL, f"stream: the arrival took {slot}")
            if i == STREAM_SAVE:
                svc.save(str(ckpt))
                restored = serve_setup(seed, dev, None, params,
                                       t_total=n_req + BATCH,
                                       buckets=STREAM_BUCKETS)[0]
                restored.restore(str(ckpt))
                check(restored.tick == svc.tick
                      and int(restored._tick_dev) == svc.tick,
                      "stream: the restored clock differs")
            live = restored is not None and i < STREAM_SAVE + RESTORE_TICKS
            x, u = envd.x[row:row + fb.n], envd.utils[row:row + fb.n]
            prefs = grid[(torch.arange(fb.n, device=dev) + i) % 3]
            buckets_used[fb.bucket] = buckets_used.get(fb.bucket, 0) + 1
            with no_sync("route_stream"):
                a1, a2, tk = svc.route_stream(x, prefs=prefs)
            b1, b2, tb = twin.route_batch(x, prefs=prefs)
            check(torch.equal(a1, b1) and torch.equal(a2, b2)
                  and torch.equal(tk, tb),
                  f"stream: batch {i} (n {fb.n}, bucket {fb.bucket}) routes "
                  f"differently from route_batch")
            if live:
                with no_sync("route_stream (restored)"):
                    r = restored.route_stream(x, prefs=prefs)
                check(all(torch.equal(p, q) for p, q in zip(r, (a1, a2, tk))),
                      f"stream: batch {i} after the restore routes "
                      f"differently")
            y = serve_votes(votes, i, u, a1, a2)
            if issued is not None:
                with no_sync("feedback_stream"):
                    n_ok = svc.feedback_stream(*issued)
                n_twin = twin.feedback_batch(*issued)
                check(torch.equal(n_ok, n_twin), f"stream: batch {i} folded "
                      f"{int(n_ok)}, route_batch's twin {int(n_twin)}")
                folded.append((n_ok, issued[0].shape[0]))
                if live:
                    with no_sync("feedback_stream (restored)"):
                        n_r = restored.feedback_stream(*issued)
                    check(torch.equal(n_r, n_ok), "stream: the restored "
                          "service folds differently")
            issued = (tk, y)
        shutil.rmtree(ckpt, ignore_errors=True)
        check(restored is not None, "stream: the restore did not run")
        del restored
        flat.check("stream: the batches, add_model and a restore")
        check(all(int(n) == m for n, m in folded),
              "stream: a late delivery did not fold in full")
        same_service(svc, twin, "stream vs route_batch")
        check(svc.tick == twin.tick == len(batches) == int(svc._tick_dev),
              "stream: the device tick left its host mirror")
        active = svc.active_mask()
        check(not active[BAD] and active[ARRIVAL],
              f"stream: membership {active.tolist()}")

        # the launches of the replays: every formed batch once more through the
        # graphs, counted by the profiler's kernel names
        launches = replay_launches(lambda: stream_pass(
            svc, envd, batches, grid, votes, svc.route_stream,
            svc.feedback_stream))
        check(launches == dict(sgld_potential_grad=2 * cfg.sgld_steps
                               * len(batches), dueling_select=len(batches),
                               dueling_score=0),
              f"stream: replayed launches {launches}")

        # the timed passes: the graphs, then the eager twin, on the same
        # batches
        route_ms, fb_ms, lat, wall = stream_pass(
            svc, envd, batches, grid, votes, svc.route_stream,
            svc.feedback_stream, guard=False)
        t_route, t_fb, t_lat, t_wall = stream_pass(
            twin, envd, batches, grid, votes, twin.route_batch,
            twin.feedback_batch)
    by_bucket = {}
    for (_, fb, _), ms in zip(batches, route_ms):
        by_bucket.setdefault(fb.bucket, []).append(ms)
    # host time of a replay alone (enqueue: the draw plan's fill and the
    # launch; no sync inside), at the top bucket
    x = envd.x[:STREAM_BUCKETS[-1]]
    prefs = grid[torch.arange(STREAM_BUCKETS[-1], device=dev) % 3]
    enqueue_ms = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.route_stream(x, prefs=prefs)
        enqueue_ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    # ... and where it goes: staging the inputs, the draw plan's fill, the
    # graph's launch (``route_stream``'s steps, run one by one here, with
    # the host mirrors kept in step)
    top = STREAM_BUCKETS[-1]
    prog = svc._s_route_pref[top]
    split = {"stage": [], "fill": [], "replay": []}
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc._stage(top, top, x=x, pref=prefs)
        t1 = time.perf_counter()
        prog.plan.fill(svc._next_key(), prog.tape)
        t2 = time.perf_counter()
        prog.graph.replay()
        t3 = time.perf_counter()
        svc.tick += 1
        svc.n_routed += top
        for k, v in zip(split, (t1 - t0, t2 - t1, t3 - t2)):
            split[k].append(1e3 * v)
    torch.cuda.synchronize()

    def full(n):
        for i in range(n):
            a1, a2, tk = svc.route_stream(x, prefs=prefs)
            svc.feedback_stream(tk, serve_votes(votes, 9000 + i,
                                                envd.utils[:len(x)], a1,
                                                a2))
    full(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full(8)
    torch.cuda.synchronize()
    ms_full = 1e3 * (time.perf_counter() - t0) / 8
    prof = profile_ticks(full, ms_full, 2 * cfg.sgld_steps, ticks=4,
                         groups=SERVE_GROUPS)
    pct = lambda v, q: float(np.percentile(v, q))
    record = dict(
        batches=len(batches), requests=n_req, buckets=list(STREAM_BUCKETS),
        max_wait_s=STREAM_MAX_WAIT, batches_per_bucket=buckets_used,
        padding_efficiency=n_req / sum(fb.bucket for _, fb, _ in batches),
        capture_s=capture_s, graphs=graphs,
        launches=launches,
        launches_per_act={k: v / len(batches) for k, v in launches.items()},
        launches_source="torch.profiler kernel names over a pass of the "
                        "formed batches through the graphs",
        route_stream_ms_by_bucket={b: statistics.median(v)
                                   for b, v in sorted(by_bucket.items())},
        route_stream_enqueue_ms=statistics.median(enqueue_ms[2:]),
        route_stream_host_split_ms={k: statistics.median(v[2:])
                                    for k, v in split.items()},
        draw_plan_entries=len(prog.plan.entries),
        feedback_stream_ms=statistics.median(fb_ms),
        route_stream_ms=statistics.median(route_ms),
        route_batch_ms=statistics.median(t_route),
        feedback_batch_ms=statistics.median(t_fb),
        stream_qps=n_req / wall, route_batch_qps=n_req / t_wall,
        stream_p50_ms=1e3 * pct(lat, 50), stream_p99_ms=1e3 * pct(lat, 99),
        route_batch_p50_ms=1e3 * pct(t_lat, 50),
        route_batch_p99_ms=1e3 * pct(t_lat, 99),
        ms_per_full_batch=ms_full, profile=prof,
        bitwise_batches=len(batches), restored_batches=RESTORE_TICKS,
        service_stats=svc.service_stats())
    del svc, twin
    record["padding_identity"] = {
        p: stream_padding_identity(dev, seed, params, p)
        for p in ("fgts", "eps_greedy")}
    record["autopilot"] = stream_autopilot(dev, seed, params, votes,
                                           batches[:STREAM_AP])
    return record


def stream_padding_identity(dev, seed, params, policy):
    """The same batches (PAD_SIZES rows, votes one batch late) through a
    ladder (128, 256) and a ladder (256,): pairs, tickets, folded counts,
    posterior and ring bitwise equal."""
    import torch
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.launch.serve import POLICIES
    fac = None if policy == "fgts" else POLICIES[policy]
    runs = []
    for buckets in ((128, 256), (256,)):
        svc, envd, _, _, _ = serve_setup(seed, dev, None, params,
                                         buckets=buckets,
                                         policy_factory=fac)
        votes, out, issued, row = KeyedDraws(seed + 301), [], None, 0
        for i, n in enumerate(PAD_SIZES):
            x, u = envd.x[row:row + n], envd.utils[row:row + n]
            row += n
            a1, a2, tk = svc.route_stream(x)
            got = None if issued is None else svc.feedback_stream(*issued)
            out.append((a1, a2, tk, got))
            issued = (tk, serve_votes(votes, i, u, a1, a2))
        runs.append((svc, out))
    for i, (a, b) in enumerate(zip(runs[0][1], runs[1][1])):
        check(all(torch.equal(p, q) for p, q in zip(a[:3], b[:3]))
              and (a[3] is None or int(a[3]) == int(b[3])),
              f"stream padding {policy}: batch {i} of {PAD_SIZES[i]} rows "
              f"differs between buckets 128 and 256")
    same_service(runs[0][0], runs[1][0], f"stream padding {policy}")
    return dict(batches=len(PAD_SIZES), sizes=list(PAD_SIZES),
                bitwise=True)


def stream_autopilot(dev, seed, params, votes, batches):
    """8 formed batches through a streaming service under the autopilot
    (votes one batch late): no host sync, the controller ticks once a
    batch; launches by the profiler's kernel names over a second pass of
    the batches: ``dueling_score`` and ``dueling_select`` once and
    ``sgld_potential_grad`` 40 times per replayed route graph."""
    import contextlib
    import torch
    from repro_torch.analysis.retrace import assert_flat
    svc, envd, _, cfg, _ = serve_setup(seed, dev, None, params,
                                       autopilot=True,
                                       buckets=STREAM_BUCKETS)

    def run(guard):
        issued = None
        for i, (row, fb, _) in enumerate(batches):
            x, u = envd.x[row:row + fb.n], envd.utils[row:row + fb.n]
            with guard("route_stream (autopilot)"):
                a1, a2, tk = svc.route_stream(x)
            if issued is not None:
                with guard("feedback_stream (autopilot)"):
                    svc.feedback_stream(*issued)
            issued = (tk, serve_votes(votes, i, u, a1, a2))
    with assert_flat(svc, note="stream autopilot"):
        run(no_sync)
        torch.cuda.synchronize()
        n = len(batches)
        st = svc.autopilot_status()
        check(int(st["tick"]) == n and math.isfinite(st["lambda"]),
              f"stream autopilot: controller tick {st['tick']}")
        launches = replay_launches(lambda: run(
            lambda what: contextlib.nullcontext()))
        check(launches == dict(sgld_potential_grad=2 * cfg.sgld_steps * n,
                               dueling_select=n, dueling_score=n),
              f"stream autopilot: replayed launches {launches}")
    return dict(batches=n, launches=launches, lam=st["lambda"],
                cost_ema=st["cost_ema"])


def refresh_world(seed, dev, params):
    """The refresh loop's world in the encoder's geometry (d 256, no
    metadata): RouterBench's 11 models in 16 slots from the fine-tuned
    encoder's ``excel_perf_cost`` embeddings, REFRESH_REQUESTS online
    queries encoded, their categories, the offline split."""
    from repro_torch.data import pipeline
    enc_cfg, params, split, _ = ccft_setup(seed, dev, REFRESH_REQUESTS,
                                           params)
    a = pipeline.routerbench_model_embeddings(
        params, enc_cfg, split, "excel_perf_cost", with_metadata=False)
    envd = pipeline.routerbench_env(params, enc_cfg, split,
                                    with_metadata=False)
    return enc_cfg, params, split, a, envd


def phase_refresh(dev, seed, params):
    """The online representation refresh loop on the card: a streaming
    service with ``RefreshConfig(every=2048)`` routes the RouterBench
    stream (categories recorded); once 2048 duels are logged,
    ``export_log`` -> ``refresh_table`` (``EncoderConfig()``, the
    fine-tuned encoder, ``RefreshConfig()``'s 2 x 20 steps of 64 pairs)
    -> ``apply_table``, then streaming goes on with no graph captured
    anew. Seconds per cycle and the cycle's attention launches (exact:
    8 forward and 8 backward a step, one encode of the offline split);
    card against CPU on the exported log."""
    import torch
    from repro_torch import kernels
    from repro_torch.analysis.retrace import assert_flat
    from repro_torch.core import fgts
    from repro_torch.core import model_pool as mp
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.data.pool import build_entries
    from repro_torch.refresh import RefreshConfig, refresh_table
    from repro_torch.serving import RouterService, RouterServiceConfig
    enc_cfg, params, split, a, envd = refresh_world(seed, dev, params)
    rcfg = RefreshConfig(every=REFRESH_EVERY)
    cfg = fgts.FGTSConfig(n_models=K_MAX, dim=a.shape[1], horizon=HORIZON,
                          eta=8.0, mu=0.2, sgld_steps=20, sgld_eps=5e-4,
                          sgld_minibatch=64, n_chains=8, force_distinct=True)
    # a model's cost: its mean over the benchmarks (Tab. 3's cost columns)
    entries = build_entries([f"rb{i}" for i in range(a.shape[0])], a,
                            split.cost.mean(dim=1).tolist())
    svc = RouterService(entries, params, enc_cfg, RouterServiceConfig(
        fgts=cfg, k_max=K_MAX, seed=seed, feedback_capacity=SERVE_CAP,
        feedback_expiry=SERVE_EXPIRY, buckets=STREAM_BUCKETS,
        refresh=rcfg), device=dev)
    graphs = svc.compiled_program_counts()
    votes = KeyedDraws(seed + 401)
    with assert_flat(svc, note="refresh"):
        batches = stream_batches(seed, (("poisson:12800", REFRESH_REQUESTS),))
        offline = (split.offline_tokens, split.offline_mask,
                   split.offline_cats)
        cats = split.online_cats.to(dev)
        issued, cycles, regrets, exported = None, [], [], None
        for i, (row, fb, _) in enumerate(batches):
            x, u = envd.x[row:row + fb.n], envd.utils[row:row + fb.n]
            with no_sync("route_stream (refresh)"):
                a1, a2, tk = svc.route_stream(x, cats=cats[row:row + fb.n])
            rows = torch.arange(fb.n, device=dev)
            regrets.append(torch.mean(u.amax(-1) - 0.5 * (
                u[rows, a1.long()] + u[rows, a2.long()])))
            if issued is not None:
                with no_sync("feedback_stream (refresh)"):
                    svc.feedback_stream(*issued)
            issued = (tk, serve_votes(votes, i, u, a1, a2))
            if svc.refresh_due():
                kernels.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                log = svc.export_log()
                table, info = refresh_table(KeyedDraws(seed + 9), log, params,
                                            enc_cfg, offline, rcfg, K_MAX,
                                            costs=svc.costs)
                svc.apply_table(table)
                torch.cuda.synchronize()
                counts = kernels.launch_counts()
                # 2 encodes a step and one of the offline split, a launch a
                # layer each
                steps = rcfg.epochs * rcfg.steps_per_epoch
                fwd = (2 * steps + 1) * enc_cfg.n_layers
                check(counts["flash_attention_bwd"] == 2 * enc_cfg.n_layers
                      * steps and counts["flash_attention"] == fwd,
                      f"refresh: attention launches {counts} in {steps} steps")
                check(torch.equal(mp.get_pool(svc.state).a_emb, table)
                      and bool(torch.isfinite(table).all()),
                      "refresh: the refreshed table is not the pool's")
                cycles.append(dict(batch=i, seconds=time.perf_counter() - t0,
                                   n_duels=info["n_duels"], log_count=log[
                                       "count"], losses=info["losses"],
                                   launches={k: v for k, v in counts.items()
                                             if v}, mix=info["mix"].tolist()))
                exported = log
        check(len(cycles) == 1, f"refresh: {len(cycles)} cycles, not 1")
    stats = svc.service_stats()
    check(stats["table_swaps"] == 1 and stats["n_routed"]
          == REFRESH_REQUESTS, f"refresh: service_stats {stats}")
    reg = torch.stack(regrets).tolist()
    check(all(math.isfinite(r) for r in reg), "refresh: regret not finite")
    at = cycles[0]["batch"]
    record = dict(requests=REFRESH_REQUESTS, batches=len(batches),
                  every=REFRESH_EVERY, config=dict(
                      n_categories=rcfg.n_categories, epochs=rcfg.epochs,
                      steps_per_epoch=rcfg.steps_per_epoch,
                      batch=rcfg.batch, capacity=rcfg.capacity,
                      weighting=rcfg.weighting),
                  cycles=cycles, seconds_per_cycle=cycles[0]["seconds"],
                  graphs=graphs, service_stats=stats,
                  regret_before=sum(reg[:at + 1]) / (at + 1),
                  regret_after=sum(reg[at + 1:]) / max(len(reg) - at - 1,
                                                       1))
    record["card_vs_cpu"] = refresh_card_vs_cpu(dev, seed, exported,
                                                params, enc_cfg, offline,
                                                svc.costs)
    return record


def refresh_card_vs_cpu(dev, seed, log, params, enc_cfg, offline, costs):
    """The refresh job's pieces on the card and on the CPU from one
    exported log: ``category_mix`` exactly, ``duel_scores`` (IPW, scatter
    adds in another order) to rtol 1e-6, and one ``refresh_table`` of 1
    epoch x 2 steps under ``HostDraws`` at the default lr 1e-3: losses to
    rtol 1e-4, the table to 1e-4 of its largest magnitude, and the
    fine-tuning's step (refreshed minus input weights, leaf by leaf) to
    REFRESH_STEP_TOL of the CPU step's largest magnitude. Control: the
    card's step on the same draws with uniform row weights (the live mix
    ignored) must land more than 10 x that limit away from the CPU's
    step."""
    import torch
    from repro_torch.contrastive import finetune_categorical
    from repro_torch.core.draws import HostDraws
    from repro_torch.models.layers import tree_map
    from repro_torch.refresh import (RefreshConfig, category_mix,
                                     duel_scores, refresh_table)
    rcfg = RefreshConfig(epochs=1, steps_per_epoch=2)
    before = [w.cpu() for w in tree_leaves(params)]

    def step(p):
        return [w.cpu() - b for w, b in zip(tree_leaves(p), before)]

    out = {}
    for where in (dev, torch.device("cpu")):
        mix = category_mix(torch.as_tensor(log["cat"]), rcfg.n_categories,
                           device=where)
        sc = duel_scores(log["a1"], log["a2"], log["y"], log["cat"],
                         log["prop"], K_MAX, rcfg.n_categories,
                         device=where)
        table, info = refresh_table(
            HostDraws(seed), log, tree_map(lambda w: w.to(where), params),
            enc_cfg, tuple(v.to(where) for v in offline), rcfg, K_MAX,
            costs=costs.to(where))
        out[where.type] = (mix.cpu(), sc.cpu(), table.cpu(), info["losses"],
                           step(info["params"]))
    (gm, gs, gt, gl, gd), (cm, cs, ct, cl, cd) = out["cuda"], out["cpu"]
    ctl, _ = finetune_categorical(
        HostDraws(seed), params, *(v.to(dev) for v in offline), enc_cfg,
        epochs=rcfg.epochs, steps_per_epoch=rcfg.steps_per_epoch,
        batch=rcfg.batch, lr=rcfg.lr)

    def gap(d):
        return max(float((a - b).abs().max()) for a, b in zip(d, cd))
    scale = max(float(d.abs().max()) for d in cd)
    s_err, s_ctl = gap(gd), gap(step(ctl))
    check(torch.equal(gm, cm), "refresh card vs cpu: category mix")
    check(torch.allclose(gs, cs, rtol=1e-6, atol=1e-7),
          f"refresh card vs cpu: duel scores {float((gs - cs).abs().max())}")
    t_err = float((gt - ct).abs().max())
    check(t_err <= 1e-4 * float(ct.abs().max()),
          f"refresh card vs cpu: table differs by {t_err}")
    check(all(abs(g - c) <= 1e-4 * abs(c) for g, c in zip(gl, cl)),
          f"refresh card vs cpu: losses {gl} vs {cl}")
    check(scale >= 0.5 * rcfg.lr and s_err <= REFRESH_STEP_TOL * scale,
          f"refresh card vs cpu: the encoder's step differs by {s_err} "
          f"(step {scale})")
    check(s_ctl > 10 * REFRESH_STEP_TOL * scale,
          f"refresh card vs cpu: the uniform-weights control's step is "
          f"{s_ctl} from the CPU's (step {scale})")
    return dict(table_max_abs_err=t_err,
                scores_max_abs_err=float((gs - cs).abs().max()),
                losses=dict(card=gl, cpu=cl), step_max_abs=scale,
                step_max_abs_err=s_err, control_step_max_abs_err=s_ctl,
                step_tol=REFRESH_STEP_TOL * scale)


# ---------------------------------------------------------------------------
# phase examples: the paper's two examples on the card
# ---------------------------------------------------------------------------

# each example's size: its online rounds (quickstart) or queries before
# the 8% removal (mixinstruct), cut from 300 and 500; both run one epoch of
# 5 fine-tuning steps (the examples: 4 x 30, 4 x 25) and their own SGLD
# steps
# ---------------------------------------------------------------------------
# phase 2: the mesh service on an NCCL world of one, and the router dry-run
# ---------------------------------------------------------------------------

MESH_TICKS = 16
MESH_STREAM_SIZES = (256, 77, 128, 5, 200, 64, 256, 33)


def timed_call(fn):
    """(fn's result, host ms of the call ending in a sync)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def mesh_tick_batch(dev, seed, params, mesh):
    """16 ticks of the serve world through the mesh service and an
    unsharded twin: pairs, tickets, folded and expired counts bitwise
    alike every tick, posterior and ring at the end; launches per act of
    the mesh service; host ms per call of both; the collectives of one
    route and one feedback (``routing_rules.tally``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.sharding import routing_rules as rr
    fb = KeyedDraws(seed + 303)
    plain, envd, pool, cfg, _ = serve_setup(seed, dev, None, params)
    meshed = serve_setup(seed, dev, None, params, mesh=mesh)[0]
    grid = torch.tensor([0.0, 0.5, 2.0], device=dev)
    svcs = dict(plain=plain, mesh=meshed)
    ms = {k: dict(route=[], feedback=[]) for k in svcs}
    counts = dict(dueling_select=0, sgld_potential_grad=0, dueling_score=0)
    issued = {}
    for s in range(MESH_TICKS):
        x = envd.x[s * BATCH:(s + 1) * BATCH]
        u = envd.utils[s * BATCH:(s + 1) * BATCH]
        prefs = grid[(torch.arange(BATCH, device=dev) + s) % 3]
        out = {}
        for name, svc in svcs.items():
            kernels.reset_launch_counts()
            out[name], t = timed_call(lambda: svc.route_batch(x,
                                                              prefs=prefs))
            ms[name]["route"].append(t)
            if name == "mesh":
                got = kernels.launch_counts()
                for k in counts:
                    counts[k] += got[k]
        check(all(torch.equal(p, q) for p, q in zip(out["plain"],
                                                    out["mesh"])),
              f"mesh: tick {s} routes differently from the unsharded twin")
        a1, a2, tk = out["mesh"]
        issued[s] = (tk, serve_votes(fb, s, u, a1, a2))
        if s >= SERVE_DELAY:
            tk_d, y_d = late_delivery(fb, s, *issued.pop(s - SERVE_DELAY))
            n = {}
            for name, svc in svcs.items():
                n[name], t = timed_call(lambda: svc.feedback_batch(tk_d, y_d))
                ms[name]["feedback"].append(t)
            check(torch.equal(n["plain"], n["mesh"]),
                  f"mesh: tick {s} folds {int(n['mesh'])}, the twin "
                  f"{int(n['plain'])}")
        e = [svc.expire_pending() for svc in svcs.values()]
        check(e[0] == e[1], f"mesh: tick {s} expires {e}")
    same_service(plain, meshed, "mesh")
    st = [svc.service_stats() for svc in svcs.values()]
    check(st[0] == st[1], f"mesh: service_stats {st}")
    check(counts == dict(dueling_select=MESH_TICKS,
                         sgld_potential_grad=2 * cfg.sgld_steps * MESH_TICKS,
                         dueling_score=0),
          f"mesh: launch counts {counts} over {MESH_TICKS} acts")
    x, u = envd.x[:BATCH], envd.utils[:BATCH]
    with rr.tally() as coll_route:
        a1, a2, tk = meshed.route_batch(x)
    y = serve_votes(fb, MESH_TICKS, u, a1, a2)
    with rr.tally() as coll_fb:
        meshed.feedback_batch(tk, y)
    check(coll_route == {"all_gather": {"bytes": BATCH * 8, "count": 1}}
          and list(coll_fb) == ["all_reduce"],
          f"mesh: collectives {coll_route} a route, {coll_fb} a feedback")
    return dict(
        collectives_per_route_batch=coll_route,
        collectives_per_feedback_batch=coll_fb,
        ticks=MESH_TICKS, batch=BATCH, launches=counts,
        launches_per_act={k: v / MESH_TICKS for k, v in counts.items()},
        route_batch_ms=statistics.median(ms["mesh"]["route"][1:]),
        feedback_batch_ms=statistics.median(ms["mesh"]["feedback"][1:]),
        unsharded_route_batch_ms=statistics.median(ms["plain"]["route"][1:]),
        unsharded_feedback_batch_ms=statistics.median(
            ms["plain"]["feedback"][1:]),
        service_stats=st[1])


def mesh_stream(dev, seed, params, mesh):
    """The streaming mesh service (one CUDA graph per bucket and program)
    against an unsharded streaming twin: every formed batch's pairs,
    tickets and folded count bitwise alike, posterior and ring at the
    end, graph counts flat; no collective called while the graphs were
    captured, the collectives of one ``route_stream`` and one
    ``feedback_stream``, and the launches of each serving kernel in one
    replay of the top bucket's route program (by the profiler's kernel
    names: a replay makes no Python call)."""
    import torch
    from repro_torch.analysis.retrace import assert_flat
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.sharding import routing_rules as rr
    votes = KeyedDraws(seed + 304)
    n_req = sum(MESH_STREAM_SIZES)
    plain, envd, pool, cfg, _ = serve_setup(
        seed, dev, None, params, t_total=n_req + BATCH,
        buckets=STREAM_BUCKETS)
    # the captures run every program's body once: the collectives they
    # call are the programs' own
    with rr.tally() as coll_capture:
        meshed = serve_setup(seed, dev, None, params, t_total=n_req + BATCH,
                             buckets=STREAM_BUCKETS, mesh=mesh)[0]
    check(coll_capture == {}, f"mesh: the captured streaming programs "
          f"call collectives: {coll_capture}")
    nb = len(STREAM_BUCKETS)
    graphs = meshed.compiled_program_counts()
    check(graphs == dict(s_route=nb, s_route_pref=nb, s_feedback=nb,
                         s_resolve=nb, captures=4 * nb),
          f"mesh: stream graph counts {graphs}")
    with assert_flat(meshed, note="mesh stream"):
        grid = torch.tensor([0.0, 0.5, 2.0], device=dev)
        svcs = dict(plain=plain, mesh=meshed)
        ms = {k: dict(route=[], feedback=[]) for k in svcs}
        row, issued = 0, None
        for i, n in enumerate(MESH_STREAM_SIZES):
            x, u = envd.x[row:row + n], envd.utils[row:row + n]
            row += n
            prefs = grid[(torch.arange(n, device=dev) + i) % 3]
            out = {}
            for name, svc in svcs.items():
                out[name], t = timed_call(
                    lambda: svc.route_stream(x, prefs=prefs))
                ms[name]["route"].append(t)
            check(all(torch.equal(p, q) for p, q in zip(out["plain"],
                                                        out["mesh"])),
                  f"mesh: stream batch {i} (n {n}) routes differently")
            y = serve_votes(votes, i, u, *out["mesh"][:2])
            if issued is not None:
                got = {}
                for name, svc in svcs.items():
                    got[name], t = timed_call(
                        lambda: svc.feedback_stream(*issued))
                    ms[name]["feedback"].append(t)
                check(torch.equal(got["plain"], got["mesh"]),
                      f"mesh: stream batch {i} folds differently")
            issued = (out["mesh"][2], y)
        same_service(plain, meshed, "mesh stream")
    x = envd.x[:STREAM_BUCKETS[-1]]
    with rr.tally() as coll_route:
        tk = meshed.route_stream(x)[2]
    with rr.tally() as coll_fb:
        meshed.feedback_stream(tk, torch.ones(tk.shape, device=dev))
    check(list(coll_route) == ["all_gather"]
          and list(coll_fb) == ["all_gather"],
          f"mesh: collectives {coll_route} a route_stream, {coll_fb} a "
          f"feedback_stream")
    prog = meshed._s_route[STREAM_BUCKETS[-1]]
    by = replay_launches(lambda: prog(meshed._next_key()))
    check(by == dict(dueling_select=1,
                     sgld_potential_grad=2 * cfg.sgld_steps,
                     dueling_score=0),
          f"mesh: a replayed route program launched {by}")
    return dict(
        batches=len(MESH_STREAM_SIZES), graphs=graphs,
        collectives_in_captured_programs=coll_capture,
        collectives_per_route_stream=coll_route,
        collectives_per_feedback_stream=coll_fb,
        replayed_route_launches=by,
        route_stream_ms=statistics.median(ms["mesh"]["route"][1:]),
        feedback_stream_ms=statistics.median(ms["mesh"]["feedback"][1:]),
        unsharded_route_stream_ms=statistics.median(
            ms["plain"]["route"][1:]),
        unsharded_feedback_stream_ms=statistics.median(
            ms["plain"]["feedback"][1:]))


def mesh_stream_autopilot(dev, seed, params, mesh):
    """A streaming mesh service under the autopilot against an unsharded
    twin: no collective called while its graphs were captured (the cost
    EMA is folded after the route's gather), every formed batch's pairs
    and tickets, the controller and the posterior bitwise alike."""
    import numpy as np
    import torch
    from repro_torch.core.draws import KeyedDraws
    from repro_torch.sharding import routing_rules as rr
    votes = KeyedDraws(seed + 305)
    sizes = MESH_STREAM_SIZES[:6]
    kw = dict(autopilot=True, t_total=sum(sizes) + BATCH,
              buckets=STREAM_BUCKETS)
    plain, envd = serve_setup(seed, dev, None, params, **kw)[:2]
    with rr.tally() as coll_capture:
        meshed = serve_setup(seed, dev, None, params, mesh=mesh, **kw)[0]
    check(coll_capture == {}, f"mesh autopilot: the captured streaming "
          f"programs call collectives: {coll_capture}")
    row, issued = 0, None
    for i, n in enumerate(sizes):
        x, u = envd.x[row:row + n], envd.utils[row:row + n]
        row += n
        out = [svc.route_stream(x) for svc in (plain, meshed)]
        check(all(torch.equal(p, q) for p, q in zip(*out)),
              f"mesh autopilot: stream batch {i} (n {n}) routes "
              f"differently")
        if issued is not None:
            for svc in (plain, meshed):
                svc.feedback_stream(*issued)
        issued = (out[1][2], serve_votes(votes, i, u, *out[1][:2]))
    st = [svc.autopilot_status() for svc in (plain, meshed)]
    for k, v in st[0].items():
        check(np.array_equal(np.asarray(v), np.asarray(st[1][k])),
              f"mesh autopilot: controller {k} {st[1][k]}, the twin {v}")
    same_service(plain, meshed, "mesh autopilot")
    return dict(batches=len(sizes),
                collectives_in_captured_programs=coll_capture,
                tick=st[1]["tick"], lam=st[1]["lambda"],
                cost_ema=st[1]["cost_ema"])


def phase_mesh(dev, seed, params):
    """The mesh service on an NCCL world of one, then the router dry-run
    (see the module docstring)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import router_dryrun as rd
    # the dry-run first: it needs no world (its fake one is its own)
    t0 = time.perf_counter()
    reckoning = rd.reckon()
    check(len(reckoning) == 8
          and all(r["rows"] == rd.SHARE_ROWS[r["mesh"]] for r in reckoning),
          "mesh: the dry-run's rows per rank")
    shares = rd.time_shares(dev, seed=seed)
    want = dict(route_step=1, update_step=rd.SGLD["sgld_steps"],
                encode_route_step=rd.ENC_CFG.n_layers)
    for r in shares:
        if r["kernel"] is not None:
            check(r["kernel_launches"] == want[r["step"]]
                  and r["kernel_device_ms"] > 0,
                  f"mesh: dry-run share {r['step']} x {r['mesh']}: "
                  f"launches {r['launches']}, kernels profiled "
                  f"{sorted(r['device_ms_by_kernel'])}")
    record = dict(dryrun=dict(reckoning=reckoning, card=shares,
                              seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    mesh_lib.init_world(dev)
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"mesh: a {dist.get_backend()} world of "
              f"{dist.get_world_size()}")
        mesh = mesh_lib.make_debug_mesh(1, 1, dev)
        record.update(
            backend=dist.get_backend(), world=1,
            tick=mesh_tick_batch(dev, seed, params, mesh),
            stream=mesh_stream(dev, seed, params, mesh),
            stream_autopilot=mesh_stream_autopilot(dev, seed, params, mesh))
    finally:
        mesh_lib.close_world()
    check(not dist.is_initialized(), "mesh: the world was not destroyed")
    record["service_s"] = time.perf_counter() - t0
    return record


EXAMPLE_RUNS = {"quickstart_torch": dict(rounds=60),
                "mixinstruct_preferences_torch": dict(queries=160)}
EXAMPLE_STEPS = dict(epochs=1, steps_per_epoch=5)


def load_example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_launches(mod, out):
    """The launches an example's run makes, reckoned from what its ``main``
    returns: per fine-tuning step two encodes (the pairs' two sides), each
    one forward and one backward attention launch a layer; per encode call
    (``encoded``: its queries) one forward a layer for each batch of up to
    ``pipeline.ENCODE_BATCH``; per online round one selection and, for each
    of the two samples, one SGLD gradient launch a step."""
    from repro_torch.data import pipeline
    layers = mod.ENC_CFG.n_layers
    steps = EXAMPLE_STEPS["epochs"] * EXAMPLE_STEPS["steps_per_epoch"]
    batches = sum(-(-n // pipeline.ENCODE_BATCH) for n in out["encoded"])
    return {"flash_attention": 2 * layers * steps + layers * batches,
            "flash_attention_bwd": 2 * layers * steps,
            "sgld_potential_grad": 2 * mod.SGLD_STEPS * out["rounds"],
            "dueling_select": out["rounds"]}


def phase_examples(dev, seed):
    """``examples/quickstart_torch.py`` and
    ``examples/mixinstruct_preferences_torch.py``, imported and run through
    their ``main`` on the card at ``EXAMPLE_RUNS``' sizes (their printing
    sent to stderr). Per example: the launch counts, reset before, must
    equal ``example_launches`` exactly (no other kernel); the regret curve
    must be finite, one value a round; its wall seconds (``main``'s own,
    from the world's making to the regret curve on the host)."""
    import contextlib
    from repro_torch import kernels
    out = {}
    for name, size in EXAMPLE_RUNS.items():
        mod = load_example(name)
        argv = [a for k, v in dict(size, **EXAMPLE_STEPS).items()
                for a in (f"--{k.replace('_', '-')}", str(v))]
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(sys.stderr):
            got = mod.main([*argv, "--device", str(dev), "--seed",
                            str(seed)])
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        want = example_launches(mod, got)
        check(counts == want, f"examples {name}: launches {counts}, want "
                              f"{want}")
        check(got["rounds"] == len(got["regret"]) > 0
              and all(math.isfinite(r) for r in got["regret"])
              and all(math.isfinite(x) for x in got["losses"]),
              f"examples {name}: {len(got['regret'])} regrets over "
              f"{got['rounds']} rounds / a regret or a loss is not finite")
        out[name] = dict(
            size, **EXAMPLE_STEPS, rounds=got["rounds"],
            regret=got["regret"][-1], slope_ratio=got["slope_ratio"],
            losses=got["losses"], picks=got.get("picks"),
            shares=got.get("shares"), kept=got.get("kept"),
            encoded=got["encoded"], launches=counts, wall_s=got["wall_s"])
    return out


def phase_examples_card_vs_cpu(dev, seed):
    """Each example's ``run`` at ``EXAMPLE_RUNS``' sizes on the card and on
    the CPU from one world and one set of encoder weights (``make_world`` of
    the seed on each device) and one host-mode ``KeyedDraws``, so both see
    the same fine-tuning pairs and SGLD and feedback draws. Held: the
    fine-tuning's epoch losses to rtol 1e-5; the model embeddings and the
    online features to 1e-4 of their largest magnitude; round by round the
    routed pair equal outside near-ties (``compare_pairs`` on the CPU's
    features, embeddings and chain-mean thetas) and the cumulative regret
    to 1e-5 + rtol 1e-5. A near-tie routed differently ends the round
    comparison there, since the two runs' histories part
    (``rounds_compared``). mixinstruct: the ambiguity scores to 1e-6, the
    kept queries and their labels equal. quickstart: where every round was
    compared, the last rounds' picks equal outside near-ties of the CPU's
    final scores."""
    import torch
    from repro_torch.core.ccft import scores_all
    from repro_torch.core.draws import KeyedDraws
    cpu = torch.device("cpu")
    out = {}
    for name, size in EXAMPLE_RUNS.items():
        mod = load_example(name)
        got, ref = [mod.run(*mod.make_world(seed, where, **size),
                            KeyedDraws(seed, host=True), **EXAMPLE_STEPS)
                    for where in (dev, cpu)]
        got = {k: v.cpu() if torch.is_tensor(v) else v
               for k, v in got.items()}
        rec = {}
        for a, b in zip(got["losses"], ref["losses"]):
            check(abs(a - b) <= 1e-5 * abs(b),
                  f"examples card vs cpu {name}: losses {got['losses']} "
                  f"against {ref['losses']}")
        rec["losses"] = dict(card=got["losses"], cpu=ref["losses"])
        for k in ("a_emb", "x"):
            top = rec[f"{k}_largest"] = float(ref[k].abs().max())
            rec[f"{k}_max_abs_err"] = float((got[k] - ref[k]).abs().max())
            check(rec[f"{k}_max_abs_err"] <= 1e-4 * top,
                  f"examples card vs cpu {name}: {k} differs by "
                  f"{rec[f'{k}_max_abs_err']} (largest {top})")
        if "kept" in ref:
            rec["ambiguity_max_abs_err"] = float(
                (got["ambiguity"] - ref["ambiguity"]).abs().max())
            check(rec["ambiguity_max_abs_err"] <= 1e-6
                  and torch.equal(got["kept"], ref["kept"])
                  and torch.equal(got["labels"], ref["labels"]),
                  f"examples card vs cpu {name}: ambiguity off by "
                  f"{rec['ambiguity_max_abs_err']} or the kept queries or "
                  f"their labels differ")
        t = ref["pairs"].shape[0]
        compared, ties = t, 0
        for r in range(t):
            bad, tie, _ = compare_pairs(
                ref["x"][r:r + 1], ref["a_emb"], ref["thetas"][r], None,
                None, True, tuple(got["pairs"][r:r + 1].T),
                tuple(ref["pairs"][r:r + 1].T))
            check(bad == 0, f"examples card vs cpu {name}: round {r} "
                            f"routed {got['pairs'][r].tolist()}, the CPU "
                            f"{ref['pairs'][r].tolist()}, outside a "
                            f"near-tie")
            if tie:
                compared, ties = r, 1
                break
        err = (got["cum"][:compared] - ref["cum"][:compared]).abs()
        rec["cum_max_abs_err"] = float(err.max()) if compared else 0.0
        check(bool((err <= 1e-5 + 1e-5 * ref["cum"][:compared].abs()).all()),
              f"examples card vs cpu {name}: cumulative regret differs by "
              f"{rec['cum_max_abs_err']} over {compared} rounds")
        if compared:
            rec["theta_max_abs_err"] = float(
                (got["thetas"][:compared] - ref["thetas"][:compared])
                .abs().max())
        if "picks" in ref and compared == t:
            i0 = t - ref["picks"].shape[0]
            s = torch.stack([scores_all(ref["x"][i], ref["a_emb"],
                                        ref["thetas"][-1, 0])
                             for i in range(i0, t)])
            tie = top2_gap(s) <= NEAR_TIE * float(s.abs().max())
            off = (got["picks"] != ref["picks"]) & ~tie
            check(not bool(off.any()),
                  f"examples card vs cpu {name}: picks "
                  f"{got['picks'].tolist()}, the CPU "
                  f"{ref['picks'].tolist()}, outside near-ties")
            rec["picks_equal"] = torch.equal(got["picks"], ref["picks"])
        out[name] = dict(rec, rounds=t, rounds_compared=compared,
                         near_tie_stop=ties)
    return out


# ---------------------------------------------------------------------------
# phases 2 and 3: the candidate LMs' generation path
# ---------------------------------------------------------------------------

LM_STEPS = 8
# each model's run at its full config: batch, prompt tokens, the front
# end's rows (vision patches before the text, or audio frames for the
# encoder), and what is cut (arctic-480b: 27.7 GB of bf16 weights a unit,
# and init peaks at the stack plus one unit, so one unit)
LM_RUNS = {
    "mamba2-1.3b": dict(batch=2, tokens=4096),
    "recurrentgemma-9b": dict(batch=2, tokens=4096),
    "granite-moe-3b-a800m": dict(batch=2, tokens=4096),
    "arctic-480b": dict(batch=2, tokens=4096, cut=dict(n_units=1)),
    "seamless-m4t-medium": dict(batch=2, tokens=4096, frames=1024),
    "llava-next-34b": dict(batch=1, tokens=1216, patches=2880),
    "granite-3-2b": dict(batch=2, tokens=4096),
    "qwen2-7b": dict(batch=2, tokens=4096),
    # B 1 x 8192, as its training run: the prompt passes the 4096-token
    # window, so the local layers' prefill keeps the last 4096 tokens at
    # their ring slots and decode wraps the ring at its full size
    "gemma2-9b": dict(batch=1, tokens=8192),
    # 2.77 GB of bf16 weights a unit, 244 GB at its 88 units: 8 units keep
    # the script short (init peaks at the stack plus one unit: 30.3 GB on
    # an NVIDIA H100 80GB HBM3 at 700 W);
    # the record's units_fit_reckoned says how deep 80 GB would go. The
    # config's fsdp=True is a sharding hint of the reference's mesh
    # dry-run; nothing of the port reads it, and on one card it does
    # nothing. Full depth needs several cards (ROADMAP item 5)
    "mistral-large-123b": dict(batch=2, tokens=4096, cut=dict(n_units=8)),
}
# the kernels of each model's prefill, with their launches per prefill
# (seamless: 12 encoder, 12 self and 12 cross attention layers; gemma2:
# 21 local and 21 global layers)
LM_PATHS = {
    "mamba2-1.3b": {"ssd_scan": 48},
    "recurrentgemma-9b": {"rglru_scan": 26, "flash_attention": 12},
    "granite-moe-3b-a800m": {"flash_attention": 32},
    "arctic-480b": {"flash_attention": 1},
    "seamless-m4t-medium": {"flash_attention": 36},
    "llava-next-34b": {"flash_attention": 60},
    "granite-3-2b": {"flash_attention": 40},
    "qwen2-7b": {"flash_attention": 28},
    "gemma2-9b": {"flash_attention": 42},
    "mistral-large-123b": {"flash_attention": 8},
}
# the models whose every moe_ffn call (prefill and decode) runs under
# set_sync_debug_mode("error") in the warm-up
LM_NO_SYNC = ("granite-moe-3b-a800m",)
# each kernel's name in a profile
KERNEL_SYMBOLS = {"ssd_scan": "ssd_kernel", "rglru_scan": "rglru_kernel",
                  "flash_attention": "flash_attention_kernel"}
# the MoE FFN's kernels by profiler name (lower case, first match wins):
# its GEMMs (the expert products and the router), the sort of the
# dispatch, its gathers and scatters; the rest "other" (softmax, SiLU,
# casts, fills)
MOE_GROUPS = {"gemm": ("gemm", "cutlass", "xmma", "nvjet"),
              "sort": ("sort", "radix"),
              "gather_scatter": ("index", "scatter", "gather", "catarray")}


def tree_leaves(tree):
    out = []
    from repro_torch.models.layers import tree_map
    tree_map(out.append, tree)
    return out


def profile_prefill(run, prefill_ms, wrappers):
    """One prefill under ``torch.profiler`` (device activity only): device
    busy time, idle share against the unprofiled prefill, kernels per
    prefill, and the share of busy time of each port kernel, of the GEMMs
    (cuBLAS / CUTLASS kernels) and of the heaviest kernels."""
    import torch
    from repro_torch import profiling
    torch.cuda.synchronize()
    with profiling.cuda_profile() as prof:
        run()
        torch.cuda.synchronize()
    kern = sorted(profiling.kernel_events(prof), key=lambda e: -e[1])
    busy = sum(us for _, us, _ in kern) / 1e3
    share = lambda pred: (sum(us for k, us, _ in kern if pred(k)) / 1e3
                          / busy if busy else None)
    gemm = lambda k: any(w in k.lower() for w in MOE_GROUPS["gemm"])
    return dict(
        device_busy_ms=busy, device_idle_share=1.0 - busy / prefill_ms,
        device_kernels_per_prefill=sum(n for _, _, n in kern),
        kernel_share={w: share(lambda k, w=w: KERNEL_SYMBOLS[w] in k)
                      for w in wrappers},
        gemm_share=share(gemm),
        top_kernels=[[k[:70], us / 1e3, n] for k, us, n in kern[:8]])


def greedy_steps(params, cache, logits, cfg, start, n):
    """``n`` more greedy decode steps after ``logits`` from position
    ``start`` (past the timed run's; they write into ``cache``, which is
    not used after)."""
    from repro_torch.models import lm
    for i in range(n):
        logits, cache = lm.decode_step(params, cache, logits.argmax(-1),
                                       start + i, cfg)


def check_slot_pos(cache, cfg, end, what):
    """Every attention layer's ``slot_pos`` after positions [0, end) went
    through the cache: a full-context layer holds position i at slot i and
    -1 past ``end``; a local layer's ring of ``clen`` slots, once ``end``
    passed it, the last ``clen`` positions p at slot p % clen (the window's
    validity in ``decode_attention`` reads these). Returns the number of
    local layers whose ring wrapped."""
    import torch
    from repro_torch.models.config import (MIXER_CROSS_ATTN,
                                           MIXER_GLOBAL_ATTN,
                                           MIXER_LOCAL_ATTN)
    stacks = [(cache["units"], cfg.pattern)]      # leaves (n_units, ...)
    if cfg.remainder:
        stacks.append((cache["remainder"], cfg.remainder))
    wrapped = 0
    for layers, specs in stacks:
        for j, spec in enumerate(specs):
            if spec.mixer not in (MIXER_GLOBAL_ATTN, MIXER_LOCAL_ATTN,
                                  MIXER_CROSS_ATTN):
                continue
            got = layers[str(j)]["kv"]["slot_pos"]
            clen = got.shape[-1]
            want = torch.full((clen,), -1, dtype=torch.int32)
            if spec.mixer == MIXER_LOCAL_ATTN and end > clen:
                pos = torch.arange(end - clen, end, dtype=torch.int32)
                want[pos.long() % clen] = pos
                wrapped += got.shape[0] if got.dim() == 2 else 1
            else:
                want[:end] = torch.arange(end, dtype=torch.int32)
            check(bool((got.cpu() == want).all()),
                  f"{what}: layer {j} ({spec.mixer}) slot_pos after "
                  f"{end} positions is not the expected ring")
    return wrapped


def lm_config(name, cut=None):
    import dataclasses
    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS[name], **(cut or {}))


def lm_batch(cfg, b, n_tokens, gen, dev, *, patches=0, frames=0):
    """Random prompt tokens and the front end's rows (fp32, cast by the
    model): ``patches`` (B, P, d) before the text, ``frames`` (B, F, d)
    for the encoder. Returns (batch, decoder positions)."""
    import torch
    out = {"tokens": torch.randint(0, cfg.vocab_size, (b, n_tokens),
                                   generator=gen, device=dev)}
    if patches:
        out["patches"] = torch.randn((b, patches, cfg.d_model),
                                     generator=gen, device=dev)
    if frames:
        out["frames"] = torch.randn((b, frames, cfg.d_model), generator=gen,
                                    device=dev)
    return out, n_tokens + patches


class MoeSpy:
    """Wraps ``models.moe.moe_ffn`` while in a ``with``: counts the calls
    (``calls``: prefill, a sequence; ``decode_calls``: one token) and keeps
    each call's (expert params, input, impl) in ``records`` (the prefill's
    only, unless ``decode`` is set). With ``no_sync`` each call runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside
    ``moe_ffn`` fails the phase."""

    def __init__(self, what, no_sync=False, decode=False):
        self.what, self.no_sync, self.decode = what, no_sync, decode
        self.records, self.calls, self.decode_calls = [], 0, 0

    def __enter__(self):
        from repro_torch.models import moe
        self.real = moe.moe_ffn
        moe.moe_ffn = self
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe_ffn = self.real

    def __call__(self, params, x, cfg, impl="sparse"):
        import torch
        one = x.shape[1] == 1
        self.decode_calls += one
        self.calls += not one
        if not one or self.decode:
            self.records.append((params, x, impl))
        if not self.no_sync:
            return self.real(params, x, cfg, impl)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return self.real(params, x, cfg, impl)
        except RuntimeError as e:
            raise CheckFailed(f"lm {self.what}: moe_ffn ({impl}) "
                              f"synchronised with the card: {e}") from e
        finally:
            torch.cuda.set_sync_debug_mode(0)


def moe_layer_stats(records, cfg, factor=1.25):
    """Per MoE layer of a prefill, from its input: tokens per expert (min,
    max) and the share of assignments dropped at ``factor``."""
    import torch
    from repro_torch.models import moe
    rows = []
    for p, x, _ in records:
        n = x.shape[0] * x.shape[1]
        _, idx, _ = moe._route(p, x.reshape(n, -1), cfg)
        counts = torch.zeros((cfg.n_experts,), device=x.device).index_add_(
            0, idx.reshape(-1), torch.ones((idx.numel(),), device=x.device))
        over = (counts - moe.capacity(n, cfg, factor)).clamp(min=0).sum()
        rows.append(torch.stack([counts.min(), counts.max(),
                                 over / idx.numel()]))
    t = torch.stack(rows).T.tolist()
    n = records[0][1].shape[0] * records[0][1].shape[1]
    return dict(capacity_factor=factor, capacity=moe.capacity(n, cfg, factor),
                assignments=n * cfg.top_k,
                tokens_per_expert_min=[int(v) for v in t[0]],
                tokens_per_expert_max=[int(v) for v in t[1]],
                dropped_share=t[2])


def moe_profile(records, cfg, busy_ms):
    """The prefill's MoE FFNs again, each on its recorded input, under
    ``torch.profiler`` (device activity only): device ms by ``MOE_GROUPS``
    over all the layers, and each group's share of the prefill's busy
    time."""
    import torch
    from repro_torch import profiling
    from repro_torch.models import moe
    torch.cuda.synchronize()
    with profiling.cuda_profile() as prof:
        for p, x, impl in records:
            moe.moe_ffn(p, x, cfg, impl)
        torch.cuda.synchronize()
    ms = dict.fromkeys([*MOE_GROUPS, "other"], 0.0)
    for key, us, _ in profiling.kernel_events(prof):
        g = next((g for g, subs in MOE_GROUPS.items()
                  if any(x in key.lower() for x in subs)), "other")
        ms[g] += us / 1e3
    total = sum(ms.values())
    return dict(layers=len(records), device_ms=total, device_ms_by_group=ms,
                share_of_prefill=total / busy_ms,
                share_of_prefill_by_group={g: v / busy_ms
                                           for g, v in ms.items()})


def phase_lm(dev, seed):
    """The candidate LMs at their full configs (``LM_RUNS``; random bf16
    weights from a generator on the card): ``lm.prefill`` of the prompt
    (cache_len S + 10: the timed and the profiled steps), then 8 greedy
    ``lm.decode_step``s, as
    ``examples/routed_serving_e2e.py::greedy_decode`` does. One warm-up
    run first (for ``LM_NO_SYNC``: every ``moe_ffn`` call under
    ``set_sync_debug_mode("error")``; each MoE layer's prefill input kept);
    then the launch counts are reset, the path runs timed, and the counts
    are read after the prefill and after the decode: each kernel of the
    model's prefill exactly ``LM_PATHS`` times, nothing from decode. One
    more prefill and two more decode steps run under the profiler (device
    activity only). After the timed decode every attention layer's
    ``slot_pos`` must be what ``check_slot_pos`` expects (a local layer's
    ring wrapped where the prompt passed its window); a cut run records
    the depth the card's memory would hold at its peak (reckoned, not
    run). For an MoE model, its FFNs once more on the kept
    inputs, profiled by kernel group, and per layer the tokens per expert
    and the dropped share at capacity factor 1.25."""
    import torch
    from repro_torch import kernels
    from repro_torch.models import lm
    out = {}
    for name, per_prefill in LM_PATHS.items():
        run = LM_RUNS[name]
        cfg = lm_config(name, run.get("cut"))
        b = run["batch"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = lm.init_params(gen, cfg, device=dev)
        batch, s = lm_batch(cfg, b, run["tokens"], gen, dev,
                            patches=run.get("patches", 0),
                            frames=run.get("frames", 0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated(dev)
        leaves = tree_leaves(params)
        cache_len = s + LM_STEPS + 2
        with MoeSpy(name, no_sync=name in LM_NO_SYNC) as spy:
            last, cache = lm.prefill(params, batch, cfg, cache_len)  # warm-up
            lm.decode_step(params, cache, last.argmax(-1), s, cfg)
        del last, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)

        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        last, cache = lm.prefill(params, batch, cfg, cache_len)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        per = kernels.launch_counts()
        logits, generated = [last], []
        nxt = last.argmax(-1)
        for i in range(LM_STEPS):
            generated.append(nxt)
            lg, cache = lm.decode_step(params, cache, nxt, s + i, cfg)
            logits.append(lg)
            nxt = lg.argmax(-1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)

        for k, n in per.items():
            want = per_prefill.get(k, 0)
            check(n == want, f"lm {name}: {n} {k} launches per prefill, "
                             f"want {want}")
        check(counts == per, f"lm {name}: decode launched a kernel: "
                             f"{counts} after the prefill's {per}")
        lg = torch.stack(logits)
        check(lg.shape == (LM_STEPS + 1, b, cfg.vocab_size)
              and bool(torch.isfinite(lg).all()),
              f"lm {name}: logits {tuple(lg.shape)} / not finite")
        toks = torch.stack(generated, dim=1)
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"lm {name}: generated tokens out of range")
        wrapped = check_slot_pos(cache, cfg, s + LM_STEPS, f"lm {name}")
        depth = {}
        if run.get("cut"):
            # a unit's weights and its decode cache (twice: the prefill
            # stacks the units' caches into a new tree)
            unit_gb = (sum(t.numel() * t.element_size()
                           for t in tree_leaves(params["units"]))
                       + 2 * sum(t.numel() * t.element_size()
                                 for t in tree_leaves(cache["units"]))
                       ) / cfg.n_units / 1e9
            card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
            full = lm_config(name).n_units
            depth = dict(
                n_units=cfg.n_units, full_n_units=full, unit_gb=unit_gb,
                units_fit_reckoned=min(full, cfg.n_units + int(
                    (card_gb - peak / 1e9) // unit_gb)))
        prefill_ms = 1e3 * (t1 - t0)
        out[name] = dict(
            params=sum(t.numel() for t in leaves),
            weights_gb=sum(t.numel() * t.element_size() for t in leaves)
            / 1e9, init_s=init_s, init_peak_memory_gb=init_peak / 1e9,
            n_layers=cfg.n_layers,
            n_enc_layers=cfg.n_enc_layers, cut=run.get("cut"), batch=b,
            prompt_len=s, prompt_tokens=run["tokens"],
            patches=run.get("patches", 0), frames=run.get("frames", 0),
            decode_steps=LM_STEPS, prefill_ms=prefill_ms,
            prompt_tokens_per_s=b * s / (t1 - t0),
            decode_ms_per_token=1e3 * (t2 - t1) / LM_STEPS,
            peak_memory_gb=peak / 1e9, **depth, window=cfg.window,
            ring_layers_wrapped=wrapped, launches_per_prefill=per,
            launches=counts, generated=toks.tolist(),
            profile=profile_prefill(
                lambda: lm.prefill(params, batch, cfg, cache_len),
                prefill_ms, per_prefill),
            decode_profile=profile_ticks(
                lambda n: greedy_steps(params, cache, logits[-1], cfg,
                                       s + LM_STEPS, n),
                1e3 * (t2 - t1) / LM_STEPS))
        if cfg.n_experts:
            moe_layers = sum(sp.ffn.startswith("moe")
                             for sp in cfg.all_specs())
            check(spy.calls == moe_layers and spy.decode_calls == moe_layers,
                  f"lm {name}: {spy.calls} / {spy.decode_calls} moe_ffn "
                  f"calls in the warm-up prefill / decode step, want "
                  f"{moe_layers}")
            out[name].update(
                moe_calls_without_sync=(spy.calls + spy.decode_calls
                                        if spy.no_sync else 0),
                moe_layers=moe_layer_stats(spy.records, cfg),
                moe_profile=moe_profile(
                    spy.records, cfg,
                    out[name]["profile"]["device_busy_ms"]))
        del params, leaves, cache, logits, lg, last, spy, batch
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# lm_train: make_train_step on the card
# ---------------------------------------------------------------------------

LM_TRAIN_STEPS = 3
# each training run: batch, sequence (text, or patches + text for llava),
# and its depth cut. granite-3-2b trains at full width and depth (the
# reference's train_4k length); the rest at full width. The cuts keep this
# script's wall time down, not 80 GB: each cut run keeps the fewest units
# that run its layers, and its record's peak_memory_gb and
# units_fit_reckoned say how much deeper 80 GB would let it go. At full
# depth none of the four cut models fits one card: their weights,
# gradients and AdamW moments alone take 12 bytes a parameter (~110 GB for
# the 9 B models, ~91 GB for qwen2-7b, ~410 GB for llava-next-34b).
LM_TRAIN_RUNS = {
    "granite-3-2b": dict(batch=2, seq=4096),
    # the RG-LRU backward and the local-window attention backward at D 256
    # with MQA: one unit (2 RG-LRU + 1 local) plus the remainder (2 RG-LRU)
    "recurrentgemma-9b": dict(batch=1, seq=4096, cut=dict(n_units=1)),
    # soft cap 50 and window 4096 at D 256, at S 8192 so the window bites:
    # 1 of 21 units (1 local + 1 global layer)
    "gemma2-9b": dict(batch=1, seq=8192, cut=dict(n_units=1)),
    # the qkv biases: 4 of 28 units
    "qwen2-7b": dict(batch=2, seq=4096, cut=dict(n_units=4)),
    # the MoE FFN's gradient, full depth (3.3 B parameters, ~40 GB with
    # grads and moments)
    "granite-moe-3b-a800m": dict(batch=2, seq=4096),
    # bidirectional encoder over 1024 frames, cross attention at S 4096
    # over T 1024, full depth (12 + 12 units)
    "seamless-m4t-medium": dict(batch=2, seq=4096),
    # vis_proj's gradient, 2880 patches + 1216 tokens: 1 of 60 units
    "llava-next-34b": dict(batch=1, seq=4096, cut=dict(n_units=1)),
    # the SSD scan's backward, full depth (1.3 B parameters: ~16 GB of
    # weights, gradients and fp32 moments; reckoned before its first run,
    # the saved unit inputs 1.6 GB, the fp32 logits and their gradient
    # ~3.3 GB, one unit's recompute and the backward's scratch ~2 GB)
    "mamba2-1.3b": dict(batch=2, seq=4096),
}
# each run's kernel launches per training step (forward, the units'
# rematerialised forward, backward): remat runs a unit's attention and
# RG-LRU forward twice, the remainder's once
LM_TRAIN_PATHS = {
    "granite-3-2b": {"flash_attention": 80, "flash_attention_bwd": 40},
    "recurrentgemma-9b": {"flash_attention": 2, "flash_attention_bwd": 1,
                          "rglru_scan": 6, "rglru_scan_bwd": 4},
    "gemma2-9b": {"flash_attention": 4, "flash_attention_bwd": 2},
    "qwen2-7b": {"flash_attention": 8, "flash_attention_bwd": 4},
    "granite-moe-3b-a800m": {"flash_attention": 64,
                             "flash_attention_bwd": 32},
    "seamless-m4t-medium": {"flash_attention": 72,
                            "flash_attention_bwd": 36},
    "llava-next-34b": {"flash_attention": 2, "flash_attention_bwd": 1},
    "mamba2-1.3b": {"ssd_scan": 96, "ssd_scan_bwd": 48},
}
# the training step's device time by kernel group (first match wins, by
# substring: attention_bwd's names also match the Hopper design's
# bwd_kv_kernel_sm90 and bwd_q_kernel_sm90, and "ssd" comes first, since
# ssd_bwd_reduce_kernel contains "bwd_reduce_kernel"; the optimizer is
# profiled on its own)
TRAIN_GROUPS = {
    "ssd": ("ssd_kernel", "ssd_bwd_"),
    "attention_fwd": ("flash_attention_kernel",),
    "attention_bwd": ("bwd_kv_kernel", "bwd_q_kernel", "bwd_reduce_kernel",
                      "delta_kernel"),
    "rglru": ("rglru_kernel", "rglru_bwd_kernel"),
    "gemm": ("gemm", "cutlass", "xmma", "nvjet", "Kernel2"),
}


# the model whose training step is run once more with the bf16 attention
# backward forced to the SIMT kernels' Large configuration
BWD_DESIGN_CHECK = "granite-3-2b"
# the models whose training step must run the SSD backward's Hopper kernels
SSD_BWD_SM90_CHECK = ("mamba2-1.3b",)


def bwd_design_check(params, batch, cfg):
    """``launch.steps.loss_and_grads`` at full width under the plan's bf16
    attention backward (the Hopper design at head dim 64) against the same
    step with every ``flash_attention_bwd`` call forced to Large (the SIMT
    kernels built for bf16, the design before it): the losses equal (the
    forward is the same kernels) and every gradient leaf within
    ``ATTN_BWD_BF16_TOL`` of its largest magnitude under Large."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps as steps_lib
    t0 = time.perf_counter()
    heads = (2, cfg.n_heads, cfg.n_kv_heads, 4096, 4096, cfg.hd, True,
             cfg.window, torch.bfloat16)
    plan = fa.bwd_plan
    check(plan(*heads).cfg == fa.BWD_SM90,
          f"lm_train {cfg.name}: the plan does not take the Hopper design")
    loss, _, grads = steps_lib.loss_and_grads(params, batch, cfg)
    fa.bwd_plan = lambda *args: plan(*args, cfg=fa.BWD_LARGE)
    try:
        loss_large, _, grads_large = steps_lib.loss_and_grads(params, batch,
                                                              cfg)
    finally:
        fa.bwd_plan = plan
    loss, loss_large = float(loss), float(loss_large)
    check(loss == loss_large, f"lm_train {cfg.name}: the loss {loss} under "
                              f"the Hopper design is not Large's {loss_large}")
    worst, worst_leaf = 0.0, None
    names, leaves = _named_leaves(grads)
    for leaf, g, w in zip(names, leaves, tree_leaves(grads_large)):
        top = float(w.float().abs().max())
        rel = float((g.float() - w.float()).abs().max()) / max(top, 1e-30)
        check(rel <= ATTN_BWD_BF16_TOL,
              f"lm_train {cfg.name}: gradient {leaf} under the Hopper design "
              f"off Large's by {rel} of its max")
        if rel > worst:
            worst, worst_leaf = rel, leaf
    torch.cuda.synchronize()
    return dict(plan=plan(*heads)._asdict(), against_cfg=fa.BWD_LARGE,
                loss=loss, loss_large=loss_large, leaves=len(names),
                max_rel_grad_err=worst, worst_leaf=worst_leaf,
                seconds=time.perf_counter() - t0)


def phase_lm_train(dev, seed):
    """``launch.steps.make_train_step`` (AdamW in place, weight decay 0.1,
    lr 3e-4, each unit rematerialised) at full width for each model of
    ``LM_TRAIN_RUNS``, bf16 weights made on the card from the seed and
    ``launch.train.synthetic_batch`` batches from ``TorchDraws``. Per run:
    one warm-up step, then the launch counts are reset and 3 timed steps
    run (host ms each, synchronised); the counts per step must equal
    ``LM_TRAIN_PATHS`` exactly and every loss must be finite. Then one
    step's two halves run under the profiler (device activity only): the
    loss and gradients by kernel group (``TRAIN_GROUPS``), and the AdamW
    update as the optimizer group; the idle share is against the
    unprofiled step. granite-3-2b's step also runs once more with the
    bf16 attention backward forced from the Hopper design to Large
    (``bwd_design_check``). Peak memory over the timed steps; for a cut
    run also
    the state a unit adds (weight and gradient in the leaf's dtype, fp32
    moments, and the unit's saved bf16 input) and the depth that the
    card's memory would hold at that rate (reckoned, not run)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.draws import TorchDraws
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init, adamw_update_
    out = {}
    for name, run in LM_TRAIN_RUNS.items():
        cfg = lm_config(name, run.get("cut"))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        params = lm.init_params(gen, cfg, device=dev)
        opt = adamw_init(params)
        draws = TorchDraws(seed, dev)
        batches = [train_lib.synthetic_batch(draws, cfg, run["batch"],
                                             run["seq"], dev)
                   for _ in range(LM_TRAIN_STEPS + 2)]
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        step = steps_lib.make_train_step(cfg)
        params, opt, m0 = step(params, opt, batches[0])       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        losses, ms = [float(m0["loss"])], []
        for b in batches[1:LM_TRAIN_STEPS + 1]:
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, b)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        per_step = {k: v / LM_TRAIN_STEPS for k, v in counts.items() if v}
        want = LM_TRAIN_PATHS[name]
        check(per_step == want, f"lm_train {name}: launches per step "
                                f"{per_step}, want {want}")
        check(all(math.isfinite(x) for x in losses),
              f"lm_train {name}: non-finite losses {losses}")
        step_ms = statistics.median(ms)
        b_last = batches[-1]
        grads = []
        fwd_bwd = profile_ticks(
            lambda n: grads.append(steps_lib.loss_and_grads(
                params, b_last, cfg)[2]), step_ms, ticks=1,
            groups=TRAIN_GROUPS)
        opt_prof = profile_ticks(
            lambda n: adamw_update_(params, grads[-1], opt, 3e-4,
                                    weight_decay=0.1), step_ms, ticks=1)
        del grads
        ssd_names = None
        if name in SSD_BWD_SM90_CHECK:
            ssd_names = fwd_bwd["kernel_names_by_group"]["ssd"]
            check(all(any(k in key for key in ssd_names)
                      for k in SSD_BWD_SM90_KERNELS)
                  and not any(k in key for key in ssd_names
                              for k in SSD_BWD_KERNELS),
                  f"lm_train {name}: the SSD group ran {ssd_names}, want "
                  f"the Hopper backward {SSD_BWD_SM90_KERNELS}")
        design = (bwd_design_check(params, b_last, cfg)
                  if name == BWD_DESIGN_CHECK else None)
        busy = (fwd_bwd["device_busy_ms_per_tick"]
                + opt_prof["device_busy_ms_per_tick"])
        groups = dict(fwd_bwd["device_ms_per_tick_by_group"],
                      optimizer=opt_prof["device_busy_ms_per_tick"])
        tokens = run["batch"] * run["seq"]
        leaves = tree_leaves(params)
        depth = {}
        if run.get("cut"):
            unit_gb = (sum(t.numel() * (2 * t.element_size() + 8)
                           for t in tree_leaves(params["units"]))
                       / cfg.n_units + 2 * tokens * cfg.d_model) / 1e9
            card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
            depth = dict(
                n_units=cfg.n_units,
                full_n_units=lm_config(name).n_units,
                unit_state_gb=unit_gb,
                units_fit_reckoned=min(
                    lm_config(name).n_units,
                    cfg.n_units + int((card_gb - peak / 1e9) // unit_gb)))
        out[name] = dict(
            params=sum(t.numel() for t in leaves), n_layers=cfg.n_layers,
            n_enc_layers=cfg.n_enc_layers, cut=run.get("cut"),
            batch=run["batch"], seq=run["seq"], tokens_per_step=tokens,
            init_s=init_s, losses=losses, ms_per_step=ms,
            median_ms_per_step=step_ms, tokens_per_s=tokens / step_ms * 1e3,
            device_ms_per_step=busy, device_idle_share=1.0 - busy / step_ms,
            device_ms_by_group=groups,
            device_kernels_per_step=(fwd_bwd["device_kernels_per_tick"]
                                     + opt_prof["device_kernels_per_tick"]),
            top_kernels=fwd_bwd["top_kernels_ms_per_tick"],
            peak_memory_gb=peak / 1e9, **depth, launches_per_step=per_step,
            launches=counts)
        if design:
            out[name]["bwd_design_check"] = design
        if ssd_names:
            out[name]["ssd_kernels"] = ssd_names
        del params, opt, batches, b_last, leaves, step
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# lm_dryrun: one rank's share of the LM mesh programs on the card
# ---------------------------------------------------------------------------

def share_call_bound(call):
    """(bound ms, "bytes" or "operations") of one kernel call of a dry-run
    share's plan: its operations as the plan counts them (``call["flops"]``:
    attention 4 D a live pair, backward 10 D; the SSD scan's chunked
    products; none for the elementwise RG-LRU), the bf16 SSD backward's
    per-head products 3x as phase 1 counts them (fp32 operands); q / k /
    v / o (and dO, dq, dk, dv, lse), x / B / C / log_a / dt / y, the
    RG-LRU's 12 (backward 24) bytes an element moved once."""
    from repro_torch.launch import dryrun as dr
    kernel, a = call["kernel"], call["args"]
    n = lambda x: math.prod(x["shape"])
    bf16 = a[0]["dtype"] == "bfloat16"
    el = 2 if bf16 else 4
    peak = BF16_FLOP_PER_S if bf16 else FP32_FLOP_PER_S
    flops = call["flops"]
    if kernel.startswith("flash_attention"):
        b, h, s, d = a[0]["shape"]
        if kernel == "flash_attention":
            return bound(el * (2 * n(a[0]) + 2 * n(a[1])), flops, peak)
        return bound(el * (4 * n(a[0]) + 4 * n(a[1])) + 4 * b * h * s,
                     flops, peak)
    if kernel.startswith("ssd_scan"):
        b, s, h, p = a[0]["shape"]
        nn = a[1]["shape"][-1]
        if kernel == "ssd_scan":
            nbytes = (el * (b * s * h * p + 2 * b * s * nn) + 8 * b * s * h
                      + 4 * b * s * h * p + 4 * b * h * p * nn)
        else:
            if bf16:        # the per-head part 3x: all less C.B^T's
                shared = dr.ssd_flops(b, s, 0, p, nn, call["chunk"])
                flops = shared + 3 * (flops - shared)
            nbytes = (2 * el * (b * s * h * p + 2 * b * s * nn)
                      + 16 * b * s * h + 4 * b * s * h * p
                      + 4 * b * h * p * nn)
        return bound(nbytes, flops, peak)
    b, s, d = a[1]["shape"]
    if kernel == "rglru_scan":
        return bound(12 * b * s * d + 4 * b * d, flops)
    return bound(24 * b * s * d + 4 * b * d, flops)


def share_call_ms(call, dev, plain=False):
    """CUDA-event ms of one kernel call of a dry-run share's plan, alone,
    on random inputs of its shapes, strides and dtypes (decays drawn as
    the models draw them: log_a = -softplus(x) scaled). ``plain``: the
    same call on the kernel's plain version (the attention a few batch
    rows at a time, as the share's plain run takes it: ``dr.PLAIN_SCORES``
    scores a chunk), timed over fewer calls."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import dryrun as dr
    gen = torch.Generator(device=dev).manual_seed(0)

    def make(a, scale=1.0):
        t = torch.empty_strided(a["shape"], a["stride"],
                                dtype=getattr(torch, a["dtype"]), device=dev)
        t.copy_(scale * torch.randn(a["shape"], generator=gen, device=dev))
        return t
    kernel, a = call["kernel"], call["args"]
    timed = (lambda fn: time_ms(fn, runs=1, calls=3, warmup=1)) if plain \
        else (lambda fn: time_ms(fn, runs=3, calls=5))
    if kernel.startswith("flash_attention"):
        q, k, v = (make(x) for x in a[:3])
        kw = dict(causal=call["causal"], window=call["window"],
                  softcap=call["softcap"])
        if plain:
            b, h, s, _ = q.shape
            n = max(1, dr.PLAIN_SCORES // (h * s * k.shape[2]))
            rows = [slice(i, i + n) for i in range(0, b, n)]
        if kernel == "flash_attention":
            if plain:
                return timed(lambda: [fa.flash_attention_plain(
                    q[r], k[r], v[r], **kw) for r in rows])
            return timed(lambda: fa.flash_attention(q, k, v, **kw))
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        do = make(a[4])
        if plain:
            return timed(lambda: [fa.flash_attention_bwd_plain(
                q[r], k[r], v[r], o[r], lse[r], do[r], **kw) for r in rows])
        return timed(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **kw))
    if kernel.startswith("ssd_scan"):
        x, bt, ct = (make(y) for y in a[:3])
        dt = torch.nn.functional.softplus(make(a[4]))
        log_a = -0.5 * dt
        if kernel == "ssd_scan":
            fwd = ss.ssd_scan_plain if plain else ss.ssd_scan
            return timed(lambda: fwd(x, bt, ct, log_a, dt,
                                     chunk=call["chunk"]))
        dy = make(a[5])
        bwd = ss.ssd_scan_bwd_plain if plain else ss.ssd_scan_bwd
        return timed(lambda: bwd(x, bt, ct, log_a, dt, None, dy, None,
                                 chunk=call["chunk"]))
    log_a = -torch.nn.functional.softplus(make(a[0])) * 0.1
    x = make(a[1])
    if kernel == "rglru_scan":
        fwd = rg.rglru_scan_plain if plain else rg.rglru_scan
        return timed(lambda: fwd(log_a, x))
    h, h_last = rg.rglru_scan(log_a, x)
    dh = make(a[3])
    bwd = rg.rglru_scan_bwd_plain if plain else rg.rglru_scan_bwd
    return timed(lambda: bwd(log_a, x, None, h, dh,
                             torch.ones_like(h_last)))


def share_library(calls, dev):
    """SDPA's forward and backward ms (CUDA events) over a share's bf16
    attention calls, on random inputs of their shapes and masks (a window
    as a dense boolean mask), or None where a call has a soft cap."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    fwd = bwd = 0.0
    gen = torch.Generator(device=dev).manual_seed(0)
    for c in calls:
        if c["kernel"] != "flash_attention":
            continue
        if c["softcap"]:
            return None, None
        q_s, k_s = c["args"][0]["shape"], c["args"][1]["shape"]
        mk = lambda shape: torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16).requires_grad_(True)
        q, k, v = mk(q_s), mk(k_s), mk(k_s)
        kw = dict(enable_gqa=q_s[1] != k_s[1])
        if c["window"]:
            kw["attn_mask"] = fa.live_mask(q_s[2], k_s[2], causal=True,
                                           window=c["window"], device=dev)
        elif c["causal"]:
            kw["is_causal"] = True
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, **kw)
        o = sdpa()
        do = torch.randn_like(o)
        fwd += time_ms(lambda: sdpa().detach(), runs=3, calls=5)
        bwd += time_ms(lambda: torch.autograd.grad(
            o, (q, k, v), do, retain_graph=True), runs=3, calls=5)
        del o, q, k, v, do
    return fwd, bwd


# a share against itself on the plain versions, outputs and each gradient
# relative to its largest plain magnitude: the bf16 attention's and its
# backward's tolerance (ATTN_TOL, ATTN_BWD_BF16_TOL), the loosest of the
# shares' kernels
SHARE_TOL = 2e-2


def phase_lm_dryrun(dev, seed):
    """``launch/dryrun.py``: the reckoning of ``SHARES``' archs at
    train_4k on 16 x 16 (a fake world, destroyed after), each share's
    plan held to the kernels' shape rules (``check_plan``) before any
    launch, then one rank's share of each timed on the card
    (``time_shares``): launches exactly the plan's, each kernel with
    device time in its profile window (``WINDOW_MS``), the shards' bytes
    the reckoning's (counted apart: ``unit_share_bytes``), the share's
    outputs and every gradient within ``SHARE_TOL`` of the same share run
    on the plain versions (same inputs, every kernel at the share's own
    shapes, strides and masks); each kernel's bound (the sum over its
    calls of ``share_call_bound``) and SDPA's time where it computes the
    same function; each kernel's calls timed alone (CUDA events, summed
    over the share's calls of it: ``ms``), and on its plain version
    (``plain_ms``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun as dr
    t0 = time.perf_counter()
    recs = dr.reckon_shares()
    check(not dist.is_initialized(), "lm_dryrun: the fake world was left")
    reckon_s = time.perf_counter() - t0
    routes = {a: dr.check_plan(dr.plan(r)) for a, r in recs.items()}
    check(all(set(v) == {"sm90"} for v in routes.values()),
          f"lm_dryrun: a share's kernel call leaves the Hopper routes "
          f"{routes}")
    t1 = time.perf_counter()
    shares = dr.time_shares(recs, dev, seed=seed)
    out = {}
    for sh in shares:
        arch = sh["arch"]
        check(sh["launches"] == sh["plan_launches"],
              f"lm_dryrun {arch}: launches {sh['launches']}, the plan's "
              f"{sh['plan_launches']}")
        check(all(sh["kernel_device_ms"].get(k, 0.0) > 0
                  for k in sh["plan_launches"]),
              f"lm_dryrun {arch}: a kernel with no device time in "
              f"{sorted(sh['device_ms_by_kernel'])}")
        check(sh["param_bytes"] == sh["reckoned_param_bytes"],
              f"lm_dryrun {arch}: shard bytes {sh['param_bytes']}, the "
              f"reckoning's {sh['reckoned_param_bytes']}")
        pl = sh["plain"]
        check(pl["finite"] and pl["out_rel_err"] <= SHARE_TOL
              and pl["grad_rel_err"] <= SHARE_TOL,
              f"lm_dryrun {arch}: against the plain versions {pl}")
        calls = sh.pop("plan")
        kernels = {}
        for k, launches in sh["plan_launches"].items():
            bounds = [share_call_bound(c) for c in calls
                      if c["kernel"] == k]
            total = sum(b for b, _ in bounds)
            kernels[k] = dict(
                launches=sh["launches"][k], device_ms=sh["kernel_device_ms"][
                    k], bound_ms=total, bound_by=max(
                    bounds, key=lambda x: x[0])[1],
                ms=sum(share_call_ms(c, dev) for c in calls
                       if c["kernel"] == k),
                plain_ms=sum(share_call_ms(c, dev, plain=True)
                             for c in calls if c["kernel"] == k),
                # the share's against its plain run (all its kernels)
                out_rel_err=pl["out_rel_err"],
                grad_rel_err=pl["grad_rel_err"],
                shapes=[c["args"][0]["shape"] for c in calls
                        if c["kernel"] == k])
        lib_fwd, lib_bwd = share_library(calls, dev)
        if "flash_attention" in kernels:
            kernels["flash_attention"]["library_ms"] = lib_fwd
            kernels["flash_attention_bwd"]["library_ms"] = lib_bwd
        rec = recs[arch]
        out[arch] = dict(
            sh, kernels=kernels, peak_memory_gb=sh["peak_bytes"] / 1e9,
            reckoning=dict(bytes=rec["bytes"], flops=rec["flops"],
                           unit_flops=rec["unit_flops"],
                           collectives=rec["collectives"],
                           collective_bytes=rec["collective_bytes"]))
        torch.cuda.empty_cache()
    return dict(shares=out, reckon_s=reckon_s,
                card_s=time.perf_counter() - t1,
                seconds=time.perf_counter() - t0)


# full width in fp32 at a smaller depth, for the card against the CPU
# (arctic-480b also at 16 of its 128 experts, so the CPU can run it;
# gemma2-9b's one local and one global layer with the window cut to 64,
# so the CPU's prompt of 128 passes it and decode wraps the ring;
# mistral-large-123b's one unit is ~8.8 GB in fp32 on each side)
LM_CPU_CUTS = {"mamba2-1.3b": dict(n_units=2),
               "recurrentgemma-9b": dict(n_units=1, remainder=()),
               "granite-moe-3b-a800m": dict(n_units=2),
               "arctic-480b": dict(n_units=1, n_experts=16),
               "seamless-m4t-medium": dict(n_units=2, enc_n_units=2,
                                           enc_frames=256),
               "llava-next-34b": dict(n_units=1, n_frontend_tokens=64),
               "granite-3-2b": dict(n_units=2),
               "qwen2-7b": dict(n_units=2),
               "gemma2-9b": dict(n_units=1, window=64),
               "mistral-large-123b": dict(n_units=1)}
# batch and prompt tokens of each card-vs-CPU run (S 500: a ragged SSD
# tail for the recurrent models)
LM_CPU_RUNS = {"mamba2-1.3b": (2, 500), "recurrentgemma-9b": (2, 500),
               "granite-moe-3b-a800m": (2, 128), "arctic-480b": (2, 128),
               "seamless-m4t-medium": (2, 128), "llava-next-34b": (1, 128),
               "granite-3-2b": (2, 128), "qwen2-7b": (2, 128),
               "gemma2-9b": (2, 128), "mistral-large-123b": (2, 128)}


def moe_layer_check(name, cfg, g_records, c_records, dev):
    """Each MoE call of the card-vs-CPU run (prefill layers, then decode
    steps) on the card from the CPU's input to it, against the CPU:
    experts equal, and (where no decision flipped in the call) the kept
    and dropped assignments equal, on every token whose CPU gap between
    the k-th and (k+1)-th router logit exceeds ``NEAR_TIE`` of the largest
    |logit|; the sparse and dense outputs on those tokens within 1e-4 of
    their largest magnitude. Also the card's own run: the calls where its
    experts differ from the CPU's (e2e flips, each at a near-tie, else the
    check fails)."""
    import torch
    from repro_torch.models import moe
    cpu = torch.device("cpu")
    k, e = cfg.top_k, cfg.n_experts
    rows, e2e_flips = [], []
    prefill_calls = sum(x.shape[1] > 1 for _, x, _ in c_records)
    for i, ((gp, gx, _), (cp, cx, _)) in enumerate(zip(g_records,
                                                       c_records)):
        what = (f"prefill layer {i}" if i < prefill_calls else
                f"decode call {i - prefill_calls}")
        n = cx.shape[0] * cx.shape[1]
        xf = cx.reshape(n, -1)
        logits = xf @ cp["router"]
        top = torch.sort(logits, dim=-1, descending=True).values
        near = (top[:, k - 1] - top[:, k]) <= NEAR_TIE * float(
            logits.abs().max())
        _, c_idx, _ = moe._route(cp, xf, cfg)
        _, g_idx, _ = moe._route(gp, xf.to(dev), cfg)
        flip = (g_idx.to(cpu) != c_idx).any(-1)
        check(not bool((flip & ~near).any()),
              f"lm card vs cpu {name}: {what}: experts differ outside "
              f"near-ties")
        _, e2e_idx, _ = moe._route(gp, gx.reshape(n, -1), cfg)
        e2e = (e2e_idx.to(cpu) != c_idx).any(-1)
        check(not bool((e2e & ~near).any()),
              f"lm card vs cpu {name}: {what}: the card's run chose other "
              f"experts outside near-ties")
        if bool(e2e.any()):
            e2e_flips.append(what)
        c = moe.capacity(n, cfg)
        c_keep = (moe.dispatch(c_idx, e, c)[2] < e * c).reshape(n, k)
        g_keep = (moe.dispatch(g_idx, e, c)[2] < e * c).to(cpu).reshape(n, k)
        if not bool(flip.any()):
            check(torch.equal(g_keep, c_keep),
                  f"lm card vs cpu {name}: {what}: dropped assignments "
                  f"differ")
        ok = ~near & ~flip & (g_keep == c_keep).all(-1)
        row = dict(call=what, tokens=n, near_ties=int(near.sum()),
                   flips=int(flip.sum()), dropped=int((~c_keep).sum()))
        for impl in ("sparse", "dense"):
            want = moe.moe_ffn(cp, cx, cfg, impl)[0].reshape(n, -1)
            got = moe.moe_ffn(gp, cx.to(dev), cfg, impl)[0].to(
                cpu).reshape(n, -1)
            rows_ok = ok if impl == "sparse" else ~near
            err = float((got - want)[rows_ok].abs().max()) if bool(
                rows_ok.any()) else 0.0
            scale = float(want.abs().max())
            row[f"{impl}_max_rel_err"] = err / scale
            check(err <= 1e-4 * scale,
                  f"lm card vs cpu {name}: {what}: moe_ffn {impl} off by "
                  f"{err}")
        rows.append(row)
    return rows, e2e_flips


def phase_lm_card_vs_cpu(dev, seed):
    """Each model at full width in fp32 (``LM_CPU_CUTS``), weights made
    once on the card from the seed and copied to the CPU; the prompts of
    ``LM_CPU_RUNS`` (with the cut's patches or frames), prefill and 4
    decode steps on the card and on the CPU, both fed the CPU's greedy
    tokens. Every step's logits within 1e-4 of the largest |logit|, the
    card's greedy token equal to the CPU's outside near-ties, every cache
    leaf within 1e-4 of its largest magnitude, ``slot_pos`` equal. An MoE
    model also runs ``moe_layer_check`` on every MoE call; where the card's
    own run flipped an expert at a near-tie (not a fault), the logit and
    cache limits are reported, not applied, and the record names the
    calls. The CPU's cache must also pass ``check_slot_pos`` (gemma2-9b's
    local ring wraps its cut window). Each model of ``LM_TRAIN_CPU_CUTS``
    then runs ``lm_train_check`` on the same weights. Returns (the prefill
    and decode records, the training records)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.layers import tree_map
    steps = 4
    cpu = torch.device("cpu")
    out, train = {}, {}
    for name, cut in LM_CPU_CUTS.items():
        start = time.perf_counter()
        cfg = lm_config(name, dict(cut, dtype="float32"))
        b, n_tok = LM_CPU_RUNS[name]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = lm.init_params(gen, cfg, device=dev)
        batch, s = lm_batch(
            cfg, b, n_tok, gen, dev,
            patches=cfg.n_frontend_tokens if cfg.frontend == "vision" else 0,
            frames=cfg.enc_frames if cfg.is_encdec else 0)
        cparams = tree_map(lambda t: t.to(cpu), params)
        cbatch = {k: v.to(cpu) for k, v in batch.items()}
        with MoeSpy(name, decode=True) as g_spy:
            g_last, g_cache = lm.prefill(params, batch, cfg, s + steps)
        with MoeSpy(name, decode=True) as c_spy:
            c_last, c_cache = lm.prefill(cparams, cbatch, cfg, s + steps)
        pairs = [(g_last.to(cpu), c_last)]
        nxt = c_last.argmax(-1)
        for i in range(steps):
            with g_spy:
                g_lg, g_cache = lm.decode_step(params, g_cache, nxt.to(dev),
                                               s + i, cfg)
            with c_spy:
                c_lg, c_cache = lm.decode_step(cparams, c_cache, nxt, s + i,
                                               cfg)
            pairs.append((g_lg.to(cpu), c_lg))
            nxt = c_lg.argmax(-1)
        moe_rows, flips = (moe_layer_check(name, cfg, g_spy.records,
                                           c_spy.records, dev)
                           if cfg.n_experts else (None, []))
        strict = not flips
        logit_err = bad = ties = 0
        for g, c in pairs:
            err = float((g - c).abs().max())
            logit_err = max(logit_err, err / float(c.abs().max()))
            check(not strict or err <= 1e-4 * float(c.abs().max()),
                  f"lm card vs cpu {name}: logits differ by {err}")
            miss = g.argmax(-1) != c.argmax(-1)
            tie = top2_gap(c) <= NEAR_TIE * float(c.abs().max())
            bad, ties = bad + int((miss & ~tie).sum()), ties + int(
                (miss & tie).sum())
        check(not strict or bad == 0,
              f"lm card vs cpu {name}: {bad} greedy tokens differ outside "
              f"near-ties")
        wrapped = check_slot_pos(c_cache, cfg, s + steps,
                                 f"lm card vs cpu {name}")
        cache_err = 0.0
        for g, c in zip(tree_leaves(g_cache), tree_leaves(c_cache)):
            g = g.to(cpu)
            if c.dtype == torch.int32:
                check(torch.equal(g, c), f"lm card vs cpu {name}: slot_pos "
                                         f"differs")
                continue
            err = float((g - c).abs().max())
            scale = max(float(c.abs().max()), 1e-30)
            cache_err = max(cache_err, err / scale)
            check(not strict or err <= 1e-4 * scale,
                  f"lm card vs cpu {name}: a cache leaf differs by {err}")
        out[name] = dict(n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers,
                         cut=cut, batch=b, prompt_len=s, decode_steps=steps,
                         max_rel_logit_err=logit_err,
                         max_rel_cache_err=cache_err, token_mismatches=bad,
                         near_ties=ties, moe_layer_check=moe_rows,
                         moe_near_tie_flips_e2e=flips,
                         limits_applied=strict, window=cfg.window,
                         ring_layers_wrapped=wrapped,
                         seconds=time.perf_counter() - start)
        del g_cache, c_cache, g_spy, c_spy
        if name in LM_TRAIN_CPU_CUTS:
            train[name] = lm_train_check(name, cfg, params, cparams, seed,
                                         dev)
        del params, cparams
        torch.cuda.empty_cache()
    return out, train

# the training check of the card against the CPU, at LM_CPU_CUTS' depths:
# the models that train in phase lm_train at full depth or with a
# recurrent, MoE, encoder or vision part; batch and sequence (llava: its
# 64 cut patches + 32 tokens)
LM_TRAIN_CPU_CUTS = {n: LM_CPU_CUTS[n] for n in (
    "mamba2-1.3b", "recurrentgemma-9b", "granite-moe-3b-a800m",
    "arctic-480b", "seamless-m4t-medium", "llava-next-34b", "granite-3-2b")}
LM_TRAIN_CPU_RUNS = {"llava-next-34b": (1, 96)}
LM_TRAIN_CPU_RUN = (2, 32)


def lm_train_check(name, cfg, params, cparams, seed, dev):
    """``launch.steps.loss_and_grads`` (``lm.loss_fn`` and its gradient,
    units rematerialised) in fp32 on the card's ``params`` and their CPU
    copy ``cparams``, on the same ``synthetic_batch`` (``HostDraws``,
    ``LM_TRAIN_CPU_RUNS``): the loss within 1e-5 relative and every
    gradient leaf within 1e-4 of its largest magnitude on the CPU."""
    import torch
    from repro_torch.core.draws import HostDraws
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_lib
    cpu = torch.device("cpu")
    start = time.perf_counter()
    b, seq = LM_TRAIN_CPU_RUNS.get(name, LM_TRAIN_CPU_RUN)
    cbatch = train_lib.synthetic_batch(HostDraws(seed), cfg, b, seq, cpu)
    gbatch = {k: v.to(dev) for k, v in cbatch.items()}
    t0 = time.perf_counter()
    g_loss, _, g_grads = steps_lib.loss_and_grads(params, gbatch, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    c_loss, _, c_grads = steps_lib.loss_and_grads(cparams, cbatch, cfg)
    t2 = time.perf_counter()
    g_loss, c_loss = float(g_loss), float(c_loss)
    check(math.isfinite(g_loss) and abs(g_loss - c_loss) <= 1e-5 * abs(
        c_loss), f"lm_train card vs cpu {name}: loss {g_loss} against "
                 f"{c_loss}")
    worst, worst_leaf = 0.0, None
    names, g_leaves = _named_leaves(g_grads)
    for leaf, g, c in zip(names, g_leaves, tree_leaves(c_grads)):
        c = c.to(dev)               # the CPU's gradient, compared on the card
        top = float(c.abs().max())
        rel = float((g - c).abs().max()) / max(top, 1e-30)
        check(rel <= 1e-4, f"lm_train card vs cpu {name}: gradient {leaf} "
                           f"off by {rel} of its max")
        if rel > worst:
            worst, worst_leaf = rel, leaf
    return dict(n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers,
                cut=LM_TRAIN_CPU_CUTS[name], batch=b, seq=seq,
                loss_card=g_loss, loss_cpu=c_loss,
                loss_rel_err=abs(g_loss - c_loss) / abs(c_loss),
                max_rel_grad_err=worst, worst_leaf=worst_leaf,
                leaves=len(names), card_s=t1 - t0, cpu_s=t2 - t1,
                check_s=time.perf_counter() - start)


# ---------------------------------------------------------------------------

SGLD_SRC = "src/repro_torch/kernels/csrc/sgld_potential.cu"
# name, source, TPU kernel replaced (its pl.pallas_call), phase-1 cases,
# field prefix in the cases, the path run whose launches count[, the
# wrapper whose launch count it is, where the name is not one]
KERNELS = [
    ("dueling_select", "src/repro_torch/kernels/csrc/dueling_select.cu",
     "src/repro/kernels/dueling_score.py:234", "select", "", "sync"),
    ("sgld_potential_fwd", SGLD_SRC, "src/repro/kernels/sgld_update.py:255",
     "sgld", "fwd_", "sync"),
    ("sgld_potential_grad", SGLD_SRC, "src/repro/kernels/sgld_update.py:272",
     "sgld", "grad_", "sync"),
    ("dueling_score", "src/repro_torch/kernels/csrc/dueling_score.cu",
     "src/repro/kernels/dueling_score.py:108", "score", "", "autopilot"),
    ("sgld_mixed_fwd", SGLD_SRC, "src/repro/kernels/sgld_update.py:255",
     "mixed", "fwd_", "mixed"),
    ("sgld_mixed_grad", SGLD_SRC, "src/repro/kernels/sgld_update.py:272",
     "mixed", "grad_", "mixed"),
    ("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:99", "attn", "", "ccft"),
    ("flash_attention_bwd",
     "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     "none: gradient of _attn_kernel (src/repro/kernels/flash_attention.py"
     ":23), which the reference takes by XLA autodiff of "
     "src/repro/models/attention.py::_attend", "attn_bwd", "", "train"),
    ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
     "src/repro/kernels/ssd_scan.py:109", "ssd", "", "mamba2-1.3b"),
    ("rglru_scan", "src/repro_torch/kernels/csrc/rglru_scan.cu",
     "src/repro/kernels/rglru_scan.py:72", "rglru", "", "recurrentgemma-9b"),
    ("flash_attention_bwd_bf16",
     "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
     "none: gradient of _attn_kernel (src/repro/kernels/flash_attention.py"
     ":23) in bf16, which the reference takes by XLA autodiff of "
     "src/repro/models/attention.py::_attend", "attn_bwd_bf16", "",
     "lm_train:granite-3-2b", "flash_attention_bwd"),
    ("rglru_scan_bwd", "src/repro_torch/kernels/csrc/rglru_scan.cu",
     "none: gradient of src/repro/models/rglru.py::linear_scan "
     "(lax.associative_scan), which the reference takes by XLA autodiff",
     "rglru_bwd", "", "lm_train:recurrentgemma-9b", "rglru_scan_bwd"),
    ("ssd_scan_bwd", "src/repro_torch/kernels/csrc/ssd_scan_bwd_sm90.cu",
     "none: gradient of _ssd_kernel (src/repro/kernels/ssd_scan.py:109), "
     "which the reference takes by XLA autodiff of "
     "src/repro/models/ssd.py::ssd_chunked", "ssd_bwd", "",
     "lm_train:mamba2-1.3b", "ssd_scan_bwd"),
]
# the rows whose kernels the LM training paths launch (the bf16 attention
# backward has its own row; the fp32 one is the encoder's)
LM_TRAIN_ROWS = ("flash_attention", "flash_attention_bwd_bf16", "rglru_scan",
                 "rglru_scan_bwd", "ssd_scan", "ssd_scan_bwd")


# the bf16 cases of flash_attention timed beside its fp32 main and bench,
# the fp32 case of ssd_scan (the SIMT kernel) beside its bf16 ones, and
# the serve case of dueling_select beside its main and bench
ATTN_BF16_TIMED = ("qwen2_bf16", "recurrentgemma_bf16", "granite_moe_bf16",
                   "arctic_bf16", "llava_bf16", "seamless_enc_bf16",
                   "seamless_self_bf16", "seamless_cross_bf16",
                   "granite_3_2b_bf16", "qwen2_7b_bf16", "gemma2_bf16",
                   "gemma2_global_bf16", "mistral_bf16")
SSD_FP32_TIMED = ("main_fp32",)
SELECT_TIMED = ("serve",)
# the timed attn_bwd cases beside main and bench
ATTN_BWD_TIMED = ("main_large", "e5b", "minilm_d24")
ATTN_BWD_BF16_TIMED = ("main_large", "recurrentgemma", "qwen2",
                       "seamless_enc", "seamless_cross")
# each family's timed case at the paper examples' shapes (the fp32 forward
# of their encoder, quickstart's act and SGLD step), under ``examples`` of
# its rows
EXAMPLES_TIMED = dict(attn="examples_d32", select="examples_quickstart",
                      sgld="examples_quickstart")
# each family's timed cases at the router dry-run's per-rank shapes, under
# ``dryrun_shapes`` of its rows
DRYRUN_TIMED = dict(select=("dryrun_16x16", "dryrun_2x16x16"),
                    sgld=("dryrun",),
                    attn=("dryrun_16x16", "dryrun_2x16x16"))


def kernels_line(cases, launches, serve_launches, lm_launches,
                 train_launches, ex_launches, shares=(), lm_shares=None):
    """``cases``: phase-1 case lists by family; ``launches``: the launch
    counts of each path run by its name. ``library_ms`` is the time of
    ``scaled_dot_product_attention`` for ``flash_attention`` (same inputs),
    its backward for ``flash_attention_bwd``, and null for the others: no
    one PyTorch call computes them. The
    ``flash_attention`` row also carries its timed bf16 cases (the Hopper
    kernel) under ``bf16``, the ``flash_attention_bwd`` row its plans, its
    device time by kernel and its other timed cases (``main_large``,
    ``e5b``, ``minilm_d24``) under ``more``, the ``ssd_scan`` row its timed
    fp32 case (the
    SIMT kernel) under ``fp32``, the ``dueling_select`` row its timed
    ``serve`` case under ``serve``. ``serve_launches`` are the launches of
    the serving runs for the kernels they launch: phase serve's main
    service and autopilot, phase stream's graph replays and its
    autopilot's (by the profiler's kernel names), and phase refresh's
    cycle (``refresh``: the fine-tuning's and the offline encode's
    attention). ``lm_launches`` are each lm model's launches per prefill
    (phase ``lm``), under ``lm_launches`` of each kernel that model's
    prefill launches; ``train_launches`` each lm_train model's launches
    per training step, under ``lm_train_launches`` of the rows in
    ``LM_TRAIN_ROWS``; ``ex_launches`` each example's launches (phase
    ``examples``), under ``examples_launches`` of the rows whose counter
    it names, and the timed case of ``EXAMPLES_TIMED`` under
    ``examples``. ``shares`` are the router dry-run's steps timed on the
    card (one rank's share), under ``mesh_dryrun`` of the row of each
    step's kernel, by mesh; the kernel's own phase-1 cases at those
    shapes (``DRYRUN_TIMED``) under ``dryrun_shapes``. ``lm_shares`` are
    phase ``lm_dryrun``'s shares by arch, under ``lm_dryrun`` of the row
    of each kernel they launch (the bf16 attention backward's row for
    ``flash_attention_bwd``): launches, device ms, bound, the plain
    version's ms, SDPA's ms. The bf16 attention backward's and the RG-LRU
    backward's ``launches`` are those of the granite-3-2b and the
    recurrentgemma-9b training runs (3 steps), and the bf16 backward row
    carries its other timed cases under ``more``. The two forward kernels
    are reached on their
    paths only through the energy trace the runs here add
    (``fgts.chain_energy`` on the slice runs,
    ``extensions.mixed_chain_energy`` on the mixed run): the policies' own
    act and update launch the gradient kernels alone."""
    rows = []
    for name, src, replaces, fam, pre, run, *counter in KERNELS:
        counter = counter[0] if counter else name
        fam_cases = cases[fam]
        m = next(r for r in fam_cases if r["case"] == "main")
        bch = next(r for r in fam_cases if r["case"] == "bench")
        rows.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[run][counter],
            max_abs_err=max(r[pre + "max_abs_err"] for r in fam_cases),
            ms=m[pre + "ms"], plain_ms=m[pre + "plain_ms"],
            bound_ms=m[pre + "bound_ms"], bound_by=m[pre + "bound_by"],
            library_ms=m.get(pre + "library_ms"),
            device_ms=m[pre + "device_ms"],
            plain_device_ms=m[pre + "plain_device_ms"],
            bench_ms=bch[pre + "ms"], bench_plain_ms=bch[pre + "plain_ms"],
            bench_device_ms=bch[pre + "device_ms"],
            bench_plain_device_ms=bch[pre + "plain_device_ms"],
            bench_bound_ms=bch[pre + "bound_ms"],
            bench_bound_by=bch[pre + "bound_by"]))
        on_serve = {run: c[name] for run, c in serve_launches.items()
                    if c.get(name)}
        if on_serve:
            rows[-1]["serve_launches"] = on_serve
        on_lm = {model: c[name] for model, c in lm_launches.items()
                 if c.get(name)}
        if on_lm:
            rows[-1]["lm_launches"] = on_lm
        on_train = {model: c[counter] for model, c in train_launches.items()
                    if c.get(counter)}
        if name in LM_TRAIN_ROWS and on_train:
            rows[-1]["lm_train_launches"] = on_train
        on_ex = {ex: c[counter] for ex, c in ex_launches.items()
                 if c.get(counter) and name != "flash_attention_bwd_bf16"}
        if on_ex:
            rows[-1]["examples_launches"] = on_ex
        ex_case = [r for r in fam_cases
                   if r["case"] == EXAMPLES_TIMED.get(fam)]
        if ex_case:
            rows[-1]["examples"] = {k: ex_case[0].get(pre + k) for k in (
                "ms", "device_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms", "plain_ms", "plain_device_ms")}
        dry = {r["case"]: {k: r.get(pre + k) for k in (
            "ms", "device_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms", "plain_ms", "plain_device_ms")}
            for r in fam_cases if r["case"] in DRYRUN_TIMED.get(fam, ())}
        if dry and name in ("dueling_select", "sgld_potential_grad",
                            "flash_attention"):
            rows[-1]["dryrun_shapes"] = dry
        on_share = {r["mesh"]: {k: r.get(k) for k in (
            "step", "rows", "kernel_launches", "kernel_device_ms",
            "bound_ms", "bound_by", "ms", "device_ms", "peak_bytes")}
            for r in shares if r["kernel"] == counter}
        if on_share:
            rows[-1]["mesh_dryrun"] = on_share
        on_lm_share = {arch: sh["kernels"][counter]
                       for arch, sh in (lm_shares or {}).items()
                       if counter in sh["kernels"]
                       and name != "flash_attention_bwd"}
        if on_lm_share:
            rows[-1]["lm_dryrun"] = on_lm_share
        if name == "flash_attention_bwd_bf16":
            rows[-1]["design_ops_ms"] = m.get("design_ops_ms")
        if name == "ssd_scan_bwd":
            rows[-1].update(device_us_by_kernel=m["device_us_by_kernel"],
                            bench_device_us_by_kernel=bch[
                                "device_us_by_kernel"])
        if name in ("flash_attention_bwd", "flash_attention_bwd_bf16"):
            rows[-1].update(plan=m["plan"], bench_plan=bch["plan"],
                            device_us_by_kernel=m["device_us_by_kernel"],
                            bench_device_us_by_kernel=bch[
                                "device_us_by_kernel"])
        extra = dict(flash_attention=("bf16", ATTN_BF16_TIMED),
                     flash_attention_bwd=("more", ATTN_BWD_TIMED),
                     flash_attention_bwd_bf16=("more", ATTN_BWD_BF16_TIMED),
                     ssd_scan=("fp32", SSD_FP32_TIMED),
                     dueling_select=("serve", SELECT_TIMED)).get(name)
        if extra:
            rows[-1][extra[0]] = {
                r["case"]: {k: r.get(k) for k in (
                    "ms", "device_ms", "bound_ms", "bound_by", "library_ms",
                    "library_device_ms", "plain_ms", "plain_device_ms",
                    "plan", "device_us_by_kernel", "design_ops_ms")}
                for r in fam_cases if r["case"] in extra[1]}
    return {"kernels": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every phase's full record here (JSON); "
                         "each phase line is appended to FILE.phases.jsonl "
                         "as it ends")
    args = ap.parse_args()
    global PHASE_LOG
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        PHASE_LOG = f"{args.out}.phases.jsonl"
        Path(PHASE_LOG).unlink(missing_ok=True)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {}

    t0 = time.perf_counter()
    _build.build_all()
    record["build"] = dict(phase="build", seconds=time.perf_counter() - t0,
                           libraries=sorted(_build.SIGNATURES))
    emit_phase(record["build"])
    record["lint"] = dict(phase="lint", **phase_lint())
    emit_phase(record["lint"])

    (sel, sg, sc, mx, at, atb, atb16, ssd, rgl, rgb, sbw,
     family_s) = phase_kernels(dev, args.seed)
    record["kernels"] = dict(phase="kernels", dueling_select=sel,
                             sgld_potential=sg, dueling_score=sc,
                             sgld_mixed=mx, flash_attention=at,
                             flash_attention_bwd=atb,
                             flash_attention_bwd_bf16=atb16, ssd_scan=ssd,
                             rglru_scan=rgl, rglru_scan_bwd=rgb,
                             ssd_scan_bwd=sbw, seconds=family_s)
    emit_phase(record["kernels"])

    runs = phase_slice(dev, args.seed)
    record["slice"] = dict(phase="slice", **runs)
    emit_phase(record["slice"])
    record["autopilot"] = dict(phase="autopilot",
                               **phase_autopilot(dev, args.seed))
    emit_phase(record["autopilot"])
    record["mixed"] = dict(phase="mixed", **phase_mixed(dev, args.seed))
    emit_phase(record["mixed"])
    train, params_ft = phase_train(dev, args.seed)
    record["train"] = dict(phase="train", **train)
    emit_phase(record["train"])
    record["ccft"] = dict(phase="ccft", **phase_ccft(dev, args.seed,
                                                     params_ft))
    emit_phase(record["ccft"])
    record["serve"] = dict(phase="serve", **phase_serve(dev, args.seed,
                                                        params_ft))
    emit_phase(record["serve"])
    record["stream"] = dict(phase="stream", **phase_stream(dev, args.seed,
                                                          params_ft))
    emit_phase(record["stream"])
    record["refresh"] = dict(phase="refresh",
                             **phase_refresh(dev, args.seed, params_ft))
    emit_phase(record["refresh"])
    record["mesh"] = dict(phase="mesh", **phase_mesh(dev, args.seed,
                                                     params_ft))
    emit_phase(record["mesh"])
    record["examples"] = dict(phase="examples",
                              **phase_examples(dev, args.seed))
    emit_phase(record["examples"])
    record["lm"] = dict(phase="lm", **phase_lm(dev, args.seed))
    emit_phase(record["lm"])
    record["lm_train"] = dict(phase="lm_train",
                              **phase_lm_train(dev, args.seed))
    emit_phase(record["lm_train"])
    record["lm_dryrun"] = dict(phase="lm_dryrun",
                               **phase_lm_dryrun(dev, args.seed))
    emit_phase(record["lm_dryrun"])

    part_s = {}

    def part(key, fn, *fn_args):
        t0 = time.perf_counter()
        got = fn(dev, args.seed, *fn_args)
        part_s[key] = time.perf_counter() - t0
        return got
    cvc = dict(phase="card_vs_cpu", **part("slice", phase_card_vs_cpu))
    cvc["autopilot"] = part("autopilot", phase_autopilot_card_vs_cpu)
    cvc["train"] = part("train", phase_train_card_vs_cpu, params_ft)
    cvc["ccft"] = part("ccft", phase_ccft_card_vs_cpu, params_ft)
    cvc["serve"] = part("serve", phase_serve_card_vs_cpu, params_ft)
    cvc["examples"] = part("examples", phase_examples_card_vs_cpu)
    # lm_train's share of "lm" is the sum of its records' check_s
    cvc["lm"], cvc["lm_train"] = part("lm", phase_lm_card_vs_cpu)
    record["card_vs_cpu"] = dict(cvc, seconds=part_s)
    emit_phase(record["card_vs_cpu"])

    trained = {n: r for n, r in record["lm_train"].items()
               if isinstance(r, dict) and "launches" in r}
    line = kernels_line(
        dict(select=sel, sgld=sg, score=sc, mixed=mx, attn=at,
             attn_bwd=atb, attn_bwd_bf16=atb16, ssd=ssd, rglru=rgl,
             rglru_bwd=rgb, ssd_bwd=sbw),
        dict(sync=runs["sync"]["launches"],
             train=record["train"]["launches"],
             autopilot=record["autopilot"]["launches"],
             mixed=record["mixed"]["launches"],
             ccft=record["ccft"]["routerbench"]["launches"],
             **{n: r["launches"] for n, r in record["lm"].items()
                if isinstance(r, dict)},
             **{f"lm_train:{n}": r["launches"] for n, r in trained.items()}),
        dict(serve=record["serve"]["launches"],
             serve_autopilot=record["serve"]["autopilot"]["launches"],
             stream=record["stream"]["launches"],
             stream_autopilot=record["stream"]["autopilot"]["launches"],
             refresh=record["refresh"]["cycles"][0]["launches"],
             mesh=record["mesh"]["tick"]["launches"]),
        {n: r["launches_per_prefill"] for n, r in record["lm"].items()
         if isinstance(r, dict)},
        {n: r["launches_per_step"] for n, r in trained.items()},
        {n: r["launches"] for n, r in record["examples"].items()
         if isinstance(r, dict)},
        record["mesh"]["dryrun"]["card"], record["lm_dryrun"]["shares"])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    record["card"] = smi
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(record, kernels_line=line["kernels"]), indent=1))
    emit(line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
