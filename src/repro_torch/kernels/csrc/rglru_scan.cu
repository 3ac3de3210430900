// RG-LRU linear recurrence for sm_90a: h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 0)) x_t,
// a_t = exp(log_a_t), per channel over (B,S,D) float32.
//
// Replaces the TPU kernel at src/repro/kernels/rglru_scan.py:72 (_rglru_kernel), whose
// sequential grid axis over sequence blocks carries the state in VMEM scratch. Here the
// state never leaves a register: one thread per (batch, channel) walks S in order, and
// neighbouring threads hold neighbouring channels.
//
// Bound: bytes (12 per element: log_a and x read, h written; a few operations each). The
// recurrence leaves only B*D threads (8192 at recurrentgemma-9b's B 2, D 4096), and a
// thread that loads for itself keeps too few bytes in flight to cover the memory's
// latency (Little's law wants ~25 KB in flight per SM at 3.35 TB/s). So the bytes arrive
// another way:
//
// rglru_kernel_sm90 (D a multiple of 4, 16-byte aligned bases; the wrapper's rule): a
// block owns 32 channels of one batch row. A producer warp streams (32 steps x 32
// channels) tiles of log_a and x through TMA into a ring of 4 stages in shared memory, so
// up to 32 KB per block are in flight whatever the thread count; B 2 x D 4096 gives 256
// blocks, about 2 per SM. Four gate warps turn each stage into a_t and
// sqrt(1 - a_t^2) x_t in place: those need two exponentials and a square root per
// element but never the state, so they leave the recurrence's path. The consumer warp
// then does only the dependent multiply-add per step, reading one conflict-free row of 32
// floats of each from shared memory, and stores h as coalesced 128-byte rows. Barriers
// per stage: full (TMA bytes landed), ready (the gate warps are done), empty (the
// consumer is done). TMA zero-fills steps past S and channels past D: there a = 1 and the
// added term is 0, so the state passes through unchanged.
//
// rglru_kernel (any D and alignment): the first design, kept for the shapes TMA cannot
// load. Each thread keeps the next PF steps' loads in flight while it computes the
// current PF steps: the loads never depend on h.
//
// Both compute each step with the same gates() and advance(), so they agree bitwise.
//
// The gradient (no TPU kernel: the reference differentiates its scan by XLA's autodiff)
// is a reverse linear scan with the same two routes by the same rule: rglru_bwd_kernel_sm90
// (the ring read in reverse) and rglru_bwd_kernel (a thread per channel), described below.
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

// a_t and sqrt(max(1 - a_t^2, 0)) x_t of one element
__device__ __forceinline__ void gates(float la, float xv, float& a, float& bx) {
  a = expf(la);
  bx = sqrtf(fmaxf(1.f - expf(2.f * la), 0.f)) * xv;
}

// rounded after the product and after the sum, as the reference's a*h + b is
__device__ __forceinline__ float advance(float state, float a, float bx) {
  return __fadd_rn(__fmul_rn(a, state), bx);
}

__device__ __forceinline__ float step(float state, float la, float xv) {
  float a, bx;
  gates(la, xv, a, bx);
  return advance(state, a, bx);
}

constexpr int PF = 16;       // steps loaded ahead
constexpr int THREADS = 64;  // channels per block: B*D/64 blocks spread over the SMs

__global__ void rglru_kernel(const float* __restrict__ log_a, const float* __restrict__ x,
                             const float* __restrict__ h0, float* __restrict__ h,
                             float* __restrict__ h_last, int S, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)b * S * D + d;
  float state = h0 ? h0[(size_t)b * D + d] : 0.f;

  float la_cur[PF], x_cur[PF], la_nxt[PF], x_nxt[PF];
#pragma unroll
  for (int u = 0; u < PF; ++u) {
    const bool ok = u < S;
    la_cur[u] = ok ? log_a[base + (size_t)u * D] : 0.f;
    x_cur[u] = ok ? x[base + (size_t)u * D] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += PF) {
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int t = t0 + PF + u;
      const bool ok = t < S;
      la_nxt[u] = ok ? log_a[base + (size_t)t * D] : 0.f;
      x_nxt[u] = ok ? x[base + (size_t)t * D] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int t = t0 + u;
      if (t < S) {
        state = step(state, la_cur[u], x_cur[u]);
        h[base + (size_t)t * D] = state;
      }
    }
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      la_cur[u] = la_nxt[u];
      x_cur[u] = x_nxt[u];
    }
  }
  h_last[(size_t)b * D + d] = state;
}

constexpr int kCh = 32;                           // channels per block
constexpr int kSteps = 32;                        // steps per ring stage
constexpr int kStages = 4;
constexpr int kGateWarps = 4;
constexpr int kThreads = 32 * (2 + kGateWarps);   // consumer, gates, producer
constexpr int kTile = kSteps * kCh;               // floats of one operand in a stage
constexpr int kStageBytes = 2 * kTile * 4;        // log_a and x
constexpr int kSmem = kStages * kStageBytes;      // 32 KB

// grid (ceil(D / 32), B), 192 threads: warp 0 consumes, warps 1-4 compute the gates,
// lane 0 of warp 5 produces
__global__ void __launch_bounds__(kThreads) rglru_kernel_sm90(
    const __grid_constant__ CUtensorMap tla, const __grid_constant__ CUtensorMap tx,
    const float* __restrict__ h0, float* __restrict__ h, float* __restrict__ h_last, int S,
    int D) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kStages], ready[kStages], empty[kStages];
  const int d0 = blockIdx.x * kCh, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (S + kSteps - 1) / kSteps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&ready[s], kGateWarps);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 1 + kGateWarps) {
    if (lane == 0) {
      sm90::tma_prefetch(&tla);
      sm90::tma_prefetch(&tx);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        sm90::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[st], kStageBytes);
        float* dst = ring + st * 2 * kTile;
        sm90::tma_load_4d(dst, &tla, &full[st], d0, it * kSteps, b, 0);
        sm90::tma_load_4d(dst + kTile, &tx, &full[st], d0, it * kSteps, b, 0);
      }
    }
    return;
  }

  if (warp > 0) {
    // gates: log_a -> a and x -> sqrt(max(1 - a^2, 0)) x, in place
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      sm90::mbar_wait(&full[st], (it / kStages) & 1);
      float* la = ring + st * 2 * kTile;
      float* xs = la + kTile;
#pragma unroll
      for (int e = (warp - 1) * 32 + lane; e < kTile; e += 32 * kGateWarps) {
        float a, bx;
        gates(la[e], xs[e], a, bx);
        la[e] = a;
        xs[e] = bx;
      }
      sm90::fence_proxy_async();  // before the next TMA write to this stage
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&ready[st]);
    }
    return;
  }

  const int d = d0 + lane;
  const bool live = d < D;
  const size_t base = (size_t)b * S * D + d;
  float state = (h0 != nullptr && live) ? h0[(size_t)b * D + d] : 0.f;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    sm90::mbar_wait(&ready[st], (it / kStages) & 1);
    const float* as = ring + st * 2 * kTile;
    const float* bs = as + kTile;
    const int t0 = it * kSteps;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      state = advance(state, as[u * kCh + lane], bs[u * kCh + lane]);
      if (live && t0 + u < S) h[base + (size_t)(t0 + u) * D] = state;
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);  // the whole warp has read this stage
  }
  if (live) h_last[(size_t)b * D + d] = state;
}

// ---------------------------------------------------------------------------
// rglru_bwd_kernel: the gradient of the recurrence (no TPU kernel: the
// reference differentiates lax.associative_scan by XLA's autodiff,
// src/repro/models/rglru.py::linear_scan). With g_t the gradient that
// reaches h_t, g_t = dh_t + a_{t+1} g_{t+1} (plus dh_last at t = S - 1):
//   dx_t     = g_t sqrt(max(1 - e_t, 0)),                e_t = exp(2 log_a_t)
//   dlog_a_t = g_t (a_t h_{t-1} - e_t x_t / sqrt(max(1 - e_t, 0)))
//   dh0      = a_0 g_0
// with h_{-1} = h0 (or 0). Where 1 - e_t is 0 (log_a_t = 0: the clamp) the
// reference's gradient through sqrt at 0 is +-inf (NaN where g_t x_t = 0),
// and so is this one. A reverse linear scan: one thread per (batch,
// channel) walks S backwards with the carried a_{t+1} g_{t+1} in a
// register, the next kBwdPF steps' loads (log_a, x, h_{t-1}, dh) in flight
// while it computes the current ones, as rglru_kernel does forwards. Bound:
// bytes (24 per element: four reads, two writes). The first design, kept for
// the shapes TMA cannot load (D % 4 != 0, misaligned inputs), as
// rglru_kernel is: rglru_bwd_kernel_sm90 below takes the rest. 32 threads a
// block, so B * D / 32 blocks spread over the SMs.
// ---------------------------------------------------------------------------

constexpr int kBwdPF = 16;
constexpr int kBwdThreads = 32;

__global__ void __launch_bounds__(kBwdThreads) rglru_bwd_kernel(
    const float* __restrict__ log_a, const float* __restrict__ x,
    const float* __restrict__ h0, const float* __restrict__ h,
    const float* __restrict__ dh, const float* __restrict__ dh_last,
    float* __restrict__ dlog_a, float* __restrict__ dx,
    float* __restrict__ dh0, int S, int D) {
  const int d = blockIdx.x * kBwdThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)b * S * D + d;
  const float h_init = h0 ? h0[(size_t)b * D + d] : 0.f;
  float carry = dh_last[(size_t)b * D + d];  // a_{t+1} g_{t+1}, dh_last at S-1

  float la_c[kBwdPF], x_c[kBwdPF], g_c[kBwdPF], hp_c[kBwdPF];
  float la_n[kBwdPF], x_n[kBwdPF], g_n[kBwdPF], hp_n[kBwdPF];
  // step t's log_a, x, dh and h_{t-1}; nothing for t < 0
  auto load = [&](int t, float& la, float& xv, float& gv, float& hp) {
    const bool ok = t >= 0;
    const size_t at = base + (size_t)(ok ? t : 0) * D;
    la = ok ? log_a[at] : 0.f;
    xv = ok ? x[at] : 0.f;
    gv = ok ? dh[at] : 0.f;
    hp = t > 0 ? h[at - D] : h_init;
  };
#pragma unroll
  for (int u = 0; u < kBwdPF; ++u)
    load(S - 1 - u, la_c[u], x_c[u], g_c[u], hp_c[u]);
  for (int t0 = S - 1; t0 >= 0; t0 -= kBwdPF) {
#pragma unroll
    for (int u = 0; u < kBwdPF; ++u)
      load(t0 - kBwdPF - u, la_n[u], x_n[u], g_n[u], hp_n[u]);
#pragma unroll
    for (int u = 0; u < kBwdPF; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const float a = expf(la_c[u]);
        const float e = expf(2.f * la_c[u]);
        const float sq = sqrtf(fmaxf(1.f - e, 0.f));
        const float g = g_c[u] + carry;
        const size_t at = base + (size_t)t * D;
        dx[at] = g * sq;
        dlog_a[at] = g * (a * hp_c[u] - e * x_c[u] / sq);
        carry = a * g;
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdPF; ++u) {
      la_c[u] = la_n[u];
      x_c[u] = x_n[u];
      g_c[u] = g_n[u];
      hp_c[u] = hp_n[u];
    }
  }
  if (dh0 != nullptr) dh0[(size_t)b * D + d] = carry;
}

// ---------------------------------------------------------------------------
// rglru_bwd_kernel_sm90: the same gradient, with the forward's TMA ring read in
// reverse (D a multiple of 4, 16-byte aligned log_a, x, h, dh: the wrapper's rule;
// rglru_bwd_kernel above keeps the rest). The first design put a thread on each (batch,
// channel) in blocks of 32: at B 1, D 4096 that is 128 one-warp blocks, about one warp
// an SM with 16 steps of loads in flight, so it waited on memory's latency (0.63 ms
// against a 0.12 ms bound at recurrentgemma-9b's B 1, S 4096, D 4096, NVIDIA H100 80GB
// HBM3 at 700 W; B 2 took as long). Here a block owns 32 channels of one batch row and
// the tiles (32 steps x 32 channels) arrive from the last backwards: a producer warp
// streams log_a, x, h and dh through TMA into a ring of 4 stages (64 KB in flight a
// block, whatever the thread count). Eight gate warps turn each stage's elements into
// a_t, sqrt(max(1 - e_t, 0)) and the factor of dlog_a, a_t h_{t-1} - e_t x_t /
// sqrt(max(1 - e_t, 0)) (h_{t-1}: the row above in the stage; for a tile's first step
// one row of h read a tile ahead, or h0), written beside the TMA'd tiles: those need two
// exponentials, a square root and a division per element but never the carry. The
// consumer warp reads a tile's dh_t and a_t into registers, walks only the reverse
// chain, g_t = dh_t + carry, carry = a_t g_t, writes dx_t = g_t sqrt(..) and dlog_a_t =
// g_t (factor) over the stage's slots and hands the two tiles to TMA stores: the
// consumer's shared-memory reads inside the walk, or its stores, paced the block, and
// with those gone four gate warps did (tools/scan_bwd_variants.py). Bound: bytes, 24 per element and one row of h per tile
// (1/32 of h's bytes) beyond it. Barriers per stage as the forward's: full (TMA bytes
// landed), ready (the gate warps are done), empty (the tile's stores have read the
// stage). The arithmetic is rglru_bwd_kernel's, term for term, and each output is
// written by one thread in a fixed order.
// ---------------------------------------------------------------------------

constexpr int kBwdIn = 4;                                   // log_a, x, h, dh
constexpr int kBwdSlots = kBwdIn + 1;                       // + the factor of dlog_a
constexpr int kBwdStages = 4;
constexpr int kBwdGateWarps = 8;
constexpr int kBwdThreadsTma = 32 * (2 + kBwdGateWarps);    // consumer, gates, producer
constexpr int kBwdStageBytes = kBwdIn * kTile * 4;          // TMA'd: 16 KB
constexpr int kBwdSmem = kBwdStages * kBwdSlots * kTile * 4;   // 80 KB

// grid (ceil(D / 32), B), kBwdThreadsTma threads: warp 0 consumes, warps 1 ..
// kBwdGateWarps compute the gates, lane 0 of the last warp produces
__global__ void __launch_bounds__(kBwdThreadsTma) rglru_bwd_kernel_sm90(
    const __grid_constant__ CUtensorMap tla, const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tdh,
    const __grid_constant__ CUtensorMap tdla, const __grid_constant__ CUtensorMap tdx,
    const float* __restrict__ h0, const float* __restrict__ h,
    const float* __restrict__ dh_last, float* __restrict__ dh0, int S, int D) {
  extern __shared__ __align__(128) float ring[];
  __shared__ __align__(8) uint64_t full[kBwdStages], ready[kBwdStages], empty[kBwdStages];
  const int d0 = blockIdx.x * kCh, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (S + kSteps - 1) / kSteps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&ready[s], kBwdGateWarps);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // the k-th tile walked is tile n_tiles - 1 - k, in stage k % kBwdStages:
  // [log_a | x | h | dh | factor], kTile floats each
  if (warp == 1 + kBwdGateWarps) {
    if (lane == 0) {
      sm90::tma_prefetch(&tla);
      sm90::tma_prefetch(&tx);
      sm90::tma_prefetch(&th);
      sm90::tma_prefetch(&tdh);
      for (int k = 0; k < n_tiles; ++k) {
        const int st = k % kBwdStages, t0 = (n_tiles - 1 - k) * kSteps;
        sm90::mbar_wait(&empty[st], ((k / kBwdStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[st], kBwdStageBytes);
        float* dst = ring + st * kBwdSlots * kTile;
        sm90::tma_load_4d(dst, &tla, &full[st], d0, t0, b, 0);
        sm90::tma_load_4d(dst + kTile, &tx, &full[st], d0, t0, b, 0);
        sm90::tma_load_4d(dst + 2 * kTile, &th, &full[st], d0, t0, b, 0);
        sm90::tma_load_4d(dst + 3 * kTile, &tdh, &full[st], d0, t0, b, 0);
      }
    }
    return;
  }

  if (warp > 0) {
    // gates: log_a -> a, x -> sqrt(max(1 - e, 0)), and the factor of dlog_a. Row 0 of a
    // tile needs h_{t0-1}, the last row of the tile walked next: warp 1 (whose lane l
    // owns element l, row 0) reads it from h one tile ahead, so the read's latency
    // overlaps a tile's work.
    const int dl = d0 + lane;
    auto h_before = [&](int t0) {          // h_{t0-1} of channel dl, h0 (or 0) at t0 = 0
      if (dl >= D) return 0.f;
      if (t0 > 0) return h[((size_t)b * S + t0 - 1) * D + dl];
      return h0 != nullptr ? h0[(size_t)b * D + dl] : 0.f;
    };
    float h_next = warp == 1 ? h_before((n_tiles - 1) * kSteps) : 0.f;
    for (int k = 0; k < n_tiles; ++k) {
      const int st = k % kBwdStages, t0 = (n_tiles - 1 - k) * kSteps;
      const float h_row0 = h_next;
      if (warp == 1 && t0 > 0) h_next = h_before(t0 - kSteps);
      sm90::mbar_wait(&full[st], (k / kBwdStages) & 1);
      float* la = ring + st * kBwdSlots * kTile;
      float* xs = la + kTile;
      const float* hs = la + 2 * kTile;
      float* fs = la + 4 * kTile;
#pragma unroll
      for (int e = (warp - 1) * 32 + lane; e < kTile; e += 32 * kBwdGateWarps) {
        const float hp = e < kCh ? h_row0 : hs[e - kCh];   // h_{t-1}
        const float l = la[e], xv = xs[e];
        const float a = expf(l);
        const float ee = expf(2.f * l);
        const float sq = sqrtf(fmaxf(1.f - ee, 0.f));
        fs[e] = a * hp - ee * xv / sq;
        la[e] = a;
        xs[e] = sq;
      }
      sm90::fence_proxy_async();  // before the next TMA write to this stage
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&ready[st]);
    }
    return;
  }

  // the consumer: a tile's dh and a into registers first, so the walk is the chain of
  // an add and a multiply a step and no shared-memory read waits inside it; then dx
  // and dlog_a written over sqrt(..) and the factor in the stage, and stored by TMA
  // (rows past S and channels past D are not written); a stage goes back to the
  // producer once the next tile's stores are issued and its own have been read
  const int d = d0 + lane;
  const bool live = d < D;
  float carry = live ? dh_last[(size_t)b * D + d] : 0.f;  // a_{t+1} g_{t+1}
  for (int k = 0; k < n_tiles; ++k) {
    const int st = k % kBwdStages, t0 = (n_tiles - 1 - k) * kSteps;
    const int n_live = min(kSteps, S - t0);                 // steps past S: none
    sm90::mbar_wait(&ready[st], (k / kBwdStages) & 1);
    float* as = ring + st * kBwdSlots * kTile;
    float* sqs = as + kTile;
    const float* dhs = as + 3 * kTile;
    float* fs = as + 4 * kTile;
    float gv[kSteps], av[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      gv[u] = dhs[u * kCh + lane];
      av[u] = as[u * kCh + lane];
    }
#pragma unroll
    for (int u = kSteps - 1; u >= 0; --u) {
      if (u < n_live) {
        gv[u] += carry;           // g_t = dh_t + a_{t+1} g_{t+1}
        carry = av[u] * gv[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int e = u * kCh + lane;
      sqs[e] = gv[u] * sqs[e];    // dx_t
      fs[e] = gv[u] * fs[e];      // dlog_a_t
    }
    sm90::fence_proxy_async();   // the writes, before TMA reads them
    __syncwarp();
    if (lane == 0) {
      sm90::tma_store_4d(&tdx, sqs, d0, t0, b, 0);
      sm90::tma_store_4d(&tdla, fs, d0, t0, b, 0);
      sm90::bulk_commit();
      sm90::bulk_wait_read<1>();  // the previous tile's stores have read its stage
      if (k > 0) sm90::mbar_arrive(&empty[(k - 1) % kBwdStages]);
    }
  }
  if (lane == 0) sm90::bulk_wait<0>();  // every store done before the block exits
  if (dh0 != nullptr && live) dh0[(size_t)b * D + d] = carry;
}

}  // namespace

extern "C" int rglru_scan_launch(const void* log_a, const void* x, const void* h0, void* h,
                                 void* h_last, int B, int S, int D, void* stream) {
  dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)log_a, (const float*)x, (const float*)h0, (float*)h, (float*)h_last, S,
      D);
  return (int)cudaGetLastError();
}

// D % 4 == 0 and log_a, x 16-byte aligned (contiguous (B,S,D))
extern "C" int rglru_scan_sm90_launch(const void* log_a, const void* x, const void* h0,
                                      void* h, void* h_last, int B, int S, int D,
                                      void* stream) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B, 1};
  const cuuint64_t row = (cuuint64_t)D * 4;
  const cuuint64_t strides[3] = {row, row * S, row * S * B};
  CUtensorMap tla, tx;
  cudaError_t err = sm90::encode_f32_4d(&tla, log_a, dims, strides, kCh, kSteps);
  if (err == cudaSuccess) err = sm90::encode_f32_4d(&tx, x, dims, strides, kCh, kSteps);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((D + kCh - 1) / kCh, B);
  rglru_kernel_sm90<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      tla, tx, (const float*)h0, (float*)h, (float*)h_last, S, D);
  return (int)cudaGetLastError();
}

// the backward: contiguous (B,S,D) log_a, x, h (the forward's output) and
// dh, dh_last (B,D); h0 and dh0 (B,D) or both NULL; writes dlog_a and dx
extern "C" int rglru_scan_bwd_launch(const void* log_a, const void* x, const void* h0,
                                     const void* h, const void* dh, const void* dh_last,
                                     void* dlog_a, void* dx, void* dh0, int B, int S,
                                     int D, void* stream) {
  dim3 grid((D + kBwdThreads - 1) / kBwdThreads, B);
  rglru_bwd_kernel<<<grid, kBwdThreads, 0, (cudaStream_t)stream>>>(
      (const float*)log_a, (const float*)x, (const float*)h0, (const float*)h,
      (const float*)dh, (const float*)dh_last, (float*)dlog_a, (float*)dx, (float*)dh0, S,
      D);
  return (int)cudaGetLastError();
}

// the backward on the TMA ring: D % 4 == 0 and log_a, x, h, dh, dlog_a, dx 16-byte
// aligned (contiguous (B,S,D)); the same arguments as rglru_scan_bwd_launch
extern "C" int rglru_scan_bwd_sm90_launch(const void* log_a, const void* x, const void* h0,
                                          const void* h, const void* dh,
                                          const void* dh_last, void* dlog_a, void* dx,
                                          void* dh0, int B, int S, int D, void* stream) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)B, 1};
  const cuuint64_t row = (cuuint64_t)D * 4;
  const cuuint64_t strides[3] = {row, row * S, row * S * B};
  CUtensorMap tla, tx, th, tdh, tdla, tdx;
  cudaError_t err = sm90::encode_f32_4d(&tla, log_a, dims, strides, kCh, kSteps);
  if (err == cudaSuccess) err = sm90::encode_f32_4d(&tx, x, dims, strides, kCh, kSteps);
  if (err == cudaSuccess) err = sm90::encode_f32_4d(&th, h, dims, strides, kCh, kSteps);
  if (err == cudaSuccess) err = sm90::encode_f32_4d(&tdh, dh, dims, strides, kCh, kSteps);
  if (err == cudaSuccess)
    err = sm90::encode_f32_4d(&tdla, dlog_a, dims, strides, kCh, kSteps);
  if (err == cudaSuccess) err = sm90::encode_f32_4d(&tdx, dx, dims, strides, kCh, kSteps);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rglru_bwd_kernel_sm90,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((D + kCh - 1) / kCh, B);
  rglru_bwd_kernel_sm90<<<grid, kBwdThreadsTma, kBwdSmem, (cudaStream_t)stream>>>(
      tla, tx, th, tdh, tdla, tdx, (const float*)h0, (const float*)h,
      (const float*)dh_last, (float*)dh0, S, D);
  return (int)cudaGetLastError();
}
