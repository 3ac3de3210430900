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
