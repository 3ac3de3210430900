// RG-LRU linear recurrence for sm_90a: h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 0)) x_t,
// a_t = exp(log_a_t), per channel over (B,S,D) float32.
//
// Replaces the TPU kernel at src/repro/kernels/rglru_scan.py:72 (_rglru_kernel), whose
// sequential grid axis over sequence blocks carries the state in VMEM scratch. Here the
// state never leaves a register: one thread per (batch, channel) walks S in order, and
// neighbouring threads hold neighbouring channels, so each step's loads and store are
// coalesced rows of D floats.
//
// Bound: bytes (12 per element: log_a and x read, h written; a few operations each).
// With B*D threads in flight (8192 at B 2, D 4096) a loop that loads and then waits would
// leave the memory system idle, so each thread keeps the next PF steps' loads in flight
// while it computes the current PF steps: the loads never depend on h. A segmented
// two-pass scan over S would put more threads in flight (later work).
#include <cuda_runtime.h>

namespace {

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
        const float a = expf(la_cur[u]);
        const float bx = sqrtf(fmaxf(1.f - expf(2.f * la_cur[u]), 0.f)) * x_cur[u];
        // rounded after the product and after the sum, as the reference's a*h + b is
        state = __fadd_rn(__fmul_rn(a, state), bx);
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

}  // namespace

extern "C" int rglru_scan_launch(const void* log_a, const void* x, const void* h0, void* h,
                                 void* h_last, int B, int S, int D, void* stream) {
  dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)log_a, (const float*)x, (const float*)h0, (float*)h, (float*)h_last, S,
      D);
  return (int)cudaGetLastError();
}
