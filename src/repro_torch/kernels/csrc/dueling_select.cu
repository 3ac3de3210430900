// dueling_select: score every arm under both posterior samples and reduce
// each query row to its routed pair (a1, a2).
//
// Replaces the Pallas kernel _select_kernel of
// src/repro/kernels/dueling_score.py (dueling_select, pallas_call at :234).
//
// Per query row b and arm k (the Hadamard identity of the Pallas kernel):
//   s_j[k] = ((x*theta_j) . a_k) / sqrt(max((x*x) . (a_k*a_k), 1e-24))
//            - tilt[b,k]             (-inf where the arm is inactive)
//   a1 = argmax s_1;  a2 = argmax s_2 (without a1 when distinct),
//   and (a1, a1) when every candidate of a2 is -inf.
//
// What bounds it on the card: the B*K*d multiply-adds of the three dot
// products (num_1, num_2, den) -- arithmetic, not bytes: A (K,d) is read
// once per row but stays in L2, and the output is two ints per row.
//
// Why this first design is simple: one warp owns one query row and walks
// the arms in increasing index, so a running argmax with strict '>' gives
// jnp.argmax's first-index tie rule and index 0 for an all -inf row, and K
// has no ceiling. The lanes split d; each dot product is reduced by an xor
// butterfly, so every lane holds the same sum (fixed order, no atomics).
// fp32 FMAs on the CUDA cores only: no TF32, which would flip near-tied
// argmaxes. Tensor cores (wgmma) and more rows per warp come later.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // query rows per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void dueling_select_kernel(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ thetas, const float* __restrict__ tilt,
    const uint8_t* __restrict__ mask, int32_t* __restrict__ a1_out,
    int32_t* __restrict__ a2_out, int B, int K, int d, int tilt_stride,
    int mask_stride, int distinct) {
  extern __shared__ float smem[];
  float* th = smem;                            // (2, d)
  float* xs = smem + 2 * d;                    // (kWarps, d)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < 2 * d; i += blockDim.x) th[i] = thetas[i];
  const int b = blockIdx.x * kWarps + warp;
  float* xr = xs + warp * d;
  if (b < B)
    for (int i = lane; i < d; i += 32) xr[i] = x[(int64_t)b * d + i];
  __syncthreads();
  if (b >= B) return;

  const float* trow = tilt ? tilt + (int64_t)b * tilt_stride : nullptr;
  const uint8_t* mrow = mask ? mask + (int64_t)b * mask_stride : nullptr;
  const float NEG = -CUDART_INF_F;
  float v1 = NEG;  int i1 = 0;                 // running argmax of s_1
  float u1 = NEG;  int j1 = 0;                 // running top-2 of s_2
  float u2 = NEG;  int j2 = 0;
  for (int k = 0; k < K; ++k) {
    const float* ak = a + (int64_t)k * d;
    float n1 = 0.f, n2 = 0.f, dd = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float xv = xr[i], av = ak[i];
      n1 = fmaf(xv * th[i], av, n1);
      n2 = fmaf(xv * th[d + i], av, n2);
      dd = fmaf(xv * xv, av * av, dd);
    }
    n1 = warp_sum(n1);
    n2 = warp_sum(n2);
    dd = warp_sum(dd);
    const bool live = mrow == nullptr || mrow[k] != 0;
    if (!live) continue;                       // -inf never beats the start
    const float den = sqrtf(fmaxf(dd, 1e-24f));
    const float t = trow ? trow[k] : 0.f;
    const float s1 = n1 / den - t, s2 = n2 / den - t;
    if (s1 > v1) { v1 = s1; i1 = k; }
    if (s2 > u1) { u2 = u1; j2 = j1; u1 = s2; j1 = k; }
    else if (s2 > u2) { u2 = s2; j2 = k; }
  }
  if (lane != 0) return;
  // a2's candidate: the best of s_2, or the runner-up when distinct takes
  // a1 away; a candidate at -inf means no arm is left -> (a1, a1)
  float c = u1;  int ci = j1;
  if (distinct && j1 == i1 && u1 != NEG) { c = u2; ci = j2; }
  a1_out[b] = i1;
  a2_out[b] = (c == NEG) ? i1 : ci;
}

}  // namespace

extern "C" int dueling_select_launch(
    const void* x, const void* a, const void* thetas, const void* tilt,
    const void* mask, void* a1, void* a2, int B, int K, int d,
    int tilt_stride, int mask_stride, int distinct, void* stream) {
  const size_t smem = sizeof(float) * (size_t)(2 + kWarps) * d;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(dueling_select_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const int blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 0)
    dueling_select_kernel<<<blocks, 32 * kWarps, smem,
                            (cudaStream_t)stream>>>(
        (const float*)x, (const float*)a, (const float*)thetas,
        (const float*)tilt, (const uint8_t*)mask, (int32_t*)a1,
        (int32_t*)a2, B, K, d, tilt_stride, mask_stride, distinct);
  return (int)cudaGetLastError();
}
