// dueling_score: the full score tensor of J posterior samples over a batch
// of queries and the arm table.
//
// Replaces the Pallas kernel _dueling_kernel of
// src/repro/kernels/dueling_score.py (dueling_score, pallas_call at :108;
// posterior_scores at :123 drives it with an all-ones query).
//
//   s_j[b,k] = ((x_b*theta_j) . a_k) / sqrt(max((x_b*x_b) . (a_k*a_k), 1e-24))
//
// What bounds it on the card: at the autopilot's shapes (one all-ones
// query, J = 16 chains, K = 16, d = 768) the ~0.1 MB it reads, so the
// launch itself; at B = 4096, K = 1024, J = 2 the (J+1)*2*B*K*d fp32
// operations of J numerators and one denominator.
//
// Why this first design is simple: a plain shared-memory tiled product,
// no wgmma or TMA. A block owns a 64 x 64 tile of (b, k) and JB = 2
// samples (grid z walks the samples in pairs, so J is a runtime size). It
// stages 16-wide slices of d: x*theta_j and x*x of its rows, formed as the
// slice is loaded, and a and a*a of its arms. Each thread holds a 4 x 4
// register block of outputs with one denominator and JB numerator
// accumulators. Every output element is accumulated by one thread over d
// in increasing order with fmaf, wherever it sits in the tile, and every
// sample pair recomputes the denominator in that same order, so duplicated
// arms give bitwise equal columns (win_matrix scores them as exact ties).
// fp32 on the CUDA cores, no TF32: win_matrix compares scores with strict
// '>' and '=='.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;            // rows (b) and arms (k) of a block tile
constexpr int kSlice = 16;           // d per stage
constexpr int kSide = 16;            // threads per tile side (16 x 16)
constexpr int kReg = kTile / kSide;  // outputs per thread per side
constexpr int kJ = 2;                // samples per block
constexpr int kPad = kTile + 1;      // row stride in shared memory

__global__ void __launch_bounds__(kSide * kSide) dueling_score_kernel(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ thetas, float* __restrict__ out, int B, int K,
    int d, int J) {
  __shared__ float xt[kJ][kSlice][kPad];  // x * theta_j, [d][row]
  __shared__ float xx[kSlice][kPad];      // x * x
  __shared__ float as[kSlice][kPad];      // a, [d][arm]
  __shared__ float aa[kSlice][kPad];      // a * a
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int k0 = blockIdx.x * kTile, b0 = blockIdx.y * kTile;
  const int j0 = blockIdx.z * kJ;

  float num[kJ][kReg][kReg], den[kReg][kReg];
#pragma unroll
  for (int i = 0; i < kReg; ++i)
#pragma unroll
    for (int n = 0; n < kReg; ++n) {
      den[i][n] = 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) num[j][i][n] = 0.f;
    }

  for (int d0 = 0; d0 < d; d0 += kSlice) {
    for (int e = threadIdx.x; e < kTile * kSlice; e += blockDim.x) {
      const int r = e / kSlice, c = e % kSlice, gd = d0 + c;
      const int gb = b0 + r, gk = k0 + r;
      const bool in_d = gd < d;
      const float xv = (gb < B && in_d) ? x[(int64_t)gb * d + gd] : 0.f;
      const float av = (gk < K && in_d) ? a[(int64_t)gk * d + gd] : 0.f;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float th =
            (j0 + j < J && in_d) ? thetas[(int64_t)(j0 + j) * d + gd] : 0.f;
        xt[j][c][r] = xv * th;
      }
      xx[c][r] = xv * xv;
      as[c][r] = av;
      aa[c][r] = av * av;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kSlice; ++c) {
      float xr[kJ][kReg], x2[kReg], ar[kReg], a2[kReg];
#pragma unroll
      for (int i = 0; i < kReg; ++i) {
        x2[i] = xx[c][ty + kSide * i];
        ar[i] = as[c][tx + kSide * i];
        a2[i] = aa[c][tx + kSide * i];
#pragma unroll
        for (int j = 0; j < kJ; ++j) xr[j][i] = xt[j][c][ty + kSide * i];
      }
#pragma unroll
      for (int i = 0; i < kReg; ++i)
#pragma unroll
        for (int n = 0; n < kReg; ++n) {
          den[i][n] = fmaf(x2[i], a2[n], den[i][n]);
#pragma unroll
          for (int j = 0; j < kJ; ++j)
            num[j][i][n] = fmaf(xr[j][i], ar[n], num[j][i][n]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kReg; ++i) {
    const int gb = b0 + ty + kSide * i;
    if (gb >= B) continue;
#pragma unroll
    for (int n = 0; n < kReg; ++n) {
      const int gk = k0 + tx + kSide * n;
      if (gk >= K) continue;
      const float dn = sqrtf(fmaxf(den[i][n], 1e-24f));
#pragma unroll
      for (int j = 0; j < kJ; ++j)
        if (j0 + j < J)
          out[((int64_t)(j0 + j) * B + gb) * K + gk] = num[j][i][n] / dn;
    }
  }
}

}  // namespace

// out: (J, B, K) floats
extern "C" int dueling_score_launch(const void* x, const void* a,
                                    const void* thetas, void* out, int B,
                                    int K, int d, int J, void* stream) {
  if (B > 0 && K > 0 && J > 0) {
    const dim3 grid((K + kTile - 1) / kTile, (B + kTile - 1) / kTile,
                    (J + kJ - 1) / kJ);
    dueling_score_kernel<<<grid, kSide * kSide, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)a, (const float*)thetas, (float*)out,
        B, K, d, J);
  }
  return (int)cudaGetLastError();
}
