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
// query, J = 16 chains, K = 16, d = 768) the ~0.1 MB it reads, so latency
// and the launch; at B = 4096, K = 1024, J = 2 the (J+1)*2*B*K*d fp32
// operations of J numerators and one denominator.
//
// Two configurations, chosen by the wrapper (dueling_score.score_plan):
// - Small (few outputs: B*K*J*d <= 2^27, as posterior_scores' one query
//   has; measured faster than Large up to ~1e8 on the H100): a warp per
//   output (j, b, k), k fastest. Lane l loads its part of x_b, a_k and
//   theta_j, the float4s l, l + 32, ... of d (elements l, l + 32, ...
//   where d % 4 != 0 or a table is not 16-byte aligned), up to 1024
//   elements per warp at a time, every load issued before the fma chain:
//   one latency round where a d-slice walk paid one per slice. The lane sums go through one fixed
//   xor tree. Every output, the denominator included, is computed in that
//   same order wherever it sits, so duplicated arms give bitwise equal
//   columns (win_matrix scores them as exact ties), and a zero arm or
//   query scores 0 through the 1e-24 clamp.
// - Large (any shape; the operations-bound ones): a plain shared-memory
//   tiled product, no wgmma or TMA. A block owns a 64 x 64 tile of (b, k)
//   and JB = 2 samples (grid z walks the samples in pairs, so J is a
//   runtime size). It stages 16-wide slices of d: x*theta_j and x*x of its
//   rows, formed as the slice is loaded, and a and a*a of its arms. Each
//   thread holds a 4 x 4 register block of outputs with one denominator
//   and JB numerator accumulators. Every output element is accumulated by
//   one thread over d in increasing order with fmaf, wherever it sits in
//   the tile, and every sample pair recomputes the denominator in that
//   same order: duplicated arms again give bitwise equal columns.
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

// ---- Large: the tiled product ----------------------------------------------

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

// ---- Small: a warp per output ---------------------------------------------

constexpr int kSmallWarps = 2;       // outputs per block

// W = 4: 16-byte loads (d % 4 == 0, tables 16-byte aligned), else 4-byte;
// each lane holds U loads of x, a and theta at a time (1024 elements a lane
// group)
template <int W>
__global__ void __launch_bounds__(32 * kSmallWarps) dueling_score_small(
    const float* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ thetas, float* __restrict__ out, int B, int K,
    int d, int J) {
  constexpr int U = 32 / W;
  const int64_t o = (int64_t)blockIdx.x * kSmallWarps + threadIdx.x / 32;
  if (o >= (int64_t)J * B * K) return;         // the whole warp
  const int lane = threadIdx.x % 32;
  const int k = (int)(o % K);
  const int64_t jb = o / K;
  const int b = (int)(jb % B), j = (int)(jb / B);
  const float* xr = x + (int64_t)b * d;
  const float* ar = a + (int64_t)k * d;
  const float* tr = thetas + (int64_t)j * d;
  float n = 0.f, e = 0.f;
  for (int t0 = 0; t0 < d; t0 += 32 * U * W) {
    float xv[U][W], av[U][W], tv[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + (u * 32 + lane) * W;  // the lane's u-th load
      const bool ok = t < d;                   // W = 4: all four or none
      if constexpr (W == 4) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 xf = ok ? *reinterpret_cast<const float4*>(xr + t) : z;
        const float4 af = ok ? *reinterpret_cast<const float4*>(ar + t) : z;
        const float4 tf = ok ? *reinterpret_cast<const float4*>(tr + t) : z;
        xv[u][0] = xf.x; xv[u][1] = xf.y; xv[u][2] = xf.z; xv[u][3] = xf.w;
        av[u][0] = af.x; av[u][1] = af.y; av[u][2] = af.z; av[u][3] = af.w;
        tv[u][0] = tf.x; tv[u][1] = tf.y; tv[u][2] = tf.z; tv[u][3] = tf.w;
      } else {
        xv[u][0] = ok ? xr[t] : 0.f;
        av[u][0] = ok ? ar[t] : 0.f;
        tv[u][0] = ok ? tr[t] : 0.f;
      }
    }
    // past d every value is 0: adding 0 leaves a sum as it is
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const float xt = __fmul_rn(xv[u][i], tv[u][i]);
        const float xx = __fmul_rn(xv[u][i], xv[u][i]);
        n = fmaf(xt, av[u][i], n);
        e = fmaf(xx, __fmul_rn(av[u][i], av[u][i]), e);
      }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {           // the fixed xor tree
    n = __fadd_rn(n, __shfl_xor_sync(0xffffffffu, n, s));
    e = __fadd_rn(e, __shfl_xor_sync(0xffffffffu, e, s));
  }
  if (lane == 0) out[o] = __fdiv_rn(n, sqrtf(fmaxf(e, 1e-24f)));
}

}  // namespace

// out: (J, B, K) floats. cfg 0 Small, 1 Large and its grid (gx, gy, gz),
// from dueling_score.score_plan
extern "C" int dueling_score_launch(const void* x, const void* a,
                                    const void* thetas, void* out, int B,
                                    int K, int d, int J, int cfg, int gx,
                                    int gy, int gz, void* stream) {
  if (B <= 0 || K <= 0 || J <= 0) return (int)cudaGetLastError();
  const dim3 grid(gx, gy, gz);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* af = (const float*)a;
  const float* tf = (const float*)thetas;
  float* of = (float*)out;
  if (cfg == 0) {
    const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)a % 16 == 0 && (uintptr_t)thetas % 16 == 0;
    if (vec)
      dueling_score_small<4><<<grid, 32 * kSmallWarps, 0, st>>>(
          xf, af, tf, of, B, K, d, J);
    else
      dueling_score_small<1><<<grid, 32 * kSmallWarps, 0, st>>>(
          xf, af, tf, of, B, K, d, J);
  } else if (cfg == 1) {
    dueling_score_kernel<<<grid, kSide * kSide, 0, st>>>(xf, af, tf, of, B,
                                                         K, d, J);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
