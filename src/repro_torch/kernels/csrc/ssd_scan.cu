// Mamba-2 chunked SSD scan for sm_90a (fp32 on the CUDA cores, no tensor cores).
//
// Replaces the TPU kernel at src/repro/kernels/ssd_scan.py:109 (_ssd_kernel, :26-80).
// Inputs: x (B,S,H,P), B and C (B,S,N) shared across heads, fp32 or bf16 (widened on
// load), read through their batch and sequence strides (the model hands in column
// slices of one conv output); log_a and dt (B,S,H) fp32; optional h0 (B,H,P,N) fp32.
// Outputs: y (B,S,H,P) fp32 and h_last (B,H,P,N) fp32. Per chunk of L steps:
//   cum     = cumsum(log_a)             (padded steps past S: log_a = dt = 0)
//   W[i,j]  = (C_i . B_j) exp(cum_i - cum_j) dt_j   for j <= i, else 0
//   y_i     = sum_j W[i,j] x_j + exp(cum_i) (C_i . state)
//   state'  = exp(cum_L) state + sum_j exp(cum_L - cum_j) dt_j x_j (x) B_j
//
// Design. The TPU walks the chunks as a sequential grid axis with the state in VMEM; on
// Hopper nothing carries between blocks, so each block loops over the chunks itself and
// keeps the state in shared memory. The grid is (B*H, P/32): each state row p depends only
// on column p of x, so splitting P is exact and puts 256 blocks on the 132 SMs at
// mamba2-1.3b's B 2, H 64 (B*H alone gives 128). Each P-tile recomputes C.B^T.
//
// Bound: operations. The function needs ~5.25 MFLOP per (batch*head, chunk) at L 128,
// P 64, N 128 (the causal half of W x, C.state, the state update) plus 2.1 MFLOP per
// (batch, chunk) for the causal half of C.B^T, which the heads share; ~0.2 GB moved. This
// kernel recomputes C.B^T for every (head, P-tile). Shared memory is the catch:
// one chunk's B and C (64 KB each in fp32), W (64 KB), x and the state would exceed the
// 227 KB a block may hold, so W is computed in two passes of 64 rows (33 KB), which also
// skips the upper-right quarter that the causal mask zeroes. 200 KB in all, one block per
// SM. Rows of the B, C and W tiles are padded by one float so the threads of a warp read
// distinct banks. C.B^T uses 4 x 8 register blocks over rows interleaved by 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LMAX = 128;   // chunk length at most (a multiple of 16)
constexpr int NMAX = 128;   // state width at most
constexpr int PT = 32;      // state rows (columns of x) per block
constexpr int NS = NMAX + 1;
constexpr int WS = LMAX + 1;
constexpr int XS = PT + 1;
constexpr int RG = 64;      // rows of W per pass
constexpr int THREADS = 256;
constexpr int SMEM_FLOATS = 2 * LMAX * NS + RG * WS + LMAX * XS + PT * NS + 3 * LMAX;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Args {
  const void* x;
  const void* bt;
  const void* ct;
  const float* la;
  const float* dt;
  const float* h0;
  float* y;
  float* h_last;
  int B, S, H, P, N, L;
  long long x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, a_sb, a_ss, a_sh, d_sb, d_ss, d_sh;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_kernel(const Args g) {
  extern __shared__ float smem[];
  float* Bs = smem;              // [LMAX][NS]
  float* Cs = Bs + LMAX * NS;    // [LMAX][NS]
  float* Ws = Cs + LMAX * NS;    // [RG][WS]
  float* xs = Ws + RG * WS;      // [LMAX][XS]
  float* st = xs + LMAX * XS;    // [PT][NS]
  float* cum = st + PT * NS;     // [LMAX]
  float* dts = cum + LMAX;       // [LMAX]
  float* dec = dts + LMAX;       // [LMAX]: exp(cum_L - cum_j) dt_j

  const int tid = threadIdx.x;
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int p0 = blockIdx.y * PT;
  const int L = g.L, N = g.N, P = g.P, S = g.S, H = g.H;
  const T* x = (const T*)g.x + b * g.x_sb + h * g.x_sh;
  const T* bt = (const T*)g.bt + b * g.b_sb;
  const T* ct = (const T*)g.ct + b * g.c_sb;
  const float* la = g.la + b * g.a_sb + h * g.a_sh;
  const float* dtp = g.dt + b * g.d_sb + h * g.d_sh;
  const size_t hbase = ((size_t)b * H + h) * P;

  for (int e = tid; e < PT * N; e += THREADS) {
    const int p = e / N, n = e % N;
    st[p * NS + n] = (g.h0 && p0 + p < P) ? g.h0[(hbase + p0 + p) * N + n] : 0.f;
  }
  const int n_chunks = (S + L - 1) / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * L;
    if (tid < L) {
      const int s = s0 + tid;
      cum[tid] = s < S ? la[s * g.a_ss] : 0.f;
      dts[tid] = s < S ? dtp[s * g.d_ss] : 0.f;
    }
    for (int e = tid; e < L * N; e += THREADS) {
      const int j = e / N, n = e % N, s = s0 + j;
      Bs[j * NS + n] = s < S ? widen(bt[s * g.b_ss + n]) : 0.f;
      Cs[j * NS + n] = s < S ? widen(ct[s * g.c_ss + n]) : 0.f;
    }
    for (int e = tid; e < L * PT; e += THREADS) {
      const int j = e / PT, p = e % PT, s = s0 + j;
      xs[j * XS + p] = (s < S && p0 + p < P) ? widen(x[s * g.x_ss + p0 + p]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // in order, as jnp.cumsum sums the chunk
      float acc = 0.f;
      for (int j = 0; j < L; ++j) {
        acc += cum[j];
        cum[j] = acc;
      }
    }
    __syncthreads();
    if (tid < L) dec[tid] = expf(cum[L - 1] - cum[tid]) * dts[tid];

    for (int i0 = 0; i0 < L; i0 += RG) {
      const int jn = min(L, i0 + RG);  // the causal mask zeroes columns j > i
      {
        const int ti = tid / 16, tj = tid % 16, nj = jn / 16;
        float acc[4][8];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[8];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cs[(i0 + ti + 16 * r) * NS + n];
#pragma unroll
          for (int q = 0; q < 8; ++q) bv[q] = q < nj ? Bs[(tj + 16 * q) * NS + n] : 0.f;
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[r][q] += cv[r] * bv[q];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ti + 16 * r;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int j = tj + 16 * q;
            if (q < nj)
              Ws[(i - i0) * WS + j] =
                  (i < L && j <= i) ? acc[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
          }
        }
      }
      __syncthreads();
      {
        const int r = tid / 4, pc = tid % 4, i = i0 + r;  // columns pc + 4k
        if (i < L) {
          float yi[8], ye[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) yi[k] = ye[k] = 0.f;
          for (int j = 0; j <= i; ++j) {
            const float w = Ws[r * WS + j];
#pragma unroll
            for (int k = 0; k < 8; ++k) yi[k] += w * xs[j * XS + pc + 4 * k];
          }
          for (int n = 0; n < N; ++n) {
            const float cv = Cs[i * NS + n];
#pragma unroll
            for (int k = 0; k < 8; ++k) ye[k] += cv * st[(pc + 4 * k) * NS + n];
          }
          const float ei = expf(cum[i]);
          const int s = s0 + i;
          if (s < S) {
            float* yrow = g.y + (((size_t)b * S + s) * H + h) * P;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int p = p0 + pc + 4 * k;
              if (p < P) yrow[p] = yi[k] + ei * ye[k];
            }
          }
        }
      }
      __syncthreads();
    }
    {  // state' = exp(cum_L) state + sum_j (x_j dec_j) (x) B_j
      const int p = tid / 8, nc = tid % 8;  // n = nc + 8k
      float acc[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = 0.f;
      for (int j = 0; j < L; ++j) {
        const float xw = xs[j * XS + p] * dec[j];
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] += xw * Bs[j * NS + nc + 8 * k];
      }
      const float ea = expf(cum[L - 1]);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int n = nc + 8 * k;
        if (n < N) st[p * NS + n] = ea * st[p * NS + n] + acc[k];
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < PT * N; e += THREADS) {
    const int p = e / N, n = e % N;
    if (p0 + p < P) g.h_last[(hbase + p0 + p) * N + n] = st[p * NS + n];
  }
}

template <typename T>
int launch(const Args& g, cudaStream_t stream) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ssd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(g.B * g.H, (g.P + PT - 1) / PT);
  ssd_kernel<T><<<grid, THREADS, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* bt, const void* ct, const void* la,
                               const void* dt, const void* h0, void* y, void* h_last, int B,
                               int S, int H, int P, int N, int L, long long x_sb,
                               long long x_ss, long long x_sh, long long b_sb, long long b_ss,
                               long long c_sb, long long c_ss, long long a_sb, long long a_ss,
                               long long a_sh, long long d_sb, long long d_ss, long long d_sh,
                               int is_bf16, void* stream) {
  const Args g{x,    bt,   ct,   (const float*)la, (const float*)dt, (const float*)h0,
               (float*)y, (float*)h_last, B, S, H, P, N, L, x_sb, x_ss, x_sh, b_sb, b_ss,
               c_sb, c_ss, a_sb, a_ss, a_sh, d_sb, d_ss, d_sh};
  return is_bf16 ? launch<__nv_bfloat16>(g, (cudaStream_t)stream)
                 : launch<float>(g, (cudaStream_t)stream);
}
