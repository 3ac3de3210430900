// Mamba-2 chunked SSD scan for sm_90a. Two routes, chosen by the wrapper's rule:
//
// * ssd_kernel (described first): fp32 on the CUDA cores, no tensor cores; every shape
//   the wrapper takes, fp32 or bf16 inputs.
// * ssd_kernel_cb_sm90 + ssd_kernel_sm90 (after it, with their own notes): bf16 x, B, C
//   at P 64, N 128, chunk 128 (mamba2-1.3b's prefill), on wgmma fed by TMA.
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
// Design of the SIMT kernel. The TPU walks the chunks as a sequential grid axis with the state in VMEM; on
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
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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


// ---------------------------------------------------------------------------
// bf16: ssd_kernel_cb_sm90, then ssd_kernel_sm90 (wgmma, TMA, an mbarrier ring)
// ---------------------------------------------------------------------------
//
// For bf16 x, B and C at P 64, N 128 and chunks of 128 (mamba2-1.3b's
// prefill); the wrapper sends every other shape to the SIMT kernel above.
//
// Bound and cost. The function needs ~21.6 GFLOP at mamba2-1.3b's prefill
// (B 2, S 4096, H 64), 0.022 ms at the bf16 tensor-core rate (0.32 ms at the
// fp32 CUDA-core rate); ~214 MB move, 0.064 ms: bound by bytes. On the bf16 tensor cores each product with an fp32 operand takes
// three bf16 pieces of that operand (sm90::split3), so every product stays
// exact and only the fp32 accumulation order differs from the plain
// version: ~65 GFLOP of wgmma.
//
// 1. ssd_kernel_cb_sm90, one block per (batch, chunk): CB = C B^T (L x L,
//    fp32) by one bf16 wgmma of the chunk's B and C (exact products, fp32
//    sums), written to a (B, n_chunks, L, L) fp32 scratch (4.2 MB at
//    mamba2-1.3b, read back from L2). The heads share B and C, so this is
//    done once per (batch, chunk), not once per head.
// 2. ssd_kernel_sm90, one block per (batch, head), walks the chunks with the
//    state (P x N fp32) in the registers of two consumer warpgroups (each
//    owns 64 of the N columns). A producer warpgroup keeps the next chunk in
//    flight through a 2-stage ring: one thread issues the TMA loads of x
//    (L x P) and B, C (L x N each; 4-D tensor maps over the model's strided
//    column slices, read in place), another warp loads log_a and dt, sums
//    cum = cumsum(log_a) in order (one lane, as the SIMT kernel and
//    jnp.cumsum sum it) and dec_j = exp(cum_L - cum_j) dt_j. Per chunk and
//    consumer warpgroup (rows i of its 64-row half):
//      y_inter = C state^T            wgmma, A = C (smem), B = the state's
//                                     three bf16 pieces (smem, K-major)
//      W       = CB exp(cum_i - cum_j) dt_j (j <= i), formed in registers in
//                the accumulator layout from the CB scratch (the next
//                chunk's rows are loaded while this chunk's state updates;
//                8-column groups masked for a whole warp are skipped), split
//                into three bf16 A fragments there (as P in flash_attention)
//      y       = W x + exp(cum_i) y_inter   (wgmma, x MN-major); the first
//                half's columns j >= 64 are all masked and skipped
//      s_new   = (x dec)^T B          A = x read transposed by ldmatrix,
//                times dec in fp32, split into three pieces; B MN-major
//      state   = exp(cum_L) state + s_new, then split into three pieces in
//                shared memory for the next chunk's C state^T
//    Shared memory: 2 stages x 80 KB (x 16, B 32, C 32), the state's pieces
//    48 KB, 217 KB in all: one block per SM, 128 blocks at B 2, H 64.
//    Rows past S arrive as zeros (TMA), and log_a = dt = 0 there, as in the
//    plain version's padding; rows past S are not stored.

namespace tc {

constexpr int L = 128;                     // chunk length
constexpr int P = 64;                      // state rows (x columns)
constexpr int N = 128;                     // state width
constexpr int kStages = 2;
constexpr int kThreads = 384;              // consumers 0-255, producer 256-383
constexpr int kConsumers = 256;
constexpr uint32_t kRow = 128;             // bytes per swizzled row: 64 bf16
constexpr uint32_t kXBytes = L * kRow;     // x: L rows x 64 columns
constexpr uint32_t kNSlab = L * kRow;      // 64 of the N columns of B or C
constexpr uint32_t kBCBytes = 2 * kNSlab;  // B (or C) for one chunk
constexpr uint32_t kStageBytes = kXBytes + 2 * kBCBytes;
constexpr uint32_t kStSlab = P * kRow;     // 64 of the state's N columns
constexpr uint32_t kStPiece = 2 * kStSlab; // one bf16 piece of the state
constexpr size_t kSmem = 1024 + kStages * kStageBytes + 3 * kStPiece +
                         3 * kStages * L * sizeof(float) + 64;
constexpr size_t kCbSmem = 1024 + 2 * kBCBytes + 64;
constexpr int kSwizzle = sm90::layout_of(kRow);

struct Params {
  const float* la;
  const float* dt;
  const float* h0;
  const float* cb;
  float* y;
  float* h_last;
  int S, H, n_chunks;
  long long a_sb, a_ss, a_sh, d_sb, d_ss, d_sh;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

__global__ void __launch_bounds__(256) ssd_kernel_cb_sm90(
    const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tcm, float* cb, int n_chunks) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sB = align1024(smem_raw);
  uint8_t* sC = sB + kBCBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sC + kBCBytes);
  const int c = blockIdx.x, b = blockIdx.y;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(bar, 2 * kBCBytes);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      sm90::tma_load_4d(sB + s * kNSlab, &tb, bar, 64 * s, c * L, 0, b);
      sm90::tma_load_4d(sC + s * kNSlab, &tcm, bar, 64 * s, c * L, 0, b);
    }
  }
  sm90::mbar_wait(bar, 0);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  const uint64_t dc = sm90::desc(sC + 64 * wg * kRow, 16, 8 * kRow, kSwizzle);
  const uint64_t db = sm90::desc(sB, 16, 8 * kRow, kSwizzle);
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t off = (kk / 4) * kNSlab + (kk % 4) * 32;
    sm90::wgmma_ss<0>(acc, dc + (off >> 4), db + (off >> 4), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  // accumulator: row 64 wg + 16 warp + lane / 4 + 8 r, column 8 j + 2 (lane % 4) + c
  float* out = cb + (((size_t)b * n_chunks + c) * L + 64 * wg + 16 * warp + lane / 4) * L +
               2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < L / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + 8 * r * L + 8 * j) =
          make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
}

// this thread's state registers (rows p = prow, prow + 8; columns
// 64 wg + 8 j + 2 q + c) as three bf16 pieces in shared memory, each a
// K-major (p rows, N columns) tile of two 64-column slabs, 128B-swizzled
__device__ __forceinline__ void put_state(uint8_t* s_state, const float (&st)[32], int wg,
                                          int prow, int q) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = prow + 8 * r;
      uint32_t pc[3];
      sm90::split3(st[4 * j + 2 * r], st[4 * j + 2 * r + 1], pc[0], pc[1], pc[2]);
      const uint32_t off = wg * kStSlab + p * kRow + ((j ^ (p & 7)) << 4) + 4 * q;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint32_t*>(s_state + k * kStPiece + off) = pc[k];
    }
}

__global__ void __launch_bounds__(kThreads, 1) ssd_kernel_sm90(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tcm, const Params g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_stage = align1024(smem_raw);                  // [kStages] x | B | C
  uint8_t* s_state = s_stage + kStages * kStageBytes;      // [3 pieces] state
  float* s_cum = reinterpret_cast<float*>(s_state + 3 * kStPiece);  // [kStages][L]
  float* s_dt = s_cum + kStages * L;
  float* s_dec = s_dt + kStages * L;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_dec + kStages * L);
  uint64_t* empty = full + kStages;

  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int nc = g.n_chunks;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);  // the TMA thread and the cumsum warp
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    sm90::regs_dec<40>();
    const int warp = (threadIdx.x - kConsumers) / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      sm90::tma_prefetch(&tx);
      sm90::tma_prefetch(&tb);
      sm90::tma_prefetch(&tcm);
      for (int it = 0; it < nc; ++it) {
        const int st = it % kStages;
        sm90::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[st], kStageBytes);
        uint8_t* d = s_stage + st * kStageBytes;
        sm90::tma_load_4d(d, &tx, &full[st], 0, it * L, h, b);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          sm90::tma_load_4d(d + kXBytes + s * kNSlab, &tb, &full[st], 64 * s, it * L, 0, b);
          sm90::tma_load_4d(d + kXBytes + kBCBytes + s * kNSlab, &tcm, &full[st], 64 * s,
                            it * L, 0, b);
        }
      }
    } else if (warp == 1) {
      const float* la = g.la + b * g.a_sb + h * g.a_sh;
      const float* dtp = g.dt + b * g.d_sb + h * g.d_sh;
      for (int it = 0; it < nc; ++it) {
        const int st = it % kStages;
        float* cum = s_cum + st * L;
        float* dts = s_dt + st * L;
        float* dec = s_dec + st * L;
        sm90::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
#pragma unroll
        for (int u = 0; u < L / 32; ++u) {
          const int j = lane + 32 * u;
          const long long s = (long long)it * L + j;
          cum[j] = s < g.S ? la[s * g.a_ss] : 0.f;
          dts[j] = s < g.S ? dtp[s * g.d_ss] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {  // in order, as jnp.cumsum sums the chunk
          float acc = 0.f;
          float4* c4 = reinterpret_cast<float4*>(cum);
          for (int j4 = 0; j4 < L / 4; ++j4) {
            float4 v = c4[j4];
            acc += v.x;
            v.x = acc;
            acc += v.y;
            v.y = acc;
            acc += v.z;
            v.z = acc;
            acc += v.w;
            v.w = acc;
            c4[j4] = v;
          }
        }
        __syncwarp();
        const float cl = cum[L - 1];
#pragma unroll
        for (int u = 0; u < L / 32; ++u) {
          const int j = lane + 32 * u;
          dec[j] = expf(cl - cum[j]) * dts[j];
        }
        sm90::mbar_arrive(&full[st]);
      }
    }
  } else {
    sm90::regs_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int q = lane % 4;
    const int prow = 16 * warp + lane / 4;   // state rows prow, prow + 8
    const int irow = 64 * wg + prow;         // chunk rows irow, irow + 8
    const size_t hrow = ((size_t)b * g.H + h) * P;
    float stv[32];  // state: rows prow + 8 r, columns 64 wg + 8 j + 2 q + c
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v = g.h0 ? *reinterpret_cast<const float2*>(
                                    g.h0 + (hrow + prow + 8 * r) * N + 64 * wg + 8 * j + 2 * q)
                              : make_float2(0.f, 0.f);
        stv[4 * j + 2 * r] = v.x;
        stv[4 * j + 2 * r + 1] = v.y;
      }
    put_state(s_state, stv, wg, prow, q);
    sm90::fence_proxy_async();
    sm90::bar_sync(1, kConsumers);

    // this thread's rows of C.B^T from the first kernel, in the accumulator
    // layout; a group of 8 columns that the causal mask zeroes for all of
    // this warp's rows stays 0 (warp-uniform, so W skips it too)
    const int last_row = 64 * wg + 16 * warp + 15;
    float w[64];
    auto load_cb = [&](int chunk) {
      const float* cbp = g.cb + (((size_t)b * nc + chunk) * L + irow) * L + 2 * q;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2 v = make_float2(0.f, 0.f);
          if (8 * j <= last_row) v = *reinterpret_cast<const float2*>(cbp + 8 * r * L + 8 * j);
          w[4 * j + 2 * r] = v.x;
          w[4 * j + 2 * r + 1] = v.y;
        }
    };
    load_cb(0);

    for (int it = 0; it < nc; ++it) {
      const int st = it % kStages;
      uint8_t* sx = s_stage + st * kStageBytes;
      uint8_t* sb = sx + kXBytes;
      uint8_t* sc = sb + kBCBytes;
      const float* cum = s_cum + st * L;
      const float* dts = s_dt + st * L;
      const float* dec = s_dec + st * L;

      sm90::mbar_wait(&full[st], (it / kStages) & 1);

      // y_inter = C state^T over the state's three pieces
      float yi[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) yi[e] = 0.f;
      const uint64_t dc = sm90::desc(sc + 64 * wg * kRow, 16, 8 * kRow, kSwizzle);
      sm90::fence_regs(yi);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const uint64_t ds = sm90::desc(s_state + k * kStPiece, 16, 8 * kRow, kSwizzle);
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          sm90::wgmma_ss<0>(yi, dc + (((kk / 4) * kNSlab + (kk % 4) * 32) >> 4),
                            ds + (((kk / 4) * kStSlab + (kk % 4) * 32) >> 4), 1);
      }
      sm90::wgmma_commit();

      // W = CB exp(cum_i - cum_j) dt_j on j <= i, in the accumulator layout
      const float ci[2] = {cum[irow], cum[irow + 8]};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (8 * j > last_row) continue;
        const int jc = 8 * j + 2 * q;
        const float2 cj = *reinterpret_cast<const float2*>(cum + jc);
        const float2 dj = *reinterpret_cast<const float2*>(dts + jc);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = irow + 8 * r;
          float& w0 = w[4 * j + 2 * r];
          float& w1 = w[4 * j + 2 * r + 1];
          w0 = jc <= i ? w0 * expf(ci[r] - cj.x) * dj.x : 0.f;
          w1 = jc + 1 <= i ? w1 * expf(ci[r] - cj.y) * dj.y : 0.f;
        }
      }

      // y_intra = W x, 16 columns of W a step, three pieces each
      float yw[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) yw[e] = 0.f;
      const uint64_t dx = sm90::desc(sx, kXBytes, 8 * kRow, kSwizzle);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half > wg) break;
        uint32_t a[4][3][4];
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = 8 * (4 * half + kq) + 2 * u;
            sm90::split3(w[e], w[e + 1], a[kq][0][u], a[kq][1][u], a[kq][2][u]);
          }
        sm90::fence_regs(yw);
        sm90::wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            sm90::wgmma_rs<1>(yw, a[kq][k], dx + (((4 * half + kq) * 16 * kRow) >> 4), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(yw);
      }
      sm90::fence_regs(yi);
      if (it + 1 < nc) load_cb(it + 1);  // in flight while the state updates

      // y = y_intra + exp(cum_i) y_inter
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = it * L + irow + 8 * r;
        if (s >= g.S) continue;
        const float e = expf(ci[r]);
        float* yrow = g.y + (((size_t)b * g.S + s) * g.H + h) * P + 2 * q;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(yrow + 8 * j) =
              make_float2(yw[4 * j + 2 * r] + e * yi[4 * j + 2 * r],
                          yw[4 * j + 2 * r + 1] + e * yi[4 * j + 2 * r + 1]);
      }

      // s_new = (x dec)^T B: A (p rows, j columns) is x read transposed
      float sn[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sn[e] = 0.f;
      const uint64_t dbw = sm90::desc(sb + wg * kNSlab, kNSlab, 8 * kRow, kSwizzle);
      const int mi = lane / 8;  // the 8 x 8 matrix whose row this lane addresses
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t a[4][3][4];
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          const int kk = 4 * half + kq;
          const int j = 16 * kk + 8 * (mi >> 1) + lane % 8;
          const int p0 = 16 * warp + 8 * (mi & 1);
          uint32_t xr[4];
          sm90::ldmatrix_x4_trans(xr, sx + j * kRow + ((((p0 >> 3) ^ (j & 7))) << 4));
          const float2 dlo = *reinterpret_cast<const float2*>(dec + 16 * kk + 2 * q);
          const float2 dhi = *reinterpret_cast<const float2*>(dec + 16 * kk + 8 + 2 * q);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 xv = sm90::unpack_bf16(xr[u]);
            const float2 d = u < 2 ? dlo : dhi;
            sm90::split3(xv.x * d.x, xv.y * d.y, a[kq][0][u], a[kq][1][u], a[kq][2][u]);
          }
        }
        sm90::fence_regs(sn);
        sm90::wgmma_fence();
#pragma unroll
        for (int kq = 0; kq < 4; ++kq)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            sm90::wgmma_rs<1>(sn, a[kq][k], dbw + (((4 * half + kq) * 16 * kRow) >> 4), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sn);
      }
      const float e_last = expf(cum[L - 1]);
      sm90::mbar_arrive(&empty[st]);  // this stage's x, B, C, cum, dt and dec are read

      // state' = exp(cum_L) state + s_new, once both groups are done with
      // the old state's pieces
      sm90::bar_sync(1, kConsumers);
#pragma unroll
      for (int e = 0; e < 32; ++e) stv[e] = e_last * stv[e] + sn[e];
      put_state(s_state, stv, wg, prow, q);
      sm90::fence_proxy_async();
      sm90::bar_sync(2, kConsumers);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(g.h_last + (hrow + prow + 8 * r) * N + 64 * wg + 8 * j +
                                   2 * q) = make_float2(stv[4 * j + 2 * r], stv[4 * j + 2 * r + 1]);
  }
}

int launch(const void* x, const void* bt, const void* ct, const Params& p, float* cb, int B,
           const long long* xs, const long long* bs, const long long* cs, cudaStream_t stream) {
  constexpr cuuint64_t E = sizeof(__nv_bfloat16);
  CUtensorMap tx, tb, tcm;
  // x (B,S,H,P) as (P, S, H, B); B and C (B,S,N) as (N, S, 1, B)
  const cuuint64_t dx[4] = {P, (cuuint64_t)p.S, (cuuint64_t)p.H, (cuuint64_t)B};
  const cuuint64_t dbc[4] = {N, (cuuint64_t)p.S, 1, (cuuint64_t)B};
  const cuuint64_t sx[3] = {xs[1] * E, xs[2] * E, xs[0] * E};
  const cuuint64_t sb[3] = {bs[1] * E, N * E, bs[0] * E};
  const cuuint64_t sc[3] = {cs[1] * E, N * E, cs[0] * E};
  cudaError_t err = sm90::encode_bf16_4d(&tx, x, dx, sx, 64, L);
  if (err == cudaSuccess) err = sm90::encode_bf16_4d(&tb, bt, dbc, sb, 64, L);
  if (err == cudaSuccess) err = sm90::encode_bf16_4d(&tcm, ct, dbc, sc, 64, L);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_kernel_cb_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kCbSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_kernel_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel_cb_sm90<<<dim3(p.n_chunks, B), 256, kCbSmem, stream>>>(tb, tcm, cb, p.n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_kernel_sm90<<<B * p.H, kThreads, kSmem, stream>>>(tx, tb, tcm, p);
  return (int)cudaGetLastError();
}

}  // namespace tc
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

// bf16 x, B, C at P 64, N 128, chunk 128: the Hopper kernels; cb is a
// (B, ceil(S / 128), 128, 128) fp32 scratch. Base addresses and the strides
// of x (batch, seq, head) and of B and C (batch, seq) are 16-byte aligned.
extern "C" int ssd_scan_sm90_launch(const void* x, const void* bt, const void* ct,
                                    const void* la, const void* dt, const void* h0, void* y,
                                    void* h_last, void* cb, int B, int S, int H,
                                    long long x_sb, long long x_ss, long long x_sh,
                                    long long b_sb, long long b_ss, long long c_sb,
                                    long long c_ss, long long a_sb, long long a_ss,
                                    long long a_sh, long long d_sb, long long d_ss,
                                    long long d_sh, void* stream) {
  const tc::Params p{(const float*)la, (const float*)dt, (const float*)h0, (const float*)cb,
                     (float*)y, (float*)h_last, S, H, (S + tc::L - 1) / tc::L,
                     a_sb, a_ss, a_sh, d_sb, d_ss, d_sh};
  const long long xs[3] = {x_sb, x_ss, x_sh};
  const long long bs[2] = {b_sb, b_ss};
  const long long cs[2] = {c_sb, c_ss};
  return tc::launch(x, bt, ct, p, (float*)cb, B, xs, bs, cs, (cudaStream_t)stream);
}
