// flash_attention_bwd: the gradient of the fp32 attention of
// flash_attention.cu (GQA, causal and sliding-window masks, the logit soft
// cap, any S and T, head dims 1-256), FlashAttention-2's backward.
//
// Replaces no Pallas kernel: it is the gradient of _attn_kernel (:23) of
// src/repro/kernels/flash_attention.py, which the reference takes by XLA's
// autodiff of its einsum attention (src/repro/models/attention.py,
// _attend). The encoder trains through it.
//
// With x = scale q_i.k_j, s = cap tanh(x / cap) (s = x without a cap), the
// forward's row log-sum-exp lse_i over the live keys, o its output and dO
// the output gradient:
//   P_ij  = exp(s_ij - lse_i) on live keys, 0 elsewhere
//   dV_j += sum_i P_ij dO_i                      (over the kv head's group)
//   dS_ij = P_ij (dO_i.v_j - Delta_i) (1 - tanh^2(x_ij / cap)),
//           Delta_i = dO_i.o_i
//   dQ_i  = scale sum_j dS_ij k_j,   dK_j = scale sum_i dS_ij q_i
// A row with no live key (a window, i >= T + window - 1) took the mean of
// v, so it adds dO_i / T to every dV_j and nothing to dQ or dK; rows are
// told dead by index, as the forward tells them.
//
// What bounds it on the card: 10 D operations per live (row, key) pair
// (five products: s, dO.v, dV, dK, dQ; s and dO.v twice, once per
// kernel, which the bound does not count) at 67 TFLOP/s on the CUDA cores
// in fp32 (no tensor cores on fp32 inputs, by the port's numerics rule),
// or the bytes of q, k, v, o, dO, lse, dq, dk and dv for short rows.
//
// Three launches, in a fixed order, no atomics, so results repeat bitwise:
//   1. delta_kernel: Delta_i, a warp per row.
//   2. dkdv_kernel: a block of 128 threads per (b, kv head, tile of BKV
//      keys), K and V resident in shared memory; it walks the group's
//      query heads in order and, per head, the tiles of 32 query rows that
//      hold a live key for its keys. Per step: Q, dO, lse and Delta land
//      by cp.async; thread (ty, tx) = (tid / 8, tid % 8) computes s and
//      dO.v for keys ty + 16 a and rows tx + 8 c in registers (fmaf over D
//      from 16-byte shared loads, K/V and Q/dO rows XOR-swizzled by 16-byte
//      chunk), then P and dS into shared memory (query-major, rows padded
//      by 4 floats so neither the writes nor the reads meet a bank twice);
//      then the same thread accumulates dV and dK for keys BKV/16 ty ..
//      and columns 4 (tx + 8 m) .. + 3 in registers over the step's rows.
//      BKV = 64 up to D 64, 32 at D 128, 16 at D 256 (64 accumulators a
//      thread).
//   3. dq_kernel: the forward's layout, a block per (b, h, 64 query rows),
//      walking the live kv tiles: s and dO.v in registers (rows 4 ty ..,
//      keys tx + 8 c), dS through shared memory key-major, dQ in
//      registers as the forward accumulates o.
// expf and tanhf, not the fast intrinsics, as in the forward. Single
// buffered (a load round is exposed per step): the simple first design.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_fp32.cuh"

namespace {

using attn::copy_commit;
using attn::copy_wait;
using attn::kThreads;
using attn::live_key;
using attn::load_rows;

// (batch, head, sequence) strides in elements of each tensor
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

// Delta at (b * H + h) * S + i: a warp per row
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const float* __restrict__ o, const float* __restrict__ g,
                 float* __restrict__ delta, int H, int S, int dim,
                 long long rows, Strides st) {
  const long long row =
      (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long i = row % S, bh = row / S;
  const long long h = bh % H, b = bh / H;
  const float* op = o + b * st.o[0] + h * st.o[1] + i * st.o[2];
  const float* gp = g + b * st.g[0] + h * st.g[1] + i * st.g[2];
  float sum = 0.f;
  for (int c = lane; c < dim; c += 32) sum = fmaf(op[c], gp[c], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

// x -> (s, ds/dx factor) under the soft cap
__device__ __forceinline__ float capped(float x, float cap, float* dcap) {
  if (cap == 0.f) {
    *dcap = 1.f;
    return x;
  }
  const float t = tanhf(x / cap);
  *dcap = 1.f - t * t;
  return cap * t;
}

template <int DP>
struct KvTile {
  static constexpr int BKV = DP <= 64 ? 64 : 4096 / DP;  // keys per block
  static constexpr int BQ = 32;                           // rows per step
  static constexpr int KA = BKV / 16;   // keys per thread (both phases)
  static constexpr int QC = BQ / 8;     // rows per thread (phase 1)
  static constexpr int DC = DP / 32;    // 16-byte column chunks per thread
  static constexpr int LDP = BKV + 4;   // row stride of P and dS
  static constexpr size_t kSmemFloats = 2 * size_t(BKV) * DP +
                                        2 * size_t(BQ) * DP +
                                        2 * size_t(BQ) * LDP + 2 * BQ + DP;
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int H, int S, int Tn, int dim,
                int group, Strides st, float scale, float cap, int causal,
                int window, int vec) {
  using Tl = KvTile<DP>;
  constexpr int BKV = Tl::BKV, BQ = Tl::BQ, KA = Tl::KA, QC = Tl::QC,
                DC = Tl::DC, LDP = Tl::LDP;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BKV][DP], swizzled
  float* Vs = Ks + BKV * DP;                    // [BKV][DP], swizzled
  float* Qs = Vs + BKV * DP;                    // [BQ][DP], swizzled
  float* Gs = Qs + BQ * DP;                     // [BQ][DP]: dO, swizzled
  float* Ps = Gs + BQ * DP;                     // [BQ][LDP]: P
  float* Ds = Ps + BQ * LDP;                    // [BQ][LDP]: dS
  float* Ls = Ds + BQ * LDP;                    // [BQ]: lse
  float* Es = Ls + BQ;                          // [BQ]: Delta
  float* Dead = Es + BQ;                        // [DP]: dead rows' dO / T

  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const int j0 = blockIdx.x * BKV, kvh = blockIdx.y, b = blockIdx.z;
  const float* kp = k + b * st.k[0] + kvh * st.k[1];
  const float* vp = v + b * st.v[0] + kvh * st.v[1];
  load_rows<DP>(Ks, kp, st.k[2], j0, BKV, Tn, dim, 0, vec);
  load_rows<DP>(Vs, vp, st.v[2], j0, BKV, Tn, dim, 0, vec);
  copy_commit();

  // rows live for some key of this block: [i_lo, i_hi); rows from
  // dead_from on have no live key at all
  const int j_last = min(j0 + BKV, Tn) - 1;
  const int i_lo = causal ? j0 : 0;
  const int i_hi = window > 0 ? min(S, j_last + window) : S;
  const int t_lo = i_lo / BQ;
  const int n_steps = i_hi > i_lo ? (i_hi + BQ - 1) / BQ - t_lo : 0;
  const long long dead_from = window > 0 ? (long long)Tn + window - 1 : S;

  float dka[KA][4 * DC], dva[KA][4 * DC];
#pragma unroll
  for (int a = 0; a < KA; ++a)
#pragma unroll
    for (int j = 0; j < 4 * DC; ++j) dka[a][j] = dva[a][j] = 0.f;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const float* qp = q + b * st.q[0] + h * st.q[1];
    const float* gp = g + b * st.g[0] + h * st.g[1];
    const float* lp = lse + ((long long)b * H + h) * S;
    const float* ep = delta + ((long long)b * H + h) * S;
    for (int it = 0; it < n_steps; ++it) {
      const int i0 = (t_lo + it) * BQ;
      __syncthreads();  // the last step's tiles are read
      load_rows<DP>(Qs, qp, st.q[2], i0, BQ, S, dim, 0, vec);
      load_rows<DP>(Gs, gp, st.g[2], i0, BQ, S, dim, 0, vec);
      copy_commit();
      if (tid < BQ) {
        const int i = i0 + tid;
        Ls[tid] = i < S ? lp[i] : 0.f;
        Es[tid] = i < S ? ep[i] : 0.f;
      }
      copy_wait<0>();
      __syncthreads();  // K, V (the first time), Q, dO, lse, Delta landed

      // phase 1: keys ty + 16 a (K/V chunk d at d ^ (ty % 8)), rows
      // tx + 8 c (Q/dO chunk d at d ^ tx)
      float s[KA][QC], dp[KA][QC];
#pragma unroll
      for (int a = 0; a < KA; ++a)
#pragma unroll
        for (int c = 0; c < QC; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DP / 4; ++d) {
        float4 kv[KA], vv[KA], qv[QC], gv[QC];
#pragma unroll
        for (int a = 0; a < KA; ++a) {
          const int off = (ty + 16 * a) * DP + 4 * (d ^ (ty & 7));
          kv[a] = *reinterpret_cast<const float4*>(Ks + off);
          vv[a] = *reinterpret_cast<const float4*>(Vs + off);
        }
#pragma unroll
        for (int c = 0; c < QC; ++c) {
          const int off = (tx + 8 * c) * DP + 4 * (d ^ tx);
          qv[c] = *reinterpret_cast<const float4*>(Qs + off);
          gv[c] = *reinterpret_cast<const float4*>(Gs + off);
        }
#pragma unroll
        for (int a = 0; a < KA; ++a)
#pragma unroll
          for (int c = 0; c < QC; ++c) {
            s[a][c] = fmaf(kv[a].x, qv[c].x, s[a][c]);
            s[a][c] = fmaf(kv[a].y, qv[c].y, s[a][c]);
            s[a][c] = fmaf(kv[a].z, qv[c].z, s[a][c]);
            s[a][c] = fmaf(kv[a].w, qv[c].w, s[a][c]);
            dp[a][c] = fmaf(vv[a].x, gv[c].x, dp[a][c]);
            dp[a][c] = fmaf(vv[a].y, gv[c].y, dp[a][c]);
            dp[a][c] = fmaf(vv[a].z, gv[c].z, dp[a][c]);
            dp[a][c] = fmaf(vv[a].w, gv[c].w, dp[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < KA; ++a)
#pragma unroll
        for (int c = 0; c < QC; ++c) {
          const int r = tx + 8 * c, i = i0 + r, j = j0 + ty + 16 * a;
          float dcap;
          const float x = capped(s[a][c] * scale, cap, &dcap);
          const bool live = i < S && live_key(i, j, Tn, causal, window);
          const float p = live ? expf(x - Ls[r]) : 0.f;
          Ps[r * LDP + ty + 16 * a] = p;
          Ds[r * LDP + ty + 16 * a] =
              live ? p * (dp[a][c] - Es[r]) * dcap : 0.f;
        }
      __syncthreads();  // P and dS complete

      // phase 2: keys KA ty + a, columns 4 (tx + 8 m) .. + 3; Q/dO row r
      // keeps chunk tx + 8 m at (tx + 8 m) ^ (r % 8)
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pr[KA], dr[KA];
#pragma unroll
        for (int a = 0; a < KA; ++a) {
          pr[a] = Ps[r * LDP + KA * ty + a];
          dr[a] = Ds[r * LDP + KA * ty + a];
        }
#pragma unroll
        for (int m = 0; m < DC; ++m) {
          const int off = r * DP + 4 * ((tx + 8 * m) ^ (r & 7));
          const float4 gv = *reinterpret_cast<const float4*>(Gs + off);
          const float4 qv = *reinterpret_cast<const float4*>(Qs + off);
#pragma unroll
          for (int a = 0; a < KA; ++a) {
            dva[a][4 * m] = fmaf(pr[a], gv.x, dva[a][4 * m]);
            dva[a][4 * m + 1] = fmaf(pr[a], gv.y, dva[a][4 * m + 1]);
            dva[a][4 * m + 2] = fmaf(pr[a], gv.z, dva[a][4 * m + 2]);
            dva[a][4 * m + 3] = fmaf(pr[a], gv.w, dva[a][4 * m + 3]);
            dka[a][4 * m] = fmaf(dr[a], qv.x, dka[a][4 * m]);
            dka[a][4 * m + 1] = fmaf(dr[a], qv.y, dka[a][4 * m + 1]);
            dka[a][4 * m + 2] = fmaf(dr[a], qv.z, dka[a][4 * m + 2]);
            dka[a][4 * m + 3] = fmaf(dr[a], qv.w, dka[a][4 * m + 3]);
          }
        }
      }
    }
    // rows with no live key: dO / T to every key
    if (dead_from < S) {
      __syncthreads();  // the last head's Dead is read
      for (int c = tid; c < DP; c += kThreads) {
        float sum = 0.f;
        if (c < dim)
          for (long long i = dead_from; i < S; ++i) sum += gp[i * st.g[2] + c];
        Dead[c] = sum / (float)Tn;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < DC; ++m) {
        const float4 dd =
            *reinterpret_cast<const float4*>(Dead + 4 * (tx + 8 * m));
#pragma unroll
        for (int a = 0; a < KA; ++a) {
          dva[a][4 * m] += dd.x;
          dva[a][4 * m + 1] += dd.y;
          dva[a][4 * m + 2] += dd.z;
          dva[a][4 * m + 3] += dd.w;
        }
      }
    }
  }
  copy_wait<0>();  // a block with no step still owns its K/V copies

#pragma unroll
  for (int a = 0; a < KA; ++a) {
    const int j = j0 + KA * ty + a;
    if (j >= Tn) continue;
    float* kd = dk + b * st.dk[0] + kvh * st.dk[1] + j * st.dk[2];
    float* vd = dv + b * st.dv[0] + kvh * st.dv[1] + j * st.dv[2];
#pragma unroll
    for (int m = 0; m < DC; ++m) {
      const int c = 4 * (tx + 8 * m);
      if (c >= dim) continue;
      const float kw[4] = {dka[a][4 * m] * scale, dka[a][4 * m + 1] * scale,
                           dka[a][4 * m + 2] * scale,
                           dka[a][4 * m + 3] * scale};
      const float vw[4] = {dva[a][4 * m], dva[a][4 * m + 1],
                           dva[a][4 * m + 2], dva[a][4 * m + 3]};
      if (vec) {
        *reinterpret_cast<float4*>(kd + c) =
            make_float4(kw[0], kw[1], kw[2], kw[3]);
        *reinterpret_cast<float4*>(vd + c) =
            make_float4(vw[0], vw[1], vw[2], vw[3]);
      } else {
        for (int u = 0; u < 4 && c + u < dim; ++u) {
          kd[c + u] = kw[u];
          vd[c + u] = vw[u];
        }
      }
    }
  }
}

constexpr int kBQ = 64;     // dq_kernel: query rows per block
constexpr int kRows = 4;    // query rows per thread
constexpr int kGroup = 8;   // threads per row group

template <int D>
struct QTile {
  static constexpr int BK = D <= 128 ? 32 : 16;   // keys per kv tile
  static constexpr int kKeys = BK / kGroup;       // score columns per thread
  static constexpr int kDimChunks = D / 32;       // dQ chunks per thread
  static constexpr size_t kSmemFloats = 2 * size_t(kBQ) * D +
                                        2 * size_t(BK) * D +
                                        size_t(BK) * kBQ + 2 * kBQ;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int S, int Tn, int dim, int group,
              Strides st, float scale, float cap, int causal, int window,
              int vec) {
  using Tl = QTile<D>;
  constexpr int BK = Tl::BK, KK = Tl::kKeys, DC = Tl::kDimChunks;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][D], swizzled
  float* Gs = Qs + kBQ * D;                     // [kBQ][D]: dO, swizzled
  float* Ks = Gs + kBQ * D;                     // [BK][D], swizzled
  float* Vs = Ks + BK * D;                      // [BK][D], swizzled
  float* Ps = Vs + BK * D;                      // [BK][kBQ]: dS, key-major
  float* Ls = Ps + BK * kBQ;                    // [kBQ]: lse
  float* Es = Ls + kBQ;                         // [kBQ]: Delta

  const int tid = threadIdx.x, tx = tid % kGroup, ty = tid / kGroup;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const float* qp = q + b * st.q[0] + h * st.q[1];
  const float* gp = g + b * st.g[0] + h * st.g[1];
  const float* kp = k + b * st.k[0] + kvh * st.k[1];
  const float* vp = v + b * st.v[0] + kvh * st.v[1];
  const long long bh = (long long)b * gridDim.y + h;

  // keys live for some row of this block: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Tn, q_last + 1) : Tn;
  const int n_lo = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - n_lo : 0;

  if (n_tiles > 0) {
    load_rows<D>(Qs, qp, st.q[2], q0, kBQ, S, dim, 2, vec);
    load_rows<D>(Gs, gp, st.g[2], q0, kBQ, S, dim, 2, vec);
    copy_commit();
    if (tid < kBQ) {
      const int i = q0 + tid;
      Ls[tid] = i < S ? lse[bh * S + i] : 0.f;
      Es[tid] = i < S ? delta[bh * S + i] : 0.f;
    }
  }

  float acc[kRows][4 * DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4 * DC; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (n_lo + it) * BK;
    if (it > 0) __syncthreads();  // the last tile's K, V and dS are read
    load_rows<D>(Ks, kp, st.k[2], k0, BK, Tn, dim, 0, vec);
    load_rows<D>(Vs, vp, st.v[2], k0, BK, Tn, dim, 0, vec);
    copy_commit();
    copy_wait<0>();
    __syncthreads();  // the tile (and Q, dO, lse, Delta) landed

    // s and dO.v: rows 4 ty + i (chunk d at d ^ (ty % 8)), keys tx + 8 c
    // (chunk d at d ^ tx)
    float s[kRows][KK], dp[kRows][KK];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < KK; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D / 4; ++d) {
      float4 qv[kRows], kv[KK];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * D +
                                                 4 * (d ^ (ty & 7)));
#pragma unroll
      for (int c = 0; c < KK; ++c)
        kv[c] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * c) * D +
                                                 4 * (d ^ tx));
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < KK; ++c) {
          s[i][c] = fmaf(qv[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv[c].w, s[i][c]);
        }
    }
#pragma unroll 4
    for (int d = 0; d < D / 4; ++d) {
      float4 gv[kRows], vv[KK];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        gv[i] = *reinterpret_cast<const float4*>(Gs + (4 * ty + i) * D +
                                                 4 * (d ^ (ty & 7)));
#pragma unroll
      for (int c = 0; c < KK; ++c)
        vv[c] = *reinterpret_cast<const float4*>(Vs + (tx + 8 * c) * D +
                                                 4 * (d ^ tx));
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < KK; ++c) {
          dp[i][c] = fmaf(gv[i].x, vv[c].x, dp[i][c]);
          dp[i][c] = fmaf(gv[i].y, vv[c].y, dp[i][c]);
          dp[i][c] = fmaf(gv[i].z, vv[c].z, dp[i][c]);
          dp[i][c] = fmaf(gv[i].w, vv[c].w, dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = 4 * ty + i, row = q0 + r;
#pragma unroll
      for (int c = 0; c < KK; ++c) {
        float dcap;
        const float x = capped(s[i][c] * scale, cap, &dcap);
        const bool live =
            row < S && live_key(row, k0 + tx + 8 * c, Tn, causal, window);
        s[i][c] = live ? expf(x - Ls[r]) * (dp[i][c] - Es[r]) * dcap : 0.f;
      }
    }
    // dS, key-major: key tx + 8 c keeps its rows' chunk ty at ty ^ tx
#pragma unroll
    for (int c = 0; c < KK; ++c)
      *reinterpret_cast<float4*>(Ps + (tx + 8 * c) * kBQ + 4 * (ty ^ tx)) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();  // dS is complete

    // dq += dS k: key c's dS for rows 4 ty.. at chunk ty ^ (c % 8); K row c
    // keeps chunk tx + 8 j at (tx + 8 j) ^ (c % 8)
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(
          Ps + c * kBQ + 4 * (ty ^ (c & 7)));
      const float pr[kRows] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(
            Ks + c * D + 4 * ((tx + 8 * j) ^ (c & 7)));
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][4 * j] = fmaf(pr[i], kv.x, acc[i][4 * j]);
          acc[i][4 * j + 1] = fmaf(pr[i], kv.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(pr[i], kv.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(pr[i], kv.w, acc[i][4 * j + 3]);
        }
      }
    }
  }

  float* dqp = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= S) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = 4 * (tx + 8 * j);
      if (c >= dim) continue;
      const float w[4] = {acc[i][4 * j] * scale, acc[i][4 * j + 1] * scale,
                          acc[i][4 * j + 2] * scale,
                          acc[i][4 * j + 3] * scale};
      float* dst = dqp + qi * st.dq[2] + c;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(w[0], w[1], w[2], w[3]);
      } else {
        for (int u = 0; u < 4 && c + u < dim; ++u) dst[u] = w[u];
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* o, const float* lse, const float* g,
                   float* dq, float* dk, float* dv, float* delta, int B,
                   int H, int KV, int S, int Tn, int dim, const Strides& st,
                   float scale, float cap, int causal, int window,
                   cudaStream_t stream) {
  const void* ptrs[8] = {q, k, v, o, g, dq, dk, dv};
  const long long* strides[8] = {st.q, st.k, st.v, st.o,
                                 st.g, st.dq, st.dk, st.dv};
  int vec = 1;
  for (const long long* x : strides)
    vec = vec && attn::aligned16(ptrs, 8, x, 3, dim);
  const long long rows = (long long)B * H * S;
  delta_kernel<<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                 stream>>>(o, g, delta, H, S, dim, rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = sizeof(float) * KvTile<DP>::kSmemFloats;
  err = allow_smem(dkdv_kernel<DP>, smem_kv);
  if (err != cudaSuccess) return err;
  constexpr int BKV = KvTile<DP>::BKV;
  dkdv_kernel<DP><<<dim3((Tn + BKV - 1) / BKV, KV, B), kThreads, smem_kv,
                    stream>>>(q, k, v, g, lse, delta, dk, dv, H, S, Tn, dim,
                              H / KV, st, scale, cap, causal, window, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_q = sizeof(float) * QTile<DP>::kSmemFloats;
  err = allow_smem(dq_kernel<DP>, smem_q);
  if (err != cudaSuccess) return err;
  dq_kernel<DP><<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, smem_q,
                  stream>>>(q, k, v, g, lse, delta, dq, S, Tn, dim, H / KV,
                            st, scale, cap, causal, window, vec);
  return cudaGetLastError();
}

}  // namespace

// fp32 q (B,H,S,D), k and v (B,KV,T,D), o and dO like q, lse (B,H,S)
// contiguous; dq, dk and dv written whole; delta a (B,H,S) scratch. D in
// [1, 256].
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* g, void* dq, void* dk, void* dv,
    void* delta, int B, int H, int KV, int S, int Tn, int D, long long qb,
    long long qh, long long qs, long long kb, long long kh, long long ks,
    long long vb, long long vh, long long vs, long long ob, long long oh,
    long long os, long long gb, long long gh, long long gs, long long dqb,
    long long dqh, long long dqs, long long dkb, long long dkh,
    long long dks, long long dvb, long long dvh, long long dvs, float scale,
    float cap, int causal, int window, void* stream) {
  const Strides st{{qb, qh, qs},    {kb, kh, ks},    {vb, vh, vs},
                   {ob, oh, os},    {gb, gh, gs},    {dqb, dqh, dqs},
                   {dkb, dkh, dks}, {dvb, dvh, dvs}};
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* of = static_cast<const float*>(o);
  const auto* lf = static_cast<const float*>(lse);
  const auto* gf = static_cast<const float*>(g);
  auto* dqf = static_cast<float*>(dq);
  auto* dkf = static_cast<float*>(dk);
  auto* dvf = static_cast<float*>(dv);
  auto* ef = static_cast<float*>(delta);
  const auto s = static_cast<cudaStream_t>(stream);
#define BWD_CASE(DIM)                                                      \
  case DIM:                                                                \
    return static_cast<int>(launch<DIM>(qf, kf, vf, of, lf, gf, dqf, dkf,  \
                                        dvf, ef, B, H, KV, S, Tn, D, st,   \
                                        scale, cap, causal, window, s));
  switch (attn::built_dim(D)) {
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
    BWD_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BWD_CASE
}
