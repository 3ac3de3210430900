// flash_attention_bwd: the gradient of the attention of flash_attention.cu
// (GQA, causal and sliding-window masks, the logit soft cap, any S and T,
// head dims 1-256), FlashAttention-2's backward, for fp32 and bf16 inputs.
//
// Replaces no Pallas kernel: it is the gradient of _attn_kernel (:23) of
// src/repro/kernels/flash_attention.py, which the reference takes by XLA's
// autodiff of its einsum attention (src/repro/models/attention.py,
// _attend). The encoder trains through it in fp32; bf16 takes it only at
// head dim 32 (no model of the repo has it), or where a configuration here
// is forced: at head dims 64, 128 and 256 bf16 runs
// flash_attention_bwd_sm90.cu, on the tensor cores
// (kernels/flash_attention.py::bwd_plan picks by dtype and head dim).
//
// bf16 runs the same kernels, instantiated for bf16 q, k, v, o and dO: each
// load widens to fp32 as it is staged into shared memory (plain loads,
// since cp.async copies bytes and cannot convert), so every product, sum,
// Delta and partial is the fp32 kernel's; dq, dk and dv are rounded to
// bf16 at their store, because autograd wants the input's type. The lse
// it reads is fp32 in natural units (the bf16 forward writes it so). The
// tensor cores stay idle here.
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
// (five products: s, dO.v, dV, dK, dQ) at 67 TFLOP/s on the CUDA cores in
// fp32 (no tensor cores on fp32 inputs, by the port's numerics rule), or
// the bytes of q, k, v, o, dO, lse, dq, dk and dv for short rows.
//
// Two plans (kernels/flash_attention.py::bwd_plan picks one and owns its
// dK/dV geometry):
//   0 Small, one launch (bwd_kv_kernel<.., FUSED>): for T up to 64 keys
//     (32 at D 256). A block owns every key of a (batch, kv head), K and V
//     resident in shared memory, and walks its group's heads and their
//     query tiles in order. Per step it computes Delta from o and dO, s and
//     dO.v in registers, P and dS once into shared memory, then dV += P^T
//     dO and dK += dS^T Q in registers and dQ = dS K, written whole: five
//     products, no global scratch. A dead row takes P = 1/T, dS = 0.
//   1 Large, for long rows: delta_kernel (a warp per row); the dK/dV walk
//     of each key tile (64 keys, 32 at D 256) cut into parts, one block a
//     part, the longest walks first; a key tile cut into several parts
//     writes raw partials that bwd_reduce_kernel sums in part order (no
//     atomics); bwd_q_kernel, a block per (64 query rows, head) with the
//     causal row tiles longest first, K and V tiles of 64 keys (16 at D
//     256) double-buffered by cp.async, recomputes s and dO.v and
//     accumulates dQ.
// The plan's part table (bwd_parts, one row of kPartInts ints a dK/dV
// block) names each block's key tile, its walk's row tiles, its steps and
// its key tile's parts; the kernels read it and derive none of it.
// Every block runs 8 warps; each product is a register tile over a warp
// grid whose lanes are 8 (rows) x 4 (columns), the squarest that divides
// it, so a 16-byte shared load is a broadcast of at most 8 distinct rows.
// Every warp computes s, P, dO.v and dS for its tile of the step; warps
// 0-3 then accumulate dV += P^T dO and warps 4-7 dK += dS^T Q (an 8 x 8
// tile each at D 128), and dQ takes all 8. K/V and Q/dO rows are
// XOR-swizzled by 16-byte chunk, P and dS rows padded by 4 floats, so no
// load meets a bank twice. Knock-out builds (tools/bwd_variants.py patches
// this file) chose this: the warpgroups splitting s and dO.v too was
// slower everywhere, dQ row tiles in natural order slower on long causal
// rows; double-buffering Q and dO in Large's dK/dV walk lost more on short
// rows than it gained on long ones; unrolling D by 2, not 4, moved
// nothing.
// expf and tanhf, not the fast intrinsics, as in the forward. A plan fixes
// every summation order, so results repeat bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_fp32.cuh"

namespace {

using attn::copy_commit;
using attn::copy_wait;
using attn::live_key;
using attn::load_rows;

constexpr int kWarps = 8;              // every block
constexpr int kBlock = 32 * kWarps;
constexpr size_t kSmemBlock = 232448;   // shared memory a block may use
constexpr size_t kSmemSm = 233472;      // an SM's, 1 KB reserved a block

// a row of the part table (bwd_plan's bwd_parts): the key tile, the first
// row tile and the row tiles its walk visits per head, the part's steps
// [first, end) of that walk (step n: head n / rows of the kv head's group,
// row tile first + n % rows), and the key tile's first part and parts
enum PartField {
  kTile, kRowTile, kRowTiles, kStepLo, kStepHi, kFirstPart, kParts,
  kPartInts = 8
};

// (batch, head, sequence) strides in elements of each tensor
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

// E: the element type of q, k, v, o, dO, dq, dk and dv (float or bf16);
// lse, Delta and the partials are fp32 whatever E is
template <typename E>
struct Args {
  const E *q, *k, *v, *o, *g;
  const float* lse;
  const int* parts;    // the part table, [n_parts][kPartInts]
  float* delta;
  E *dq, *dk, *dv;
  float* part;
  int B, H, KV, S, Tn, dim, group, causal, window, vec;
  int n_parts;         // dK/dV blocks per (batch, kv head)
  float scale, cap;
  Strides st;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [row0, row0 + n) of a (rows, dim) tensor into shared memory as
// fp32, laid out as attn::load_rows lays them (row r's 16-byte chunk c at
// chunk c ^ (r % 8)), zeros past `limit` rows and `dim` columns. fp32 goes
// by cp.async; bf16 is widened as it is staged, by plain loads (cp.async
// copies bytes and cannot convert them), 8 bytes a chunk where `vec`
template <int DP, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long stride, int row0, int n,
                                           int limit, int dim, bool vec) {
  load_rows<DP, NT>(dst, src, stride, row0, n, limit, dim, 0, vec);
}

template <int DP, int NT>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const __nv_bfloat16* src,
                                           long long stride, int row0, int n,
                                           int limit, int dim, bool vec) {
  constexpr int C = DP / 4;
  for (int e = threadIdx.x; e < n * C; e += NT) {
    const int r = e / C, c = e % C, i = row0 + r;
    const int cols = i < limit ? max(0, min(4, dim - 4 * c)) : 0;
    float w[4] = {0.f, 0.f, 0.f, 0.f};
    if (cols > 0) {
      const __nv_bfloat16* p = src + i * stride + 4 * c;
      if (vec) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const float2 lo =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        w[0] = lo.x, w[1] = lo.y, w[2] = hi.x, w[3] = hi.y;
      } else {
        for (int u = 0; u < cols; ++u) w[u] = __bfloat162float(p[u]);
      }
    }
    *reinterpret_cast<float4*>(dst + r * DP + 4 * (c ^ (r & 7))) =
        make_float4(w[0], w[1], w[2], w[3]);
  }
}

// Delta at (b * H + h) * S + i: a warp per row (Large)
template <typename E>
__global__ void __launch_bounds__(kBlock) delta_kernel(const Args<E> a) {
  const long long rows = (long long)a.B * a.H * a.S;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long i = row % a.S, bh = row / a.S;
  const long long h = bh % a.H, b = bh / a.H;
  const E* op = a.o + b * a.st.o[0] + h * a.st.o[1] + i * a.st.o[2];
  const E* gp = a.g + b * a.st.g[0] + h * a.st.g[1] + i * a.st.g[2];
  float sum = 0.f;
  for (int c = lane; c < a.dim; c += 32)
    sum = fmaf(to_f32(op[c]), to_f32(gp[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) a.delta[row] = sum;
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

// The register tile of a product with an M x N output (N in columns, U = 1,
// or in 4-float chunks, U = 4) over NW warps: warps WM x WN, a warp's lanes
// 8 (m) x 4 (n), a thread TM x TN (TM <= 8). The warp grid is the one that
// loads the fewest bytes per fma (the squarest warp tile). A thread's m are
// m0() + 8 u (rows: 8 lanes meet 8 rows), or key(u) where its m are keys
// read as float4 from a row of P or dS (lanes on neighbouring 16 bytes);
// its n are n0() + 4 v.
constexpr int warp_tile_score(int tm, int tn, int u) {
  return 1000 * (8 * tm) * (4 * tn * u) / (8 * tm + 4 * tn * u);
}

constexpr int pick_wm(int M, int N, int U, int NW) {
  int best = 0, score = -1;
  for (int wm = 1; wm <= NW; wm *= 2) {
    const int wn = NW / wm;
    if (M % (8 * wm) || N % (4 * wn) || M / (8 * wm) > 8) continue;
    const int s = warp_tile_score(M / (8 * wm), N / (4 * wn), U);
    if (s > score) {
      score = s;
      best = wm;
    }
  }
  return best;
}

template <int M, int N, int U, int NW>
struct Tile {
  static constexpr int WM = pick_wm(M, N, U, NW);
  static_assert(WM > 0, "no warp grid divides the tile");
  static constexpr int WN = NW / WM;
  static constexpr int TM = M / (8 * WM), TN = N / (4 * WN);
  __device__ __forceinline__ static int lane() { return threadIdx.x % 32; }
  __device__ __forceinline__ static int warp() {
    return (threadIdx.x / 32) % NW;
  }
  __device__ __forceinline__ static int m0() {
    return (warp() / WN) * 8 * TM + lane() % 8;
  }
  // contiguous m: float4 groups 32 apart (TM >= 4), else TM in a row
  __device__ __forceinline__ static int key(int u) {
    const int base = (warp() / WN) * 8 * TM, lm = lane() % 8;
    return TM >= 4 ? base + (u / 4) * 32 + 4 * lm + u % 4 : base + lm * TM + u;
  }
  __device__ __forceinline__ static int n0() {
    return (warp() % WN) * 4 * TN + lane() / 8;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a thread's TM contiguous-tile values of one shared-memory row (Tile::key)
template <int TM>
__device__ __forceinline__ void ld_keys(float* dst, const float* row,
                                        int first) {
  if constexpr (TM >= 4) {
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
      const float4 x = ld4(row + first + 32 * g);
      dst[4 * g] = x.x, dst[4 * g + 1] = x.y, dst[4 * g + 2] = x.z,
      dst[4 * g + 3] = x.w;
    }
  } else if constexpr (TM == 2) {
    const float2 x = *reinterpret_cast<const float2*>(row + first);
    dst[0] = x.x, dst[1] = x.y;
  } else {
    dst[0] = row[first];
  }
}

// rows [row0, row0 + n) of a length-`limit` vector into shared memory by
// 4-byte copies, zeros past the end
template <int NT>
__device__ __forceinline__ void load_col(float* dst, const float* src,
                                         int row0, int n, int limit) {
  for (int r = threadIdx.x; r < n; r += NT) {
    const int i = row0 + r;
    const uint32_t d = sm90::smem_u32(dst + r);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(i < limit ? src + i : src), "r"(i < limit ? 4 : 0)
                 : "memory");
  }
}

// the s (or dO.v) product of rows [i0, i0 + BQ) x keys [j0, j0 + KP):
// X rows (Q or dO) against Y rows (K or V), row r keeping 16-byte chunk d
// at d ^ (r % 8) (the rows r0 + 8 u share it)
template <typename T, int DP>
__device__ __forceinline__ void dots(const float* X, const float* Y,
                                     float (&s)[T::TM][T::TN]) {
  const int r0 = T::m0(), c0 = T::n0();
#pragma unroll
  for (int u = 0; u < T::TM; ++u)
#pragma unroll
    for (int v = 0; v < T::TN; ++v) s[u][v] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP / 4; ++d) {
    float4 xv[T::TM], yv[T::TN];
#pragma unroll
    for (int u = 0; u < T::TM; ++u)
      xv[u] = ld4(X + (r0 + 8 * u) * DP + 4 * (d ^ (r0 & 7)));
#pragma unroll
    for (int v = 0; v < T::TN; ++v) {
      const int c = c0 + 4 * v;
      yv[v] = ld4(Y + c * DP + 4 * (d ^ (c & 7)));
    }
#pragma unroll
    for (int u = 0; u < T::TM; ++u)
#pragma unroll
      for (int v = 0; v < T::TN; ++v) {
        s[u][v] = fmaf(xv[u].x, yv[v].x, s[u][v]);
        s[u][v] = fmaf(xv[u].y, yv[v].y, s[u][v]);
        s[u][v] = fmaf(xv[u].z, yv[v].z, s[u][v]);
        s[u][v] = fmaf(xv[u].w, yv[v].w, s[u][v]);
      }
  }
}

// s of the tile's (r0 + 8 u, c0 + 4 v) -> P (into Ps if WANT_P) and P dcap
// (into Ds); DEAD_P: a row with no live key takes P = 1/T on every key
// (the block holds them all)
template <typename T, int KP, bool WANT_P, bool DEAD_P, typename A>
__device__ __forceinline__ void probs(const float (&s)[T::TM][T::TN],
                                      const float* Ls, float* Ps, float* Ds,
                                      int i0, int j0, const A& a) {
  constexpr int LDP = KP + 4;
  const int r0 = T::m0(), c0 = T::n0();
  const long long dead_from =
      a.window > 0 ? (long long)a.Tn + a.window - 1 : a.S;
#pragma unroll
  for (int u = 0; u < T::TM; ++u) {
    const int r = r0 + 8 * u, i = i0 + r;
#pragma unroll
    for (int v = 0; v < T::TN; ++v) {
      const int c = c0 + 4 * v, j = j0 + c;
      float dcap;
      const float x = capped(s[u][v] * a.scale, a.cap, &dcap);
      const bool live = i < a.S && live_key(i, j, a.Tn, a.causal, a.window);
      float p = live ? expf(x - Ls[r]) : 0.f;
      Ds[r * LDP + c] = p * dcap;
      if (DEAD_P && i < a.S && i >= dead_from && j < a.Tn)
        p = 1.f / (float)a.Tn;
      if (WANT_P) Ps[r * LDP + c] = p;
    }
  }
}

// dS = P dcap (dp - Delta) in place, for the tile's (r0 + 8 u, c0 + 4 v)
template <typename T, int KP>
__device__ __forceinline__ void dscores(const float (&dp)[T::TM][T::TN],
                                        const float* Es, float* Ds) {
  constexpr int LDP = KP + 4;
  const int r0 = T::m0(), c0 = T::n0();
#pragma unroll
  for (int u = 0; u < T::TM; ++u) {
    const int r = r0 + 8 * u;
#pragma unroll
    for (int v = 0; v < T::TN; ++v) {
      float* ds = Ds + r * LDP + c0 + 4 * v;
      *ds = *ds * (dp[u][v] - Es[r]);
    }
  }
}

// rows [i0, i0 + BQ) x keys [j0, j0 + KP): P (if WANT_P) and dS into
// shared memory, row-major at a row stride of KP + 4, every warp both for
// its tile. Ends with the block synchronised.
template <int DP, int KP, int BQ, bool WANT_P, bool DEAD_P, typename A>
__device__ __forceinline__ void scores(const float* Qs, const float* Gs,
                                       const float* Ks, const float* Vs,
                                       const float* Ls, const float* Es,
                                       float* Ps, float* Ds, int i0, int j0,
                                       const A& a) {
  using T = Tile<BQ, KP, 1, kWarps>;
  float s[T::TM][T::TN];
  dots<T, DP>(Qs, Ks, s);
  probs<T, KP, WANT_P, DEAD_P>(s, Ls, Ps, Ds, i0, j0, a);
  dots<T, DP>(Gs, Vs, s);
  dscores<T, KP>(s, Es, Ds);  // the thread's own P dcap
  __syncthreads();            // P and dS complete
}

// the step's dK/dV over its BQ rows: warps 0-3 dV += P^T dO, warps 4-7
// dK += dS^T Q, each half over the same tile of KP keys x DP columns; a
// thread holds keys key(u) and 16-byte chunks n0 + 4 v
template <int DP, int KP>
using KvTile = Tile<KP, DP / 4, 4, kWarps / 2>;

__device__ __forceinline__ bool holds_dk() {
  return threadIdx.x >= kBlock / 2;
}

template <int DP, int KP, int BQ>
__device__ __forceinline__ void accumulate_kv(
    const float* Qs, const float* Gs, const float* Ps, const float* Ds,
    float (&acc)[KvTile<DP, KP>::TM][4 * KvTile<DP, KP>::TN]) {
  using T = KvTile<DP, KP>;
  constexpr int TM = T::TM, TN = T::TN, LDP = KP + 4;
  const int k0 = T::key(0), c0 = T::n0();
  const bool dk = holds_dk();
  const float* X = dk ? Ds : Ps;
  const float* Y = dk ? Qs : Gs;
#pragma unroll 2
  for (int r = 0; r < BQ; ++r) {
    float xr[TM];
    ld_keys<TM>(xr, X + r * LDP, k0);
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const float4 y = ld4(Y + r * DP + 4 * ((c0 + 4 * v) ^ (r & 7)));
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        acc[u][4 * v] = fmaf(xr[u], y.x, acc[u][4 * v]);
        acc[u][4 * v + 1] = fmaf(xr[u], y.y, acc[u][4 * v + 1]);
        acc[u][4 * v + 2] = fmaf(xr[u], y.z, acc[u][4 * v + 2]);
        acc[u][4 * v + 3] = fmaf(xr[u], y.w, acc[u][4 * v + 3]);
      }
    }
  }
}

// acc += dS K over the tile's KP keys, all 8 warps, for rows m0 + 8 u and
// 16-byte chunks n0 + 4 v of dQ
template <int DP, int BQ>
using QTile = Tile<BQ, DP / 4, 4, kWarps>;

template <int DP, int KP, int BQ>
__device__ __forceinline__ void accumulate_q(
    const float* Ds, const float* Ks,
    float (&acc)[QTile<DP, BQ>::TM][4 * QTile<DP, BQ>::TN]) {
  using T = QTile<DP, BQ>;
  constexpr int TM = T::TM, TN = T::TN, LDP = KP + 4;
  const int r0 = T::m0(), c0 = T::n0();
#pragma unroll 2
  for (int c = 0; c < KP; c += 4) {
    float4 dsv[TM];
#pragma unroll
    for (int u = 0; u < TM; ++u) dsv[u] = ld4(Ds + (r0 + 8 * u) * LDP + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = c + e;
#pragma unroll
      for (int v = 0; v < TN; ++v) {
        const float4 kv =
            ld4(Ks + key * DP + 4 * ((c0 + 4 * v) ^ (key & 7)));
#pragma unroll
        for (int u = 0; u < TM; ++u) {
          const float w = e == 0 ? dsv[u].x : e == 1 ? dsv[u].y
                        : e == 2 ? dsv[u].z : dsv[u].w;
          acc[u][4 * v] = fmaf(w, kv.x, acc[u][4 * v]);
          acc[u][4 * v + 1] = fmaf(w, kv.y, acc[u][4 * v + 1]);
          acc[u][4 * v + 2] = fmaf(w, kv.z, acc[u][4 * v + 2]);
          acc[u][4 * v + 3] = fmaf(w, kv.w, acc[u][4 * v + 3]);
        }
      }
    }
  }
}

// four floats of a row at column c (< dim) of a global tensor, rounded to
// bf16 for a bf16 one (autograd wants the input's type)
__device__ __forceinline__ void store4(float* dst, int c, int dim,
                                       const float* w, int vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst + c) = make_float4(w[0], w[1], w[2], w[3]);
  } else {
    for (int e = 0; e < 4 && c + e < dim; ++e) dst[c + e] = w[e];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, int c, int dim,
                                       const float* w, int vec) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(w[0], w[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(w[2], w[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst + c) = raw;
  } else {
    for (int e = 0; e < 4 && c + e < dim; ++e)
      dst[c + e] = __float2bfloat16_rn(w[e]);
  }
}

// dq rows i0 + m0 + 8 u of head h, scaled
template <int DP, int BQ, typename A>
__device__ __forceinline__ void store_dq(
    const A& a, int b, int h, int i0,
    const float (&acc)[QTile<DP, BQ>::TM][4 * QTile<DP, BQ>::TN]) {
  using T = QTile<DP, BQ>;
  const int r0 = T::m0(), c0 = T::n0();
  auto* dqp = a.dq + b * a.st.dq[0] + h * a.st.dq[1];
#pragma unroll
  for (int u = 0; u < T::TM; ++u) {
    const int i = i0 + r0 + 8 * u;
    if (i >= a.S) continue;
#pragma unroll
    for (int v = 0; v < T::TN; ++v) {
      const int c = 4 * (c0 + 4 * v);
      if (c >= a.dim) continue;
      const float w[4] = {acc[u][4 * v] * a.scale, acc[u][4 * v + 1] * a.scale,
                          acc[u][4 * v + 2] * a.scale,
                          acc[u][4 * v + 3] * a.scale};
      store4(dqp + i * a.st.dq[2], c, a.dim, w, a.vec);
    }
  }
}

template <int DP, int KP, int BQ>
struct KvPlan {
  static constexpr size_t kSmemFloats = 4 * size_t(KP) * DP +
                                        2 * size_t(BQ) * (KP + 4) + 2 * BQ;
  static constexpr size_t kSmemBytes = 4 * kSmemFloats;
  static_assert(BQ == KP, "K and V share their room with Q and dO");
  static_assert(kSmemBytes <= kSmemBlock, "dK/dV tile past shared memory");
  static constexpr int kMinBlocks = 2 * (kSmemBytes + 1024) <= kSmemSm ? 2
                                                                       : 1;
};

// A block per (part, batch, kv head), parts first: K and V of the part's
// key tile resident, its (head, query tile) steps in order, dV and dK in
// registers. FUSED (Small): the one part holds every key and walks every
// row, and the block also writes dQ; else (Large) dK/dV only, raw partials
// where the key tile has several parts.
template <typename E, int DP, int KP, int BQ, bool FUSED>
__global__ void __launch_bounds__(kBlock, (KvPlan<DP, KP, BQ>::kMinBlocks))
    bwd_kv_kernel(const Args<E> a) {
  using KT = KvTile<DP, KP>;
  using QT = QTile<DP, BQ>;
  constexpr int LDP = KP + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [KP][DP], swizzled
  float* Vs = Ks + KP * DP;                     // [KP][DP], swizzled
  float* Qs = Vs + KP * DP;                     // [BQ][DP], swizzled
  float* Gs = Qs + BQ * DP;                     // dO, like Q
  float* Ps = Gs + BQ * DP;                     // [BQ][LDP]: P
  float* Ds = Ps + BQ * LDP;                    // [BQ][LDP]: dS
  float* Ls = Ds + BQ * LDP;                    // [BQ]: lse
  float* Es = Ls + BQ;                          // [BQ]: Delta
  float* Dead = Ps;             // [DP] after the walk: dead rows' dO / T

  const int kvb = blockIdx.x % (a.KV * a.B);
  const int part = blockIdx.x / (a.KV * a.B);
  const int kvh = kvb % a.KV, b = kvb / a.KV;
  const int* row = a.parts + part * kPartInts;
  const int t_lo = row[kRowTile], n_rows = row[kRowTiles];
  const int s_lo = row[kStepLo], s_hi = row[kStepHi];
  const bool first = row[kFirstPart] == part, cut = row[kParts] > 1;
  const int j0 = row[kTile] * KP;

  // step -> its head and first query row
  auto head_of = [&](int step) { return kvh * a.group + step / n_rows; };
  auto row_of = [&](int step) { return (t_lo + step % n_rows) * BQ; };
  // Q, dO, lse (Large: Delta) of a step, one copy group
  auto issue = [&](int step) {
    const int h = head_of(step), i0 = row_of(step);
    const long long bh = (long long)b * a.H + h;
    stage_rows<DP, kBlock>(Qs, a.q + b * a.st.q[0] + h * a.st.q[1],
                           a.st.q[2], i0, BQ, a.S, a.dim, a.vec);
    stage_rows<DP, kBlock>(Gs, a.g + b * a.st.g[0] + h * a.st.g[1],
                           a.st.g[2], i0, BQ, a.S, a.dim, a.vec);
    load_col<kBlock>(Ls, a.lse + bh * a.S, i0, BQ, a.S);
    if (!FUSED) load_col<kBlock>(Es, a.delta + bh * a.S, i0, BQ, a.S);
    copy_commit();
  };
  stage_rows<DP, kBlock>(Ks, a.k + b * a.st.k[0] + kvh * a.st.k[1],
                         a.st.k[2], j0, KP, a.Tn, a.dim, a.vec);
  stage_rows<DP, kBlock>(Vs, a.v + b * a.st.v[0] + kvh * a.st.v[1],
                         a.st.v[2], j0, KP, a.Tn, a.dim, a.vec);
  copy_commit();

  float acc[KT::TM][4 * KT::TN];  // raw dV (warps 0-3) or dK (warps 4-7)
#pragma unroll
  for (int u = 0; u < KT::TM; ++u)
#pragma unroll
    for (int e = 0; e < 4 * KT::TN; ++e) acc[u][e] = 0.f;

  for (int s = s_lo; s < s_hi; ++s) {
    const int h = head_of(s), i0 = row_of(s);
    issue(s);
    if (FUSED) {
      // Delta of the step's rows, a warp per row (delta_kernel's order),
      // while the copies fly
      const int lane = threadIdx.x % 32;
      for (int r = threadIdx.x / 32; r < BQ; r += kWarps) {
        const long long i = i0 + r;
        float sum = 0.f;
        if (i < a.S) {
          const E* op = a.o + b * a.st.o[0] + h * a.st.o[1] + i * a.st.o[2];
          const E* gp = a.g + b * a.st.g[0] + h * a.st.g[1] + i * a.st.g[2];
          for (int c = lane; c < a.dim; c += 32)
            sum = fmaf(to_f32(op[c]), to_f32(gp[c]), sum);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) Es[r] = sum;
      }
    }
    copy_wait<0>();
    __syncthreads();  // the step's tiles (and K, V) landed; Delta written
    scores<DP, KP, BQ, true, FUSED>(Qs, Gs, Ks, Vs, Ls, Es, Ps, Ds, i0, j0, a);
    accumulate_kv<DP, KP, BQ>(Qs, Gs, Ps, Ds, acc);
    if (FUSED) {
      float qa[QT::TM][4 * QT::TN];
#pragma unroll
      for (int u = 0; u < QT::TM; ++u)
#pragma unroll
        for (int e = 0; e < 4 * QT::TN; ++e) qa[u][e] = 0.f;
      accumulate_q<DP, KP, BQ>(Ds, Ks, qa);
      store_dq<DP, BQ>(a, b, h, i0, qa);
    }
    __syncthreads();  // Q, dO, P and dS are read
  }
  copy_wait<0>();  // a block with no step still owns its K/V copies

  const bool dk = holds_dk();
  const int c0 = KT::n0();
  // rows with no live key (Large; Small gave them P = 1/T): dO / T to
  // every key's dV, added once per key tile, by its first part
  const long long dead_from =
      a.window > 0 ? (long long)a.Tn + a.window - 1 : a.S;
  if (!FUSED && first && dead_from < a.S) {
    for (int gi = 0; gi < a.group; ++gi) {
      const int h = kvh * a.group + gi;
      const E* gp = a.g + b * a.st.g[0] + h * a.st.g[1];
      __syncthreads();  // the last head's Dead is read
      for (int c = threadIdx.x; c < DP; c += kBlock) {
        float sum = 0.f;
        if (c < a.dim)
          for (long long i = dead_from; i < a.S; ++i)
            sum += to_f32(gp[i * a.st.g[2] + c]);
        Dead[c] = sum / (float)a.Tn;
      }
      __syncthreads();
      if (dk) continue;
#pragma unroll
      for (int v = 0; v < KT::TN; ++v) {
        const float4 dd = ld4(Dead + 4 * (c0 + 4 * v));
#pragma unroll
        for (int u = 0; u < KT::TM; ++u) {
          acc[u][4 * v] += dd.x;
          acc[u][4 * v + 1] += dd.y;
          acc[u][4 * v + 2] += dd.z;
          acc[u][4 * v + 3] += dd.w;
        }
      }
    }
  }

  if (cut) {
    // raw partials of slot `part`: [parts][KV * B][2 (dK, dV)][KP][DP]
    float* dst =
        a.part + (((size_t)part * a.KV * a.B + kvb) * 2 + !dk) * KP * DP;
#pragma unroll
    for (int u = 0; u < KT::TM; ++u)
#pragma unroll
      for (int v = 0; v < KT::TN; ++v)
        *reinterpret_cast<float4*>(dst + KT::key(u) * DP + 4 * (c0 + 4 * v)) =
            make_float4(acc[u][4 * v], acc[u][4 * v + 1], acc[u][4 * v + 2],
                        acc[u][4 * v + 3]);
    return;
  }
  const float mul = dk ? a.scale : 1.f;
  E* out = dk ? a.dk + b * a.st.dk[0] + kvh * a.st.dk[1]
              : a.dv + b * a.st.dv[0] + kvh * a.st.dv[1];
  const long long row_st = dk ? a.st.dk[2] : a.st.dv[2];
#pragma unroll
  for (int u = 0; u < KT::TM; ++u) {
    const int j = j0 + KT::key(u);
    if (j >= a.Tn) continue;
#pragma unroll
    for (int v = 0; v < KT::TN; ++v) {
      const int c = 4 * (c0 + 4 * v);
      if (c >= a.dim) continue;
      const float w[4] = {acc[u][4 * v] * mul, acc[u][4 * v + 1] * mul,
                          acc[u][4 * v + 2] * mul, acc[u][4 * v + 3] * mul};
      store4(out + j * row_st, c, a.dim, w, a.vec);
    }
  }
}

// Large: dK and dV of every key tile with several parts, the parts'
// partials summed in part order; a block per (part, batch x kv head), of
// which the first part of each such key tile works
template <typename E, int DP, int KP>
__global__ void __launch_bounds__(kBlock) bwd_reduce_kernel(const Args<E> a) {
  const int p = blockIdx.x, kvb = blockIdx.y;
  const int* row = a.parts + p * kPartInts;
  const int n_q = row[kParts];
  if (row[kFirstPart] != p || n_q == 1) return;
  const int kvh = kvb % a.KV, b = kvb / a.KV, j0 = row[kTile] * KP;
  const size_t slot = (size_t)a.KV * a.B * 2 * KP * DP;
  const float* base = a.part + (size_t)kvb * 2 * KP * DP;
  for (int e = threadIdx.x; e < KP * DP; e += kBlock) {
    const int j = j0 + e / DP, c = e % DP;
    if (j >= a.Tn || c >= a.dim) continue;
    float sk = 0.f, sv = 0.f;
    for (int q = p; q < p + n_q; ++q) {
      sk += base[q * slot + e];
      sv += base[q * slot + KP * DP + e];
    }
    a.dk[b * a.st.dk[0] + kvh * a.st.dk[1] + j * a.st.dk[2] + c] =
        from_f32<E>(sk * a.scale);
    a.dv[b * a.st.dv[0] + kvh * a.st.dv[1] + j * a.st.dv[2] + c] =
        from_f32<E>(sv);
  }
}

template <int DP, int BQ, int BK>
struct QPlan {
  static constexpr size_t kSmemFloats = 2 * size_t(BQ) * DP +
                                        2 * 2 * size_t(BK) * DP +
                                        size_t(BQ) * (BK + 4) + 2 * BQ;
  static constexpr size_t kSmemBytes = 4 * kSmemFloats;
  static_assert(kSmemBytes <= kSmemBlock, "dQ tile past shared memory");
  static constexpr int kMinBlocks = 2 * (kSmemBytes + 1024) <= kSmemSm ? 2
                                                                       : 1;
};

// Large: a block per (BQ query rows, batch x head), the causal row tiles
// longest first; Q and dO resident, K and V double-buffered over the live
// kv tiles; s and dO.v again, dS through shared memory, dQ in registers
template <typename E, int DP, int BQ, int BK>
__global__ void __launch_bounds__(kBlock, (QPlan<DP, BQ, BK>::kMinBlocks))
    bwd_q_kernel(const Args<E> a) {
  using QT = QTile<DP, BQ>;
  constexpr int LDP = BK + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][DP], swizzled
  float* Gs = Qs + BQ * DP;                     // dO, like Q
  float* Ks = Gs + BQ * DP;                     // [2][BK][DP], swizzled
  float* Vs = Ks + 2 * BK * DP;                 // [2][BK][DP], swizzled
  float* Ds = Vs + 2 * BK * DP;                 // [BQ][LDP]: dS
  float* Ls = Ds + BQ * LDP;                    // [BQ]: lse
  float* Es = Ls + BQ;                          // [BQ]: Delta

  const int nq = (a.S + BQ - 1) / BQ, bhs = a.B * a.H;
  int qt = blockIdx.x / bhs;
  if (a.causal) qt = nq - 1 - qt;  // longest first
  const int bh = blockIdx.x % bhs, h = bh % a.H, b = bh / a.H;
  const int kvh = h / a.group, q0 = qt * BQ;
  const E* kp = a.k + b * a.st.k[0] + kvh * a.st.k[1];
  const E* vp = a.v + b * a.st.v[0] + kvh * a.st.v[1];

  // keys live for some row of this block: [k_lo, k_hi)
  const int q_last = min(q0 + BQ, a.S) - 1;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int k_hi = a.causal ? min(a.Tn, q_last + 1) : a.Tn;
  const int n_lo = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - n_lo : 0;

  auto issue_kv = [&](int it, int stage) {
    const int k0 = (n_lo + it) * BK;
    stage_rows<DP, kBlock>(Ks + stage * BK * DP, kp, a.st.k[2], k0, BK,
                           a.Tn, a.dim, a.vec);
    stage_rows<DP, kBlock>(Vs + stage * BK * DP, vp, a.st.v[2], k0, BK,
                           a.Tn, a.dim, a.vec);
    copy_commit();
  };
  if (n_tiles > 0) {
    const long long bhl = (long long)b * a.H + h;
    stage_rows<DP, kBlock>(Qs, a.q + b * a.st.q[0] + h * a.st.q[1],
                           a.st.q[2], q0, BQ, a.S, a.dim, a.vec);
    stage_rows<DP, kBlock>(Gs, a.g + b * a.st.g[0] + h * a.st.g[1],
                           a.st.g[2], q0, BQ, a.S, a.dim, a.vec);
    load_col<kBlock>(Ls, a.lse + bhl * a.S, q0, BQ, a.S);
    load_col<kBlock>(Es, a.delta + bhl * a.S, q0, BQ, a.S);
    issue_kv(0, 0);  // one group with Q, dO, lse and Delta
  }

  float acc[QT::TM][4 * QT::TN];
#pragma unroll
  for (int u = 0; u < QT::TM; ++u)
#pragma unroll
    for (int e = 0; e < 4 * QT::TN; ++e) acc[u][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      issue_kv(it + 1, stage ^ 1);  // that stage was read by tile it - 1
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();  // the tile (and Q, dO, lse, Delta) landed
    const float* Kst = Ks + stage * BK * DP;
    scores<DP, BK, BQ, false, false>(Qs, Gs, Kst, Vs + stage * BK * DP, Ls,
                                     Es, nullptr, Ds, q0, (n_lo + it) * BK,
                                     a);
    accumulate_q<DP, BK, BQ>(Ds, Kst, acc);
    __syncthreads();  // the stage and dS are read
  }
  store_dq<DP, BQ>(a, b, h, q0, acc);
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

template <typename E, int DP, int KP, bool FUSED>
cudaError_t run_kv(const Args<E>& a, cudaStream_t stream) {
  constexpr size_t smem = KvPlan<DP, KP, KP>::kSmemBytes;
  cudaError_t err = allow_smem(bwd_kv_kernel<E, DP, KP, KP, FUSED>, smem);
  if (err != cudaSuccess) return err;
  bwd_kv_kernel<E, DP, KP, KP, FUSED>
      <<<a.n_parts * a.KV * a.B, kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

// keys: the plan's key tile (and query rows a step)
template <int DP, typename E>
cudaError_t launch(const Args<E>& a, int cfg, int keys, cudaStream_t stream) {
  if (cfg == 0) {  // Small: one launch, one part holding every key
    if (a.n_parts != 1 || a.Tn > keys) return cudaErrorInvalidValue;
    if (keys == 32) return run_kv<E, DP, 32, true>(a, stream);
    if constexpr (DP <= 128)
      if (keys == 64) return run_kv<E, DP, 64, true>(a, stream);
    return cudaErrorInvalidValue;
  }
  constexpr int KP = DP <= 128 ? 64 : 32;            // dK/dV
  constexpr int QB = 64, BK = DP <= 128 ? 64 : 16;   // dQ
  if (cfg != 1 || keys != KP) return cudaErrorInvalidValue;
  const long long rows = (long long)a.B * a.H * a.S;
  delta_kernel<E><<<(rows + kWarps - 1) / kWarps, kBlock, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = run_kv<E, DP, KP, false>(a, stream);
  if (err != cudaSuccess) return err;
  if (a.part != nullptr) {
    bwd_reduce_kernel<E, DP, KP>
        <<<dim3(a.n_parts, a.KV * a.B), kBlock, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  constexpr size_t smem_q = QPlan<DP, QB, BK>::kSmemBytes;
  err = allow_smem(bwd_q_kernel<E, DP, QB, BK>, smem_q);
  if (err != cudaSuccess) return err;
  const long long nq = (a.S + QB - 1) / QB;
  bwd_q_kernel<E, DP, QB, BK><<<nq * a.B * a.H, kBlock, smem_q, stream>>>(a);
  return cudaGetLastError();
}

// Args of element type E from the C entry point's untyped arguments, then
// the launch at the built head dim
template <typename E>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const void* o, const void* lse, const void* g,
                         void* dq, void* dk, void* dv, void* delta,
                         void* part, const void* parts, int B, int H, int KV,
                         int S, int Tn, int D, const long long* st,
                         float scale, float cap, int causal, int window,
                         int cfg, int keys, int n_parts, cudaStream_t stream) {
  Args<E> a;
  a.q = static_cast<const E*>(q);
  a.k = static_cast<const E*>(k);
  a.v = static_cast<const E*>(v);
  a.o = static_cast<const E*>(o);
  a.g = static_cast<const E*>(g);
  a.lse = static_cast<const float*>(lse);
  a.parts = static_cast<const int*>(parts);
  a.dq = static_cast<E*>(dq);
  a.dk = static_cast<E*>(dk);
  a.dv = static_cast<E*>(dv);
  a.delta = static_cast<float*>(delta);
  a.part = static_cast<float*>(part);
  a.B = B, a.H = H, a.KV = KV, a.S = S, a.Tn = Tn, a.dim = D;
  a.group = H / KV, a.causal = causal, a.window = window;
  a.n_parts = n_parts;
  a.scale = scale, a.cap = cap;
  long long* dst[8] = {a.st.q, a.st.k, a.st.v, a.st.o,
                       a.st.g, a.st.dq, a.st.dk, a.st.dv};
  for (int x = 0; x < 8; ++x)
    for (int y = 0; y < 3; ++y) dst[x][y] = st[3 * x + y];
  const void* ptrs[8] = {q, k, v, o, g, dq, dk, dv};
  // fp32: 16-byte copies and stores; bf16: 8-byte loads and stores (the
  // same rule: every address 16-byte aligned, strides and D multiples of 4)
  a.vec = attn::aligned16(ptrs, 8, st, 24, D);
  if (parts == nullptr || n_parts < 1) return cudaErrorInvalidValue;
  switch (attn::built_dim(D)) {
    case 32:
      return launch<32>(a, cfg, keys, stream);
    case 64:
      return launch<64>(a, cfg, keys, stream);
    case 128:
      return launch<128>(a, cfg, keys, stream);
    case 256:
      return launch<256>(a, cfg, keys, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,S,D), k and v (B,KV,T,D), o and dO like q, all fp32 or all bf16
// (is_bf16), with dq, dk and dv of the same type written whole; lse
// (B,H,S) fp32 contiguous. configuration 0 Small, 1 Large, with its key
// tile `keys` and its part table (n_parts rows of kPartInts int32 on the
// card); Large takes a (B,H,S) fp32 Delta scratch and, where a key tile
// has several parts, an fp32 partials scratch of n_parts x KV x B x 2 x
// keys x DP floats (else NULL). D in [1, 256].
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* g, void* dq, void* dk, void* dv,
    void* delta, void* part, const void* parts, int B, int H, int KV, int S,
    int Tn, int D, long long qb, long long qh, long long qs, long long kb,
    long long kh, long long ks, long long vb, long long vh, long long vs,
    long long ob, long long oh, long long os, long long gb, long long gh,
    long long gs, long long dqb, long long dqh, long long dqs, long long dkb,
    long long dkh, long long dks, long long dvb, long long dvh,
    long long dvs, float scale, float cap, int causal, int window, int cfg,
    int keys, int n_parts, int is_bf16, void* stream) {
  const long long st[24] = {qb,  qh,  qs,  kb,  kh,  ks,  vb,  vh,
                            vs,  ob,  oh,  os,  gb,  gh,  gs,  dqb,
                            dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs};
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch_typed<__nv_bfloat16>(q, k, v, o, lse, g, dq, dk, dv,
                                            delta, part, parts, B, H, KV, S,
                                            Tn, D, st, scale, cap, causal,
                                            window, cfg, keys, n_parts, s)
              : launch_typed<float>(q, k, v, o, lse, g, dq, dk, dv, delta,
                                    part, parts, B, H, KV, S, Tn, D, st,
                                    scale, cap, causal, window, cfg, keys,
                                    n_parts, s));
}
