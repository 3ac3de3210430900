// dueling_select: score every arm under both posterior samples and reduce
// each query row to its routed pair (a1, a2), in one launch.
//
// Replaces the Pallas kernel _select_kernel of
// src/repro/kernels/dueling_score.py (dueling_select, pallas_call at :234).
//
// Per query row b and arm k (the Hadamard identity of the Pallas kernel):
//   s_j[k] = ((x*theta_j) . a_k) / sqrt(max((x*x) . (a_k*a_k), 1e-24))
//            - tilt[b,k]             (-inf where the arm is inactive)
//   a1 = argmax s_1;  a2 = argmax s_2 (without a1 when distinct),
//   and (a1, a1) when every candidate of a2 is -inf.
// Every argmax orders candidates by (value descending, index ascending):
// jnp.argmax's first index on ties, and arm 0 for an all -inf row.
//
// What bounds it on the card: the 3 B*K*d multiply-adds of num_1, num_2
// and den over the live arms (6 B*K*d operations at the fp32 rate);
// below ~1e5 live (row, arm) pairs of d 768, the bytes of x and the
// latency of a launch. The output is two ints per row.
//
// Two configurations, chosen by the wrapper (dueling_score.select_plan):
// - Small (the routing pools: K <= 16, or K <= 32 and B*K <= 2^16): a
//   block per row (per 8 rows from B 1024 on, K <= 16), a warp per arm. A
//   warp reads its arm's mask entries first and, where the arm is dead in
//   every row of the block, loads and sums nothing. A live warp issues all
//   its loads of a_k (16-byte loads where d % 4 == 0 and the tables are
//   16-byte aligned, else 4-byte) before the block stages x*theta_1,
//   x*theta_2 and x*x of its rows in shared memory, once, and keeps a_k in
//   registers across its rows. Lane l sums the elements of its loads l,
//   l + 32, ... in increasing order, then one fixed xor tree adds the
//   lanes (the order of the Small score kernel). The (s_1, s_2) of every
//   (row, arm) go to shared memory; after one barrier a warp per row takes,
//   lane per arm, the argmax of s_1 and then of s_2 (a1 put at -inf when
//   distinct) by an xor tree of (value, index) merges. The latency of the
//   two rounds of loads (mask, then a_k beside x and theta) and of the
//   launch bounds it at the routing batch, not the operations.
// - Large (many arms): a register-tiled product fused with the argmax. A
//   block owns 32 rows and walks arm tiles of 128, staging 32-wide slices
//   of d in shared memory (double-buffered, the next slice's loads in
//   registers during the current slice's products): x*theta_1, x*theta_2
//   and x*x of its rows, a and a*a of the tile's arms. Each thread holds
//   4 rows x 4 arms with three accumulators each, summed over d in
//   increasing order with fmaf. After a tile it scores its 16 outputs and
//   keeps, per row, the best s_1 and the top two of s_2. At the end the 32
//   threads that share a row merge their candidates by an xor tree of
//   (value, index) merges. Where the rows give fewer blocks than SMs, a
//   thread-block cluster of up to 8 blocks splits the arm tiles (rank r
//   takes tiles r, r + cl, ...) and rank 0 merges the blocks' candidates
//   over distributed shared memory in rank order. No (2,B,K) score tensor
//   reaches device memory. With one block of 8 warps an SM, it issues its
//   fmas at about half the fp32 rate.
// Every (b, k) is summed over d in an order that does not depend on where
// b or k sits, so duplicated arms score bitwise equal (the first copy
// wins) and repeated calls repeat bitwise; the merges are by a total order,
// so their tree shape does not matter. No atomics. fp32 FMAs on the CUDA
// cores only, no TF32: TF32 would flip near-tied argmaxes.
//
// The bounds between the configurations come from both forced over a
// sweep of (B, K) at d 768 on the H100 (tools/score_sweep.py --select):
// a Large block takes ~0.083 ms per arm tile whatever its rows, while
// Small costs ~0.87 us per thousand (row, arm) pairs.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <limits>

#include "sm90.cuh"

namespace {

struct SelectArgs {
  const float* x;            // (B, d)
  const float* a;            // (K, d)
  const float* thetas;       // (2, d)
  const float* tilt;         // (K,) or (B, K), or null
  const uint8_t* mask;       // (K,) or (B, K) bool, or null
  int32_t* a1;               // (B,)
  int32_t* a2;               // (B,)
  int B, K, d;
  int tilt_stride, mask_stride;  // 0 for a (K,) operand, K for (B, K)
  int distinct;
};

constexpr float kNegInf = -std::numeric_limits<float>::infinity();

// (v, i) before (bv, bi): higher value, then lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// the warp's best (v, i) by the (value, index) order, in every lane
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, s);
    const int oi = __shfl_xor_sync(0xffffffffu, i, s);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// a row's candidates: the best of s_1, the top two of s_2
struct Cands {
  float v1; int i1;
  float u1; int j1;
  float u2; int j2;
};

__device__ __forceinline__ void cands_init(Cands& c) {
  c.v1 = c.u1 = c.u2 = kNegInf;
  c.i1 = c.j1 = c.j2 = INT_MAX;
}

__device__ __forceinline__ void cands_push(Cands& c, float s1, float s2,
                                           int k) {
  if (better(s1, k, c.v1, c.i1)) { c.v1 = s1; c.i1 = k; }
  if (better(s2, k, c.u1, c.j1)) {
    c.u2 = c.u1; c.j2 = c.j1; c.u1 = s2; c.j1 = k;
  } else if (better(s2, k, c.u2, c.j2)) {
    c.u2 = s2; c.j2 = k;
  }
}

// merge o into c (arms of c and o disjoint)
__device__ __forceinline__ void cands_merge(Cands& c, const Cands& o) {
  if (better(o.v1, o.i1, c.v1, c.i1)) { c.v1 = o.v1; c.i1 = o.i1; }
  if (better(o.u1, o.j1, c.u1, c.j1)) {
    // o's first leads; the second is the better of c's first and o's second
    if (better(c.u1, c.j1, o.u2, o.j2)) { c.u2 = c.u1; c.j2 = c.j1; }
    else { c.u2 = o.u2; c.j2 = o.j2; }
    c.u1 = o.u1; c.j1 = o.j1;
  } else if (better(o.u1, o.j1, c.u2, c.j2)) {
    c.u2 = o.u1; c.j2 = o.j1;
  }
}

__device__ __forceinline__ void cands_warp_merge(Cands& c) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    Cands o;
    o.v1 = __shfl_xor_sync(0xffffffffu, c.v1, s);
    o.i1 = __shfl_xor_sync(0xffffffffu, c.i1, s);
    o.u1 = __shfl_xor_sync(0xffffffffu, c.u1, s);
    o.j1 = __shfl_xor_sync(0xffffffffu, c.j1, s);
    o.u2 = __shfl_xor_sync(0xffffffffu, c.u2, s);
    o.j2 = __shfl_xor_sync(0xffffffffu, c.j2, s);
    cands_merge(c, o);
  }
}

// the routed pair of a row from its merged candidates: a2's candidate is
// the best of s_2, or the runner-up where distinct takes a1 away; at -inf
// no arm is left and the row duels (a1, a1)
__device__ __forceinline__ void write_pair(const SelectArgs& p, int b,
                                           const Cands& c) {
  const bool skip = p.distinct && c.j1 == c.i1;
  const float cv = skip ? c.u2 : c.u1;
  const int ci = skip ? c.j2 : c.j1;
  p.a1[b] = c.i1;
  p.a2[b] = cv == kNegInf ? c.i1 : ci;
}

__device__ __forceinline__ float score(float num, float den, float t) {
  return __fsub_rn(__fdiv_rn(num, den), t);
}

// ---- Small: a warp per arm, R rows per block --------------------------------

constexpr int kSmallArms = 32;       // warps per block, at most
constexpr int kSmallRowsArms = 16;   // at most, where a block holds 8 rows

__host__ __device__ constexpr int pad4(int d) { return (d + 3) / 4 * 4; }

// dynamic shared memory: R rows of (x*theta_1, x*theta_2, x*x), pad4(d)
// floats each, then R x K of s_1 and of s_2
size_t small_smem(int rows, int K, int d) {
  return sizeof(float) * ((size_t)3 * rows * pad4(d) + (size_t)2 * rows * K);
}

// R = 1 or 8 rows. W = 4: 16-byte loads (d % 4 == 0, tables 16-byte
// aligned), else 4-byte; a round of loads of a_k covers kChunk elements of
// d (U loads a lane). Blocks of 8 rows hold at most 16 arms (512 threads),
// so a thread may keep the rows' sums beside a_k in up to 128 registers.
template <int R, int W>
__global__ void __launch_bounds__(R == 1 ? 32 * kSmallArms
                                         : 32 * kSmallRowsArms)
    select_small(const SelectArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kChunk = W == 4 ? 1024 : 512;
  constexpr int U = kChunk / (32 * W);
  const int K = p.K, d = p.d, dp = pad4(d);
  const int k = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b0 = blockIdx.x * R;
  float* sc1 = smem + 3 * R * dp;              // (R, K)
  float* sc2 = sc1 + R * K;

  // the arm's mask entries, before any load of a_k
  bool live[R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int b = b0 + r;
    live[r] = b < p.B &&
              (p.mask == nullptr ||
               p.mask[(int64_t)b * p.mask_stride + k] != 0);
    any |= live[r];
  }
  const float* ak = p.a + (int64_t)k * d;
  float av[U][W];
  auto load_a = [&](int t0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + (u * 32 + lane) * W;   // W = 4: all four or none
      if constexpr (W == 4) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 f =
            t < d ? *reinterpret_cast<const float4*>(ak + t) : z;
        av[u][0] = f.x; av[u][1] = f.y; av[u][2] = f.z; av[u][3] = f.w;
      } else {
        av[u][0] = t < d ? ak[t] : 0.f;
      }
    }
  };
  if (any) load_a(0);

  // stage the rows' products once (rows past B as zeros)
  const float* th1 = p.thetas;
  const float* th2 = p.thetas + d;
  const int nd = d / W;
  for (int e = threadIdx.x; e < R * nd; e += blockDim.x) {
    const int r = e / nd, t = (e % nd) * W, b = b0 + r;
    float* row = smem + 3 * r * dp;
    if constexpr (W == 4) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 xv =
          b < p.B ? *reinterpret_cast<const float4*>(p.x + (int64_t)b * d + t)
                  : z;
      const float4 t1 = *reinterpret_cast<const float4*>(th1 + t);
      const float4 t2 = *reinterpret_cast<const float4*>(th2 + t);
      *reinterpret_cast<float4*>(row + t) = make_float4(
          __fmul_rn(xv.x, t1.x), __fmul_rn(xv.y, t1.y),
          __fmul_rn(xv.z, t1.z), __fmul_rn(xv.w, t1.w));
      *reinterpret_cast<float4*>(row + dp + t) = make_float4(
          __fmul_rn(xv.x, t2.x), __fmul_rn(xv.y, t2.y),
          __fmul_rn(xv.z, t2.z), __fmul_rn(xv.w, t2.w));
      *reinterpret_cast<float4*>(row + 2 * dp + t) = make_float4(
          __fmul_rn(xv.x, xv.x), __fmul_rn(xv.y, xv.y),
          __fmul_rn(xv.z, xv.z), __fmul_rn(xv.w, xv.w));
    } else {
      const float xv = b < p.B ? p.x[(int64_t)b * d + t] : 0.f;
      row[t] = __fmul_rn(xv, th1[t]);
      row[dp + t] = __fmul_rn(xv, th2[t]);
      row[2 * dp + t] = __fmul_rn(xv, xv);
    }
  }
  __syncthreads();

  if (any) {
    float n1[R], n2[R], e[R];
#pragma unroll
    for (int r = 0; r < R; ++r) n1[r] = n2[r] = e[r] = 0.f;
    for (int t0 = 0; t0 < d; t0 += kChunk) {
      if (t0 > 0) load_a(t0);
      // past d every value is 0: adding 0 leaves a sum as it is
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + (u * 32 + lane) * W;
        const bool ok = t < d;
        float aa[W];
#pragma unroll
        for (int i = 0; i < W; ++i) aa[i] = __fmul_rn(av[u][i], av[u][i]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float* row = smem + 3 * r * dp + t;
          float x1[W], x2[W], xx[W];
          if constexpr (W == 4) {
            const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 f1 = ok ? *reinterpret_cast<const float4*>(row) : z;
            const float4 f2 =
                ok ? *reinterpret_cast<const float4*>(row + dp) : z;
            const float4 f3 =
                ok ? *reinterpret_cast<const float4*>(row + 2 * dp) : z;
            x1[0] = f1.x; x1[1] = f1.y; x1[2] = f1.z; x1[3] = f1.w;
            x2[0] = f2.x; x2[1] = f2.y; x2[2] = f2.z; x2[3] = f2.w;
            xx[0] = f3.x; xx[1] = f3.y; xx[2] = f3.z; xx[3] = f3.w;
          } else {
            x1[0] = ok ? row[0] : 0.f;
            x2[0] = ok ? row[dp] : 0.f;
            xx[0] = ok ? row[2 * dp] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < W; ++i) {
            n1[r] = fmaf(x1[i], av[u][i], n1[r]);
            n2[r] = fmaf(x2[i], av[u][i], n2[r]);
            e[r] = fmaf(xx[i], aa[i], e[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {       // the fixed xor tree
        n1[r] = __fadd_rn(n1[r], __shfl_xor_sync(0xffffffffu, n1[r], s));
        n2[r] = __fadd_rn(n2[r], __shfl_xor_sync(0xffffffffu, n2[r], s));
        e[r] = __fadd_rn(e[r], __shfl_xor_sync(0xffffffffu, e[r], s));
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s1 = kNegInf, s2 = kNegInf;
        if (live[r]) {
          const int b = b0 + r;
          const float den = sqrtf(fmaxf(e[r], 1e-24f));
          const float t =
              p.tilt ? p.tilt[(int64_t)b * p.tilt_stride + k] : 0.f;
          s1 = score(n1[r], den, t);
          s2 = score(n2[r], den, t);
        }
        sc1[r * K + k] = s1;
        sc2[r * K + k] = s2;
      }
    }
  } else if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) sc1[r * K + k] = sc2[r * K + k] = kNegInf;
  }
  __syncthreads();

  // a warp per row, a lane per arm
  for (int r = k; r < R; r += K) {
    const int b = b0 + r;
    if (b >= p.B) break;
    float v = lane < K ? sc1[r * K + lane] : kNegInf;
    int i = lane < K ? lane : INT_MAX;
    warp_best(v, i);
    const int a1 = i;
    float v2 = lane < K && !(p.distinct && lane == a1) ? sc2[r * K + lane]
                                                       : kNegInf;
    int i2 = lane < K ? lane : INT_MAX;
    warp_best(v2, i2);
    if (lane == 0) {
      p.a1[b] = a1;
      p.a2[b] = v2 == kNegInf ? a1 : i2;
    }
  }
}

// ---- Large: register tiles, the argmax fused --------------------------------

constexpr int kRows = 32;            // rows of a block
constexpr int kArms = 128;           // arms of a tile
constexpr int kSlice = 32;           // d per stage
constexpr int kThreads = 256;        // 8 warps; a thread holds 4 x 4
constexpr int kRowPad = kRows + 4;   // strides that keep float4 alignment
constexpr int kArmPad = kArms + 4;
// one stage: x*theta_1, x*theta_2, x*x [d][row]; a, a*a [d][arm]
constexpr int kStage = 3 * kSlice * kRowPad + 2 * kSlice * kArmPad;
// dynamic shared memory: two stages (the candidates' merge reuses them),
// then the block's merged rows
constexpr size_t kLargeSmem = sizeof(float) * (2 * kStage + kRows * 6);
static_assert(kRows * 32 * 6 <= 2 * kStage, "the merge fits the stages");

template <int W>
__global__ void __launch_bounds__(kThreads)
    select_large(const SelectArgs p, int cl) {
  extern __shared__ float4 smem4[];
  float (*stage)[kStage] = reinterpret_cast<float (*)[kStage]>(smem4);
  float (*result)[6] = reinterpret_cast<float (*)[6]>(stage[2]);
  const int K = p.K, d = p.d;
  const int rank = blockIdx.x % cl, b0 = (blockIdx.x / cl) * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // a warp covers 4 row groups x 8 arm groups of 4: its row loads are 64
  // contiguous bytes and its arm loads 128, one shared-memory wavefront
  const int rg = (warp / 4) * 4 + lane / 8;    // rows 4 rg .. 4 rg + 3
  const int ag = (warp % 4) * 8 + lane % 8;    // arms 4 ag .. 4 ag + 3
  const int n_tiles = (K + kArms - 1) / kArms;
  const int my_tiles = (n_tiles - rank + cl - 1) / cl;
  const int n_slices = (d + kSlice - 1) / kSlice;
  const int steps = my_tiles * n_slices;

  // the next slice in registers: x (with theta) of the rows, a of the arms
  constexpr int XN = kRows * kSlice / W;       // loads of x per slice
  constexpr int AN = kArms * kSlice / W;       // loads of a per slice
  constexpr int XL = (XN + kThreads - 1) / kThreads;
  constexpr int AL = AN / kThreads;
  float xr[XL][W], t1r[XL][W], t2r[XL][W], ar[AL][W];

  auto load = [&](int st) {
    const int k0 = (rank + (st / n_slices) * cl) * kArms;
    const int d0 = (st % n_slices) * kSlice;
#pragma unroll
    for (int l = 0; l < XL; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / (kSlice / W), t = d0 + (e % (kSlice / W)) * W;
      const bool ok = e < XN && b0 + r < p.B && t < d;
      const bool okt = e < XN && t < d;
      const float* xs = p.x + (int64_t)(b0 + r) * d + t;
      if constexpr (W == 4) {
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 f = ok ? *reinterpret_cast<const float4*>(xs) : z;
        const float4 g1 =
            okt ? *reinterpret_cast<const float4*>(p.thetas + t) : z;
        const float4 g2 =
            okt ? *reinterpret_cast<const float4*>(p.thetas + d + t) : z;
        xr[l][0] = f.x; xr[l][1] = f.y; xr[l][2] = f.z; xr[l][3] = f.w;
        t1r[l][0] = g1.x; t1r[l][1] = g1.y; t1r[l][2] = g1.z;
        t1r[l][3] = g1.w;
        t2r[l][0] = g2.x; t2r[l][1] = g2.y; t2r[l][2] = g2.z;
        t2r[l][3] = g2.w;
      } else {
        xr[l][0] = ok ? *xs : 0.f;
        t1r[l][0] = okt ? p.thetas[t] : 0.f;
        t2r[l][0] = okt ? p.thetas[d + t] : 0.f;
      }
    }
#pragma unroll
    for (int l = 0; l < AL; ++l) {
      const int e = tid + l * kThreads;
      const int n = e / (kSlice / W), t = d0 + (e % (kSlice / W)) * W;
      const bool ok = k0 + n < K && t < d;
      const float* as = p.a + (int64_t)(k0 + n) * d + t;
      if constexpr (W == 4) {
        const float4 f = ok ? *reinterpret_cast<const float4*>(as)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        ar[l][0] = f.x; ar[l][1] = f.y; ar[l][2] = f.z; ar[l][3] = f.w;
      } else {
        ar[l][0] = ok ? *as : 0.f;
      }
    }
  };
  // the registers' products into a stage (the roundings of the Small path)
  auto store = [&](float* s) {
    float* x1 = s;
    float* x2 = x1 + kSlice * kRowPad;
    float* xx = x2 + kSlice * kRowPad;
    float* as = xx + kSlice * kRowPad;
    float* aa = as + kSlice * kArmPad;
#pragma unroll
    for (int l = 0; l < XL; ++l) {
      const int e = tid + l * kThreads;
      if (e >= XN) break;
      const int r = e / (kSlice / W), c = (e % (kSlice / W)) * W;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int o = (c + i) * kRowPad + r;
        x1[o] = __fmul_rn(xr[l][i], t1r[l][i]);
        x2[o] = __fmul_rn(xr[l][i], t2r[l][i]);
        xx[o] = __fmul_rn(xr[l][i], xr[l][i]);
      }
    }
#pragma unroll
    for (int l = 0; l < AL; ++l) {
      const int e = tid + l * kThreads;
      const int n = e / (kSlice / W), c = (e % (kSlice / W)) * W;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int o = (c + i) * kArmPad + n;
        as[o] = ar[l][i];
        aa[o] = __fmul_rn(ar[l][i], ar[l][i]);
      }
    }
  };

  float n1[4][4], n2[4][4], de[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n) n1[i][n] = n2[i][n] = de[i][n] = 0.f;
  Cands cand[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) cands_init(cand[i]);

  if (steps > 0) {
    load(0);
    store(stage[0]);
  }
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const float* s = stage[st & 1];
    if (st + 1 < steps) load(st + 1);
    const float* x1 = s;
    const float* x2 = x1 + kSlice * kRowPad;
    const float* xx = x2 + kSlice * kRowPad;
    const float* as = xx + kSlice * kRowPad;
    const float* aa = as + kSlice * kArmPad;
#pragma unroll
    for (int c = 0; c < kSlice; ++c) {
      const float4 r1 = *reinterpret_cast<const float4*>(x1 + c * kRowPad + 4 * rg);
      const float4 r2 = *reinterpret_cast<const float4*>(x2 + c * kRowPad + 4 * rg);
      const float4 rx = *reinterpret_cast<const float4*>(xx + c * kRowPad + 4 * rg);
      const float4 va = *reinterpret_cast<const float4*>(as + c * kArmPad + 4 * ag);
      const float4 vq = *reinterpret_cast<const float4*>(aa + c * kArmPad + 4 * ag);
      const float q1[4] = {r1.x, r1.y, r1.z, r1.w};
      const float q2[4] = {r2.x, r2.y, r2.z, r2.w};
      const float qx[4] = {rx.x, rx.y, rx.z, rx.w};
      const float wa[4] = {va.x, va.y, va.z, va.w};
      const float wq[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          n1[i][n] = fmaf(q1[i], wa[n], n1[i][n]);
          n2[i][n] = fmaf(q2[i], wa[n], n2[i][n]);
          de[i][n] = fmaf(qx[i], wq[n], de[i][n]);
        }
    }
    if (st % n_slices == n_slices - 1) {       // the tile's scores
      const int k0 = (rank + (st / n_slices) * cl) * kArms;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int b = b0 + 4 * rg + i;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int k = k0 + 4 * ag + n;
          if (b < p.B && k < K) {
            float s1 = kNegInf, s2 = kNegInf;
            if (p.mask == nullptr ||
                p.mask[(int64_t)b * p.mask_stride + k] != 0) {
              const float den = sqrtf(fmaxf(de[i][n], 1e-24f));
              const float t =
                  p.tilt ? p.tilt[(int64_t)b * p.tilt_stride + k] : 0.f;
              s1 = score(n1[i][n], den, t);
              s2 = score(n2[i][n], den, t);
            }
            cands_push(cand[i], s1, s2, k);
          }
          n1[i][n] = n2[i][n] = de[i][n] = 0.f;
        }
      }
    }
    if (st + 1 < steps) store(stage[(st + 1) & 1]);
    __syncthreads();
  }

  // merge a row's 32 arm groups: a warp per 4 rows, a lane per arm group
  float* cs = stage[0];                        // (32 rows, 32 groups, 6)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* o = cs + ((4 * rg + i) * 32 + ag) * 6;
    o[0] = cand[i].v1; o[1] = __int_as_float(cand[i].i1);
    o[2] = cand[i].u1; o[3] = __int_as_float(cand[i].j1);
    o[4] = cand[i].u2; o[5] = __int_as_float(cand[i].j2);
  }
  __syncthreads();
  for (int row = warp * 4; row < warp * 4 + 4; ++row) {
    const float* o = cs + (row * 32 + lane) * 6;
    Cands c;
    c.v1 = o[0]; c.i1 = __float_as_int(o[1]);
    c.u1 = o[2]; c.j1 = __float_as_int(o[3]);
    c.u2 = o[4]; c.j2 = __float_as_int(o[5]);
    cands_warp_merge(c);
    if (cl == 1) {
      if (lane == 0 && b0 + row < p.B) write_pair(p, b0 + row, c);
    } else if (lane == 0) {
      result[row][0] = c.v1; result[row][1] = __int_as_float(c.i1);
      result[row][2] = c.u1; result[row][3] = __int_as_float(c.j1);
      result[row][4] = c.u2; result[row][5] = __int_as_float(c.j2);
    }
  }
  if (cl == 1) return;
  // rank 0 merges the cluster's rows, lane r reading rank r
  sm90::cluster_sync();
  if (rank == 0) {
    for (int row = warp * 4; row < warp * 4 + 4; ++row) {
      Cands c;
      cands_init(c);
      if (lane < cl) {
        float v[6];
#pragma unroll
        for (int f = 0; f < 6; ++f)
          v[f] = sm90::ld_cluster(sm90::map_rank(&result[row][f], lane));
        c.v1 = v[0]; c.i1 = __float_as_int(v[1]);
        c.u1 = v[2]; c.j1 = __float_as_int(v[3]);
        c.u2 = v[4]; c.j2 = __float_as_int(v[5]);
      }
      cands_warp_merge(c);
      if (lane == 0 && b0 + row < p.B) write_pair(p, b0 + row, c);
    }
  }
  sm90::cluster_sync();   // no block leaves while its rows may be read
}

template <int R>
int launch_small(const SelectArgs& p, bool vec, int blocks,
                 cudaStream_t st) {
  const size_t smem = small_smem(R, p.K, p.d);
  void (*kern)(SelectArgs) = vec ? select_small<R, 4> : select_small<R, 1>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, 32 * p.K, smem, st>>>(p);
  return (int)cudaGetLastError();
}

int launch_large(const SelectArgs& p, bool vec, int cl, int blocks,
                 cudaStream_t st) {
  void (*kern)(SelectArgs, int) = vec ? select_large<4> : select_large<1>;
  const cudaError_t e0 = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kLargeSmem);
  if (e0 != cudaSuccess) return (int)e0;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(blocks);
  lc.blockDim = dim3(kThreads);
  lc.dynamicSmemBytes = kLargeSmem;
  lc.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&lc, kern, p, cl);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// cfg 0 Small with `rows` rows per block, 1 Large with clusters of `cl`
// blocks; `blocks` the grid (dueling_score.select_plan)
extern "C" int dueling_select_launch(
    const void* x, const void* a, const void* thetas, const void* tilt,
    const void* mask, void* a1, void* a2, int B, int K, int d,
    int tilt_stride, int mask_stride, int distinct, int cfg, int rows,
    int cl, int blocks, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (K <= 0 || d <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  const SelectArgs p{(const float*)x,   (const float*)a,
                     (const float*)thetas, (const float*)tilt,
                     (const uint8_t*)mask, (int32_t*)a1,
                     (int32_t*)a2,      B,
                     K,                 d,
                     tilt_stride,       mask_stride,
                     distinct};
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)a % 16 == 0 && (uintptr_t)thetas % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (cfg == 0) {
    if (K > (rows == 1 ? kSmallArms : kSmallRowsArms) ||
        (int64_t)blocks * rows < B)
      return (int)cudaErrorInvalidValue;
    if (rows == 1) return launch_small<1>(p, vec, blocks, st);
    if (rows == 8) return launch_small<8>(p, vec, blocks, st);
    return (int)cudaErrorInvalidValue;
  }
  if (cfg == 1) {
    if (rows != kRows || cl < 1 || cl > 8 || blocks % cl != 0 ||
        (int64_t)(blocks / cl) * kRows < B)
      return (int)cudaErrorInvalidValue;
    return launch_large(p, vec, cl, blocks, st);
  }
  return (int)cudaErrorInvalidValue;
}
