// flash_attention_bwd_sm90: the bf16 gradient of flash_attention.cu's Hopper
// forward (flash_attention_kernel_sm90) on the tensor cores, at head dims
// 64, 128 and 256: GQA, causal and sliding-window masks, the logit soft
// cap, any S and T. FlashAttention-3's backward, in two deterministic
// passes.
//
// Replaces no Pallas kernel: it is the gradient of _attn_kernel (:23) of
// src/repro/kernels/flash_attention.py, which the reference takes by XLA's
// autodiff of its einsum attention (src/repro/models/attention.py,
// _attend); the LMs train through it in bf16. fp32 inputs, and bf16 at head
// dim 32, keep flash_attention_bwd.cu's SIMT kernels
// (kernels/flash_attention.py::bwd_plan picks by dtype and head dim).
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
// v, so it adds dO_i / T to every dV_j and nothing to dQ or dK.
//
// Rounding, as the reference's bf16 autodiff rounds: S and dP = dO V^T are
// fp32 wgmma accumulators; P is rounded to bf16 for dV = P^T dO and dS to
// bf16 for dQ = dS K and dK = dS^T Q (the reference casts P to v's type
// before P.V, and dS comes back through that cast); every accumulator is
// fp32, and dq, dk and dv are rounded to bf16 at the store.
//
// What bounds it on the card: 10 D operations per live (row, key) pair at
// 989 bf16 TFLOP/s (five products). Two passes do 14 D: both recompute S
// and dP (4 D each), dQ = dS K is the dQ pass's third product and dV, dK
// the dK/dV pass's (18 D at head dim 256, whose two warpgroups both
// compute a block's S^T and dP^T). The price buys a deterministic dQ: no
// block shares an output with another, so there are no atomics and every
// sum has one order; results repeat bitwise.
//
// 1. bwd_q_kernel_sm90, a block per (QR = 128 query rows, batch x head),
//    the causal row tiles longest first. Its consumers first write the rows'
//    stats that the second pass reads: lse in log2 units (+inf on padded
//    rows, so their P is 0) and Delta = rowsum(dO o), from plain 16-byte
//    loads of o and dO. Then, like the forward: Q and dO once by TMA, K
//    and V tiles of QK keys (128, 64 and 32 at head dims 64, 128 and 256:
//    Q, dO and the ring fill shared memory) through an mbarrier ring; per
//    tile and consumer warpgroup (64 rows), S = Q K^T and dP = dO V^T
//    (wgmma, both operands K-major in shared memory), P and dS in the
//    accumulator registers, dS packed to bf16 as the A fragment of
//    dQ += dS K (wgmma from registers, K MN-major).
// 2. bwd_kv_kernel_sm90, a block per (key tile of KK = 128 keys, 64 at
//    head dim 256; batch x kv head), read from the plan's part table
//    (bwd_parts, one part a key tile: the longest causal walks first). K
//    and V once by TMA; a producer warp keeps the Q, dO, lse and Delta of
//    the next (head, 64-row tile) steps of the group's walk in a ring of
//    kStages. Each consumer warpgroup owns 64 keys (at head dim 256 the
//    block's 64, and half of dK's and dV's columns: see Cfg): S^T = K Q^T
//    and dP^T = V dO^T (wgmma), P^T and dS^T in registers, packed to bf16
//    as the A fragments of dV += P^T dO and dK += dS^T Q (Q and dO
//    MN-major, the same tiles). GQA sums in registers along the walk; no
//    block shares a key with another.
// Masks by index, where a tile straddles an edge only (causal, window,
// S != T, ragged edges): rows and keys out of range arrive as zeros by
// TMA. A warpgroup skips the products of a tile masked for all of its rows
// or keys but still releases the slot.
//
// Layout of the operand tiles as flash_attention.cu's bf16 forward lays
// them (csrc/sm90.cuh): slabs of 64 columns, 128-byte rows swizzled by TMA.
// One block an SM: 384 threads, consumers at 240 registers, the producer
// warpgroup at 24. TMA needs every base address and stride 16-byte
// aligned; the wrapper checks it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 384;          // consumers 0-255, producer 256-383
constexpr int kConsumers = 256;
constexpr int kStages = 2;
constexpr int W = 64;                  // bf16 columns a slab
constexpr int RB = 2 * W;              // bytes a slab row
constexpr int kLayout = sm90::layout_of(RB);
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kQueryRows = 128;        // the dQ pass's rows a block
// a full barrier (Q and dO, or K and V) and the ring's full and empty ones
constexpr int kBarBytes = 8 * (1 + 2 * kStages);

// a row of the part table (kernels/flash_attention.py::bwd_parts)
enum PartField {
  kTile, kRowTile, kRowTiles, kStepLo, kStepHi, kFirstPart, kParts,
  kPartInts = 8
};

// Tiles by head dim. The dQ pass: blocks of QR rows (64 a consumer
// warpgroup), key tiles of QK. The dK/dV pass: blocks of KK keys, steps of
// KR rows; below D 256 each warpgroup owns 64 of the keys and all of dK's
// and dV's columns; at D 256 (kSplit: 64 x 256 fp32 accumulators for dK
// and dV would not fit a warpgroup's registers) both own the block's 64
// keys, each half of the columns (DA), and both compute the same S^T and
// dP^T.
template <int D>
struct Cfg {
  static constexpr int kSlabs = D / W;
  static constexpr int QR = kQueryRows;
  static constexpr int QK = D == 64 ? 128 : D == 128 ? 64 : 32;
  static constexpr bool kSplit = D == 256;
  static constexpr int KK = kSplit ? 64 : 128;
  static constexpr int KR = 64;
  static constexpr int DA = kSplit ? D / 2 : D;
  __host__ __device__ static constexpr uint32_t bytes(int rows) {
    return rows * RB * kSlabs;
  }
  // dQ pass: Q, dO, kStages x (K, V)
  static constexpr size_t kSmemQ =
      1024 + 2 * bytes(QR) + 2 * kStages * bytes(QK) + kBarBytes;
  // dK/dV pass: K, V, kStages x (Q, dO, lse, Delta), barriers, dead rows
  static constexpr size_t kSmemKV = 1024 + 2 * bytes(KK) +
                                    kStages * (2 * bytes(KR) + 2 * KR * 4) +
                                    kBarBytes + D * 4;
  static_assert(kSmemQ <= 232448 && kSmemKV <= 232448, "past shared memory");
};

struct Params {
  const __nv_bfloat16 *o, *g;   // o and dO: Delta and the dead rows
  const float* lse;             // (B,H,S), natural units
  float* stats;                 // [2][B*H][S_pad]: lse (log2 units), Delta
  const int* parts;             // the part table, [n_parts][kPartInts]
  __nv_bfloat16 *dq, *dk, *dv;
  int B, H, KV, S, T, group, BH, S_pad, n_q, causal, window;
  long long ob, oh, os, gb, gh, gs;
  long long dqb, dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
  float scale, scale_log2, cap;
};

__device__ __forceinline__ bool live_key(long long i, long long j, int T,
                                         int causal, int window) {
  return j < T && (!causal || j <= i) && (window <= 0 || j > i - window);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// wgmma descriptor of k16 step kk of a K-major tile (the reduction runs
// over the head dim, its contiguous one) whose slabs are `slab` bytes apart
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, uint32_t slab,
                                           int kk) {
  return sm90::desc(tile + (kk / (W / 16)) * slab + (kk % (W / 16)) * 32, 16,
                    8 * RB, kLayout);
}

// ... of an MN-major tile (the reduction runs over its rows, the output
// over the head dim): rows 16 kk .. 16 kk + 15
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile,
                                            uint32_t slab, int kk) {
  return sm90::desc(tile + kk * 16 * RB, slab, 8 * RB, kLayout);
}

// S (or S^T) = A B^T over the head dim into an fp32 accumulator, both
// operands K-major; one commit group
template <int D, int N>
__device__ __forceinline__ void scores(float (&acc)[N], const uint8_t* a,
                                       uint32_t a_slab, const uint8_t* b,
                                       uint32_t b_slab) {
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = 0.f;
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss<0>(acc, kmajor(a, a_slab, kk), kmajor(b, b_slab, kk),
                      kk > 0);
  sm90::wgmma_commit();
}

// 2^x by the MUFU unit alone (exp2f adds range handling around it; a
// result below 2^-126 is flushed to 0, far under bf16's P)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x (an fp32 product q.k) -> P dcap, P = 2^(s log2 e - lse2) (0 where the
// pair is not live, under kMask), dcap = 1 - tanh^2 under the soft cap
template <bool kCap>
__device__ __forceinline__ float prob(float x, float lse2, bool live,
                                      const Params& p, float* pr) {
  float y, dcap = 1.f;
  if (kCap) {
    const float th = tanhf(x * p.scale / p.cap);
    y = p.cap * th * kLog2e;
    dcap = 1.f - th * th;
  } else {
    y = x * p.scale_log2;
  }
  const float pe = live ? ex2(y - lse2) : 0.f;
  *pr = pe;
  return pe * dcap;
}

// ---------------------------------------------------------------------------
// 1. dQ (and the rows' stats)
// ---------------------------------------------------------------------------

// the accumulator of a 64-row tile: element e of thread (warp w, lane l) is
// row 16 w + l / 4 + 8 ((e >> 1) & 1), column 8 (e >> 2) + 2 (l % 4) + (e & 1).
// S -> P dcap in place
template <int N, bool kCap, bool kMask>
__device__ __forceinline__ void probs_rows(float (&s)[N],
                                           const float (&lse2)[2],
                                           const Params& p, int row0, int k0,
                                           int lane) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int r = (e >> 1) & 1;
    const int j = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
    const bool live =
        !kMask || live_key(row0 + 8 * r, j, p.T, p.causal, p.window);
    float pr;
    s[e] = prob<kCap>(s[e], lse2[r], live, p, &pr);
  }
}

// dS = P dcap (dP - Delta of the row), packed to bf16 as the A fragments
// of a product over the tile's columns
template <int N>
__device__ __forceinline__ void dscores_rows(const float (&s)[N],
                                             const float (&dp)[N],
                                             const float (&delta)[2],
                                             uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const float dl = delta[(e >> 1) & 1];
    a[e / 8][(e % 8) / 2] =
        sm90::pack_bf16(s[e] * (dp[e] - dl), s[e + 1] * (dp[e + 1] - dl));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) bwd_q_kernel_sm90(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  constexpr int QR = C::QR, QK = C::QK;
  constexpr uint32_t kRowSlab = QR * RB, kKeySlab = QK * RB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sG = sQ + C::bytes(QR);
  uint8_t* sK = sG + C::bytes(QR);                  // [kStages] K slots
  uint8_t* sV = sK + kStages * C::bytes(QK);        // [kStages] V slots
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * C::bytes(QK));
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int L = blockIdx.x;
  const int q0 = (p.n_q - 1 - L / p.BH) * QR;
  const int h = L % p.BH % p.H, b = L % p.BH / p.H, kvh = h / p.group;
  // keys live for some row of this block: [k_lo, k_hi)
  const int q_last = min(q0 + QR, p.S) - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.T, q_last + 1) : p.T;
  const int n_lo = k_lo / QK;
  const int n_tiles = k_hi > k_lo ? (k_hi + QK - 1) / QK - n_lo : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    sm90::regs_dec<24>();
    if (threadIdx.x == kConsumers && n_tiles > 0) {
      sm90::tma_prefetch(&tq);
      sm90::tma_prefetch(&tg);
      sm90::tma_prefetch(&tk);
      sm90::tma_prefetch(&tv);
      sm90::mbar_arrive_expect_tx(q_full, 2 * C::bytes(QR));
#pragma unroll
      for (int s = 0; s < C::kSlabs; ++s) {
        sm90::tma_load_4d(sQ + s * kRowSlab, &tq, q_full, s * W, q0, h, b);
        sm90::tma_load_4d(sG + s * kRowSlab, &tg, q_full, s * W, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        sm90::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[st], 2 * C::bytes(QK));
        const int k0 = (n_lo + it) * QK;
#pragma unroll
        for (int s = 0; s < C::kSlabs; ++s) {
          sm90::tma_load_4d(sK + st * C::bytes(QK) + s * kKeySlab, &tk,
                            &full[st], s * W, k0, kvh, b);
          sm90::tma_load_4d(sV + st * C::bytes(QK) + s * kKeySlab, &tv,
                            &full[st], s * W, k0, kvh, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63
  sm90::regs_inc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int ra = q0 + 64 * wg;                  // first row of the group
  const int rb = min(ra + 63, p.S - 1);         // last row that is stored
  const int row0 = ra + 16 * warp + lane / 4;   // this thread's rows: +0, +8
  const long long bh = (long long)b * p.H + h;

  // the rows' stats: Delta from this thread's quarter of the columns (16
  // bytes at a time), summed over the 4 threads of a row
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    float sum = 0.f;
    if (i < p.S) {
      const __nv_bfloat16* op = p.o + b * p.ob + h * p.oh + i * p.os;
      const __nv_bfloat16* gp = p.g + b * p.gb + h * p.gh + i * p.gs;
#pragma unroll
      for (int u8 = 0; u8 < D / 32; ++u8) {
        const int c = (lane & 3) * (D / 4) + 8 * u8;
        const uint4 ov = *reinterpret_cast<const uint4*>(op + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(gp + c);
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
        const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 a = sm90::unpack_bf16(ow[u]), g = sm90::unpack_bf16(gw[u]);
          sum = fmaf(a.x, g.x, sum);
          sum = fmaf(a.y, g.y, sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[r] = sum;
    lse2[r] = i < p.S ? p.lse[bh * p.S + i] * kLog2e : INFINITY;
    if ((lane & 3) == 0) {
      p.stats[bh * p.S_pad + i] = lse2[r];
      p.stats[((long long)p.BH + bh) * p.S_pad + i] = sum;
    }
  }

  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  const uint8_t* sQw = sQ + 64 * wg * RB;
  const uint8_t* sGw = sG + 64 * wg * RB;
  if (n_tiles > 0) sm90::mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int k0 = (n_lo + it) * QK, k1 = k0 + QK - 1;
    // no live pair for this group's rows / every pair live
    const bool skip = ra > rb || k0 >= p.T || (p.causal && k0 > rb) ||
                      (p.window > 0 && k1 <= ra - p.window);
    const bool all_live = k1 < p.T && (!p.causal || k1 <= ra) &&
                          (p.window <= 0 || k0 > rb - p.window);
    sm90::mbar_wait(&full[st], (it / kStages) & 1);
    if (!skip) {
      const uint8_t* k_st = sK + st * C::bytes(QK);
      const uint8_t* v_st = sV + st * C::bytes(QK);
      float s[QK / 2], dp[QK / 2];
      scores<D>(s, sQw, kRowSlab, k_st, kKeySlab);
      scores<D>(dp, sGw, kRowSlab, v_st, kKeySlab);
      sm90::wgmma_wait<1>();   // S landed; P while dP runs
      sm90::fence_regs(s);
      if (p.cap != 0.f) {
        if (all_live) probs_rows<QK / 2, true, false>(s, lse2, p, row0, k0, lane);
        else probs_rows<QK / 2, true, true>(s, lse2, p, row0, k0, lane);
      } else {
        if (all_live) probs_rows<QK / 2, false, false>(s, lse2, p, row0, k0, lane);
        else probs_rows<QK / 2, false, true>(s, lse2, p, row0, k0, lane);
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      uint32_t da[QK / 16][4];
      dscores_rows(s, dp, delta, da);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QK / 16; ++kk)
        sm90::wgmma_rs<1>(acc, da[kk], mnmajor(k_st, kKeySlab, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
    }
    sm90::mbar_arrive(&empty[st]);
  }

  __nv_bfloat16* dqp = p.dq + b * p.dqb + h * p.dqh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i >= p.S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(dqp + i * p.dqs + c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * p.scale,
                                acc[4 * j + 2 * r + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV
// ---------------------------------------------------------------------------

// the transposed accumulator of a 64-key tile: element e of thread (warp
// w, lane l) is key 16 w + l / 4 + 8 ((e >> 1) & 1), query row 8 (e >> 2) +
// 2 (l % 4) + (e & 1) of the step, whose lse (log2 units) is at ls. S^T ->
// P^T dcap in place, and P^T packed to bf16 into pa (the A fragments of
// dV += P^T dO)
template <int N, bool kCap, bool kMask>
__device__ __forceinline__ void probs_cols(float (&s)[N], const float* ls,
                                           uint32_t (&pa)[N / 8][4],
                                           const Params& p, int key0, int i0,
                                           int lane) {
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const int col = 8 * (e >> 2) + 2 * (lane & 3);
    const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
    const int j = key0 + 8 * ((e >> 1) & 1);
    float pr[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool live =
          !kMask || live_key(i0 + col + c, j, p.T, p.causal, p.window);
      s[e + c] = prob<kCap>(s[e + c], c ? l2.y : l2.x, live, p, &pr[c]);
    }
    pa[e / 8][(e % 8) / 2] = sm90::pack_bf16(pr[0], pr[1]);
  }
}

// dS^T = P^T dcap (dP^T - Delta of the column), Delta at es, packed to bf16
// into da (the A fragments of dK += dS^T Q)
template <int N>
__device__ __forceinline__ void dscores_cols(const float (&s)[N],
                                             const float (&dp)[N],
                                             const float* es,
                                             uint32_t (&da)[N / 8][4],
                                             int lane) {
#pragma unroll
  for (int e = 0; e < N; e += 2) {
    const float2 dl = *reinterpret_cast<const float2*>(
        es + 8 * (e >> 2) + 2 * (lane & 3));
    da[e / 8][(e % 8) / 2] = sm90::pack_bf16(s[e] * (dp[e] - dl.x),
                                             s[e + 1] * (dp[e + 1] - dl.y));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) bwd_kv_kernel_sm90(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  constexpr int KK = C::KK, KR = C::KR;
  constexpr uint32_t kKeySlab = KK * RB, kRowSlab = KR * RB;
  constexpr uint32_t kStep = 2 * C::bytes(KR);     // Q and dO of a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + C::bytes(KK);
  uint8_t* sQG = sV + C::bytes(KK);                 // [kStages] (Q, dO)
  float* sLE = reinterpret_cast<float*>(sQG + kStages * kStep);
  // [kStages] (lse, Delta) of KR rows each
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sLE + kStages * 2 * KR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  float* dead = reinterpret_cast<float*>(empty + kStages);  // [D]

  const int kvb = blockIdx.x % (p.KV * p.B);
  const int part = blockIdx.x / (p.KV * p.B);
  const int kvh = kvb % p.KV, b = kvb / p.KV;
  const int* row = p.parts + part * kPartInts;
  const int t_lo = row[kRowTile], n_rows = row[kRowTiles];
  const int s_lo = row[kStepLo], n_steps = row[kStepHi] - s_lo;
  const int j0 = row[kTile] * KK;
  // step -> its head and first query row
  auto head_of = [&](int n) { return kvh * p.group + (s_lo + n) / n_rows; };
  auto row_of = [&](int n) { return (t_lo + (s_lo + n) % n_rows) * KR; };

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    sm90::regs_dec<24>();
    if (threadIdx.x == kConsumers && n_steps > 0) {
      sm90::tma_prefetch(&tq);
      sm90::tma_prefetch(&tg);
      sm90::tma_prefetch(&tk);
      sm90::tma_prefetch(&tv);
      sm90::mbar_arrive_expect_tx(kv_full, 2 * C::bytes(KK));
#pragma unroll
      for (int s = 0; s < C::kSlabs; ++s) {
        sm90::tma_load_4d(sK + s * kKeySlab, &tk, kv_full, s * W, j0, kvh, b);
        sm90::tma_load_4d(sV + s * kKeySlab, &tv, kv_full, s * W, j0, kvh, b);
      }
      for (int n = 0; n < n_steps; ++n) {
        const int st = n % kStages;
        const int h = head_of(n), i0 = row_of(n);
        sm90::mbar_wait(&empty[st], ((n / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[st], kStep + 2 * KR * 4);
        uint8_t* q_st = sQG + st * kStep;
#pragma unroll
        for (int s = 0; s < C::kSlabs; ++s) {
          sm90::tma_load_4d(q_st + s * kRowSlab, &tq, &full[st], s * W, i0,
                            h, b);
          sm90::tma_load_4d(q_st + C::bytes(KR) + s * kRowSlab, &tg,
                            &full[st], s * W, i0, h, b);
        }
        const long long bh = (long long)b * p.H + h;
        float* le = sLE + st * 2 * KR;
        sm90::bulk_load(le, p.stats + bh * p.S_pad + i0, KR * 4, &full[st]);
        sm90::bulk_load(le + KR, p.stats + (p.BH + bh) * p.S_pad + i0,
                        KR * 4, &full[st]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys j0 + 64 wg .. + 63 and columns
  // [0, D) of dK and dV, or (kSplit) keys j0 .. + 63 and columns
  // [DA wg, DA wg + DA)
  constexpr int DA = C::DA;
  sm90::regs_inc<240>();
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int jk0 = j0 + (C::kSplit ? 0 : 64 * wg), jk1 = jk0 + 63;
  const int key0 = jk0 + 16 * warp + lane / 4;  // this thread's keys: +0, +8
  const int col0 = C::kSplit ? DA * wg : 0;     // its first column
  const uint32_t col_slab = col0 / W * kRowSlab;
  float dv[DA / 2], dk[DA / 2];
#pragma unroll
  for (int e = 0; e < DA / 2; ++e) dv[e] = dk[e] = 0.f;
  const uint8_t* sKw = sK + (jk0 - j0) * RB;
  const uint8_t* sVw = sV + (jk0 - j0) * RB;
  if (n_steps > 0) sm90::mbar_wait(kv_full, 0);

  for (int n = 0; n < n_steps; ++n) {
    const int st = n % kStages;
    const int i0 = row_of(n), i1 = i0 + KR - 1;
    // no live pair for this group's keys / every pair live (rows past S
    // have lse +inf: P = 0)
    const bool skip = jk0 >= p.T || (p.causal && jk0 > i1) ||
                      (p.window > 0 && jk1 <= i0 - p.window);
    const bool all_live = jk1 < p.T && (!p.causal || jk1 <= i0) &&
                          (p.window <= 0 || jk0 > i1 - p.window);
    sm90::mbar_wait(&full[st], (n / kStages) & 1);
    if (!skip) {
      const uint8_t* q_st = sQG + st * kStep;
      const uint8_t* g_st = q_st + C::bytes(KR);
      const float* ls = sLE + st * 2 * KR;
      float s[KR / 2], dp[KR / 2];
      scores<D>(s, sKw, kKeySlab, q_st, kRowSlab);
      scores<D>(dp, sVw, kKeySlab, g_st, kRowSlab);
      sm90::wgmma_wait<1>();   // S^T landed; P^T and dV while dP^T runs
      sm90::fence_regs(s);
      uint32_t pa[KR / 16][4], da[KR / 16][4];
      if (p.cap != 0.f) {
        if (all_live) probs_cols<KR / 2, true, false>(s, ls, pa, p, key0, i0, lane);
        else probs_cols<KR / 2, true, true>(s, ls, pa, p, key0, i0, lane);
      } else {
        if (all_live) probs_cols<KR / 2, false, false>(s, ls, pa, p, key0, i0, lane);
        else probs_cols<KR / 2, false, true>(s, ls, pa, p, key0, i0, lane);
      }
      sm90::fence_regs(dv);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk)
        sm90::wgmma_rs<1>(dv, pa[kk], mnmajor(g_st + col_slab, kRowSlab, kk),
                          1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();   // dP^T landed; dS^T while dV runs
      sm90::fence_regs(dp);
      dscores_cols(s, dp, ls + KR, da, lane);
      sm90::fence_regs(dk);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk)
        sm90::wgmma_rs<1>(dk, da[kk], mnmajor(q_st + col_slab, kRowSlab, kk),
                          1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
    }
    sm90::mbar_arrive(&empty[st]);
  }

  // rows with no live key: dO / T (summed over the group's heads) to every
  // key's dV
  const long long dead_from =
      p.window > 0 ? (long long)p.T + p.window - 1 : p.S;
  if (dead_from < p.S) {
    for (int c = threadIdx.x; c < D; c += kConsumers) {
      float sum = 0.f;
      for (int gi = 0; gi < p.group; ++gi) {
        const __nv_bfloat16* gp =
            p.g + b * p.gb + (kvh * p.group + gi) * p.gh + c;
        for (long long i = dead_from; i < p.S; ++i)
          sum += __bfloat162float(gp[i * p.gs]);
      }
      dead[c] = sum / (float)p.T;
    }
    sm90::bar_sync(1, kConsumers);
#pragma unroll
    for (int e = 0; e < DA / 2; ++e)
      dv[e] += dead[col0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1)];
  }

  __nv_bfloat16* dkp = p.dk + b * p.dkb + kvh * p.dkh;
  __nv_bfloat16* dvp = p.dv + b * p.dvb + kvh * p.dvh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = key0 + 8 * r;
    if (j >= p.T) continue;
#pragma unroll
    for (int jj = 0; jj < DA / 8; ++jj) {
      const int c = col0 + 8 * jj + 2 * (lane & 3), e = 4 * jj + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dkp + j * p.dks + c) =
          __floats2bfloat162_rn(dk[e] * p.scale, dk[e + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + j * p.dvs + c) =
          __floats2bfloat162_rn(dv[e], dv[e + 1]);
    }
  }
}

// ---------------------------------------------------------------------------

// (batch, head, sequence) strides in elements of the TMA-loaded tensors
struct Strides {
  long long q[3], k[3], v[3], g[3];
};

// a (D, rows, heads, B) bf16 tensor map of boxes of 64 columns x `box` rows
cudaError_t encode(CUtensorMap* map, const void* base, int D, int rows,
                   int heads, int B, const long long (&st)[3], int box) {
  constexpr cuuint64_t E = sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {st[2] * E, st[1] * E, st[0] * E};
  return sm90::encode_bf16_4d(map, base, dims, strides, W, box);
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const Strides& st, const Params& p, int n_parts,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap q_rows, g_rows, k_keys, v_keys;   // the dQ pass's boxes
  CUtensorMap q_step, g_step, k_tile, v_tile;   // the dK/dV pass's
  const void* g = p.g;
  cudaError_t err = encode(&q_rows, q, D, p.S, p.H, p.B, st.q, C::QR);
  if (err == cudaSuccess) err = encode(&g_rows, g, D, p.S, p.H, p.B, st.g, C::QR);
  if (err == cudaSuccess) err = encode(&k_keys, k, D, p.T, p.KV, p.B, st.k, C::QK);
  if (err == cudaSuccess) err = encode(&v_keys, v, D, p.T, p.KV, p.B, st.v, C::QK);
  if (err == cudaSuccess) err = encode(&q_step, q, D, p.S, p.H, p.B, st.q, C::KR);
  if (err == cudaSuccess) err = encode(&g_step, g, D, p.S, p.H, p.B, st.g, C::KR);
  if (err == cudaSuccess) err = encode(&k_tile, k, D, p.T, p.KV, p.B, st.k, C::KK);
  if (err == cudaSuccess) err = encode(&v_tile, v, D, p.T, p.KV, p.B, st.v, C::KK);
  if (err == cudaSuccess) err = allow_smem(bwd_q_kernel_sm90<D>, C::kSmemQ);
  if (err == cudaSuccess) err = allow_smem(bwd_kv_kernel_sm90<D>, C::kSmemKV);
  if (err != cudaSuccess) return err;
  bwd_q_kernel_sm90<D><<<p.n_q * p.BH, kThreads, C::kSmemQ, stream>>>(
      q_rows, g_rows, k_keys, v_keys, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_kv_kernel_sm90<D><<<n_parts * p.KV * p.B, kThreads, C::kSmemKV,
                          stream>>>(q_step, g_step, k_tile, v_tile, p);
  return cudaGetLastError();
}

}  // namespace

// bf16 q (B,H,S,D), k and v (B,KV,T,D), o and dO like q, dq, dk and dv of
// the same shapes written whole (every base address and batch, head and
// sequence stride 16-byte aligned, the head dim contiguous; D 64, 128 or
// 256); lse (B,H,S) fp32 contiguous; stats an fp32 scratch of 2 x B*H x
// S_pad (S_pad: S rounded up to 128); the plan's part table of n_parts rows
// of kPartInts int32, one part a key tile of Cfg<D>::KK keys.
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* g, void* dq, void* dk, void* dv,
    void* stats, const void* parts, int B, int H, int KV, int S, int Tn,
    int D, long long qb, long long qh, long long qs, long long kb,
    long long kh, long long ks, long long vb, long long vh, long long vs,
    long long ob, long long oh, long long os, long long gb, long long gh,
    long long gs, long long dqb, long long dqh, long long dqs, long long dkb,
    long long dkh, long long dks, long long dvb, long long dvh,
    long long dvs, float scale, float cap, int causal, int window,
    int n_parts, void* stream) {
  const Strides st{{qb, qh, qs}, {kb, kh, ks}, {vb, vh, vs}, {gb, gh, gs}};
  Params p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.lse = static_cast<const float*>(lse);
  p.stats = static_cast<float*>(stats);
  p.parts = static_cast<const int*>(parts);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.B = B, p.H = H, p.KV = KV, p.S = S, p.T = Tn, p.group = H / KV;
  p.BH = B * H;
  p.n_q = (S + kQueryRows - 1) / kQueryRows;
  p.S_pad = kQueryRows * p.n_q;
  p.causal = causal, p.window = window;
  p.ob = ob, p.oh = oh, p.os = os, p.gb = gb, p.gh = gh, p.gs = gs;
  p.dqb = dqb, p.dqh = dqh, p.dqs = dqs, p.dkb = dkb, p.dkh = dkh;
  p.dks = dks, p.dvb = dvb, p.dvh = dvh, p.dvs = dvs;
  p.scale = scale, p.scale_log2 = scale * kLog2e, p.cap = cap;
  const auto s = static_cast<cudaStream_t>(stream);
  if (parts == nullptr || n_parts < 1 || H % KV) return cudaErrorInvalidValue;
  if (D == 64) return static_cast<int>(launch<64>(q, k, v, st, p, n_parts, s));
  if (D == 128)
    return static_cast<int>(launch<128>(q, k, v, st, p, n_parts, s));
  if (D == 256)
    return static_cast<int>(launch<256>(q, k, v, st, p, n_parts, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
