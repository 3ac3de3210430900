// flash_attention: online-softmax attention with GQA, causal and sliding
// window masks and a logit soft cap, forward (the fp32 backward is
// flash_attention_bwd.cu).
//
// Replaces the Pallas kernel _attn_kernel (:23) of
// src/repro/kernels/flash_attention.py (flash_attention, pallas_call at
// :99).
//
//   o[b,h,i] = sum_j softmax_j(mask(cap*tanh(scale*q_i.k_j/cap))) v_j
//
// with q (B,H,S,D), k and v (B,KV,T,D), kv head h / (H/KV), and the mask by
// index: j < T, then causal j <= i, then window j > i - window. A row with
// no live key at all (only with a window, for i >= T + window - 1) is the
// mean of v over the T keys, as the dense oracle's uniform softmax over
// its -1e30 fill gives it. (The TPU kernel's value there depends on its
// tiling; see the port's notes.)
//
// What bounds it on the card: 4*D operations per live (row, key) pair (two
// products), at 67 TFLOP/s on the CUDA cores in fp32 or 989 TFLOP/s on the
// bf16 tensor cores; the bytes of q, k, v and o for short rows (the
// encoder's S = T = 64 is bound by bytes).
//
// Two kernels, by input type:
//
// * fp32: flash_attention_kernel, the parity path: fp32 FMAs on the CUDA
//   cores (no tensor cores, by the port's numerics rule), described here.
// * bf16: flash_attention_kernel_sm90 (after the fp32 kernel): wgmma on
//   the tensor cores for both products, fed by TMA through an mbarrier
//   ring; its design notes stand beside it. Q.K^T of bf16 inputs is exact
//   in the fp32 accumulator, as the reference's fp32 product is; the one
//   new rounding is p to bf16 before P.V (FlashAttention-2/3 and SDPA's
//   flash backend do the same).
//
// The fp32 kernel: a block of 128 threads owns 64 query rows of one (b, h)
// and walks the kv tiles that hold a live key for any of its rows (tiles
// wholly masked for the block are skipped, as the TPU kernel skips them).
// Thread (ty, tx) = (tid / 8, tid % 8) owns rows 4 ty .. 4 ty + 3: their
// scores for keys tx + 8 k of each tile and their output columns
// 4 (tx + 8 m) .. + 3, so the eight threads of a row group are eight
// neighbouring lanes of one warp.
//   * Loads: 16-byte cp.async (4-byte where an address or stride is not
//     16-byte aligned) of Q once and of K and V per tile, double-buffered:
//     tile n + 1 is in flight while tile n computes. Rows out of range are
//     zero-filled by the copy.
//   * Scores: a 4 x (BK / 8) register tile, fmaf over D in order, from
//     16-byte shared loads (Q rows broadcast to the row group; Q and K rows
//     XOR-swizzled by 16-byte chunk, so the four row groups of a warp, and
//     the eight keys of a row group, read distinct banks): one shared load
//     per 8 FMAs (per 5 at D 256).
//   * Softmax in registers: scale, soft cap (tanhf) and the index mask,
//     then the row max over the row group by three xor shuffles; running
//     max m and this thread's share of the running sum l in fp32, p =
//     expf(s - m) (a row whose keys are all masked so far uses 0 as its
//     reference, so masked keys add exactly 0); the shares of l are summed
//     by shuffles at the end.
//   * P.V: p goes once through shared memory (key-major, swizzled), read
//     back as one 16-byte load per key for the thread's four rows, with
//     D / 32 16-byte loads of V per key: at most one shared load per 4
//     FMAs. O stays in registers, rescaled by expf(m_old - m_new).
// Two barriers per tile besides the one that releases the tile's buffers.
// expf and tanhf, not the fast intrinsics, so that fp32 results stay within
// 2e-5 of the dense oracle. Tiles (BK keys; shared memory; blocks per SM):
// D 32: 32, 32 KB; D 64: 32, 56 KB, 4 blocks; D 128: 32, 104 KB, 2 blocks;
// D 256: 16, 132 KB, 1 block.
// Strides are passed for every tensor's batch, head and sequence axes (the
// head dim is contiguous), so the (B,S,H,D) projections of the model need
// no copy. Any head dim D from 1 to 256 runs on the kernel built for the
// next of 32, 64, 128 and 256: the loads zero-fill the columns past D (as
// they zero-fill rows past S and T), which add exactly nothing to the fmaf
// chains, and the stores skip them. For training the kernel also writes
// each row's log-sum-exp m + log(l) (B,H,S), which the backward
// (flash_attention_bwd.cu) recomputes P from; given a null pointer it
// writes nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_fp32.cuh"
#include "sm90.cuh"

namespace {

using attn::copy_commit;
using attn::copy_wait;
using attn::kThreads;
using attn::live_key;
using attn::load_rows;

constexpr int kBQ = 64;              // query rows per block
constexpr int kRows = 4;             // query rows per thread
constexpr int kGroup = 8;            // threads per row group

template <int D>
struct Tile {
  static constexpr int BK = D <= 128 ? 32 : 16;   // keys per kv tile
  static constexpr int kKeys = BK / kGroup;       // score columns per thread
  static constexpr int kDimChunks = D / 32;       // output chunks per thread
  static constexpr int kMinBlocks = D <= 64 ? 4 : D == 128 ? 2 : 1;
  static constexpr size_t kSmemFloats =
      size_t(kBQ) * D + 4 * size_t(BK) * D + size_t(BK) * kBQ;
};

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// D: the built head dim (32, 64, 128, 256); dim <= D the tensors' own,
// whose columns past dim are loaded as zeros and never stored. lse, when
// not null, gets each row's log-sum-exp m + log(l) at (b * H + h) * S + i
// (-inf for a row with no live key).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int S, int Tn, int dim,
                           int group, Strides st, float scale, float cap,
                           int causal, int window, int vec) {
  using Tl = Tile<D>;
  constexpr int BK = Tl::BK, KK = Tl::kKeys, DC = Tl::kDimChunks;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][D]
  float* Ks = Qs + kBQ * D;                     // [2][BK][D], swizzled
  float* Vs = Ks + 2 * BK * D;                  // [2][BK][D], swizzled
  float* Ps = Vs + 2 * BK * D;                  // [BK][kBQ]: p, key-major

  const int tid = threadIdx.x, tx = tid % kGroup, ty = tid / kGroup;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;
  T* op = o + b * st.ob + h * st.oh;

  // keys live for some row of this block: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Tn, q_last + 1) : Tn;
  const int n_lo = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - n_lo : 0;

  // groups: {Q, tile 0}, {tile 1}, then one per tile (some empty), so that
  // tile n has landed once at most one later group is pending
  if (n_tiles > 0) {
    load_rows<D>(Qs, qp, st.qs, q0, kBQ, S, dim, 2, vec);
    load_rows<D>(Ks, kp, st.ks, n_lo * BK, BK, Tn, dim, 0, vec);
    load_rows<D>(Vs, vp, st.vs, n_lo * BK, BK, Tn, dim, 0, vec);
  }
  copy_commit();
  if (n_tiles > 1) {
    load_rows<D>(Ks + BK * D, kp, st.ks, (n_lo + 1) * BK, BK, Tn, dim, 0,
                 vec);
    load_rows<D>(Vs + BK * D, vp, st.vs, (n_lo + 1) * BK, BK, Tn, dim, 0,
                 vec);
  }
  copy_commit();

  float acc[kRows][4 * DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4 * DC; ++j) acc[i][j] = 0.f;
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1, k0 = (n_lo + it) * BK;
    const float* Kt = Ks + buf * BK * D;
    const float* Vt = Vs + buf * BK * D;
    copy_wait<1>();
    __syncthreads();  // tile it (and Q) have landed for every thread

    // scores: rows 4 ty + i, keys tx + 8 c; Q row 4 ty + i keeps chunk d
    // at d ^ (ty % 8), K row tx + 8 c at d ^ tx
    float s[kRows][KK];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < KK; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D / 4; ++d) {
      float4 qv[kRows], kv[KK];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * D +
                                                 4 * (d ^ (ty & 7)));
#pragma unroll
      for (int c = 0; c < KK; ++c)
        kv[c] = *reinterpret_cast<const float4*>(Kt + (tx + 8 * c) * D +
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

    // scale, soft cap, mask; online softmax over the row group
    float alpha[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < KK; ++c) {
        float x = s[i][c] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);  // as `if softcap:`
        s[i][c] = live_key(row, k0 + tx + 8 * c, Tn, causal, window)
                      ? x : -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 1; off < kGroup; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float ref = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = expf(m[i] - ref);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KK; ++c) {
        s[i][c] = expf(s[i][c] - ref);
        sum += s[i][c];
      }
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    // p, key-major: key tx + 8 c keeps its rows' chunk ty at ty ^ tx
#pragma unroll
    for (int c = 0; c < KK; ++c)
      *reinterpret_cast<float4*>(Ps + (tx + 8 * c) * kBQ + 4 * (ty ^ tx)) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 4 * DC; ++j) acc[i][j] *= alpha[i];
    __syncthreads();  // p is complete

    // o += p v: key c's p for rows 4 ty.. at chunk ty ^ (c % 8); V row c
    // keeps chunk tx + 8 j at (tx + 8 j) ^ (c % 8)
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(
          Ps + c * kBQ + 4 * (ty ^ (c & 7)));
      const float pr[kRows] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(
            Vt + c * D + 4 * ((tx + 8 * j) ^ (c & 7)));
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][4 * j] = fmaf(pr[i], vv.x, acc[i][4 * j]);
          acc[i][4 * j + 1] = fmaf(pr[i], vv.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(pr[i], vv.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(pr[i], vv.w, acc[i][4 * j + 3]);
        }
      }
    }
    __syncthreads();  // this tile's K, V and p are read
    if (it + 2 < n_tiles) {
      load_rows<D>(Ks + buf * BK * D, kp, st.ks, k0 + 2 * BK, BK, Tn, dim, 0,
                   vec);
      load_rows<D>(Vs + buf * BK * D, vp, st.vs, k0 + 2 * BK, BK, Tn, dim, 0,
                   vec);
    }
    copy_commit();
  }
  copy_wait<0>();
  __syncthreads();

  // rows with no live key (i >= T + window - 1) take the mean of v
  const long long dead_from = window > 0 ? (long long)Tn + window - 1 : -1;
  const bool any_dead = window > 0 && q_last >= dead_from;
  if (any_dead) {
    for (int c = tid; c < D; c += kThreads) {
      float sum = 0.f;
      if (c < dim)
        for (int j = 0; j < Tn; ++j) sum += vp[j * st.vs + c];
      Ks[c] = sum / (float)Tn;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int off = 1; off < kGroup; off <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int qi = q0 + 4 * ty + i;
    if (qi >= S) continue;
    const bool dead = any_dead && qi >= dead_from;
    if (lse != nullptr && tx == 0)
      lse[((long long)b * gridDim.y + h) * S + qi] = m[i] + logf(l[i]);
    const float inv_l = dead ? 0.f : 1.f / l[i];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = 4 * (tx + 8 * j);
      if (c >= dim) continue;
      float4 out = make_float4(acc[i][4 * j] * inv_l, acc[i][4 * j + 1] * inv_l,
                               acc[i][4 * j + 2] * inv_l,
                               acc[i][4 * j + 3] * inv_l);
      if (dead) out = make_float4(Ks[c], Ks[c + 1], Ks[c + 2], Ks[c + 3]);
      T* dst = op + qi * st.os + c;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = out;
      } else {
        const float w[4] = {out.x, out.y, out.z, out.w};
        for (int u = 0; u < 4 && c + u < dim; ++u) dst[u] = w[u];
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KV, int S, int Tn, int dim,
                   const Strides& st, float scale, float cap, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * Tile<D>::kSmemFloats;
  auto kern = flash_attention_kernel<float, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  const void* ptrs[4] = {q, k, v, o};
  const long long strides[12] = {st.qb, st.qh, st.qs, st.kb, st.kh, st.ks,
                                 st.vb, st.vh, st.vs, st.ob, st.oh, st.os};
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Tn, dim,
      H / KV, st, scale, cap, causal, window,
      attn::aligned16(ptrs, 4, strides, 12, dim));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: flash_attention_kernel_sm90 (wgmma, TMA, an mbarrier ring)
// ---------------------------------------------------------------------------
//
// Work per block: 128 query rows of one (b, h). Three warpgroups: two
// consumers of 64 rows each, and a producer whose first thread issues every
// TMA load (its other warps return at once; the warpgroup hands its
// registers to the consumers with setmaxnreg). The grid is 1-D and walks
// the q tiles last to first across all (b, h): under a causal mask the
// tiles that carry the most live keys start first and the light ones fill
// the tail.
//
// Loads: the Q tile once; K and V tiles of BK keys through a ring of
// kStages slots (full barrier: the TMA bytes have landed; empty barrier:
// all 256 consumer threads are done with the slot). Only the kv tiles in
// [k_lo, k_hi) are walked, as in the fp32 kernel. Rows and keys out of
// range arrive as zeros and the index mask decides what is live; padded
// query rows are never stored.
//
// Per tile and consumer warpgroup: S = Q.K^T (wgmma m64nBKk16, both
// operands K-major in shared memory, D/16 steps); then per score, in
// registers: scale, soft cap (tanhf), the index mask only where the tile
// straddles an edge, and p = exp2 of the score in log2 units against the
// running row max (0 while every key of the row so far is masked, as in
// the fp32 kernel), the row max reduced over the 4 threads that share a
// row by shuffles; O is rescaled, and P, rounded to bf16 in registers,
// feeds O += P.V (wgmma m64nDk16, A from registers, V MN-major from shared
// memory, trans-b). The row sums stay per thread (fp32, unrounded p) until
// the end. O stays in registers for the whole walk. A warpgroup skips the
// products of a tile masked for all of its rows, but still waits for the
// slot and releases it (the ring's phases count every tile).
//
// Tiles: BK = 128 for D <= 128, 64 at D = 256, where Q is 64 KB and each
// K + V stage 64 KB (192 KB in all) and the O accumulator 128 fp32
// registers a thread: the consumers take 232 registers, the producer 40.
// TMA needs the base address and every stride 16-byte aligned; the wrapper
// checks it.

namespace tc {

constexpr int kBQ = 128;               // query rows per block
constexpr int kThreads = 384;          // consumers 0-255, producer 256-383
constexpr int kConsumerThreads = 256;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int BK = D >= 256 ? 64 : 128;   // keys per kv tile
  static constexpr int W = D >= 64 ? 64 : D;       // columns per slab
  static constexpr int RB = 2 * W;                 // bytes per slab row
  static constexpr int kSlabs = D / W;
  static constexpr int kKPerSlab = W / 16;         // k16 steps per slab
  static constexpr int kLayout = sm90::layout_of(RB);
  static constexpr uint32_t kQSlab = kBQ * RB;
  static constexpr uint32_t kKVSlab = BK * RB;
  static constexpr uint32_t kQBytes = kQSlab * kSlabs;
  static constexpr uint32_t kKVBytes = kKVSlab * kSlabs;  // K (or V), 1 slot
  static constexpr int kBarBytes = 64;
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes +
                                  kBarBytes + 2 * D * sizeof(float);
};

struct Params {
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // (B,H,S) row log-sum-exp in natural units, or null
  int S, T, H, group, BH, n_q;
  long long vb, vh, vs, ob, oh, os;
  float scale, scale_log2, cap;
  int causal, window;
};

// scale, soft cap and mask of one tile's scores, in log2 units; the row
// maxima of this thread's two rows
template <int N, bool kCap, bool kMask>
__device__ __forceinline__ void score_tile(float (&s)[N], float (&mx)[2],
                                           const Params& p, int row0, int k0,
                                           int lane) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int r = (e >> 1) & 1;
    float x;
    if (kCap) {
      x = s[e] * p.scale;
      x = p.cap * tanhf(x / p.cap) * kLog2e;
    } else {
      x = s[e] * p.scale_log2;
    }
    if (kMask) {
      const int i = row0 + 8 * r;
      const int j = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      if (!live_key(i, j, p.T, p.causal, p.window)) x = -INFINITY;
    }
    s[e] = x;
    mx[r] = fmaxf(mx[r], x);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel_sm90(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + C::kQBytes;               // [kStages] K slots
  uint8_t* sV = sK + kStages * C::kKVBytes;    // [kStages] V slots
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * C::kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  float* mean_v = reinterpret_cast<float*>(q_full + C::kBarBytes / 8);

  const int L = blockIdx.x;
  const int q0 = (p.n_q - 1 - L / p.BH) * kBQ;
  const int h = L % p.BH % p.H, b = L % p.BH / p.H, kvh = h / p.group;
  // keys live for some row of this block: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, p.S) - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int k_hi = p.causal ? min(p.T, q_last + 1) : p.T;
  const int n_lo = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - n_lo : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerThreads);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer
    sm90::regs_dec<40>();
    if (threadIdx.x == kConsumerThreads && n_tiles > 0) {
      sm90::tma_prefetch(&tq);
      sm90::tma_prefetch(&tk);
      sm90::tma_prefetch(&tv);
      sm90::mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int s = 0; s < C::kSlabs; ++s)
        sm90::tma_load_4d(sQ + s * C::kQSlab, &tq, q_full, s * C::W, q0, h,
                          b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        sm90::mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[st], 2 * C::kKVBytes);
        const int k0 = (n_lo + it) * BK;
#pragma unroll
        for (int s = 0; s < C::kSlabs; ++s) {
          sm90::tma_load_4d(sK + st * C::kKVBytes + s * C::kKVSlab, &tk,
                            &full[st], s * C::W, k0, kvh, b);
          sm90::tma_load_4d(sV + st * C::kKVBytes + s * C::kKVSlab, &tv,
                            &full[st], s * C::W, k0, kvh, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63
    sm90::regs_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int ra = q0 + 64 * wg;                  // first row of the group
    const int rb = min(ra + 63, p.S - 1);         // last row that is stored
    const int row0 = ra + 16 * warp + lane / 4;   // this thread's rows: +0, +8
    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    const uint64_t dq = sm90::desc(sQ + 64 * wg * C::RB, 16, 8 * C::RB,
                                   C::kLayout);
    if (n_tiles > 0) sm90::mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const int k0 = (n_lo + it) * BK;
      const int k1 = k0 + BK - 1;
      // no live pair for this group's rows / every pair live
      const bool skip = ra > rb || k0 >= p.T || (p.causal && k0 > rb) ||
                        (p.window > 0 && k1 <= ra - p.window);
      const bool all_live = k1 < p.T && (!p.causal || k1 <= ra) &&
                            (p.window <= 0 || k0 > rb - p.window);
      sm90::mbar_wait(&full[st], (it / kStages) & 1);
      if (!skip) {
        const uint64_t dk = sm90::desc(sK + st * C::kKVBytes, 16, 8 * C::RB,
                                       C::kLayout);
        float s[BK / 2];
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
        sm90::fence_regs(s);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk % C::kKPerSlab) * 32;   // bytes in the row
          sm90::wgmma_ss<0>(
              s, dq + (((kk / C::kKPerSlab) * C::kQSlab + off) >> 4),
              dk + (((kk / C::kKPerSlab) * C::kKVSlab + off) >> 4), kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);

        float mx[2] = {-INFINITY, -INFINITY};
        if (p.cap != 0.f) {
          if (all_live) score_tile<BK / 2, true, false>(s, mx, p, row0, k0, lane);
          else score_tile<BK / 2, true, true>(s, mx, p, row0, k0, lane);
        } else {
          if (all_live) score_tile<BK / 2, false, false>(s, mx, p, row0, k0, lane);
          else score_tile<BK / 2, false, true>(s, mx, p, row0, k0, lane);
        }
        float ref[2], alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          ref[r] = m_new == -INFINITY ? 0.f : m_new;
          alpha[r] = exp2f(m[r] - ref[r]);
          m[r] = m_new;
        }
        uint32_t pa[BK / 16][4];
        float ls[2] = {0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = 8 * kk + 2 * u, r = u & 1;
            const float p0 = exp2f(s[e] - ref[r]);
            const float p1 = exp2f(s[e + 1] - ref[r]);
            ls[r] += p0 + p1;
            pa[kk][u] = sm90::pack_bf16(p0, p1);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

        const uint64_t dv = sm90::desc(sV + st * C::kKVBytes, C::kKVSlab,
                                       8 * C::RB, C::kLayout);
        sm90::fence_regs(o);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          sm90::wgmma_rs<1>(o, pa[kk], dv + ((kk * 16 * C::RB) >> 4), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
      }
      sm90::mbar_arrive(&empty[st]);
    }

    // rows with no live key (i >= T + window - 1) take the mean of v
    const long long dead_from =
        p.window > 0 ? (long long)p.T + p.window - 1 : (long long)p.S;
    const bool any_dead = p.window > 0 && ra <= rb && rb >= dead_from;
    float* mv = mean_v + wg * D;
    if (any_dead) {
      const __nv_bfloat16* vp = p.v + b * p.vb + kvh * p.vh;
      for (int c = t; c < D; c += 128) {
        float sum = 0.f;
        for (int j = 0; j < p.T; ++j) sum += __bfloat162float(vp[j * p.vs + c]);
        mv[c] = sum / (float)p.T;
      }
      sm90::bar_sync(1 + wg, 128);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    __nv_bfloat16* op = p.o + b * p.ob + h * p.oh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row0 + 8 * r;
      if (i >= p.S) continue;
      const bool dead = any_dead && i >= dead_from;
      // m and the sums are in log2 units (p = 2^(s log2 e - m)), so the
      // natural log-sum-exp the backward recomputes P = exp(s - lse) from
      // is (m + log2 l) ln 2; -inf for a row with no live key (m = -inf,
      // l = 0), as the fp32 kernel writes it
      if (p.lse != nullptr && (lane & 3) == 0)
        p.lse[((long long)b * p.H + h) * p.S + i] =
            (m[r] + log2f(l[r])) * kLn2;
      const float inv_l = dead ? 0.f : 1.f / l[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * (lane & 3);
        const float x0 = dead ? mv[c] : o[4 * j + 2 * r] * inv_l;
        const float x1 = dead ? mv[c + 1] : o[4 * j + 2 * r + 1] * inv_l;
        *reinterpret_cast<__nv_bfloat162*>(op + i * p.os + c) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KV, int S, int Tn,
                   const Strides& st, float scale, float cap, int causal,
                   int window, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr cuuint64_t E = sizeof(__nv_bfloat16);
  CUtensorMap tq, tk, tv;
  const cuuint64_t dq[4] = {D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t dkv[4] = {D, (cuuint64_t)Tn, (cuuint64_t)KV,
                             (cuuint64_t)B};
  const cuuint64_t sq[3] = {st.qs * E, st.qh * E, st.qb * E};
  const cuuint64_t sk[3] = {st.ks * E, st.kh * E, st.kb * E};
  const cuuint64_t sv[3] = {st.vs * E, st.vh * E, st.vb * E};
  cudaError_t err = sm90::encode_bf16_4d(&tq, q, dq, sq, C::W, kBQ);
  if (err == cudaSuccess)
    err = sm90::encode_bf16_4d(&tk, k, dkv, sk, C::W, C::BK);
  if (err == cudaSuccess)
    err = sm90::encode_bf16_4d(&tv, v, dkv, sv, C::W, C::BK);
  if (err != cudaSuccess) return err;
  auto kern = flash_attention_kernel_sm90<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const int n_q = (S + kBQ - 1) / kBQ;
  const Params p{static_cast<const __nv_bfloat16*>(v),
                 static_cast<__nv_bfloat16*>(o), lse, S, Tn, H, H / KV,
                 B * H, n_q,
                 st.vb, st.vh, st.vs, st.ob, st.oh, st.os, scale,
                 scale * kLog2e, cap, causal, window};
  kern<<<n_q * B * H, kThreads, C::kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace tc

cudaError_t launch_fp32(int D, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int H, int KV, int S,
                        int Tn, const Strides& st, float scale, float cap,
                        int causal, int window, cudaStream_t stream) {
#define FA_CASE(DIM)                                                       \
  case DIM:                                                                \
    return launch<DIM>(q, k, v, o, lse, B, H, KV, S, Tn, D, st, scale, cap, \
                       causal, window, stream);
  switch (attn::built_dim(D)) {
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

cudaError_t launch_bf16(int D, const void* q, const void* k, const void* v,
                        void* o, float* lse, int B, int H, int KV, int S,
                        int Tn, const Strides& st, float scale, float cap,
                        int causal, int window, cudaStream_t stream) {
#define FA_CASE(DIM)                                                        \
  case DIM:                                                                 \
    return tc::launch<DIM>(q, k, v, o, lse, B, H, KV, S, Tn, st, scale,     \
                           cap, causal, window, stream);
  switch (D) {
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// fp32 q, k, v, o: the SIMT kernel, any head dim D in [1, 256]; lse
// (B,H,S) or null
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int S, int Tn, int D, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long vb, long long vh,
    long long vs, long long ob, long long oh, long long os, float scale,
    float cap, int causal, int window, void* lse, void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  return static_cast<int>(launch_fp32(
      D, q, k, v, o, static_cast<float*>(lse), B, H, KV, S, Tn, st, scale,
      cap, causal, window, static_cast<cudaStream_t>(stream)));
}

// bf16 q, k, v, o: the Hopper kernel (base addresses and strides 16-byte
// aligned, the head dim contiguous; D 32, 64, 128 or 256); lse (B,H,S)
// float32 or null
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int S, int Tn, int D, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long vb, long long vh,
    long long vs, long long ob, long long oh, long long os, float scale,
    float cap, int causal, int window, void* lse, void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  return static_cast<int>(launch_bf16(
      D, q, k, v, o, static_cast<float*>(lse), B, H, KV, S, Tn, st, scale,
      cap, causal, window, static_cast<cudaStream_t>(stream)));
}
