// Mamba-2 chunked SSD scan, backward, for sm_90a: the gradient of ssd_scan.cu's function for
// bf16 x, B and C at P 64, N 128 and chunks of 128 (mamba2-1.3b's training shape), on wgmma
// fed by TMA. ssd_scan_bwd.cu keeps fp32 and every other shape; the wrapper chooses by the
// forward's rule (kernels/ssd_scan.py::uses_sm90).
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// src/repro/models/ssd.py:65-126::ssd_chunked, and this is that gradient with the mask on
// the exponent (only pairs j <= i are formed, so every exponential is at most 1). Inputs and
// outputs as ssd_scan_bwd.cu's, whose header sets out the formulas: per chunk c of L steps,
// with H_{c-1} the state entering it, dH_c the gradient reaching the state after it, CB_ij =
// C_i . B_j, E_ij = e^{cum_i - cum_j} (j <= i), eo_j = e^{cum_L - cum_j}:
//
//   dCB = (dy x^T) E dt_j                  M = CB E
//   bracket = M^T dy + eo (B dH^T)         dx = dt bracket, ddt = rowsum(x bracket)
//   dC = dCB B + e^{cum} (dy H)            dB = dCB^T C + eo dt (x dH)     (over the heads)
//   dcum = rowsum(dCB CB) + C.(e^cum dy H) - colsum(dCB CB) - U   (+ the last step's terms)
//
// Numerics. Every product runs on bf16 wgmma with fp32 accumulation and is exact: an fp32
// operand goes in as three bf16 pieces (sm90::split3) against a bf16 one (x, B, C). Two
// products have two fp32 operands, M^T dy and dy H: both are split, and the six pairs of
// pieces whose products reach fp32's precision are kept (hi hi, hi mid, mid hi, hi lo, mid
// mid, lo hi; tests/test_torch_ssd_bwd_sm90.py shows a one-sided split misses the
// tolerance). Every sum has a fixed order and there are no atomics: results repeat bitwise.
//
// Bound: operations. ~207 GFLOP at mamba2-1.3b's B 2, S 4096, H 64 as chip_smoke.py counts
// them (bf16 rate, a product with an fp32 operand counted 3x), 0.209 ms at 989 TFLOP/s.
// This design issues ~310 GFLOP of wgmma (the states walk both ways, the six-term products,
// dCB B and dCB^T C per head; 0.31 ms at that rate) and moves ~2 GB, mostly the pieces
// scratches below (0.6 ms at 3.35 TB/s): the walks are bound by those bytes, the chunk
// kernels by no one part (knock-outs, tools/ssd_bwd_variants.py).
//
// Six launches:
// 1. ssd_bwd_cb_sm90, a block per (batch, chunk): CB = C B^T once (exact bf16 products),
//    written as CB and CB^T to two (B, nc, L, L) fp32 scratches (4.2 MB each at mamba2,
//    read back from L2 by the chunk kernels in their accumulator layouts).
// 2. ssd_bwd_states_sm90<false>, a block per (batch, head): H^T walks the chunks forwards,
//    H'^T = e^{cum_L} H^T + B^T (x dec), dec_j = eo_j dt_j. The state (N x P fp32) lives in
//    the registers of two consumer warpgroups (64 of the N rows each); a producer warpgroup
//    brings each chunk's B and x through a 2-stage TMA ring and sums cum in order. Per chunk
//    the consumers write x dec as three bf16 pieces (MN-major, swizzled) into shared memory,
//    read B^T as the A operand by ldmatrix.trans, and run 3 x 8 wgmma m64n64k16. Each
//    chunk's entry state is stored as three bf16 pieces, pre-swizzled, into a (B, nc, H, 3,
//    N, P) scratch (staged in shared memory, one bulk copy a chunk), so the chunk kernels
//    copy it to shared memory as it lies.
// 3. ssd_bwd_states_sm90<true>: dH^T walks backwards the same way, dH'^T = e^{cum_L} dH^T +
//    C^T (e^cum dy), dy through an fp32 TMA map; it stores dH_c's pieces and dy's own pieces
//    (the same swizzled layout, rows of the chunk), <H_{c-1}, dH_c> (the forward walk's tile
//    of the chunk bulk-copied into shared memory, a head of the staged dH tile; summed in a
//    fixed order) into a (B, nc, H) scratch, then dh0.
// 4. ssd_bwd_dc_sm90, a block per (batch, chunk, group of 16 heads; 256 blocks at mamba2),
//    two consumer warpgroups and a producer warpgroup (one warp of it busy): per head,
//    through a 2-stage ring (x by TMA, dy's pieces and H's pieces by bulk copy), each
//    consumer warpgroup owns 64 rows i: dy H (six pairs) -> dC += e^cum (dy H)
//    and C.(e^cum dy H); G = dy x^T on the causal 64 x 64 tiles -> dCB -> rowsum(dCB CB) and
//    dC += dCB B (dCB's pieces as register A fragments). dC sums the group's heads in
//    registers, in order, and is stored as the group's partial; the row terms of dcum go to
//    a (B, S, H) scratch.
// 5. ssd_bwd_dx_sm90, a block per (batch, chunk, group): each warpgroup owns 64 rows j: G^T =
//    x dy^T and M^T on the causal tiles -> colsum(dCB CB), bracket += M^T dy (six pairs),
//    dB += dCB^T C; then dB += eo dt (x dH), B dH^T -> U and bracket += eo (B dH^T); dx,
//    ddt; dcum from the row terms, its reverse cumsum by one warp's fixed-order scan ->
//    dlog_a. dB sums the group's heads in registers, in order.
// 6. ssd_bwd_reduce_sm90: dB and dC, the groups' partials summed in order, rounded to bf16.
//
// Scratch at mamba2-1.3b (B 2, S 4096, H 64): three pieces tiles (H, dH, dy) of 201 MB each,
// CB twice 8.4 MB, the partials 2 x 33.6 MB (groups of 16 heads; the first design's per-head dB and
// dC took 536 MB). Rows past S arrive as zeros from TMA (and the scratches hold zeros
// there), with log_a = dt = 0, and are not stored. One block an SM (shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int L = 128;                      // chunk length
constexpr int P = 64;                       // state rows (x columns)
constexpr int N = 128;                      // state width
constexpr int kThreads = 384;               // consumers 0-255, producer 256-383
constexpr int kConsumers = 256;
constexpr uint32_t kRow = 128;              // bytes a swizzled row: 64 bf16
constexpr uint32_t kSlab = L * kRow;        // 128 rows x 64 bf16 (16 KB)
constexpr uint32_t kBC = 2 * kSlab;         // B or C of a chunk: two slabs of N
constexpr uint32_t kPieces = 3 * kSlab;     // three bf16 pieces of a 128 x 64 tile
constexpr int kSwz = sm90::layout_of(kRow);

// the six pairs of pieces (first operand's, second's) of a two-sided product: hi hi, hi mid,
// mid hi, hi lo, mid mid, lo hi
__host__ __device__ constexpr int six_a(int pr) { return (0x210100 >> (4 * pr)) & 0xF; }
__host__ __device__ constexpr int six_b(int pr) { return (0x012010 >> (4 * pr)) & 0xF; }

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// byte offset of 16-byte chunk `ch` of row `row` in a 128B-swizzled tile
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  return row * kRow + ((ch ^ (row & 7)) << 4);
}

// descriptors of a 128B-swizzled bf16 tile at `p`: K-major (step 16 of K: +2), and MN-major
// (the next 64 output columns one slab on; step 16 of K: 16 rows, +128)
__device__ __forceinline__ uint64_t kdesc(const void* p) {
  return sm90::desc(p, 16, 8 * kRow, kSwz);
}
__device__ __forceinline__ uint64_t mdesc(const void* p) {
  return sm90::desc(p, kSlab, 8 * kRow, kSwz);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from shared to global memory by
// the bulk copy engine, in the issuing thread's bulk async-group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(sm90::smem_u32(src)), "r"(bytes)
               : "memory");
}

// cum = the in-order running sum of log_a over a chunk (one lane, as the forward kernels and
// jnp.cumsum sum it), dts = dt; steps past S are 0. One warp calls it.
__device__ __forceinline__ void chunk_scalars(const float* la, const float* dtp, long long a_ss,
                                              long long d_ss, int s0, int S, float* cum,
                                              float* dts, int lane) {
#pragma unroll
  for (int u = 0; u < L / 32; ++u) {
    const int j = lane + 32 * u;
    const int s = s0 + j;
    cum[j] = s < S ? la[s * a_ss] : 0.f;
    dts[j] = s < S ? dtp[s * d_ss] : 0.f;
  }
  __syncwarp();
  if (lane == 0) {
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
}

// ---------------------------------------------------------------------------
// 1. C B^T once per (batch, chunk)
// ---------------------------------------------------------------------------

constexpr size_t kCbSmem = 1024 + 2 * kBC + 64;

__global__ void __launch_bounds__(256) ssd_bwd_cb_sm90(const __grid_constant__ CUtensorMap tb,
                                                       const __grid_constant__ CUtensorMap tcm,
                                                       float* cb, float* cbt, int nc) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sB = align1024(smem_raw);
  uint8_t* sC = sB + kBC;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sC + kBC);
  const int c = blockIdx.x, b = blockIdx.y;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(bar, 2 * kBC);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      sm90::tma_load_4d(sB + s * kSlab, &tb, bar, 64 * s, c * L, 0, b);
      sm90::tma_load_4d(sC + s * kSlab, &tcm, bar, 64 * s, c * L, 0, b);
    }
  }
  sm90::mbar_wait(bar, 0);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, q = lane % 4;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  const uint64_t dc = kdesc(sC + 64 * wg * kRow);
  const uint64_t db = kdesc(sB);
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t off = (kk / 4) * kSlab + (kk % 4) * 32;
    sm90::wgmma_ss<0>(acc, dc + (off >> 4), db + (off >> 4), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  // accumulator: row i = 64 wg + 16 warp + lane / 4 + 8 r, column j = 8 jj + 2 q + c
  const size_t base = ((size_t)b * nc + c) * L * L;
  const int i0 = 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int jj = 0; jj < L / 8; ++jj)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r, j = 8 * jj + 2 * q;
      const float v0 = acc[4 * jj + 2 * r], v1 = acc[4 * jj + 2 * r + 1];
      *reinterpret_cast<float2*>(cb + base + (size_t)i * L + j) = make_float2(v0, v1);
      cbt[base + (size_t)j * L + i] = v0;
      cbt[base + (size_t)(j + 1) * L + i] = v1;
    }
}

// ---------------------------------------------------------------------------
// 2, 3. the chunk states, forwards (H^T) and backwards (dH^T)
// ---------------------------------------------------------------------------

struct StateParams {
  const float* la;
  const float* dt;
  const float* init;          // h0 (forwards) or dh_last (backwards), (B,H,P,N), or NULL
  const uint8_t* h_pieces;    // backwards: the forward walk's pieces (for <H, dH>)
  uint8_t* out_pieces;        // the entry states' pieces, (B, nc, H) tiles of kPieces
  uint8_t* dy_pieces;         // backwards: dy's pieces, the same tiles
  float* hd;                  // backwards: <H_{c-1}, dH_c>, (B, nc, H)
  float* dh0;                 // backwards, (B,H,P,N), or NULL
  int S, H, nc;
  long long a_sb, a_ss, a_sh, d_sb, d_ss, d_sh;
};

constexpr int kStStages = 2;
constexpr uint32_t kStStage = kBC + 2 * kSlab;   // W (B or C) and V (x bf16 or dy fp32)
// the stages, the pieces of v, (backwards) the forward walk's tile, each stage's
// coefficients, the scalar warp's cum, the reduction of <H, dH> and e^{cum_L} by stage, the
// barriers (backwards 232,064 bytes: 384 under the limit)
constexpr size_t st_smem(bool rev) {
  return 1024 + kStStages * kStStage + (rev ? 2 : 1) * kPieces +
         (kStStages + 1) * L * sizeof(float) + 80 + 48;
}

template <bool kRev>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_states_sm90(
    const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tv,
    const StateParams g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* s_stage = align1024(smem_raw);                     // [stage] W | V
  uint8_t* s_pc = s_stage + kStStages * kStStage;             // the pieces of v
  uint8_t* s_h = s_pc + kPieces;                              // backwards: the H tile
  float* s_coef = reinterpret_cast<float*>(s_h + (kRev ? kPieces : 0));   // [stage][L]
  float* s_cum = s_coef + kStStages * L;                      // [L]: the scalar warp's
  float* s_red = s_cum + L;                                   // [2][8]
  float* s_last = s_red + 16;                                 // [stage]: e^{cum_L}
  uint64_t* full = reinterpret_cast<uint64_t*>(s_last + 4);
  uint64_t* empty = full + kStStages;
  uint64_t* hfull = empty + kStStages;
  uint64_t* hempty = hfull + 1;

  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int nc = g.nc;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStStages; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);   // the TMA thread and the scalar warp
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::mbar_init(hfull, 1);
    sm90::mbar_init(hempty, kConsumers);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    sm90::regs_dec<40>();
    const int warp = (threadIdx.x - kConsumers) / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      sm90::tma_prefetch(&tw);
      sm90::tma_prefetch(&tv);
      // backwards, the forward walk's tile of chunk c for the k-th staged state (k = nc - 1
      // - c), loaded into s_h once the last one's <H, dH> is summed
      auto load_h = [&](int k) {
        sm90::mbar_wait(hempty, (k & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(hfull, kPieces);
        sm90::bulk_load(s_h, g.h_pieces + (((size_t)b * nc + nc - 1 - k) * g.H + h) * kPieces,
                        kPieces, hfull);
      };
      if (kRev) load_h(0);
      for (int it = 0; it < nc; ++it) {
        const int c = kRev ? nc - 1 - it : it, st = it % kStStages;
        sm90::mbar_wait(&empty[st], ((it / kStStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[st], kBC + (kRev ? 2 : 1) * kSlab);
        uint8_t* d = s_stage + st * kStStage;
#pragma unroll
        for (int s = 0; s < 2; ++s)
          sm90::tma_load_4d(d + s * kSlab, &tw, &full[st], 64 * s, c * L, 0, b);
        sm90::tma_load_4d(d + kBC, &tv, &full[st], 0, c * L, h, b);
        if (kRev && it + 1 < nc) load_h(it + 1);
      }
    } else if (warp == 1) {
      const float* la = g.la + b * g.a_sb + h * g.a_sh;
      const float* dtp = g.dt + b * g.d_sb + h * g.d_sh;
      for (int it = 0; it < nc; ++it) {
        const int c = kRev ? nc - 1 - it : it, st = it % kStStages;
        float* cum = s_cum;
        float* coef = s_coef + st * L;
        sm90::mbar_wait(&empty[st], ((it / kStStages) & 1) ^ 1);
        chunk_scalars(la, dtp, g.a_ss, g.d_ss, c * L, g.S, cum, coef, lane);
        const float cl = cum[L - 1];
        if (lane == 0) s_last[st] = expf(cl);
#pragma unroll
        for (int u = 0; u < L / 32; ++u) {
          const int j = lane + 32 * u;
          // backwards e^{cum_i}; forwards dec_j = e^{cum_L - cum_j} dt_j
          coef[j] = kRev ? expf(cum[j]) : expf(cl - cum[j]) * coef[j];
        }
        __syncwarp();   // every lane has read cum before the next chunk's writes
        sm90::mbar_arrive(&full[st]);
      }
    }
  } else {
    sm90::regs_inc<232>();
    const int tid = threadIdx.x, t = tid % 128, warp = t / 32, lane = t % 32, q = lane % 4;
    const int nrow = 64 * wg + 16 * warp + lane / 4;   // state rows n = nrow, nrow + 8
    const size_t bh = (size_t)b * g.H + h;
    // the state: rows n = nrow + 8 r, columns p = 8 jj + 2 q + c at st[4 jj + 2 r + c]
    float stv[32];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = nrow + 8 * r, p = 8 * jj + 2 * q + c;
          stv[4 * jj + 2 * r + c] = g.init ? g.init[(bh * P + p) * N + n] : 0.f;
        }
    // The entry state of chunk c as three pieces, swizzled as an (n, p) tile, into `stage`
    // (shared memory), then stored by one bulk copy into its scratch tile (4-byte stores
    // straight from the registers paced the walks); backwards also <H_{c-1}, dH_c>, from
    // the forward walk's tile of chunk c in s_h (the same layout), summed over the block in
    // a fixed order. `stage` is free once both groups have read it: the last chunk's W and
    // V.
    int k_put = 0;
    auto put_state = [&](uint8_t* stage, int c) {
      const size_t tile = ((size_t)b * nc + c) * g.H + h;
      sm90::bar_sync(3, kConsumers);   // both groups are done reading `stage`
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t off = swz(nrow + 8 * r, jj) + 4 * q;
          uint32_t pc[3];
          sm90::split3(stv[4 * jj + 2 * r], stv[4 * jj + 2 * r + 1], pc[0], pc[1], pc[2]);
#pragma unroll
          for (int k = 0; k < 3; ++k) *reinterpret_cast<uint32_t*>(stage + k * kSlab + off) = pc[k];
        }
      sm90::fence_proxy_async();
      sm90::bar_sync(3, kConsumers);   // the tile is whole
      if (tid == 0) {
        bulk_store(g.out_pieces + tile * kPieces, stage, kPieces);
        sm90::bulk_commit();
      }
      if (kRev) {
        sm90::mbar_wait(hfull, k_put & 1);
        float hd = 0.f;
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int e = tid + kConsumers * e4;
          float hv[8] = {}, dv[8] = {};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const uint4 a = *reinterpret_cast<const uint4*>(s_h + k * kSlab + 16 * e);
            const uint4 d = *reinterpret_cast<const uint4*>(stage + k * kSlab + 16 * e);
            const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, dw[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const float2 av = sm90::unpack_bf16(aw[w]), dvv = sm90::unpack_bf16(dw[w]);
              hv[2 * w] += av.x;
              hv[2 * w + 1] += av.y;
              dv[2 * w] += dvv.x;
              dv[2 * w + 1] += dvv.y;
            }
          }
#pragma unroll
          for (int v = 0; v < 8; ++v) hd += hv[v] * dv[v];
        }
        hd = warp_sum(hd);
        float* red = s_red + 8 * (k_put & 1);
        if (lane == 0) red[wg * 4 + warp] = hd;
        sm90::mbar_arrive(hempty);   // s_h is read
        sm90::bar_sync(3, kConsumers);
        if (tid == 0) {
          float sum = 0.f;
          for (int w = 0; w < 8; ++w) sum += red[w];
          g.hd[tile] = sum;
        }
      }
      if (tid == 0) sm90::bulk_wait_read<0>();   // `stage` may be written again
      ++k_put;
    };
    put_state(s_pc, kRev ? nc - 1 : 0);

    const int mi = lane / 8;   // the 8 x 8 matrix whose row this lane addresses
    for (int it = 0; it < nc; ++it) {
      const int c = kRev ? nc - 1 - it : it, st = it % kStStages;
      const size_t tile = ((size_t)b * nc + c) * g.H + h;
      uint8_t* sw = s_stage + st * kStStage;
      uint8_t* sv = sw + kBC;
      const float* coef = s_coef + st * L;
      sm90::bar_sync(1, kConsumers);   // the last chunk's products and the v tile are done
      sm90::mbar_wait(&full[st], (it / kStStages) & 1);

      // v = coef_r V_r (V: x or dy) as three pieces, an MN-major (r, p) tile; backwards
      // also dy's own pieces into the scratch
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int e = tid + kConsumers * k4;
        const int r = e >> 3, ch = e & 7;
        float v[8];
        if (kRev) {
          const float4 lo = *reinterpret_cast<const float4*>(sv + r * 256 + ch * 32);
          const float4 hi = *reinterpret_cast<const float4*>(sv + r * 256 + ch * 32 + 16);
          v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
          v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
          uint4 pk[3];
          sm90::split3(v[0], v[1], pk[0].x, pk[1].x, pk[2].x);
          sm90::split3(v[2], v[3], pk[0].y, pk[1].y, pk[2].y);
          sm90::split3(v[4], v[5], pk[0].z, pk[1].z, pk[2].z);
          sm90::split3(v[6], v[7], pk[0].w, pk[1].w, pk[2].w);
          uint8_t* dyo = g.dy_pieces + tile * kPieces + swz(r, ch);
          for (int k = 0; k < 3; ++k) *reinterpret_cast<uint4*>(dyo + k * kSlab) = pk[k];
        } else {
          const uint4 raw = *reinterpret_cast<const uint4*>(sv + swz(r, ch));
          const float2 a = sm90::unpack_bf16(raw.x), bb = sm90::unpack_bf16(raw.y);
          const float2 cc = sm90::unpack_bf16(raw.z), d = sm90::unpack_bf16(raw.w);
          v[0] = a.x, v[1] = a.y, v[2] = bb.x, v[3] = bb.y;
          v[4] = cc.x, v[5] = cc.y, v[6] = d.x, v[7] = d.y;
        }
        const float f = coef[r];
        uint4 pk[3];
        sm90::split3(f * v[0], f * v[1], pk[0].x, pk[1].x, pk[2].x);
        sm90::split3(f * v[2], f * v[3], pk[0].y, pk[1].y, pk[2].y);
        sm90::split3(f * v[4], f * v[5], pk[0].z, pk[1].z, pk[2].z);
        sm90::split3(f * v[6], f * v[7], pk[0].w, pk[1].w, pk[2].w);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<uint4*>(s_pc + k * kSlab + swz(r, ch)) = pk[k];
      }
      sm90::fence_proxy_async();
      sm90::bar_sync(2, kConsumers);

      // A = W^T (rows n of this group's slab, K = the chunk's rows) by ldmatrix.trans
      uint32_t a[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int r = 16 * kk + 8 * (mi >> 1) + lane % 8;
        const int n0 = 16 * warp + 8 * (mi & 1);
        sm90::ldmatrix_x4_trans(a[kk], sw + wg * kSlab + r * kRow + (((n0 >> 3) ^ (r & 7)) << 4));
      }
      const float e_last = s_last[st];

      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      const uint64_t dpc = mdesc(s_pc);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          sm90::wgmma_rs<1>(acc, a[kk], dpc + ((k * kSlab + kk * 16 * kRow) >> 4), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
#pragma unroll
      for (int e = 0; e < 32; ++e) stv[e] = e_last * stv[e] + acc[e];
      // the next chunk's entry state, staged where this chunk's W and V were
      if (it + 1 < nc) put_state(sw, kRev ? c - 1 : c + 1);
      sm90::mbar_arrive(&empty[st]);   // W, V, the scalars and the staged state are read
    }
    if (threadIdx.x == 0) sm90::bulk_wait<0>();
    if (kRev && g.dh0 != nullptr) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int n = nrow + 8 * r, p = 8 * jj + 2 * q + c;
            g.dh0[(bh * P + p) * N + n] = stv[4 * jj + 2 * r + c];
          }
    }
  }
}

// ---------------------------------------------------------------------------
// 4, 5. the chunk kernels, a block per (batch, chunk, group of heads)
// ---------------------------------------------------------------------------

struct ChunkParams {
  const float* la;
  const float* dt;
  const float* cb;             // (B, nc, L, L): CB_ij
  const float* cbt;            // (B, nc, L, L): CB_ij at [j][i]
  const uint8_t* h_pieces;     // (B, nc, H) tiles: H_{c-1}^T
  const uint8_t* dh_pieces;    // dH_c^T
  const uint8_t* dy_pieces;    // dy
  const float* hd;             // (B, nc, H): <H_{c-1}, dH_c>
  const __nv_bfloat16* ct;     // C through its strides
  float* rowpart;              // (B, S, H): the row terms of dcum
  float* part;                 // (B, G, S, N): the group's dC (dc kernel) or dB (dx kernel)
  __nv_bfloat16* dx;           // (B, S, H, P)
  float* dla;                  // (B, S, H)
  float* ddt;
  int S, H, nc, group, G;
  long long c_sb, c_ss, a_sb, a_ss, a_sh, d_sb, d_ss, d_sh;
};

// the group's partial (rows 64 w + 16 warp + lane / 4 + 8 r, columns 8 jj + 2 q + c of N)
__device__ __forceinline__ void store_part(const ChunkParams& g, const float (&acc)[64], int b,
                                           int grp, int c, int row0, int q) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = c * L + row0 + 8 * r;
    if (s >= g.S) continue;
    float* out = g.part + (((size_t)b * g.G + grp) * g.S + s) * N + 2 * q;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
      *reinterpret_cast<float2*>(out + 8 * jj) =
          make_float2(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
  }
}

// 4. dC and the row terms of dcum
constexpr size_t kDcStage = kSlab + kPieces;   // x | dy's pieces
constexpr size_t kDcSmem = 1024 + kBC + 2 * kDcStage + kPieces + 2 * 3 * L * sizeof(float) + 64;

__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_dc_sm90(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
    const ChunkParams g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sB = align1024(smem_raw);
  uint8_t* s_stage = sB + kBC;                                  // [2] x | dy pieces
  uint8_t* s_h = s_stage + 2 * kDcStage;                        // H's pieces
  float* s_sc = reinterpret_cast<float*>(s_h + kPieces);        // [2] cum | dt | e^cum
  uint64_t* bfull = reinterpret_cast<uint64_t*>(s_sc + 2 * 3 * L);
  uint64_t* full = bfull + 1;
  uint64_t* empty = full + 2;
  uint64_t* hfull = empty + 2;
  uint64_t* hempty = hfull + 1;

  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * g.group, nh = min(g.group, g.H - h0);
  if (threadIdx.x == 0) {
    sm90::mbar_init(bfull, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&full[s], 1 + 32);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::mbar_init(hfull, 1);
    sm90::mbar_init(hempty, kConsumers);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: one warp, whose lane 0 issues the copies; the warp sums each head's
    // scalars
    sm90::regs_dec<40>();
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      sm90::tma_prefetch(&tx);
      sm90::tma_prefetch(&tb);
      sm90::mbar_arrive_expect_tx(bfull, kBC);
      for (int s = 0; s < 2; ++s) sm90::tma_load_4d(sB + s * kSlab, &tb, bfull, 64 * s, c * L, 0, b);
    }
    for (int k = 0; k < nh; ++k) {
      const int st = k & 1, h = h0 + k;
      const size_t tile = ((size_t)b * g.nc + c) * g.H + h;
      uint8_t* d = s_stage + st * kDcStage;
      float* cum = s_sc + st * 3 * L;
      sm90::mbar_wait(&empty[st], ((k >> 1) & 1) ^ 1);
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full[st], kSlab + kPieces);
        sm90::tma_load_4d(d, &tx, &full[st], 0, c * L, h, b);
        for (int p = 0; p < 3; ++p)
          sm90::bulk_load(d + kSlab + p * kSlab, g.dy_pieces + tile * kPieces + p * kSlab, kSlab,
                          &full[st]);
      }
      chunk_scalars(g.la + b * g.a_sb + h * g.a_sh, g.dt + b * g.d_sb + h * g.d_sh, g.a_ss,
                    g.d_ss, c * L, g.S, cum, cum + L, lane);
#pragma unroll
      for (int u = 0; u < L / 32; ++u) cum[2 * L + lane + 32 * u] = expf(cum[lane + 32 * u]);
      sm90::mbar_arrive(&full[st]);
      if (lane == 0) {
        sm90::mbar_wait(hempty, (k & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(hfull, kPieces);
        for (int p = 0; p < 3; ++p)
          sm90::bulk_load(s_h + p * kSlab, g.h_pieces + tile * kPieces + p * kSlab, kSlab, hfull);
      }
      __syncwarp();
    }
  } else {
    sm90::regs_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, q = lane % 4;
    const int irow = 64 * wg + 16 * warp + lane / 4;   // rows i = irow, irow + 8
    float dc[64];   // the group's dC: rows i, columns 8 jj + 2 q + c of N
#pragma unroll
    for (int e = 0; e < 64; ++e) dc[e] = 0.f;
    sm90::mbar_wait(bfull, 0);
    for (int k = 0; k < nh; ++k) {
      const int st = k & 1, h = h0 + k;
      uint8_t* sx = s_stage + st * kDcStage;
      uint8_t* sdy = sx + kSlab;
      const float* cum = s_sc + st * 3 * L;
      const float* dts = cum + L;
      const float* ein = cum + 2 * L;
      sm90::mbar_wait(&full[st], (k >> 1) & 1);
      sm90::mbar_wait(hfull, k & 1);
      const float ci[2] = {cum[irow], cum[irow + 8]};
      const float ei[2] = {ein[irow], ein[irow + 8]};

      // dy H (six pairs of pieces), by halves of N: C.(e^cum dy H) and dC += e^cum (dy H)
      float inter[2] = {0.f, 0.f};
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        float acc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = 0.f;
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int pr = 0; pr < 6; ++pr)
            sm90::wgmma_ss<0>(acc, kdesc(sdy + six_a(pr) * kSlab + 64 * wg * kRow) + 2 * kk,
                              kdesc(s_h + six_b(pr) * kSlab + 64 * hn * kRow) + 2 * kk, 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = c * L + irow + 8 * r;
          const __nv_bfloat16* crow = g.ct + b * g.c_sb + (long long)s * g.c_ss + 64 * hn + 2 * q;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 cv = s < g.S ? sm90::unpack_bf16(
                                            *reinterpret_cast<const uint32_t*>(crow + 8 * jj))
                                      : make_float2(0.f, 0.f);
            const float t0 = acc[4 * jj + 2 * r], t1 = acc[4 * jj + 2 * r + 1];
            inter[r] += cv.x * t0 + cv.y * t1;
            dc[4 * (8 * hn + jj) + 2 * r] += ei[r] * t0;
            dc[4 * (8 * hn + jj) + 2 * r + 1] += ei[r] * t1;
          }
        }
      }
      sm90::mbar_arrive(hempty);   // H's pieces are read

      // G = dy x^T on the causal 64-column blocks J <= wg: dCB = G E dt_j, rowsum(dCB CB),
      // dC += dCB B
      float rows[2] = {0.f, 0.f};
#pragma unroll 1
      for (int J = 0; J <= wg; ++J) {
        float gm[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) gm[e] = 0.f;
        sm90::fence_regs(gm);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int pa = 0; pa < 3; ++pa)
            sm90::wgmma_ss<0>(gm, kdesc(sdy + pa * kSlab + 64 * wg * kRow) + 2 * kk,
                              kdesc(sx + 64 * J * kRow) + 2 * kk, 1);
        sm90::wgmma_commit();
        const float* cbp = g.cb + (((size_t)b * g.nc + c) * L + irow) * L + 64 * J + 2 * q;
        float cbv[32];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 v = *reinterpret_cast<const float2*>(cbp + 8 * r * L + 8 * jj);
            cbv[4 * jj + 2 * r] = v.x;
            cbv[4 * jj + 2 * r + 1] = v.y;
          }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(gm);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 64 * J + 8 * jj + 2 * q;
          const float2 cj = *reinterpret_cast<const float2*>(cum + j);
          const float2 dj = *reinterpret_cast<const float2*>(dts + j);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int i = irow + 8 * r;
            float& g0 = gm[4 * jj + 2 * r];
            float& g1 = gm[4 * jj + 2 * r + 1];
            g0 *= expf(j <= i ? ci[r] - cj.x : neg_inf()) * dj.x;
            g1 *= expf(j + 1 <= i ? ci[r] - cj.y : neg_inf()) * dj.y;
            rows[r] += g0 * cbv[4 * jj + 2 * r] + g1 * cbv[4 * jj + 2 * r + 1];
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t a[2][3][4];
#pragma unroll
          for (int kq = 0; kq < 2; ++kq)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = 8 * (2 * half + kq) + 2 * u;
              sm90::split3(gm[e], gm[e + 1], a[kq][0][u], a[kq][1][u], a[kq][2][u]);
            }
          sm90::fence_regs(dc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kq = 0; kq < 2; ++kq)
#pragma unroll
            for (int pc = 0; pc < 3; ++pc)
              sm90::wgmma_rs<1>(dc, a[kq][pc],
                                mdesc(sB + (64 * J + 16 * (2 * half + kq)) * kRow), 1);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(dc);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = quad_sum(rows[r]) + ei[r] * quad_sum(inter[r]);
        const int s = c * L + irow + 8 * r;
        if (q == 0 && s < g.S) g.rowpart[((size_t)b * g.S + s) * g.H + h] = v;
      }
      sm90::mbar_arrive(&empty[st]);   // x, dy's pieces and the scalars are read
    }
    store_part(g, dc, b, grp, c, irow, q);
  }
}

// 5. dB, dx, ddt and dlog_a
constexpr size_t kDxSmem = 1024 + 2 * kBC + 2 * kSlab + 2 * kPieces +
                           2 * 3 * L * sizeof(float) + 2 * 2 * L * sizeof(float) + 128;

__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_dx_sm90(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tcm, const ChunkParams g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sB = align1024(smem_raw);
  uint8_t* sC = sB + kBC;
  uint8_t* s_x = sC + kBC;                                      // [2] x
  uint8_t* s_dy = s_x + 2 * kSlab;                              // dy's pieces
  uint8_t* s_dh = s_dy + kPieces;                               // dH's pieces
  float* s_sc = reinterpret_cast<float*>(s_dh + kPieces);       // [2] cum | dt | eo
  float* s_dcum = s_sc + 2 * 3 * L;                             // [2] dcum | U
  uint64_t* bcfull = reinterpret_cast<uint64_t*>(s_dcum + 2 * 2 * L);
  uint64_t* xfull = bcfull + 1;
  uint64_t* xempty = xfull + 2;
  uint64_t* yfull = xempty + 2;
  uint64_t* yempty = yfull + 1;
  uint64_t* dfull = yempty + 1;
  uint64_t* dempty = dfull + 1;

  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * g.group, nh = min(g.group, g.H - h0);
  if (threadIdx.x == 0) {
    sm90::mbar_init(bcfull, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&xfull[s], 1 + 32);
      sm90::mbar_init(&xempty[s], kConsumers);
    }
    sm90::mbar_init(yfull, 1);
    sm90::mbar_init(yempty, kConsumers);
    sm90::mbar_init(dfull, 1);
    sm90::mbar_init(dempty, kConsumers);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // the producer: one warp, whose lane 0 issues the copies; the warp sums each head's
    // scalars
    sm90::regs_dec<40>();
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      sm90::tma_prefetch(&tx);
      sm90::tma_prefetch(&tb);
      sm90::tma_prefetch(&tcm);
      sm90::mbar_arrive_expect_tx(bcfull, 2 * kBC);
      for (int s = 0; s < 2; ++s) {
        sm90::tma_load_4d(sB + s * kSlab, &tb, bcfull, 64 * s, c * L, 0, b);
        sm90::tma_load_4d(sC + s * kSlab, &tcm, bcfull, 64 * s, c * L, 0, b);
      }
    }
    for (int k = 0; k < nh; ++k) {
      const int st = k & 1, h = h0 + k;
      const size_t tile = ((size_t)b * g.nc + c) * g.H + h;
      float* cum = s_sc + st * 3 * L;
      sm90::mbar_wait(&xempty[st], ((k >> 1) & 1) ^ 1);
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&xfull[st], kSlab);
        sm90::tma_load_4d(s_x + st * kSlab, &tx, &xfull[st], 0, c * L, h, b);
      }
      chunk_scalars(g.la + b * g.a_sb + h * g.a_sh, g.dt + b * g.d_sb + h * g.d_sh, g.a_ss,
                    g.d_ss, c * L, g.S, cum, cum + L, lane);
      const float cl = cum[L - 1];
#pragma unroll
      for (int u = 0; u < L / 32; ++u) {
        const int j = lane + 32 * u;
        cum[2 * L + j] = expf(cl - cum[j]);
      }
      sm90::mbar_arrive(&xfull[st]);
      if (lane == 0) {
        sm90::mbar_wait(yempty, (k & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(yfull, kPieces);
        for (int p = 0; p < 3; ++p)
          sm90::bulk_load(s_dy + p * kSlab, g.dy_pieces + tile * kPieces + p * kSlab, kSlab,
                          yfull);
        sm90::mbar_wait(dempty, (k & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(dfull, kPieces);
        for (int p = 0; p < 3; ++p)
          sm90::bulk_load(s_dh + p * kSlab, g.dh_pieces + tile * kPieces + p * kSlab, kSlab,
                          dfull);
      }
      __syncwarp();
    }
  } else {
    sm90::regs_inc<232>();
    const int tid = threadIdx.x, t = tid % 128, warp = t / 32, lane = t % 32, q = lane % 4;
    const int jrow = 64 * wg + 16 * warp + lane / 4;   // rows j = jrow, jrow + 8
    float db[64];   // the group's dB: rows j, columns 8 jj + 2 q + c of N
#pragma unroll
    for (int e = 0; e < 64; ++e) db[e] = 0.f;
    sm90::mbar_wait(bcfull, 0);
    for (int k = 0; k < nh; ++k) {
      const int st = k & 1, h = h0 + k;
      const size_t tile = ((size_t)b * g.nc + c) * g.H + h;
      uint8_t* sx = s_x + st * kSlab;
      const float* cum = s_sc + st * 3 * L;
      const float* dts = cum + L;
      const float* eo = cum + 2 * L;
      float* dcum = s_dcum + (k & 1) * 2 * L;
      float* uu = dcum + L;
      sm90::mbar_wait(&xfull[st], (k >> 1) & 1);
      sm90::mbar_wait(yfull, k & 1);
      const float cj[2] = {cum[jrow], cum[jrow + 8]};
      const float dtj[2] = {dts[jrow], dts[jrow + 8]};
      const float eoj[2] = {eo[jrow], eo[jrow + 8]};

      float br[32];   // the bracket: rows j, columns 8 jj + 2 q + c of P
#pragma unroll
      for (int e = 0; e < 32; ++e) br[e] = 0.f;
      float cols[2] = {0.f, 0.f};
      // the causal 64-row blocks I >= wg of the chunk's rows i
#pragma unroll 1
      for (int I = wg; I < 2; ++I) {
        float gm[32];   // G^T = x dy^T, then dCB^T
#pragma unroll
        for (int e = 0; e < 32; ++e) gm[e] = 0.f;
        sm90::fence_regs(gm);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int pb = 0; pb < 3; ++pb)
            sm90::wgmma_ss<0>(gm, kdesc(sx + 64 * wg * kRow) + 2 * kk,
                              kdesc(s_dy + pb * kSlab + 64 * I * kRow) + 2 * kk, 1);
        sm90::wgmma_commit();
        const float* cbp = g.cbt + (((size_t)b * g.nc + c) * L + jrow) * L + 64 * I + 2 * q;
        float m[32];   // CB^T, then M^T = CB^T E
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 v = *reinterpret_cast<const float2*>(cbp + 8 * r * L + 8 * jj);
            m[4 * jj + 2 * r] = v.x;
            m[4 * jj + 2 * r + 1] = v.y;
          }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(gm);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int i = 64 * I + 8 * jj + 2 * q;
          const float2 cix = *reinterpret_cast<const float2*>(cum + i);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int j = jrow + 8 * r;
            const float e0 = expf(i >= j ? cix.x - cj[r] : neg_inf());
            const float e1 = expf(i + 1 >= j ? cix.y - cj[r] : neg_inf());
            float& g0 = gm[4 * jj + 2 * r];
            float& g1 = gm[4 * jj + 2 * r + 1];
            float& m0 = m[4 * jj + 2 * r];
            float& m1 = m[4 * jj + 2 * r + 1];
            g0 *= e0 * dtj[r];
            g1 *= e1 * dtj[r];
            cols[r] += g0 * m0 + g1 * m1;
            m0 *= e0;
            m1 *= e1;
          }
        }
        // bracket += M^T dy over this block (six pairs of pieces), dB += dCB^T C
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t a[2][3][4];
#pragma unroll
          for (int kq = 0; kq < 2; ++kq)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = 8 * (2 * half + kq) + 2 * u;
              sm90::split3(m[e], m[e + 1], a[kq][0][u], a[kq][1][u], a[kq][2][u]);
            }
          sm90::fence_regs(br);
          sm90::wgmma_fence();
#pragma unroll
          for (int kq = 0; kq < 2; ++kq)
#pragma unroll
            for (int pr = 0; pr < 6; ++pr)
              sm90::wgmma_rs<1>(
                  br, a[kq][six_a(pr)],
                  mdesc(s_dy + six_b(pr) * kSlab + (64 * I + 16 * (2 * half + kq)) * kRow), 1);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(br);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t a[2][3][4];
#pragma unroll
          for (int kq = 0; kq < 2; ++kq)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int e = 8 * (2 * half + kq) + 2 * u;
              sm90::split3(gm[e], gm[e + 1], a[kq][0][u], a[kq][1][u], a[kq][2][u]);
            }
          sm90::fence_regs(db);
          sm90::wgmma_fence();
#pragma unroll
          for (int kq = 0; kq < 2; ++kq)
#pragma unroll
            for (int pc = 0; pc < 3; ++pc)
              sm90::wgmma_rs<1>(db, a[kq][pc],
                                mdesc(sC + (64 * I + 16 * (2 * half + kq)) * kRow), 1);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(db);
        }
      }
      sm90::mbar_arrive(yempty);   // dy's pieces are read
      sm90::mbar_wait(dfull, k & 1);

      // dB += eo dt (x dH), by halves of N
#pragma unroll
      for (int hn = 0; hn < 2; ++hn) {
        float acc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = 0.f;
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int pb = 0; pb < 3; ++pb)
            sm90::wgmma_ss<0>(acc, kdesc(sx + 64 * wg * kRow) + 2 * kk,
                              kdesc(s_dh + pb * kSlab + 64 * hn * kRow) + 2 * kk, 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float f = eoj[r] * dtj[r];
            db[4 * (8 * hn + jj) + 2 * r] += f * acc[4 * jj + 2 * r];
            db[4 * (8 * hn + jj) + 2 * r + 1] += f * acc[4 * jj + 2 * r + 1];
          }
      }

      // B dH^T: U_j = eo_j dt_j x_j . (B dH^T)_j, bracket += eo (B dH^T)
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int pb = 0; pb < 3; ++pb)
          sm90::wgmma_ss<1>(acc, kdesc(sB + 64 * wg * kRow) + (((kk / 4) * kSlab + (kk % 4) * 32) >> 4),
                            mdesc(s_dh + pb * kSlab + kk * 16 * kRow), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::mbar_arrive(dempty);   // dH's pieces are read

      // dx = dt bracket, ddt = x . bracket
      float u[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = jrow + 8 * r, s = c * L + j;
        __nv_bfloat16* dxr = g.dx + (((size_t)b * g.S + s) * g.H + h) * P + 2 * q;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 xv =
              sm90::unpack_bf16(*reinterpret_cast<const uint32_t*>(sx + swz(j, jj) + 4 * q));
          const float t0 = acc[4 * jj + 2 * r], t1 = acc[4 * jj + 2 * r + 1];
          u[r] += xv.x * t0 + xv.y * t1;
          const float b0 = br[4 * jj + 2 * r] + eoj[r] * t0;
          const float b1 = br[4 * jj + 2 * r + 1] + eoj[r] * t1;
          dd[r] += xv.x * b0 + xv.y * b1;
          if (s < g.S)
            *reinterpret_cast<uint32_t*>(dxr + 8 * jj) = sm90::pack_bf16(dtj[r] * b0, dtj[r] * b1);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = jrow + 8 * r, s = c * L + j;
        const float uj = eoj[r] * dtj[r] * quad_sum(u[r]);
        const float ddj = quad_sum(dd[r]);
        const float cj2 = quad_sum(cols[r]);
        if (q == 0) {
          const size_t o = ((size_t)b * g.S + s) * g.H + h;
          const float rowp = s < g.S ? g.rowpart[o] : 0.f;
          if (s < g.S) g.ddt[o] = ddj;
          dcum[j] = rowp - cj2 - uj;
          uu[j] = uj;
        }
      }
      sm90::bar_sync(1, kConsumers);   // dcum and U of every row are in shared memory
      if (tid < 32) {
        // U summed and dcum reverse-summed over the chunk, in a fixed order: lane l owns
        // rows 4 l .. 4 l + 3
        float d4[4], us = 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          d4[v] = dcum[4 * lane + v];
          us += uu[4 * lane + v];
        }
        us = warp_sum(us);
        if (lane == 31) d4[3] += us + expf(cum[L - 1]) * g.hd[tile];
        float suf[4];
        suf[3] = d4[3];
#pragma unroll
        for (int v = 2; v >= 0; --v) suf[v] = d4[v] + suf[v + 1];
        float x = suf[0];   // lane l: the sum over lanes >= l
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_down_sync(0xffffffffu, x, o);
          if (lane + o < 32) x += y;
        }
        float after = __shfl_down_sync(0xffffffffu, x, 1);
        if (lane == 31) after = 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int s = c * L + 4 * lane + v;
          if (s < g.S) g.dla[((size_t)b * g.S + s) * g.H + h] = suf[v] + after;
        }
      }
      sm90::mbar_arrive(&xempty[st]);   // x and the scalars are read
    }
    store_part(g, db, b, grp, c, jrow, q);
  }
}

// ---------------------------------------------------------------------------
// 6. dB and dC: the groups' partials summed in order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(N) ssd_bwd_reduce_sm90(const float* dcp, const float* dbp,
                                                         __nv_bfloat16* dct,
                                                         __nv_bfloat16* dbt, int S, int G) {
  const int s = blockIdx.x, b = blockIdx.y, n = threadIdx.x;
  float sc = 0.f, sb = 0.f;
  for (int gi = 0; gi < G; ++gi) {
    const size_t o = (((size_t)b * G + gi) * S + s) * N + n;
    sc += dcp[o];
    sb += dbp[o];
  }
  const size_t o = ((size_t)b * S + s) * N + n;
  dct[o] = __float2bfloat16_rn(sc);
  dbt[o] = __float2bfloat16_rn(sb);
}

}  // namespace

// bf16 x, bt, ct at P 64, N 128, chunk 128, read through TMA (16-byte aligned addresses,
// batch, seq (and head for x) strides of a multiple of 8 elements); log_a, dt (B,S,H) fp32
// through their strides; dy (B,S,H,P), h0, dh_last, dh0 (B,H,P,N) contiguous fp32 (h0 / dh0,
// dh_last may be NULL). Writes dx (B,S,H,P), dbt, dct (B,S,N) bf16 and dla, ddt (B,S,H)
// fp32, contiguous. Scratch: cb 2 x (B, nc, 128, 128) fp32; h_pieces, dh_pieces, dy_pieces
// (B, nc, H) tiles of 3 x 128 x 64 bf16 (48 KB); hd (B, nc, H), rowpart (B, S, H) fp32;
// dcp, dbp (B, G, S, 128) fp32, G = ceil(H / group).
extern "C" int ssd_scan_bwd_sm90_launch(
    const void* x, const void* bt, const void* ct, const void* la, const void* dt,
    const void* h0, const void* dy, const void* dh_last, void* dx, void* dbt, void* dct,
    void* dla, void* ddt, void* dh0, void* cb, void* h_pieces, void* dh_pieces,
    void* dy_pieces, void* hd, void* rowpart, void* dcp, void* dbp, int B, int S, int H,
    int group, long long x_sb, long long x_ss, long long x_sh, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, long long a_sb, long long a_ss,
    long long a_sh, long long d_sb, long long d_ss, long long d_sh, void* stream) {
  constexpr cuuint64_t E = sizeof(__nv_bfloat16);
  const cudaStream_t st = (cudaStream_t)stream;
  const int nc = (S + L - 1) / L, G = (H + group - 1) / group;
  CUtensorMap tx, tb, tcm, tdy;
  // x (B,S,H,P) as (P, S, H, B); B and C (B,S,N) as (N, S, 1, B); dy as x, fp32
  const cuuint64_t dxm[4] = {P, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t dbc[4] = {N, (cuuint64_t)S, 1, (cuuint64_t)B};
  const cuuint64_t sx[3] = {x_ss * E, x_sh * E, x_sb * E};
  const cuuint64_t sb[3] = {b_ss * E, N * E, b_sb * E};
  const cuuint64_t sc[3] = {c_ss * E, N * E, c_sb * E};
  const cuuint64_t sdy[3] = {(cuuint64_t)H * P * 4, P * 4, (cuuint64_t)S * H * P * 4};
  cudaError_t err = sm90::encode_bf16_4d(&tx, x, dxm, sx, 64, L);
  if (err == cudaSuccess) err = sm90::encode_bf16_4d(&tb, bt, dbc, sb, 64, L);
  if (err == cudaSuccess) err = sm90::encode_bf16_4d(&tcm, ct, dbc, sc, 64, L);
  if (err == cudaSuccess) err = sm90::encode_f32_4d(&tdy, dy, dxm, sdy, P, L);
  if (err != cudaSuccess) return (int)err;
  const struct {
    const void* fn;
    size_t smem;
  } attrs[] = {{(const void*)ssd_bwd_cb_sm90, kCbSmem},
               {(const void*)ssd_bwd_states_sm90<false>, st_smem(false)},
               {(const void*)ssd_bwd_states_sm90<true>, st_smem(true)},
               {(const void*)ssd_bwd_dc_sm90, kDcSmem},
               {(const void*)ssd_bwd_dx_sm90, kDxSmem}};
  for (const auto& a : attrs) {
    err = cudaFuncSetAttribute(a.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.smem);
    if (err != cudaSuccess) return (int)err;
  }
  float* cbp = (float*)cb;
  float* cbtp = cbp + (size_t)B * nc * L * L;
  ssd_bwd_cb_sm90<<<dim3(nc, B), 256, kCbSmem, st>>>(tb, tcm, cbp, cbtp, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  StateParams sp{(const float*)la, (const float*)dt, (const float*)h0, nullptr,
                 (uint8_t*)h_pieces, nullptr, nullptr, nullptr, S, H, nc,
                 a_sb, a_ss, a_sh, d_sb, d_ss, d_sh};
  ssd_bwd_states_sm90<false><<<B * H, kThreads, st_smem(false), st>>>(tb, tx, sp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sp.init = (const float*)dh_last;
  sp.h_pieces = (const uint8_t*)h_pieces;
  sp.hd = (float*)hd;
  sp.out_pieces = (uint8_t*)dh_pieces;
  sp.dy_pieces = (uint8_t*)dy_pieces;
  sp.dh0 = (float*)dh0;
  ssd_bwd_states_sm90<true><<<B * H, kThreads, st_smem(true), st>>>(tcm, tdy, sp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ChunkParams cp{(const float*)la, (const float*)dt, cbp, cbtp,
                 (const uint8_t*)h_pieces, (const uint8_t*)dh_pieces,
                 (const uint8_t*)dy_pieces, (const float*)hd, (const __nv_bfloat16*)ct,
                 (float*)rowpart, (float*)dcp, (__nv_bfloat16*)dx, (float*)dla, (float*)ddt,
                 S, H, nc, group, G, c_sb, c_ss, a_sb, a_ss, a_sh, d_sb, d_ss, d_sh};
  ssd_bwd_dc_sm90<<<dim3(nc, G, B), kThreads, kDcSmem, st>>>(tx, tb, cp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cp.part = (float*)dbp;
  ssd_bwd_dx_sm90<<<dim3(nc, G, B), kThreads, kDxSmem, st>>>(tx, tb, tcm, cp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_reduce_sm90<<<dim3(S, B), N, 0, st>>>((const float*)dcp, (const float*)dbp,
                                                (__nv_bfloat16*)dct, (__nv_bfloat16*)dbt, S,
                                                G);
  return (int)cudaGetLastError();
}
