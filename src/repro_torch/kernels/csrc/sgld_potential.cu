// sgld_potential: the minibatch potential of C SGLD chains, and its
// hand-derived theta-gradient, in two modes (the reference's _SgldSpec.mode):
// "fgts" (the FGTS.CDB potential, below) and "mixed" (duel and click rows,
// further down).
//
// Replaces the Pallas kernels of src/repro/kernels/sgld_update.py:
//   forward  _fwd_kernel/_tile_terms (pallas_call in _forward, :255)
//   gradient _bwd_kernel/_tile_grad  (pallas_call in _backward, :272)
// "mixed" is the same pallas_calls entered through sgld_mixed_potential
// (:396; branches of _tile_terms/_tile_grad at :158-161 and :196-200).
//
// For chain c and minibatch row i (a ring row r = rows[c,i]):
//   s_k   = ((x_r*theta_c) . a_k) / sqrt(max((x_r*x_r) . (a_k*a_k), 1e-24))
//   U_c   = sum_i valid_ci * [eta*softplus(-y_r (s_a1 - s_a2))
//             - mu_r * (max_{k live}(s_k - p_r cost_k) - (s_opp - p_r cost_opp))]
//   mu_r  = mu / (1 + max(p_r, 0)),  opp = a2 for j = 1, a1 for j = 2
//   dU_c  = g_c * sum_i x_r * sum_k (W_ik / den_ik) a_k
// where W holds the logistic slope on a1 and a2, -mu_r split evenly over
// the tied maxima of the feel-good max (jnp.max's VJP), and +mu_r on opp.
//
// What bounds it on the card: at the routing shapes (C 8, m 64, K ~ 16,
// d 768) the bytes of the gathered rows, about a microsecond, so latency
// and the launch; at K ~ 1024 the C*m*K*d multiply-adds of the scores.
//
// The fgts design (one kernel, two entry points: forward and gradient):
// - Lanes over arms, not over d. One thread-block cluster per chain
//   (cluster size <= 8, the portable limit); the chain's m rows are split
//   evenly over its blocks, and a block walks its rows in groups. A
//   group's x*theta and x*x rows (whole d) and theta sit in shared memory.
// - Register tiles: each thread keeps a few (row, arm) pairs' numerators
//   and denominators and walks d in one fixed order, one fma per step, so
//   every arm's score goes through the same roundings wherever it sits:
//   duplicated arms score bitwise equal, which the tie-split gradient
//   needs. No shuffle per arm.
// - After the scores a warp per row folds them into the row's state (s_a1,
//   s_a2 and their den, the tilted running max, its first arm and tie
//   count). A tie needs no second walk over d: the tied arms' scores and
//   den are at hand, in shared memory when K fits one tile, else in a
//   global scratch (2, C, m, K) the gradient writes as it goes.
// - One launch: each block sums its rows' terms (or gradient rows) in row
//   order into its partial; after a cluster barrier each block sums a slice
//   of d over the blocks' partials through distributed shared memory, in
//   rank order, times g_c. No second kernel, no atomics, no counter to
//   reset: the result is bitwise the same from run to run, and the launch
//   can be captured in a CUDA graph.
// Configurations (chosen by the wrapper, sgld_update.fgts_plan):
// - Small, K <= 32 (the routing shape, latency-bound): all of A resident
//   in shared memory, 8-row groups, each thread one row, 4 arms and one of
//   8 (K <= 16) or 4 segments of d, the segments' sums added in order;
//   rows and A arrive by bulk copies (cp.async otherwise).
// - Large (any K, the operations-bound shapes): 16-row groups against
//   256-arm tiles streamed through a cp.async ring of d-chunks, each thread
//   a 4 x 4 outer-product tile walking all of d in one chain.
// - Narrow: Large's tile with 4-row groups, for d beyond Large's shared
//   memory.
// fp32 on the CUDA cores, no TF32 and no tensor cores.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

#include "sm90.cuh"

namespace {

// every kernel of this file: 8 warps, one block per SM, a cluster per chain
constexpr int kBlockWarps = 8;
constexpr int kBlockThreads = 32 * kBlockWarps;

__device__ __forceinline__ float softplus(float v) {      // logaddexp(v, 0)
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// ---------------------------------------------------------------------------
// "fgts" mode
// ---------------------------------------------------------------------------

struct FgtsArgs {
  const float* theta;      // (C, d)
  const float* x;          // (N, d) ring rows
  const int32_t* a1;       // (N,)
  const int32_t* a2;       // (N,)
  const float* y;          // (N,)
  const float* pref;       // (N,) or null (= 0)
  const int64_t* rows;     // (C, m) ring row of each minibatch slot
  const float* valid;      // (C, m)
  const float* a;          // (K, d)
  const uint8_t* mask;     // (K,) or null (= all live)
  const float* costs;      // (K,) or null (= 0)
  const float* g;          // (C,) or null (= 1): scale of the result
  float* scratch;          // (2, C, m, K) scores and den (gradient, K > AT)
  float* out;              // (C, d) gradient or (C,) potential
  int C, m, K, d, j;
  float eta, mu;
  int rpb;                 // minibatch rows per block of a cluster
};

struct RowState {
  int64_t r;
  int a1, a2, cnt, kmax;
  float v, y, pref, copp, s1, den1, s2, den2, smax, dmax, term;
  float c1, c2, cm;        // the gradient's coefficients (grad_coef)
};

// s_k - p * cost_k, rounded as the reference rounds it (no fma contraction)
__device__ __forceinline__ float tilted(float s, float pr, float cost) {
  return __fsub_rn(s, __fmul_rn(pr, cost));
}

// arm k's cost and live flag from a table (null: 0 and live)
__device__ __forceinline__ float arm_cost(const float* costs, int k) {
  return costs ? costs[k] : 0.f;
}

__device__ __forceinline__ bool arm_live(const uint8_t* mask, int k) {
  return mask == nullptr || mask[k] != 0;
}

// N (1 or 4) consecutive floats of shared memory, 4 as one 16-byte load
template <int N>
__device__ __forceinline__ void load_n(const float* src, float* dst) {
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(src);
    dst[0] = f.x; dst[1] = f.y; dst[2] = f.z; dst[3] = f.w;
  } else {
    dst[0] = src[0];
  }
}

// n rows of a table (row stride `stride`, `width` live columns) into
// shared memory as rows of ld floats, `cols` columns each (a multiple of
// 4), zeros past width; rows past n_live are left as they are (their sums
// are never read); rows_of(q) gives row q's index in the table. vec:
// 16-byte copies (every row start 16-byte aligned and width a multiple of
// 4), else 4-byte ones.
template <int W, class RowOf>
__device__ __forceinline__ void stage_rows_w(float* dst, int ld,
                                             const float* src, int stride,
                                             int width, int n, int n_live,
                                             int cols, RowOf rows_of) {
  const int v = cols / W;                  // copies per row
  const auto copy = [&](int q, int t) {
    if (q >= n_live) return;
    const bool ok = t < width;
    const float* from = ok ? src + (int64_t)rows_of(q) * stride + t : src;
    if (W == 4) sm90::cp_async_16(dst + q * ld + t, from, ok ? 16 : 0);
    else sm90::cp_async_4(dst + q * ld + t, from, ok ? 4 : 0);
  };
  if (v >= 32) {                           // a warp per row: no division
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int q = warp; q < n; q += kBlockWarps)
      for (int j = lane; j < v; j += 32) copy(q, j * W);
  } else {
    for (int e = threadIdx.x; e < n * v; e += kBlockThreads) {
      const int q = e / v;
      copy(q, (e - q * v) * W);
    }
  }
}

// the same by the bulk copy engine (width % 4 == 0, 16-byte aligned
// table): rows q < n_live as one copy each by the lanes of warp 0,
// completing on bar, which thread 0 arms with their bytes; the zero tail
// [width, cols) of every row by plain stores. The caller waits on bar.
template <class RowOf>
__device__ __forceinline__ void bulk_rows(float* dst, int ld, const float* src,
                                          int stride, int width, int n,
                                          int n_live, int cols, RowOf rows_of,
                                          uint64_t* bar) {
  if (threadIdx.x == 0)
    sm90::mbar_arrive_expect_tx(bar, (uint32_t)(n_live * width * 4));
  __syncwarp();
  if (threadIdx.x < 32)
    for (int q = threadIdx.x; q < n_live; q += 32)
      sm90::bulk_load(dst + q * ld, src + (int64_t)rows_of(q) * stride,
                      width * 4, bar);
  const int tail = cols - width;
  for (int e = threadIdx.x; e < n * tail; e += kBlockThreads)
    dst[(e / tail) * ld + width + e % tail] = 0.f;
}

template <class RowOf>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int stride,
                                           int width, int n, int n_live,
                                           int cols, RowOf rows_of, bool vec) {
  if (vec) stage_rows_w<4>(dst, ld, src, stride, width, n, n_live, cols, rows_of);
  else stage_rows_w<1>(dst, ld, src, stride, width, n, n_live, cols, rows_of);
}

// the row threads (tid < n) load the ring row and valid flag of the group
// at g into registers (zeros past i_end), to store into their row state
// when the group starts: the loads overlap what comes between
__device__ __forceinline__ void fetch_rows(const FgtsArgs& p, int n, int c,
                                           int g, int i_end, int64_t& r,
                                           float& v) {
  if ((int)threadIdx.x < n) {
    const int i = g + threadIdx.x;
    const bool in = i < i_end;
    r = in ? p.rows[(int64_t)c * p.m + i] : 0;
    v = in ? p.valid[(int64_t)c * p.m + i] : 0.f;
  }
}

// the row threads read their tables and reset their state
__device__ __forceinline__ void init_rows(const FgtsArgs& p, RowState* rs,
                                          int n) {
  if (threadIdx.x < n) {
    RowState& s = rs[threadIdx.x];
    s.a1 = p.a1[s.r];
    s.a2 = p.a2[s.r];
    s.y = p.y[s.r];
    s.pref = p.pref ? p.pref[s.r] : 0.f;
    s.copp = arm_cost(p.costs, p.j == 1 ? s.a2 : s.a1);
    s.s1 = s.s2 = 0.f;
    s.den1 = s.den2 = 1.f;
    s.smax = -CUDART_INF_F;
    s.dmax = 1.f;
    s.cnt = s.kmax = 0;
  }
}

// one warp folds its row's tile of scores (ts, tden: AT entries from arm
// k0, with the tile's costs and live flags tcost, tlive) into the row's
// state; sc_s / sc_d (or null) keep the tile for the tie pass
template <int AT>
__device__ __forceinline__ void scan_row(const FgtsArgs& p, RowState& s,
                                         const float* ts, const float* tden,
                                         const float* tcost,
                                         const uint8_t* tlive, int k0,
                                         float* sc_s, float* sc_d, int lane) {
  // the row's fields in registers: the state is written below
  const int a1 = s.a1, a2 = s.a2;
  const float pref = s.pref;
  float lmax = -CUDART_INF_F;
  int lcnt = 0, lfirst = INT_MAX;
  for (int kk = lane; kk < AT && k0 + kk < p.K; kk += 32) {
    const int k = k0 + kk;
    const float sv = ts[kk];
    if (k == a1) { s.s1 = sv; s.den1 = tden[kk]; }
    if (k == a2) { s.s2 = sv; s.den2 = tden[kk]; }
    if (sc_s != nullptr) { sc_s[k] = sv; sc_d[k] = tden[kk]; }
    if (!tlive[kk]) continue;
    const float tv = tilted(sv, pref, tcost[kk]);
    if (tv > lmax) { lmax = tv; lcnt = 1; lfirst = k; }
    else if (tv == lmax) { ++lcnt; }
  }
  float wmax = lmax;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
  int cnt = lmax == wmax ? lcnt : 0;
  int first = lmax == wmax ? lfirst : INT_MAX;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
  }
  if (lane == 0 && cnt > 0) {
    if (wmax > s.smax) {
      s.smax = wmax; s.cnt = cnt; s.kmax = first; s.dmax = tden[first - k0];
    } else if (wmax == s.smax) {
      s.cnt += cnt;
    }
  }
}

// the row's potential term (the forward), by its row thread
__device__ __forceinline__ float row_term(const FgtsArgs& p,
                                          const RowState s) {
  const float s_opp = tilted(p.j == 1 ? s.s2 : s.s1, s.pref, s.copp);
  const float z = __fmul_rn(s.y, __fsub_rn(s.s1, s.s2));
  const float mu_row = p.mu / (1.f + fmaxf(s.pref, 0.f));
  return __fmul_rn(__fsub_rn(__fmul_rn(p.eta, softplus(-z)),
                             __fmul_rn(mu_row, __fsub_rn(s.smax, s_opp))),
                   s.v);
}

// the gradient row's coefficients: c1 on a_a1, c2 on a_a2, cm on the
// single feel-good max (cnt == 1), wt (over den_k) on each tied one
struct GradCoef {
  float c1, c2, cm, wt;
};

__device__ __forceinline__ GradCoef grad_coef(const FgtsArgs& p,
                                              const RowState& s) {
  const float z = __fmul_rn(s.y, __fsub_rn(s.s1, s.s2));
  const float mu_row = p.mu / (1.f + fmaxf(s.pref, 0.f));
  const float dz = __fmul_rn(__fmul_rn(p.eta, -1.f / (1.f + expf(z))), s.y);
  // W on a1 and a2 (cancelling when a1 == a2), +mu_r on opp
  float w1 = s.a1 == s.a2 ? 0.f : dz;
  float w2 = s.a1 == s.a2 ? 0.f : -dz;
  if (p.j == 1) w2 = __fadd_rn(w2, mu_row);
  else w1 = __fadd_rn(w1, mu_row);
  GradCoef g;
  g.c1 = __fmul_rn(w1, s.v) / s.den1;
  g.c2 = __fmul_rn(w2, s.v) / s.den2;
  g.wt = __fmul_rn(-mu_row / (float)max(s.cnt, 1), s.v);
  g.cm = s.cnt == 1 ? g.wt / s.dmax : 0.f;
  return g;
}

// gradient row of one minibatch row into gq (d floats), by one warp:
// x_r * (c1 a_a1 + c2 a_a2 + the tied maxima's (wt / den_k) a_k, in arm
// order). xr: the row's x; arms: A's rows, ld floats apart (global or
// shared); sc / dn: the row's scores and den of every arm, costs / mask
// its arms' (null: 0 / all live), for ties.
template <int U = 8>
__device__ __forceinline__ void grad_row(const FgtsArgs& p,
                                         const RowState s, float* gq,
                                         const float* xr, const float* arms,
                                         int64_t ld, const float* sc,
                                         const float* dn, const float* costs,
                                         const uint8_t* mask, int lane) {
  const GradCoef g = grad_coef(p, s);
  const float c1 = g.c1, c2 = g.c2, cm = g.cm, wt = g.wt;
  const float* r1 = arms + s.a1 * ld;
  const float* r2 = arms + s.a2 * ld;
  const float* rm = arms + s.kmax * ld;
  const bool fused = s.cnt <= 1;       // no tie pass: apply x_r at once
  // U of the lane's columns at a time, their loads issued together
  for (int t0 = lane; t0 < p.d; t0 += 32 * U) {
    float v1[U], v2[U], vm[U], vx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + 32 * u;
      const bool ok = t < p.d;
      v1[u] = ok ? r1[t] : 0.f;
      v2[u] = ok ? r2[t] : 0.f;
      vm[u] = ok && s.cnt == 1 ? rm[t] : 0.f;
      vx[u] = ok && fused ? xr[t] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + 32 * u;
      if (t >= p.d) break;
      float gv = fmaf(c2, v2[u], __fmul_rn(c1, v1[u]));
      if (s.cnt == 1) gv = fmaf(cm, vm[u], gv);
      gq[t] = fused ? __fmul_rn(vx[u], gv) : gv;
    }
  }
  if (fused) return;
  for (int kb = 0; kb < p.K; kb += 32) {
    const int k = kb + lane;
    const bool tied =
        k < p.K && arm_live(mask, k) &&
        tilted(sc[k], s.pref, arm_cost(costs, k)) == s.smax;
    uint32_t bits = __ballot_sync(0xffffffffu, tied);
    while (bits) {
      const int kt = kb + __ffs(bits) - 1;
      bits &= bits - 1;
      const float ck = wt / dn[kt];
      const float* rk = arms + kt * ld;
      for (int t = lane; t < p.d; t += 32) gq[t] = fmaf(ck, rk[t], gq[t]);
    }
  }
  for (int t = lane; t < p.d; t += 32) gq[t] = __fmul_rn(xr[t], gq[t]);
}

// the group's n rows (gradient rows gr, RB x ld, or the row states'
// terms) added in row order to the block's partial
template <bool GRAD>
__device__ __forceinline__ void add_rows(const FgtsArgs& p, float* part,
                                         const float* gr, int ld,
                                         const RowState* rs, int nrows) {
  if (GRAD) {
    for (int t = threadIdx.x; t < p.d; t += kBlockThreads) {
      float acc = part[t];
      for (int q = 0; q < nrows; ++q) acc = __fadd_rn(acc, gr[q * ld + t]);
      part[t] = acc;
    }
  } else if (threadIdx.x == 0) {
    float acc = part[0];
    for (int q = 0; q < nrows; ++q) acc = __fadd_rn(acc, rs[q].term);
    part[0] = acc;
  }
}

// the chain's result (both modes): the cluster's partials (part: d floats
// for a gradient, 1 for a potential) in rank order, times g_c (gs null:
// 1), into out (C, d) or (C,), each block writing a slice of d through
// distributed shared memory
template <bool GRAD>
__device__ __forceinline__ void reduce_cluster(const float* gs, float* out,
                                               int d, const float* part,
                                               int c) {
  const uint32_t rank = sm90::cluster_rank(), ncl = gridDim.x;
  const float g = gs ? gs[c] : 1.f;
  sm90::cluster_sync();
  const int L = GRAD ? d : 1;
  for (int t = (int)(rank * kBlockThreads + threadIdx.x); t < L;
       t += (int)ncl * kBlockThreads) {
    float v[8];                          // every remote load in flight at once
#pragma unroll
    for (int b = 0; b < 8; ++b)
      v[b] = b < (int)ncl ? sm90::ld_cluster(sm90::map_rank(part + t, b)) : 0.f;
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (b < (int)ncl) acc = __fadd_rn(acc, v[b]);
    out[(int64_t)c * L + t] = gs ? __fmul_rn(g, acc) : acc;
  }
  sm90::cluster_sync();   // no block leaves while its partial may be read
}

// ---- Small: K <= 32, the routing shape -------------------------------------
//
// Groups of 8 rows against all (up to 32) arms. A thread takes one row, 4
// arms (ag + j * ng, ng = 4 arm groups for K <= 16, else 8) and one of S
// segments of d (S = 8, else 4): the 256 threads cover a group's pairs
// once. Each segment is walked in increasing t (one fma per t for each
// sum); a pair's S partial sums are then added in segment order. That is
// one fixed order for every arm, so duplicated arms still score bitwise
// equal. The walk is bound by shared memory (a warp's 16-byte load costs 4
// wavefronts, broadcast or not) and by issue, so each row load serves 4
// arms and the segments keep 8 warps busy on a group of 8 rows. All of A
// (32 arms x d) stays in shared memory for the block's life, so the
// gradient's arm rows come from there too, and a thread per column adds
// the gradient rows x_r * (c1 a_a1 + c2 a_a2 + cm a_max) in row order
// (a warp per row forms a row with a tied maximum first). Layout (floats):
// x, x*theta (later the tied rows' gradient rows) and x*x (8 x lda each),
// theta (dp), A (32 x lda), the segments' partial sums (2 x 8 x 8 x 32),
// the tile scores and den (8 x 32 each), the partial (dp), the arms' costs
// (32) and live flags (32 bytes); dp = d rounded up to 32, lda = dp + 4
// (neighbouring rows' float4 reads hit distinct banks).
constexpr int kSmallRows = 8, kSmallArms = 32, kSmallSegs = 8;

__host__ __device__ __forceinline__ int small_dp(int d) {
  return (d + 31) / 32 * 32;
}

inline size_t small_smem(int d) {
  const size_t dp = small_dp(d), lda = dp + 4;
  return 4 * (3 * kSmallRows * lda + dp + kSmallArms * lda +
              2 * kSmallSegs * kSmallRows * kSmallArms +
              2 * kSmallRows * kSmallArms + dp + kSmallArms) +
         kSmallArms;
}

// grid (cluster size, C), one cluster per chain, 256 threads
template <bool GRAD>
__global__ void __launch_bounds__(kBlockThreads, 1)
    fgts_kernel_small(FgtsArgs p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ RowState rs[kSmallRows];
  __shared__ __align__(8) uint64_t bars[2];   // A and theta; a group's x
  const int dp = small_dp(p.d), lda = dp + 4;
  float* xs = sm;
  float* xt = xs + kSmallRows * lda;    // then tied rows' gradient rows
  float* xx = xt + kSmallRows * lda;
  float* th = xx + kSmallRows * lda;
  float* as = th + dp;
  float* sn = as + kSmallArms * lda;    // [segment][row][arm] partials
  float* se = sn + kSmallSegs * kSmallRows * kSmallArms;
  float* ts = se + kSmallSegs * kSmallRows * kSmallArms;
  float* tden = ts + kSmallRows * kSmallArms;
  float* part = tden + kSmallRows * kSmallArms;
  float* tcost = part + dp;
  uint8_t* tlive = reinterpret_cast<uint8_t*>(tcost + kSmallArms);
  const int c = blockIdx.y, rank = (int)sm90::cluster_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // bulk copies where every row is 16-byte aligned, else cp.async
  const bool bulk = p.d % 4 == 0 && (uintptr_t)p.x % 16 == 0 &&
                    (uintptr_t)p.a % 16 == 0 && (uintptr_t)p.theta % 16 == 0;
  if (tid == 0) {
    sm90::mbar_init(&bars[0], 2);   // theta's and A's arrivals
    sm90::mbar_init(&bars[1], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  // a thread's arms ag + j * ng (j < 4), its row and its segment of d
  // (sgld_update.fgts_order's rule)
  const int rb = kSmallRows, ng = p.K <= 16 ? 4 : 8;
  const int nseg = kBlockThreads / (kSmallRows * ng), seg_len = dp / nseg;
  const int ag = tid % ng, row = tid / ng % kSmallRows;
  const int seg = tid / (ng * kSmallRows);
  const int i_end = min(p.m, (rank + 1) * p.rpb);
  int64_t r_next = 0;
  float v_next = 0.f;
  fetch_rows(p, rb, c, rank * p.rpb, i_end, r_next, v_next);
  // the arms' costs and live flags: loaded now, stored with the first group
  const float cost_t = tid < p.K ? arm_cost(p.costs, tid) : 0.f;
  const bool live_t = tid < p.K && arm_live(p.mask, tid);
  const float* theta_c = p.theta + (int64_t)c * p.d;
  if (bulk) {
    // one barrier phase for theta and A (two arrivals with their bytes)
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(&bars[0], (uint32_t)(p.d * 4));
      sm90::bulk_load(th, theta_c, p.d * 4, &bars[0]);
    }
    bulk_rows(as, lda, p.a, p.d, p.d, kSmallArms, p.K, dp,
              [](int k) { return k; }, &bars[0]);
    for (int t = p.d + tid; t < dp; t += kBlockThreads) th[t] = 0.f;
  } else {
    stage_rows(th, dp, theta_c, p.d, p.d, 1, 1, dp, [](int) { return 0; },
               false);
    stage_rows(as, lda, p.a, p.d, p.d, kSmallArms, p.K, dp,
               [](int k) { return k; }, false);
    sm90::cp_async_commit();
  }
  for (int t = tid; t < (GRAD ? p.d : 1); t += kBlockThreads) part[t] = 0.f;
  uint32_t x_phase = 0;

  for (int g0 = rank * p.rpb; g0 < i_end; g0 += rb) {
    const int nrows = min(rb, i_end - g0);
    if (tid < rb) {
      rs[tid].r = r_next;
      rs[tid].v = v_next;
    }
    __syncthreads();
    if (bulk) {
      bulk_rows(xs, lda, p.x, p.d, p.d, rb, nrows, dp,
                [&](int q) { return rs[q].r; }, &bars[1]);
    } else {
      stage_rows(xs, lda, p.x, p.d, p.d, rb, nrows, dp,
                 [&](int q) { return rs[q].r; }, false);
      sm90::cp_async_commit();
    }
    init_rows(p, rs, rb);
    fetch_rows(p, rb, c, g0 + rb, i_end, r_next, v_next);
    if (tid < kSmallArms) {
      tcost[tid] = cost_t;
      tlive[tid] = live_t;
    }
    if (bulk) {
      if (g0 == rank * p.rpb) sm90::mbar_wait(&bars[0], 0);
      sm90::mbar_wait(&bars[1], x_phase);
      x_phase ^= 1;
    } else {
      sm90::cp_async_wait<0>();
    }
    __syncthreads();
    // x*theta and x*x, a warp per row
    for (int q = warp; q < rb; q += kBlockWarps)
      for (int t = 4 * lane; t < dp; t += 128) {
        float xv[4];
        load_n<4>(xs + q * lda + t, xv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xt[q * lda + t + i] = __fmul_rn(xv[i], th[t + i]);
          xx[q * lda + t + i] = __fmul_rn(xv[i], xv[i]);
        }
      }
    __syncthreads();
    {
      // the segment's sums for (row, ag + j * ng): one fma per t, t in order
      const int t0 = seg * seg_len;
      const float* ur = xt + row * lda + t0;
      const float* wr = xx + row * lda + t0;
      const float* ar = as + ag * lda + t0;
      float n[4] = {0.f, 0.f, 0.f, 0.f}, e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int t = 0; t < seg_len; t += 4) {
        float u[4], w[4], a[4][4];
        load_n<4>(ur + t, u);
        load_n<4>(wr + t, w);
#pragma unroll
        for (int j = 0; j < 4; ++j) load_n<4>(ar + j * ng * lda + t, a[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            n[j] = fmaf(u[i], a[j][i], n[j]);
            e[j] = fmaf(w[i], __fmul_rn(a[j][i], a[j][i]), e[j]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int idx = (seg * kSmallRows + row) * kSmallArms + ag + j * ng;
        sn[idx] = n[j];
        se[idx] = e[j];
      }
    }
    __syncthreads();
    {
      // each pair's segments added in order, then its score
      const int prow = tid / kSmallArms, parm = tid % kSmallArms;
      const int base = prow * kSmallArms + parm;
      float n = sn[base], e = se[base];
      for (int g = 1; g < nseg; ++g) {
        n = __fadd_rn(n, sn[g * kSmallRows * kSmallArms + base]);
        e = __fadd_rn(e, se[g * kSmallRows * kSmallArms + base]);
      }
      const float dn = sqrtf(fmaxf(e, 1e-24f));
      ts[base] = __fdiv_rn(n, dn);
      tden[base] = dn;
    }
    __syncthreads();
    for (int q = warp; q < nrows; q += kBlockWarps)
      scan_row<kSmallArms>(p, rs[q], ts + q * kSmallArms,
                           tden + q * kSmallArms, tcost, tlive, 0, nullptr,
                           nullptr, lane);
    __syncthreads();
    if (!GRAD) {
      if (tid < nrows) rs[tid].term = row_term(p, rs[tid]);
      __syncthreads();
      add_rows<false>(p, part, xt, lda, rs, nrows);
    } else {
      if (tid < nrows) {
        const GradCoef g = grad_coef(p, rs[tid]);
        rs[tid].c1 = g.c1;
        rs[tid].c2 = g.c2;
        rs[tid].cm = g.cm;
      }
      // rows with a tied maximum: their whole gradient rows, a warp each
      for (int q = warp; q < nrows; q += kBlockWarps)
        if (rs[q].cnt > 1)
          grad_row(p, rs[q], xt + q * lda, xs + q * lda, as, lda,
                   ts + q * kSmallArms, tden + q * kSmallArms, tcost, tlive,
                   lane);
      __syncthreads();
      // a thread per column (d <= 4 * 256 here) adds the rows in order
      float acc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tid + i * kBlockThreads;
        acc[i] = t < p.d ? part[t] : 0.f;
      }
      for (int q = 0; q < nrows; ++q) {
        const RowState s = rs[q];
        const float* gx = xs + q * lda;
        if (s.cnt > 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = tid + i * kBlockThreads;
            if (t < p.d) acc[i] = __fadd_rn(acc[i], xt[q * lda + t]);
          }
          continue;
        }
        const float* r1 = as + s.a1 * lda;
        const float* r2 = as + s.a2 * lda;
        const float* rm = as + s.kmax * lda;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = tid + i * kBlockThreads;
          if (t >= p.d) break;
          float gv = fmaf(s.c2, r2[t], __fmul_rn(s.c1, r1[t]));
          if (s.cnt == 1) gv = fmaf(s.cm, rm[t], gv);
          acc[i] = __fadd_rn(acc[i], __fmul_rn(gx[t], gv));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = tid + i * kBlockThreads;
        if (t < p.d) part[t] = acc[i];
      }
    }
    __syncthreads();
  }
  // a block without rows still lets its copies land before it leaves
  if (bulk && i_end <= rank * p.rpb) sm90::mbar_wait(&bars[0], 0);
  reduce_cluster<GRAD>(p.g, p.out, p.d, part, c);
}

// ---- Large and Narrow: any K, the operations-bound shapes ------------------
//
// 4 row threads x 64 arm threads, each a TR x TA (rows x arms) outer-product
// tile of accumulators; a group of RB = 4 TR rows against tiles of 256 arms.
// The group's x*theta and x*x sit transposed ([dp][RB]) in shared memory,
// formed once per group, so at each t a thread reads its TR rows' values
// as one vector. Arm tiles stream through a ring of NST d-chunks (DC wide;
// arm-major rows of DC + 4, the thread's arms 64 apart so neighbouring
// lanes' float4 reads hit distinct banks), each issued NST - 1 chunks
// ahead by cp.async.
template <int TR_, int TA_, int DC_, int NST_>
struct Cfg {
  static constexpr int TR = TR_, TA = TA_, DC = DC_, NST = NST_;
  static constexpr int RTH = 4, ATH = kBlockThreads / RTH;
  static constexpr int RB = RTH * TR;       // minibatch rows per group
  static constexpr int AT = ATH * TA;       // arms per tile
  static constexpr int LD = DC + 4;         // a ring slot's padded row
  static constexpr int SLOT = AT * LD;
  static_assert(DC % 32 == 0 && NST >= 2, "chunks");
  __host__ __device__ static int dp(int d) { return (d + DC - 1) / DC * DC; }
  // xt, xx (RB x dp); the ring; tile scores and den (RB x AT each); theta
  // and the block's partial (dp each); the tile's costs (AT) and live
  // flags (AT bytes)
  static size_t smem(int d) {
    const size_t p = dp(d);
    return 4 * (2 * RB * p + (size_t)NST * SLOT + 2 * RB * AT + 2 * p + AT) +
           AT;
  }
};
// the wrapper's FGTS_CONFIGS mirrors Small, Large and Narrow, in this order
using Large = Cfg<4, 4, 32, 2>;
using Narrow = Cfg<1, 4, 32, 2>;

// chunk [t0, t0 + DC) of arms k0 .. k0 + AT - 1 into a ring slot
template <class G>
__device__ __forceinline__ void load_chunk(const FgtsArgs& p, float* slot,
                                           int k0, int t0, bool vec) {
  stage_rows(slot, G::LD, p.a + t0, p.d, p.d - t0, G::AT, p.K - k0, G::DC,
             [&](int q) { return k0 + q; }, vec);
}

// the first NST - 1 chunks of the arm tile at k0, one cp.async group each
template <class G>
__device__ __forceinline__ void tile_prologue(const FgtsArgs& p, float* ring,
                                              int k0, int n_ch, bool vec) {
#pragma unroll
  for (int s = 0; s < G::NST - 1; ++s) {
    if (s < n_ch) load_chunk<G>(p, ring + s * G::SLOT, k0, s * G::DC, vec);
    sm90::cp_async_commit();
  }
}

// scores and den of the group's RB rows (xt, xx) against the arm tile at k0
// into ts / tden (RB x AT): numerator and denominator one fma per t, t in
// increasing order, for every (row, arm); the caller issued the prologue
template <class G>
__device__ __forceinline__ void score_tile(const FgtsArgs& p, const float* xt,
                                           const float* xx, float* ring,
                                           float* ts, float* tden, int k0,
                                           int dp, bool vec) {
  const int n_ch = dp / G::DC;
  const int rt = threadIdx.x / G::ATH, at = threadIdx.x % G::ATH;
  float num[G::TR][G::TA], den[G::TR][G::TA];
#pragma unroll
  for (int i = 0; i < G::TR; ++i)
#pragma unroll
    for (int j = 0; j < G::TA; ++j) num[i][j] = den[i][j] = 0.f;
  for (int ch = 0; ch < n_ch; ++ch) {
    sm90::cp_async_wait<G::NST - 2>();   // this thread's copies of chunk ch
    __syncthreads();                     // everyone's; chunk ch - 1 is read
    const int nx = ch + G::NST - 1;
    if (nx < n_ch)
      load_chunk<G>(p, ring + (nx % G::NST) * G::SLOT, k0, nx * G::DC, vec);
    sm90::cp_async_commit();
    const float* ac = ring + (ch % G::NST) * G::SLOT + at * G::LD;
    const float* uc = xt + ch * G::DC * G::RB + rt * G::TR;
    const float* wc = xx + ch * G::DC * G::RB + rt * G::TR;
#pragma unroll
    for (int t = 0; t < G::DC; t += 4) {
      float a[G::TA][4];
#pragma unroll
      for (int j = 0; j < G::TA; ++j)
        load_n<4>(ac + j * G::ATH * G::LD + t, a[j]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float u[G::TR], w[G::TR];
        load_n<G::TR>(uc + (t + s) * G::RB, u);
        load_n<G::TR>(wc + (t + s) * G::RB, w);
#pragma unroll
        for (int j = 0; j < G::TA; ++j) {
          const float aa = __fmul_rn(a[j][s], a[j][s]);
#pragma unroll
          for (int i = 0; i < G::TR; ++i) {
            num[i][j] = fmaf(u[i], a[j][s], num[i][j]);
            den[i][j] = fmaf(w[i], aa, den[i][j]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < G::TR; ++i)
#pragma unroll
    for (int j = 0; j < G::TA; ++j) {
      const int idx = (rt * G::TR + i) * G::AT + at + j * G::ATH;
      const float dn = sqrtf(fmaxf(den[i][j], 1e-24f));
      ts[idx] = __fdiv_rn(num[i][j], dn);
      tden[idx] = dn;
    }
}

// grid (cluster size, C), one cluster per chain, 256 threads
template <class G, bool GRAD>
__global__ void __launch_bounds__(kBlockThreads, 1) fgts_kernel(FgtsArgs p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ RowState rs[G::RB];
  const int dp = G::dp(p.d);
  float* xt = sm;                       // x * theta, [dp][RB]
  float* xx = xt + G::RB * dp;          // x, then x * x; then gradient rows
  float* ring = xx + G::RB * dp;
  float* ts = ring + G::NST * G::SLOT;  // RB x AT
  float* tden = ts + G::RB * G::AT;
  float* th = tden + G::RB * G::AT;     // theta (dp)
  float* part = th + dp;                // this block's partial
  float* tcost = part + dp;             // the tile's costs and live flags
  uint8_t* tlive = reinterpret_cast<uint8_t*>(tcost + G::AT);
  const int c = blockIdx.y, rank = (int)sm90::cluster_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_ch = dp / G::DC;
  const bool spill = GRAD && p.K > G::AT;   // ties read the scratch
  const bool aligned = p.d % 4 == 0;
  const bool vec_a = aligned && (uintptr_t)p.a % 16 == 0;
  const int i_end = min(p.m, (rank + 1) * p.rpb);
  int64_t r_next = 0;
  float v_next = 0.f;
  fetch_rows(p, G::RB, c, rank * p.rpb, i_end, r_next, v_next);
  stage_rows(th, dp, p.theta + (int64_t)c * p.d, p.d, p.d, 1, 1, dp,
             [](int) { return 0; }, aligned && (uintptr_t)p.theta % 16 == 0);
  sm90::cp_async_commit();
  for (int t = tid; t < (GRAD ? p.d : 1); t += kBlockThreads) part[t] = 0.f;

  for (int g0 = rank * p.rpb; g0 < i_end; g0 += G::RB) {
    const int nrows = min(G::RB, i_end - g0);
    tile_prologue<G>(p, ring, 0, n_ch, vec_a);
    if (tid < G::RB) {
      rs[tid].r = r_next;
      rs[tid].v = v_next;
    }
    __syncthreads();
    // the group's rows x into xx, transposed (zeros past d and nrows)
    for (int e = tid; e < G::RB * dp; e += kBlockThreads) {
      const int q = e % G::RB, t = e / G::RB;
      const bool ok = q < nrows && t < p.d;
      sm90::cp_async_4(xx + e, ok ? p.x + rs[q].r * p.d + t : p.x,
                       ok ? 4 : 0);
    }
    sm90::cp_async_commit();
    init_rows(p, rs, G::RB);
    fetch_rows(p, G::RB, c, g0 + G::RB, i_end, r_next, v_next);
    sm90::cp_async_wait<0>();
    __syncthreads();
    for (int e = tid; e < G::RB * dp; e += kBlockThreads) {
      const float xv = xx[e];
      xt[e] = __fmul_rn(xv, th[e / G::RB]);
      xx[e] = __fmul_rn(xv, xv);
    }
    for (int k0 = 0; k0 < p.K; k0 += G::AT) {
      // the tile's costs and live flags: loaded now, stored after the walk
      const int kt = k0 + tid;
      const float cost_t = kt < p.K ? arm_cost(p.costs, kt) : 0.f;
      const bool live_t = kt < p.K && arm_live(p.mask, kt);
      score_tile<G>(p, xt, xx, ring, ts, tden, k0, dp, vec_a);
      if (tid < G::AT) {
        tcost[tid] = cost_t;
        tlive[tid] = live_t;
      }
      __syncthreads();
      if (k0 + G::AT < p.K) tile_prologue<G>(p, ring, k0 + G::AT, n_ch, vec_a);
      for (int q = warp; q < nrows; q += kBlockWarps) {
        float* sc = spill ? p.scratch + ((int64_t)c * p.m + g0 + q) * p.K
                          : nullptr;
        scan_row<G::AT>(p, rs[q], ts + q * G::AT, tden + q * G::AT, tcost,
                        tlive, k0, sc,
                        spill ? sc + (int64_t)p.C * p.m * p.K : nullptr,
                        lane);
      }
      __syncthreads();
    }
    if (!GRAD) {
      if (tid < nrows) rs[tid].term = row_term(p, rs[tid]);
    } else {
      // the gradient rows into xx (RB x dp, row-major), a warp per row
      for (int q = warp; q < nrows; q += kBlockWarps) {
        const int64_t row = (int64_t)c * p.m + g0 + q;
        const float* sc = spill ? p.scratch + row * p.K : ts + q * G::AT;
        const float* dn = spill ? sc + (int64_t)p.C * p.m * p.K
                                : tden + q * G::AT;
        grad_row(p, rs[q], xx + q * dp, p.x + rs[q].r * p.d, p.a, p.d, sc,
                 dn, p.costs, p.mask, lane);
      }
    }
    __syncthreads();
    add_rows<GRAD>(p, part, xx, dp, rs, nrows);
    __syncthreads();
  }
  reduce_cluster<GRAD>(p.g, p.out, p.d, part, c);
}

// one cluster of cl blocks per chain (either mode's kernel and arguments)
template <class Args>
int launch_clusters(void (*kernel)(Args), const Args& p, size_t smem, int cl,
                    cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess || p.C == 0) return (int)e;
  cudaLaunchConfig_t lc = {};
  lc.gridDim = dim3(cl, p.C);
  lc.blockDim = dim3(kBlockThreads);
  lc.dynamicSmemBytes = smem;
  lc.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  lc.attrs = attr;
  lc.numAttrs = 1;
  e = cudaLaunchKernelEx(&lc, kernel, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// cfg: 0 Small, 1 Large, 2 Narrow (sgld_update.fgts_plan)
template <bool GRAD>
int launch_fgts_as(const FgtsArgs& p, int cfg, int cl, cudaStream_t stream) {
  if (cl < 1 || cl > 8) return (int)cudaErrorInvalidValue;
  switch (cfg) {
    case 0:
      if (p.K > kSmallArms) return (int)cudaErrorInvalidValue;
      return launch_clusters(fgts_kernel_small<GRAD>, p, small_smem(p.d), cl,
                             stream);
    case 1:
      return launch_clusters(fgts_kernel<Large, GRAD>, p, Large::smem(p.d),
                             cl, stream);
    case 2:
      return launch_clusters(fgts_kernel<Narrow, GRAD>, p, Narrow::smem(p.d),
                             cl, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

FgtsArgs make_args(const void* theta, const void* x, const void* a1,
                   const void* a2, const void* y, const void* pref,
                   const void* rows, const void* valid, const void* a_emb,
                   const void* mask, const void* costs, const void* g,
                   void* scratch, void* out, int C, int m, int K, int d,
                   int j, float eta, float mu, int rpb) {
  FgtsArgs p;
  p.theta = (const float*)theta;
  p.x = (const float*)x;
  p.a1 = (const int32_t*)a1;
  p.a2 = (const int32_t*)a2;
  p.y = (const float*)y;
  p.pref = (const float*)pref;
  p.rows = (const int64_t*)rows;
  p.valid = (const float*)valid;
  p.a = (const float*)a_emb;
  p.mask = (const uint8_t*)mask;
  p.costs = (const float*)costs;
  p.g = (const float*)g;
  p.scratch = (float*)scratch;
  p.out = (float*)out;
  p.C = C; p.m = m; p.K = K; p.d = d; p.j = j;
  p.eta = eta; p.mu = mu;
  p.rpb = rpb;
  return p;
}

// ---------------------------------------------------------------------------
// "mixed" mode: the mixed duel + click estimator (no feel-good term)
//
// For chain c and minibatch row i (ring row r, is_duel_r > 0 for a duel):
//   duel:  eta * softplus(-y_r (s_a1 - s_a2))
//   click: eta * softplus(-s_a1) if y_r > 0.5 else eta * softplus(s_a1)
//   U_c   = sum_i valid_ci * term_i
//   dU_c  = g_c * sum_i x_r * (w1/den1 * a_a1 + w2/den2 * a_a2)
// with w1 = -w2 = eta * (-sigmoid(-z)) * y_r (z = y_r (s_a1 - s_a2)) on a
// duel (both 0 when a1 == a2, where the one-hot difference cancels), and
// w1 = eta * (-sigmoid(-s_a1) if y_r > 0.5 else sigmoid(s_a1)), w2 = 0 on a
// click.
//
// What bounds it: the bytes of the gathered rows (x_r, and the one or two
// arm rows it scores), so ~1.6 MB at C = 8, m = 64, d = 768, half a
// microsecond: latency and the launch. It scores only a1 (and a2 on a
// duel), never walking the K arms: its work is O(m * d) whatever K is.
//
// The design (one kernel, two entry points, like fgts mode):
// - One thread-block cluster per chain; the chain's m rows split evenly
//   over its blocks (sgld_update.mixed_plan), each block walking its rows
//   in groups of rb (8, fewer only where d leaves no room), a warp a row.
// - A thread per row reads the ring rows and table entries of up to 256
//   rows at once into shared memory, while theta's copy into shared memory
//   is in flight. Then each warp loads its row's x_r, a_a1 and (on a duel)
//   a_a2 straight into registers, every load of a round (1024 floats a
//   warp) issued before the fma chain: one latency round. 16-byte loads
//   where d % 4 == 0 and x, A and theta are 16-byte aligned, else 4-byte
//   ones (a rule, not a fallback). Staging the rows in shared memory
//   first, by bulk copies or cp.async, measured slower on the H100
//   (PERF.md, section 6).
// - Lane l adds its loads l, l + 32, ... (float4s, or single floats on
//   the 4-byte rule) in order, one fma per element, then a fixed xor tree,
//   so every lane holds the row's sums; a click runs the same code for
//   its one arm. tests/test_torch_kernels.py emulates this order.
// - The forward adds the rows' terms in row order. The gradient's warp
//   writes its row x_r * (c1 a_a1 + c2 a_a2) to shared memory (from the
//   values still in registers when d fits one round), and a thread per 4
//   columns adds the group's rows in row order into the block's partial,
//   one block barrier a group (two buffers of rows). reduce_cluster adds
//   the partials in rank order over distributed shared memory, times g_c,
//   straight into out. One launch, no atomics: bitwise repeatable, and
//   capturable in a CUDA graph.
// ---------------------------------------------------------------------------

constexpr int kMixedRows = kBlockWarps;   // most rows per group: a warp each
// rows whose table entries a block reads in one pass, a thread each
constexpr int kMetaRows = kBlockThreads;

struct MixedArgs {
  const float* theta;      // (C, d)
  const float* x;          // (N, d) ring rows
  const int32_t* a1;       // (N,)
  const int32_t* a2;       // (N,) used on duel rows only
  const float* y;          // (N,) duels +-1, clicks 0/1
  const float* duel;       // (N,) > 0 on a duel row
  const int64_t* rows;     // (C, m)
  const float* valid;      // (C, m)
  const float* a;          // (K, d)
  const float* g;          // (C,) or null (= 1)
  float* out;              // (C, d) gradient or (C,) potential
  int C, m, d;
  float eta;
  int rpb, rb;             // rows per block and per group (mixed_plan)
};

// a minibatch row's table entries, then its potential term
struct MixedRow {
  int64_t r;
  int a1, a2;              // a2 == a1 on a click
  float y, v;
  int duel;
  float term;
};

// d rounded up to 4: gradient rows are dp floats
__host__ __device__ __forceinline__ int mixed_dp(int d) {
  return (d + 3) / 4 * 4;
}

// dynamic shared memory: theta and the block's partial (dp each) and two
// buffers of rb gradient rows (dp each)
inline size_t mixed_smem(int rb, int d) {
  return 4 * (size_t)mixed_dp(d) * (2 + 2 * rb);
}

// minibatch slot i of chain c: its ring row and table entries
__device__ __forceinline__ void mixed_read_row(const MixedArgs& p, int c,
                                               int i, MixedRow& mr) {
  const int64_t slot = (int64_t)c * p.m + i;
  const int64_t r = p.rows[slot];
  const bool duel = p.duel[r] > 0.f;
  const int a1 = p.a1[r], a2 = p.a2[r];
  mr.r = r;
  mr.v = p.valid[slot];
  mr.a1 = a1;
  mr.a2 = duel ? a2 : a1;
  mr.y = p.y[r];
  mr.duel = duel;
}

// one warp's sum over its lanes: lane l adds lane l ^ o's value for o =
// 16, 8, 4, 2, 1, so every lane ends with the same sum
__device__ __forceinline__ float xor_tree(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// W floats at p (global, or shared where SH) into v (W = 4: one 16-byte
// load), zeros where !ok
template <int W, bool SH = false>
__device__ __forceinline__ void load_w(const float* p, bool ok, float* v) {
  if constexpr (W == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 f = !ok ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : SH ? *q : __ldg(q);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    v[0] = !ok ? 0.f : SH ? *p : __ldg(p);
  }
}

// One warp scores minibatch row mr straight from global memory: lane l
// takes loads l, l + 32, ... of W floats (16-byte loads where d % 4 == 0
// and the tables are 16-byte aligned, else 4-byte) of x_r, a_a1 and, on a
// duel, a_a2, and of theta (th, in shared memory), U loads of each (1024
// floats a warp) issued before the fma chain; it adds one fma per element
// in order, then the xor tree. The forward leaves the row's term in mr; the gradient
// writes the row x_r * (c1 a_a1 + c2 a_a2) to gr (a click has c2 = 0 and
// takes its a_a1 twice), from the values still in registers when d fits
// one round of loads. Every lane holds the same sums after the xor tree,
// so every lane computes the same c1 and c2.
template <bool GRAD, int W>
__device__ __forceinline__ void mixed_row(const MixedArgs& p, MixedRow& mr,
                                          const float* th, float* gr,
                                          int lane) {
  constexpr int U = 32 / W;
  const bool duel = mr.duel;
  const float* xr = p.x + mr.r * p.d;
  const float* u = p.a + (int64_t)mr.a1 * p.d;
  const float* w = p.a + (int64_t)mr.a2 * p.d;
  float xv[U][W], uv[U][W], wv[U][W];
  const auto load = [&](int t0) {
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int t = t0 + (32 * k + lane) * W;
      const bool ok = t < p.d;
      load_w<W>(xr + t, ok, xv[k]);
      load_w<W>(u + t, ok, uv[k]);
      load_w<W>(w + t, ok && duel, wv[k]);
    }
  };
  float n1 = 0.f, e1 = 0.f, n2 = 0.f, e2 = 0.f;
  for (int t0 = 0; t0 < p.d; t0 += 32 * U * W) {
    float tv[U][W];
    load(t0);
#pragma unroll
    for (int k = 0; k < U; ++k)
      load_w<W, true>(th + t0 + (32 * k + lane) * W,
                      t0 + (32 * k + lane) * W < p.d, tv[k]);
    // past d every value is 0: adding 0 leaves a sum as it is
#pragma unroll
    for (int k = 0; k < U; ++k)
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const float xt = __fmul_rn(xv[k][i], tv[k][i]);
        const float xx = __fmul_rn(xv[k][i], xv[k][i]);
        n1 = fmaf(xt, uv[k][i], n1);
        e1 = fmaf(xx, __fmul_rn(uv[k][i], uv[k][i]), e1);
        n2 = fmaf(xt, wv[k][i], n2);
        e2 = fmaf(xx, __fmul_rn(wv[k][i], wv[k][i]), e2);
      }
  }
  n1 = xor_tree(n1);
  e1 = xor_tree(e1);
  n2 = xor_tree(n2);
  e2 = xor_tree(e2);
  const float den1 = sqrtf(fmaxf(e1, 1e-24f)), s1 = __fdiv_rn(n1, den1);
  const float den2 = sqrtf(fmaxf(e2, 1e-24f)), s2 = __fdiv_rn(n2, den2);
  const float y = mr.y, v = mr.v;
  if (!GRAD) {
    const float term = duel ? softplus(-__fmul_rn(y, __fsub_rn(s1, s2)))
                            : (y > 0.5f ? softplus(-s1) : softplus(s1));
    if (lane == 0) mr.term = __fmul_rn(__fmul_rn(p.eta, term), v);
    return;
  }
  float c1, c2 = 0.f;
  if (duel) {
    const float z = __fmul_rn(y, __fsub_rn(s1, s2));
    const float dz = __fmul_rn(__fmul_rn(p.eta, -1.f / (1.f + expf(z))), y);
    const float w1 = mr.a1 == mr.a2 ? 0.f : dz;
    c1 = __fdiv_rn(__fmul_rn(w1, v), den1);
    c2 = __fdiv_rn(__fmul_rn(-w1, v), den2);
  } else {
    const float w1 = __fmul_rn(p.eta, y > 0.5f ? -1.f / (1.f + expf(s1))
                                               : 1.f / (1.f + expf(-s1)));
    c1 = __fdiv_rn(__fmul_rn(w1, v), den1);
  }
  for (int t0 = 0; t0 < p.d; t0 += 32 * U * W) {
    if (p.d > 32 * U * W) load(t0);    // else still in registers
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int t = t0 + (32 * k + lane) * W;
      if (t >= p.d) break;
#pragma unroll
      for (int i = 0; i < W; ++i)
        gr[t + i] = __fmul_rn(
            xv[k][i], fmaf(c2, duel ? wv[k][i] : uv[k][i],
                           __fmul_rn(c1, uv[k][i])));
    }
  }
}

// a thread per 4 columns adds the group's gradient rows gr (rows of dp
// floats) in row order to the block's partial
__device__ __forceinline__ void mixed_add_rows(float* part, const float* gr,
                                               int nrows, int d, int dp) {
  for (int t = 4 * (int)threadIdx.x; t < d; t += 4 * kBlockThreads) {
    float acc[4], gv[4];
    load_n<4>(part + t, acc);
#pragma unroll
    for (int q = 0; q < kMixedRows; ++q) {
      if (q >= nrows) break;
      load_n<4>(gr + q * dp + t, gv);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], gv[i]);
    }
    *reinterpret_cast<float4*>(part + t) = make_float4(acc[0], acc[1], acc[2],
                                                       acc[3]);
  }
}

// grid (cluster size, C), one cluster per chain, 256 threads; W as for
// mixed_row
template <bool GRAD, int W>
__global__ void __launch_bounds__(kBlockThreads, 1) mixed_kernel(MixedArgs p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ MixedRow meta[kMetaRows];
  const int dp = mixed_dp(p.d), rb = p.rb;
  float* th = sm;                       // theta_c
  float* part = th + dp;                // this block's partial
  float* grs = part + dp;               // two buffers of rb gradient rows
  const int c = blockIdx.y, rank = (int)sm90::cluster_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = rank * p.rpb, i_end = min(p.m, i0 + p.rpb);
  // theta once a block, its copies in flight while the tables are read
  const float* theta_c = p.theta + (int64_t)c * p.d;
  for (int t = W * tid; t < p.d; t += W * kBlockThreads) {
    if (W == 4) sm90::cp_async_16(th + t, theta_c + t, 16);
    else sm90::cp_async_4(th + t, theta_c + t, 4);
  }
  sm90::cp_async_commit();
  for (int t = tid; t < (GRAD ? dp : 1); t += kBlockThreads) part[t] = 0.f;
  int g_base = 0;                       // groups of the passes before
  for (int m0 = i0; m0 < i_end; m0 += kMetaRows) {
    // a pass: every row's table entries at once, then its groups
    const int nm = min(kMetaRows, i_end - m0), ng = (nm + rb - 1) / rb;
    __syncthreads();                    // the pass before is done
    if (tid < nm) mixed_read_row(p, c, m0 + tid, meta[tid]);
    sm90::cp_async_wait<0>();           // this thread's copies of theta
    __syncthreads();
    for (int k = 0; k < ng; ++k) {
      const int nrows = min(rb, nm - k * rb);
      float* gr = grs + ((g_base + k) & 1) * rb * dp;
      MixedRow* gm = meta + k * rb;
      if (warp < nrows)
        mixed_row<GRAD, W>(p, gm[warp], th, gr + warp * dp, lane);
      // one barrier a group: the other buffer's rows were added before it
      __syncthreads();
      if (GRAD) {
        mixed_add_rows(part, gr, nrows, p.d, dp);
      } else if (tid == 0) {
        float acc = part[0];
        for (int q = 0; q < nrows; ++q) acc = __fadd_rn(acc, gm[q].term);
        part[0] = acc;
      }
    }
    g_base += ng;
  }
  reduce_cluster<GRAD>(p.g, p.out, p.d, part, c);
}

// cl blocks per chain, rpb rows per block, rb per group (mixed_plan);
// 16-byte loads where d % 4 == 0 and x, A and theta are 16-byte aligned
template <bool GRAD>
int launch_mixed(const MixedArgs& p, int cl, cudaStream_t stream) {
  if (cl < 1 || cl > 8 || p.rb < 1 || p.rb > kMixedRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mixed_smem(p.rb, p.d);
  const bool vec = p.d % 4 == 0 && (uintptr_t)p.x % 16 == 0 &&
                   (uintptr_t)p.a % 16 == 0 && (uintptr_t)p.theta % 16 == 0;
  return vec ? launch_clusters(mixed_kernel<GRAD, 4>, p, smem, cl, stream)
             : launch_clusters(mixed_kernel<GRAD, 1>, p, smem, cl, stream);
}

MixedArgs make_mixed_args(const void* theta, const void* x, const void* a1,
                          const void* a2, const void* y, const void* is_duel,
                          const void* rows, const void* valid,
                          const void* a_emb, const void* g, void* out, int C,
                          int m, int d, float eta, int rpb, int rb) {
  MixedArgs p;
  p.theta = (const float*)theta;
  p.x = (const float*)x;
  p.a1 = (const int32_t*)a1;
  p.a2 = (const int32_t*)a2;
  p.y = (const float*)y;
  p.duel = (const float*)is_duel;
  p.rows = (const int64_t*)rows;
  p.valid = (const float*)valid;
  p.a = (const float*)a_emb;
  p.g = (const float*)g;
  p.out = (float*)out;
  p.C = C; p.m = m; p.d = d;
  p.eta = eta;
  p.rpb = rpb; p.rb = rb;
  return p;
}

}  // namespace

#define SGLD_PARAMS                                                        \
  const void *theta, const void *x, const void *a1, const void *a2,        \
      const void *y, const void *pref, const void *rows, const void *valid, \
      const void *a_emb, const void *mask, const void *costs,              \
      const void *g, void *scratch, void *out, int C, int m, int K, int d, \
      int j, float eta, float mu, int cfg, int cl, int rpb, void *stream
#define SGLD_ARGS                                                          \
  make_args(theta, x, a1, a2, y, pref, rows, valid, a_emb, mask, costs, g, \
            scratch, out, C, m, K, d, j, eta, mu, rpb)

// cfg: 0 Small, 1 Large, 2 Narrow; cl blocks per chain (the cluster), rpb
// rows per block (sgld_update.fgts_plan); scratch unused; out: (C,)
extern "C" int sgld_potential_fwd_launch(SGLD_PARAMS) {
  return launch_fgts_as<false>(SGLD_ARGS, cfg, cl, (cudaStream_t)stream);
}

// scratch: (2, C, m, K) floats when K exceeds the configuration's arm tile,
// else unused; out: (C, d)
extern "C" int sgld_potential_grad_launch(SGLD_PARAMS) {
  return launch_fgts_as<true>(SGLD_ARGS, cfg, cl, (cudaStream_t)stream);
}

#define MIXED_PARAMS                                                       \
  const void *theta, const void *x, const void *a1, const void *a2,        \
      const void *y, const void *is_duel, const void *rows,                \
      const void *valid, const void *a_emb, const void *g, void *out,      \
      int C, int m, int d, float eta, int cl, int rpb, int rb, void *stream
#define MIXED_ARGS                                                         \
  make_mixed_args(theta, x, a1, a2, y, is_duel, rows, valid, a_emb, g,     \
                  out, C, m, d, eta, rpb, rb)

// cl blocks per chain (the cluster), rpb rows per block, rb rows per group
// (sgld_update.mixed_plan); out: (C,)
extern "C" int sgld_mixed_fwd_launch(MIXED_PARAMS) {
  return launch_mixed<false>(MIXED_ARGS, cl, (cudaStream_t)stream);
}

// out: (C, d)
extern "C" int sgld_mixed_grad_launch(MIXED_PARAMS) {
  return launch_mixed<true>(MIXED_ARGS, cl, (cudaStream_t)stream);
}
