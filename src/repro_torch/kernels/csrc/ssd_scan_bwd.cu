// Mamba-2 chunked SSD scan, backward, for sm_90a: the gradient of ssd_scan.cu's function.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// src/repro/models/ssd.py:65-126::ssd_chunked (its Pallas kernel has no backward), and this
// is that gradient. Inputs: the forward's x (B,S,H,P), B and C (B,S,N) shared by the heads
// (fp32 or bf16, widened on load, read through their batch and sequence strides), log_a and
// dt (B,S,H) fp32, h0 (B,H,P,N) fp32 or NULL, and the incoming gradients dy (B,S,H,P) and
// dh_last (B,H,P,N) fp32 (NULL: zero). Outputs: dx (B,S,H,P), dB, dC (B,S,N) in the inputs'
// dtype (rounded once from fp32), dlog_a, ddt (B,S,H) and dh0 fp32. Per chunk c of L steps,
// with H_{c-1} the state entering it and dH_c the gradient reaching the state after it:
//
//   dH_{c-1} = e^{cum_L} dH_c + sum_i e^{cum_i} dy_i C_i^T
//   bracket_j = sum_{i>=j} CB_ij e^{cum_i - cum_j} dy_i + e^{cum_L - cum_j} dH_c B_j
//   dx_j = dt_j bracket_j,  ddt_j = x_j . bracket_j
//   dCB_ij = (dy_i . x_j) e^{cum_i - cum_j} dt_j                    (j <= i)
//   dC_i = sum_j dCB_ij B_j + e^{cum_i} H_{c-1}^T dy_i             (summed over heads)
//   dB_j = sum_i dCB_ij C_i + e^{cum_L - cum_j} dt_j dH_c^T x_j    (summed over heads)
//   dcum_i = dy_i . y_intra_i + C_i . (e^{cum_i} H_{c-1}^T dy_i) - dt_i ddt_i
//            + [i = L-1] (sum_j U_j + e^{cum_L} <H_{c-1}, dH_c>),
//   U_j = e^{cum_L - cum_j} dt_j x_j . (dH_c B_j),  dlog_a = reverse cumsum of dcum per chunk
//
// (dy_i . y_intra_i is the row sum of T_ij = dCB_ij CB_ij, and dt_i ddt_i its column sum plus
// U_i: the terms of the plain version ssd_scan_bwd_plain, gathered.) Only pairs j <= i are
// formed, so every exponential is at most 1 and none overflows (the reference forms
// exp(cum_i - cum_j) for j > i too, which overflows at mamba2-1.3b's decays and makes its
// gradient NaN: the mask here goes on the exponent).
//
// Three launches, every sum in a fixed order (no atomics), so results repeat bitwise:
// 1. ssd_bwd_states_kernel, grid (B*H, P/32, 2): z 0 walks the chunks forwards and writes
//    each chunk's entry state H_{c-1} into a (B, nc, H, P, N) fp32 scratch; z 1 walks them
//    backwards and writes dH_c into a second one, then dh0. Both are the forward's state
//    update H' = e^{cum_L} H + sum_j v_j w_j^T (v = e^{cum_L-cum_j} dt x, w = B; or
//    v = e^{cum_i} dy, w = C), the state split by rows of P, 4 x 4 register tiles a thread.
// 2. ssd_bwd_chunk_kernel, grid (n_chunks, H, B): a block per (batch, chunk, head), every
//    chunk independent given the two scratches. B, C and an L x L tile in shared memory
//    (first CB e^{cum_i-cum_j}, then dCB), x and dy in passes of 16 columns of P; writes dx,
//    ddt, dlog_a and this head's dB and dC into (B,S,H,N) fp32 scratches.
// 3. ssd_bwd_reduce_kernel, grid (S, B): dB and dC summed over the heads in order, rounded
//    to the inputs' dtype.
//
// Bound: operations. Per (batch, head, chunk) at L 128, P 64, N 128 the gradient needs
// about 17 MFLOP on the CUDA cores as done here (CB 4.2, G 2.1, the bracket 3.1, dC and dB
// 4.2 each, ~half of the L x L products causal) plus 4 MFLOP for the two state walks;
// memory: the inputs read once, the outputs written once, and the scratches (2 x 134 MB of
// states and 2 x 268 MB of per-head dB / dC at mamba2-1.3b's B 2, S 4096) written and read
// once each. A first design on the CUDA cores in fp32, like ssd_scan.cu's SIMT kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LMAX = 128;   // chunk length at most (a multiple of 16)
constexpr int NMAX = 128;   // state width at most
constexpr int NS = NMAX + 1;
constexpr int WS = LMAX + 1;
constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* x;
  const void* bt;
  const void* ct;
  const float* la;
  const float* dt;
  const float* h0;
  const float* dy;       // (B,S,H,P) contiguous
  const float* dh_last;  // (B,H,P,N) or NULL
  void* dx;              // (B,S,H,P), the dtype of x
  void* dbt;             // (B,S,N), the dtype of x
  void* dct;
  float* dla;            // (B,S,H)
  float* ddt;
  float* dh0;            // (B,H,P,N) or NULL
  float* states;         // (B,nc,H,P,N): H_{c-1}
  float* dstates;        // (B,nc,H,P,N): dH_c
  float* dbp;            // (B,S,H,N): each head's dB
  float* dcp;            // (B,S,H,N): each head's dC
  int B, S, H, P, N, L, nc;
  long long x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, a_sb, a_ss, a_sh, d_sb, d_ss, d_sh;
};

// cum = cumsum(log_a) (in order, one thread, as the forward kernels and jnp.cumsum sum a
// chunk) and dt of chunk c of (b, h) into shared memory; steps past S have log_a = dt = 0.
// Every thread of the block calls it.
__device__ void chunk_scalars(const Args& g, int b, int h, int c, float* cum, float* dts) {
  const int s0 = c * g.L;
  const float* la = g.la + b * g.a_sb + h * g.a_sh;
  const float* dtp = g.dt + b * g.d_sb + h * g.d_sh;
  for (int i = threadIdx.x; i < g.L; i += blockDim.x) {
    const int s = s0 + i;
    cum[i] = s < g.S ? la[s * g.a_ss] : 0.f;
    dts[i] = s < g.S ? dtp[s * g.d_ss] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < g.L; ++i) {
      acc += cum[i];
      cum[i] = acc;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// 1. the chunk states, forwards (H_{c-1}) and backwards (dH_c, dh0)
// ---------------------------------------------------------------------------

constexpr int PT1 = 32;   // state rows per block
constexpr int XS1 = PT1 + 1;
constexpr int SMEM1_FLOATS = LMAX * NMAX + LMAX * XS1 + 2 * LMAX;

// thread (tp = tid / 32, tn = tid % 32) owns rows p0 + tp + 8 u and columns tn + 32 k
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_states_kernel(const Args g) {
  extern __shared__ float smem[];
  float* ws = smem;                // [LMAX][NMAX]: B (forwards) or C (backwards)
  float* us = ws + LMAX * NMAX;    // [LMAX][XS1]: x or dy, this block's rows of P
  float* cum = us + LMAX * XS1;    // [LMAX]
  float* cf = cum + LMAX;          // [LMAX]: dt, then the coefficient of v

  const int tid = threadIdx.x, tp = tid / 32, tn = tid % 32;
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const int p0 = blockIdx.y * PT1;
  const bool rev = blockIdx.z == 1;
  const int L = g.L, N = g.N, P = g.P, S = g.S, H = g.H;
  const T* w = (const T*)(rev ? g.ct : g.bt) + b * (rev ? g.c_sb : g.b_sb);
  const long long w_ss = rev ? g.c_ss : g.b_ss;
  const T* x = (const T*)g.x + b * g.x_sb + h * g.x_sh;
  const size_t hrow = ((size_t)b * H + h) * P;   // (B,H,P,N): row p of (b, h)
  const float* init = rev ? g.dh_last : g.h0;
  float* out = rev ? g.dstates : g.states;

  float st[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = p0 + tp + 8 * u, n = tn + 32 * k;
      st[u][k] = (init != nullptr && p < P && n < N) ? init[(hrow + p) * N + n] : 0.f;
    }
  for (int it = 0; it < g.nc; ++it) {
    const int c = rev ? g.nc - 1 - it : it;
    const int s0 = c * L;
    const size_t orow = (((size_t)b * g.nc + c) * H + h) * P;   // (B,nc,H,P,N)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + tp + 8 * u, n = tn + 32 * k;
        if (p < P && n < N) out[(orow + p) * N + n] = st[u][k];
      }
    chunk_scalars(g, b, h, c, cum, cf);
    for (int e = tid; e < L * NMAX; e += THREADS) {
      const int j = e / NMAX, n = e % NMAX, s = s0 + j;
      ws[e] = (s < S && n < N) ? widen(w[s * w_ss + n]) : 0.f;
    }
    for (int e = tid; e < L * PT1; e += THREADS) {
      const int j = e / PT1, q = e % PT1, s = s0 + j, p = p0 + q;
      float v = 0.f;
      if (s < S && p < P)
        v = rev ? g.dy[(((size_t)b * S + s) * H + h) * P + p] : widen(x[s * g.x_ss + p]);
      us[j * XS1 + q] = v;
    }
    if (tid < L) cf[tid] = rev ? expf(cum[tid]) : expf(cum[L - 1] - cum[tid]) * cf[tid];
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[u][k] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float f = cf[j];
      float uv[4], wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) uv[u] = us[j * XS1 + tp + 8 * u] * f;
#pragma unroll
      for (int k = 0; k < 4; ++k) wv[k] = ws[j * NMAX + tn + 32 * k];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[u][k] += uv[u] * wv[k];
    }
    const float ea = expf(cum[L - 1]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) st[u][k] = ea * st[u][k] + acc[u][k];
    __syncthreads();  // before the next chunk overwrites ws, us, cum, cf
  }
  if (rev && g.dh0 != nullptr) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + tp + 8 * u, n = tn + 32 * k;
        if (p < P && n < N) g.dh0[(hrow + p) * N + n] = st[u][k];
      }
  }
}

// ---------------------------------------------------------------------------
// 2. one (batch, chunk, head): dx, ddt, dlog_a and this head's dB and dC
// ---------------------------------------------------------------------------

constexpr int PT = 16;    // columns of P per pass
constexpr int PS = PT + 1;
constexpr int SMEM2_FLOATS = 3 * LMAX * NS + 2 * LMAX * PS + PT * NS + 12 * LMAX;

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_chunk_kernel(const Args g) {
  extern __shared__ float smem[];
  float* Bs = smem;              // [LMAX][NS]
  float* Cs = Bs + LMAX * NS;    // [LMAX][NS]
  float* Ms = Cs + LMAX * NS;    // [LMAX][WS]: CB_ij e^{cum_i - cum_j}, then dCB_ij (j <= i)
  float* xs = Ms + LMAX * WS;    // [LMAX][PS]: 16 columns of x
  float* gs = xs + LMAX * PS;    // [LMAX][PS]: the same columns of dy
  float* hs = gs + LMAX * PS;    // [PT][NS]: the same rows of H_{c-1} or dH_c
  float* cum = hs + PT * NS;     // [LMAX]
  float* dts = cum + LMAX;
  float* ei = dts + LMAX;        // e^{cum_i}
  float* eo = ei + LMAX;         // e^{cum_L - cum_j}
  float* rs = eo + LMAX;         // dy_i . y_intra_i
  float* dd = rs + LMAX;         // ddt_j
  float* uu = dd + LMAX;         // x_j . (e^{cum_L - cum_j} dH_c B_j)
  float* ci = uu + LMAX;         // C_i . (e^{cum_i} H_{c-1}^T dy_i)
  float* red = ci + LMAX;        // [4][LMAX]
  __shared__ float hd_part[THREADS / 32];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int L = g.L, N = g.N, P = g.P, S = g.S, H = g.H, s0 = c * L, nb = L / 16;
  const T* x = (const T*)g.x + b * g.x_sb + h * g.x_sh;
  const T* bt = (const T*)g.bt + b * g.b_sb;
  const T* ct = (const T*)g.ct + b * g.c_sb;
  const size_t sbase = (((size_t)b * g.nc + c) * H + h) * P * N;
  const float* Hp = g.states + sbase;    // H_{c-1} (P x N)
  const float* dHc = g.dstates + sbase;  // dH_c (P x N)
  const size_t yrow = ((size_t)b * S + s0) * H + h;  // (B,S,H) index of step s0

  // x and dy columns p0 .. p0 + 15 of the chunk, and rows p0 .. of a P x N state
  auto load_x_dy = [&](int p0, bool want_x, bool want_dy) {
    for (int e = tid; e < LMAX * PT; e += THREADS) {
      const int j = e / PT, q = e % PT, s = s0 + j, p = p0 + q;
      const bool ok = j < L && s < S && p < P;
      if (want_x) xs[j * PS + q] = ok ? widen(x[s * g.x_ss + p]) : 0.f;
      if (want_dy) gs[j * PS + q] = ok ? g.dy[(yrow + (size_t)j * H) * P + p] : 0.f;
    }
  };
  auto load_state_rows = [&](const float* st, int p0) {
    for (int e = tid; e < PT * NMAX; e += THREADS) {
      const int q = e / NMAX, n = e % NMAX, p = p0 + q;
      hs[q * NS + n] = (p < P && n < N) ? st[(size_t)p * N + n] : 0.f;
    }
  };

  // phase 0: B, C, the chunk's scalars, <H_{c-1}, dH_c>
  chunk_scalars(g, b, h, c, cum, dts);
  for (int e = tid; e < LMAX * NMAX; e += THREADS) {
    const int j = e / NMAX, n = e % NMAX, s = s0 + j;
    const bool ok = j < L && s < S && n < N;
    Bs[j * NS + n] = ok ? widen(bt[s * g.b_ss + n]) : 0.f;
    Cs[j * NS + n] = ok ? widen(ct[s * g.c_ss + n]) : 0.f;
  }
  if (tid < L) {
    ei[tid] = expf(cum[tid]);
    eo[tid] = expf(cum[L - 1] - cum[tid]);
    rs[tid] = dd[tid] = uu[tid] = 0.f;
  }
  {
    float hd = 0.f;
    for (int e = tid; e < P * N; e += THREADS) hd += Hp[e] * dHc[e];
    hd = warp_sum(hd);
    if (lane == 0) hd_part[warp] = hd;
  }
  __syncthreads();

  // Ms = CB_ij e^{cum_i - cum_j} (j <= i), 0 above the diagonal; 8 x 8 register tiles over
  // rows interleaved by 16
  {
    const int ti = tid / 16, tj = tid % 16;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) cv[r] = r < nb ? Cs[(ti + 16 * r) * NS + n] : 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) bv[q] = q < nb ? Bs[(tj + 16 * q) * NS + n] : 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] += cv[r] * bv[q];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = ti + 16 * r, j = tj + 16 * q;
        if (r < nb && q < nb) Ms[i * WS + j] = j <= i ? acc[r][q] * expf(cum[i] - cum[j]) : 0.f;
      }
  }
  __syncthreads();

  // phase 1, by 16 columns of P: the bracket (dx, ddt, U) and dy_i . y_intra_i. Thread
  // (row jr, half) owns row jr and columns 8 half .. 8 half + 7 of the pass.
  const int jr = tid % LMAX, half = tid / LMAX;
  for (int p0 = 0; p0 < P; p0 += PT) {
    load_x_dy(p0, true, true);
    load_state_rows(dHc, p0);
    __syncthreads();
    if (jr < L) {
      const int j = jr;
      float br[8], p2[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) br[q] = p2[q] = 0.f;
      for (int i = j & ~31; i < L; ++i) {  // Ms is 0 for i < j
        const float m = Ms[i * WS + j];
#pragma unroll
        for (int q = 0; q < 8; ++q) br[q] += m * gs[i * PS + 8 * half + q];
      }
      for (int n = 0; n < N; ++n) {
        const float bv = Bs[j * NS + n];
#pragma unroll
        for (int q = 0; q < 8; ++q) p2[q] += bv * hs[(8 * half + q) * NS + n];
      }
      float sdd = 0.f, su = 0.f;
      const int s = s0 + j;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int p = p0 + 8 * half + q;
        const float t2 = eo[j] * p2[q];
        const float bk = br[q] + t2;
        const float xv = xs[j * PS + 8 * half + q];
        sdd += xv * bk;
        su += xv * t2;
        if (s < S && p < P) narrow((T*)g.dx + (yrow + (size_t)j * H) * P + p, dts[j] * bk);
      }
      red[half * LMAX + j] = sdd;
      red[(2 + half) * LMAX + j] = su;
    }
    __syncthreads();
    if (tid < L) {
      dd[tid] += red[tid] + red[LMAX + tid];
      uu[tid] += red[2 * LMAX + tid] + red[3 * LMAX + tid];
    }
    __syncthreads();
    if (jr < L) {
      const int i = jr;
      float yi[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) yi[q] = 0.f;
      const int jmax = min(L - 1, i | 31);   // Ms is 0 for j > i
      for (int j = 0; j <= jmax; ++j) {
        const float w = Ms[i * WS + j] * dts[j];
#pragma unroll
        for (int q = 0; q < 8; ++q) yi[q] += w * xs[j * PS + 8 * half + q];
      }
      float r = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) r += gs[i * PS + 8 * half + q] * yi[q];
      red[half * LMAX + i] = r;
    }
    __syncthreads();
    if (tid < L) rs[tid] += red[tid] + red[LMAX + tid];
    __syncthreads();  // before the next pass overwrites the tiles
  }

  // phase 2: Ms = dCB_ij = (dy_i . x_j) e^{cum_i - cum_j} dt_j (j <= i)
  {
    const int ti = tid / 16, tj = tid % 16;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int p0 = 0; p0 < P; p0 += PT) {
      load_x_dy(p0, true, true);
      __syncthreads();
      for (int k = 0; k < PT; ++k) {
        float gv[8], xv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) gv[r] = r < nb ? gs[(ti + 16 * r) * PS + k] : 0.f;
#pragma unroll
        for (int q = 0; q < 8; ++q) xv[q] = q < nb ? xs[(tj + 16 * q) * PS + k] : 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] += gv[r] * xv[q];
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = ti + 16 * r, j = tj + 16 * q;
        if (r < nb && q < nb)
          Ms[i * WS + j] = j <= i ? acc[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
      }
  }
  __syncthreads();

  // phase 3: this head's dC_i = e^{cum_i} H_{c-1}^T dy_i + sum_j dCB_ij B_j, and
  // C_i . (its first term) for dcum. Thread (ti, tn): rows ti + 16 r, columns tn + 16 a.
  {
    const int ti = tid / 16, tn = tid % 16;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int a = 0; a < 8; ++a) acc[r][a] = 0.f;
    for (int p0 = 0; p0 < P; p0 += PT) {
      load_x_dy(p0, false, true);
      load_state_rows(Hp, p0);
      __syncthreads();
      for (int k = 0; k < PT; ++k) {
        float gv[8], hv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) gv[r] = r < nb ? gs[(ti + 16 * r) * PS + k] : 0.f;
#pragma unroll
        for (int a = 0; a < 8; ++a) hv[a] = hs[k * NS + tn + 16 * a];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int a = 0; a < 8; ++a) acc[r][a] += gv[r] * hv[a];
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ti + 16 * r;
      float d = 0.f;
      if (r < nb) {
        const float e = ei[i];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          acc[r][a] *= e;
          d += Cs[i * NS + tn + 16 * a] * acc[r][a];
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (r < nb && tn == 0) ci[i] = d;
    }
    for (int j = 0; j < L; ++j) {
      float mv[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) mv[r] = r < nb ? Ms[(ti + 16 * r) * WS + j] : 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) bv[a] = Bs[j * NS + tn + 16 * a];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int a = 0; a < 8; ++a) acc[r][a] += mv[r] * bv[a];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ti + 16 * r, s = s0 + i;
      if (r < nb && s < S) {
        float* out = g.dcp + (((size_t)b * S + s) * H + h) * N;
#pragma unroll
        for (int a = 0; a < 8; ++a)
          if (tn + 16 * a < N) out[tn + 16 * a] = acc[r][a];
      }
    }
  }

  // phase 4: this head's dB_j = e^{cum_L - cum_j} dt_j dH_c^T x_j + sum_i dCB_ij C_i
  {
    const int tj = tid / 16, tn = tid % 16;
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int a = 0; a < 8; ++a) acc[r][a] = 0.f;
    for (int p0 = 0; p0 < P; p0 += PT) {
      __syncthreads();  // the previous readers of xs and hs are done
      load_x_dy(p0, true, false);
      load_state_rows(dHc, p0);
      __syncthreads();
      for (int k = 0; k < PT; ++k) {
        float xv[8], hv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) xv[r] = r < nb ? xs[(tj + 16 * r) * PS + k] : 0.f;
#pragma unroll
        for (int a = 0; a < 8; ++a) hv[a] = hs[k * NS + tn + 16 * a];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int a = 0; a < 8; ++a) acc[r][a] += xv[r] * hv[a];
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = tj + 16 * r;
      if (r < nb) {
        const float f = eo[j] * dts[j];
#pragma unroll
        for (int a = 0; a < 8; ++a) acc[r][a] *= f;
      }
    }
    for (int i = 0; i < L; ++i) {
      float mv[8], cv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) mv[r] = r < nb ? Ms[i * WS + tj + 16 * r] : 0.f;
#pragma unroll
      for (int a = 0; a < 8; ++a) cv[a] = Cs[i * NS + tn + 16 * a];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int a = 0; a < 8; ++a) acc[r][a] += mv[r] * cv[a];
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = tj + 16 * r, s = s0 + j;
      if (r < nb && s < S) {
        float* out = g.dbp + (((size_t)b * S + s) * H + h) * N;
#pragma unroll
        for (int a = 0; a < 8; ++a)
          if (tn + 16 * a < N) out[tn + 16 * a] = acc[r][a];
      }
    }
  }
  __syncthreads();  // ci is written

  // phase 5: dcum, then dlog_a as its reverse cumsum in the chunk, and ddt (one thread, in
  // order)
  if (tid == 0) {
    float hd = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) hd += hd_part[w];
    float usum = 0.f;
    for (int j = 0; j < L; ++j) usum += dts[j] * uu[j];
    float run = 0.f;
    for (int i = L - 1; i >= 0; --i) {
      float dc = rs[i] + ci[i] - dts[i] * dd[i];
      if (i == L - 1) dc += usum + expf(cum[L - 1]) * hd;
      run += dc;
      if (s0 + i < S) {
        g.dla[yrow + (size_t)i * H] = run;
        g.ddt[yrow + (size_t)i * H] = dd[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dB and dC: the heads' partials summed in order
// ---------------------------------------------------------------------------

// grid (S, B), one thread per column n
template <typename T>
__global__ void __launch_bounds__(NMAX) ssd_bwd_reduce_kernel(const Args g) {
  const int s = blockIdx.x, b = blockIdx.y, n = threadIdx.x;
  if (n >= g.N) return;
  const size_t row = ((size_t)b * g.S + s) * g.H;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < g.H; ++h) {
    sb += g.dbp[(row + h) * g.N + n];
    sc += g.dcp[(row + h) * g.N + n];
  }
  const size_t o = ((size_t)b * g.S + s) * g.N + n;
  narrow((T*)g.dbt + o, sb);
  narrow((T*)g.dct + o, sc);
}

template <typename T>
int launch(const Args& g, cudaStream_t stream) {
  const size_t smem1 = SMEM1_FLOATS * sizeof(float);
  const size_t smem2 = SMEM2_FLOATS * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_states_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_states_kernel<T><<<dim3(g.B * g.H, (g.P + PT1 - 1) / PT1, 2), THREADS, smem1,
                             stream>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_chunk_kernel<T><<<dim3(g.nc, g.H, g.B), THREADS, smem2, stream>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ssd_bwd_reduce_kernel<T><<<dim3(g.S, g.B), NMAX, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// x, bt, ct (fp32 or bf16, is_bf16) read through the strides given (inner dim contiguous);
// log_a, dt through theirs; dy (B,S,H,P), h0, dh_last, dh0 (B,H,P,N) contiguous fp32
// (h0 / dh0 and dh_last may be NULL); writes dx (B,S,H,P), dbt, dct (B,S,N) contiguous in
// the inputs' dtype and dla, ddt (B,S,H) contiguous fp32. states and dstates are
// (B, ceil(S / L), H, P, N) fp32 scratches, dbp and dcp (B,S,H,N) fp32 scratches.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* bt, const void* ct,
                                   const void* la, const void* dt, const void* h0,
                                   const void* dy, const void* dh_last, void* dx, void* dbt,
                                   void* dct, void* dla, void* ddt, void* dh0, void* states,
                                   void* dstates, void* dbp, void* dcp, int B, int S, int H,
                                   int P, int N, int L, long long x_sb, long long x_ss,
                                   long long x_sh, long long b_sb, long long b_ss,
                                   long long c_sb, long long c_ss, long long a_sb,
                                   long long a_ss, long long a_sh, long long d_sb,
                                   long long d_ss, long long d_sh, int is_bf16, void* stream) {
  const Args g{x, bt, ct, (const float*)la, (const float*)dt, (const float*)h0,
               (const float*)dy, (const float*)dh_last, dx, dbt, dct, (float*)dla,
               (float*)ddt, (float*)dh0, (float*)states, (float*)dstates, (float*)dbp,
               (float*)dcp, B, S, H, P, N, L, (S + L - 1) / L, x_sb, x_ss, x_sh, b_sb,
               b_ss, c_sb, c_ss, a_sb, a_ss, a_sh, d_sb, d_ss, d_sh};
  return is_bf16 ? launch<__nv_bfloat16>(g, (cudaStream_t)stream)
                 : launch<float>(g, (cudaStream_t)stream);
}
