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
// What bounds it on the card: at the routing shapes (K ~ 16, d = 768) the
// bytes of the gathered rows, a few MB per SGLD step, so about a
// microsecond; the launch itself costs more. At K ~ 1024 the m*K*d
// multiply-adds of the score pass bound it instead.
//
// Why this first design is simple: one warp owns one minibatch row and
// walks the arms in increasing index (lanes split d, xor-butterfly sums),
// keeping s_a1, s_a2 and the running feel-good max with its tie count.
// W is zero outside a1, a2 and the tied maxima, so the gradient needs no
// (m, K) weight matrix: a second pass over K runs only when the max is
// tied. Rows are gathered from the replay ring inside the kernel. Each
// block writes its own partial (its rows summed in warp order); a second
// launch sums a chain's partials in block order: a fixed reduction order
// and no atomics. fp32 on the CUDA cores, no TF32.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // minibatch rows per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
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
  float* partials;         // (C, nblk, L)
  float* out;              // (C, L)
  int C, m, K, d, j;
  float eta, mu;
};

// score of arm k for the row xr under theta th; the same inlined code in
// both passes gives bitwise equal scores for the tie test
__device__ __forceinline__ float arm_score(const Args& p, const float* xr,
                                           const float* th, int k, int lane,
                                           float* den_out) {
  const float* ak = p.a + (int64_t)k * p.d;
  float n = 0.f, dd = 0.f;
  for (int t = lane; t < p.d; t += 32) {
    const float xv = xr[t], av = ak[t];
    n = fmaf(xv * th[t], av, n);
    dd = fmaf(xv * xv, av * av, dd);
  }
  n = warp_sum(n);
  dd = warp_sum(dd);
  const float den = sqrtf(fmaxf(dd, 1e-24f));
  *den_out = den;
  return n / den;
}

// s_k - p * cost_k, rounded as the reference rounds it (no fma contraction)
__device__ __forceinline__ float tilted(float s, float pr, const Args& p,
                                        int k) {
  return __fsub_rn(s, __fmul_rn(pr, p.costs ? p.costs[k] : 0.f));
}

__device__ __forceinline__ bool live(const Args& p, int k) {
  return p.mask == nullptr || p.mask[k] != 0;
}

__device__ __forceinline__ float softplus(float v) {      // logaddexp(v, 0)
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

// this block's partial: its rows summed in warp order (gradient rows gr of
// kWarps x d in shared memory, or the per-warp terms)
template <bool GRAD>
__device__ __forceinline__ void block_partial(const float* gr,
                                              const float* terms,
                                              float* partials, int c, int blk,
                                              int nblk, int d) {
  if (GRAD) {
    float* dst = partials + ((int64_t)c * nblk + blk) * d;
    for (int t = threadIdx.x; t < d; t += blockDim.x) {
      float acc = 0.f;
      for (int w = 0; w < kWarps; ++w) acc += gr[w * d + t];
      dst[t] = acc;
    }
  } else if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += terms[w];
    partials[(int64_t)c * nblk + blk] = acc;
  }
}

// grid (nblk, C), kWarps warps; dynamic smem: theta (d) + kWarps rows (d)
// [+ kWarps gradient rows (d) when GRAD]
template <bool GRAD>
__global__ void sgld_rows_kernel(Args p) {
  extern __shared__ float smem[];
  __shared__ float terms[kWarps];
  float* th = smem;
  const int c = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blk * kWarps + warp;
  const bool in_range = i < p.m;
  float* xr = smem + p.d + warp * p.d;
  float* gr = smem + p.d + kWarps * p.d + warp * p.d;
  for (int t = threadIdx.x; t < p.d; t += blockDim.x)
    th[t] = p.theta[(int64_t)c * p.d + t];
  int64_t r = 0;
  float v = 0.f;
  if (in_range) {
    r = p.rows[(int64_t)c * p.m + i];
    v = p.valid[(int64_t)c * p.m + i];
    for (int t = lane; t < p.d; t += 32) xr[t] = p.x[r * p.d + t];
  }
  __syncthreads();

  float term = 0.f;
  if (in_range) {
    const int ia1 = p.a1[r], ia2 = p.a2[r];
    const float yv = p.y[r];
    const float pr = p.pref ? p.pref[r] : 0.f;
    float s1 = 0.f, s2 = 0.f, den1 = 1.f, den2 = 1.f;
    float smax = -CUDART_INF_F, dmax = 1.f;
    int kmax = 0, cnt = 0;
    for (int k = 0; k < p.K; ++k) {
      float den;
      const float s = arm_score(p, xr, th, k, lane, &den);
      if (k == ia1) { s1 = s; den1 = den; }
      if (k == ia2) { s2 = s; den2 = den; }
      if (!live(p, k)) continue;
      const float tv = tilted(s, pr, p, k);
      if (tv > smax) { smax = tv; kmax = k; dmax = den; cnt = 1; }
      else if (tv == smax) { ++cnt; }
    }
    const int opp = p.j == 1 ? ia2 : ia1;
    const float s_opp = tilted(p.j == 1 ? s2 : s1, pr, p, opp);
    const float z = yv * (s1 - s2);
    const float mu_row = p.mu / (1.f + fmaxf(pr, 0.f));
    if (!GRAD) {
      term = (p.eta * softplus(-z) - mu_row * (smax - s_opp)) * v;
    } else {
      // W/den on a1 and a2 (cancelling when a1 == a2), +mu_r on opp
      const float dz = p.eta * (-1.f / (1.f + expf(z))) * yv;
      float w1 = ia1 == ia2 ? 0.f : dz;
      float w2 = ia1 == ia2 ? 0.f : -dz;
      if (p.j == 1) w2 += mu_row; else w1 += mu_row;
      const float c1 = w1 * v / den1, c2 = w2 * v / den2;
      const float wt = -mu_row / (float)max(cnt, 1) * v;  // per tied max
      const float* r1 = p.a + (int64_t)ia1 * p.d;
      const float* r2 = p.a + (int64_t)ia2 * p.d;
      for (int t = lane; t < p.d; t += 32)
        gr[t] = fmaf(c2, r2[t], c1 * r1[t]);
      if (cnt == 1) {
        const float* rm = p.a + (int64_t)kmax * p.d;
        const float cm = wt / dmax;
        for (int t = lane; t < p.d; t += 32) gr[t] = fmaf(cm, rm[t], gr[t]);
      } else if (cnt > 1) {
        // tied maxima: find them again by their bitwise equal scores
        for (int k = 0; k < p.K; ++k) {
          if (!live(p, k)) continue;
          float den;
          const float s = arm_score(p, xr, th, k, lane, &den);
          if (tilted(s, pr, p, k) != smax) continue;
          const float* rk = p.a + (int64_t)k * p.d;
          const float ck = wt / den;
          for (int t = lane; t < p.d; t += 32)
            gr[t] = fmaf(ck, rk[t], gr[t]);
        }
      }
      for (int t = lane; t < p.d; t += 32) gr[t] = xr[t] * gr[t];
    }
  } else if (GRAD) {
    for (int t = lane; t < p.d; t += 32) gr[t] = 0.f;
  }
  if (!GRAD && lane == 0) terms[warp] = term;
  __syncthreads();
  block_partial<GRAD>(smem + p.d + kWarps * p.d, terms, p.partials, c, blk,
                      nblk, p.d);
}

// second pass: out[c, l] = g_c * sum_blk partials[c, blk, l], in block order
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       const float* __restrict__ g,
                                       float* __restrict__ out, int C,
                                       int nblk, int L) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)C * L) return;
  const int c = (int)(idx / L), l = (int)(idx % L);
  float acc = 0.f;
  for (int b = 0; b < nblk; ++b)
    acc += partials[((int64_t)c * nblk + b) * L + l];
  out[idx] = g ? g[c] * acc : acc;
}

// the row kernel on grid (nblk, C), then the ordered reduction of its
// partials (L = d for a gradient, 1 for a potential)
template <typename A>
int launch_rows(void (*kernel)(A), const A& p, int C, int m, int d,
                size_t smem, bool grad, const float* g, float* partials,
                float* out, cudaStream_t stream) {
  const int nblk = (m + kWarps - 1) / kWarps;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  if (nblk > 0 && C > 0) {
    kernel<<<dim3(nblk, C), 32 * kWarps, smem, stream>>>(p);
    const int L = grad ? d : 1;
    const int64_t n = (int64_t)C * L;
    reduce_partials_kernel<<<(int)((n + 255) / 256), 256, 0, stream>>>(
        partials, g, out, C, nblk, L);
  }
  return (int)cudaGetLastError();
}

template <bool GRAD>
int launch(const Args& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (size_t)p.d * (1 + kWarps * (GRAD ? 2 : 1));
  return launch_rows(sgld_rows_kernel<GRAD>, p, p.C, p.m, p.d, smem, GRAD,
                     p.g, p.partials, p.out, stream);
}

Args make_args(const void* theta, const void* x, const void* a1,
               const void* a2, const void* y, const void* pref,
               const void* rows, const void* valid, const void* a_emb,
               const void* mask, const void* costs, const void* g,
               void* partials, void* out, int C, int m, int K, int d, int j,
               float eta, float mu) {
  Args p;
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
  p.partials = (float*)partials;
  p.out = (float*)out;
  p.C = C; p.m = m; p.K = K; p.d = d; p.j = j;
  p.eta = eta; p.mu = mu;
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
// arm rows it scores), so ~1.6 MB at C = 8, m = 64, d = 768. It scores
// only a1 (and a2 on a duel), never walking the K arms: its work is
// O(m * d) whatever K is. Same row layout as "fgts" mode (one warp per
// minibatch row, rows gathered from the ring in the kernel, per-block
// partials reduced in a fixed order by a second launch, no atomics).
// ---------------------------------------------------------------------------

struct MixedArgs {
  const float* theta;      // (C, d)
  const float* x;          // (N, d) ring rows
  const int32_t* a1;       // (N,)
  const int32_t* a2;       // (N,) read on duel rows only
  const float* y;          // (N,) duels +-1, clicks 0/1
  const float* duel;       // (N,) > 0 on a duel row
  const int64_t* rows;     // (C, m)
  const float* valid;      // (C, m)
  const float* a;          // (K, d)
  const float* g;          // (C,) or null (= 1)
  float* partials;         // (C, nblk, L)
  float* out;              // (C, L)
  int C, m, d;
  float eta;
};

// grid (nblk, C), kWarps warps; dynamic smem: theta (d) [+ kWarps gradient
// rows (d) when GRAD]
template <bool GRAD>
__global__ void sgld_mixed_kernel(MixedArgs p) {
  extern __shared__ float smem[];
  __shared__ float terms[kWarps];
  float* th = smem;
  float* gr = smem + p.d + (threadIdx.x / 32) * p.d;
  const int c = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blk * kWarps + warp;
  for (int t = threadIdx.x; t < p.d; t += blockDim.x)
    th[t] = p.theta[(int64_t)c * p.d + t];
  __syncthreads();

  float term = 0.f;
  if (i < p.m) {
    const int64_t r = p.rows[(int64_t)c * p.m + i];
    const float v = p.valid[(int64_t)c * p.m + i];
    const float* xr = p.x + r * p.d;
    const int ia1 = p.a1[r];
    const bool duel = p.duel[r] > 0.f;       // the same for the whole warp
    const int ia2 = duel ? p.a2[r] : ia1;
    const float yv = p.y[r];
    const float* r1 = p.a + (int64_t)ia1 * p.d;
    const float* r2 = p.a + (int64_t)ia2 * p.d;
    float n1 = 0.f, d1 = 0.f, n2 = 0.f, d2 = 0.f;
    if (duel) {
      for (int t = lane; t < p.d; t += 32) {
        const float xv = xr[t], xt = xv * th[t], xx = xv * xv;
        const float u = r1[t], w = r2[t];
        n1 = fmaf(xt, u, n1);
        d1 = fmaf(xx, u * u, d1);
        n2 = fmaf(xt, w, n2);
        d2 = fmaf(xx, w * w, d2);
      }
      n2 = warp_sum(n2);
      d2 = warp_sum(d2);
    } else {
      for (int t = lane; t < p.d; t += 32) {
        const float xv = xr[t], u = r1[t];
        n1 = fmaf(xv * th[t], u, n1);
        d1 = fmaf(xv * xv, u * u, d1);
      }
    }
    n1 = warp_sum(n1);
    d1 = warp_sum(d1);
    const float den1 = sqrtf(fmaxf(d1, 1e-24f));
    const float den2 = sqrtf(fmaxf(d2, 1e-24f));
    const float s1 = n1 / den1;
    const float s2 = n2 / den2;
    if (!GRAD) {
      const float t = duel ? softplus(-(yv * (s1 - s2)))
                           : (yv > 0.5f ? softplus(-s1) : softplus(s1));
      term = p.eta * t * v;
    } else {
      float c1, c2 = 0.f;
      if (duel) {
        const float z = yv * (s1 - s2);
        const float dz = p.eta * (-1.f / (1.f + expf(z))) * yv;
        const float w1 = ia1 == ia2 ? 0.f : dz;
        c1 = w1 * v / den1;
        c2 = -w1 * v / den2;
      } else {
        const float w1 = p.eta * (yv > 0.5f ? -1.f / (1.f + expf(s1))
                                            : 1.f / (1.f + expf(-s1)));
        c1 = w1 * v / den1;
      }
      for (int t = lane; t < p.d; t += 32)
        gr[t] = xr[t] * fmaf(c2, r2[t], c1 * r1[t]);
    }
  } else if (GRAD) {
    for (int t = lane; t < p.d; t += 32) gr[t] = 0.f;
  }
  if (!GRAD && lane == 0) terms[warp] = term;
  __syncthreads();
  block_partial<GRAD>(smem + p.d, terms, p.partials, c, blk, nblk, p.d);
}

template <bool GRAD>
int launch_mixed(const MixedArgs& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)p.d * (1 + (GRAD ? kWarps : 0));
  return launch_rows(sgld_mixed_kernel<GRAD>, p, p.C, p.m, p.d, smem, GRAD,
                     p.g, p.partials, p.out, stream);
}

MixedArgs make_mixed_args(const void* theta, const void* x, const void* a1,
                          const void* a2, const void* y, const void* is_duel,
                          const void* rows, const void* valid,
                          const void* a_emb, const void* g, void* partials,
                          void* out, int C, int m, int d, float eta) {
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
  p.partials = (float*)partials;
  p.out = (float*)out;
  p.C = C; p.m = m; p.d = d;
  p.eta = eta;
  return p;
}

}  // namespace

#define SGLD_PARAMS                                                        \
  const void *theta, const void *x, const void *a1, const void *a2,        \
      const void *y, const void *pref, const void *rows, const void *valid, \
      const void *a_emb, const void *mask, const void *costs,              \
      const void *g, void *partials, void *out, int C, int m, int K, int d, \
      int j, float eta, float mu, void *stream
#define SGLD_ARGS                                                          \
  make_args(theta, x, a1, a2, y, pref, rows, valid, a_emb, mask, costs, g, \
            partials, out, C, m, K, d, j, eta, mu)

// partials: (C, ceil(m/8)) floats; out: (C,)
extern "C" int sgld_potential_fwd_launch(SGLD_PARAMS) {
  return launch<false>(SGLD_ARGS, (cudaStream_t)stream);
}

// partials: (C, ceil(m/8), d) floats; out: (C, d)
extern "C" int sgld_potential_grad_launch(SGLD_PARAMS) {
  return launch<true>(SGLD_ARGS, (cudaStream_t)stream);
}

#define MIXED_PARAMS                                                       \
  const void *theta, const void *x, const void *a1, const void *a2,        \
      const void *y, const void *is_duel, const void *rows,                \
      const void *valid, const void *a_emb, const void *g, void *partials, \
      void *out, int C, int m, int d, float eta, void *stream
#define MIXED_ARGS                                                         \
  make_mixed_args(theta, x, a1, a2, y, is_duel, rows, valid, a_emb, g,     \
                  partials, out, C, m, d, eta)

// partials: (C, ceil(m/8)) floats; out: (C,)
extern "C" int sgld_mixed_fwd_launch(MIXED_PARAMS) {
  return launch_mixed<false>(MIXED_ARGS, (cudaStream_t)stream);
}

// partials: (C, ceil(m/8), d) floats; out: (C, d)
extern "C" int sgld_mixed_grad_launch(MIXED_PARAMS) {
  return launch_mixed<true>(MIXED_ARGS, (cudaStream_t)stream);
}
