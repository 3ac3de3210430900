// flash_attention: online-softmax attention with GQA, causal and sliding
// window masks and a logit soft cap, forward only.
//
// Replaces the Pallas kernel _attn_kernel of
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
// What bounds it on the card: 4*D operations per live (row, key) pair on
// the CUDA cores in fp32 at the encoder's and the LM heads' shapes; the
// bytes of q, k, v and o only for very short rows.
//
// Why this first design is simple: no tensor cores, no wgmma or TMA. A
// block owns 64 query rows of one (b, h) and keeps them in shared memory;
// it walks the kv tiles that hold a live key for any of its rows (tiles
// wholly masked for the block are skipped, as the TPU kernel skips them),
// staging BK keys and values in shared memory (fp32, whatever the input
// type: bf16 is widened on load). Three phases per tile, 256 threads on a
// 16 x 16 grid:
//   1. scores: each thread a 4 x (BK/16) block of S = q k^T, fmaf over D
//      in order, then scale, soft cap and mask (masked -> -inf);
//   2. online softmax: one warp per row, running max m and sum l in fp32,
//      p = expf(s - m) (a row whose keys are all masked so far uses 0 as
//      its reference, so masked keys add exactly 0);
//   3. output: each thread a 4 x (D/16) block of o, rescaled by
//      expf(m_old - m_new) and accumulated with p v.
// expf and tanhf, not the fast intrinsics, so that fp32 results stay
// within 2e-5 of the dense oracle. K rows and Q rows are padded by one
// float in shared memory, so a warp's column reads hit distinct banks.
// Tiles per head dim: BK = 64 up to D = 128, 32 at D = 256 (140 KB of
// shared memory: Q 64 x 257, K 32 x 257, V 32 x 256 and P 64 x 33 floats).
// Strides are passed for every tensor's batch, head and sequence axes (the
// head dim is contiguous), so the (B,S,H,D) projections of the model need
// no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;            // threads per side of the 16 x 16 grid
constexpr int kBQ = 64;              // query rows per block
constexpr int kRows = kBQ / kSide;   // query rows per thread
constexpr int kWarps = kThreads / 32;

template <int D>
struct Tile {
  static constexpr int BK = D >= 256 ? 32 : 64;   // keys per kv tile
  static constexpr int kCols = BK / kSide;        // score columns per thread
  static constexpr int kDims = D / kSide;         // output dims per thread
  static constexpr int kLane = BK / 32;           // scores per lane, phase 2
  static constexpr size_t kSmemFloats =
      size_t(kBQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
      size_t(kBQ) * (BK + 1) + 3 * kBQ;
};

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ bool live_key(long long i, long long j, int T,
                                         int causal, int window) {
  return j < T && (!causal || j <= i) && (window <= 0 || j > i - window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int Tn, int group, Strides st, float scale,
    float cap, int causal, int window) {
  using Tl = Tile<D>;
  constexpr int BK = Tl::BK;
  extern __shared__ float smem[];
  float* Qs = smem;                         // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);           // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);            // [BK][D]
  float* Ps = Vs + BK * D;                  // [kBQ][BK + 1]: scores, then p
  float* Ms = Ps + kBQ * (BK + 1);          // running max per row
  float* Ls = Ms + kBQ;                     // running sum per row
  float* As = Ls + kBQ;                     // this tile's rescale per row

  const int tid = threadIdx.x, tx = tid % kSide, ty = tid / kSide;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;
  T* op = o + b * st.ob + h * st.oh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, i = q0 + r;
    Qs[r * (D + 1) + c] = i < S ? widen(qp[i * st.qs + c]) : 0.f;
  }
  if (tid < kBQ) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  // keys live for some row of this block: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? min(Tn, q_last + 1) : Tn;

  float acc[kRows][Tl::kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < Tl::kDims; ++j) acc[i][j] = 0.f;

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the Q load, or the last tile's readers, are done
    for (int e = tid; e < BK * D; e += kThreads) {
      const int r = e / D, c = e % D, j = k0 + r;
      const bool in = j < Tn;
      Ks[r * (D + 1) + c] = in ? widen(kp[j * st.ks + c]) : 0.f;
      Vs[r * D + c] = in ? widen(vp[j * st.vs + c]) : 0.f;
    }
    __syncthreads();

    // 1. scores
    float s[kRows][Tl::kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < Tl::kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[Tl::kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + kSide * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < Tl::kCols; ++j) kv[j] = Ks[(tx + kSide * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < Tl::kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < Tl::kCols; ++j) {
        const int r = ty + kSide * i, c = tx + kSide * j;
        float x = s[i][j] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);  // as `if softcap:`
        Ps[r * (BK + 1) + c] =
            live_key(q0 + r, k0 + c, Tn, causal, window) ? x : -INFINITY;
      }
    __syncthreads();

    // 2. online softmax, one warp per row
    for (int r = warp; r < kBQ; r += kWarps) {
      float sv[Tl::kLane];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < Tl::kLane; ++u) {
        sv[u] = Ps[r * (BK + 1) + lane + 32 * u];
        mx = fmaxf(mx, sv[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < Tl::kLane; ++u) {
        const float p = expf(sv[u] - m_ref);
        Ps[r * (BK + 1) + lane + 32 * u] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_ref);
        As[r] = alpha;
        Ls[r] = Ls[r] * alpha + sum;
        Ms[r] = m_new;
      }
    }
    __syncthreads();

    // 3. o = o * alpha + p v
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float alpha = As[ty + kSide * i];
#pragma unroll
      for (int j = 0; j < Tl::kDims; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[kRows], vv[Tl::kDims];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + kSide * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < Tl::kDims; ++j) vv[j] = Vs[c * D + tx + kSide * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < Tl::kDims; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  // rows with no live key (i >= T + window - 1) take the mean of v
  const long long dead_from = window > 0 ? (long long)Tn + window - 1 : -1;
  const bool any_dead = window > 0 && q_last >= dead_from;
  if (any_dead) {
    for (int c = tid; c < D; c += kThreads) {
      float sum = 0.f;
      for (int j = 0; j < Tn; ++j) sum += widen(vp[j * st.vs + c]);
      Ks[c] = sum / (float)Tn;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + kSide * i, qi = q0 + r;
    if (qi >= S) continue;
    const bool dead = any_dead && qi >= dead_from;
    const float inv_l = dead ? 0.f : 1.f / Ls[r];
#pragma unroll
    for (int j = 0; j < Tl::kDims; ++j) {
      const int c = tx + kSide * j;
      put(op + qi * st.os + c, dead ? Ks[c] : acc[i][j] * inv_l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KV, int S, int Tn, const Strides& st,
                   float scale, float cap, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * Tile<D>::kSmemFloats;
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tn, H / KV, st, scale,
      cap, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int H, int KV, int S, int Tn,
                     const Strides& st, float scale, float cap, int causal,
                     int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KV, S, Tn, st, scale, cap,
                           causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KV, S, Tn, st, scale, cap,
                           causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KV, S, Tn, st, scale, cap,
                            causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, KV, S, Tn, st, scale, cap,
                            causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int S, int Tn, int D, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long vb, long long vh,
    long long vs, long long ob, long long oh, long long os, float scale,
    float cap, int causal, int window, int is_bf16, void* stream) {
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KV, S, Tn, st,
                                        scale, cap, causal, window, s)
              : launch_d<float>(D, q, k, v, o, B, H, KV, S, Tn, st, scale,
                                cap, causal, window, s);
  return static_cast<int>(err);
}
