// Pieces shared by the fp32 attention kernels: the forward
// (flash_attention.cu) and the backward (flash_attention_bwd.cu).
//
// Both stage rows of (rows, D) tensors in shared memory by cp.async (the
// forward in blocks of 128 threads, the backward 256), at the built head
// dim DP (32, 64, 128 or 256)
// for any D <= DP: a row's columns past D, and rows past the tensor's end,
// arrive as zeros, which add exactly nothing to an fp32 fma chain.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace attn {

constexpr int kThreads = 128;

__device__ __forceinline__ bool live_key(long long i, long long j, int T,
                                         int causal, int window) {
  return j < T && (!causal || j <= i) && (window <= 0 || j > i - window);
}

// 16 bytes global -> shared, of which the first `cols` floats (0-4) come
// from src and the rest are zeros. vec: one 16-byte copy (cols is 0 or 4
// there); else four 4-byte copies, for unaligned addresses or strides.
__device__ __forceinline__ void copy16(float* dst, const float* src, int cols,
                                       bool vec) {
  const uint32_t d = sm90::smem_u32(dst);
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(4 * cols)
                 : "memory");
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                       d + 4 * u),
                   "l"(src + (u < cols ? u : 0)), "r"(u < cols ? 4 : 0)
                   : "memory");
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + n) of a (rows, dim) tensor into shared memory at a
// width of DP floats: row r at dst + r * DP, its 16-byte chunk c at chunk
// c ^ ((r >> shift) % 8); rows at or past `limit` and columns at or past
// `dim` are zeros. NT: the block's threads, which share the copies.
template <int DP, int NT = kThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0, int n,
                                          int limit, int dim, int shift,
                                          bool vec) {
  constexpr int C = DP / 4;
  for (int e = threadIdx.x; e < n * C; e += NT) {
    const int r = e / C, c = e % C, i = row0 + r;
    const int cols = i < limit ? max(0, min(4, dim - 4 * c)) : 0;
    copy16(dst + r * DP + 4 * (c ^ ((r >> shift) & 7)),
           cols > 0 ? src + i * stride + 4 * c : src, cols, vec);
  }
}

// the built head dim a kernel runs head dim D on (0: none)
inline int built_dim(int D) {
  return D < 1 ? 0 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128
                                : D <= 256 ? 256 : 0;
}

// every address and stride a multiple of 16 bytes and D of 4 floats:
// 16-byte copies and stores
inline bool aligned16(const void* const* ptrs, int n_ptrs,
                      const long long* strides, int n_strides, int D) {
  if (D % 4) return false;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] % 4) return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

}  // namespace attn
