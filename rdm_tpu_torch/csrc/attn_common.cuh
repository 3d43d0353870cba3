// Device helpers shared by the attention kernels (fused_attn_block.cu,
// fused_attn_block_bwd.cu) and the fused resblock
// (fused_resblock.cu): conversions to and from the working type, rounding to
// it, vector loads, warp reductions, the register-tiled product loop and the
// row softmax.  Everything sits in an unnamed namespace, so each translation
// unit gets its own copy.
#pragma once

#include <cmath>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 128;
constexpr int TM = 4;  // rows of a thread's register tile
constexpr int TN = 8;  // columns of a thread's register tile

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Round a float to the working type and back.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// Eight consecutive values of the working type from global memory, as float
// (p is 16-byte aligned).
template <typename T> __device__ __forceinline__ void load8_global(const T* p, float* b);
template <> __device__ __forceinline__ void load8_global<float>(const float* p, float* b) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  const float4 v = __ldg(reinterpret_cast<const float4*>(p) + 1);
  b[0] = u.x; b[1] = u.y; b[2] = u.z; b[3] = u.w;
  b[4] = v.x; b[5] = v.y; b[6] = v.z; b[7] = v.w;
}
template <> __device__ __forceinline__ void load8_global<__nv_bfloat16>(
    const __nv_bfloat16* p, float* b) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    b[2 * i] = f.x;
    b[2 * i + 1] = f.y;
  }
}

// Eight consecutive floats from shared memory (p is 16-byte aligned).
__device__ __forceinline__ void load8_shared(const float* p, float* b) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 v = reinterpret_cast<const float4*>(p)[1];
  b[0] = u.x; b[1] = u.y; b[2] = u.z; b[3] = u.w;
  b[4] = v.x; b[5] = v.y; b[6] = v.z; b[7] = v.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// out[i][j] = sum_k A(i, k) * B(k, j) for i < M, j < N, over TM x TN
// register tiles, one per thread in turn.  a(i, k) returns one value;
// b(k, j0, vals) fills vals[0..TN) with B(k, j0 .. j0 + TN); store(i, j, acc)
// writes a result.  N is padded to a multiple of TN by the caller's buffers,
// and rows past M repeat row M - 1 (their results are dropped).
template <class LoadA, class LoadB, class Store>
__device__ __forceinline__ void tile_product(int M, int N, int K, LoadA a, LoadB b,
                                             Store store) {
  const int tiles_n = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * tiles_n;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int i0 = (t / tiles_n) * TM;
    const int j0 = (t % tiles_n) * TN;
    int rows[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) rows[m] = min(i0 + m, M - 1);
    float acc[TM][TN];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;
    for (int k = 0; k < K; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) av[m] = a(rows[m], k);
      b(k, j0, bv);
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
    }
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n)
        if (i0 + m < M && j0 + n < N) store(i0 + m, j0 + n, acc[m][n]);
  }
}

// Softmax of nr score rows of length L (row stride LP) in place, one warp
// per row; the probabilities are rounded to the working type T.  With
// kScoresInT (scores already in T), every step also runs in T: s - max and
// its exp are rounded to T, and the sum (taken in f32) is rounded to T before
// the division.  Otherwise the whole softmax is f32.
template <typename T, bool kScoresInT = false>
__device__ __forceinline__ void softmax_rows(float* sb, int nr, int L, int LP) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nr; r += kWarps) {
    float* srow = sb + r * LP;
    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = kScoresInT ? rnd<T>(expf(rnd<T>(srow[j] - m))) : expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (kScoresInT) sum = rnd<T>(sum);
    for (int j = lane; j < L; j += 32) srow[j] = rnd<T>(srow[j] / sum);
  }
}

}  // namespace
