// Building blocks of the tiled bfloat16 bodies (fused_attn_block_tiled.cu,
// fused_resblock_tiled.cu): the shapes whose one sample does not fit in a
// block's shared memory (DDPM++ at 32 x 32 with 384 channels, attention at
// 256 tokens and 256 channels) run as a few launches that meet in global
// memory, each intermediate stored in bfloat16 exactly where the TPU kernel
// rounds it, so the rounding points stay those of the fused kernel.
//
//   tiled_gemm_kernel   C = A B on the tensor cores (mma.sync.m16n8k16, bf16
//                       operands, f32 sums): 64 x 64 output tiles, four warps
//                       of 32 x 32, K in steps of 32 through shared memory.
//                       A and B are read through a Src (strided matrix, either
//                       dimension contiguous, or the 3x3 neighbourhood of an
//                       NHWC image: an implicit-GEMM convolution), the result
//                       goes out through an Epi (round, + bias, + time
//                       embedding, residual and rescale into NCHW, or float32).
//                       With kchunk the grid's z runs over chunks of K and each
//                       chunk writes its own float32 partial (split-K, summed
//                       later in a fixed order by sum_partials_kernel).
//   gn_apply_kernel     GroupNorm (f32 statistics, E[x^2] - mean^2), the bf16
//                       scale and bias, optional SiLU, out token-major in bf16;
//                       one block a (sample, group).
//   gn_bwd_kernel       GroupNorm's backward for one (sample, group), with
//                       per-sample float32 partials of the scale and bias
//                       gradients.
//
// Every sum runs in a fixed order (no atomics), so two runs on the same
// inputs agree bit for bit.  Everything sits in an unnamed namespace, so each
// translation unit gets its own copy.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 64;             // output rows of a GEMM block
constexpr int kBN = 64;             // output columns of a GEMM block
constexpr int kBK = 32;             // K of one shared-memory stage
constexpr int kBKP = kBK + 8;       // a stage row: 80 bytes, ldmatrix free of bank conflicts
constexpr int kGemmThreads = 128;   // four warps, 2 x 2 over the tile
constexpr int kGemmSmemBytes = (kBM + kBN) * kBKP * 2;   // one A and one B stage, static
constexpr int kRowThreads = 256;    // GroupNorm kernels: one block a (sample, group)

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }

// Where the operands of tiled_gemm_kernel come from.  Element (r, k) of the
// operand (r: a row of A or a column of B) of batch z lies at
// p + z*sz + r*sr + k*sk; kKContig needs sk == 1, kRContig sr == 1, both with
// 16-byte aligned rows where they read 8 values at once.  kConv3x3: row r is
// token r of an NHWC tensor (samples of H x W tokens, c channels) and k =
// tap * c + ch with tap = (dy + 1) * 3 + (dx + 1); a tap outside the image
// reads 0.  Rows at or past `rows` read 0; ones_row (kRContig only) reads 1
// at every k, so its output row sums the other operand over K.
enum SrcKind : int { kKContig = 0, kRContig = 1, kConv3x3 = 2 };

struct Src {
  const bf16* p;
  long long sz, sr, sk;
  int rows;
  int kind;
  int ones_row;
  int H, W, c;
};

// Epilogue kinds: kOutBf16 rounds the sum, adds bias[n] and temb[sample, n]
// (each rounded), row-major out; kOutF32 stores the float32 sum; kOutResidual
// rounds, adds bias[n], adds the residual res(sample, l, n) and multiplies by
// rescale (T(1/sqrt 2)), each rounded, into NCHW out (sample, n, l).  A row m
// is (sample z, token m), or with rps > 0 (sample m / rps, token m % rps).
enum EpiKind : int { kOutBf16 = 0, kOutF32 = 1, kOutResidual = 2 };

struct Epi {
  int kind;
  void* out;
  long long soz, som;
  const bf16* bias;
  const bf16* temb;
  int temb_ld;
  int rps;
  const bf16* res;
  long long res_sb, res_sl, res_sn;
  long long out_sb;
  int out_L;
  float rescale;
};

struct GemmArgs {
  Src a, b;
  Epi e;
  int M, N, K;
  int kchunk;   // > 0: split-K, blockIdx.z is the chunk and a, b are read at z = 0
};

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

// Fill a stage: rows r0 .. r0 + 63 of the operand, k0 .. k0 + 31, as
// s[row][k] (bf16), zeros past `rows` and past kend.
__device__ __forceinline__ void fill_stage(bf16 (*s)[kBKP], const Src& a, int z, int r0, int k0,
                                           int kend) {
  const int tid = threadIdx.x;
  if (a.kind == kRContig) {
    // 32 k x 64 rows in chunks of 8 rows at one k; each chunk scattered into 8 rows
    for (int q = tid; q < 256; q += kGemmThreads) {
      const int kk = q >> 3, rr = (q & 7) * 8;
      const int k = k0 + kk, r = r0 + rr;
      bf16 v[8];
      if (k < kend) {
        const bf16* src = a.p + z * a.sz + static_cast<long long>(k) * a.sk + r;
        if (r + 8 <= a.rows && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          const uint4 u = *reinterpret_cast<const uint4*>(src);
          const bf16* w = reinterpret_cast<const bf16*>(&u);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = w[i];
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = r + i < a.rows ? src[i] : __float2bfloat16(0.f);
        }
        if (a.ones_row >= r && a.ones_row < r + 8) v[a.ones_row - r] = __float2bfloat16(1.f);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(0.f);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s[rr + i][kk] = v[i];
    }
    return;
  }
  // 64 rows x 32 k in chunks of 8 k of one row
  for (int q = tid; q < 256; q += kGemmThreads) {
    const int rr = q >> 2, kk = (q & 3) * 8;
    const int r = r0 + rr, k = k0 + kk;
    uint4 u = zero4();
    if (r < a.rows && k < kend) {
      if (a.kind == kKContig) {
        u = *reinterpret_cast<const uint4*>(a.p + z * a.sz + static_cast<long long>(r) * a.sr + k);
      } else {
        const int L = a.H * a.W;
        const int b = r / L, l = r - b * L;
        const int y = l / a.W, x = l - y * a.W;
        const int tap = k / a.c, ch = k - tap * a.c;
        const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
        if (yy >= 0 && yy < a.H && xx >= 0 && xx < a.W)
          u = *reinterpret_cast<const uint4*>(
              a.p + (static_cast<long long>(b) * L + yy * a.W + xx) * a.c + ch);
      }
    }
    *reinterpret_cast<uint4*>(&s[rr][kk]) = u;
  }
}

__device__ __forceinline__ void epilogue(const Epi& e, int z, int m, int n, float v0, float v1) {
  if (e.kind == kOutF32) {
    float* o = static_cast<float*>(e.out) + z * e.soz + m * e.som + n;
    o[0] = v0;
    o[1] = v1;
    return;
  }
  int sample = z, l = m;
  if (e.rps > 0) {
    sample = m / e.rps;
    l = m - sample * e.rps;
  }
  float r0 = rbf(v0), r1 = rbf(v1);
  if (e.bias) {
    r0 = rbf(r0 + bf(e.bias[n]));
    r1 = rbf(r1 + bf(e.bias[n + 1]));
  }
  if (e.temb) {
    const bf16* t = e.temb + static_cast<long long>(sample) * e.temb_ld + n;
    r0 = rbf(r0 + bf(t[0]));
    r1 = rbf(r1 + bf(t[1]));
  }
  if (e.kind == kOutBf16) {
    bf16* o = static_cast<bf16*>(e.out) + z * e.soz + static_cast<long long>(m) * e.som + n;
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(r0, r1);
    return;
  }
  const bf16* rp = e.res + sample * e.res_sb + l * e.res_sl + n * e.res_sn;
  r0 = rbf(rbf(bf(rp[0]) + r0) * e.rescale);
  r1 = rbf(rbf(bf(rp[e.res_sn]) + r1) * e.rescale);
  bf16* o = static_cast<bf16*>(e.out) + sample * e.out_sb + static_cast<long long>(n) * e.out_L + l;
  o[0] = __float2bfloat16(r0);
  o[e.out_L] = __float2bfloat16(r1);
}

// grid (ceil(M / 64), ceil(N / 64), batches or K chunks), 128 threads.
__global__ void __launch_bounds__(kGemmThreads) tiled_gemm_kernel(const GemmArgs g) {
  __shared__ __align__(16) bf16 sA[kBM][kBKP];
  __shared__ __align__(16) bf16 sB[kBN][kBKP];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, z = blockIdx.z;
  int kbeg = 0, kend = g.K, zs = z;
  if (g.kchunk > 0) {
    kbeg = z * g.kchunk;
    kend = min(g.K, kbeg + g.kchunk);
    zs = 0;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    fill_stage(sA, g.a, zs, m0, k0, kend);
    fill_stage(sB, g.b, zs, n0, k0, kend);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], &sA[wm + mi * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned bfr[4];
        ldmatrix_x4(bfr, &sB[wn + np * 16 + (lane & 7) + (lane >> 4) * 8]
                            [kk + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mi * 16 + (lane >> 2) + h * 8;
        const int n = n0 + wn + nj * 8 + (lane & 3) * 2;
        if (m < g.M && n < g.N) epilogue(g.e, z, m, n, acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
}

inline dim3 gemm_grid(const GemmArgs& g, int z) {
  return dim3((g.M + kBM - 1) / kBM, (g.N + kBN - 1) / kBN, z);
}

inline cudaError_t launch_gemm(const GemmArgs& g, int z, cudaStream_t s) {
  tiled_gemm_kernel<<<gemm_grid(g, z), kGemmThreads, 0, s>>>(g);
  return cudaGetLastError();
}

inline Src src(const bf16* p, long long sz, long long sr, long long sk, int rows, int kind) {
  Src a{};
  a.p = p;
  a.sz = sz;
  a.sr = sr;
  a.sk = sk;
  a.rows = rows;
  a.kind = kind;
  a.ones_row = -1;
  return a;
}

inline Epi epi_bf16(void* out, long long soz, long long som, const bf16* bias) {
  Epi e{};
  e.kind = kOutBf16;
  e.out = out;
  e.soz = soz;
  e.som = som;
  e.bias = bias;
  return e;
}

inline Epi epi_f32(float* out, long long soz, long long som) {
  Epi e{};
  e.kind = kOutF32;
  e.out = out;
  e.soz = soz;
  e.som = som;
  return e;
}

// Deterministic block sum: butterfly within each warp, then the warps' sums in
// order; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) t += red[i];
  return t;
}

// GroupNorm of one (sample, group) of x: element (c, l) of sample b at
// x + b*sxb + c*sxc + l*sxl (NCHW: sxl = 1; token-major: sxc = 1).  Writes
// T(f(((x - mean) * inv) * gamma + beta)) (f = SiLU or the identity, in f32)
// token-major to out + b*sob + l*C + c, and (mean, inv) to stats when given.
__global__ void __launch_bounds__(kRowThreads) gn_apply_kernel(
    const bf16* x, long long sxb, long long sxc, long long sxl, int C, int L, int G,
    const bf16* gamma, const bf16* beta, float eps, int silu, bf16* out, long long sob,
    float* stats) {
  __shared__ float red[kRowThreads / 32];
  const int b = blockIdx.x / G, grp = blockIdx.x - b * G, cg = C / G, n = cg * L;
  const bf16* base = x + b * sxb + static_cast<long long>(grp) * cg * sxc;
  const bool channel_major = sxl == 1;
  float s = 0.f, s2 = 0.f;
  for (int e = threadIdx.x; e < n; e += kRowThreads) {
    const int c = channel_major ? e / L : e % cg, l = channel_major ? e % L : e / cg;
    const float v = bf(base[c * sxc + l * sxl]);
    s += v;
    s2 += v * v;
  }
  const float inv_n = 1.f / static_cast<float>(n);
  s = block_sum(s, red);
  s2 = block_sum(s2, red);
  const float mean = __fmul_rn(s, inv_n);
  const float var = __fsub_rn(__fmul_rn(s2, inv_n), __fmul_rn(mean, mean));
  const float inv = 1.f / sqrtf(var + eps);
  if (stats != nullptr && threadIdx.x == 0) {
    stats[2 * blockIdx.x] = mean;
    stats[2 * blockIdx.x + 1] = inv;
  }
  for (int e = threadIdx.x; e < n; e += kRowThreads) {
    const int c = channel_major ? e / L : e % cg, l = channel_major ? e % L : e / cg;
    const int ch = grp * cg + c;
    float t = __fmul_rn(__fsub_rn(bf(base[c * sxc + l * sxl]), mean), inv);
    t = __fadd_rn(__fmul_rn(t, bf(gamma[ch])), bf(beta[ch]));
    if (silu) t = t / (1.f + expf(-t));
    out[b * sob + static_cast<long long>(l) * C + ch] = __float2bfloat16(t);
  }
}

// GroupNorm's backward for one (sample, group), the forward's statistics
// given: dh float32 token-major (dh + b*sdb + l*C + c), x and the output
// cotangent g NCHW in bf16.  dx = T(inv * (dxhat - m1 - xhat * m2) + g *
// rescale) with dxhat = dh * gamma and m1, m2 the group means of dxhat and
// dxhat * xhat; partial[(b*2 + 0)*C + c] = sum_l dh * xhat and
// partial[(b*2 + 1)*C + c] = sum_l dh.
__global__ void __launch_bounds__(kRowThreads) gn_bwd_kernel(
    const float* dh, long long sdb, const bf16* x, const bf16* g, const float* stats,
    const bf16* gamma, int C, int L, int G, float rescale, bf16* dx, float* partial) {
  __shared__ float red[kRowThreads / 32];
  const int b = blockIdx.x / G, grp = blockIdx.x - b * G, cg = C / G;
  const float mean = stats[2 * blockIdx.x], inv = stats[2 * blockIdx.x + 1];
  const float* d = dh + b * sdb;
  const long long xb = static_cast<long long>(b) * C * L;
  float m1 = 0.f, m2 = 0.f;
  for (int cc = 0; cc < cg; ++cc) {
    const int c = grp * cg + cc;
    const float gam = bf(gamma[c]);
    float sg = 0.f, sb = 0.f;
    for (int l = threadIdx.x; l < L; l += kRowThreads) {
      const float dv = d[static_cast<long long>(l) * C + c];
      const float xh = __fmul_rn(__fsub_rn(bf(x[xb + static_cast<long long>(c) * L + l]), mean), inv);
      const float dxh = __fmul_rn(dv, gam);
      sg += dv * xh;
      sb += dv;
      m1 += dxh;
      m2 += dxh * xh;
    }
    sg = block_sum(sg, red);
    sb = block_sum(sb, red);
    if (threadIdx.x == 0) {
      partial[(2 * b) * C + c] = sg;
      partial[(2 * b + 1) * C + c] = sb;
    }
  }
  const float inv_n = 1.f / static_cast<float>(cg * L);
  m1 = __fmul_rn(block_sum(m1, red), inv_n);
  m2 = __fmul_rn(block_sum(m2, red), inv_n);
  for (int e = threadIdx.x; e < cg * L; e += kRowThreads) {
    const int cc = e / L, l = e - cc * L, c = grp * cg + cc;
    const long long xi = xb + static_cast<long long>(c) * L + l;
    const float dv = d[static_cast<long long>(l) * C + c];
    const float xh = __fmul_rn(__fsub_rn(bf(x[xi]), mean), inv);
    const float dxh = __fmul_rn(dv, bf(gamma[c]));
    const float t = __fmul_rn(inv, __fsub_rn(__fsub_rn(dxh, m1), __fmul_rn(xh, m2)));
    dx[xi] = __float2bfloat16(__fadd_rn(t, __fmul_rn(bf(g[xi]), rescale)));
  }
}

// out[i] = sum over s < S of in[s * stride + i], in order of s.
__global__ void sum_partials_kernel(const float* in, long long stride, int S, int n, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = 0.f;
  for (int s = 0; s < S; ++s) t += in[s * stride + i];
  out[i] = t;
}

inline cudaError_t launch_sum(const float* in, long long stride, int S, int n, float* out,
                              cudaStream_t s) {
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(in, stride, S, n, out);
  return cudaGetLastError();
}

// Carves a workspace into 256-byte aligned pieces; with base null it only counts.
struct Carve {
  char* base;
  long long used = 0;
  template <typename T> T* take(long long count) {
    used = (used + 255) / 256 * 256;
    T* p = base ? reinterpret_cast<T*>(base + used) : nullptr;
    used += count * static_cast<long long>(sizeof(T));
    return p;
  }
};

}  // namespace
