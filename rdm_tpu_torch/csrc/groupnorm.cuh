// GroupNorm of the tiled bfloat16 bodies (fused_attn_block_tiled.cu,
// fused_resblock_tiled.cu), forward and backward, and the bf16 helpers the
// tiled kernels share:
//
//   gn_apply_kernel     GroupNorm (f32 statistics, E[x^2] - mean^2), the bf16
//                       scale and bias, optional SiLU, out token-major in bf16
//                       (and x itself token-major on request); one block a few
//                       adjacent groups of a sample (launch_gn_apply), reads
//                       and writes in pieces of up to 16 bytes.
//   gn_bwd_kernel       GroupNorm's backward for one (sample, group), with
//                       per-sample float32 partials of the scale and bias
//                       gradients.
//
// Every sum runs in a fixed order (no atomics), so two runs on the same
// inputs agree bit for bit.  The statistics and the h formula are a third
// copy of the fused attention kernels' (fused_attn_block.cu,
// fused_attn_block_bwd.cu): a change to the rounding goes into all three.
// Everything sits in an unnamed namespace, so each translation unit gets its
// own copy.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRowThreads = 256;    // GroupNorm kernels

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16(v)); }

// GroupNorm of GPB adjacent groups of one sample of x: element (c, l) of
// sample b at x + b*sxb + c*sxc + l*sxl (NCHW: sxc = L, sxl = 1; token-major:
// sxc = 1, sxl = C).  Writes T(f(((x - mean) * inv) * gamma + beta)) (f = SiLU
// or the identity, in f32) token-major to out + b*sob + l*C + c, (mean, inv)
// of group g of sample b to stats[2 (b G + g)] when given, and with xt (NCHW
// x only) x itself token-major at the same places of xt.
//
// Each group's statistics are the sums of a one-group block: thread t adds
// the group's elements e = t, t + 256, ... (e = (c, l) = (e / L, e % L)
// channel-major, (e % cg, e / cg) token-major) in that order, then the
// butterfly in each warp and the warps' sums in order, so their bits do not
// depend on GPB.  GPB groups a block make a token's channels of the block
// GPB cg * 2 >= 32 bytes wherever cg allows (cg 4: four groups): whole
// sectors for the token-major reads and writes.  Where the block's values fit
// in 48 KB (every shape of the configs) they are read once, every load in
// flight, into shared memory, and the statistics and the output come from
// there; otherwise NCHW input goes through shared memory in tiles of tokens,
// read twice from device memory, loads eight ahead of the arithmetic.  Out
// in pieces of up to 16 bytes.
__device__ __forceinline__ void gn_copy(bf16* dst, const bf16* src, int vw) {
  if (vw == 8) *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  else if (vw == 4) *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  else if (vw == 2) *reinterpret_cast<unsigned*>(dst) = *reinterpret_cast<const unsigned*>(src);
  else *dst = *src;
}

constexpr int kGnTile = 4096;   // values of an apply tile: tokens x the block's channels
constexpr int kGnSlab = 24000;  // values of a block kept whole in shared memory (48,000 bytes)

template <int GPB>
__global__ void __launch_bounds__(kRowThreads) gn_apply_kernel(
    const bf16* x, long long sxb, long long sxc, long long sxl, int C, int L, int G,
    const bf16* gamma, const bf16* beta, float eps, int silu, bf16* out, long long sob,
    float* stats, bf16* xt) {
  __shared__ float red[kRowThreads / 32];
  __shared__ float mv[2][GPB];
  const int per_sample = G / GPB;
  const int b = blockIdx.x / per_sample, g0 = (blockIdx.x - b * per_sample) * GPB;
  const int cg = C / G, n = cg * L, cw = GPB * cg;
  const bool channel_major = sxl == 1;
  const bf16* base = x + b * sxb + static_cast<long long>(g0) * cg * sxc;   // the block's channel 0
  float s[GPB], s2[GPB];
#pragma unroll
  for (int gi = 0; gi < GPB; ++gi) s[gi] = s2[gi] = 0.f;
  auto add = [&](int gi, bf16 w) {
    const float v = bf(w);
    s[gi] += v;
    s2[gi] += v * v;
  };
  constexpr int kAhead = GPB >= 8 ? 1 : 8 / GPB;   // loads of a group ahead of its sums
  extern __shared__ __align__(16) bf16 slab[];
  const bool whole = cw * L <= kGnSlab;
  if (whole) {
    // The block's values once into shared memory, every load in flight:
    // channel-major as cw rows of L tokens (one contiguous run of x), token-major
    // as L rows of cw channels.  The statistics then read them in the order above.
    if (channel_major) {
      const int total = cw * L;
      if (L % 8 == 0) {
        for (int i = threadIdx.x; i < total / 8; i += kRowThreads)
          reinterpret_cast<uint4*>(slab)[i] = reinterpret_cast<const uint4*>(base)[i];
      } else {
        for (int i = threadIdx.x; i < total; i += kRowThreads) slab[i] = base[i];
      }
    } else {
      const int vwl = (cw & 7) == 0 ? 8 : (cw & 3) == 0 ? 4 : (cw & 1) == 0 ? 2 : 1;
      const int pl = cw / vwl;
      for (int i = threadIdx.x; i < L * pl; i += kRowThreads) {
        const int l = i / pl, j = (i - l * pl) * vwl;
        gn_copy(slab + l * cw + j, base + static_cast<long long>(l) * sxl + j, vwl);
      }
    }
    __syncthreads();
    if (channel_major) {
      for (int e = threadIdx.x; e < n; e += kRowThreads)
#pragma unroll
        for (int gi = 0; gi < GPB; ++gi) add(gi, slab[gi * n + e]);
    } else if (kRowThreads % cg == 0) {
      const int c = threadIdx.x % cg, step = kRowThreads / cg;
      for (int l = threadIdx.x / cg; l < L; l += step)
#pragma unroll
        for (int gi = 0; gi < GPB; ++gi) add(gi, slab[l * cw + gi * cg + c]);
    } else {
      for (int e = threadIdx.x; e < n; e += kRowThreads)
#pragma unroll
        for (int gi = 0; gi < GPB; ++gi) add(gi, slab[(e / cg) * cw + gi * cg + e % cg]);
    }
  } else if (channel_major) {
    int e = threadIdx.x;
    for (; e + (kAhead - 1) * kRowThreads < n; e += kAhead * kRowThreads) {
      bf16 w[GPB][kAhead];
#pragma unroll
      for (int gi = 0; gi < GPB; ++gi)
#pragma unroll
        for (int k = 0; k < kAhead; ++k) w[gi][k] = base[static_cast<long long>(gi) * n + e + k * kRowThreads];
#pragma unroll
      for (int gi = 0; gi < GPB; ++gi)
#pragma unroll
        for (int k = 0; k < kAhead; ++k) add(gi, w[gi][k]);
    }
    for (; e < n; e += kRowThreads)
#pragma unroll
      for (int gi = 0; gi < GPB; ++gi) add(gi, base[static_cast<long long>(gi) * n + e]);
  } else if (kRowThreads % cg == 0) {
    // a thread's channel is fixed: c = t % cg, tokens t / cg + k 256 / cg
    const int c = threadIdx.x % cg, step = kRowThreads / cg;
    const bf16* p = base + c;
    int l = threadIdx.x / cg;
    for (; l + (kAhead - 1) * step < L; l += kAhead * step) {
      bf16 w[GPB][kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
#pragma unroll
        for (int gi = 0; gi < GPB; ++gi) w[gi][k] = p[static_cast<long long>(l + k * step) * sxl + gi * cg];
#pragma unroll
      for (int gi = 0; gi < GPB; ++gi)
#pragma unroll
        for (int k = 0; k < kAhead; ++k) add(gi, w[gi][k]);
    }
    for (; l < L; l += step)
#pragma unroll
      for (int gi = 0; gi < GPB; ++gi) add(gi, p[static_cast<long long>(l) * sxl + gi * cg]);
  } else {
    for (int e = threadIdx.x; e < n; e += kRowThreads)
#pragma unroll
      for (int gi = 0; gi < GPB; ++gi) add(gi, base[gi * cg + (e % cg) + (e / cg) * sxl]);
  }
  const float inv_n = 1.f / static_cast<float>(n);
  // every group's two sums in the fixed order (butterfly in each warp,
  // then the warps' totals in order), through one exchange
  __shared__ float part[2 * GPB][kRowThreads / 32];
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int gi = 0; gi < GPB; ++gi)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s[gi] += __shfl_xor_sync(0xffffffffu, s[gi], off);
        s2[gi] += __shfl_xor_sync(0xffffffffu, s2[gi], off);
      }
    if (lane == 0)
#pragma unroll
      for (int gi = 0; gi < GPB; ++gi) {
        part[2 * gi][warp] = s[gi];
        part[2 * gi + 1][warp] = s2[gi];
      }
    __syncthreads();
  }
#pragma unroll
  for (int gi = 0; gi < GPB; ++gi) {
    float t = 0.f, t2 = 0.f;
    for (int i = 0; i < kRowThreads / 32; ++i) {
      t += part[2 * gi][i];
      t2 += part[2 * gi + 1][i];
    }
    if (threadIdx.x == 0) {
      const float mean = __fmul_rn(t, inv_n);
      const float var = __fsub_rn(__fmul_rn(t2, inv_n), __fmul_rn(mean, mean));
      mv[0][gi] = mean;
      mv[1][gi] = 1.f / sqrtf(var + eps);
      if (stats != nullptr) {
        stats[2 * (b * G + g0 + gi)] = mean;
        stats[2 * (b * G + g0 + gi) + 1] = mv[1][gi];
      }
    }
  }
  __syncthreads();
  auto apply = [&](bf16 v, int c) {   // c: the block's channel
    const int gi = c / cg, ch = g0 * cg + c;
    float t = __fmul_rn(__fsub_rn(bf(v), mv[0][gi]), mv[1][gi]);
    t = __fadd_rn(__fmul_rn(t, bf(gamma[ch])), bf(beta[ch]));
    if (silu) t = t / (1.f + expf(-t));
    return __float2bfloat16(t);
  };
  const int vw = (cw & 7) == 0 ? 8 : (cw & 3) == 0 ? 4 : (cw & 1) == 0 ? 2 : 1;
  const int per = cw / vw;
  const long long ob = b * sob + static_cast<long long>(g0) * cg;
  if (whole) {
    // each piece (token l, channels j .. j + vw - 1) from shared memory, out in
    // one store (and x itself into xt)
    for (int e = threadIdx.x; e < L * per; e += kRowThreads) {
      const int l = e / per, j = (e - l * per) * vw;
      __align__(16) bf16 v[8], w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < vw) {
          w[k] = channel_major ? slab[(j + k) * L + l] : slab[l * cw + j + k];
          v[k] = apply(w[k], j + k);
        }
      const long long at = ob + static_cast<long long>(l) * C + j;
      gn_copy(out + at, v, vw);
      if (xt != nullptr) gn_copy(xt + at, w, vw);
    }
    return;
  }
  bf16 (*tile)[kGnTile] = reinterpret_cast<bf16 (*)[kGnTile]>(slab);
  if (channel_major) {
    const int T = kGnTile / cw < L ? kGnTile / cw : L;
    for (int l0 = 0; l0 < L; l0 += T) {
      const int nt = L - l0 < T ? L - l0 : T;
      // thread -> (channel, token) walking the tile's tokens, then channels;
      // eight elements loaded ahead of the arithmetic
      int c = threadIdx.x / nt, i = threadIdx.x - c * nt;
      const int dc = kRowThreads / nt, di = kRowThreads - dc * nt;
      while (c < cw) {
        bf16 w[8];
        int at[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          at[k] = -1;
          if (c < cw) {
            w[k] = base[c * sxc + l0 + i];
            at[k] = i * cw + c;
            c += dc;
            i += di;
            if (i >= nt) {
              i -= nt;
              ++c;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (at[k] < 0) break;
          tile[0][at[k]] = apply(w[k], at[k] % cw);
          if (xt != nullptr) tile[1][at[k]] = w[k];
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < nt * per; e += kRowThreads) {
        const int i2 = e / per, j = (e - i2 * per) * vw;
        const long long at = ob + static_cast<long long>(l0 + i2) * C + j;
        gn_copy(out + at, &tile[0][i2 * cw + j], vw);
        if (xt != nullptr) gn_copy(xt + at, &tile[1][i2 * cw + j], vw);
      }
      __syncthreads();
    }
    return;
  }
  // token-major: a thread keeps one piece of vw of the block's channels (when
  // per divides 256) and walks the tokens, four pieces loaded ahead
  if (kRowThreads % per == 0) {
    const int j = (threadIdx.x % per) * vw, lstep = kRowThreads / per;
    for (int l = threadIdx.x / per; l < L; l += 4 * lstep) {
      __align__(16) bf16 v[4][8];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (l + k * lstep < L)
          gn_copy(v[k], base + static_cast<long long>(l + k * lstep) * sxl + j, vw);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (l + k * lstep >= L) break;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (q < vw) v[k][q] = apply(v[k][q], j + q);
        gn_copy(out + ob + static_cast<long long>(l + k * lstep) * C + j, v[k], vw);
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < L * per; e += kRowThreads) {
    const int l = e / per, j = (e - l * per) * vw;
    __align__(16) bf16 v[8];
    gn_copy(v, base + static_cast<long long>(l) * sxl + j, vw);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < vw) v[q] = apply(v[q], j + q);
    gn_copy(out + ob + static_cast<long long>(l) * C + j, v, vw);
  }
}

// Groups a GroupNorm block takes: a power of two dividing G, as many as make
// a token's channels of the block 16 values (32 bytes) where cg is small.
inline int gn_groups_per_block(int C, int G) {
  const int cg = C / G;
  int gpb = 1;
  while (2 * gpb * cg <= 16 && G % (2 * gpb) == 0) gpb *= 2;
  return gpb;
}

// gn_apply_kernel over B samples and G groups (arguments as the kernel's).
inline cudaError_t launch_gn_apply(const bf16* x, long long sxb, long long sxc, long long sxl,
                                   int B, int C, int L, int G, const bf16* gamma,
                                   const bf16* beta, float eps, int silu, bf16* out,
                                   long long sob, float* stats, bf16* xt, cudaStream_t s) {
  const int gpb = gn_groups_per_block(C, G);
  const int blocks = B * (G / gpb), cw = gpb * (C / G);
  const int smem = 2 * (cw * L <= kGnSlab ? cw * L : 2 * kGnTile);   // the block's values, or two tiles
#define RDM_GN_CASE(N)                                                                      \
  case N:                                                                                   \
    gn_apply_kernel<N><<<blocks, kRowThreads, smem, s>>>(x, sxb, sxc, sxl, C, L, G, gamma, \
                                                         beta, eps, silu, out, sob, stats, xt); \
    break;
  switch (gpb) {
    RDM_GN_CASE(1)
    RDM_GN_CASE(2)
    RDM_GN_CASE(4)
    RDM_GN_CASE(8)
    RDM_GN_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef RDM_GN_CASE
  return cudaGetLastError();
}

// GroupNorm's backward for one (sample, group), the forward's statistics
// given: dh float32 NCHW (dh + b*sdb + c*L + l), x and the output cotangent
// g NCHW in bf16, all read along l.  dx = T(inv * (dxhat - m1 - xhat * m2) + g *
// rescale) with dxhat = dh * gamma and m1, m2 the group means of dxhat and
// dxhat * xhat; partial[(b*2 + 0)*C + c] = sum_l dh * xhat and
// partial[(b*2 + 1)*C + c] = sum_l dh.  Every sum is each warp's butterfly,
// then the warps' sums in order; all of them meet at one barrier.
constexpr int kGnBwdMaxCg = 256;    // channels of a group at most

__global__ void __launch_bounds__(kRowThreads) gn_bwd_kernel(
    const float* dh, long long sdb, const bf16* x, const bf16* g, const float* stats,
    const bf16* gamma, int C, int L, int G, float rescale, bf16* dx, float* partial) {
  constexpr int kWarpsPer = kRowThreads / 32;
  __shared__ float part[2 * kGnBwdMaxCg][kWarpsPer];
  __shared__ float mpart[2][kWarpsPer];
  const int b = blockIdx.x / G, grp = blockIdx.x - b * G, cg = C / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float mean = stats[2 * blockIdx.x], inv = stats[2 * blockIdx.x + 1];
  const float* d = dh + b * sdb;
  const long long xb = static_cast<long long>(b) * C * L;
  float m1 = 0.f, m2 = 0.f;
  for (int cc = 0; cc < cg; ++cc) {
    const int c = grp * cg + cc;
    const float gam = bf(gamma[c]);
    float sg = 0.f, sb = 0.f;
    for (int l = threadIdx.x; l < L; l += kRowThreads) {
      const float dv = d[static_cast<long long>(c) * L + l];
      const float xh = __fmul_rn(__fsub_rn(bf(x[xb + static_cast<long long>(c) * L + l]), mean), inv);
      const float dxh = __fmul_rn(dv, gam);
      sg += dv * xh;
      sb += dv;
      m1 += dxh;
      m2 += dxh * xh;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sg += __shfl_xor_sync(0xffffffffu, sg, off);
      sb += __shfl_xor_sync(0xffffffffu, sb, off);
    }
    if (lane == 0) {
      part[2 * cc][warp] = sg;
      part[2 * cc + 1][warp] = sb;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m1 += __shfl_xor_sync(0xffffffffu, m1, off);
    m2 += __shfl_xor_sync(0xffffffffu, m2, off);
  }
  if (lane == 0) {
    mpart[0][warp] = m1;
    mpart[1][warp] = m2;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * cg; i += kRowThreads) {
    float t = 0.f;
    for (int w = 0; w < kWarpsPer; ++w) t += part[i][w];
    partial[(2 * b + (i & 1)) * C + grp * cg + (i >> 1)] = t;
  }
  float t1 = 0.f, t2 = 0.f;
  for (int w = 0; w < kWarpsPer; ++w) {
    t1 += mpart[0][w];
    t2 += mpart[1][w];
  }
  const float inv_n = 1.f / static_cast<float>(cg * L);
  m1 = __fmul_rn(t1, inv_n);
  m2 = __fmul_rn(t2, inv_n);
  for (int e = threadIdx.x; e < cg * L; e += kRowThreads) {
    const int cc = e / L, l = e - cc * L, c = grp * cg + cc;
    const long long xi = xb + static_cast<long long>(c) * L + l;
    const float dv = d[static_cast<long long>(c) * L + l];
    const float xh = __fmul_rn(__fsub_rn(bf(x[xi]), mean), inv);
    const float dxh = __fmul_rn(dv, bf(gamma[c]));
    const float t = __fmul_rn(inv, __fsub_rn(__fsub_rn(dxh, m1), __fmul_rn(xh, m2)));
    dx[xi] = __float2bfloat16(__fadd_rn(t, __fmul_rn(bf(g[xi]), rescale)));
  }
}

}  // namespace
