// Per-warp tensor-core attention in bfloat16 (mma.sync.m16n8k16, float32
// sums): one warp computes softmax(q k^T * scale) v for 16 query rows of one
// sample whose q, k and v are staged in shared memory, with the scores and
// probabilities kept in registers.
//
// Staged layout: a tensor of ROWS rows of 8 NCH bf16 values (NCH 16-byte
// chunks, NCH a multiple of 8) is kept as NCH / 8 panels of ROWS x 64 values,
// as TMA writes a box of 128-byte rows with the 128-byte swizzle: chunk ch of
// row r sits in panel ch / 8 at chunk slot (ch ^ r) % 8 of the row, so the
// eight row addresses of one ldmatrix (eight rows, one chunk column) fall on
// distinct banks.  Keys past L and channels past C must be staged as zeros:
// they are multiplied, and a padded key is masked to -inf before the softmax,
// so its probability is exactly 0.
//
// Rounding (the two variants of attention_core.cu):
// * float32 softmax: s = acc * scale, p = rnd(exp(s - max) / sum), sum in f32;
// * kScoresInT: s = rnd(rnd(acc) * rnd(scale)), d = rnd(s - max),
//   e = rnd(exp(d)), the sum taken in f32 and rounded, p = rnd(e / sum);
// then p v accumulates in f32 (rounded once by the caller).
#pragma once

#include <cmath>

#include "mma_ptx.cuh"

namespace {

// Element offset of chunk ch of row r in a staged tensor of ROWS rows.
template <int ROWS>
__device__ __forceinline__ int swizzled_chunk(int r, int ch) {
  return (ch >> 3) * ROWS * 64 + r * 64 + ((ch ^ r) & 7) * 8;
}

__device__ __forceinline__ float rnd_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Two floats rounded to bf16 and back (one conversion for the pair).
__device__ __forceinline__ float2 rnd2_bf16(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// o (16 x 16 CT, float) = softmax(q k^T * scale) v for query rows r0 .. r0 + 15
// of the staged q, k and v (16 NT key rows, 16 CT channels each); lane l
// receives rows r0 + l / 4 (o[n][0..1]) and r0 + l / 4 + 8 (o[n][2..3]) at
// channels 8 n + 2 (l % 4) + {0, 1}.  L is the number of real keys.
template <int NT, int CT, bool kScoresInT>
__device__ __forceinline__ void attn_rows16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                            const __nv_bfloat16* v, int r0, int L, float scale,
                                            float (&o)[2 * CT][4]) {
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;

  // S = q k^T: 2 NT tiles of 8 keys.  k row-major is the column-major B
  // operand of q k^T, so plain ldmatrix gives its fragments.
  float s[2 * NT][4];
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < CT; ++kc) {
    unsigned a[4];
    ldmatrix_x4(a, q + swizzled_chunk<16 * NT>(r0 + (lane & 15), 2 * kc + (lane >> 4)));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      unsigned b[4];   // keys 16 j + 0..7 then + 8..15; channels 16 kc + 0..7 and + 8..15
      ldmatrix_x4(b, k + swizzled_chunk<16 * NT>(16 * j + (lane & 7) + ((lane >> 4) << 3),
                                             2 * kc + ((lane >> 3) & 1)));
      mma_bf16(s[2 * j], a, b[0], b[1]);
      mma_bf16(s[2 * j + 1], a, b[2], b[3]);
    }
  }

  // Softmax of rows r0 + lane / 4 (s[.][0..1]) and + 8 (s[.][2..3]); a row's
  // values are spread over the four lanes of a quad.  Tiles of keys that are
  // all real skip the mask, tiles of padding alone the exp (the same p: 0).
  const float scale_t = rnd_bf16(scale);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    const bool ragged = 8 * j + 8 > L;
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // the pair of row r0 + lane / 4 + 8 h
      float2 x = make_float2(s[j][2 * h] * scale, s[j][2 * h + 1] * scale);
      if (kScoresInT) {
        x = rnd2_bf16(s[j][2 * h], s[j][2 * h + 1]);
        x = rnd2_bf16(x.x * scale_t, x.y * scale_t);
      }
      s[j][2 * h] = !ragged || 8 * j + 2 * tq < L ? x.x : -INFINITY;
      s[j][2 * h + 1] = !ragged || 8 * j + 2 * tq + 1 < L ? x.y : -INFINITY;
      mx[h] = fmaxf(mx[h], fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    if (8 * j >= L) {                 // padding alone: p is 0 without an exp
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {     // -inf for a padded key: exp gives 0
      float2 d = make_float2(s[j][2 * h] - mx[h], s[j][2 * h + 1] - mx[h]);
      if (kScoresInT) d = rnd2_bf16(d.x, d.y);
      float2 e = make_float2(expf(d.x), expf(d.y));
      if (kScoresInT) e = rnd2_bf16(e.x, e.y);
      s[j][2 * h] = e.x;
      s[j][2 * h + 1] = e.y;
      sum[h] += e.x + e.y;
    }
  }
  // p = e / sum, correctly rounded: with y = 1 / sum rounded and q = e y, the
  // remainder e - q sum is exact in one fma and q + (e - q sum) y rounds to
  // e / sum (Markstein) for the e in [0, 1] and sum in [1, 128] of a softmax,
  // without the special-case branch of a general division.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    if (kScoresInT) sum[h] = rnd_bf16(sum[h]);
    inv[h] = __frcp_rn(sum[h]);
  }
  auto div = [&](float e, int h) {
    const float q = e * inv[h];
    return fmaf(fmaf(-q, sum[h], e), inv[h], q);
  };

  // p v: two neighbouring 8-key accumulator tiles of p, rounded to bf16, are
  // the A fragment of the next m16n8k16 (the layouts coincide), so p never
  // leaves the registers; v's B fragments come from ldmatrix.trans.
#pragma unroll
  for (int n = 0; n < 2 * CT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const unsigned p[4] = {pack_bf16(div(s[2 * j][0], 0), div(s[2 * j][1], 0)),
                           pack_bf16(div(s[2 * j][2], 1), div(s[2 * j][3], 1)),
                           pack_bf16(div(s[2 * j + 1][0], 0), div(s[2 * j + 1][1], 0)),
                           pack_bf16(div(s[2 * j + 1][2], 1), div(s[2 * j + 1][3], 1))};
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      unsigned b[4];   // keys 16 j + 0..15; channels 16 c + 0..7 then + 8..15
      ldmatrix_x4_trans(b, v + swizzled_chunk<16 * NT>(16 * j + (lane & 15), 2 * c + (lane >> 4)));
      mma_bf16(o[2 * c], p, b[0], b[1]);
      mma_bf16(o[2 * c + 1], p, b[2], b[3]);
    }
  }
}

// Round the warp's 16 x C result once to bf16 and write rows r0 .. r0 + 15
// below L to out (row stride C) with 16-byte stores, through `stage`: 16
// staged rows (same swizzle) that only this warp uses.
template <int NT, int CT>
__device__ __forceinline__ void store_rows16(const float (&o)[2 * CT][4], __nv_bfloat16* stage,
                                             int r0, int L, int C, __nv_bfloat16* out) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 2 * CT; ++n) {
    *reinterpret_cast<unsigned*>(stage + swizzled_chunk<16 * NT>(r0 + g, n) + 2 * tq) =
        pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<unsigned*>(stage + swizzled_chunk<16 * NT>(r0 + g + 8, n) + 2 * tq) =
        pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  const int cch = C / 8;
  for (int i = lane; i < 16 * cch; i += 32) {
    const int r = i / cch, ch = i - r * cch;
    if (r0 + r < L)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(r0 + r) * C + 8 * ch) =
          *reinterpret_cast<const uint4*>(stage + swizzled_chunk<16 * NT>(r0 + r, ch));
  }
}

}  // namespace
