// Fused NCSN++ attention block, forward and backward, in bfloat16 at the widths
// whose one sample does not fit in a block's shared memory: C in {32, 64,
// 128, 256} and up to 256 tokens (DDPM++ on CIFAR-10: C 256, L 256; the
// nf-32 NCSN++: C 32, L 81), sm_90a.
//
// Replaces, at these shapes, the TPU kernels rdm_tpu/ops/pallas/attention.py
// ::_fused_block_kernel (forward) and ::_fused_block_bwd_kernel (backward);
// the flagship's shapes keep fused_attn_block.cu and fused_attn_block_bwd.cu.
// At C 256, L 256 one sample's q, k and v take 128 KB each in bf16 and its
// scores 256 KB in f32, more than a block's 227 KB of shared memory, so the
// block is cut into launches that meet in global memory, every intermediate
// stored in bf16 where the TPU kernel rounds it (h, q, k, v, p, o; do, ds, dq,
// dk, dv), so the rounding points are the TPU kernel's:
//
// forward   gn_apply_kernel      h = T(GroupNorm(x)), token-major
//           wg_gemm_kernel       [q | k | v] = T(T(h [Wq | Wk | Wv]) + b), one
//                                product over all B Lp token rows (wg_gemm.cuh)
//           attn_fwd_kernel      o = T(T(softmax(q k^T / sqrt C)) v) for 128 query
//                                rows a block: a producer warp streams q and k in
//                                64-channel stages, then v, by TMA; each of two
//                                consumer warpgroups keeps the f32 scores of its
//                                64 rows over all keys in wgmma accumulators, so
//                                the softmax is exact in f32 (the row max and sum
//                                over every key first, then p normalised and
//                                rounded, then p.v: the TPU's rounding points,
//                                which a one-pass online softmax would move), and
//                                p goes from registers into the p.v wgmma
//           wg_gemm_kernel       out = T(T(x + T(T(o Wp) + bp)) * T(1/sqrt 2)), NCHW
// backward  the forward's first three launches again (recompute), then
//           gs = T(T(g) T(rescale)); do = T(gs Wp^T);
//           attn_ds_kernel       p again, pt = T(p), dp = do v^T in chunks of 64
//                                keys, each row's sum of dp * p over all keys, then
//                                ds = T(p (dp - sum) / sqrt C)
//           dq = T(ds k), dk = T(ds^T q), dv = T(pt^T do)   (tiled_gemm_kernel)
//           dh = [dq | dk | dv] [Wq | Wk | Wv]^T in f32; gn_bwd_kernel gives dx
//           and per-sample partials of dgamma, dbeta; the weight gradients
//           [dWq | dWk | dWv] = h^T [dq | dk | dv] and dWp = o^T gs as split-K
//           float32 partials, with a row of ones in the A operand giving the bias
//           gradients; every partial summed in a fixed order (sum_partials_kernel),
//           so two runs agree bit for bit and no gradient is rounded to bf16.
//
// Bound on this card at C 256, L 256: about 201 MFLOP a sample forward (13 us
// at B 64 against 989 TFLOP/s, against 5 us for its 16.8 MB), so operations
// bound it; the backward does about twice the products.  The forward's
// products and attention run on wgmma fed by TMA rings; the backward's own
// launches still run on tiled_gemm_kernel's mma.sync tiles.  PERF.md has the
// times.
#include <cmath>

#include "smem_attr.cuh"
#include "wg_gemm.cuh"

namespace {

constexpr int kQRows = 64;        // query rows of an attention block (16 a warp)
constexpr int kAttnThreads = 128;
constexpr int kMaxTokens = 256;

__host__ __device__ inline int padded_tokens(int L) { return (L + 15) / 16 * 16; }

int attn_smem_bytes(int C, int L, int q_tiles_of_rows) {
  return (q_tiles_of_rows * kQRows + padded_tokens(L)) * (C + 8) * 2;
}

// Rows [r0, r0 + rows) of a token-major bf16 matrix (row stride ld elements)
// into shared memory (row stride C + 8), C columns from column col, zeros for
// rows at or past valid.
__device__ __forceinline__ void stage_rows(bf16* s, const bf16* g, int ld, int col, int r0,
                                           int rows, int valid, int C) {
  const int chunks = C / 8, CP = C + 8;
  for (int q = threadIdx.x; q < rows * chunks; q += blockDim.x) {
    const int r = q / chunks, cc = (q - r * chunks) * 8;
    uint4 u = zero4();
    if (r0 + r < valid)
      u = *reinterpret_cast<const uint4*>(g + static_cast<long long>(r0 + r) * ld + col + cc);
    *reinterpret_cast<uint4*>(s + r * CP + cc) = u;
  }
}

// s = (A B^T) for the warp's 16 rows of sA (row stride C + 8) against rows
// 0 .. 16 * kt - 1 of sB: s[j] is the m16n8 tile of keys 8j .. 8j + 7.
template <int KTM>
__device__ __forceinline__ void warp_scores(float (&s)[2 * KTM][4], const bf16* sA, const bf16* sB,
                                            int C, int kt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, CP = C + 8;
#pragma unroll
  for (int j = 0; j < 2 * KTM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  for (int kk = 0; kk < C; kk += 16) {
    unsigned af[4];
    ldmatrix_x4(af, sA + (warp * 16 + (lane & 15)) * CP + kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < KTM; ++j) {
      if (j < kt) {
        unsigned b[4];
        ldmatrix_x4(b, sB + (j * 16 + (lane & 7) + (lane >> 4) * 8) * CP + kk +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j], af, b[0], b[1]);
        mma_bf16(s[2 * j + 1], af, b[2], b[3]);
      }
    }
  }
}

// The exact f32 softmax of the warp's 16 score rows in place: scale, keys at
// or past L masked, exp(s - row max) / row sum over every key.
template <int KTM>
__device__ __forceinline__ void warp_softmax(float (&s)[2 * KTM][4], int L, float scale) {
  const int lane = threadIdx.x & 31;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2 * KTM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + (lane & 3) * 2 + (e & 1);
      s[j][e] = key < L ? __fmul_rn(s[j][e], scale) : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int j = 0; j < 2 * KTM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + (lane & 3) * 2 + (e & 1);
      s[j][e] = key < L ? expf(__fsub_rn(s[j][e], mx[e >> 1])) : 0.f;
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
#pragma unroll
  for (int j = 0; j < 2 * KTM; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] / sum[e >> 1];
}

constexpr int kFwdRows = 128;     // query rows of a forward block: two warpgroups of 64
constexpr int kFwdThreads = 288;  // two consumer warpgroups and a producer warp

// Key tiles of 64 the forward kernel is built for: 1, 2 or 4 (up to 256 keys).
__host__ __device__ inline int fwd_key_tiles_max(int L) {
  const int kt = (L + 63) / 64;
  return kt <= 1 ? 1 : kt <= 2 ? 2 : 4;
}

// A q/k stage: 64 channels of the block's 128 queries and of every key; a v
// stage: 64 channels of every key.  Two of each, from a 1024-byte boundary.
__host__ __device__ constexpr int fwd_qk_stage(int ktm) { return kFwdRows * 128 + ktm * 8192; }
__host__ __device__ constexpr int fwd_smem_bytes(int ktm) {
  return 1024 + 2 * fwd_qk_stage(ktm) + 2 * ktm * 8192 + 8 * 8;
}

// grid (ceil(L / 128), B), 288 threads.  qmap, kmap, vmap: 3-D maps (C, L, B)
// of the token-major q, k and v (rows 3C apart, Lp rows a sample), boxes of
// 64 channels x 64 tokens, zeros past C and past L; o: (B, Lp, C) bf16, rows
// < L written.
template <int KTM>
__global__ void __launch_bounds__(kFwdThreads, 1) attn_fwd_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* o, int C, int L, float scale) {
  constexpr int kQK = fwd_qk_stage(KTM), kV = KTM * 8192;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qk = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* vs = qk + 2 * kQK;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + 2 * kV);
  uint64_t *qk_full = bars, *qk_empty = bars + 2, *v_full = bars + 4, *v_empty = bars + 6;
  const int Lp = padded_tokens(L), kt = (L + 63) / 64, chunks = (C + 63) / 64;
  const int b = blockIdx.y, q0 = blockIdx.x * kFwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(qk_full + i, 1);
      mbar_init(qk_empty + i, 8);           // one arrival per consumer warp
      mbar_init(v_full + i, 1);
      mbar_init(v_empty + i, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {
    // Producer: q and k chunk by chunk, then v; v's first two stages load
    // while the consumers run the softmax.
    if (lane == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int slot = c & 1;
        if (c >= 2) mbar_wait(qk_empty + slot, ((c >> 1) - 1) & 1);
        unsigned char* st = qk + slot * kQK;
        mbar_expect_tx(qk_full + slot, kFwdRows * 128 + kt * 8192);
        tma_load_3d(st, &qmap, 64 * c, q0, b, qk_full + slot);
        tma_load_3d(st + 8192, &qmap, 64 * c, q0 + 64, b, qk_full + slot);
        for (int j = 0; j < kt; ++j)
          tma_load_3d(st + kFwdRows * 128 + j * 8192, &kmap, 64 * c, 64 * j, b, qk_full + slot);
      }
      for (int c = 0; c < chunks; ++c) {
        const int slot = c & 1;
        if (c >= 2) mbar_wait(v_empty + slot, ((c >> 1) - 1) & 1);
        unsigned char* st = vs + slot * kV;
        mbar_expect_tx(v_full + slot, kt * 8192);
        for (int j = 0; j < kt; ++j)
          tma_load_3d(st + j * 8192, &vmap, 64 * c, 64 * j, b, v_full + slot);
      }
    }
    return;
  }

  // Consumer warpgroup wg: query rows q0 + 64 wg ..; s[j] holds keys 64 j ..
  // 64 j + 63 in wgmma's accumulator layout (n-tile t, element e: row
  // 16 (warp % 4) + lane / 4 + 8 (e / 2), key 64 j + 8 t + 2 (lane % 4) + e % 2).
  const int wg = warp >> 2;
  float s[KTM][8][4];
#pragma unroll
  for (int j = 0; j < KTM; ++j) {
#pragma unroll
    for (int t = 0; t < 8; ++t) s[j][t][0] = s[j][t][1] = s[j][t][2] = s[j][t][3] = 0.f;
    wg_fence_acc(s[j]);
  }
  for (int c = 0; c < chunks; ++c) {
    const int slot = c & 1;
    mbar_wait(qk_full + slot, (c >> 1) & 1);
    __syncwarp();                            // wgmma is warp-aligned
    wg_fence();
    const unsigned char* st = qk + slot * kQK;
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16)
#pragma unroll
      for (int j = 0; j < KTM; ++j)
        if (j < kt)
          wg_ss<8>(s[j], sw128_desc(st + wg * 8192 + 32 * k16, 16, 1024),
                   sw128_desc(st + kFwdRows * 128 + j * 8192 + 32 * k16, 16, 1024));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < KTM; ++j) wg_fence_acc(s[j]);
    if (lane == 0) mbar_arrive(qk_empty + slot);
  }

  // The exact f32 softmax of each row over every key (keys at or past L masked).
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < KTM; ++j)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 64 * j + 8 * t + 2 * (lane & 3) + (e & 1);
        s[j][t][e] = key < L ? __fmul_rn(s[j][t][e], scale) : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][t][e]);
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int j = 0; j < KTM; ++j)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 64 * j + 8 * t + 2 * (lane & 3) + (e & 1);
        s[j][t][e] = key < L ? expf(__fsub_rn(s[j][t][e], mx[e >> 1])) : 0.f;
        sum[e >> 1] += s[j][t][e];
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }
  // p = T(s / sum) as the A fragments of p.v: 16 keys 16 kb .. a fragment
  unsigned pa[4 * KTM][4];
#pragma unroll
  for (int j = 0; j < KTM; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float (&lo)[4] = s[j][2 * t];
      float (&hi)[4] = s[j][2 * t + 1];
      pa[4 * j + t][0] = pack_bf16(lo[0] / sum[0], lo[1] / sum[0]);
      pa[4 * j + t][1] = pack_bf16(lo[2] / sum[1], lo[3] / sum[1]);
      pa[4 * j + t][2] = pack_bf16(hi[0] / sum[0], hi[1] / sum[0]);
      pa[4 * j + t][3] = pack_bf16(hi[2] / sum[1], hi[3] / sum[1]);
    }

  // o = T(p v), 64 channels a v stage (the N-major B operand: a 128-byte row
  // a key).
  const int row0 = q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  for (int c = 0; c < chunks; ++c) {
    const int slot = c & 1;
    float acc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    wg_fence_acc(acc);
    mbar_wait(v_full + slot, (c >> 1) & 1);
    __syncwarp();
    wg_fence();
    const unsigned char* st = vs + slot * kV;
#pragma unroll
    for (int kb = 0; kb < 4 * KTM; ++kb)
      if (kb < 4 * kt) wg_rs_t<8>(acc, pa[kb], sw128_desc(st + kb * 2048, 1024, 1024));
    wg_commit();
    wg_wait<0>();
    wg_fence_acc(acc);
    if (lane == 0) mbar_arrive(v_empty + slot);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h, col = 64 * c + 8 * t + 2 * (lane & 3);
        if (row < L && col < C)
          *reinterpret_cast<unsigned*>(o + (static_cast<long long>(b) * Lp + row) * C + col) =
              pack_bf16(acc[t][2 * h], acc[t][2 * h + 1]);
      }
  }
}

// grid (ceil(L / 64), B), 128 threads.  Writes pt = T(p) and ds = T(p (dp -
// sum_keys dp p) / sqrt C), (B, Lp, Lp) bf16, rows < L; do: (B, Lp, C).
template <int KTM>
__global__ void __launch_bounds__(kAttnThreads) attn_ds_kernel(
    const bf16* qkv, const bf16* dO, bf16* pt, bf16* ds, int C, int L, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Lp = padded_tokens(L), kt = Lp / 16, CP = C + 8, ld = 3 * C;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sD = sQ + kQRows * CP;
  bf16* sKV = sD + kQRows * CP;
  const int b = blockIdx.y, q0 = blockIdx.x * kQRows;
  const bf16* base = qkv + static_cast<long long>(b) * Lp * ld;
  stage_rows(sQ, base, ld, 0, q0, kQRows, L, C);
  stage_rows(sD, dO + static_cast<long long>(b) * Lp * C, C, 0, q0, kQRows, L, C);
  stage_rows(sKV, base, ld, C, 0, Lp, L, C);
  __syncthreads();
  float p[2 * KTM][4];
  warp_scores<KTM>(p, sQ, sKV, C, kt);
  warp_softmax<KTM>(p, L, scale);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const long long pb = static_cast<long long>(b) * Lp * Lp;
#pragma unroll
  for (int j = 0; j < 2 * KTM; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * 8, key = j * 8 + (lane & 3) * 2;
      if (row < L && key < Lp)
        *reinterpret_cast<unsigned*>(pt + pb + static_cast<long long>(row) * Lp + key) =
            pack_bf16(p[j][2 * h], p[j][2 * h + 1]);
    }
  __syncthreads();
  stage_rows(sKV, base, ld, 2 * C, 0, Lp, L, C);
  __syncthreads();
  // dp = do v^T in chunks of 64 keys: first each row's sum of dp * p, then ds
  float dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int ch = 0; ch < KTM / 4; ++ch) {
      if (ch * 4 < kt) {
        float dp[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
        for (int kk = 0; kk < C; kk += 16) {
          unsigned af[4];
          ldmatrix_x4(af, sD + (warp * 16 + (lane & 15)) * CP + kk + (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (ch * 4 + j < kt) {
              unsigned b4[4];
              ldmatrix_x4(b4, sKV + ((ch * 4 + j) * 16 + (lane & 7) + (lane >> 4) * 8) * CP + kk +
                                  ((lane >> 3) & 1) * 8);
              mma_bf16(dp[2 * j], af, b4[0], b4[1]);
              mma_bf16(dp[2 * j + 1], af, b4[2], b4[3]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv = p[ch * 8 + j][e];
            if (pass == 0) {
              dsum[e >> 1] += dp[j][e] * pv;
            } else {
              dp[j][e] = __fmul_rn(__fmul_rn(pv, __fsub_rn(dp[j][e], dsum[e >> 1])), scale);
            }
          }
        if (pass == 1) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + h * 8, key = (ch * 8 + j) * 8 + (lane & 3) * 2;
              if (row < L && key < Lp)
                *reinterpret_cast<unsigned*>(ds + pb + static_cast<long long>(row) * Lp + key) =
                    pack_bf16(dp[j][2 * h], dp[j][2 * h + 1]);
            }
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 1);
        dsum[h] += __shfl_xor_sync(0xffffffffu, dsum[h], 2);
      }
    }
  }
}

// gs[b, l, c] = T(g[b, c, l] * rescale) (rescale already in bf16), token-major
// with Lp rows a sample.
__global__ void scale_transpose_kernel(const bf16* g, int C, int L, long long total, float rescale,
                                       bf16* gs) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const long long b = i / (static_cast<long long>(C) * L);
  const int c = static_cast<int>((i / L) % C), l = static_cast<int>(i % L);
  gs[(b * padded_tokens(L) + l) * C + c] = __float2bfloat16(bf(g[i]) * rescale);
}

int key_tiles_max(int L) {
  const int kt = padded_tokens(L) / 16;
  return kt <= 4 ? 4 : kt <= 8 ? 8 : 16;
}

// One of the token-major q, k, v of [q | k | v] (col 0, C or 2C) as a 3-D
// map (C, L, B): rows 3C apart, Lp rows a sample, so the padded rows and the
// channels past C read as zeros; boxes of 64 channels x 64 tokens.
bool qkv_map(CUtensorMap* map, const bf16* qkv, int col, int B, int C, int L) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(3 * C) * 2,
                                 static_cast<cuuint64_t>(3 * C) * 2 * padded_tokens(L)};
  const cuuint32_t box[3] = {64, 64, 1};
  return wg_tensor_map(map, qkv + col, 3, dims, strides, box);
}

template <int KTM>
cudaError_t attn_fwd(const CUtensorMap (&maps)[3], bf16* o, int B, int C, int L, float scale,
                     cudaStream_t s) {
  static SmemAttr attr;
  constexpr int smem = fwd_smem_bytes(KTM);
  cudaError_t err = attr.apply(reinterpret_cast<const void*>(attn_fwd_kernel<KTM>), smem);
  if (err != cudaSuccess) return err;
  attn_fwd_kernel<KTM><<<dim3((L + kFwdRows - 1) / kFwdRows, B), kFwdThreads, smem, s>>>(
      maps[0], maps[1], maps[2], o, C, L, scale);
  return cudaGetLastError();
}

template <int KTM>
cudaError_t attn_ds(const bf16* qkv, const bf16* dO, bf16* pt, bf16* ds, int B, int C, int L,
                    float scale, cudaStream_t s) {
  static SmemAttr attr;
  const int smem = attn_smem_bytes(C, L, 2);
  cudaError_t err = attr.apply(reinterpret_cast<const void*>(attn_ds_kernel<KTM>), smem);
  if (err != cudaSuccess) return err;
  attn_ds_kernel<KTM><<<dim3((L + kQRows - 1) / kQRows, B), kAttnThreads, smem, s>>>(
      qkv, dO, pt, ds, C, L, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_fwd(const bf16* qkv, bf16* o, int B, int C, int L, float scale,
                         cudaStream_t s) {
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i)
    if (!qkv_map(&maps[i], qkv, i * C, B, C, L)) return cudaErrorInvalidValue;
  switch (fwd_key_tiles_max(L)) {
    case 1: return attn_fwd<1>(maps, o, B, C, L, scale, s);
    case 2: return attn_fwd<2>(maps, o, B, C, L, scale, s);
    default: return attn_fwd<4>(maps, o, B, C, L, scale, s);
  }
}

cudaError_t dispatch_ds(const bf16* qkv, const bf16* dO, bf16* pt, bf16* ds, int B, int C, int L,
                        float scale, cudaStream_t s) {
  switch (key_tiles_max(L)) {
    case 4: return attn_ds<4>(qkv, dO, pt, ds, B, C, L, scale, s);
    case 8: return attn_ds<8>(qkv, dO, pt, ds, B, C, L, scale, s);
    default: return attn_ds<16>(qkv, dO, pt, ds, B, C, L, scale, s);
  }
}

bool shape_ok(int B, int C, int L, int G) {
  return B >= 1 && (C == 32 || C == 64 || C == 128 || C == 256) && L >= 1 && L <= kMaxTokens &&
         G >= 1 && G <= 32 && C % G == 0;
}

// Split-K of the weight gradients: K = B * Lp token rows in chunks of a
// multiple of 32, at most 64 chunks and about 512 rows each.
int split_chunk(long long K) {
  long long S = (K + 511) / 512;
  if (S > 64) S = 64;
  if (S < 1) S = 1;
  const long long chunk = ((K + S - 1) / S + kBK - 1) / kBK * kBK;
  return static_cast<int>(chunk);
}

// The forward's two products on wg_gemm: [q | k | v] = h Wqkv and the
// output product, each over all B Lp token rows.
struct FwdPlans {
  WgArgs g[2];
  WgPlan p[2];
};

FwdPlans fwd_plans(int B, int C, int L) {
  FwdPlans r{};
  const int M = B * padded_tokens(L);
  r.p[0] = wg_plan(r.g[0], 0, B, 0, M, 3 * C, C);
  r.p[1] = wg_plan(r.g[1], 0, B, 0, M, C, C);
  return r;
}

struct FwdBuffers {
  float* stats;
  bf16 *h, *qkv, *o;
  float* partial;
};

FwdBuffers carve_fwd(Carve& w, int B, int C, int L, int G) {
  const long long rows = static_cast<long long>(B) * padded_tokens(L);
  const FwdPlans pl = fwd_plans(B, C, L);
  const long long part = wg_partial_bytes(pl.p[0], static_cast<int>(rows), 3 * C) >
                                 wg_partial_bytes(pl.p[1], static_cast<int>(rows), C)
                             ? wg_partial_bytes(pl.p[0], static_cast<int>(rows), 3 * C)
                             : wg_partial_bytes(pl.p[1], static_cast<int>(rows), C);
  FwdBuffers f;
  f.stats = w.take<float>(2LL * B * G);
  f.h = w.take<bf16>(rows * C);
  f.qkv = w.take<bf16>(rows * 3 * C);
  f.o = w.take<bf16>(rows * C);
  f.partial = part > 0 ? w.take<float>(part / 4) : nullptr;
  return f;
}

struct BwdBuffers {
  FwdBuffers f;
  bf16 *gs, *dO, *pt, *ds, *dqkv;
  float *dh, *gnpart, *part1, *part2;
  int chunk, splits;
};

BwdBuffers carve_bwd(Carve& w, int B, int C, int L, int G) {
  const int Lp = padded_tokens(L);
  const long long rows = static_cast<long long>(B) * Lp;
  BwdBuffers d;
  d.f = carve_fwd(w, B, C, L, G);
  d.gs = w.take<bf16>(rows * C);
  d.dO = w.take<bf16>(rows * C);
  d.pt = w.take<bf16>(rows * Lp);
  d.ds = w.take<bf16>(rows * Lp);
  d.dqkv = w.take<bf16>(rows * 3 * C);
  d.dh = w.take<float>(rows * C);
  d.gnpart = w.take<float>(2LL * B * C);
  d.chunk = split_chunk(rows);
  d.splits = static_cast<int>((rows + d.chunk - 1) / d.chunk);
  d.part1 = w.take<float>(static_cast<long long>(d.splits) * (C + 1) * 3 * C);
  d.part2 = w.take<float>(static_cast<long long>(d.splits) * (C + 1) * C);
  return d;
}

// The forward's launches up to o: h, [q | k | v] (padded rows not written),
// o; each part's end marked on clock.
cudaError_t forward_core(const bf16* x, const bf16* gamma, const bf16* beta, const bf16* wqkv_t,
                         const bf16* bqkv, const FwdBuffers& f, int B, int C, int L, int G,
                         float eps, float scale, cudaStream_t s, LaunchClock& clock) {
  const int Lp = padded_tokens(L);
  const long long sb = static_cast<long long>(Lp) * C;
  cudaError_t err = launch_gn_apply(x, static_cast<long long>(C) * L, L, 1, B, C, L, G, gamma,
                                    beta, eps, 0, f.h, sb, f.stats, nullptr, s);
  if (err != cudaSuccess || (err = clock.mark()) != cudaSuccess) return err;
  WgEpi e{};
  e.kind = kWgRow;
  e.out = f.qkv;
  e.ld = 3 * C;
  e.bias = bqkv;
  e.rps = Lp;
  e.valid = L;
  if ((err = wg_gemm(f.h, wqkv_t, 0, B, 0, B * Lp, 3 * C, C, e, f.partial, s)) != cudaSuccess ||
      (err = clock.mark()) != cudaSuccess)
    return err;
  if ((err = dispatch_fwd(f.qkv, f.o, B, C, L, scale, s)) != cudaSuccess) return err;
  return clock.mark();
}

constexpr int kGemmPlanInts = 14;   // WgPlan's ten fields and its box

void put_plan(const WgPlan& p, int* out) {
  const int v[kGemmPlanInts] = {p.bm,     p.bn,     p.tiles_m, p.tiles_n, p.steps,
                                p.chunk,  p.splits, p.blocks,  p.stages,  p.smem,
                                p.box[0], p.box[1], p.box[2],  p.box[3]};
  for (int i = 0; i < kGemmPlanInts; ++i) out[i] = v[i];
}

}  // namespace

extern "C" {

// Bytes of the workspace of the forward (bwd = 0) or the backward (bwd = 1).
long long rdm_attn_tiled_workspace(int B, int C, int L, int G, int bwd) {
  Carve w{nullptr};
  if (bwd) carve_bwd(w, B, C, L, G);
  else carve_fwd(w, B, C, L, G);
  return w.used;
}

// The launch plan at (B, C, L): plan[0] the kernel launches of the forward
// and plan[1] of the backward (split-K sums included); the forward attention
// kernel's shared-memory bytes (plan[2]), its grid's x (query tiles of 128,
// plan[4]), the key tiles of 64 it is built for (plan[5]) and its threads
// (plan[6]); the backward's ds kernel's shared memory (plan[3]), query tiles
// of 64 (plan[7]) and key tiles of 16 (plan[8]); the padded tokens
// (plan[9]); the weight gradients' K chunk (plan[10]) and its number
// (plan[11]); then the q/k/v product's and the output product's plans, 14
// ints each (as rdm_resblock_tiled_plan's): 40 ints.
int rdm_attn_tiled_plan(int B, int C, int L, int G, int* plan) {
  if (!shape_ok(B, C, L, G)) return static_cast<int>(cudaErrorInvalidValue);
  Carve w{nullptr};
  const BwdBuffers d = carve_bwd(w, B, C, L, G);
  const FwdPlans pl = fwd_plans(B, C, L);
  const int qkv = pl.p[0].splits > 1 ? 2 : 1, proj = pl.p[1].splits > 1 ? 2 : 1;
  const int v[12] = {2 + qkv + proj, 2 + qkv + 13, fwd_smem_bytes(fwd_key_tiles_max(L)),
                     attn_smem_bytes(C, L, 2), (L + kFwdRows - 1) / kFwdRows,
                     fwd_key_tiles_max(L), kFwdThreads, (L + kQRows - 1) / kQRows,
                     key_tiles_max(L), padded_tokens(L), d.chunk, d.splits};
  for (int i = 0; i < 12; ++i) plan[i] = v[i];
  put_plan(pl.p[0], plan + 12);
  put_plan(pl.p[1], plan + 12 + kGemmPlanInts);
  return 0;
}

// x, out: (B, C, H, W) bf16 NCHW with L = H W.  gamma, beta, bqkv (3C), bp:
// bf16; wqkv_t (3C, C) = [Wq | Wk | Wv]^T, wp_t (C, C) = Wp^T.  rescale is
// T(rescale).  launch_ms: null, or 4 floats that receive the ms of the
// GroupNorm, the q/k/v product, the attention kernel and the output product
// (CUDA events; the call then waits for them).  Returns a cudaError_t.
int rdm_attn_tiled_fwd(const void* x, void* out, const void* gamma, const void* beta,
                       const void* wqkv_t, const void* bqkv, const void* wp_t, const void* bp,
                       void* workspace, int B, int C, int L, int G, float eps, float scale,
                       float rescale, void* stream, float* launch_ms) {
  if (!shape_ok(B, C, L, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Carve w{static_cast<char*>(workspace)};
  const FwdBuffers f = carve_fwd(w, B, C, L, G);
  const bf16* xb = static_cast<const bf16*>(x);
  LaunchClock clock(launch_ms, s);
  cudaError_t err = clock.mark();
  if (err != cudaSuccess ||
      (err = forward_core(xb, static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
                          static_cast<const bf16*>(wqkv_t), static_cast<const bf16*>(bqkv), f, B,
                          C, L, G, eps, scale, s, clock)) != cudaSuccess)
    return static_cast<int>(err);
  WgEpi e{};
  e.kind = kWgResidual;
  e.out = static_cast<bf16*>(out);
  e.bias = static_cast<const bf16*>(bp);
  e.rps = padded_tokens(L);
  e.valid = L;
  e.res = xb;
  e.rescale = rescale;
  if ((err = wg_gemm(f.o, static_cast<const bf16*>(wp_t), 0, B, 0, B * padded_tokens(L), C, C, e,
                     f.partial, s)) != cudaSuccess ||
      (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(clock.finish());
}

// The backward: x, g (B, C, H, W) bf16; dx out (bf16, NCHW); grads (float32)
// receives [dWq | dWk | dWv] with the bias gradients as row C ((C + 1) x 3C),
// then dWp with dbp as row C ((C + 1) x C), then dgamma and dbeta (C each).
// wqkv (C, 3C) = [Wq | Wk | Wv]; wp (C, C) = Wp; the rest as the forward's.
int rdm_attn_tiled_bwd(const void* x, const void* g, void* dx, const void* gamma,
                       const void* beta, const void* wqkv_t, const void* bqkv, const void* wqkv,
                       const void* wp, void* grads, void* workspace, int B, int C, int L, int G,
                       float eps, float scale, float rescale_t, float rescale, void* stream) {
  if (!shape_ok(B, C, L, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Carve w{static_cast<char*>(workspace)};
  const BwdBuffers d = carve_bwd(w, B, C, L, G);
  const FwdBuffers& f = d.f;
  // padded token rows are read by the products over tokens: they must be 0
  cudaError_t err = cudaMemsetAsync(workspace, 0, w.used, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  LaunchClock untimed(nullptr, s);
  if ((err = forward_core(xb, static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
                          static_cast<const bf16*>(wqkv_t), static_cast<const bf16*>(bqkv), f, B,
                          C, L, G, eps, scale, s, untimed)) != cudaSuccess)
    return static_cast<int>(err);
  const int Lp = padded_tokens(L);
  const long long rows = static_cast<long long>(B) * Lp, sb = static_cast<long long>(Lp) * C;
  const long long total = static_cast<long long>(B) * C * L;
  scale_transpose_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      gb, C, L, total, rescale_t, d.gs);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  GemmArgs m{};   // do = T(gs Wp^T)
  m.a = src(d.gs, sb, C, 1, L, kKContig);
  m.b = src(static_cast<const bf16*>(wp), 0, C, 1, C, kKContig);
  m.e = epi_bf16(d.dO, sb, C, nullptr);
  m.M = L, m.N = C, m.K = C;
  if ((err = launch_gemm(m, B, s)) != cudaSuccess) return static_cast<int>(err);
  if ((err = dispatch_ds(f.qkv, d.dO, d.pt, d.ds, B, C, L, scale, s)) != cudaSuccess)
    return static_cast<int>(err);

  const long long spp = static_cast<long long>(Lp) * Lp, sq = 3 * sb;
  GemmArgs dq{};  // dq = T(ds k)
  dq.a = src(d.ds, spp, Lp, 1, L, kKContig);
  dq.b = src(f.qkv + C, sq, 1, 3 * C, C, kRContig);
  dq.e = epi_bf16(d.dqkv, sq, 3 * C, nullptr);
  dq.M = L, dq.N = C, dq.K = Lp;
  if ((err = launch_gemm(dq, B, s)) != cudaSuccess) return static_cast<int>(err);
  GemmArgs dk{};  // dk = T(ds^T q)
  dk.a = src(d.ds, spp, 1, Lp, L, kRContig);
  dk.b = src(f.qkv, sq, 1, 3 * C, C, kRContig);
  dk.e = epi_bf16(d.dqkv + C, sq, 3 * C, nullptr);
  dk.M = L, dk.N = C, dk.K = Lp;
  if ((err = launch_gemm(dk, B, s)) != cudaSuccess) return static_cast<int>(err);
  GemmArgs dv{};  // dv = T(pt^T do)
  dv.a = src(d.pt, spp, 1, Lp, L, kRContig);
  dv.b = src(d.dO, sb, 1, C, C, kRContig);
  dv.e = epi_bf16(d.dqkv + 2 * C, sq, 3 * C, nullptr);
  dv.M = L, dv.N = C, dv.K = Lp;
  if ((err = launch_gemm(dv, B, s)) != cudaSuccess) return static_cast<int>(err);

  GemmArgs dh{};  // dh = [dq | dk | dv] [Wq | Wk | Wv]^T, float32
  dh.a = src(d.dqkv, sq, 3 * C, 1, L, kKContig);
  dh.b = src(static_cast<const bf16*>(wqkv), 0, 3 * C, 1, C, kKContig);
  dh.e = epi_f32(d.dh, sb, C);
  dh.M = L, dh.N = C, dh.K = 3 * C;
  if ((err = launch_gemm(dh, B, s)) != cudaSuccess) return static_cast<int>(err);
  gn_bwd_kernel<<<B * G, kRowThreads, 0, s>>>(d.dh, sb, xb, gb, f.stats,
                                              static_cast<const bf16*>(gamma), C, L, G, rescale,
                                              static_cast<bf16*>(dx), d.gnpart);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  GemmArgs wq{};  // [dWq | dWk | dWv] and their biases (row C), split over token rows
  wq.a = src(f.h, 0, 1, C, C, kRContig);
  wq.a.ones_row = C;
  wq.b = src(d.dqkv, 0, 1, 3 * C, 3 * C, kRContig);
  wq.e = epi_f32(d.part1, static_cast<long long>(C + 1) * 3 * C, 3 * C);
  wq.M = C + 1, wq.N = 3 * C, wq.K = static_cast<int>(rows), wq.kchunk = d.chunk;
  if ((err = launch_gemm(wq, d.splits, s)) != cudaSuccess) return static_cast<int>(err);
  GemmArgs wpg{};  // dWp and dbp (row C)
  wpg.a = src(f.o, 0, 1, C, C, kRContig);
  wpg.a.ones_row = C;
  wpg.b = src(d.gs, 0, 1, C, C, kRContig);
  wpg.e = epi_f32(d.part2, static_cast<long long>(C + 1) * C, C);
  wpg.M = C + 1, wpg.N = C, wpg.K = static_cast<int>(rows), wpg.kchunk = d.chunk;
  if ((err = launch_gemm(wpg, d.splits, s)) != cudaSuccess) return static_cast<int>(err);

  float* out = static_cast<float*>(grads);
  const int n1 = (C + 1) * 3 * C, n2 = (C + 1) * C;
  if ((err = launch_sum(d.part1, n1, d.splits, n1, out, s)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = launch_sum(d.part2, n2, d.splits, n2, out + n1, s)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(launch_sum(d.gnpart, 2 * C, B, 2 * C, out + n1 + n2, s));
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
