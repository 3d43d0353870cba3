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
// dk, dv), so the rounding points are the TPU kernel's.  Every product runs
// on wg_gemm.cuh's TMA-ring wgmma GEMM or inside one of the two attention
// kernels:
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
//           wg_gemm_kernel       out = T(T(x + T(T(o Wp) + bp)) * T(rescale)), NCHW
// backward  the forward's first three launches again (recompute), then
//           scale_transpose      gs = T(T(g) T(rescale)), token-major
//           wg_gemm_kernel       do = T(gs Wp^T)
//           attn_ds_kernel       the scores and the exact softmax again as the
//                                forward's kernel has them (f32 p in registers),
//                                then do and v of the block's rows and every key
//                                resident in shared memory, dp = do v^T on wgmma
//                                64 keys at a time: first each row's sum of
//                                dp * p over every key, then dp again for
//                                ds = T(p (dp - sum) / sqrt C) and pt = T(p),
//                                both written (B, Lp, Lp)
//           wg_gemm_kernel x 3   dq = T(ds k), dk = T(ds^T q), dv = T(pt^T do):
//                                batched per sample, ds, pt, q and do read
//                                MN-major by TMA (no transposed copies)
//           wg_gemm_kernel       dh = [dq | dk | dv] [Wq | Wk | Wv]^T, float32 NCHW
//           gn_bwd_kernel        dx and per-sample partials of dgamma, dbeta
//           wg_gemm_kernel x 2   [dWq | dWk | dWv] = h^T [dq | dk | dv] and
//                                dWp = o^T gs, K over every (sample, 64 tokens),
//                                split in a fixed order, float32 partials with
//                                the bias gradients (the sums of [dq | dk | dv]
//                                and gs over tokens) as their last row
//           grad_sums_kernel     every partial summed in split order, one launch,
//                                so two runs agree bit for bit and no gradient is
//                                rounded to bf16.
// The ds kernel does not fold dk and dv in: with L up to 256 a sample's
// queries take two blocks, and their per-key sums would need a second pass
// over partials; writing ds and pt (16.8 MB at C 256, L 256, B 64) and
// reading them back through TMA costs less than that.  No buffer is cleared:
// every map is bounded at L, so TMA reads the padded tokens as zeros.
//
// Bound on this card at C 256, L 256: about 201 MFLOP a sample forward (13 us
// at B 64 against 989 TFLOP/s, against 5 us for its 16.8 MB), so operations
// bound it; the backward does about 2.8 times the forward's products.
// PERF.md has the times of each launch against these bounds.
#include <cmath>

#include "smem_attr.cuh"
#include "wg_gemm.cuh"

namespace {

constexpr int kMaxTokens = 256;

__host__ __device__ inline int padded_tokens(int L) { return (L + 15) / 16 * 16; }

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
          wg_ss<0, 0>(s[j], wg_desc<0>(st + wg * 8192, k16),
                      wg_desc<0>(st + kFwdRows * 128 + j * 8192, k16));
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
      if (kb < 4 * kt) wg_rs_t(acc, pa[kb], sw128_desc(st + kb * 2048, 1024, 1024));
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

// The ds kernel's shared memory: max(2, C / 64) stages of fwd_qk_stage(KTM)
// bytes (first two q/k stages as the forward's; then chunk c's do rows and v
// keys in stage c, all resident), five barriers, 1024 bytes of alignment.
__host__ __device__ inline int ds_smem_bytes(int ktm, int C) {
  const int chunks = (C + 63) / 64;
  return 1024 + (chunks > 2 ? chunks : 2) * fwd_qk_stage(ktm) + 8 * 8;
}

// grid (ceil(L / 128), B), 288 threads.  qmap, kmap, vmap, dmap: 3-D maps
// (C, L, B) of the token-major q, k, v (rows 3C apart) and do (rows C apart),
// Lp rows a sample, boxes of 64 channels x 64 tokens, zeros past C and past
// L; ds, pt: (B, Lp, Lp) bf16, rows and keys < L written.
//
// The scores and the softmax are the forward kernel's (each consumer
// warpgroup's 64 rows over every key in wgmma accumulators, the exact
// two-pass f32 softmax), p kept in f32 in those registers.  Then do and v
// (the block's 128 rows and every key, all channels: 192 KB at C 256, L 256)
// arrive in the stages the q/k chunks left, and dp = do v^T runs 64 keys at a
// time into one 64 x 64 accumulator: pass 0 sums dp * p over every key of a
// row, pass 1 computes dp again (the registers hold p and one dp tile, not
// two 64 x 256 tiles) and writes ds = T(p (dp - sum) / sqrt C) and pt = T(p).
template <int KTM>
__global__ void __launch_bounds__(kFwdThreads, 1) attn_ds_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap, bf16* ds,
    bf16* pt, int C, int L, float scale) {
  constexpr int kStage = fwd_qk_stage(KTM);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stages = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int Lp = padded_tokens(L), kt = (L + 63) / 64, chunks = (C + 63) / 64;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + (chunks > 2 ? chunks : 2) * kStage);
  uint64_t *qk_full = bars, *qk_empty = bars + 2, *dv_full = bars + 4;
  const int b = blockIdx.y, q0 = blockIdx.x * kFwdRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(qk_full + i, 1);
      mbar_init(qk_empty + i, 8);           // one arrival per consumer warp
    }
    mbar_init(dv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {
    // Producer: q and k chunk by chunk through two stages; once the
    // consumers have read the last of them, do and v whole.
    if (lane == 0) {
      for (int c = 0; c < chunks; ++c) {
        const int slot = c & 1;
        if (c >= 2) mbar_wait(qk_empty + slot, ((c >> 1) - 1) & 1);
        unsigned char* st = stages + slot * kStage;
        mbar_expect_tx(qk_full + slot, kFwdRows * 128 + kt * 8192);
        tma_load_3d(st, &qmap, 64 * c, q0, b, qk_full + slot);
        tma_load_3d(st + 8192, &qmap, 64 * c, q0 + 64, b, qk_full + slot);
        for (int j = 0; j < kt; ++j)
          tma_load_3d(st + kFwdRows * 128 + j * 8192, &kmap, 64 * c, 64 * j, b, qk_full + slot);
      }
      for (int c = chunks > 2 ? chunks - 2 : 0; c < chunks; ++c)
        mbar_wait(qk_empty + (c & 1), (c >> 1) & 1);
      mbar_expect_tx(dv_full, chunks * (kFwdRows * 128 + kt * 8192));
      for (int c = 0; c < chunks; ++c) {
        unsigned char* st = stages + c * kStage;
        tma_load_3d(st, &dmap, 64 * c, q0, b, dv_full);
        tma_load_3d(st + 8192, &dmap, 64 * c, q0 + 64, b, dv_full);
        for (int j = 0; j < kt; ++j)
          tma_load_3d(st + kFwdRows * 128 + j * 8192, &vmap, 64 * c, 64 * j, b, dv_full);
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
    const unsigned char* st = stages + slot * kStage;
#pragma unroll
    for (int k16 = 0; k16 < 4; ++k16)
#pragma unroll
      for (int j = 0; j < KTM; ++j)
        if (j < kt)
          wg_ss<0, 0>(s[j], wg_desc<0>(st + wg * 8192, k16),
                      wg_desc<0>(st + kFwdRows * 128 + j * 8192, k16));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int j = 0; j < KTM; ++j) wg_fence_acc(s[j]);
    if (lane == 0) mbar_arrive(qk_empty + slot);
  }

  // The exact f32 softmax of each row over every key (keys at or past L
  // masked), as the forward kernel computes it: p = exp(s - max) / sum in f32.
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
#pragma unroll
  for (int j = 0; j < KTM; ++j)
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][t][e] = s[j][t][e] / sum[e >> 1];

  // dp = do v^T, 64 keys at a time: pass 0 each row's sum of dp * p, pass 1
  // ds and pt.  Stage c holds do's chunk c (the block's 128 rows) and v's.
  mbar_wait(dv_full, 0);
  const int row0 = q0 + 64 * wg + 16 * (warp & 3) + (lane >> 2);
  const long long sample = static_cast<long long>(b) * Lp;
  float dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < KTM; ++j) {
      if (j < kt) {
        float acc[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
        wg_fence_acc(acc);
        __syncwarp();
        wg_fence();
        for (int c = 0; c < chunks; ++c) {
          const unsigned char* st = stages + c * kStage;
#pragma unroll
          for (int k16 = 0; k16 < 4; ++k16)
            wg_ss<0, 0>(acc, wg_desc<0>(st + wg * 8192, k16),
                        wg_desc<0>(st + kFwdRows * 128 + j * 8192, k16));
        }
        wg_commit();
        wg_wait<0>();
        wg_fence_acc(acc);
        if (pass == 0) {
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) dsum[e >> 1] += acc[t][e] * s[j][t][e];
        } else {
#pragma unroll
          for (int t = 0; t < 8; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + 8 * h, key = 64 * j + 8 * t + 2 * (lane & 3);
              if (row < L && key < L) {
                const float p0 = s[j][t][2 * h], p1 = s[j][t][2 * h + 1];
                const float d0 = __fmul_rn(__fmul_rn(p0, __fsub_rn(acc[t][2 * h], dsum[h])), scale);
                const float d1 =
                    __fmul_rn(__fmul_rn(p1, __fsub_rn(acc[t][2 * h + 1], dsum[h])), scale);
                const long long at = (sample + row) * Lp + key;
                *reinterpret_cast<unsigned*>(ds + at) = pack_bf16(d0, d1);
                *reinterpret_cast<unsigned*>(pt + at) = pack_bf16(p0, p1);
              }
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
// with Lp rows a sample: a block takes a 32 x 32 tile (channels x tokens) of
// one sample, read along l and written along c through shared memory.  grid
// (ceil(L / 32), C / 32, B), 256 threads.
__global__ void __launch_bounds__(256) scale_transpose_kernel(const bf16* g, int C, int L,
                                                              float rescale, bf16* gs) {
  __shared__ bf16 tile[32][34];
  const int b = blockIdx.z, c0 = blockIdx.y * 32, l0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const bf16* src = g + static_cast<long long>(b) * C * L;
  for (int i = ty; i < 32; i += 8)
    if (l0 + tx < L)
      tile[i][tx] =
          __float2bfloat16(bf(src[static_cast<long long>(c0 + i) * L + l0 + tx]) * rescale);
  __syncthreads();
  bf16* dst = gs + static_cast<long long>(b) * padded_tokens(L) * C;
  for (int i = ty; i < 32; i += 8)
    if (l0 + i < L) dst[static_cast<long long>(l0 + i) * C + c0 + tx] = tile[tx][i];
}

// The parameter gradients: out[i] = sum over s < S of in[s n + i], in order of
// s, for the three runs of partials one after the other (the q/k/v and the
// output product's weights with their bias rows, GroupNorm's per-sample
// dgamma and dbeta).
struct GradSums {
  const float* in[3];
  int splits[3], n[3];
};

__global__ void grad_sums_kernel(const GradSums a, float* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  for (int r = 0; r < 3; ++r) {
    if (i < a.n[r]) {
      float t = 0.f;
      for (int s = 0; s < a.splits[r]; ++s) t += a.in[r][static_cast<long long>(s) * a.n[r] + i];
      out[i] = t;
      return;
    }
    i -= a.n[r];
    out += a.n[r];
  }
}

// q, k or v of [q | k | v] (col 0, C or 2C), or do (ld C): a 3-D map (C, L,
// B) with Lp rows a sample, boxes of 64 channels x 64 tokens.
bool token_map(CUtensorMap* map, const bf16* p, int ld, int B, int C, int L) {
  return wg_rows_map(map, p, C, ld, L, padded_tokens(L), B, 64);
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
cudaError_t attn_ds(const CUtensorMap (&maps)[4], bf16* ds, bf16* pt, int B, int C, int L,
                    float scale, cudaStream_t s) {
  static SmemAttr attr;   // set once a card: the most any width takes
  cudaError_t err = attr.apply(reinterpret_cast<const void*>(attn_ds_kernel<KTM>),
                               ds_smem_bytes(KTM, 256));
  if (err != cudaSuccess) return err;
  attn_ds_kernel<KTM><<<dim3((L + kFwdRows - 1) / kFwdRows, B), kFwdThreads,
                        ds_smem_bytes(KTM, C), s>>>(maps[0], maps[1], maps[2], maps[3], ds, pt,
                                                    C, L, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_fwd(const bf16* qkv, bf16* o, int B, int C, int L, float scale,
                         cudaStream_t s) {
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i)
    if (!token_map(&maps[i], qkv + i * C, 3 * C, B, C, L)) return cudaErrorInvalidValue;
  switch (fwd_key_tiles_max(L)) {
    case 1: return attn_fwd<1>(maps, o, B, C, L, scale, s);
    case 2: return attn_fwd<2>(maps, o, B, C, L, scale, s);
    default: return attn_fwd<4>(maps, o, B, C, L, scale, s);
  }
}

cudaError_t dispatch_ds(const bf16* qkv, const bf16* dO, bf16* ds, bf16* pt, int B, int C, int L,
                        float scale, cudaStream_t s) {
  CUtensorMap maps[4];
  for (int i = 0; i < 3; ++i)
    if (!token_map(&maps[i], qkv + i * C, 3 * C, B, C, L)) return cudaErrorInvalidValue;
  if (!token_map(&maps[3], dO, C, B, C, L)) return cudaErrorInvalidValue;
  switch (fwd_key_tiles_max(L)) {
    case 1: return attn_ds<1>(maps, ds, pt, B, C, L, scale, s);
    case 2: return attn_ds<2>(maps, ds, pt, B, C, L, scale, s);
    default: return attn_ds<4>(maps, ds, pt, B, C, L, scale, s);
  }
}

bool shape_ok(int B, int C, int L, int G) {
  return B >= 1 && (C == 32 || C == 64 || C == 128 || C == 256) && L >= 1 && L <= kMaxTokens &&
         G >= 1 && G <= 32 && C % G == 0;
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

// The backward's products on wg_gemm, in launch order: do, dq, dk, dv (per
// sample), dh over all B Lp token rows, none of them split; the weight
// gradients with K over every (sample, 64 tokens), split in at most
// kGradSplits, float32 partials with the bias row.
enum { kDo, kDq, kDk, kDv, kDh, kDWqkv, kDWp, kBwdProducts };
constexpr int kGradSplits = 64;

struct BwdPlans {
  WgArgs g[kBwdProducts];
  WgPlan p[kBwdProducts];
};

BwdPlans bwd_plans(int B, int C, int L) {
  BwdPlans r{};
  const int rows = B * padded_tokens(L), kt = (L + 63) / 64, mtps = (L + kWgBM - 1) / kWgBM;
  const int kc = (C + 63) / 64, k3c = (3 * C + 63) / 64;
  r.p[kDo] = wg_plan_rows(r.g[kDo], rows, C, kc, kc, 0, 1, 0, 1);
  r.p[kDq] = wg_plan_rows(r.g[kDq], rows, C, kt, kt, mtps, B, 0, 1);
  r.p[kDk] = wg_plan_rows(r.g[kDk], rows, C, kt, kt, mtps, B, 1, 1);
  r.p[kDv] = wg_plan_rows(r.g[kDv], rows, C, kt, kt, mtps, B, 1, 1);
  r.p[kDh] = wg_plan_rows(r.g[kDh], rows, C, k3c, k3c, 0, 1, 0, 1);
  r.p[kDWqkv] = wg_plan_rows(r.g[kDWqkv], C, 3 * C, B * kt, kt, 0, 1, 1, kGradSplits);
  r.p[kDWp] = wg_plan_rows(r.g[kDWp], C, C, B * kt, kt, 0, 1, 1, kGradSplits);
  r.g[kDWqkv].colsum = r.g[kDWp].colsum = 1;
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
  float *dh, *gnpart, *part1, *part2;   // dh: float32 NCHW
};

BwdBuffers carve_bwd(Carve& w, int B, int C, int L, int G) {
  const int Lp = padded_tokens(L);
  const long long rows = static_cast<long long>(B) * Lp;
  const BwdPlans pl = bwd_plans(B, C, L);
  BwdBuffers d;
  d.f = carve_fwd(w, B, C, L, G);
  d.gs = w.take<bf16>(rows * C);
  d.dO = w.take<bf16>(rows * C);
  d.pt = w.take<bf16>(rows * Lp);
  d.ds = w.take<bf16>(rows * Lp);
  d.dqkv = w.take<bf16>(rows * 3 * C);
  d.dh = w.take<float>(rows * C);
  d.gnpart = w.take<float>(2LL * B * C);
  d.part1 = w.take<float>(wg_partial_floats(pl.p[kDWqkv], C, 3 * C, 1, 1));
  d.part2 = w.take<float>(wg_partial_floats(pl.p[kDWp], C, C, 1, 1));
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

// Product i of the backward's plans on maps a and b with epilogue e.
template <int KIND, int TA, int TB>
cudaError_t bwd_product(const BwdPlans& pl, int i, const CUtensorMap& a, const CUtensorMap& b,
                        const WgEpi& e, float* partial, cudaStream_t s) {
  WgArgs g = pl.g[i];
  g.e = e;
  g.partial = partial;
  return wg_gemm_maps<KIND, TA, TB>(a, b, g, pl.p[i], s);
}

// The epilogue of a product over B Lp token rows (tokens < L written): bf16
// rows of ld values at out, or float32 NCHW at outf.
WgEpi rows_epi(bf16* out, float* outf, long long ld, int Lp, int L) {
  WgEpi e{};
  e.kind = out != nullptr ? kWgRow : kWgF32;
  e.out = out;
  e.outf = outf;
  e.ld = ld;
  e.rps = Lp;
  e.valid = L;
  return e;
}

constexpr int kGemmPlanInts = 14;   // WgPlan's ten fields and its box
constexpr int kPlanHead = 8;        // the plan's own fields before the products'

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
// and plan[1] of the backward (split-K sums included); the shared-memory
// bytes of the forward attention kernel (plan[2]) and of the ds kernel
// (plan[3]); both kernels' grid x (query tiles of 128, plan[4]), the key
// tiles of 64 they are built for (plan[5]) and their threads (plan[6]); the
// padded tokens (plan[7]); then the products' plans, 14 ints each (as
// rdm_resblock_tiled_plan's): q/k/v and output (forward), do, dq, dk, dv,
// dh, the q/k/v and the output weight gradients (backward): 134 ints.
int rdm_attn_tiled_plan(int B, int C, int L, int G, int* plan) {
  if (!shape_ok(B, C, L, G)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdPlans fp = fwd_plans(B, C, L);
  const BwdPlans bp = bwd_plans(B, C, L);
  const int qkv = fp.p[0].splits > 1 ? 1 : 0, proj = fp.p[1].splits > 1 ? 1 : 0;
  const int ktm = fwd_key_tiles_max(L);
  const int v[kPlanHead] = {4 + qkv + proj, 14 + qkv,         fwd_smem_bytes(ktm),
                            ds_smem_bytes(ktm, C), (L + kFwdRows - 1) / kFwdRows, ktm,
                            kFwdThreads,       padded_tokens(L)};
  for (int i = 0; i < kPlanHead; ++i) plan[i] = v[i];
  put_plan(fp.p[0], plan + kPlanHead);
  put_plan(fp.p[1], plan + kPlanHead + kGemmPlanInts);
  for (int i = 0; i < kBwdProducts; ++i)
    put_plan(bp.p[i], plan + kPlanHead + (2 + i) * kGemmPlanInts);
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
// then dWp with dbp as row C ((C + 1) x C), then dgamma and dbeta (C each),
// every element written.  wqkv (C, 3C) = [Wq | Wk | Wv]; wp (C, C) = Wp; the
// rest as the forward's.  launch_ms: null, or 12 floats that receive the ms
// of the recompute (the forward's first three launches), gs, do, ds, dq, dk,
// dv, dh, GroupNorm's backward, the two weight products and the sums.
int rdm_attn_tiled_bwd(const void* x, const void* g, void* dx, const void* gamma,
                       const void* beta, const void* wqkv_t, const void* bqkv, const void* wqkv,
                       const void* wp, void* grads, void* workspace, int B, int C, int L, int G,
                       float eps, float scale, float rescale_t, float rescale, void* stream,
                       float* launch_ms) {
  if (!shape_ok(B, C, L, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Carve w{static_cast<char*>(workspace)};
  const BwdBuffers d = carve_bwd(w, B, C, L, G);
  const FwdBuffers& f = d.f;
  const BwdPlans pl = bwd_plans(B, C, L);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const int Lp = padded_tokens(L), rows = B * Lp;
  LaunchClock clock(launch_ms, s), untimed(nullptr, s);
  cudaError_t err = clock.mark();
  if (err != cudaSuccess ||
      (err = forward_core(xb, static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
                          static_cast<const bf16*>(wqkv_t), static_cast<const bf16*>(bqkv), f, B,
                          C, L, G, eps, scale, s, untimed)) != cudaSuccess ||
      (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);
  scale_transpose_kernel<<<dim3((L + 31) / 32, C / 32, B), 256, 0, s>>>(gb, C, L, rescale_t, d.gs);
  if ((err = cudaGetLastError()) != cudaSuccess || (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);

  // every operand as TMA reads it: token-major rows (K-major), or one
  // sample's tokens as the K rows of an MN-major box, bounded at L
  CUtensorMap gs_rows, wp_w, ds_k, k_mn, ds_mn, q_mn, pt_mn, do_mn, dqkv_rows, wqkv_w, h_mn,
      dqkv_mn, o_mn, gs_mn;
  const bool ok =
      wg_rows_map(&gs_rows, d.gs, C, C, rows, rows, 1, kWgBM) &&
      wg_weight_map(&wp_w, static_cast<const bf16*>(wp), C, C, 1, pl.p[kDo].bn) &&
      wg_rows_map(&ds_k, d.ds, L, Lp, L, Lp, B, kWgBM) &&
      token_map(&k_mn, f.qkv + C, 3 * C, B, C, L) &&
      wg_rows_map(&ds_mn, d.ds, L, Lp, L, Lp, B, 64) && token_map(&q_mn, f.qkv, 3 * C, B, C, L) &&
      wg_rows_map(&pt_mn, d.pt, L, Lp, L, Lp, B, 64) && token_map(&do_mn, d.dO, C, B, C, L) &&
      wg_rows_map(&dqkv_rows, d.dqkv, 3 * C, 3 * C, rows, rows, 1, kWgBM) &&
      wg_weight_map(&wqkv_w, static_cast<const bf16*>(wqkv), C, 3 * C, 1, pl.p[kDh].bn) &&
      token_map(&h_mn, f.h, C, B, C, L) && token_map(&dqkv_mn, d.dqkv, 3 * C, B, 3 * C, L) &&
      token_map(&o_mn, f.o, C, B, C, L) && token_map(&gs_mn, d.gs, C, B, C, L);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);

  // do = T(gs Wp^T); ds and pt; dq = T(ds k), dk = T(ds^T q), dv = T(pt^T do)
  if ((err = bwd_product<kWgRow, 0, 0>(pl, kDo, gs_rows, wp_w, rows_epi(d.dO, nullptr, C, Lp, L),
                                       nullptr, s)) != cudaSuccess ||
      (err = clock.mark()) != cudaSuccess ||
      (err = dispatch_ds(f.qkv, d.dO, d.ds, d.pt, B, C, L, scale, s)) != cudaSuccess ||
      (err = clock.mark()) != cudaSuccess ||
      (err = bwd_product<kWgRow, 0, 1>(pl, kDq, ds_k, k_mn,
                                       rows_epi(d.dqkv, nullptr, 3 * C, Lp, L), nullptr, s)) !=
          cudaSuccess ||
      (err = clock.mark()) != cudaSuccess ||
      (err = bwd_product<kWgRow, 1, 1>(pl, kDk, ds_mn, q_mn,
                                       rows_epi(d.dqkv + C, nullptr, 3 * C, Lp, L), nullptr, s)) !=
          cudaSuccess ||
      (err = clock.mark()) != cudaSuccess ||
      (err = bwd_product<kWgRow, 1, 1>(pl, kDv, pt_mn, do_mn,
                                       rows_epi(d.dqkv + 2 * C, nullptr, 3 * C, Lp, L), nullptr,
                                       s)) != cudaSuccess ||
      (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);

  // dh = [dq | dk | dv] [Wq | Wk | Wv]^T in float32 NCHW, then GroupNorm's
  // backward (reading dh, x and g along the tokens)
  if ((err = bwd_product<kWgF32, 0, 0>(pl, kDh, dqkv_rows, wqkv_w,
                                       rows_epi(nullptr, d.dh, C, Lp, L), nullptr, s)) !=
          cudaSuccess ||
      (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);
  gn_bwd_kernel<<<B * G, kRowThreads, 0, s>>>(d.dh, static_cast<long long>(C) * L, xb, gb,
                                              f.stats, static_cast<const bf16*>(gamma), C, L, G,
                                              rescale, static_cast<bf16*>(dx), d.gnpart);
  if ((err = cudaGetLastError()) != cudaSuccess || (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);

  // the weight gradients and (row C) the bias gradients as split partials
  WgEpi pe{};
  pe.kind = kWgPartial;
  pe.rps = pe.valid = 1;
  if ((err = bwd_product<kWgPartial, 1, 1>(pl, kDWqkv, h_mn, dqkv_mn, pe, d.part1, s)) !=
          cudaSuccess ||
      (err = clock.mark()) != cudaSuccess ||
      (err = bwd_product<kWgPartial, 1, 1>(pl, kDWp, o_mn, gs_mn, pe, d.part2, s)) !=
          cudaSuccess ||
      (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);
  GradSums sums{{d.part1, d.part2, d.gnpart},
                {pl.p[kDWqkv].splits, pl.p[kDWp].splits, B},
                {(C + 1) * 3 * C, (C + 1) * C, 2 * C}};
  const int total = sums.n[0] + sums.n[1] + sums.n[2];
  grad_sums_kernel<<<(total + 255) / 256, 256, 0, s>>>(sums, static_cast<float*>(grads));
  if ((err = cudaGetLastError()) != cudaSuccess || (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(clock.finish());
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
