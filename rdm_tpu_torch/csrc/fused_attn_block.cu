// Fused NCSN++ attention block (AttnBlockpp forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel rdm_tpu/ops/pallas/attention.py::_fused_block_kernel.
// For one sample it computes
//   h   = GroupNorm(x)                      (f32 statistics, var = E[x^2] - mean^2)
//   q,k,v = h Wq + bq, h Wk + bk, h Wv + bv (f32 accumulation)
//   p   = softmax(q k^T / sqrt(C))          (f32)
//   o   = p v
//   out = (x + (o Wp + bp)) * rescale
// with the rounding points of the TPU kernel: h, each NIN result (before its
// bias is added in the working type), p and o are rounded to the working
// type T (float or bfloat16), and the residual is formed in T.
//
// Bound on this card: at the sampling shape (B = 1024, L = 81, C = 64, bf16)
// the block reads and writes 1024*81*64*2 bytes each way (21.2 MB) and does
// about 4.4 GFLOP, so memory bounds it at about 6.3 us against 4.5 us of
// tensor-core time.  Both bodies keep every intermediate out of device
// memory, so it sees one read of x, one write of out and the weights.
//
// bfloat16, C = 64, L <= 96 (fused_attn_block_tc_kernel): one persistent
// block per SM stages the four C x C weights once, transposed into
// ldmatrix-ready panels (output channel rows, 16-byte chunks swizzled), and
// walks the samples blockIdx.x, + gridDim.x, ...  Each of two groups of warps
// loads its samples' NCHW slabs (C x L, contiguous) with 1-D TMA bulk copies
// into two stages of its own, one sample ahead, so one sample's load hides
// behind another's compute.
// A group is one warp per 16 token rows.  Its warps take the GroupNorm
// statistics from the slab, then each builds its 16 rows of h as mma A
// fragments straight from the slab, runs the q, k and v NINs on
// mma.sync.m16n8k16 (f32 sums, rounded before the bias), stages k and v for
// the group and its own q rows in bf16, swizzled as attn_mma.cuh wants them,
// and runs attn_rows16 (scores and probabilities in registers, -inf on padded
// keys).  o, rounded once, is the A operand of the output NIN straight from
// the registers (the accumulator and A layouts coincide); the residual is
// formed in bf16 into the group's output slab, the x stage is released, and
// the slab goes back to device memory with one bulk store, whose read of
// shared memory is waited for only a sample later.
//
// Every other shape and float32 (fused_attn_block_kernel, the earlier body):
// one thread block of 256 threads per sample (the grid is B, so a ragged
// batch needs no padding).  Shared memory holds, in f32: k transposed
// (C x LP), v (L x C), a chunk of score rows (R x LP), h (later o;
// L x (C + 1)) and a chunk of q rows (R x (C + 1)).  Query rows are processed
// in chunks of R rows so that C = 128 with L = 128 still fits in 227 KB.
// Every product is a plain f32 FMA loop over a 4 x 8 register tile per
// thread; the NIN weights are read from global memory (L1/L2).  TF32 would
// break the float32 tolerance (1e-4).
#include "attn_common.cuh"
#include "attn_mma.cuh"
#include "tma.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int kSmemLimit = 232448;

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
fused_attn_block_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const T* __restrict__ gamma, const T* __restrict__ beta,
                        const T* __restrict__ wq, const T* __restrict__ bq,
                        const T* __restrict__ wk, const T* __restrict__ bk,
                        const T* __restrict__ wv, const T* __restrict__ bv,
                        const T* __restrict__ wp, const T* __restrict__ bp,
                        int L, int groups, int R, float eps, float scale, float rescale) {
  constexpr int CP = C + 1;          // odd row stride of h and q: no bank conflicts
  const int LP = (L + TN - 1) / TN * TN;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                  // C x LP: k transposed, later (o Wp + bp) transposed
  float* vb = kt + C * LP;           // L x C : v
  float* sb = vb + L * C;            // R x LP: scores, then probabilities
  float* hb = sb + R * LP;           // L x CP: h, then o
  float* qb = hb + L * CP;           // R x CP: a chunk of q rows
  __shared__ float s_mu[C];
  __shared__ float s_inv[C];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* xb = x + static_cast<size_t>(blockIdx.x) * C * L;
  T* ob = out + static_cast<size_t>(blockIdx.x) * C * L;

  // 1. Group statistics.  A group is cg consecutive channels, i.e. a
  //    contiguous run of cg * L values of the NCHW slab.
  const int cg = C / groups;
  const int gsize = cg * L;
  const float inv_n = 1.0f / static_cast<float>(gsize);
  for (int g = warp; g < groups; g += kWarps) {
    const T* xg = xb + static_cast<size_t>(g) * gsize;
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < gsize; i += 32) {
      const float v = to_f<T>(xg[i]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mu = s1 * inv_n;
      const float var = s2 * inv_n - mu * mu;
      s_mu[g] = mu;
      s_inv[g] = 1.0f / sqrtf(var + eps);
    }
  }
  __syncthreads();

  // 2. h = GroupNorm(x), rounded to T, stored token-major.
  for (int i = tid; i < C * L; i += kThreads) {
    const int c = i / L;
    const int l = i - c * L;
    const int g = c / cg;
    const float hn = (to_f<T>(xb[i]) - s_mu[g]) * s_inv[g];
    hb[l * CP + c] = rnd<T>(hn * to_f<T>(gamma[c]) + to_f<T>(beta[c]));
  }
  __syncthreads();

  // NIN: T(T(sum_c src[i][c] W[c][j]) + b[j]).
  auto h_row = [=](int i, int k) { return hb[i * CP + k]; };
  auto w_row = [](const T* W) {
    return [=](int k, int j0, float* vals) { load8_global<T>(W + k * C + j0, vals); };
  };

  // 3. k (stored transposed) and v for all rows.
  tile_product(L, C, C, h_row, w_row(wk), [=](int i, int j, float acc) {
    kt[j * LP + i] = rnd<T>(rnd<T>(acc) + to_f<T>(bk[j]));
  });
  tile_product(L, C, C, h_row, w_row(wv), [=](int i, int j, float acc) {
    vb[i * C + j] = rnd<T>(rnd<T>(acc) + to_f<T>(bv[j]));
  });
  __syncthreads();

  // 4. Attention, R query rows at a time.  Row r of h is dead once q row r
  //    exists, so o overwrites h chunk by chunk.
  for (int r0 = 0; r0 < L; r0 += R) {
    const int nr = min(R, L - r0);
    const float* hc = hb + r0 * CP;
    tile_product(nr, C, C, [=](int i, int k) { return hc[i * CP + k]; }, w_row(wq),
                 [=](int i, int j, float acc) {
                   qb[i * CP + j] = rnd<T>(rnd<T>(acc) + to_f<T>(bq[j]));
                 });
    __syncthreads();

    tile_product(nr, L, C, [=](int i, int k) { return qb[i * CP + k]; },
                 [=](int k, int j0, float* vals) { load8_shared(kt + k * LP + j0, vals); },
                 [=](int i, int j, float acc) { sb[i * LP + j] = acc * scale; });
    __syncthreads();

    softmax_rows<T>(sb, nr, L, LP);
    __syncthreads();

    float* oc = hb + r0 * CP;
    tile_product(nr, C, L, [=](int i, int k) { return sb[i * LP + k]; },
                 [=](int k, int j0, float* vals) { load8_shared(vb + k * C + j0, vals); },
                 [=](int i, int j, float acc) { oc[i * CP + j] = rnd<T>(acc); });
    __syncthreads();
  }

  // 5. Output projection, stored transposed into the dead k buffer.
  tile_product(L, C, C, h_row, w_row(wp), [=](int i, int j, float acc) {
    kt[j * LP + i] = rnd<T>(rnd<T>(acc) + to_f<T>(bp[j]));
  });
  __syncthreads();

  // 6. Residual in T, written back as NCHW.
  const float rs = rnd<T>(rescale);
  for (int i = tid; i < C * L; i += kThreads) {
    const int c = i / L;
    const int l = i - c * L;
    const float s = rnd<T>(to_f<T>(xb[i]) + kt[c * LP + l]);
    ob[i] = from_f<T>(s * rs);
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, void* out, const void* const* p, int B, int L,
                   int groups, int R, float eps, float scale, float rescale,
                   cudaStream_t stream) {
  const size_t LP = (L + TN - 1) / TN * TN;
  const size_t smem = sizeof(float) * (C * LP + static_cast<size_t>(L) * C + R * LP
                                       + static_cast<size_t>(L) * (C + 1)
                                       + static_cast<size_t>(R) * (C + 1));
  auto kern = fused_attn_block_kernel<T, C>;
  // The most any shape may take beside the static statistics
  // (ops/attention.py: rows_per_chunk keeps each within it), set once per
  // instantiation and card.
  constexpr int limit = kSmemLimit - 2 * C * static_cast<int>(sizeof(float));
  static SmemAttr smem_attr;
  const cudaError_t attr = smem_attr.apply(reinterpret_cast<const void*>(kern), limit);
  if (attr != cudaSuccess) return attr;
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  kern<<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
      static_cast<const T*>(p[8]), static_cast<const T*>(p[9]),
      L, groups, R, eps, scale, rescale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16, C = 64: tensor cores, weights staged once per block, a TMA ring

using bf16 = __nv_bfloat16;

constexpr int kTcC = 64;             // channels of the tensor-core body
constexpr int kTcGroups = 2;         // groups of warps a block, each taking every other sample
constexpr int kTcStagesPerGroup = 2; // slab stages each group owns

// Bytes of one staged slab (C x L bf16, rounded up to 128) and the block's
// shared memory: barriers, the four weight panels, six parameter vectors in
// f32, and per group its k, v and q panels (16 NT rows each), its output
// slab and GroupNorm statistics, then the ring.
__host__ __device__ constexpr int tc_slab_bytes(int L) { return (kTcC * L * 2 + 127) / 128 * 128; }
__host__ __device__ constexpr int tc_group_bytes(int NT, int L) {
  return 3 * 16 * NT * kTcC * 2 + tc_slab_bytes(L) + 2 * kTcC * 4;
}
__host__ __device__ constexpr int tc_smem_bytes(int NT, int L) {
  return 128 + 4 * kTcC * kTcC * 2 + 6 * kTcC * 4 + kTcGroups * tc_group_bytes(NT, L)
         + kTcGroups * kTcStagesPerGroup * tc_slab_bytes(L);
}

// acc (16 rows x 64 channels) = A (16 x 64: four 16-deep fragments) W, with
// W^T staged as a panel of 64 output-channel rows of 64 values (chunk j of
// row n at slot j ^ (n % 8)), so plain ldmatrix gives the B fragments.
__device__ __forceinline__ void nin16(float (&acc)[8][4], const unsigned (&a)[4][4],
                                      const bf16* panel, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned b[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 16 * j + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(b[j], panel + n * 64 + ((2 * kk + ((lane >> 3) & 1)) ^ (n & 7)) * 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mma_bf16(acc[2 * j], a[kk], b[j][0], b[j][1]);
      mma_bf16(acc[2 * j + 1], a[kk], b[j][2], b[j][3]);
    }
  }
}

// Round the warp's NIN result before its bias, add the bias in bf16 and
// stage rows r0 .. r0 + 15 in a panel laid out as attn_mma.cuh reads it.
template <int NT>
__device__ __forceinline__ void stage_rows(const float (&acc)[8][4], const float* bias,
                                           bf16* panel, int r0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = 8 * n + 2 * tq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + g + 8 * hf;
      *reinterpret_cast<unsigned*>(panel + swizzled_chunk<16 * NT>(r, n) + 2 * tq) =
          pack_bf16(rnd_bf16(acc[n][2 * hf]) + bias[c], rnd_bf16(acc[n][2 * hf + 1]) + bias[c + 1]);
    }
  }
}

// Block b takes samples b, b + gridDim.x, ...; its i-th sample goes to group
// i % kTcGroups, as that group's m-th, into stage m % kTcStagesPerGroup of
// the group's own stages.  A group loads its own samples: its leader (warp
// 0, lane 0) fills both stages at the start and refills a stage with the
// group's sample kTcStagesPerGroup ahead as soon as every warp of the group
// is done with the stage, so the block needs no producer warp (and with 12
// warps each may hold 168 registers).  Warp w of a group owns token rows
// 16 w .. 16 w + 15 (rows past L are padding: h = 0 there, so k and v stay
// finite, and attn_rows16 masks those keys).
template <int NT>
__global__ void __launch_bounds__(32 * kTcGroups * NT, 1)
fused_attn_block_tc_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                           const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                           const bf16* __restrict__ wq, const bf16* __restrict__ bq,
                           const bf16* __restrict__ wk, const bf16* __restrict__ bk,
                           const bf16* __restrict__ wv, const bf16* __restrict__ bv,
                           const bf16* __restrict__ wp, const bf16* __restrict__ bp, int B,
                           int L, int groups, float eps, float scale, float rescale) {
  constexpr int C = kTcC, ROWS = 16 * NT, SPG = kTcStagesPerGroup;
  constexpr int STAGES = kTcGroups * SPG;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_tc);
  bf16* wsm = reinterpret_cast<bf16*>(smem_tc + 128);         // Wq, Wk, Wv, Wp panels
  float* prm = reinterpret_cast<float*>(wsm + 4 * C * C);  // gamma, beta, bq, bk, bv, bp
  unsigned char* gmem = reinterpret_cast<unsigned char*>(prm + 6 * C);
  unsigned char* ring = gmem + kTcGroups * tc_group_bytes(NT, L);
  const int slab = C * L;
  const int slab_bytes = slab * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
  }
  // The weights, once: W (C_in x C_out, row-major) into panels of W^T, eight
  // output channels (one 16-byte load) an item, every load of a thread in
  // flight before its stores.
  {
    constexpr int kItems = 4 * C * C / 8, kThreadsAll = 32 * kTcGroups * NT;
    constexpr int kPer = (kItems + kThreadsAll - 1) / kThreadsAll;
    uint4 u[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreadsAll, t = i / (C * C / 8);
      const bf16* src = t == 0 ? wq : t == 1 ? wk : t == 2 ? wv : wp;
      if (i < kItems) u[j] = __ldg(reinterpret_cast<const uint4*>(src) + (i - t * (C * C / 8)));
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreadsAll, t = i / (C * C / 8);
      const int r = i - t * (C * C / 8), c = r / (C / 8), n0 = (r % (C / 8)) * 8;
      const bf16* v = reinterpret_cast<const bf16*>(&u[j]);
      if (i < kItems)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wsm[t * C * C + (n0 + e) * 64 + (((c >> 3) ^ (n0 + e)) & 7) * 8 + (c & 7)] = v[e];
    }
  }
  for (int i = threadIdx.x; i < 6 * C; i += blockDim.x) {
    const int t = i / C;
    const bf16* src = t == 0 ? gamma : t == 1 ? beta : t == 2 ? bq : t == 3 ? bk : t == 4 ? bv : bp;
    prm[i] = __bfloat162float(src[i - t * C]);
  }
  __syncthreads();

  const int group = warp / NT, w = warp - group * NT, r0 = 16 * w;
  const int g = lane >> 2, tq = lane & 3;
  bf16* kp = reinterpret_cast<bf16*>(gmem + group * tc_group_bytes(NT, L));
  bf16* vp = kp + ROWS * C;
  bf16* qp = vp + ROWS * C;
  bf16* ob = qp + ROWS * C;                                // the output slab, C x L
  float* mu = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ob) + tc_slab_bytes(L));
  float* inv = mu + C;
  const float* gm = prm;
  const float* bt = prm + C;
  const int cg = C / groups, mul = (65536 + cg - 1) / cg;   // c / cg = (c * mul) >> 16
  const float inv_n = 1.0f / static_cast<float>(cg * L);
  const float rs = rnd_bf16(rescale);
  const bool leader = w == 0 && lane == 0;
  const int first = blockIdx.x + group * gridDim.x;         // the group's first sample
  const int step = kTcGroups * gridDim.x;                   // between a group's samples
  auto load = [&](int m, int b) {                           // its m-th, into stage m % SPG
    uint64_t* bar = full + group * SPG + m % SPG;
    mbar_expect_tx(bar, slab_bytes);
    bulk_load(ring + (group * SPG + m % SPG) * tc_slab_bytes(L),
              x + static_cast<size_t>(b) * slab, slab_bytes, bar);
  };
  if (leader)
    for (int m = 0; m < SPG && first + m * step < B; ++m) load(m, first + m * step);

  for (int m = 0, b = first; b < B; ++m, b += step) {
    const int s = group * SPG + m % SPG;
    mbar_wait(full + s, (m / SPG) & 1);
    bf16* xs = reinterpret_cast<bf16*>(ring + s * tc_slab_bytes(L));   // C x L

    // The output slab is free once the group's last bulk store has read it
    // (a sample ago); the barrier after the statistics publishes that.
    if (leader) bulk_wait_read();

    // 1. GroupNorm statistics: group gi is cg * L contiguous values.
    for (int gi = w; gi < groups; gi += NT) {
      const bf16* xg = xs + gi * cg * L;
      float s1 = 0.f, s2 = 0.f;
      if ((cg * L) % 2 == 0) {       // bf16 pairs (a group starts on a 4-byte boundary)
        for (int i = lane; i < cg * L / 2; i += 32) {
          const float2 v = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(xg)[i]);
          s1 += v.x;
          s1 += v.y;
          s2 = fmaf(v.x, v.x, s2);
          s2 = fmaf(v.y, v.y, s2);
        }
      } else {
        for (int i = lane; i < cg * L; i += 32) {
          const float v = __bfloat162float(xg[i]);
          s1 += v;
          s2 = fmaf(v, v, s2);
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        const float mean = s1 * inv_n;
        mu[gi] = mean;
        inv[gi] = 1.0f / sqrtf(__fsub_rn(__fmul_rn(s2, inv_n), __fmul_rn(mean, mean)) + eps);
      }
    }
    named_sync(1 + group, 32 * NT);

    // 2. The warp's 16 rows of h as A fragments: register e of k-step kk
    //    holds row r0 + g + 8 (e % 2), channels 16 kk + 2 tq + 8 (e / 2) + {0, 1}.
    unsigned a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // channels c and c + 1 (c even) share a group when its width is even
        const int r = r0 + g + 8 * (e & 1), c = 16 * kk + 2 * tq + 8 * (e >> 1);
        float h[2] = {0.f, 0.f};
        if (r < L) {
          const float2 gm2 = *reinterpret_cast<const float2*>(gm + c);
          const float2 bt2 = *reinterpret_cast<const float2*>(bt + c);
          const int k0 = (c * mul) >> 16, k1 = cg % 2 ? ((c + 1) * mul) >> 16 : k0;
          const float h0 = (__bfloat162float(xs[c * L + r]) - mu[k0]) * inv[k0];
          const float h1 = (__bfloat162float(xs[(c + 1) * L + r]) - mu[k1]) * inv[k1];
          h[0] = __fadd_rn(__fmul_rn(h0, gm2.x), bt2.x);
          h[1] = __fadd_rn(__fmul_rn(h1, gm2.y), bt2.y);
        }
        a[kk][e] = pack_bf16(h[0], h[1]);
      }

    // 3. k and v for the group, q for this warp's rows.
    float acc[8][4];
    nin16(acc, a, wsm + C * C, lane);
    stage_rows<NT>(acc, prm + 3 * C, kp, r0, lane);
    nin16(acc, a, wsm + 2 * C * C, lane);
    stage_rows<NT>(acc, prm + 4 * C, vp, r0, lane);
    nin16(acc, a, wsm, lane);
    stage_rows<NT>(acc, prm + 2 * C, qp, r0, lane);
    named_sync(1 + group, 32 * NT);

    // 4. softmax(q k^T / sqrt(C)) v for the warp's rows, f32 softmax.
    attn_rows16<NT, 4, false>(qp, kp, vp, r0, L, scale, acc);

    // 5. o rounded once is the A operand of the output NIN as it stands.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
      a[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
      a[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
      a[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
    }
    nin16(acc, a, wsm + 3 * C * C, lane);

    // 6. out = bf16(bf16(x + bf16(bf16(o Wp) + bp)) * bf16(rescale)) for the
    //    warp's rows, into the output slab; once every warp has read its x,
    //    the slab goes out with one bulk store and the stage takes the
    //    group's sample after next.
    const float* bpf = prm + 5 * C;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1), c = 8 * n + 2 * tq + (e & 1);
        if (r < L) {
          const float o2 = rnd_bf16(rnd_bf16(acc[n][e]) + bpf[c]);
          ob[c * L + r] = __float2bfloat16(
              __fmul_rn(rnd_bf16(__bfloat162float(xs[c * L + r]) + o2), rs));
        }
      }
    fence_proxy_async();             // the bulk store reads these bytes
    named_sync(1 + group, 32 * NT);
    if (leader) {
      bulk_store(out + static_cast<size_t>(b) * slab, ob, slab_bytes);
      if (b + SPG * step < B) load(m + SPG, b + SPG * step);   // the stage is free
    }
  }
  if (leader) bulk_wait();
}

template <int NT>
cudaError_t launch_tc(const void* x, void* out, const void* const* p, int B, int L, int groups,
                      float eps, float scale, float rescale, cudaStream_t stream) {
  auto kern = fused_attn_block_tc_kernel<NT>;
  constexpr int smem = tc_smem_bytes(NT, 16 * NT);
  static_assert(smem <= kSmemLimit, "the ring does not fit");
  static SmemAttr smem_attr;
  const cudaError_t attr = smem_attr.apply(reinterpret_cast<const void*>(kern), smem);
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  kern<<<min(B, sms), 32 * kTcGroups * NT, tc_smem_bytes(NT, L), stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out),
      static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[1]),
      static_cast<const bf16*>(p[2]), static_cast<const bf16*>(p[3]),
      static_cast<const bf16*>(p[4]), static_cast<const bf16*>(p[5]),
      static_cast<const bf16*>(p[6]), static_cast<const bf16*>(p[7]),
      static_cast<const bf16*>(p[8]), static_cast<const bf16*>(p[9]), B, L, groups, eps, scale,
      rescale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  params: gamma, beta, wq, bq, wk, bk,
// wv, bv, wp, bp, all of the working type; W is (C_in, C_out) row-major.
// bfloat16 at C = 64 with L <= 96 runs the tensor-core body (x and out
// starting on 16-byte boundaries); every other shape and float32 the
// scalar body, R query rows at a time (ops/attention.py: attn_body,
// rows_per_chunk).  Returns a cudaError_t.
int rdm_fused_attn_block(const void* x, void* out,
                         const void* gamma, const void* beta,
                         const void* wq, const void* bq,
                         const void* wk, const void* bk,
                         const void* wv, const void* bv,
                         const void* wp, const void* bp,
                         int B, int C, int L, int groups, int R, int dtype,
                         float eps, float scale, float rescale, void* stream) {
  const void* p[10] = {gamma, beta, wq, bq, wk, bk, wv, bv, wp, bp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || L > kMaxL || groups < 1 || C % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && C == kTcC && L <= 96) {
    const int nt = (L + 31) / 32 * 2;   // 16-row tiles: 2, 4 or 6
    if (nt == 2) return static_cast<int>(launch_tc<2>(x, out, p, B, L, groups, eps, scale, rescale, s));
    if (nt == 4) return static_cast<int>(launch_tc<4>(x, out, p, B, L, groups, eps, scale, rescale, s));
    return static_cast<int>(launch_tc<6>(x, out, p, B, L, groups, eps, scale, rescale, s));
  }
  if (R < 1 || R > L) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && C == 64)
    return static_cast<int>(launch<float, 64>(x, out, p, B, L, groups, R, eps, scale, rescale, s));
  if (dtype == 0 && C == 128)
    return static_cast<int>(launch<float, 128>(x, out, p, B, L, groups, R, eps, scale, rescale, s));
  if (dtype == 1 && C == 64)
    return static_cast<int>(launch<__nv_bfloat16, 64>(x, out, p, B, L, groups, R, eps, scale, rescale, s));
  if (dtype == 1 && C == 128)
    return static_cast<int>(launch<__nv_bfloat16, 128>(x, out, p, B, L, groups, R, eps, scale, rescale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
