// Bare attention core softmax(q k^T / sqrt(C)) v for Hopper, sm_90a.
//
// Replaces the TPU kernel rdm_tpu/ops/pallas/attention.py::_attn_kernel.  For
// one sample of (L, C) q, k, v it computes the L x L scores, their row
// softmax and p v, keeping the scores out of device memory.  With the f32
// softmax (softmax_f32, or float32 inputs) scores and softmax are f32 and p
// is rounded to the working type T before p v; otherwise the scores are
// rounded to T, scaled by T(1/sqrt C) in T, and the softmax runs in T (see
// attn_mma.cuh and attn_common.cuh: softmax_rows).  p v accumulates in f32
// and is rounded to T once.
//
// Bound on this card: at B = 1024, L = 81, C = 64 in bf16 the kernel must read
// q, k, v and write o, 42.5 MB (12.7 us at 3.35 TB/s), against 1.7 GFLOP
// (1.7 us at the bf16 tensor-core peak): memory bounds it.
//
// bfloat16 design (attention_core_mma_kernel): the earlier scalar-f32 kernel
// staged everything as f32 (about 93 KB a sample, two blocks an SM), ran both
// products as scalar FMAs, sent the scores through shared memory with five
// __syncthreads() per chunk, and reached 7 % of the bound.  Here one
// persistent block per SM walks the samples blockIdx.x, + gridDim.x, ...: a
// producer warp loads each sample's q, k and v with TMA (bf16, 128-byte
// swizzle, so ldmatrix is free of bank conflicts) into a ring of staged
// samples, and consumer groups (two at L 81, C 64, each with two stages of
// its own) take the samples in turn, so device memory streams while they
// compute.  Each consumer warp
// owns 16 query rows (6 warps at L 81: 96 rows, 19 % padding) and runs
// attn_rows16: q k^T and p v on mma.sync.m16n8k16, the softmax in the
// accumulator registers, p fed to p v from registers.  The warp rounds its
// result once, stages it in its own q rows, writes it with 16-byte stores
// and frees the stage.  mma.sync and not wgmma: wgmma tiles are 64 rows,
// which would pad 81 query rows to 128, and the tensor cores need not run
// at full rate for a kernel that memory bounds.  What bounds it now: the
// time to move the 42.5 MB through this ring (the kernel with its products
// and softmax knocked out: benchmark/knockouts.py), and the compute of each
// block's first and last samples, which no load hides.
//
// float32 (attention_core_f32_kernel): the tensor cores on a 3xTF32 split.
// The scalar-FMA body it replaces (PR 6) reached 14 % of its bound; TF32
// alone keeps 10 mantissa bits and would break the 1e-5 tolerance.  Each
// operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and
// every product a b is hi_a lo_b + lo_a hi_b + hi_a hi_b on
// mma.sync.m16n8k8.tf32 (the products exact in the tensor cores, lo_a lo_b,
// about 2^-22 |a b|, dropped), the three summed from zero for each 8-deep
// slice of K and that partial added to the f32 sum with an IEEE add, so the
// tensor cores' own accumulation rounds over 8 terms at a time only.  One
// block a sample, one warp a 16-row tile of queries: q, k and v (16 NT rows,
// zeros past L, C + 4 floats a row: the fragment loads are free of bank
// conflicts) arrive by cp.async, the scores stay in registers, the softmax is
// exact in f32 as the plain version's (p not rounded: v is float32), and p
// feeds p v from registers: its accumulator layout gives lane (g, t) keys
// 2t and 2t + 1 of each 8, which are the A fragment's k-indices t and t + 4
// once v's rows are read in that order.  At B 1024, L 81, C 64 the kernel
// moves 85 MB, 25.4 us at 3.35 TB/s; its 3 x 1.7 GFLOP at TF32's 495
// TFLOP/s take 10.3 us, so memory bounds it.  No path of the port runs the
// core in float32.
#include "attn_mma.cuh"
#include "tma.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int kMaxL = 128;   // tokens at most (both bodies)

// ---------------------------------------------------------------------------
// float32: 3xTF32 on mma.sync.m16n8k8

// x rounded to TF32, to nearest with ties away from zero (the low 13 bits 0).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi = TF32(x), lo = TF32(x - hi).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8, row-major) b (8 x 8, column-major), TF32 operands.
// Lane (g, t) = (lane / 4, lane % 4) holds a at (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4), b at (k t, n g) and (k t + 4, n g), d as mma_bf16's.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a b in 3xTF32 (a's and b's hi and lo parts), the three products
// summed from zero first.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, ahi, bl0, bl1);
  mma_tf32(t, alo, bh0, bh1);
  mma_tf32(t, ahi, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], t[e]);
}

// Floats of a staged row: C + 4 (fragment loads free of bank conflicts).
__host__ __device__ constexpr int f32_row(int C) { return C + 4; }
__host__ __device__ constexpr int f32_smem_bytes(int NT, int C) {
  return 3 * 16 * NT * f32_row(C) * 4;
}

// grid B (a sample a block), 32 ceil(L / 16) threads, f32_smem_bytes(NT, C)
// of dynamic shared memory.  NT: key tiles of 16 (keys padded to 16 NT, zeros
// past L); CT: channel tiles of 16 the output covers (C <= 16 CT, C % 8 == 0).
template <int NT, int CT>
__global__ void __launch_bounds__(256) attention_core_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int L, int C, float scale) {
  constexpr int KP = 16 * NT;
  extern __shared__ __align__(16) float smem[];
  const int R = f32_row(C), c4 = C / 4;
  float* qs = smem;
  float* ks = qs + KP * R;
  float* vs = ks + KP * R;
  const size_t base = static_cast<size_t>(blockIdx.x) * L * C;
  for (int i = threadIdx.x; i < KP * c4; i += blockDim.x) {
    const int r = i / c4, c = (i - r * c4) * 4;
    if (r < L) {
      const size_t at = base + static_cast<size_t>(r) * C + c;
      cp_async16(qs + r * R + c, q + at);
      cp_async16(ks + r * R + c, k + at);
      cp_async16(vs + r * R + c, v + at);
    } else {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(qs + r * R + c) = z;
      *reinterpret_cast<float4*>(ks + r * R + c) = z;
      *reinterpret_cast<float4*>(vs + r * R + c) = z;
    }
  }
  cp_async_wait();
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  // S = q k^T: 2 NT tiles of 8 keys, K in slices of 8 channels
  float s[2 * NT][4];
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  for (int c0 = 0; c0 < C; c0 += 8) {
    const float* qa = qs + (r0 + g) * R + c0 + t;
    uint32_t ahi[4], alo[4];
    split_tf32(qa[0], ahi[0], alo[0]);
    split_tf32(qa[8 * R], ahi[1], alo[1]);
    split_tf32(qa[4], ahi[2], alo[2]);
    split_tf32(qa[8 * R + 4], ahi[3], alo[3]);
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const float* kb = ks + (8 * j + g) * R + c0 + t;
      mma_3xtf32(s[j], ahi, alo, kb[0], kb[4]);
    }
  }

  // The exact f32 softmax of rows r0 + g (s[.][0..1]) and r0 + g + 8
  // (s[.][2..3]) over the L real keys: p = exp(s scale - max) / sum.
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t + (e & 1);
      s[j][e] = key < L ? __fmul_rn(s[j][e], scale) : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * t + (e & 1);
      s[j][e] = key < L ? expf(__fsub_rn(s[j][e], mx[e >> 1])) : 0.f;
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
  }

  // O = p v: keys in slices of 8, p's A fragment straight from the
  // accumulators (k-index t is key 2t, t + 4 is key 2t + 1), v's rows read in
  // that order; 2 CT tiles of 8 channels
  float acc[2 * CT][4];
#pragma unroll
  for (int n = 0; n < 2 * CT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * NT; ++j) {
    uint32_t ahi[4], alo[4];
    split_tf32(s[j][0] / sum[0], ahi[0], alo[0]);
    split_tf32(s[j][2] / sum[1], ahi[1], alo[1]);
    split_tf32(s[j][1] / sum[0], ahi[2], alo[2]);
    split_tf32(s[j][3] / sum[1], ahi[3], alo[3]);
    const float* vb = vs + (8 * j + 2 * t) * R + g;
#pragma unroll
    for (int n = 0; n < 2 * CT; ++n)
      if (8 * n < C) mma_3xtf32(acc[n], ahi, alo, vb[8 * n], vb[R + 8 * n]);
  }
  float* out = o + base;
#pragma unroll
  for (int n = 0; n < 2 * CT; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + g + 8 * h, c = 8 * n + 2 * t;
      if (row < L && c < C)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * C + c) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
    }
}

template <int NT, int CT>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int L, int C,
                       float scale, cudaStream_t stream) {
  auto kern = attention_core_f32_kernel<NT, CT>;
  static SmemAttr smem_attr;   // the most this instantiation takes: C = 16 CT
  const cudaError_t attr =
      smem_attr.apply(reinterpret_cast<const void*>(kern), f32_smem_bytes(NT, 16 * CT));
  if (attr != cudaSuccess) return attr;
  kern<<<B, 32 * ((L + 15) / 16), f32_smem_bytes(NT, C), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), L, C, scale);
  return cudaGetLastError();
}

// Key tiles of 16 (NT: 2, 4, 6, 8 for L <= 32, 64, 96, 128) and channel
// tiles of 16 (CT: 4, 8 for C <= 64, 128), as ops/attention.py: core_plan.
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, int B, int L,
                         int C, float scale, cudaStream_t s) {
  const int nt = (L + 31) / 32 * 2;
  if (C <= 64) {
    switch (nt) {
      case 2: return launch_f32<2, 4>(q, k, v, o, B, L, C, scale, s);
      case 4: return launch_f32<4, 4>(q, k, v, o, B, L, C, scale, s);
      case 6: return launch_f32<6, 4>(q, k, v, o, B, L, C, scale, s);
      default: return launch_f32<8, 4>(q, k, v, o, B, L, C, scale, s);
    }
  }
  switch (nt) {
    case 2: return launch_f32<2, 8>(q, k, v, o, B, L, C, scale, s);
    case 4: return launch_f32<4, 8>(q, k, v, o, B, L, C, scale, s);
    case 6: return launch_f32<6, 8>(q, k, v, o, B, L, C, scale, s);
    default: return launch_f32<8, 8>(q, k, v, o, B, L, C, scale, s);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, scores in registers, a TMA ring of samples

using bf16 = __nv_bfloat16;

// Consumer groups (taking the block's samples in turn), the ring stages each
// group owns, the bytes of one staged sample (q, k, v, each 16 NT rows of
// 16 CT values) and the block's shared memory, as ops/attention.py:
// core_plan.
__host__ __device__ constexpr int core_groups(int NT, int CT) { return NT * CT >= 32 ? 1 : 2; }
constexpr int kStagesPerGroup = 2;
__host__ __device__ constexpr int core_sample_bytes(int NT, int CT) { return 3 * (16 * NT) * (16 * CT) * 2; }
__host__ __device__ constexpr int core_smem_bytes(int NT, int CT) {
  return 1024 + core_groups(NT, CT) * kStagesPerGroup * (core_sample_bytes(NT, CT) + 16);
}

// A block is core_groups consumer groups of ceil(L / 16) warps (warp w of a
// group owns query rows 16 w .. 16 w + 15) and one producer warp; block b
// takes samples b, b + gridDim.x, ... in turn, and its i-th sample goes to
// group g = i % groups, as that group's m-th (m = i / groups), into stage
// m % SPG of the group's own SPG stages.  A stage serves one group only, so
// a group waits for a stage's next phase only after consuming the phase
// before it itself: only then is a parity wait exact (it cannot tell a phase
// from the one two earlier, nor a phase from the next while that is pending;
// a ring shared by the groups let a fast group take a stage whose earlier
// sample had not landed).  The producer loads each sample's q, k,
// v with TMA (3-D maps (C, L, B), boxes of L rows x 64 values) once its
// stage is free; a consumer warp waits for the stage, runs attn_rows16,
// stages its result in its own q rows, writes it and frees the stage.  Rows
// L .. 16 NT - 1 of k and v are zeroed once and never loaded; channels past
// C are zero-filled by TMA.
template <int NT, int CT, bool kScoresInT>
__global__ void __launch_bounds__(32 * (core_groups(NT, CT) * NT + 1), 1)
attention_core_mma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                          const __grid_constant__ CUtensorMap tmap_k,
                          const __grid_constant__ CUtensorMap tmap_v, bf16* __restrict__ o, int B,
                          int L, int C, float scale) {
  constexpr int ROWS = 16 * NT, TILE = ROWS * 16 * CT, PANELS = CT / 4;
  constexpr int GROUPS = core_groups(NT, CT), SPG = kStagesPerGroup;
  constexpr int STAGES = GROUPS * SPG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * 3 * TILE);
  uint64_t* empty = full + STAGES;
  const int mt = (L + 15) / 16;   // warps of a group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < STAGES * 3 * PANELS * (ROWS - L) * 8; i += blockDim.x) {
    const int ch = i & 7, rest = i >> 3;
    const int r = L + rest % (ROWS - L), panel = rest / (ROWS - L);   // panel of q, k, v, stage
    *reinterpret_cast<uint4*>(ring + panel * ROWS * 64 + r * 64 + ch * 8) = make_uint4(0, 0, 0, 0);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, mt);      // one arrival per warp of the group
    }
    mbar_init_fence();
  }
  fence_proxy_async();
  __syncthreads();

  if (warp == GROUPS * mt) {
    if (lane == 0) {
      int i = 0;
      for (int b = blockIdx.x; b < B; b += gridDim.x, ++i) {
        const int m = i / GROUPS, s = (i % GROUPS) * SPG + m % SPG;
        if (m >= SPG) mbar_wait(empty + s, (m / SPG - 1) & 1);
        mbar_expect_tx(full + s, 3 * PANELS * L * 128);
        for (int t = 0; t < 3; ++t)
          for (int p = 0; p < PANELS; ++p)
            tma_load_3d(ring + (s * 3 + t) * TILE + p * ROWS * 64,
                        t == 0 ? &tmap_q : t == 1 ? &tmap_k : &tmap_v, 64 * p, 0, b, full + s);
      }
    }
    return;
  }

  const int group = warp / mt, r0 = 16 * (warp - group * mt);
  const size_t sample = static_cast<size_t>(L) * C;
  for (int m = 0, b = blockIdx.x + group * gridDim.x; b < B; ++m, b += GROUPS * gridDim.x) {
    const int s = group * SPG + m % SPG;
    mbar_wait(full + s, (m / SPG) & 1);
    __syncwarp();
    bf16* qs = ring + s * 3 * TILE;
    float acc[2 * CT][4];
    attn_rows16<NT, CT, kScoresInT>(qs, qs + TILE, qs + 2 * TILE, r0, L, scale, acc);
    // the warp's own q rows are free now: they stage its output
    store_rows16<NT, CT>(acc, qs, r0, L, C, o + b * sample);
    fence_proxy_async();             // before TMA writes these bytes again
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
}

template <int NT, int CT, bool kScoresInT>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int L, int C,
                       float scale, cudaStream_t stream) {
  auto kern = attention_core_mma_kernel<NT, CT, kScoresInT>;
  constexpr int smem = core_smem_bytes(NT, CT);
  static_assert(smem <= 232448, "the ring does not fit");
  const int threads = 32 * (core_groups(NT, CT) * ((L + 15) / 16) + 1);
  static SmemAttr smem_attr;
  const cudaError_t attr = smem_attr.apply(reinterpret_cast<const void*>(kern), smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap maps[3];
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(L) * C * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(L), 1};
  const void* src[3] = {q, k, v};
  for (int t = 0; t < 3; ++t)
    if (!tensor_map(&maps[t], src[t], 3, dims, strides, box)) return cudaErrorNotSupported;
  // blocks an SM holds, by warps of a group (1 .. 8), asked once each
  static int per_sm[9] = {};
  const int mt = (L + 15) / 16;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm[mt] == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[mt], kern, threads, smem);
  if (err != cudaSuccess) return err;
  const int grid = min(B, max(1, per_sm[mt]) * sms);
  kern<<<grid, threads, smem, stream>>>(maps[0], maps[1], maps[2], static_cast<bf16*>(o), B, L, C,
                                        scale);
  return cudaGetLastError();
}

// Key tiles of 16 (NT: 2, 4, 6, 8 for L <= 32, 64, 96, 128) and channel
// tiles of 16 (CT: 4, 8 for C <= 64, 128), as ops/attention.py: core_plan.
template <bool kScoresInT>
cudaError_t dispatch_mma(const void* q, const void* k, const void* v, void* o, int B, int L,
                         int C, float scale, cudaStream_t s) {
  const int nt = (L + 31) / 32 * 2;
  if (C <= 64) {
    switch (nt) {
      case 2: return launch_mma<2, 4, kScoresInT>(q, k, v, o, B, L, C, scale, s);
      case 4: return launch_mma<4, 4, kScoresInT>(q, k, v, o, B, L, C, scale, s);
      case 6: return launch_mma<6, 4, kScoresInT>(q, k, v, o, B, L, C, scale, s);
      default: return launch_mma<8, 4, kScoresInT>(q, k, v, o, B, L, C, scale, s);
    }
  }
  switch (nt) {
    case 2: return launch_mma<2, 8, kScoresInT>(q, k, v, o, B, L, C, scale, s);
    case 4: return launch_mma<4, 8, kScoresInT>(q, k, v, o, B, L, C, scale, s);
    case 6: return launch_mma<6, 8, kScoresInT>(q, k, v, o, B, L, C, scale, s);
    default: return launch_mma<8, 8, kScoresInT>(q, k, v, o, B, L, C, scale, s);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, k, v and o are (B, L, C) row-major of
// the working type, starting on 16-byte boundaries; scores_in_t selects the
// bfloat16 softmax in the working type (softmax_f32 off; float32 always
// keeps its softmax in f32).  Returns a cudaError_t.
int rdm_attention_core(const void* q, const void* k, const void* v, void* o,
                       int B, int L, int C, int dtype, int scores_in_t,
                       float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || L > kMaxL || C < 8 || C > 128 || C % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(dispatch_f32(q, k, v, o, B, L, C, scale, s));
  if (dtype == 1 && scores_in_t)
    return static_cast<int>(dispatch_mma<true>(q, k, v, o, B, L, C, scale, s));
  if (dtype == 1)
    return static_cast<int>(dispatch_mma<false>(q, k, v, o, B, L, C, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
