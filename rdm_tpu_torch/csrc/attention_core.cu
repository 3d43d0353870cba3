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
// float32 (attention_core_kernel<float>, the earlier body): one block of 256
// threads per sample, the products as the fused attention block does them
// (attn_common.cuh: tile_product over 4 x 8 register tiles in f32), query
// rows in chunks of R rows so that L = C = 128 fits in 227 KB.  Shared
// memory, f32: k transposed (C x LP), v (L x C), a chunk of score rows
// (R x LP) and of q rows (R x (C + 1)).  TF32 would break its 1e-5
// tolerance; no path of the port runs the core in f32.
#include "attn_common.cuh"
#include "attn_mma.cuh"
#include "tma.cuh"
#include "smem_attr.cuh"

namespace {

template <typename T, bool kScoresInT>
__global__ void __launch_bounds__(kThreads)
attention_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      int L, int C, int R, float scale) {
  const int LP = (L + TN - 1) / TN * TN;
  const int CP = C + 1;              // odd row stride of q: no bank conflicts
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                  // C x LP: k transposed
  float* vb = kt + C * LP;           // L x C : v
  float* sb = vb + L * C;            // R x LP: scores, then probabilities
  float* qb = sb + R * LP;           // R x CP: a chunk of q rows

  const size_t base = static_cast<size_t>(blockIdx.x) * L * C;
  const T* qs = q + base;
  T* os = o + base;
  for (int i = threadIdx.x; i < L * C; i += kThreads) {
    const int l = i / C;
    kt[(i - l * C) * LP + l] = to_f<T>(k[base + i]);
    vb[i] = to_f<T>(v[base + i]);
  }
  const float scale_t = rnd<T>(scale);

  for (int r0 = 0; r0 < L; r0 += R) {
    const int nr = min(R, L - r0);
    for (int i = threadIdx.x; i < nr * C; i += kThreads) {
      const int l = i / C;
      qb[l * CP + i - l * C] = to_f<T>(qs[static_cast<size_t>(r0) * C + i]);
    }
    __syncthreads();

    tile_product(nr, L, C, [=](int i, int c) { return qb[i * CP + c]; },
                 [=](int c, int j0, float* vals) { load8_shared(kt + c * LP + j0, vals); },
                 [=](int i, int j, float acc) {
                   sb[i * LP + j] = kScoresInT ? rnd<T>(rnd<T>(acc) * scale_t) : acc * scale;
                 });
    __syncthreads();

    softmax_rows<T, kScoresInT>(sb, nr, L, LP);
    __syncthreads();

    tile_product(nr, C, L, [=](int i, int j) { return sb[i * LP + j]; },
                 [=](int j, int c0, float* vals) { load8_shared(vb + j * C + c0, vals); },
                 [=](int i, int c, float acc) {
                   os[static_cast<size_t>(r0 + i) * C + c] = from_f<T>(acc);
                 });
    __syncthreads();
  }
}

template <typename T, bool kScoresInT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int L, int C,
                   int R, float scale, cudaStream_t stream) {
  const size_t LP = (L + TN - 1) / TN * TN;
  const size_t smem = sizeof(float) * (C * LP + static_cast<size_t>(L) * C + R * LP
                                       + static_cast<size_t>(R) * (C + 1));
  auto kern = attention_core_kernel<T, kScoresInT>;
  // The most shared memory any shape takes (the launcher caps R so that
  // L = C = 128 fits), set once per instantiation and card.
  static SmemAttr smem_attr;
  const cudaError_t attr = smem_attr.apply(reinterpret_cast<const void*>(kern), 232448);
  if (attr != cudaSuccess) return attr;
  if (smem > 232448) return cudaErrorInvalidValue;
  kern<<<B, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(o),
                                      L, C, R, scale);
  return cudaGetLastError();
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
// the working type (bfloat16: starting on 16-byte boundaries); scores_in_t
// selects the softmax in the working type (softmax_f32 off); R is the float32
// kernel's rows per chunk (ops/attention.py: core_rows_per_chunk), unused in
// bfloat16.  Returns a cudaError_t.
int rdm_attention_core(const void* q, const void* k, const void* v, void* o,
                       int B, int L, int C, int R, int dtype, int scores_in_t,
                       float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || L > kMaxL || C < 8 || C > 128 || C % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (R < 1 || R > L) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<float, false>(q, k, v, o, B, L, C, R, scale, s));
  }
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
