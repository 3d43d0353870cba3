// Channels-first primitives of a resblock redesign for Hopper, sm_90a: a 2-D
// transpose, a masked lane-roll sum and wide channels-first products on the
// tensor cores, all in bfloat16 with rows x lanes, the lane axis last.
//
// Replaces the TPU microbenchmark kernels of scripts/micro_pallas_cf.py: the
// transpose pair (:49 (N, C) -> (C, N) and :56 (C, N) -> (N, C), one kernel
// here for both), the eight masked lane-rolls (:85) and the channels-first
// dots (:111, K = 64 with 9 taps and K = 192 with 3).
//
// Bound on this card at the script's shapes (C = 64, N = 20,736): each
// transpose and the roll sum read and write 2.65 MB each, 1.58 us at
// 3.35 TB/s; the dots read w (73.7 KB) and x (2.65 MB at K 64, 7.96 MB at
// K 192) and write 2.65 MB, 1.61 us and 3.19 us, against 1.55 us of
// operations (1.53 GFLOP) at the bf16 tensor-core peak: device memory bounds
// all three.  Every working set is 5-11 MB, so a run that feeds each call
// the previous output stays in the 50 MB L2 and can beat that bound.
//
// Design.
// * Transpose: a 64 x 64 tile per block through shared memory, 16-byte
//   loads and stores.  The tile is 64 rows of eight 16-byte chunks; chunk k
//   of row r sits at slot k ^ (r / 8 % 8), so the stores of one row and the
//   2-byte column reads of the write-back both fall on distinct banks.
// * Roll sum: a block takes one row and a span of 2,048 lanes; it stages
//   the span and two 16-byte chunks on each side (a halo of 16 lanes) as
//   float in shared memory, then each thread sums the shifted taps of
//   lanes t, t + 256, ... in the order of the shifts, so neighbouring
//   threads read neighbouring words.
// * Dots: one persistent block per SM (at most one per 64-column tile)
//   walks the output tiles b, b + gridDim.x, ... (324 tiles at N 20,736: 2
//   or 3 a block).  The earlier kernel gave each of 162 blocks one 128-column
//   tile: each staged all of w from L2, waited for all its loads, then
//   computed, then stored, with no overlap, and 30 SMs took two tiles; its
//   mma.sync products lost to cuBLAS.  Here one producer warp loads all of w
//   once per block, tap by tap (taps x 64 x K, 73.7 KB at both K, as
//   64 x 64 panels), then streams the block's K x 64 x tiles through a ring
//   of one or two stages for each consumer, all with TMA (128-byte swizzle,
//   completion counted on mbarriers; cuTensorMapEncodeTiled is taken from
//   the runtime's driver entry point, so the library needs no -lcuda).  Three consumer
//   warpgroups take the tiles in turn (at N 20,736 a block's tiles all run
//   at once): each issues taps x K / 16 = 36 wgmma.m64n64k16 (A = w[t]
//   K-major, B = the x tile N-major) into one float32 accumulator, frees the
//   stage, and rounds once to bf16 through a per-warp swizzled stage into
//   16-byte coalesced stores while the other warpgroups' products and the
//   producer's loads run.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_ptx.cuh"
#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;   // shared memory one block may use on sm_90

// ---------------------------------------------------------------------------
// transpose

constexpr int kTile = 64;            // a 64 x 64 tile: 64 rows of 8 chunks

__device__ __forceinline__ int swizzled(int r, int k) { return r * 8 + (k ^ ((r >> 3) & 7)); }

// y (S x R) = x (R x S)^T; R and S are multiples of 8.
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int R, int S) {
  __shared__ uint4 tile[kTile * 8];
  const int r0 = blockIdx.x * kTile;
  const int s0 = blockIdx.y * kTile;
  for (int q = threadIdx.x; q < kTile * 8; q += kThreads) {
    const int r = q >> 3, k = q & 7;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < R && s0 + 8 * k < S)
      v = __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(r0 + r) * S + s0 + 8 * k));
    tile[swizzled(r, k)] = v;
  }
  __syncthreads();
  const uint16_t* t16 = reinterpret_cast<const uint16_t*>(tile);
  for (int q = threadIdx.x; q < kTile * 8; q += kThreads) {
    const int c = q >> 3, m = q & 7;     // output row s0 + c, its lanes r0 + 8m .. r0 + 8m + 7
    if (s0 + c >= S || r0 + 8 * m >= R) continue;
    uint32_t packed[4];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const uint32_t lo = t16[swizzled(8 * m + j, c >> 3) * 8 + (c & 7)];
      const uint32_t hi = t16[swizzled(8 * m + j + 1, c >> 3) * 8 + (c & 7)];
      packed[j / 2] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(y + static_cast<size_t>(s0 + c) * R + r0 + 8 * m) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// ---------------------------------------------------------------------------
// masked lane-roll sum

constexpr int kSpan = 8 * kThreads;  // lanes a block sums
constexpr int kHalo = 16;            // lanes staged on each side of the span
constexpr int kMaxShifts = 16;

struct Shifts {
  int n;
  int s[kMaxShifts];
};

// y[c, n] = bf16(sum_j [0 <= n % L + s_j < L] x[c, n + s_j]) in float32, in
// the order of the shifts, starting from 0; |s_j| <= kHalo, N % 8 == 0.
__global__ void __launch_bounds__(kThreads)
roll_sum_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int N, int L, Shifts sh) {
  __shared__ __align__(16) float win[kSpan + 2 * kHalo];
  const int n0 = blockIdx.x * kSpan;
  const bf16* row = x + static_cast<size_t>(blockIdx.y) * N;
  const int chunks = N / 8;
  for (int q = threadIdx.x; q < (kSpan + 2 * kHalo) / 8; q += kThreads) {
    const int k = (n0 - kHalo) / 8 + q;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k >= 0 && k < chunks) v = __ldg(reinterpret_cast<const uint4*>(row) + k);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    float4* dst = reinterpret_cast<float4*>(win + 8 * q);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
    dst[0] = make_float4(a.x, a.y, b.x, b.y);
    dst[1] = make_float4(c.x, c.y, d.x, d.y);
  }
  __syncthreads();
  bf16* out = y + static_cast<size_t>(blockIdx.y) * N;
  const int step = kThreads % L;     // the position in the sample moves by this per lane stride
  int p = (n0 + threadIdx.x) % L;
#pragma unroll
  for (int i = 0; i < 8; ++i, p = p + step >= L ? p + step - L : p + step) {
    const int local = threadIdx.x + i * kThreads;
    const int n = n0 + local;
    if (n >= N) break;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxShifts; ++j) {
      if (j < sh.n) {
        const int s = sh.s[j];
        if (p + s >= 0 && p + s < L) acc += win[kHalo + local + s];
      }
    }
    out[n] = __float2bfloat16(acc);
  }
}

// ---------------------------------------------------------------------------
// channels-first dots: persistent, a TMA ring of x tiles, wgmma

constexpr int kRows = 64;            // C: every row of w, the rows of y
constexpr int kTileN = 64;           // output columns of a tile
constexpr int kMaxTaps = 16;
constexpr int kMaxK = 256;           // a TMA box has at most 256 rows
constexpr int kPanel = kRows * 128;  // bytes of one 64 x 64 bf16 panel of w
constexpr int kConsumers = 3;                 // consumer warpgroups, taking tiles in turn
constexpr int kOutStage = kConsumers * 4 * 16 * 128;   // 16 rows x 64 bf16 for each consumer warp
constexpr int kDotsThreads = kConsumers * 128 + 32;    // and one producer warp

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 (128B).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d (64 x 64 float, the warpgroup's registers) += a (64 x 16, K-major) b (16 x 64,
// N-major: imm-trans-b 1), both bf16 from shared memory.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// y (64 x N) = bf16(sum_t w[t] (64 x K) @ x[:K] (K x N)) over 64-column
// tiles; block b takes tiles b, b + gridDim.x, ..., and its i-th tile goes
// to consumer c = i % kConsumers, as that consumer's m-th (m = i /
// kConsumers), into stage m % spc of the consumer's own spc = stages /
// kConsumers stages: a stage serves one consumer only, so a consumer waits
// for a stage's next phase only after consuming the phase before it itself,
// which is what makes a parity wait exact (attention_core.cu says why).
// Shared memory, from a 1024-byte boundary: w as taps x
// ceil(K / 64) panels of 64 rows x 64 values (TMA, 128-byte swizzle: the
// K-major A operand), the ring of `stages` x tiles of K rows x 64 values
// (the N-major B operand), the consumer warps' output stages, then the
// barriers.
__global__ void __launch_bounds__(kDotsThreads, 1)
dots_kernel(const __grid_constant__ CUtensorMap tmap_w, const __grid_constant__ CUtensorMap tmap_x,
            bf16* __restrict__ y, int taps, int K, int N, int stages) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int panels = (K + 63) / 64;
  const int x_bytes = K * 128;
  unsigned char* ws = smem;
  unsigned char* xs = ws + taps * panels * kPanel;
  unsigned char* os = xs + stages * x_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(os + kOutStage);
  uint64_t* empty = full + stages;
  uint64_t* wbar = empty + stages;            // one per tap
  const int tiles = (N + kTileN - 1) / kTileN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);                // one arrival per warp of the consumer
    }
    for (int t = 0; t < taps; ++t) mbar_init(wbar + t, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // Producer: w once, tap by tap, then the block's x tiles through the ring.
    if (lane == 0) {
      for (int t = 0; t < taps; ++t) {
        mbar_expect_tx(wbar + t, panels * kPanel);
        for (int p = 0; p < panels; ++p)
          tma_load_2d(ws + (t * panels + p) * kPanel, &tmap_w, 64 * p, kRows * t, wbar + t);
      }
      const int spc = stages / kConsumers;
      int i = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
        const int m = i / kConsumers, s = (i % kConsumers) * spc + m % spc;
        if (m >= spc) mbar_wait(empty + s, (m / spc - 1) & 1);
        mbar_expect_tx(full + s, x_bytes);
        tma_load_2d(xs + s * x_bytes, &tmap_x, kTileN * tile, 0, full + s);
      }
    }
    return;
  }

  // Consumers: warpgroup c takes the block's tiles c, c + kConsumers, ...;
  // its warp w4 holds rows 16 w4 .. 16 w4 + 15 of the 64 x 64 accumulator.
  const int c = warp >> 2, w4 = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  unsigned char* stage = os + (c * 4 + w4) * 16 * 128;
  const int spc = stages / kConsumers;
  for (int m = 0, tile = blockIdx.x + c * gridDim.x; tile < tiles;
       ++m, tile += kConsumers * gridDim.x) {
    const int s = c * spc + m % spc;
    float acc[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] = 0.f;
    fence_acc(acc);
    mbar_wait(full + s, (m / spc) & 1);
    __syncwarp();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int t = 0; t < taps; ++t) {
      mbar_wait(wbar + t, 0);                 // passes at once after the first tile
      __syncwarp();                           // wgmma is warp-aligned: reconverge first
      for (int k = 0; k < K / 16; ++k) {
        // A: panel k / 4 of tap t, 32 bytes per 16 values along K inside the
        // swizzled 128-byte rows, 8-row groups 1024 bytes apart; B: 16 rows of
        // 128 bytes per step, 8-row groups 1024 bytes apart (a 64-wide tile
        // is one swizzle atom across N, so its other offset is never used).
        const uint64_t da = sw128_desc(ws + (t * panels + k / 4) * kPanel + 32 * (k % 4), 16, 1024);
        const uint64_t db = sw128_desc(xs + s * x_bytes + k * 2048, 1024, 1024);
        wgmma_64x64x16(acc, da, db);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty + s);   // the x tile is read

    // Round once; stage the warp's 16 rows (128-byte rows, chunk j of row r
    // at j ^ (r % 8)) and write them with 16-byte stores.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(stage + g * 128 + ((j ^ g) << 4) + 4 * tq) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(stage + (g + 8) * 128 + ((j ^ g) << 4) + 4 * tq) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = it * 4 + (lane >> 3), ch = lane & 7;
      const int col = kTileN * tile + 8 * ch;
      if (col < N)
        *reinterpret_cast<uint4*>(y + static_cast<size_t>(16 * w4 + r) * N + col) =
            *reinterpret_cast<const uint4*>(stage + r * 128 + ((ch ^ (r & 7)) << 4));
    }
    __syncwarp();
  }
}

// Shared memory the kernel lays out for `stages` (ops/micro_cf.py: dots_plan).
int dots_smem_needed(int taps, int K, int stages) {
  return 1024 + taps * ((K + 63) / 64) * kPanel + stages * K * 128 + kOutStage
         + 8 * (2 * stages + taps);
}

}  // namespace

extern "C" {

// x (R x S) and y (S x R) are row-major bfloat16.  Returns a cudaError_t.
int rdm_cf_transpose(const void* x, void* y, int R, int S, void* stream) {
  if (R < 1 || S < 1 || R % 8 != 0 || S % 8 != 0 || (S + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((R + kTile - 1) / kTile, (S + kTile - 1) / kTile);
  transpose_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), R, S);
  return static_cast<int>(cudaGetLastError());
}

// x and y are (C x N) row-major bfloat16; shifts holds n_shifts values.
int rdm_cf_masked_roll_sum(const void* x, void* y, int C, int N, int L, const int* shifts,
                           int n_shifts, void* stream) {
  if (C < 1 || C > 65535 || N < 8 || N % 8 != 0 || L < 1 || n_shifts < 0 ||
      n_shifts > kMaxShifts)
    return static_cast<int>(cudaErrorInvalidValue);
  Shifts sh{};
  sh.n = n_shifts;
  for (int j = 0; j < n_shifts; ++j) {
    if (shifts[j] < -kHalo || shifts[j] > kHalo) return static_cast<int>(cudaErrorInvalidValue);
    sh.s[j] = shifts[j];
  }
  const dim3 grid((N + kSpan - 1) / kSpan, C);
  roll_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), N, L, sh);
  return static_cast<int>(cudaGetLastError());
}

// w (taps x 64 x K), x (>= K rows of N) and y (64 x N) are row-major
// bfloat16 starting on 16-byte boundaries; stages and smem are the plan of
// ops/micro_cf.py: dots_plan.
int rdm_cf_dots(const void* w, const void* x, void* y, int taps, int K, int N, int stages,
                int smem, void* stream) {
  if (taps < 1 || taps > kMaxTaps || K < 16 || K > kMaxK || K % 16 != 0 || N < 8 || N % 8 != 0 ||
      stages < kConsumers || stages % kConsumers != 0 || smem < dots_smem_needed(taps, K, stages) ||
      smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  // The most any shape may take, set once.
  static const cudaError_t attr = cudaFuncSetAttribute(
      dots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tmap_w, tmap_x;
  if (!tensor_map_2d(&tmap_w, w, taps * kRows, K, kRows) || !tensor_map_2d(&tmap_x, x, K, N, K))
    return static_cast<int>(cudaErrorNotSupported);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + kTileN - 1) / kTileN;
  dots_kernel<<<tiles < sms ? tiles : sms, kDotsThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tmap_w, tmap_x, static_cast<bf16*>(y), taps, K, N, stages);
  return static_cast<int>(cudaGetLastError());
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
