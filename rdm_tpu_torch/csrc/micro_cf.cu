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
// the previous output stays in the 50 MB L2 and can beat that bound.  A
// cold device-to-device copy of the same bytes (scripts/micro_cf.py:
// copy_floor_us) is the practical floor of the transposes and the roll
// sum: they move their bytes once and do little else.
//
// Design.
// * Transpose: a warp per 32 x 32 tile (1,296 tiles at the script's
//   shapes), two warps a block (648 blocks, 4 or 5 an SM, all resident at
//   once).  The lanes load the tile's 2 KB with 16-byte loads into the
//   warp's stage in shared memory, the warp transposes it with
//   ldmatrix.x4.trans and stmatrix.x4 (8 x 8 blocks, no 2-byte accesses,
//   no bank conflicts under the swizzle) and the lanes store it with
//   16-byte stores; only __syncwarp orders a warp, no block barrier.  (64
//   x 32 tiles moved by TMA through a ring per warp, one block per SM, ran
//   slower cold, with or without the transposition: what costs is moving
//   the tiles, not transposing them.)
// * Roll sum: one thread per 16-byte chunk of 8 lanes of the flattened
//   array, 256 a block (648 blocks, 4 or 5 an SM, all resident at once).
//   Each warp stages its 32 chunks and two on either side in shared memory
//   as bf16, with no block barrier on the data; each thread reads its
//   neighbours with 16-byte reads, converts the 40 lanes to float once,
//   adds the taps in the order of the shifts in registers and stores its
//   chunk once.  The script's table and L = 81 have a body of their own:
//   the 64 keep-bits of a chunk come from one 8-byte mask per position
//   (81 in shared memory, as two 32-bit words), which ptxas tests with
//   R2P, seven predicates an instruction, instead of 64 compares.  Any
//   other table runs the same arithmetic with the masks compared term by
//   term and each tap chosen by a switch on its shift.
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
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_ptx.cuh"
#include "tma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kSmemLimit = 232448;   // shared memory one block may use on sm_90

// ---------------------------------------------------------------------------
// transpose: a 32 x 32 tile a warp, 16-byte loads and stores, ldmatrix.trans + stmatrix

constexpr int kTransposeTile = 32;   // rows and columns of a tile: 64-byte rows
constexpr int kTransposeWarps = 2;   // warps a block, a tile each

// Byte offset o of a tile whose rows are kSpan bytes (64 or 128), with the
// 16-byte chunks of each 128-byte line permuted by the line's place in a
// group of 8 (or 4) lines, so that 8 rows read or written at one chunk
// column fall on distinct bank groups.
template <int kSpan>
__device__ __forceinline__ int swizzled(int o) {
  return o ^ (((o >> 7) & (kSpan / 16 - 1)) << 4);
}

// One TR x TS tile of x (rows of TS values) into the TS x TR tile of y in
// shared memory: each ldmatrix.x4.trans reads four 8 x 8 blocks, block
// (a, b) of x coming back as the fragment of its transpose, and
// stmatrix.x4 writes that as block (b, a) of y.  Lane l gives the address
// of row l % 8 of block 4 q + l / 8; both sides' eight rows fall on
// distinct 16-byte bank groups under the swizzle.
template <int TR, int TS>
__device__ __forceinline__ void transpose_tile(const unsigned char* in, unsigned char* out,
                                               int lane) {
  constexpr int kOps = TR * TS / 256, kBlocksPerRow = TS / 8;
  unsigned r[kOps][4];
  const int i = lane & 7;
#pragma unroll
  for (int q = 0; q < kOps; ++q) {
    const int blk = 4 * q + (lane >> 3), a = blk / kBlocksPerRow, b = blk % kBlocksPerRow;
    ldmatrix_x4_trans(r[q], in + swizzled<2 * TS>((8 * a + i) * 2 * TS + 16 * b));
  }
#pragma unroll
  for (int q = 0; q < kOps; ++q) {
    const int blk = 4 * q + (lane >> 3), a = blk / kBlocksPerRow, b = blk % kBlocksPerRow;
    stmatrix_x4(r[q], out + swizzled<2 * TR>((8 * b + i) * 2 * TR + 16 * a));
  }
}

// y (S x R) = x (R x S)^T in 32 x 32 tiles; tile t covers x's rows from
// 32 (t / tiles_s) and columns from 32 (t % tiles_s).  Each warp works
// alone on tiles t = w gridDim.x + b, t + 2 gridDim.x, ... (w its warp in
// block b; ops/micro_cf.py: transpose_plan gives one tile a warp): its
// lanes load the tile's 128 16-byte chunks (zeros past the edge) into the
// warp's input stage, the warp transposes it into its output stage, and
// the lanes store the 128 chunks of y's tile that lie inside y.  (Written
// as a loop even for one tile a warp: the same body after an early return
// ran slower cold at the script's shapes.)
__global__ void __launch_bounds__(32 * kTransposeWarps)
transpose_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, int R, int S) {
  constexpr int T = kTransposeTile, kBytes = T * T * 2, kChunks = T * T / 8, kRow = T / 8;
  __shared__ __align__(1024) unsigned char smem[kTransposeWarps][2][kBytes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_s = (S + T - 1) / T, tiles = (R + T - 1) / T * tiles_s;
  unsigned char* in = smem[warp][0];
  unsigned char* out = smem[warp][1];
  for (int t = warp * gridDim.x + blockIdx.x; t < tiles; t += kTransposeWarps * gridDim.x) {
    const int r0 = T * (t / tiles_s), c0 = T * (t % tiles_s);
    uint4 v[kChunks / 32];
#pragma unroll
    for (int it = 0; it < kChunks / 32; ++it) {
      const int q = 32 * it + lane, row = q / kRow, col = c0 + 8 * (q % kRow);
      const bf16* src = x + static_cast<size_t>(r0 + row) * S + col;
      v[it] = r0 + row < R && col < S ? __ldg(reinterpret_cast<const uint4*>(src))
                                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int it = 0; it < kChunks / 32; ++it)
      *reinterpret_cast<uint4*>(in + swizzled<2 * T>(16 * (32 * it + lane))) = v[it];
    __syncwarp();
    transpose_tile<T, T>(in, out, lane);
    __syncwarp();
#pragma unroll
    for (int it = 0; it < kChunks / 32; ++it) {
      const int q = 32 * it + lane, row = q / kRow, col = r0 + 8 * (q % kRow);
      if (c0 + row < S && col < R)
        *reinterpret_cast<uint4*>(y + static_cast<size_t>(c0 + row) * R + col) =
            *reinterpret_cast<const uint4*>(out + swizzled<2 * T>(16 * q));
    }
    __syncwarp();                      // the stages are free for the warp's next tile
  }
}

// ---------------------------------------------------------------------------
// masked lane-roll sum: one thread per 16-byte chunk

constexpr int kRollThreads = 256;
constexpr int kMaxShift = 16;        // a tap reaches at most two chunks to either side
constexpr int kMaxShifts = 16;
constexpr int kScriptL = 81;         // the script's sample and table, the specialised body's
constexpr int kScriptShifts[8] = {-10, -9, -8, -1, 1, 8, 9, 10};

struct Shifts {
  int n;
  int s[kMaxShifts];
};

// For each position p0 in [0, 81) of a chunk's first lane, bit 8 (k % 4) + j
// of word k / 4 is set where lane j keeps tap k of the script's table (the
// launcher fills it).  Two 32-bit words, so that each tap's byte is tested
// in place.
struct ScriptMasks {
  uint2 m[kScriptL];
};

// Tap S of a chunk's eight lanes: w holds lanes 8g - 16 .. 8g + 23 as
// float, p[j] is lane j's position in its sample of L lanes; lane j's term
// is kept where p[j] + S stays in [0, L).
template <int S>
__device__ __forceinline__ void add_tap(float (&acc)[8], const float (&w)[40], const int (&p)[8],
                                        int L) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (S > 0 ? p[j] < L - S : p[j] >= -S) acc[j] += w[16 + j + S];
}

// Tap S for the eight lanes, each kept where its bit 8 B + j of `mask`
// is set: bit tests of one register, which ptxas turns into R2P (seven
// predicates at once).
template <int S, int B>
__device__ __forceinline__ void add_masked_tap(float (&acc)[8], const float (&w)[40],
                                               unsigned mask) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (mask & (1u << (8 * B + j))) acc[j] += w[16 + j + S];
}

// The script's eight taps in its order, tap K kept by byte K % 4 of word
// K / 4 of `mask`.
template <int... K>
__device__ __forceinline__ void script_taps(float (&acc)[8], const float (&w)[40], uint2 mask,
                                            std::integer_sequence<int, K...>) {
  (add_masked_tap<kScriptShifts[K], K % 4>(acc, w, K < 4 ? mask.x : mask.y), ...);
}

// The two bfloat16 values of a 32-bit word as floats, exactly: a bfloat16
// is the upper half of the float of the same value.
__device__ __forceinline__ float2 bf16x2_to_float2(unsigned u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ unsigned pack_bf16_rn(float lo, float hi) {
  const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const unsigned*>(&h);
}

// y = the masked roll sum of x, both C x N and read as chunks of 8 lanes of
// the flattened array (N % L == 0, so a row ends where a sample does and a
// tap that crosses it is masked).  The thread of chunk g loads it, and
// lanes 0-3 of each warp the two chunks on either side of the warp's 32
// (zeros past the array), into the warp's own stage in shared memory; after
// a __syncwarp (no block barrier waits on the data) each thread reads the
// two chunks on either side of its own with 16-byte reads, converts the
// lanes to float once (by bit placement), adds the taps in the order of
// the shifts from 0.0 and writes its chunk, rounded once, with one 16-byte
// store.
// kScript: L = 81 and the script's table; lane j keeps tap k where its bit
// of the mask of its chunk's position p0 = 8g mod 81 is set, the 81
// masks copied to shared memory at the block's start (one barrier, before
// anything waits on the data).  Otherwise L and the shifts are arguments:
// lane j's position follows from p0 = 8g mod L, each term is tested, and
// each tap goes through a switch on its shift, the same for every thread.
template <bool kScript>
__global__ void __launch_bounds__(kRollThreads)
roll_sum_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int chunks, int L,
                Shifts sh, ScriptMasks masks) {
  __shared__ uint4 stage[kRollThreads / 32][36];
  __shared__ uint2 mask_of[kScript ? kScriptL : 1];
  const int tid = threadIdx.x, lane = tid & 31, g = blockIdx.x * kRollThreads + tid;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const uint4 v = g < chunks ? __ldg(x + g) : zero;
  uint4 halo = zero;
  if (lane < 4) {
    // lanes 0-1: the warp's first chunk - 2, - 1; lanes 2-3: its first + 32, + 33
    const int h = lane < 2 ? g - 2 : g + 30;
    if (h >= 0 && h < chunks) halo = __ldg(x + h);
  }
  if constexpr (kScript) {
    if (tid < kScriptL) mask_of[tid] = masks.m[tid];
    __syncthreads();
  }
  uint4* st = stage[tid >> 5];
  st[lane + 2] = v;
  if (lane < 4) st[lane < 2 ? lane : 32 + lane] = halo;
  __syncwarp();
  if (g >= chunks) return;
  const uint4 c[5] = {st[lane], st[lane + 1], v, st[lane + 3], st[lane + 4]};
  float w[40];
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const unsigned words[4] = {c[m].x, c[m].y, c[m].z, c[m].w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float2 f = bf16x2_to_float2(words[h]);
      w[8 * m + 2 * h] = f.x;
      w[8 * m + 2 * h + 1] = f.y;
    }
  }
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
  if constexpr (kScript) {
    script_taps(acc, w, mask_of[8 * (g % kScriptL) % kScriptL],
                std::make_integer_sequence<int, 8>());
  } else {
    int p[8];
    p[0] = 8 * (g % L) % L;
#pragma unroll
    for (int j = 1; j < 8; ++j) p[j] = p[j - 1] + 1 == L ? 0 : p[j - 1] + 1;
#pragma unroll 1
    for (int n = 0; n < sh.n; ++n) {
      switch (sh.s[n]) {
#define RDM_TAP(S) \
  case S:          \
    add_tap<S>(acc, w, p, L); \
    break;
        RDM_TAP(-16) RDM_TAP(-15) RDM_TAP(-14) RDM_TAP(-13) RDM_TAP(-12) RDM_TAP(-11)
        RDM_TAP(-10) RDM_TAP(-9) RDM_TAP(-8) RDM_TAP(-7) RDM_TAP(-6) RDM_TAP(-5) RDM_TAP(-4)
        RDM_TAP(-3) RDM_TAP(-2) RDM_TAP(-1) RDM_TAP(0) RDM_TAP(1) RDM_TAP(2) RDM_TAP(3)
        RDM_TAP(4) RDM_TAP(5) RDM_TAP(6) RDM_TAP(7) RDM_TAP(8) RDM_TAP(9) RDM_TAP(10)
        RDM_TAP(11) RDM_TAP(12) RDM_TAP(13) RDM_TAP(14) RDM_TAP(15) RDM_TAP(16)
#undef RDM_TAP
      }
    }
  }
  y[g] = make_uint4(pack_bf16_rn(acc[0], acc[1]), pack_bf16_rn(acc[2], acc[3]),
                    pack_bf16_rn(acc[4], acc[5]), pack_bf16_rn(acc[6], acc[7]));
}

// The masks of the script's body (see ScriptMasks), made once.
const ScriptMasks& script_masks() {
  static const ScriptMasks masks = [] {
    ScriptMasks t{};
    for (int p0 = 0; p0 < kScriptL; ++p0)
      for (int k = 0; k < 8; ++k)
        for (int j = 0; j < 8; ++j) {
          const int q = (p0 + j) % kScriptL + kScriptShifts[k];
          if (q >= 0 && q < kScriptL) (k < 4 ? t.m[p0].x : t.m[p0].y) |= 1u << (8 * (k % 4) + j);
        }
    return t;
  }();
  return masks;
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

// x (R x S) and y (S x R) are row-major bfloat16 starting on 16-byte
// boundaries; tile, warps and blocks are the plan of ops/micro_cf.py:
// transpose_plan (any number of blocks covers the tiles).  Returns a
// cudaError_t.
int rdm_cf_transpose(const void* x, void* y, int R, int S, int tile, int warps, int blocks,
                     void* stream) {
  const long long tiles = static_cast<long long>((R + kTransposeTile - 1) / kTransposeTile) *
                          ((S + kTransposeTile - 1) / kTransposeTile);
  if (R < 1 || S < 1 || R % 8 != 0 || S % 8 != 0 || tile != kTransposeTile ||
      warps != kTransposeWarps || blocks < 1 || tiles > 0x3fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  transpose_kernel<<<blocks, 32 * kTransposeWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), R, S);
  return static_cast<int>(cudaGetLastError());
}

// x and y are (C x N) row-major bfloat16 starting on 16-byte boundaries;
// shifts holds n_shifts values; script_body and blocks are what
// ops/micro_cf.py's roll_sum_body and roll_sum_plan give: the launch is
// refused where they do not match the arguments.
int rdm_cf_masked_roll_sum(const void* x, void* y, int C, int N, int L, const int* shifts,
                           int n_shifts, int script_body, int blocks, void* stream) {
  const long long chunks = static_cast<long long>(C) * (N / 8);
  if (C < 1 || N < 8 || N % 8 != 0 || L < 1 || N % L != 0 || n_shifts < 0 ||
      n_shifts > kMaxShifts || chunks > 0x7fffffffLL - kRollThreads ||
      blocks != (chunks + kRollThreads - 1) / kRollThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  Shifts sh{};
  sh.n = n_shifts;
  bool script = L == kScriptL && n_shifts == 8;
  for (int j = 0; j < n_shifts; ++j) {
    if (shifts[j] < -kMaxShift || shifts[j] > kMaxShift)
      return static_cast<int>(cudaErrorInvalidValue);
    sh.s[j] = shifts[j];
    script = script && shifts[j] == kScriptShifts[j];
  }
  if ((script_body != 0) != script) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto kernel = script ? roll_sum_kernel<true> : roll_sum_kernel<false>;
  kernel<<<blocks, kRollThreads, 0, st>>>(static_cast<const uint4*>(x), static_cast<uint4*>(y),
                                          static_cast<int>(chunks), L, sh, script_masks());
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
