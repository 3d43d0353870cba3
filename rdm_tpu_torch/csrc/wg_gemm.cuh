// The Hopper GEMM of the tiled bfloat16 bodies (fused_resblock_tiled.cu: both
// convolutions and the NIN; fused_attn_block_tiled.cu: every product of the
// forward and of the backward), and the wgmma and TMA pieces that the tiled
// attention kernels share with it.
//
//   wg_gemm_kernel     C = A B^T on wgmma (bf16 operands, f32 sums).  Each
//                      operand is K-major (K contiguous: rows, or the
//                      weights as N x K) or MN-major (M or N contiguous: a
//                      token-major matrix read along its tokens; TA, TB),
//                      both read by TMA in boxes of 64 values x rows in the
//                      128-byte swizzle; an MN-major box is 64 rows of K, and
//                      wgmma's transpose bit reads it (descriptor: 1024 bytes
//                      between groups of eight K rows, 8192 between the
//                      64-wide boxes along M or N).  Persistent: block b
//                      walks the units (M tile, N tile, K split) b, b + grid,
//                      ...; one producer warp keeps TMA loads of a 128-row A
//                      tile and a BN-column B tile in flight through a ring of
//                      stages counted on full and empty mbarriers; two
//                      consumer warpgroups each take 64 rows of the 128-row
//                      tile with a 64 x BN accumulator (wgmma.m64nBNk16, both
//                      operands by shared-memory descriptor).  K runs in
//                      stages of 64: tap-major (9 taps x ceil(C / 64) channel
//                      chunks) for the 3x3 convolution, whose A box is a 4-D
//                      box of the NHWC activations (64 channels x W x nh image
//                      rows x nb samples) placed at the tap's shift: TMA reads
//                      zeros outside the image and for channels past C, so the
//                      implicit GEMM spends no instruction on indices.  A conv
//                      tile is nh whole image rows of one sample or nb whole
//                      samples, so its rows are one contiguous run of output
//                      rows (H 9: 81 of the 128 rows carry tokens).  Other
//                      operands are 3-D maps (64-value axis, rows, samples):
//                      a batched product (the attention's per-sample dq, dk,
//                      dv) takes its M tiles within one sample and reads both
//                      operands at that sample; a product whose K runs over
//                      tokens (the weight gradients) takes its stages as
//                      (sample, 64 tokens), the map's bound at L reading the
//                      padded tokens as zeros, so no buffer needs clearing.
//   wg_splitk_kernel   where the tiles alone cannot fill the card (H 8, H 4),
//                      K is split on stage boundaries: each split writes its
//                      float32 partial tile, and this kernel sums the partials
//                      in split order (fixed, so two runs agree bit for bit)
//                      and runs the same epilogue.
//
// The consumers round a finished tile into shared memory and go on to the
// next tile's products; four epilogue warps store it meanwhile (mbarriers
// "staged" and "freed" pass the one staging buffer between them).
//
// Epilogues, with the TPU kernel's rounding points (those of the plain
// versions), in order: the sum is rounded, + bias[n] rounded (the bias kept in
// shared memory), + temb[sample, n] rounded (a tile's temb rows fetched into
// shared memory before its products); kWgRow stores token-major rows, kWgNchw
// NCHW (sample, n, l), kWgResidual adds the NCHW residual and multiplies by
// rescale, each rounded, into NCHW.  The tile goes through shared memory and
// out in 16-byte stores (along n for rows, along l for NCHW, the residual read
// the same way).  kWgF32 stores the float32 sums NCHW from the registers
// (a lane's 8-token column runs are whole 32-byte sectors); kWgPartial
// always writes float32 partials [split][M + 1][N] (the caller sums them in
// split order), row M the column sums of an MN-major B
// over the split's K (the bias gradients: B summed over tokens, taken from
// the staged B tiles by the units of M tile 0, each thread's rows in order,
// so the sum's order is fixed).
//
// Bound on this card: the convolutions do 64-600 operations a byte, so the
// tensor cores bound them; the ring keeps the loads behind the products and
// the epilogue warps put one tile's stores under the next one's products.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "groupnorm.cuh"
#include "smem_attr.cuh"
#include "tma.cuh"

namespace {

constexpr int kWgBM = 128;                   // rows of a tile: two warpgroups of 64
constexpr int kWgAStage = kWgBM * 128;       // bytes of the A box of a stage
constexpr int kWgConsumers = 256;            // two consumer warpgroups
constexpr int kWgEpilogue = 128;             // four warps that store the staged tiles
constexpr int kWgThreads = kWgConsumers + 32 + kWgEpilogue;   // and a producer warp
constexpr int kWgSms = 132;                  // persistent blocks at most (the H100 SXM's SMs):
                                             // a constant, so the plan and the split-K sums
                                             // are the same on every card
constexpr int kWgMaxSplits = 16;
constexpr int kWgMaxN = 1024;                // columns of a product at most (bias in shared memory)
constexpr int kWgTembMax = 8192;             // temb values of a tile's samples kept in shared memory

// d (the warpgroup's 64 x 8 NT float accumulators, mma.sync's C layout for
// each 8 columns) += A (64 x 16) B^T (B: 8 NT x 16), both bf16 from shared
// memory by descriptor; TA / TB: the operand is MN-major (wgmma's transpose
// bit).  Asynchronous: wg_fence before, wg_commit and wg_wait after.
template <int TA, int TB>
__device__ __forceinline__ void wg_ss(float (&d)[8][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wg_ss(float (&d)[16][4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 64) += a (the warp's 16 x 16 bf16 fragment in registers, in
// mma.sync's A layout) B (16 x 64, N-major: 128-byte rows along N,
// imm-trans-b 1).
__device__ __forceinline__ void wg_rs_t(float (&d)[8][4], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The descriptor of a staged operand box for product step k16 (16 of K): a
// K-major box of 128-byte rows (rows along M or N) advances 32 bytes along
// the rows; an MN-major box (rows along K) advances 16 rows, its 64-wide
// boxes along M or N 8192 bytes apart.
template <int MN>
__device__ __forceinline__ uint64_t wg_desc(const unsigned char* box, int k16) {
  return MN ? sw128_desc(box + 2048 * k16, 8192, 1024) : sw128_desc(box + 32 * k16, 16, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N groups of this warpgroup's products are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int NT>
__device__ __forceinline__ void wg_fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A bf16 tensor map of rank 2 to 4 (dims innermost first, byte strides of
// dims 1 .. rank - 1, each a multiple of 16) read in boxes whose innermost
// side is 64 values in the 128-byte swizzle (tma.cuh's layout); cells outside
// the tensor, negative coordinates included, read as zeros.
bool wg_tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major bf16 matrix as a 3-D map (cols, rows, samples): rows ld values
// apart, a sample every rps rows, `rows` of each real (the rest, and columns
// past cols, read as zeros); boxes of 64 values x box_rows rows of one sample.
bool wg_rows_map(CUtensorMap* map, const bf16* p, int cols, long long ld, int rows,
                 long long rps, int samples, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(samples)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * 2,
                                 static_cast<cuuint64_t>(ld) * 2 * rps};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  return wg_tensor_map(map, p, 3, dims, strides, box);
}

// The weights w (N x K row-major bf16: taps of K each where taps > 1) as the
// K-major B map of a product: 3-D (K of a tap, taps, N), boxes 64 x 1 x bn.
bool wg_weight_map(CUtensorMap* map, const bf16* w, int N, int K, int taps, int bn) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(taps),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(K) * 2,
                                 static_cast<cuuint64_t>(K) * 2 * taps};
  const cuuint32_t box[3] = {64, 1, static_cast<cuuint32_t>(bn)};
  return wg_tensor_map(map, w, 3, dims, strides, box);
}

enum WgOut : int { kWgRow = 0, kWgNchw = 1, kWgResidual = 2, kWgF32 = 3, kWgPartial = 4 };

// Where the tile goes.  Output row m is token l = m % rps of sample m / rps;
// only tokens l < valid are written (the attention's rows are padded to 16).
// kWgRow: out + m ld + n.  kWgNchw, kWgResidual: out + (sample N + n) valid
// + l, the residual at the same place of the NCHW tensor res; kWgF32 the same
// place of outf.
struct WgEpi {
  int kind;
  bf16* out;
  float* outf;
  long long ld;
  const bf16* bias;   // [N] or null
  const bf16* temb;   // [samples, N] or null
  int rps, valid;
  const bf16* res;
  float rescale;
};

struct WgArgs {
  int M, N;               // output rows and columns
  int conv;               // 1: A is the 3x3 neighbourhood of an NHWC image
  int B, H, W, nh, nb;    // conv: the images; a tile's image rows and samples
  int tiles_h;            // conv: tiles along H of a group of nb samples
  int cchunks, taps;      // a tap's 64-channel chunks; 9 taps or 1
  int steps;              // stages of K
  int kpb;                // 3-D maps: stage q reads K rows 64 (q % kpb) of sample q / kpb
  int mtps;               // > 0: batched, M tiles of a sample (its rows from sample * rps)
  int colsum;             // kWgPartial: row M of each partial = B's column sums
  int chunk, splits;      // split-K: stages of a split, and their number
  int tiles_m, tiles_n;
  int a_bytes, b_bytes;   // bytes of the A and B boxes of a stage
  float* partial;         // splits > 1 or kWgPartial: float32 partials [split][M + colsum][N]
  WgEpi e;
};

template <int BN>
struct WgShape {
  static constexpr int NT = BN / 8;
  static constexpr int kStage = kWgAStage + BN * 128;
  static constexpr int kStages = BN == 128 ? 5 : 6;
  static constexpr int kPitchRow = BN + 8;       // staged row-major tile: 128 x BN
  static constexpr int kPitchCol = kWgBM + 8;    // staged NCHW tile: BN x 128
  static constexpr int kStaging =
      (kWgBM * kPitchRow > BN * kPitchCol ? kWgBM * kPitchRow : BN * kPitchCol) * 2;
  static constexpr int kSmem =
      1024 + kStages * kStage + kStaging + 2 * (kWgMaxN + kWgTembMax) + (2 * kStages + 2) * 8;
};

// The first output row of tile mt and its row count; the tile's A box sits
// at image row y0 of sample b0 (conv), at row y0 of sample b0 (batched), or
// at row y0 = m_base.
__host__ __device__ inline void wg_tile_rows(const WgArgs& g, int mt, int& m_base, int& rows,
                                             int& y0, int& b0) {
  if (g.conv) {
    const int bg = mt / g.tiles_h, yg = mt - bg * g.tiles_h;
    b0 = bg * g.nb;
    y0 = yg * g.nh;
    m_base = (b0 * g.H + y0) * g.W;
    rows = g.nb == 1 ? (g.H - y0 < g.nh ? g.H - y0 : g.nh) * g.W
                     : (g.B - b0 < g.nb ? g.B - b0 : g.nb) * g.H * g.W;
  } else if (g.mtps > 0) {
    b0 = mt / g.mtps;
    y0 = (mt - b0 * g.mtps) * kWgBM;
    m_base = b0 * g.e.rps + y0;
    rows = g.e.rps - y0 < kWgBM ? g.e.rps - y0 : kWgBM;
  } else {
    b0 = 0;
    y0 = m_base = mt * kWgBM;
    rows = g.M - m_base < kWgBM ? g.M - m_base : kWgBM;
  }
}

// Unit u: N tile fastest (the blocks that share an A tile run together),
// then M tile, then the split; its stages are [q0, q1).
__device__ __forceinline__ void wg_unit(const WgArgs& g, int u, int& mt, int& nt, int& sp,
                                        int& q0, int& q1) {
  nt = u % g.tiles_n;
  const int rest = u / g.tiles_n;
  mt = rest % g.tiles_m;
  sp = rest / g.tiles_m;
  q0 = sp * g.chunk;
  q1 = q0 + g.chunk < g.steps ? q0 + g.chunk : g.steps;
}

// Output (m, n) rounded before it is stored: T(T(T(v) + bias) + temb).
__device__ __forceinline__ float wg_value(const WgEpi& e, int N, int m, int n, float v) {
  float r = rbf(v);
  if (e.bias) r = rbf(r + bf(e.bias[n]));
  if (e.temb) r = rbf(r + bf(e.temb[static_cast<long long>(m / e.rps) * N + n]));
  return r;
}

// Put the value of tile row r, tile column c into the staging tile (KIND:
// the epilogue's WgOut, fixed when the kernel is built).
template <int BN, int KIND>
__device__ __forceinline__ void wg_stage(bf16* stg, int r, int c, float v) {
  if constexpr (KIND == kWgRow) stg[r * WgShape<BN>::kPitchRow + c] = __float2bfloat16(v);
  else stg[c * WgShape<BN>::kPitchCol + r] = __float2bfloat16(v);
}

__device__ __forceinline__ float wg_residual(const WgEpi& e, float res, float r) {
  return rbf(rbf(res + r) * e.rescale);
}

// Stage a warpgroup's accumulator fragment (the thread's rows rbase and
// rbase + 8 of the tile, columns n0 + 8 j + 2 q + {0, 1}) rounded as
// wg_value rounds, bias from bias_s (all N columns) and temb from temb_s (the
// tile's samples s_first .. as rows of BN) where temb_s is not null, else
// from device memory.
template <int BN, int KIND>
__device__ __forceinline__ void wg_stage_acc(const WgEpi& e, int N, bf16* stg, const bf16* bias_s,
                                             const bf16* temb_s, int s_first, int m_base,
                                             int rows, int n0, int rbase, int q,
                                             const float (&acc)[BN / 8][4]) {
  constexpr int NT = BN / 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rbase + 8 * h;
    if (r >= rows) continue;
    const int sample = (m_base + r) / e.rps;
    const bf16* tr = temb_s != nullptr ? temb_s + (sample - s_first) * BN - n0
                                       : e.temb + static_cast<long long>(sample) * N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * q, n = n0 + c;
      if (n >= N) continue;
      float v0 = rbf(acc[j][2 * h]), v1 = rbf(acc[j][2 * h + 1]);
      if (e.bias != nullptr) {
        const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(bias_s + n);
        v0 = rbf(v0 + __low2float(bv));
        v1 = rbf(v1 + __high2float(bv));
      }
      if (e.temb != nullptr) {
        const __nv_bfloat162 tv = *reinterpret_cast<const __nv_bfloat162*>(tr + n);
        v0 = rbf(v0 + __low2float(tv));
        v1 = rbf(v1 + __high2float(tv));
      }
      if constexpr (KIND == kWgRow) {
        // both values are bf16 already: one 4-byte store
        *reinterpret_cast<__nv_bfloat162*>(stg + r * WgShape<BN>::kPitchRow + c) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        wg_stage<BN, KIND>(stg, r, c, v0);
        wg_stage<BN, KIND>(stg, r, c + 1, v1);
      }
    }
  }
}

// Store the staged tile (rows m_base .. m_base + rows - 1 of at most
// tile_rows, columns n0 ..): 16-byte chunks along n (kWgRow) or along l
// (NCHW, where 8 rows of the chunk are 8 tokens of one sample on a 16-byte
// boundary; single values otherwise).  `tid` counts the `nthr` threads that
// share the work; NCHW chunks go four at a time, their residual loads first.
template <int BN, int KIND>
__device__ void wg_store(const WgEpi& e, const bf16* stg, int N, int m_base, int rows, int n0,
                         int tid, int nthr, int tile_rows) {
  using S = WgShape<BN>;
  if constexpr (KIND == kWgRow) {
    for (int q = tid; q < tile_rows * (BN / 8); q += nthr) {
      const int r = q / (BN / 8), c = (q - r * (BN / 8)) * 8, n = n0 + c;
      if (r >= rows || n >= N) continue;
      const int m = m_base + r;
      if (m % e.rps >= e.valid) continue;
      *reinterpret_cast<uint4*>(e.out + static_cast<long long>(m) * e.ld + n) =
          *reinterpret_cast<const uint4*>(stg + r * S::kPitchRow + c);
    }
    return;
  }
  const bool vec = e.rps == e.valid && e.valid % 8 == 0 && m_base % 8 == 0;
  const int chunks = BN * (tile_rows / 8);
  for (int q0 = tid; q0 < chunks; q0 += 4 * nthr) {
    long long at[4];
    bool fast[4];
    uint4 rv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = q0 + k * nthr;
      const int c = q / (tile_rows / 8), r0 = (q - c * (tile_rows / 8)) * 8;
      fast[k] = vec && q < chunks && r0 + 8 <= rows && n0 + c < N;
      at[k] = 0;
      if (fast[k]) {
        const int m = m_base + r0, sample = m / e.rps, l = m - sample * e.rps;
        at[k] = (static_cast<long long>(sample) * N + n0 + c) * e.valid + l;
        if constexpr (KIND == kWgResidual) rv[k] = *reinterpret_cast<const uint4*>(e.res + at[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = q0 + k * nthr;
      if (q >= chunks) break;
      const int c = q / (tile_rows / 8), r0 = (q - c * (tile_rows / 8)) * 8, n = n0 + c;
      if (r0 >= rows || n >= N) continue;
      const bf16* src = stg + c * S::kPitchCol + r0;
      if (fast[k]) {
        uint4 u = *reinterpret_cast<const uint4*>(src);
        if constexpr (KIND == kWgResidual) {
          const bf16* a = reinterpret_cast<const bf16*>(&u);
          const bf16* b = reinterpret_cast<const bf16*>(&rv[k]);
          uint4 o;
          unsigned* op = reinterpret_cast<unsigned*>(&o);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            op[i] = pack_bf16(wg_residual(e, bf(b[2 * i]), bf(a[2 * i])),
                              wg_residual(e, bf(b[2 * i + 1]), bf(a[2 * i + 1])));
          u = o;
        }
        *reinterpret_cast<uint4*>(e.out + at[k]) = u;
        continue;
      }
      for (int i = 0; i < 8 && r0 + i < rows; ++i) {
        const int m = m_base + r0 + i, sample = m / e.rps, l = m - sample * e.rps;
        if (l >= e.valid) continue;
        const long long p = (static_cast<long long>(sample) * N + n) * e.valid + l;
        float v = bf(src[i]);
        if constexpr (KIND == kWgResidual) v = wg_residual(e, bf(e.res[p]), v);
        e.out[p] = __float2bfloat16(v);
      }
    }
  }
}

// Element (K row r, column n) of an MN-major tile staged as 64-column boxes of
// 64 rows in the 128-byte swizzle (chunk j of row r at j ^ (r % 8)).
__device__ __forceinline__ float wg_mn_at(const unsigned char* tile, int r, int n) {
  const int nn = n & 63;
  return bf(*reinterpret_cast<const bf16*>(tile + (n >> 6) * 8192 + r * 128 +
                                           ((((nn >> 3) ^ r) & 7) << 4) + (nn & 7) * 2));
}

// grid: min(units, kWgSms) persistent blocks of kWgThreads, WgShape<BN>::kSmem
// bytes of dynamic shared memory.  amap: the A operand (conv: 4-D NHWC, boxes
// 64 x W x nh x nb; K-major: 3-D (K, rows, samples), boxes 64 x 128 x 1;
// MN-major: 3-D (M, K, samples), boxes 64 x 64 x 1, two a stage); bmap:
// K-major, the weights as 3-D (K of a tap, taps, N), boxes 64 x 1 x BN;
// MN-major, 3-D (N, K, samples), boxes 64 x 64 x 1, BN / 64 a stage.
template <int BN, int KIND, int TA, int TB>
__global__ void __launch_bounds__(kWgThreads, 1)
wg_gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
               const WgArgs g) {
  using S = WgShape<BN>;
  constexpr int NT = S::NT, kStages = S::kStages;
  constexpr bool kDirect = KIND == kWgF32 || KIND == kWgPartial;   // no staged epilogue
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* stg = reinterpret_cast<bf16*>(ring + kStages * S::kStage);
  bf16* bias_s = stg + S::kStaging / 2;
  bf16* temb_s = bias_s + kWgMaxN;
  uint64_t* full = reinterpret_cast<uint64_t*>(temb_s + kWgTembMax);
  uint64_t* empty = full + kStages;
  uint64_t* staged = empty + kStages;          // the consumers have staged a tile
  uint64_t* freed = staged + 1;                // the epilogue warps have stored it
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = g.tiles_m * g.tiles_n * g.splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);                 // one arrival per consumer warp
    }
    mbar_init(staged, kWgConsumers);
    mbar_init(freed, kWgEpilogue);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {
    // Producer: every stage of every unit of this block, in order.
    if (lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int mt, nt, sp, q0, q1, m_base, rows, y0, b0;
        wg_unit(g, u, mt, nt, sp, q0, q1);
        wg_tile_rows(g, mt, m_base, rows, y0, b0);
        for (int q = q0; q < q1; ++q, ++it) {
          const int slot = it % kStages;
          if (it >= kStages) mbar_wait(empty + slot, ((it / kStages) - 1) & 1);
          unsigned char* st = ring + slot * S::kStage;
          const int tap = q / g.cchunks, cc = q - tap * g.cchunks;
          // 3-D maps: K rows k1 .. k1 + 63 of sample kz
          const int kq = q / g.kpb, k1 = 64 * (q - kq * g.kpb), kz = kq + b0;
          mbar_expect_tx(full + slot, g.a_bytes + g.b_bytes);
          if (g.conv) {
            tma_load_4d(st, &amap, 64 * cc, tap % 3 - 1, y0 + tap / 3 - 1, b0, full + slot);
          } else if (TA) {
            tma_load_3d(st, &amap, y0, k1, kz, full + slot);
            tma_load_3d(st + 8192, &amap, y0 + 64, k1, kz, full + slot);
          } else {
            tma_load_3d(st, &amap, k1, y0, kz, full + slot);
          }
          if (TB) {
            for (int i = 0; i < BN / 64; ++i)
              tma_load_3d(st + kWgAStage + i * 8192, &bmap, nt * BN + 64 * i, k1, kz, full + slot);
          } else {
            tma_load_3d(st + kWgAStage, &bmap, 64 * cc, tap, nt * BN, full + slot);
          }
        }
      }
    }
    return;
  }

  if (warp > 8) {
    // Epilogue warps: store each staged tile while the consumers run the
    // next one's products (none with a split or a direct epilogue: the
    // consumers write those).
    if constexpr (!kDirect) {
      if (g.splits > 1) return;
      int t = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++t) {
        int mt, nt, sp, q0, q1, m_base, rows, y0, b0;
        wg_unit(g, u, mt, nt, sp, q0, q1);
        wg_tile_rows(g, mt, m_base, rows, y0, b0);
        mbar_wait(staged, t & 1);
        wg_store<BN, KIND>(g.e, stg, g.N, m_base, rows, nt * BN, threadIdx.x - kWgConsumers - 32,
                           kWgEpilogue, kWgBM);
        mbar_arrive(freed);
      }
    }
    return;
  }

  // Consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of each tile.
  // The bias goes to shared memory once; each tile's temb rows (its samples'
  // BN columns, 16 bytes a copy) are fetched before its products, so their
  // latency hides under them.
  const int wg = warp >> 2, tid = threadIdx.x;
  if (g.e.bias != nullptr)
    for (int i = tid; i < g.N; i += kWgConsumers) bias_s[i] = g.e.bias[i];
  const int temb_rows = g.conv ? g.nb : (kWgBM + g.e.rps - 1) / g.e.rps + 1;
  const bool temb_smem = g.e.temb != nullptr && temb_rows * BN <= kWgTembMax;
  const long long plane = static_cast<long long>(g.M + g.colsum) * g.N;
  // kWgPartial with colsum: in the units of M tile 0 thread tid sums column
  // tid % BN of B over its kCsumRows rows of each stage, in order
  constexpr int kCsumRows = 64 * BN / kWgConsumers;
  int it = 0, t = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++t) {
    int mt, nt, sp, q0, q1, m_base, rows, y0, b0;
    wg_unit(g, u, mt, nt, sp, q0, q1);
    wg_tile_rows(g, mt, m_base, rows, y0, b0);
    const int s_first = m_base / g.e.rps;
    if (t == 0 || temb_smem)
      named_sync(1, kWgConsumers);             // bias_s written; temb_s read by the last tile
    if (temb_smem && g.splits == 1) {
      const int s_count = (m_base + rows - 1) / g.e.rps - s_first + 1;
      for (int i = tid; i < s_count * (BN / 8); i += kWgConsumers) {
        const int sr = i / (BN / 8), n = nt * BN + (i - sr * (BN / 8)) * 8;
        if (n < g.N)
          cp_async16(temb_s + sr * BN + n - nt * BN,
                     g.e.temb + static_cast<long long>(s_first + sr) * g.N + n);
      }
    }
    const bool csum_unit = KIND == kWgPartial && TB && g.colsum && mt == 0;
    float csum = 0.f;
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    wg_fence_acc(acc);
    int prev = -1;
    for (int q = q0; q < q1; ++q, ++it) {
      const int slot = it % kStages;
      mbar_wait(full + slot, (it / kStages) & 1);
      __syncwarp();                            // wgmma is warp-aligned
      wg_fence();
      const unsigned char* st = ring + slot * S::kStage;
#pragma unroll
      for (int k16 = 0; k16 < 4; ++k16)
        wg_ss<TA, TB>(acc, wg_desc<TA>(st + wg * 8192, k16), wg_desc<TB>(st + kWgAStage, k16));
      wg_commit();
      if (csum_unit) {
        const int r0 = (tid / BN) * kCsumRows;
        for (int r = r0; r < r0 + kCsumRows; ++r) csum += wg_mn_at(st + kWgAStage, r, tid % BN);
      }
      wg_wait<1>();                            // the stage before this one is read
      if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);
      prev = slot;
    }
    wg_wait<0>();
    wg_fence_acc(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(empty + prev);

    // Epilogue.  Fragment (n-tile j, e): row 16 (warp % 4) + lane / 4 + 8 (e / 2)
    // of the warpgroup's 64, column 8 j + 2 (lane % 4) + e % 2.
    const int n0 = nt * BN;
    const int rbase = 64 * wg + 16 * (warp & 3) + (lane >> 2);
    if (g.splits > 1 || KIND == kWgPartial) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + 8 * h, n = n0 + 8 * j + 2 * (lane & 3);
          if (r < rows && n < g.N)
            *reinterpret_cast<float2*>(g.partial + sp * plane +
                                       static_cast<long long>(m_base + r) * g.N + n) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        }
      if (csum_unit) {
        // each column's groups of rows in order, through stg (unused here)
        float* red = reinterpret_cast<float*>(stg);
        named_sync(2, kWgConsumers);           // the last unit's sums are read
        red[tid] = csum;
        named_sync(2, kWgConsumers);
        if (tid < BN && n0 + tid < g.N) {
          float s = 0.f;
          for (int i = 0; i < kWgConsumers / BN; ++i) s += red[i * BN + tid];
          g.partial[sp * plane + static_cast<long long>(g.M) * g.N + n0 + tid] = s;
        }
      }
      continue;
    }
    if constexpr (KIND == kWgF32) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + 8 * h, n = n0 + 8 * j + 2 * (lane & 3), m = m_base + r;
          const int sample = m / g.e.rps, l = m - sample * g.e.rps;
          if (r < rows && n < g.N && l < g.e.valid) {
            float* p = g.e.outf + (static_cast<long long>(sample) * g.N + n) * g.e.valid + l;
            p[0] = acc[j][2 * h];
            p[g.e.valid] = acc[j][2 * h + 1];
          }
        }
    } else if constexpr (!kDirect) {
      if (temb_smem) {
        cp_async_wait();
        named_sync(1, kWgConsumers);           // every thread's temb copies have landed
      }
      if (t > 0) mbar_wait(freed, (t - 1) & 1);   // the last tile is stored: stg is free
      wg_stage_acc<BN, KIND>(g.e, g.N, stg, bias_s, temb_smem ? temb_s : nullptr, s_first,
                             m_base, rows, n0, rbase, lane & 3, acc);
      mbar_arrive(staged);
    }
  }
}

// The split-K sum and epilogue: one block of 256 threads a slice of
// kSliceRows rows of a (M tile, N tile), so the card holds enough blocks;
// out(m, n) = the epilogue of sum over s of partial[s][m][n], in order of s.
constexpr int kSliceRows = 16;

template <int BN, int KIND>
__global__ void __launch_bounds__(256) wg_splitk_kernel(const WgArgs g) {
  __shared__ __align__(16) bf16 stg[WgShape<BN>::kStaging / 2];
  constexpr int kSlices = kWgBM / kSliceRows;
  const int slice = blockIdx.x % kSlices, tile = blockIdx.x / kSlices;
  const int nt = tile % g.tiles_n, mt = tile / g.tiles_n;
  int m_base, rows, y0, b0;
  wg_tile_rows(g, mt, m_base, rows, y0, b0);
  m_base += slice * kSliceRows;
  rows -= slice * kSliceRows;
  if (rows <= 0) return;
  if (rows > kSliceRows) rows = kSliceRows;
  const int n0 = nt * BN;
  const long long plane = static_cast<long long>(g.M) * g.N;
  for (int q = threadIdx.x; q < kSliceRows * BN; q += blockDim.x) {
    const int r = q / BN, c = q - r * BN, n = n0 + c;
    if (r >= rows || n >= g.N) continue;
    const int m = m_base + r;
    const float* p = g.partial + static_cast<long long>(m) * g.N + n;
    // the partials in split order, loaded four ahead of the sums
    float t = p[0];
    int s = 1;
    for (; s + 3 < g.splits; s += 4) {
      const float a0 = p[s * plane], a1 = p[(s + 1) * plane], a2 = p[(s + 2) * plane],
                  a3 = p[(s + 3) * plane];
      t += a0;
      t += a1;
      t += a2;
      t += a3;
    }
    for (; s < g.splits; ++s) t += p[s * plane];
    wg_stage<BN, KIND>(stg, r, c, wg_value(g.e, g.N, m, n, t));
  }
  __syncthreads();
  wg_store<BN, KIND>(g.e, stg, g.N, m_base, rows, n0, threadIdx.x, blockDim.x, kSliceRows);
}

// The launch plan of one product: tiles, the split of K, the persistent
// blocks, the ring and the shared memory; the A box (conv: (64, W, nh, nb);
// K-major (64, 128, 1, 1); MN-major (64, 64, 1, 1), two a stage).
struct WgPlan {
  int bm, bn, tiles_m, tiles_n, steps, chunk, splits, blocks, stages, smem;
  int box[4];
};

// K split: only where the tiles fill less than half the card; then as many
// splits as the card has room for, at most max_splits, each a whole number
// of stages.
inline void wg_split(int tiles, int steps, int max_splits, int& chunk, int& splits) {
  int s = 1;
  if (2 * tiles < kWgSms) {
    s = kWgSms / tiles;
    if (s > max_splits) s = max_splits;
    if (s > steps) s = steps;
  }
  chunk = (steps + s - 1) / s;
  splits = (steps + chunk - 1) / chunk;
}

inline int wg_bn(int N) { return N >= 128 ? 128 : 64; }

// The plan once g's M tiles and stages are set: N tiles, the split, blocks.
inline WgPlan wg_finish_plan(WgArgs& g, int max_splits, int b0, int b1, int b2, int b3) {
  WgPlan p{};
  const int bn = wg_bn(g.N);
  g.tiles_n = (g.N + bn - 1) / bn;
  g.b_bytes = bn * 128;
  wg_split(g.tiles_m * g.tiles_n, g.steps, max_splits, g.chunk, g.splits);
  const int units = g.tiles_m * g.tiles_n * g.splits;
  p.bm = kWgBM;
  p.bn = bn;
  p.tiles_m = g.tiles_m;
  p.tiles_n = g.tiles_n;
  p.steps = g.steps;
  p.chunk = g.chunk;
  p.splits = g.splits;
  p.blocks = units < kWgSms ? units : kWgSms;
  p.stages = bn == 128 ? WgShape<128>::kStages : WgShape<64>::kStages;
  p.smem = bn == 128 ? WgShape<128>::kSmem : WgShape<64>::kSmem;
  p.box[0] = b0, p.box[1] = b1, p.box[2] = b2, p.box[3] = b3;
  return p;
}

// Fill g's geometry for an M x N product with K-major operands: conv (B
// images of H x H, channels c: M = B H H, K = 9 c) or plain (K = c).
inline WgPlan wg_plan(WgArgs& g, int conv, int B, int H, int M, int N, int c) {
  g.M = M;
  g.N = N;
  g.conv = conv;
  g.cchunks = (c + 63) / 64;
  g.taps = conv ? 9 : 1;
  g.steps = g.kpb = g.taps * g.cchunks;
  if (!conv) {
    g.tiles_m = (M + kWgBM - 1) / kWgBM;
    g.a_bytes = kWgAStage;
    return wg_finish_plan(g, kWgMaxSplits, 64, kWgBM, 1, 1);
  }
  g.B = B;
  g.H = g.W = H;
  if (H * H <= kWgBM) {
    g.nh = H;
    g.nb = kWgBM / (H * H);
  } else {
    g.nh = kWgBM / H;
    g.nb = 1;
  }
  g.tiles_h = (H + g.nh - 1) / g.nh;
  g.tiles_m = (B + g.nb - 1) / g.nb * g.tiles_h;
  g.a_bytes = 128 * H * g.nh * g.nb;
  return wg_finish_plan(g, kWgMaxSplits, 64, H, g.nh, g.nb);
}

// The geometry of a product read through 3-D maps: M x N outputs over `steps`
// stages of K 64, stage q at K rows 64 (q % kpb) of sample q / kpb; batched
// (mtps > 0: steps = kpb): mtps M tiles a sample, each reading both operands
// at its sample; A MN-major (ta) or K-major; K split in at most max_splits.
inline WgPlan wg_plan_rows(WgArgs& g, int M, int N, int steps, int kpb, int mtps, int samples,
                           int ta, int max_splits) {
  g.M = M;
  g.N = N;
  g.conv = 0;
  g.taps = 1;
  g.cchunks = g.steps = steps;
  g.kpb = kpb;
  g.mtps = mtps;
  g.tiles_m = mtps > 0 ? mtps * samples : (M + kWgBM - 1) / kWgBM;
  g.a_bytes = kWgAStage;
  return wg_finish_plan(g, max_splits, 64, ta ? 64 : kWgBM, 1, 1);
}

// Floats of the partials a product with this plan needs (0 without a split;
// kWgPartial: always, with its column-sum row when colsum).
inline long long wg_partial_floats(const WgPlan& p, int M, int N, int partial = 0,
                                   int colsum = 0) {
  return p.splits > 1 || partial ? static_cast<long long>(p.splits) * (M + colsum) * N : 0;
}

inline long long wg_partial_bytes(const WgPlan& p, int M, int N) {
  return 4 * wg_partial_floats(p, M, N);
}

template <int BN, int KIND, int TA, int TB>
cudaError_t wg_launch(const CUtensorMap& amap, const CUtensorMap& bmap, const WgArgs& g,
                      const WgPlan& p, cudaStream_t s) {
  static SmemAttr attr;
  cudaError_t err = attr.apply(reinterpret_cast<const void*>(wg_gemm_kernel<BN, KIND, TA, TB>),
                               WgShape<BN>::kSmem);
  if (err != cudaSuccess) return err;
  wg_gemm_kernel<BN, KIND, TA, TB><<<p.blocks, kWgThreads, WgShape<BN>::kSmem, s>>>(amap, bmap,
                                                                                   g);
  if constexpr (KIND == kWgF32 || KIND == kWgPartial) {
    return err;   // never summed here: kWgF32 is not split, kWgPartial's caller sums
  } else {
    if (err != cudaSuccess || g.splits == 1) return err;
    wg_splitk_kernel<BN, KIND><<<g.tiles_m * g.tiles_n * (kWgBM / kSliceRows), 256, 0, s>>>(g);
    return cudaGetLastError();
  }
}

// The product out = epilogue(A B^T) with K-major operands: A (conv: NHWC B x
// H x H x c; plain: M x c row-major), B = w as (N, taps, c) row-major.
// partial: float32 scratch of wg_partial_bytes (null without a split).
// e.kind: kWgRow, kWgNchw or kWgResidual.
inline cudaError_t wg_gemm(const bf16* a, const bf16* w, int conv, int B, int H, int M, int N,
                           int c, const WgEpi& e, float* partial, cudaStream_t s) {
  WgArgs g{};
  g.e = e;
  const WgPlan p = wg_plan(g, conv, B, H, M, N, c);
  g.partial = partial;
  if ((g.splits > 1 && partial == nullptr) || N > kWgMaxN) return cudaErrorInvalidValue;
  CUtensorMap amap, bmap;
  bool ok;
  if (conv) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c) * 2,
                                   static_cast<cuuint64_t>(c) * 2 * H,
                                   static_cast<cuuint64_t>(c) * 2 * H * H};
    const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(H), static_cast<cuuint32_t>(g.nh),
                               static_cast<cuuint32_t>(g.nb)};
    ok = wg_tensor_map(&amap, a, 4, dims, strides, box);
  } else {
    ok = wg_rows_map(&amap, a, c, c, M, M, 1, kWgBM);
  }
  ok = ok && wg_weight_map(&bmap, w, N, c, g.taps, p.bn);
  if (!ok) return cudaErrorInvalidValue;
  switch (e.kind * 2 + (p.bn == 128)) {
    case kWgRow * 2: return wg_launch<64, kWgRow, 0, 0>(amap, bmap, g, p, s);
    case kWgRow * 2 + 1: return wg_launch<128, kWgRow, 0, 0>(amap, bmap, g, p, s);
    case kWgNchw * 2: return wg_launch<64, kWgNchw, 0, 0>(amap, bmap, g, p, s);
    case kWgNchw * 2 + 1: return wg_launch<128, kWgNchw, 0, 0>(amap, bmap, g, p, s);
    case kWgResidual * 2: return wg_launch<64, kWgResidual, 0, 0>(amap, bmap, g, p, s);
    case kWgResidual * 2 + 1: return wg_launch<128, kWgResidual, 0, 0>(amap, bmap, g, p, s);
    default: return cudaErrorInvalidValue;
  }
}

// A product whose operands are given as maps (wg_rows_map, wg_weight_map)
// and whose geometry g comes from wg_plan_rows: KIND and the operands'
// majors fixed at the call; g.partial as wg_partial_floats asks; kWgF32 is
// not split.
template <int KIND, int TA, int TB>
cudaError_t wg_gemm_maps(const CUtensorMap& amap, const CUtensorMap& bmap, const WgArgs& g,
                         const WgPlan& p, cudaStream_t s) {
  if (((g.splits > 1 || KIND == kWgPartial) && g.partial == nullptr) || g.N > kWgMaxN ||
      (KIND == kWgF32 && g.splits > 1))
    return cudaErrorInvalidValue;
  return p.bn == 128 ? wg_launch<128, KIND, TA, TB>(amap, bmap, g, p, s)
                     : wg_launch<64, KIND, TA, TB>(amap, bmap, g, p, s);
}

// Times of a body's launches (CUDA events on its stream) where the caller
// asks for them (ms not null): mark() before the first part and after each,
// finish() waits for the last and writes part i's ms to ms[i].
struct LaunchClock {
  float* ms;
  cudaStream_t s;
  cudaEvent_t ev[16];
  int n = 0;
  LaunchClock(float* out, cudaStream_t stream) : ms(out), s(stream) {}
  cudaError_t mark() {
    if (ms == nullptr || n == 16) return cudaSuccess;
    cudaError_t err = cudaEventCreate(&ev[n]);
    if (err != cudaSuccess) return err;
    return cudaEventRecord(ev[n++], s);
  }
  cudaError_t finish() {
    if (ms == nullptr || n == 0) return cudaSuccess;
    cudaError_t err = cudaEventSynchronize(ev[n - 1]);
    for (int i = 1; i < n && err == cudaSuccess; ++i) err = cudaEventElapsedTime(&ms[i - 1], ev[i - 1], ev[i]);
    for (int i = 0; i < n; ++i) cudaEventDestroy(ev[i]);
    n = 0;
    return err;
  }
};

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
