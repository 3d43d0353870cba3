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
// * Dots: a block owns a 64 x 128 output tile.  It stages all of w (taps x
//   64 x K, 73.7 KB at both K) and its K x 128 slice of x once in shared
//   memory with asynchronous copies (cp.async), rows padded by 16 bytes so
//   that the tensor-core fragment loads (ldmatrix) fall on distinct banks,
//   and eight warps each keep a 32 x 32 float32 accumulator (2 x 4 tiles of
//   mma.sync.m16n8k16, bf16 in) across all taps and K; the sum is rounded
//   once, through a float32 stage in shared memory that gives 16-byte
//   coalesced stores.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// channels-first dots on the tensor cores

// 16 bytes from global to shared memory without a register round trip;
// src_bytes 0 fills the 16 bytes with zeros.  Every copy a thread issues is
// in flight at once until cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Four 8 x 8 bf16 matrices from shared memory into the fragment layout of
// mma.m16n8k16 (lane l gives the address of row l % 8 of matrix l / 8);
// .trans hands each lane a column pair instead of a row pair.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d (16 x 8 float) += a (16 x 16 bf16, row-major) b (16 x 8 bf16, column-major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kRows = 64;            // C: every row of w
constexpr int kCols = 128;           // output columns a block owns
constexpr int kXPitch = kCols + 8;   // bf16 row pitch of the staged x slice
constexpr int kOPitch = kCols + 4;   // float row pitch of the output stage

// y (64 x N) = bf16(sum_t w[t] (64 x K) @ x[:K] (K x N)); K % 16 == 0,
// N % 8 == 0.
__global__ void __launch_bounds__(kThreads)
dots_kernel(const bf16* __restrict__ w, const bf16* __restrict__ x, bf16* __restrict__ y,
            int taps, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int wp = K + 8;                                     // bf16 row pitch of staged w
  bf16* ws = reinterpret_cast<bf16*>(smem);                 // taps * 64 rows of wp
  bf16* xs = ws + static_cast<size_t>(taps) * kRows * wp;   // K rows of kXPitch
  float* os = reinterpret_cast<float*>(smem);               // 64 rows of kOPitch, after the products
  const int n0 = blockIdx.x * kCols;

  // Stage all of w and the block's x slice with asynchronous copies, all in
  // flight together (a load-then-store loop would wait out one L2 round trip
  // per 16 bytes of each thread).
  const int kc = K / 8;
  for (int q = threadIdx.x; q < taps * kRows * kc; q += kThreads) {
    const int r = q / kc, k = q - r * kc;
    cp_async16(ws + static_cast<size_t>(r) * wp + 8 * k, w + static_cast<size_t>(r) * K + 8 * k,
               16);
  }
  for (int q = threadIdx.x; q < K * (kCols / 8); q += kThreads) {
    const int r = q / (kCols / 8), k = q % (kCols / 8);
    const bool in = n0 + 8 * k < N;
    cp_async16(xs + r * kXPitch + 8 * k, in ? x + static_cast<size_t>(r) * N + n0 + 8 * k : x,
               in ? 16 : 0);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2 x 4 warps of 32 x 32 over the 64 x 128 tile; each warp keeps 2 x 4
  // float32 accumulators of 16 x 8 (mma.m16n8k16) across all taps and K.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 32;
  const int wn = (warp & 3) * 32;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;   // this lane's ldmatrix row address
  float acc[2][4][4] = {};
  for (int t = 0; t < taps; ++t) {
    const bf16* wt = ws + static_cast<size_t>(t) * kRows * wp;
    for (int k0 = 0; k0 < K; k0 += 16) {
      unsigned a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], wt + (wm + 16 * i + lrow) * wp + k0 + lcol);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(b[j], xs + (k0 + lrow) * kXPitch + wn + 16 * j + lcol);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          mma_bf16(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
  }
  __syncthreads();                   // every warp is done with ws and xs
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* o = os + (wm + 16 * i + g) * kOPitch + wn + 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(o) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(o + 8 * kOPitch) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();

  for (int q = threadIdx.x; q < kRows * (kCols / 8); q += kThreads) {
    const int r = q / (kCols / 8), k = q % (kCols / 8);
    if (n0 + 8 * k >= N) continue;
    const float4 u = *reinterpret_cast<const float4*>(os + r * kOPitch + 8 * k);
    const float4 v = *reinterpret_cast<const float4*>(os + r * kOPitch + 8 * k + 4);
    const __nv_bfloat162 p0 = __floats2bfloat162_rn(u.x, u.y), p1 = __floats2bfloat162_rn(u.z, u.w);
    const __nv_bfloat162 p2 = __floats2bfloat162_rn(v.x, v.y), p3 = __floats2bfloat162_rn(v.z, v.w);
    uint4 out;
    out.x = *reinterpret_cast<const uint32_t*>(&p0);
    out.y = *reinterpret_cast<const uint32_t*>(&p1);
    out.z = *reinterpret_cast<const uint32_t*>(&p2);
    out.w = *reinterpret_cast<const uint32_t*>(&p3);
    *reinterpret_cast<uint4*>(y + static_cast<size_t>(r) * N + n0 + 8 * k) = out;
  }
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
// bfloat16; smem is the block's shared memory (ops/micro_cf.py:
// dots_smem_bytes).
int rdm_cf_dots(const void* w, const void* x, void* y, int taps, int K, int N, int smem,
                void* stream) {
  if (taps < 1 || K < 16 || K % 16 != 0 || N < 8 || N % 8 != 0 || smem < 1 ||
      smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  // The most any shape may take, set once.
  static const cudaError_t attr = cudaFuncSetAttribute(
      dots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  dots_kernel<<<(N + kCols - 1) / kCols, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(w), static_cast<const bf16*>(x), static_cast<bf16*>(y), taps, K, N);
  return static_cast<int>(cudaGetLastError());
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
