// Fused NCSN++ resblock (ResnetBlockDDPMpp forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel rdm_tpu/ops/pallas/resblock.py::_kernel.  For each
// sample it computes
//   a0  = SiLU(GroupNorm_0(x))                  (f32 statistics, E[x^2] - mean^2)
//   h   = conv3x3(a0) + b0 + tembv              (f32 accumulation over 9 taps)
//   a1  = SiLU(GroupNorm_1(h))
//   h2  = conv3x3(a1) + b1
//   out = (shortcut(x) + h2) * rescale          (shortcut: NIN, or x itself)
// with the rounding points of the TPU kernel in the working type T (float or
// bfloat16): a0, a1 (SiLU in f32, rounded once), each convolution and the
// NIN product (rounded before its bias is added in T), + tembv, the residual
// sum and its product with T(rescale).  The GroupNorm scale and bias are T.
//
// Bound on this card: the 17 blocks of the flagship NCSN++ do 171.5 MFLOP a
// sample (175.6 GFLOP a sampling step at B = 1024), 178 us at the bf16
// tensor-core peak; a block's activations are a few hundred KB to 10 MB per
// launch, so operations bound every shape (the largest activation traffic,
// (9, 192, 64) at B = 1024: 42.5 MB, 12.7 us, against 26.8 us of operations).
//
// bfloat16 (fused_resblock_tc_kernel): each convolution is an implicit GEMM
// on the tensor cores (wgmma.m64nNk16, f32 sums).  M is the token rows of
// the S samples a block holds at once (4 at H = 9, 8 at H = 4, 16 at
// H = 2: 324, 128 and 64 rows), K is 9 taps x C_in in 16-deep steps and N is
// all of C_out, so GroupNorm_1's statistics stay in the block.  The
// activations sit in shared memory token-major in bf16 (one row per token,
// channels contiguous, 16-byte chunk j of row r at j ^ (r % 8), so ldmatrix
// is free of bank conflicts), with one zero row after them.  The 3x3 shift
// costs no copy: ldmatrix takes one row address per lane, and each lane
// gives, per tap, the row of its token's neighbour, or the zero row for an
// out-of-image tap (a table built on the host, ops/resblock.py:
// gather_table); the fragments so gathered are wgmma's A operand in
// registers.  The weights come re-laid on the host as stages of C_out rows
// x 64 input channels in the same swizzle (weight_panels: the NIN, then
// conv0 and conv1 tap by tap): a stage on a 1024-byte boundary is wgmma's
// K-major B operand with the 128-byte swizzle, read by the tensor cores
// through a descriptor.  A producer warp streams the stages through a ring
// with 1-D TMA bulk copies, each stage consumed by every consumer warp in
// turn (mbarriers full and empty), so staging overlaps the products with no
// __syncthreads per chunk.  Where a block's stages all fit, (9, 64, 64), they stay resident
// for the block's life.  Blocks are persistent (one an SM, groups of S
// samples blockIdx.x, + gridDim.x, ...), so the ring runs ahead into the
// next group while the block does its elementwise work.  Each consumer
// warpgroup keeps a 128 x 64 (H = 9), 64 x 128 (H = 4) or 64 x 64 (H = 2, two
// warpgroups across C_out) accumulator tile in registers over all 9 taps and
// all of C_in and rounds it once; the shortcut (the NIN as one more GEMM
// over the same rows, or x) waits in registers as bf16 pairs.  A
// compile-time switch (kWgmma) gives the same kernel on mma.sync instead,
// each warp reading its B fragments by ldmatrix: slower (PERF.md).
// GroupNorm statistics, SiLU and the residual stay in f32 as before, read
// from shared memory; x comes in and the output goes out through the same
// buffer, transposed on the way, with 16-byte shared-memory accesses.
//
// float32 (fused_resblock_kernel<float, H>, the earlier body): S samples per
// block (1 at H = 9, 4 at H = 4, 8 at H = 2), activations channel-major in
// shared memory, weights staged one tap and 32 input channels at a time, and
// each thread keeps one RT x 8 tile of accumulators for a whole convolution
// in scalar f32 FMAs.  TF32 would break its 1e-4 tolerance; no model path
// runs it.
#include "attn_common.cuh"
#include "attn_mma.cuh"
#include "tma.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int KC = 32;           // input channels per staged weight chunk
constexpr int kMaxGroups = 32;   // GroupNorm groups a block keeps statistics for

// float32 body.  Per spatial size H = W: samples per block S, rows per
// thread tile RT and the output width CO (shared with the bf16 body).  (S * H * H) / RT row tiles times CO / TN column
// tiles are at most kThreads, so each thread owns at most one tile.
template <int H> struct Geometry;
template <> struct Geometry<9> { static constexpr int S = 1, RT = 3, CO = 64; };
template <> struct Geometry<4> { static constexpr int S = 4, RT = 4, CO = 128; };
template <> struct Geometry<2> { static constexpr int S = 8, RT = 2, CO = 128; };

template <int H> struct Shape {
  static constexpr int L = H * H;
  static constexpr int S = Geometry<H>::S;
  static constexpr int RT = Geometry<H>::RT;
  static constexpr int CO = Geometry<H>::CO;
  static constexpr int M = S * L;            // token rows of a block
  static constexpr int MP = M + 1;           // row stride: M rows and the zero slot
  static constexpr int TILES_N = CO / TN;
  static constexpr int TILES = (M / RT) * TILES_N;
  static_assert(M % RT == 0 && CO % TN == 0 && TILES <= kThreads, "tiling");
};

// Eight consecutive values of T from shared memory (16-byte aligned), as
// float (only the float32 body uses it).
template <typename T> __device__ __forceinline__ void load8_smem(const T* p, float* b);
template <> __device__ __forceinline__ void load8_smem<float>(const float* p, float* b) {
  load8_shared(p, b);
}
// Copy KC x CO weights (16-byte aligned in both places) into shared memory.
template <typename T, int CO>
__device__ __forceinline__ void stage_weights(const T* __restrict__ src, T* ws) {
  constexpr int n = KC * CO * static_cast<int>(sizeof(T)) / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(ws);
  for (int i = threadIdx.x; i < n; i += kThreads) d[i] = __ldg(s + i);
}

// acc += A x W over NT taps (9: a 3x3 SAME convolution; 1: the NIN).  A is
// cin channel rows of stride MP in shared memory; W is (NT, cin, CO) in
// device memory.  The thread's tile is rows i0 .. i0 + RT, columns j0 .. j0
// + TN; threads without a tile (active false) only help stage the weights.
template <typename T, int H, int NT>
__device__ void conv_product(const T* act, int cin, const T* __restrict__ w, T* ws,
                             float (&acc)[Shape<H>::RT][TN], int i0, int j0, bool active) {
  using Sh = Shape<H>;
#pragma unroll
  for (int r = 0; r < Sh::RT; ++r)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[r][n] = 0.f;
  for (int tap = 0; tap < NT; ++tap) {
    const int dy = NT == 1 ? 0 : tap / 3 - 1;
    const int dx = NT == 1 ? 0 : tap % 3 - 1;
    int nb[Sh::RT];   // the neighbour row of each tile row, or the zero slot
#pragma unroll
    for (int r = 0; r < Sh::RT; ++r) {
      const int m = i0 + r;
      const int s = m / Sh::L;
      const int p = m - s * Sh::L;
      const int y = p / H + dy;
      const int x = p % H + dx;
      nb[r] = (y >= 0 && y < H && x >= 0 && x < H) ? s * Sh::L + y * H + x : Sh::M;
    }
    for (int c0 = 0; c0 < cin; c0 += KC) {
      __syncthreads();                 // every thread is done with the last chunk
      stage_weights<T, Sh::CO>(w + (static_cast<size_t>(tap) * cin + c0) * Sh::CO, ws);
      __syncthreads();
      if (!active) continue;
      const T* a = act + c0 * Sh::MP;
#pragma unroll 4
      for (int k = 0; k < KC; ++k) {
        float av[Sh::RT], bv[TN];
#pragma unroll
        for (int r = 0; r < Sh::RT; ++r) av[r] = to_f<T>(a[k * Sh::MP + nb[r]]);
        load8_smem<T>(ws + k * Sh::CO + j0, bv);
#pragma unroll
        for (int r = 0; r < Sh::RT; ++r)
#pragma unroll
          for (int n = 0; n < TN; ++n) acc[r][n] = fmaf(av[r], bv[n], acc[r][n]);
      }
    }
  }
}

// GroupNorm statistics of C channel rows (stride MP) for each of the S
// samples: mean and 1 / sqrt(var + eps) with var = E[x^2] - mean^2, in f32;
// index s * groups + g.  One warp per (sample, group).
template <typename T, int H>
__device__ void group_stats(const T* a, int C, int groups, float eps, float* mu, float* inv) {
  using Sh = Shape<H>;
  const int lane = threadIdx.x & 31;
  const int cg = C / groups;
  const int n = cg * Sh::L;
  const float inv_n = 1.0f / static_cast<float>(n);
  for (int pair = threadIdx.x >> 5; pair < Sh::S * groups; pair += kWarps) {
    const int s = pair / groups;
    const int g = pair - s * groups;
    const T* base = a + g * cg * Sh::MP + s * Sh::L;
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < n; i += 32) {
      const int c = i / Sh::L;
      const float v = to_f<T>(base[c * Sh::MP + (i - c * Sh::L)]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {   // each product and difference rounded, as the plain version does
      const float m = s1 * inv_n;
      const float var = __fsub_rn(__fmul_rn(s2, inv_n), __fmul_rn(m, m));
      mu[pair] = m;
      inv[pair] = 1.0f / sqrtf(var + eps);
    }
  }
}

// In place: a = T(SiLU(((a - mean) * inv) * gamma + beta)), the affine and
// SiLU in f32 (no fused multiply-add, as the plain version rounds).
template <typename T, int H>
__device__ void group_norm_silu(T* a, int C, int groups, const float* mu, const float* inv,
                                const T* __restrict__ gamma, const T* __restrict__ beta) {
  using Sh = Shape<H>;
  const int cg = C / groups;
  for (int i = threadIdx.x; i < C * Sh::M; i += kThreads) {
    const int c = i / Sh::M;
    const int m = i - c * Sh::M;
    const int k = (m / Sh::L) * groups + c / cg;
    float h = (to_f<T>(a[c * Sh::MP + m]) - mu[k]) * inv[k];
    h = __fadd_rn(__fmul_rn(h, to_f<T>(gamma[c])), to_f<T>(beta[c]));
    a[c * Sh::MP + m] = from_f<T>(h / (1.0f + expf(-h)));
  }
}

template <typename T, int H>
__host__ __device__ constexpr size_t smem_bytes(int cin) {
  using Sh = Shape<H>;
  return sizeof(float) * 2 * Sh::S * kMaxGroups
         + sizeof(T) * (static_cast<size_t>(KC) * Sh::CO + static_cast<size_t>(cin) * Sh::MP
                        + static_cast<size_t>(Sh::CO) * Sh::MP + static_cast<size_t>(Sh::CO) * Sh::M);
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
fused_resblock_kernel(const T* __restrict__ x, const T* __restrict__ tembv, T* __restrict__ out,
                      const T* __restrict__ gamma0, const T* __restrict__ beta0,
                      const T* __restrict__ w0, const T* __restrict__ b0,
                      const T* __restrict__ gamma1, const T* __restrict__ beta1,
                      const T* __restrict__ w1, const T* __restrict__ b1,
                      const T* __restrict__ wn, const T* __restrict__ bn,
                      int B, int cin, int groups0, int groups1, float eps, float rescale) {
  using Sh = Shape<H>;
  constexpr int L = Sh::L, M = Sh::M, MP = Sh::MP, CO = Sh::CO, RT = Sh::RT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* mu = reinterpret_cast<float*>(smem);      // S x kMaxGroups
  float* inv = mu + Sh::S * kMaxGroups;             // S x kMaxGroups
  T* ws = reinterpret_cast<T*>(inv + Sh::S * kMaxGroups);   // KC x CO staged weights
  T* xa = ws + KC * CO;                             // cin x MP: x, then a0
  T* ha = xa + cin * MP;                            // CO x MP: h, then a1
  T* xs = ha + CO * MP;                             // CO x M: shortcut, then out

  const int tid = threadIdx.x;
  const int b_first = blockIdx.x * Sh::S;
  const int ns = min(Sh::S, B - b_first);           // samples of this block
  const int valid = ns * L;                         // rows that hold a sample
  const bool active = tid < Sh::TILES;
  const int i0 = active ? (tid / Sh::TILES_N) * RT : 0;
  const int j0 = active ? (tid % Sh::TILES_N) * TN : 0;
  float acc[RT][TN];

  // 1. x into shared memory in device-memory order (each sample is a
  //    contiguous cin x L slab); rows past the samples and the zero slots
  //    are 0, as is h's zero slot.
  const T* xb = x + static_cast<size_t>(b_first) * cin * L;
  for (int i = tid; i < ns * cin * L; i += kThreads) {
    const int s = i / (cin * L);
    const int r = i - s * cin * L;
    const int c = r / L;
    xa[c * MP + s * L + (r - c * L)] = xb[i];
  }
  const int pad = MP - valid;
  for (int i = tid; i < cin * pad; i += kThreads)
    xa[(i / pad) * MP + valid + i % pad] = from_f<T>(0.f);
  for (int c = tid; c < CO; c += kThreads) ha[c * MP + M] = from_f<T>(0.f);
  __syncthreads();

  // 2. GroupNorm_0 statistics, and the shortcut while x is still there.
  group_stats<T, H>(xa, cin, groups0, eps, mu, inv);
  if (wn != nullptr) {
    conv_product<T, H, 1>(xa, cin, wn, ws, acc, i0, j0, active);
    if (active) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int n = 0; n < TN; ++n)
          xs[(j0 + n) * M + i0 + r] = from_f<T>(rnd<T>(acc[r][n]) + to_f<T>(bn[j0 + n]));
    }
  } else {
    for (int i = tid; i < CO * M; i += kThreads) xs[i] = xa[(i / M) * MP + i % M];
  }
  __syncthreads();

  // 3. a0 over x, then conv0 + b0 + tembv into h.
  group_norm_silu<T, H>(xa, cin, groups0, mu, inv, gamma0, beta0);
  conv_product<T, H, 9>(xa, cin, w0, ws, acc, i0, j0, active);
  if (active) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int m = i0 + r;
      const int s = m / L;
      const T* tv = tembv + static_cast<size_t>(b_first + s) * CO;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int o = j0 + n;
        float h = rnd<T>(rnd<T>(acc[r][n]) + to_f<T>(b0[o]));
        if (s < ns) h += to_f<T>(tv[o]);
        ha[o * MP + m] = from_f<T>(h);
      }
    }
  }
  __syncthreads();

  // 4. GroupNorm_1 and a1 over h, then conv1 + b1; the residual in T.
  group_stats<T, H>(ha, CO, groups1, eps, mu, inv);
  __syncthreads();
  group_norm_silu<T, H>(ha, CO, groups1, mu, inv, gamma1, beta1);
  conv_product<T, H, 9>(ha, CO, w1, ws, acc, i0, j0, active);
  if (active) {
    const float rs = rnd<T>(rescale);
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const int o = j0 + n;
        const float h2 = rnd<T>(rnd<T>(acc[r][n]) + to_f<T>(b1[o]));
        const float sum = rnd<T>(to_f<T>(xs[o * M + i0 + r]) + h2);
        xs[o * M + i0 + r] = from_f<T>(__fmul_rn(sum, rs));
      }
  }
  __syncthreads();

  // 5. The output, NCHW, in device-memory order.
  T* ob = out + static_cast<size_t>(b_first) * CO * L;
  for (int i = tid; i < ns * CO * L; i += kThreads) {
    const int s = i / (CO * L);
    const int r = i - s * CO * L;
    const int c = r / L;
    ob[i] = xs[c * M + s * L + (r - c * L)];
  }
}

template <typename T, int H>
cudaError_t launch(const void* x, const void* tembv, void* out, const void* const* p, int B,
                   int cin, int groups0, int groups1, float eps, float rescale,
                   cudaStream_t stream) {
  auto kern = fused_resblock_kernel<T, H>;
  // The largest shared memory any C_in needs, set once per instantiation and card.
  static SmemAttr smem_attr;
  const cudaError_t attr = smem_attr.apply(reinterpret_cast<const void*>(kern),
                                           static_cast<int>(smem_bytes<T, H>(256)));
  if (attr != cudaSuccess) return attr;
  const int blocks = (B + Shape<H>::S - 1) / Shape<H>::S;
  kern<<<blocks, kThreads, smem_bytes<T, H>(cin), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(tembv), static_cast<T*>(out),
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
      static_cast<const T*>(p[8]), static_cast<const T*>(p[9]),
      B, cin, groups0, groups1, eps, rescale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: implicit-GEMM convolutions on the tensor cores

using bf16 = __nv_bfloat16;

// The products: true = wgmma (each warpgroup MT tiles of 64 rows, a warp 16
// rows of each, its B operand read from the stage by the tensor cores
// through a shared-memory descriptor), false = mma.sync (each warp its own
// 16 MT-row tile, its B fragments by ldmatrix).  Both take A from registers
// filled by the same ldmatrix gather; wgmma is 12 % faster on the H100
// (PERF.md; benchmark/knockouts.py builds the other).
constexpr bool kWgmma = true;

// Per H and product: samples a block holds at once (S), the m-tiles (MT)
// of one accumulator tile and its 8-column n-tiles (NT).
template <int H, bool WG> struct TcGeometry;
template <> struct TcGeometry<9, false> { static constexpr int S = 4, MT = 2, NT = 8; };
template <> struct TcGeometry<4, false> { static constexpr int S = 8, MT = 2, NT = 8; };
template <> struct TcGeometry<2, false> { static constexpr int S = 16, MT = 2, NT = 4; };
template <> struct TcGeometry<9, true> { static constexpr int S = 4, MT = 2, NT = 8; };
template <> struct TcGeometry<4, true> { static constexpr int S = 8, MT = 1, NT = 16; };
template <> struct TcGeometry<2, true> { static constexpr int S = 16, MT = 1, NT = 8; };

template <int H, bool WG = kWgmma> struct Tc {
  static constexpr int L = H * H, S = TcGeometry<H, WG>::S;
  static constexpr int MT = TcGeometry<H, WG>::MT, NT = TcGeometry<H, WG>::NT;
  static constexpr int CO = Geometry<H>::CO;
  static constexpr int M = S * L;                               // token rows of a group
  static constexpr int UNIT = WG ? 4 : 1;                       // warps of one accumulator tile
  static constexpr int RSTEP = WG ? 64 : 16;                    // rows from one m-tile to the next
  static constexpr int STRIP = RSTEP * MT;                      // rows of an accumulator tile
  static constexpr int MP = (M + STRIP - 1) / STRIP * STRIP;    // rows padded; row MP is zero
  static constexpr int COLS = CO / (8 * NT);                    // tiles across C_out
  static constexpr int WARPS = MP / STRIP * COLS * UNIT;        // consumer warps
  static constexpr int THREADS = 32 * (WARPS + 1);              // and one producer warp
  static constexpr int SB = CO * 128;                           // bytes of a weight stage
  static constexpr int P = L >= 64 ? 8 : L >= 16 ? 4 : 1;       // lanes per GroupNorm group
};

constexpr int kSmemLimit = 232448;

// Shared memory of the bf16 kernel with `stages` weight stages: room to
// start the ring on a 1024-byte boundary (the swizzle of a stage is that of
// its address), the ring, its barriers, the activations (MP + 1 rows of
// max(C_in, C_out) bf16), the gather table (9 x MP int16), the per-channel
// parameters, tembv and the GroupNorm statistics in f32.
template <int H>
__host__ __device__ constexpr int tc_smem_bytes(int cin, int stages) {
  using G = Tc<H>;
  const int cmax = cin > G::CO ? cin : G::CO;
  return 1024 + stages * (G::SB + 16) + (G::MP + 1) * cmax * 2 + 9 * G::MP * 2
         + (2 * cin + 5 * G::CO) * 4 + G::S * G::CO * 4 + 2 * G::S * kMaxGroups * 4;
}

// The launch plan of the bf16 kernel for C_in: the weight stages a group
// consumes (the NIN's C_in / 64, conv0's 9 C_in / 64, conv1's 9 C_out / 64)
// and the ring, which holds all of them where they fit beside the
// activations (then they stay resident for the block's life), else as many
// as fit.
struct TcPlan {
  int samples, rows, weight_stages, stages, stage_bytes, smem_bytes;
};

template <int H>
__host__ constexpr TcPlan tc_plan(int cin) {
  using G = Tc<H>;
  const int weight_stages = (cin != G::CO ? cin / 64 : 0) + 9 * cin / 64 + 9 * G::CO / 64;
  const int fit = (kSmemLimit - tc_smem_bytes<H>(cin, 0)) / (G::SB + 16);
  const int stages = weight_stages < fit ? weight_stages : fit;
  return {G::S, G::MP, weight_stages, stages, G::SB, tc_smem_bytes<H>(cin, stages)};
}

// c / cg for 0 <= c < 256 and 1 <= cg <= 256 by a multiply and a shift
// (exact there), with mul = group_mul(cg).
__host__ __device__ constexpr int group_mul(int cg) { return (65536 + cg - 1) / cg; }
__device__ __forceinline__ int group_of(int c, int mul) { return (c * mul) >> 16; }

// Element offset of channel c of row m in the swizzled token-major
// activations (row stride re elements, a multiple of 64).
__device__ __forceinline__ int act_at(int m, int re, int c) {
  return m * re + ((((c >> 3) ^ m) & 7) | (c >> 3 & ~7)) * 8 + (c & 7);
}

// GroupNorm statistics of the S samples' rows (channels 0 .. C - 1) for
// every (sample, group): mean and 1 / sqrt(var + eps), var = E[x^2] - mean^2,
// in f32, at index s * groups + g.  P lanes share a (sample, group) and sum
// bf16 pairs (a group's width is even), then reduce with shuffles.
template <int H>
__device__ void tc_group_stats(const bf16* X, int re, int C, int groups, float eps, float* mu,
                               float* inv, int tid, int nthreads) {
  using G = Tc<H>;
  constexpr int L = G::L, P = G::P;
  const int cg = C / groups;
  const int pairs = G::S * groups;
  const float inv_n = 1.0f / static_cast<float>(cg * L);
  for (int base = 0; base < pairs * P; base += nthreads) {
    const int i = base + tid;
    const int pair = i / P, sub = i % P;
    float s1 = 0.f, s2 = 0.f;
    if (pair < pairs) {
      const int s = pair / groups;
      const int c0 = (pair - s * groups) * cg;
      for (int p = sub; p < L; p += P) {
        const int m = s * L + p;
        for (int c = c0; c < c0 + cg; c += 2) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(X + act_at(m, re, c)));
          s1 += v.x;
          s1 += v.y;
          s2 = fmaf(v.x, v.x, s2);
          s2 = fmaf(v.y, v.y, s2);
        }
      }
    }
#pragma unroll
    for (int off = P / 2; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (pair < pairs && sub == 0) {   // each product and difference rounded, as the plain version
      const float m = s1 * inv_n;
      const float var = __fsub_rn(__fmul_rn(s2, inv_n), __fmul_rn(m, m));
      mu[pair] = m;
      inv[pair] = 1.0f / sqrtf(var + eps);
    }
  }
}

// In place over the S samples' rows: a = bf16(SiLU(((a - mean) * inv) *
// gamma + beta)), the affine in f32 without fused multiply-adds, eight
// channels (one 16-byte chunk) a thread at a time.  SiLU takes the hardware
// exp2 and reciprocal (h / (1 + e^-h) within 4 ulp of f32, against the
// bf16 step of 2^16 ulp that rounds it next).
template <int H>
__device__ void tc_group_norm_silu(bf16* X, int re, int C, int groups, const float* mu,
                                   const float* inv, const float* gamma, const float* beta,
                                   int tid, int nthreads) {
  using G = Tc<H>;
  const int mul = group_mul(C / groups), chunks = C / 8;
  for (int i = tid; i < G::M * chunks; i += nthreads) {
    const int m = i / chunks, ch = i - m * chunks;
    const int k0 = (m / G::L) * groups;
    uint4* p = reinterpret_cast<uint4*>(X + act_at(m, re, 8 * ch));
    uint4 u = *p;
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&u);
    float gm[8], bt[8];
    *reinterpret_cast<float4*>(gm) = reinterpret_cast<const float4*>(gamma)[2 * ch];
    *reinterpret_cast<float4*>(gm + 4) = reinterpret_cast<const float4*>(gamma)[2 * ch + 1];
    *reinterpret_cast<float4*>(bt) = reinterpret_cast<const float4*>(beta)[2 * ch];
    *reinterpret_cast<float4*>(bt + 4) = reinterpret_cast<const float4*>(beta)[2 * ch + 1];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(v[e]);
      float r[2] = {f.x, f.y};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + group_of(8 * ch + 2 * e + j, mul);
        float h = (r[j] - mu[k]) * inv[k];
        h = __fadd_rn(__fmul_rn(h, gm[2 * e + j]), bt[2 * e + j]);
        r[j] = __fdividef(h, 1.0f + __expf(-h));
      }
      v[e] = __floats2bfloat162_rn(r[0], r[1]);
    }
    *p = u;
  }
}

// d (the warpgroup's 64 x 8 NT float accumulators: this warp's 16 rows, n-tile
// by n-tile in mma.sync's C layout) += a (this warp's 16 x 16 bf16 fragment,
// in mma.sync's A layout) b (16 x 8 NT bf16, K-major, 128-byte swizzle, from
// the shared-memory descriptor db).  Asynchronous: wgmma_fence() before,
// wgmma_commit_wait() and fence_acc() after.
template <int NT>
__device__ void wgmma_rs(float (&d)[NT][4], const unsigned (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[8][4], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[16][4], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int MT, int NT>
__device__ __forceinline__ void fence_acc(float (&d)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[m][n][e])::"memory");
}

// Ring position of a consumer: the next stage's index in the group's
// sequence (resident weights) or its slot and fill count (streamed).
struct RingPos {
  int stage, slot, fill;
};

// acc (the warp's MT m-tiles of 16 rows, RSTEP rows apart from r0, by NT x 8
// columns from n0) = sum over `taps` taps and C = 64 kc channels of A (the
// activation rows, gathered per tap through the table) times the weight
// stages that arrive in that order.  A row's 16-deep fragments come from
// ldmatrix with each lane's own row address: its token's neighbour for the
// tap, or the zero row.  taps == 1 is the 1x1 product (the NIN) over the
// centre tap.  The products are wgmma, B from the stage by descriptor (a
// stage row is 128 bytes: 64 input channels of one output channel, 8-row
// groups 1024 bytes apart), or mma.sync, B by ldmatrix.
template <int H>
__device__ __forceinline__ void tc_gemm(float (&acc)[Tc<H>::MT][Tc<H>::NT][4], const bf16* X,
                                        int re, const short* tab, int taps, int kc,
                                        const unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int stages, bool resident, RingPos& rp,
                                        int r0, int n0, int lane) {
  using G = Tc<H>;
  constexpr int MT = G::MT, NT = G::NT;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  for (int t = 0; t < taps; ++t) {
    const int tap = taps == 1 ? 4 : t;
    int row[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) row[mt] = tab[tap * G::MP + r0 + G::RSTEP * mt + (lane & 15)];
    for (int c = 0; c < kc; ++c) {
      const int slot = resident ? rp.stage : rp.slot;
      mbar_wait(full + slot, resident ? 0 : rp.fill & 1);
      const unsigned char* stage = ring + slot * G::SB;
      if constexpr (G::UNIT == 4) {
        unsigned a[4][MT][4];
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldmatrix_x4(a[k16][mt], X + act_at(row[mt], re, 64 * c + 16 * k16 + 8 * (lane >> 4)));
        __syncwarp();                                      // wgmma is warp-aligned
        wgmma_fence();
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wgmma_rs<NT>(acc[mt], a[k16][mt], sw128_desc(stage + n0 * 128 + 32 * k16, 16, 1024));
        wgmma_commit_wait();
        fence_acc(acc);
      } else {
        const bf16* w = reinterpret_cast<const bf16*>(stage);
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16) {
          unsigned a[MT][4], b[NT / 2][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldmatrix_x4(a[mt], X + act_at(row[mt], re, 64 * c + 16 * k16 + 8 * (lane >> 4)));
#pragma unroll
          for (int j = 0; j < NT / 2; ++j) {
            // output channels n0 + 16 j + 0..7 then + 8..15; input channels
            // 16 k16 + 0..7 and + 8..15 of the stage
            const int n = n0 + 16 * j + (lane & 7) + ((lane >> 4) << 3);
            ldmatrix_x4(b[j], w + n * 64 + ((2 * k16 + ((lane >> 3) & 1)) ^ (n & 7)) * 8);
          }
#pragma unroll
          for (int j = 0; j < NT / 2; ++j)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[mt][2 * j], a[mt], b[j][0], b[j][1]);
              mma_bf16(acc[mt][2 * j + 1], a[mt], b[j][2], b[j][3]);
            }
        }
      }
      __syncwarp();
      if (!resident) {
        if (lane == 0) mbar_arrive(empty + rp.slot);   // this warp is done with the stage
        if (++rp.slot == stages) {
          rp.slot = 0;
          ++rp.fill;
        }
      }
      ++rp.stage;
    }
  }
}

// One block: consumer warps take groups of S samples blockIdx.x, +
// gridDim.x, ...; accumulator tile (um, un), of one warp (mma.sync) or one
// warpgroup (wgmma), owns rows um STRIP .. um STRIP + STRIP - 1 and output
// channels 8 NT un .. 8 NT un + 8 NT - 1 of every product.  The producer warp streams the weight stages of each group in
// the order the products consume them: the NIN's C_in / 64, conv0's
// 9 C_in / 64 (tap-major), conv1's 9 C_out / 64.
template <int H>
__global__ void __launch_bounds__(Tc<H>::THREADS, 1)
fused_resblock_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ tembv,
                         bf16* __restrict__ out, const bf16* __restrict__ gamma0,
                         const bf16* __restrict__ beta0, const bf16* __restrict__ b0,
                         const bf16* __restrict__ gamma1, const bf16* __restrict__ beta1,
                         const bf16* __restrict__ b1, const bf16* __restrict__ bn,
                         const bf16* __restrict__ panels, const short* __restrict__ table, int B,
                         int cin, int groups0, int groups1, int stages, float eps,
                         float rescale) {
  using G = Tc<H>;
  constexpr int L = G::L, S = G::S, CO = G::CO, MP = G::MP, MT = G::MT, NT = G::NT;
  constexpr int NCT = 32 * G::WARPS;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * G::SB);
  uint64_t* empty = full + stages;
  const int re = cin > CO ? cin : CO;                      // activation row stride
  bf16* X = reinterpret_cast<bf16*>(empty + stages);
  short* tab = reinterpret_cast<short*>(X + (MP + 1) * re);
  float* g0 = reinterpret_cast<float*>(tab + 9 * MP);
  float* be0 = g0 + cin;
  float* bb0 = be0 + cin;
  float* g1 = bb0 + CO;
  float* be1 = g1 + CO;
  float* bb1 = be1 + CO;
  float* bbn = bb1 + CO;
  float* tv = bbn + CO;                                    // S x CO: the group's tembv
  float* mu = tv + S * CO;                                 // S x kMaxGroups
  float* inv = mu + S * kMaxGroups;

  const bool nin = bn != nullptr;
  const int kc_in = cin / 64;
  const int n_stages = (nin ? kc_in : 0) + 9 * kc_in + 9 * (CO / 64);
  const bool resident = stages >= n_stages;
  const int n_groups = (B + S - 1) / S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, G::WARPS);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  for (int i = tid; i < 9 * MP / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(tab)[i] = __ldg(reinterpret_cast<const uint4*>(table) + i);
  for (int i = tid; i < cin; i += blockDim.x) {
    g0[i] = __bfloat162float(gamma0[i]);
    be0[i] = __bfloat162float(beta0[i]);
  }
  for (int i = tid; i < CO; i += blockDim.x) {
    bb0[i] = __bfloat162float(b0[i]);
    g1[i] = __bfloat162float(gamma1[i]);
    be1[i] = __bfloat162float(beta1[i]);
    bb1[i] = __bfloat162float(b1[i]);
    bbn[i] = nin ? __bfloat162float(bn[i]) : 0.f;
  }
  for (int i = tid; i < re / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(X + MP * re)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  if (warp == G::WARPS) {
    // Producer: the weight stages of each of the block's groups in turn
    // (once, where they all stay resident), each into the slot the
    // consumers have all released.
    if (lane == 0) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(panels);
      if (resident) {
        for (int i = 0; i < n_stages; ++i) {
          mbar_expect_tx(full + i, G::SB);
          bulk_load(ring + i * G::SB, src + static_cast<size_t>(i) * G::SB, G::SB, full + i);
        }
      } else {
        int slot = 0, fill = 0;
        for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x)
          for (int i = 0; i < n_stages; ++i) {
            if (fill > 0) mbar_wait(empty + slot, (fill - 1) & 1);
            mbar_expect_tx(full + slot, G::SB);
            bulk_load(ring + slot * G::SB, src + static_cast<size_t>(i) * G::SB, G::SB,
                      full + slot);
            if (++slot == stages) {
              slot = 0;
              ++fill;
            }
          }
      }
    }
    return;
  }

  const int unit = warp / G::UNIT;
  const int um = unit / G::COLS, un = unit - um * G::COLS;
  const int r0 = um * G::STRIP + (G::UNIT == 4 ? 16 * (warp & 3) : 0), n0 = un * 8 * NT;
  const int g = lane >> 2, tq = lane & 3;
  const float rs = rnd_bf16(rescale);
  RingPos rp{0, 0, 0};
  float acc[MT][NT][4];
  unsigned xs[MT][NT][2];   // the shortcut, bf16 pairs in the accumulator layout

  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
    const int b_first = grp * S;
    const int ns = min(S, B - b_first);
    const int valid = ns * L;                              // rows that hold a sample
    rp.stage = 0;

    // 1. x (NCHW slabs) into token-major rows, eight channels a thread,
    //    neighbouring threads on neighbouring tokens, kLoads items' loads in
    //    flight before their stores; rows of absent samples are 0.  tembv in
    //    16-byte loads.
    {
      constexpr int kLoads = 4;
      const int chunks = cin / 8, items = S * chunks * L;
      for (int base = tid; base < items; base += kLoads * NCT) {
        uint4 u[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int i = base + j * NCT;
          const int p = i % L, rest = i / L;
          const int ch = rest % chunks, s = rest / chunks;
          u[j] = make_uint4(0, 0, 0, 0);
          if (i < items && s < ns) {
            const bf16* src = x + (static_cast<size_t>(b_first + s) * cin + 8 * ch) * L + p;
            bf16* v = reinterpret_cast<bf16*>(&u[j]);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = src[e * L];
          }
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
          const int i = base + j * NCT;
          const int p = i % L, rest = i / L;
          if (i < items)
            *reinterpret_cast<uint4*>(X + act_at((rest / chunks) * L + p, re, 8 * (rest % chunks))) = u[j];
        }
      }
      for (int i = tid; i < S * CO / 8; i += NCT) {
        uint4 u = make_uint4(0, 0, 0, 0);
        if (i < ns * CO / 8)
          u = __ldg(reinterpret_cast<const uint4*>(tembv + static_cast<size_t>(b_first) * CO) + i);
        const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(v[e]);
          tv[8 * i + 2 * e] = f.x;
          tv[8 * i + 2 * e + 1] = f.y;
        }
      }
    }
    named_sync(1, NCT);

    // 2. The shortcut: the NIN, rounded before + bn, or x itself.
    if (nin) {
      tc_gemm<H>(acc, X, re, tab, 1, kc_in, ring, full, empty, stages, resident, rp, r0, n0,
                 lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int o = n0 + 8 * nt + 2 * tq;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            xs[mt][nt][hf] = pack_bf16(rnd_bf16(acc[mt][nt][2 * hf]) + bbn[o],
                                       rnd_bf16(acc[mt][nt][2 * hf + 1]) + bbn[o + 1]);
        }
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            xs[mt][nt][hf] = *reinterpret_cast<const unsigned*>(
                X + act_at(r0 + G::RSTEP * mt + g + 8 * hf, re, n0 + 8 * nt + 2 * tq));
    }

    // 3. a0 = SiLU(GroupNorm_0(x)) in place, then conv0.
    tc_group_stats<H>(X, re, cin, groups0, eps, mu, inv, tid, NCT);
    named_sync(1, NCT);
    tc_group_norm_silu<H>(X, re, cin, groups0, mu, inv, g0, be0, tid, NCT);
    named_sync(1, NCT);
    tc_gemm<H>(acc, X, re, tab, 9, kc_in, ring, full, empty, stages, resident, rp, r0, n0, lane);
    named_sync(1, NCT);                                    // every warp is done with a0

    // 4. h = conv0 + b0 + tembv over the rows of the samples; GroupNorm_1.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = r0 + G::RSTEP * mt + g + 8 * hf;
        if (m >= valid) continue;
        const float* t = tv + (m / L) * CO;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int o = n0 + 8 * nt + 2 * tq;
          const float h0 = rnd_bf16(rnd_bf16(acc[mt][nt][2 * hf]) + bb0[o]) + t[o];
          const float h1 = rnd_bf16(rnd_bf16(acc[mt][nt][2 * hf + 1]) + bb0[o + 1]) + t[o + 1];
          *reinterpret_cast<unsigned*>(X + act_at(m, re, o)) = pack_bf16(h0, h1);
        }
      }
    named_sync(1, NCT);
    tc_group_stats<H>(X, re, CO, groups1, eps, mu, inv, tid, NCT);
    named_sync(1, NCT);
    tc_group_norm_silu<H>(X, re, CO, groups1, mu, inv, g1, be1, tid, NCT);
    named_sync(1, NCT);

    // 5. conv1 + b1, the residual in bf16, times bf16(rescale), staged in X.
    tc_gemm<H>(acc, X, re, tab, 9, CO / 64, ring, full, empty, stages, resident, rp, r0, n0,
               lane);
    named_sync(1, NCT);                                    // every warp is done with a1
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = r0 + G::RSTEP * mt + g + 8 * hf;
        if (m >= valid) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int o = n0 + 8 * nt + 2 * tq;
          const float2 sc = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xs[mt][nt][hf]));
          const float h0 = rnd_bf16(rnd_bf16(acc[mt][nt][2 * hf]) + bb1[o]);
          const float h1 = rnd_bf16(rnd_bf16(acc[mt][nt][2 * hf + 1]) + bb1[o + 1]);
          *reinterpret_cast<unsigned*>(X + act_at(m, re, o)) =
              pack_bf16(__fmul_rn(rnd_bf16(sc.x + h0), rs), __fmul_rn(rnd_bf16(sc.y + h1), rs));
        }
      }
    named_sync(1, NCT);

    // 6. The output, NCHW, eight channels a thread, neighbouring threads on
    //    neighbouring tokens.
    {
      const int chunks = CO / 8;
      for (int i = tid; i < ns * chunks * L; i += NCT) {
        const int p = i % L, rest = i / L;
        const int ch = rest % chunks, s = rest / chunks;
        const uint4 u = *reinterpret_cast<const uint4*>(X + act_at(s * L + p, re, 8 * ch));
        const bf16* v = reinterpret_cast<const bf16*>(&u);
        bf16* dst = out + (static_cast<size_t>(b_first + s) * CO + 8 * ch) * L + p;
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e * L] = v[e];
      }
    }
    named_sync(1, NCT);                                    // X is free for the next group
  }
}

template <int H>
cudaError_t launch_tc(const void* x, const void* tembv, void* out, const void* const* p,
                      const void* panels, const void* table, int B, int cin, int groups0,
                      int groups1, float eps, float rescale, cudaStream_t stream) {
  auto kern = fused_resblock_tc_kernel<H>;
  const TcPlan plan = tc_plan<H>(cin);
  if (plan.stages < 1) return cudaErrorInvalidValue;
  // The most any shape may take, set once per instantiation and card.
  static SmemAttr smem_attr;
  const cudaError_t attr = smem_attr.apply(reinterpret_cast<const void*>(kern), kSmemLimit);
  if (attr != cudaSuccess) return attr;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int groups = (B + Tc<H>::S - 1) / Tc<H>::S;
  kern<<<min(groups, sms), Tc<H>::THREADS, plan.smem_bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(tembv), static_cast<bf16*>(out),
      static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[1]),
      static_cast<const bf16*>(p[3]), static_cast<const bf16*>(p[4]),
      static_cast<const bf16*>(p[5]), static_cast<const bf16*>(p[7]),
      static_cast<const bf16*>(p[9]), static_cast<const bf16*>(panels),
      static_cast<const short*>(table), B, cin, groups0, groups1, plan.stages, eps, rescale);
  return cudaGetLastError();
}

cudaError_t dispatch_float(const void* x, const void* tembv, void* out, const void* const* p,
                           int B, int H, int cin, int groups0, int groups1, float eps,
                           float rescale, cudaStream_t s) {
  if (H == 9) return launch<float, 9>(x, tembv, out, p, B, cin, groups0, groups1, eps, rescale, s);
  if (H == 4) return launch<float, 4>(x, tembv, out, p, B, cin, groups0, groups1, eps, rescale, s);
  return launch<float, 2>(x, tembv, out, p, B, cin, groups0, groups1, eps, rescale, s);
}

cudaError_t dispatch_tc(const void* x, const void* tembv, void* out, const void* const* p,
                        const void* panels, const void* table, int B, int H, int cin,
                        int groups0, int groups1, float eps, float rescale, cudaStream_t s) {
  if (H == 9)
    return launch_tc<9>(x, tembv, out, p, panels, table, B, cin, groups0, groups1, eps, rescale, s);
  if (H == 4)
    return launch_tc<4>(x, tembv, out, p, panels, table, B, cin, groups0, groups1, eps, rescale, s);
  return launch_tc<2>(x, tembv, out, p, panels, table, B, cin, groups0, groups1, eps, rescale, s);
}

int out_width(int H) { return H == 9 ? Geometry<9>::CO : H == 4 ? Geometry<4>::CO
                                                       : H == 2 ? Geometry<2>::CO : -1; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Parameters are of the working type:
// gamma0, beta0 (cin), b0, gamma1, beta1 (cout), b1, and the shortcut's bn
// (cout), null when cin == cout.  float32 reads the weights as w0 (9, cin,
// cout) with tap (dy + 1) * 3 + (dx + 1), w1 (9, cout, cout) and wn (cin,
// cout; null when cin == cout), and ignores panels and table.  bfloat16
// reads them from panels instead (ops/resblock.py: weight_panels), with the
// gather table (9, rows) int16 of gather_table (rows: rdm_fused_resblock_plan);
// w0, w1, wn are ignored.  x is (B, cin, H, H) and out (B, cout, H, H), NCHW; tembv is
// (B, cout).  Returns a cudaError_t.
int rdm_fused_resblock(const void* x, const void* tembv, void* out,
                       const void* gamma0, const void* beta0, const void* w0, const void* b0,
                       const void* gamma1, const void* beta1, const void* w1, const void* b1,
                       const void* wn, const void* bn, const void* panels, const void* table,
                       int B, int H, int cin, int cout, int groups0, int groups1, int dtype,
                       float eps, float rescale, void* stream) {
  const void* p[10] = {gamma0, beta0, w0, b0, gamma1, beta1, w1, b1, wn, bn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool shapes_ok = B >= 1 && out_width(H) == cout && cin >= 64 && cin <= 256
                         && cin % 64 == 0 && (bn == nullptr) == (cin == cout);
  const bool groups_ok = groups0 >= 1 && groups0 <= kMaxGroups && cin % groups0 == 0
                         && groups1 >= 1 && groups1 <= kMaxGroups && cout % groups1 == 0;
  if (!shapes_ok || !groups_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if ((wn == nullptr) != (cin == cout)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dispatch_float(x, tembv, out, p, B, H, cin, groups0, groups1, eps,
                                           rescale, s));
  }
  if (dtype == 1)
    return static_cast<int>(dispatch_tc(x, tembv, out, p, panels, table, B, H, cin, groups0,
                                        groups1, eps, rescale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bfloat16 kernel's launch plan for a block shape, into plan[0..5]: the
// samples a group holds, its token rows (the gather table's width; row
// `rows` is the zero row), the weight stages a group consumes, the ring's
// stages (all of them where they fit: resident), a stage's bytes and the
// launch's shared memory.  Returns a cudaError_t.
int rdm_fused_resblock_plan(int H, int cin, int cout, int* plan) {
  if (out_width(H) != cout || cin < 64 || cin > 256 || cin % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TcPlan q = H == 9 ? tc_plan<9>(cin) : H == 4 ? tc_plan<4>(cin) : tc_plan<2>(cin);
  const int v[6] = {q.samples, q.rows, q.weight_stages, q.stages, q.stage_bytes, q.smem_bytes};
  for (int i = 0; i < 6; ++i) plan[i] = v[i];
  return 0;
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
