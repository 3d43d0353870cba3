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
// This first kernel does its products with f32 FMAs outside the tensor
// cores (67 TFLOP/s peak), so it cannot come near that bound; tensor cores
// (mma.sync / wgmma) are later work.
//
// Design: each thread block takes S samples (S = 1 at H = 9, 4 at H = 4, 8
// at H = 2, so that a block has 32-81 token rows to share the staged weights
// over) and keeps all their activations in shared memory in T: x (later a0),
// h (later a1) and the shortcut (later the output), channel-major with the
// S * L token rows contiguous, plus one zero slot per channel that
// out-of-image taps read.  Device memory sees x, tembv and out once and the
// weights once per block: a convolution is a (S*L) x C_out x (9 * C_in)
// product whose weights are staged through shared memory one tap and 32
// input channels at a time (the largest weight, 9 x 256 x 128 in bf16, is
// 590 KB and does not fit).  Each thread keeps one RT x 8 tile of the
// product's accumulators in registers for a whole convolution; a 3x3 tap
// reads its neighbour token through a 2-D bounds check that sends an
// out-of-image tap to the zero slot.
#include "attn_common.cuh"

namespace {

constexpr int KC = 32;           // input channels per staged weight chunk
constexpr int kMaxGroups = 32;   // GroupNorm groups a block keeps statistics for

// Per spatial size H = W: samples per block S, rows per thread tile RT and
// the output width CO.  (S * H * H) / RT row tiles times CO / TN column
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

// Eight consecutive values of T from shared memory (16-byte aligned), as float.
template <typename T> __device__ __forceinline__ void load8_smem(const T* p, float* b);
template <> __device__ __forceinline__ void load8_smem<float>(const float* p, float* b) {
  load8_shared(p, b);
}
template <> __device__ __forceinline__ void load8_smem<__nv_bfloat16>(
    const __nv_bfloat16* p, float* b) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    b[2 * i] = f.x;
    b[2 * i + 1] = f.y;
  }
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
  // The largest shared memory any C_in needs, set once per instantiation.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
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

template <typename T>
cudaError_t dispatch(const void* x, const void* tembv, void* out, const void* const* p, int B,
                     int H, int cin, int groups0, int groups1, float eps, float rescale,
                     cudaStream_t s) {
  if (H == 9) return launch<T, 9>(x, tembv, out, p, B, cin, groups0, groups1, eps, rescale, s);
  if (H == 4) return launch<T, 4>(x, tembv, out, p, B, cin, groups0, groups1, eps, rescale, s);
  return launch<T, 2>(x, tembv, out, p, B, cin, groups0, groups1, eps, rescale, s);
}

int out_width(int H) { return H == 9 ? Geometry<9>::CO : H == 4 ? Geometry<4>::CO
                                                       : H == 2 ? Geometry<2>::CO : -1; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Parameters are of the working type:
// gamma0, beta0 (cin), w0 (9, cin, cout) with tap (dy + 1) * 3 + (dx + 1),
// b0, gamma1, beta1 (cout), w1 (9, cout, cout), b1, and the shortcut wn
// (cin, cout), bn (cout), both null when cin == cout.  x is (B, cin, H, H)
// and out (B, cout, H, H), NCHW; tembv is (B, cout).  Returns a cudaError_t.
int rdm_fused_resblock(const void* x, const void* tembv, void* out,
                       const void* gamma0, const void* beta0, const void* w0, const void* b0,
                       const void* gamma1, const void* beta1, const void* w1, const void* b1,
                       const void* wn, const void* bn,
                       int B, int H, int cin, int cout, int groups0, int groups1, int dtype,
                       float eps, float rescale, void* stream) {
  const void* p[10] = {gamma0, beta0, w0, b0, gamma1, beta1, w1, b1, wn, bn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool shapes_ok = B >= 1 && out_width(H) == cout && cin >= KC && cin <= 256
                         && cin % KC == 0 && (wn == nullptr) == (cin == cout)
                         && (wn == nullptr) == (bn == nullptr);
  const bool groups_ok = groups0 >= 1 && groups0 <= kMaxGroups && cin % groups0 == 0
                         && groups1 >= 1 && groups1 <= kMaxGroups && cout % groups1 == 0;
  if (!shapes_ok || !groups_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(dispatch<float>(x, tembv, out, p, B, H, cin, groups0, groups1,
                                            eps, rescale, s));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(x, tembv, out, p, B, H, cin, groups0,
                                                    groups1, eps, rescale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
