// Fused NCSN++ resblock (ResnetBlockDDPMpp forward) in bfloat16 at the shapes
// of DDPM++ on CIFAR-10 and of the nf-32 NCSN++, sm_90a: H = W up to 64,
// C_in and C_out multiples of 32 up to 1024.
//
// Replaces, at these shapes, the TPU kernel rdm_tpu/ops/pallas/resblock.py
// ::_kernel; the flagship's shapes keep fused_resblock.cu.  One sample's input
// at (32, 384) is 768 KB in bf16, so no block holds a sample: the block runs
// as launches that meet in global memory, each intermediate stored in bf16
// where the TPU kernel rounds it, so its rounding points stay:
//
//   gn_apply_kernel    a0 = T(SiLU(GroupNorm_0(x)))             NCHW in, NHWC out
//   tiled_gemm_kernel  h = T(T(T(conv3x3(a0)) + b0) + tembv)     implicit GEMM, NHWC
//   gn_apply_kernel    a1 = T(SiLU(GroupNorm_1(h)))
//   tiled_gemm_kernel  xs = T(T(x^T Wn) + bn)                     (NIN shortcut only)
//   tiled_gemm_kernel  out = T(T(xs + T(T(conv3x3(a1)) + b1)) * T(rescale)), NCHW
//
// (xs is x itself where the width does not change.)  Each convolution is one
// GEMM over all samples' tokens: M = B H W rows, N = C_out, K = 9 C_in, its A
// operand read straight from the NHWC activations with the 3x3 shift applied
// on load (a tap outside the image reads 0), on mma.sync with f32 sums.
//
// Bound on this card: DDPM++'s 70 blocks do 31.7 GFLOP a sample; every shape
// does at least 64 operations a byte of its activations, so operations bound
// them all.  This body is the simple one (64 x 64 tiles, no pipelining);
// PERF.md has its times against that bound.
#include "tiled_gemm.cuh"

namespace {

bool shape_ok(int B, int H, int cin, int cout, int g0, int g1) {
  return B >= 1 && H >= 1 && H <= 64 && cin >= 32 && cin <= 1024 && cin % 32 == 0 &&
         cout >= 32 && cout <= 1024 && cout % 32 == 0 && g0 >= 1 && g0 <= 32 && cin % g0 == 0 &&
         g1 >= 1 && g1 <= 32 && cout % g1 == 0;
}

struct Buffers {
  float* stats;
  bf16 *a0, *h, *a1, *xs;
};

Buffers carve(Carve& w, int B, int H, int cin, int cout, bool nin) {
  const long long rows = static_cast<long long>(B) * H * H;
  Buffers b;
  b.stats = w.take<float>(2LL * B * 32);
  b.a0 = w.take<bf16>(rows * cin);
  b.h = w.take<bf16>(rows * cout);
  b.a1 = w.take<bf16>(rows * cout);
  b.xs = nin ? w.take<bf16>(rows * cout) : nullptr;
  return b;
}

Src conv_src(const bf16* a, int B, int H, int c) {
  Src s = src(a, 0, 0, 0, B * H * H, kConv3x3);
  s.H = s.W = H;
  s.c = c;
  return s;
}

}  // namespace

extern "C" {

long long rdm_resblock_tiled_workspace(int B, int H, int cin, int cout) {
  Carve w{nullptr};
  carve(w, B, H, cin, cout, cin != cout);
  return w.used;
}

// The launch plan at (B, H, C_in, C_out): plan[0] the launches, then the grid
// (x, y, z) of conv0, of the NIN (0 0 0 without one) and of conv1, the
// GroupNorm launches' blocks (B G0, B G1), the threads of a GEMM and of a
// GroupNorm block, and a GEMM block's shared memory: 15 ints.
int rdm_resblock_tiled_plan(int B, int H, int cin, int cout, int g0, int g1, int* plan) {
  if (!shape_ok(B, H, cin, cout, g0, g1)) return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * H * H;
  GemmArgs c0{}, nn{}, c1{};
  c0.M = M, c0.N = cout, c0.K = 9 * cin;
  nn.M = H * H, nn.N = cout, nn.K = cin;
  c1.M = M, c1.N = cout, c1.K = 9 * cout;
  const dim3 g_c0 = gemm_grid(c0, 1), g_nn = gemm_grid(nn, B), g_c1 = gemm_grid(c1, 1);
  const bool nin = cin != cout;
  const int v[15] = {nin ? 5 : 4,
                     static_cast<int>(g_c0.x), static_cast<int>(g_c0.y), static_cast<int>(g_c0.z),
                     nin ? static_cast<int>(g_nn.x) : 0, nin ? static_cast<int>(g_nn.y) : 0,
                     nin ? static_cast<int>(g_nn.z) : 0,
                     static_cast<int>(g_c1.x), static_cast<int>(g_c1.y), static_cast<int>(g_c1.z),
                     B * g0, B * g1, kGemmThreads, kRowThreads, kGemmSmemBytes};
  for (int i = 0; i < 15; ++i) plan[i] = v[i];
  return 0;
}

// x (B, cin, H, H), out (B, cout, H, H) NCHW bf16; tembv (B, cout) bf16.
// Parameters bf16: gamma0, beta0 (cin), gamma1, beta1, b0, b1 (cout); w0
// (cout, 9 cin) and w1 (cout, 9 cout) with column tap * C + c, tap = (dy + 1)
// * 3 + (dx + 1); wn_t (cout, cin) = Wn^T and bn (cout), both null when cin ==
// cout.  rescale is T(rescale).  Returns a cudaError_t.
int rdm_resblock_tiled(const void* x, const void* tembv, void* out, const void* gamma0,
                       const void* beta0, const void* w0, const void* b0, const void* gamma1,
                       const void* beta1, const void* w1, const void* b1, const void* wn_t,
                       const void* bn, void* workspace, int B, int H, int cin, int cout,
                       int groups0, int groups1, float eps, float rescale, void* stream) {
  const bool nin = cin != cout;
  if (!shape_ok(B, H, cin, cout, groups0, groups1) || (wn_t == nullptr) == nin ||
      (bn == nullptr) == nin)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Carve w{static_cast<char*>(workspace)};
  const Buffers f = carve(w, B, H, cin, cout, nin);
  const int L = H * H, M = B * L;
  const bf16* xb = static_cast<const bf16*>(x);

  gn_apply_kernel<<<B * groups0, kRowThreads, 0, s>>>(
      xb, static_cast<long long>(cin) * L, L, 1, cin, L, groups0,
      static_cast<const bf16*>(gamma0), static_cast<const bf16*>(beta0), eps, 1, f.a0,
      static_cast<long long>(L) * cin, f.stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmArgs c0{};
  c0.a = conv_src(f.a0, B, H, cin);
  c0.b = src(static_cast<const bf16*>(w0), 0, 9LL * cin, 1, cout, kKContig);
  c0.e = epi_bf16(f.h, 0, cout, static_cast<const bf16*>(b0));
  c0.e.temb = static_cast<const bf16*>(tembv);
  c0.e.temb_ld = cout;
  c0.e.rps = L;
  c0.M = M, c0.N = cout, c0.K = 9 * cin;
  if ((err = launch_gemm(c0, 1, s)) != cudaSuccess) return static_cast<int>(err);

  gn_apply_kernel<<<B * groups1, kRowThreads, 0, s>>>(
      f.h, static_cast<long long>(L) * cout, 1, cout, cout, L, groups1,
      static_cast<const bf16*>(gamma1), static_cast<const bf16*>(beta1), eps, 1, f.a1,
      static_cast<long long>(L) * cout, f.stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  GemmArgs c1{};
  c1.e.kind = kOutResidual;
  if (nin) {
    GemmArgs n{};
    n.a = src(xb, static_cast<long long>(cin) * L, 1, L, L, kRContig);
    n.b = src(static_cast<const bf16*>(wn_t), 0, cin, 1, cout, kKContig);
    n.e = epi_bf16(f.xs, static_cast<long long>(L) * cout, cout, static_cast<const bf16*>(bn));
    n.M = L, n.N = cout, n.K = cin;
    if ((err = launch_gemm(n, B, s)) != cudaSuccess) return static_cast<int>(err);
    c1.e.res = f.xs;
    c1.e.res_sb = static_cast<long long>(L) * cout;
    c1.e.res_sl = cout;
    c1.e.res_sn = 1;
  } else {
    c1.e.res = xb;
    c1.e.res_sb = static_cast<long long>(cin) * L;
    c1.e.res_sl = 1;
    c1.e.res_sn = L;
  }
  c1.a = conv_src(f.a1, B, H, cout);
  c1.b = src(static_cast<const bf16*>(w1), 0, 9LL * cout, 1, cout, kKContig);
  c1.e.bias = static_cast<const bf16*>(b1);
  c1.e.rps = L;
  c1.e.out = out;
  c1.e.out_sb = static_cast<long long>(cout) * L;
  c1.e.out_L = L;
  c1.e.rescale = rescale;
  c1.M = M, c1.N = cout, c1.K = 9 * cout;
  return static_cast<int>(launch_gemm(c1, 1, s));
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
