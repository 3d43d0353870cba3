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
//                      (and x itself token-major where a NIN follows)
//   wg_gemm_kernel     h = T(T(T(conv3x3(a0)) + b0) + tembv)     implicit GEMM, NHWC
//   gn_apply_kernel    a1 = T(SiLU(GroupNorm_1(h)))
//   wg_gemm_kernel     xs = T(T(x^T Wn) + bn)                     (NIN shortcut only), NCHW
//   wg_gemm_kernel     out = T(T(xs + T(T(conv3x3(a1)) + b1)) * T(rescale)), NCHW
//
// (xs is x itself where the width does not change.)  Each convolution is one
// GEMM over all samples' tokens: M = B H W rows, N = C_out, K = 9 C_in, its A
// operand loaded tap by tap by TMA as a box of the NHWC activations shifted
// by the tap (zeros outside the image), on wgmma with f32 sums; at H 8 and
// H 4 its K is split and the float32 partials summed in a fixed order
// (wg_splitk_kernel) before the one rounding (wg_gemm.cuh).
//
// Bound on this card: DDPM++'s 70 blocks do 31.7 GFLOP a sample; every shape
// does at least 64 operations a byte of its activations, so operations bound
// them all.  PERF.md has the times of each launch against that bound.
#include "wg_gemm.cuh"

namespace {

bool shape_ok(int B, int H, int cin, int cout, int g0, int g1) {
  return B >= 1 && H >= 1 && H <= 64 && cin >= 32 && cin <= 1024 && cin % 32 == 0 &&
         cout >= 32 && cout <= 1024 && cout % 32 == 0 && g0 >= 1 && g0 <= 32 && cin % g0 == 0 &&
         g1 >= 1 && g1 <= 32 && cout % g1 == 0;
}

// The products' plans: conv0, the NIN (where the width changes), conv1.
struct Plans {
  WgArgs g[3];
  WgPlan p[3];
};

Plans plans(int B, int H, int cin, int cout) {
  Plans r{};
  const int M = B * H * H;
  r.p[0] = wg_plan(r.g[0], 1, B, H, M, cout, cin);
  if (cin != cout) r.p[1] = wg_plan(r.g[1], 0, B, H, M, cout, cin);
  r.p[2] = wg_plan(r.g[2], 1, B, H, M, cout, cout);
  return r;
}

struct Buffers {
  float* stats;
  bf16 *a0, *h, *a1, *xt, *xs;
  float* partial;
};

Buffers carve(Carve& w, int B, int H, int cin, int cout) {
  const long long rows = static_cast<long long>(B) * H * H;
  const bool nin = cin != cout;
  const Plans pl = plans(B, H, cin, cout);
  long long part = 0;
  for (int i = 0; i < 3; ++i) {
    const long long b = wg_partial_bytes(pl.p[i], static_cast<int>(rows), cout);
    if (b > part) part = b;
  }
  Buffers b;
  b.stats = w.take<float>(2LL * B * 32);
  b.a0 = w.take<bf16>(rows * cin);
  b.h = w.take<bf16>(rows * cout);
  b.a1 = w.take<bf16>(rows * cout);
  b.xt = nin ? w.take<bf16>(rows * cin) : nullptr;
  b.xs = nin ? w.take<bf16>(rows * cout) : nullptr;
  b.partial = part > 0 ? w.take<float>(part / 4) : nullptr;
  return b;
}

constexpr int kPlanInts = 14;   // a product's plan: WgPlan's ten fields and its box

void put_plan(const WgPlan& p, int* out) {
  const int v[kPlanInts] = {p.bm,     p.bn,     p.tiles_m, p.tiles_n, p.steps,
                            p.chunk,  p.splits, p.blocks,  p.stages,  p.smem,
                            p.box[0], p.box[1], p.box[2],  p.box[3]};
  for (int i = 0; i < kPlanInts; ++i) out[i] = v[i];
}

}  // namespace

extern "C" {

long long rdm_resblock_tiled_workspace(int B, int H, int cin, int cout) {
  Carve w{nullptr};
  carve(w, B, H, cin, cout);
  return w.used;
}

// The launch plan at (B, H, C_in, C_out): plan[0] the kernel launches (the
// split-K sums included), then conv0's, the NIN's (zeros without one) and
// conv1's plans, 14 ints each (tile rows and columns, M and N tiles, stages of
// K, a split's stages, splits, persistent blocks, ring stages, dynamic shared
// memory, the A box), then the GroupNorm launches' blocks (B G0 / g, B G1 / g
// with g groups a block) and the threads of a GEMM and of a GroupNorm block:
// 47 ints.
int rdm_resblock_tiled_plan(int B, int H, int cin, int cout, int g0, int g1, int* plan) {
  if (!shape_ok(B, H, cin, cout, g0, g1)) return static_cast<int>(cudaErrorInvalidValue);
  const Plans pl = plans(B, H, cin, cout);
  const bool nin = cin != cout;
  int launches = 2;
  for (int i = 0; i < 3; ++i)
    if (i != 1 || nin) launches += pl.p[i].splits > 1 ? 2 : 1;
  plan[0] = launches;
  for (int i = 0; i < 3; ++i) put_plan(pl.p[i], plan + 1 + kPlanInts * i);
  int* tail = plan + 1 + 3 * kPlanInts;
  tail[0] = B * (g0 / gn_groups_per_block(cin, g0));
  tail[1] = B * (g1 / gn_groups_per_block(cout, g1));
  tail[2] = kWgThreads;
  tail[3] = kRowThreads;
  return 0;
}

// x (B, cin, H, H), out (B, cout, H, H) NCHW bf16; tembv (B, cout) bf16.
// Parameters bf16: gamma0, beta0 (cin), gamma1, beta1, b0, b1 (cout); w0
// (cout, 9 cin) and w1 (cout, 9 cout) with column tap * C + c, tap = (dy + 1)
// * 3 + (dx + 1); wn_t (cout, cin) = Wn^T and bn (cout), both null when cin ==
// cout.  rescale is T(rescale).  launch_ms: null, or 5 floats that receive
// the ms of GroupNorm 0, conv0, GroupNorm 1, the NIN (0 without one) and
// conv1 (CUDA events; the call then waits for them).  Returns a cudaError_t.
int rdm_resblock_tiled(const void* x, const void* tembv, void* out, const void* gamma0,
                       const void* beta0, const void* w0, const void* b0, const void* gamma1,
                       const void* beta1, const void* w1, const void* b1, const void* wn_t,
                       const void* bn, void* workspace, int B, int H, int cin, int cout,
                       int groups0, int groups1, float eps, float rescale, void* stream,
                       float* launch_ms) {
  const bool nin = cin != cout;
  if (!shape_ok(B, H, cin, cout, groups0, groups1) || (wn_t == nullptr) == nin ||
      (bn == nullptr) == nin)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Carve w{static_cast<char*>(workspace)};
  const Buffers f = carve(w, B, H, cin, cout);
  const int L = H * H, M = B * L;
  const bf16* xb = static_cast<const bf16*>(x);
  LaunchClock clock(launch_ms, s);
  if (launch_ms != nullptr) launch_ms[3] = 0.f;
  cudaError_t err = clock.mark();
  if (err != cudaSuccess) return static_cast<int>(err);

  if ((err = launch_gn_apply(xb, static_cast<long long>(cin) * L, L, 1, B, cin, L, groups0,
                             static_cast<const bf16*>(gamma0), static_cast<const bf16*>(beta0),
                             eps, 1, f.a0, static_cast<long long>(L) * cin, f.stats, f.xt, s)) !=
          cudaSuccess ||
      (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);

  WgEpi e0{};
  e0.kind = kWgRow;
  e0.out = f.h;
  e0.ld = cout;
  e0.bias = static_cast<const bf16*>(b0);
  e0.temb = static_cast<const bf16*>(tembv);
  e0.rps = e0.valid = L;
  if ((err = wg_gemm(f.a0, static_cast<const bf16*>(w0), 1, B, H, M, cout, cin, e0, f.partial,
                     s)) != cudaSuccess ||
      (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);

  if ((err = launch_gn_apply(f.h, static_cast<long long>(L) * cout, 1, cout, B, cout, L, groups1,
                             static_cast<const bf16*>(gamma1), static_cast<const bf16*>(beta1),
                             eps, 1, f.a1, static_cast<long long>(L) * cout, f.stats, nullptr,
                             s)) != cudaSuccess ||
      (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);

  WgEpi e1{};
  e1.kind = kWgResidual;
  e1.out = static_cast<bf16*>(out);
  e1.bias = static_cast<const bf16*>(b1);
  e1.rps = e1.valid = L;
  e1.res = xb;
  e1.rescale = rescale;
  if (nin) {
    WgEpi en{};
    en.kind = kWgNchw;
    en.out = f.xs;
    en.bias = static_cast<const bf16*>(bn);
    en.rps = en.valid = L;
    if ((err = wg_gemm(f.xt, static_cast<const bf16*>(wn_t), 0, B, H, M, cout, cin, en,
                       f.partial, s)) != cudaSuccess ||
        (err = clock.mark()) != cudaSuccess)
      return static_cast<int>(err);
    e1.res = f.xs;
  }
  if ((err = wg_gemm(f.a1, static_cast<const bf16*>(w1), 1, B, H, M, cout, cout, e1, f.partial,
                     s)) != cudaSuccess ||
      (err = clock.mark()) != cudaSuccess)
    return static_cast<int>(err);
  if (launch_ms != nullptr && !nin) {
    // the marks were gn0 | conv0 | gn1 | conv1: put conv1 in its slot
    if ((err = clock.finish()) != cudaSuccess) return static_cast<int>(err);
    launch_ms[4] = launch_ms[3];
    launch_ms[3] = 0.f;
    return 0;
  }
  return static_cast<int>(clock.finish());
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
