// Shooting kernels of the batched warm-start solver for Hopper, sm_90a:
// fixed-step RK4 through the Earth-Moon CR3BP with low thrust, in float64 and
// float32 (physics/solver_gpu.py, ops/cr3bp.py).
//
// No Pallas kernel of the JAX package computes these: there the whole solver
// is one vmapped XLA program (rdm_tpu/physics/solver_tpu.py) whose cost is its
// lax.scan integrations (_shoot_forward/_shoot_backward :150-186, the
// manifold target of physics/manifold.py:40-167 and dynamics_df.py:154-242).
// Three kernels take their place, every state in registers from start to end:
//
// * shoot_legs<T>, one thread per (lane, variant), a variant being a base
//   point, a finite-difference column or a ladder rung: the forward leg from
//   the spiral end and the backward leg from the variant's target (32 coast
//   + 16 x n_fwd segment steps each, 192 at 20 segments); the 7-residual
//   with the finite flag, 1e6 in every entry where a leg or the target is
//   not finite.  full = 1 integrates the whole forward arc instead.
// * manifold_target<T>, the manifold chain: 256 halo-phase steps carrying
//   the stable direction, then 1024 ballistic steps backward.  float64
//   carries the direction with the variational equations (the 12-dim system
//   of dynamics_f64._ode12), a thread a row; float32 with the tangent of the
//   RK4 map (each step on Dual<float>), as the JAX package's two precisions
//   do, a row on a group of kChainLanes lanes of one warp (below).
// * shoot_jvp_f32: the float32 Jacobian of the residual on Dual<float>; the
//   phase column 64 differentiates the tangent transport itself on
//   Dual<Dual<float>>, the length column 65 the back-integration's step.
//   Its two target columns come first in the grid, a group of kChainLanes
//   lanes a lane on the same chain code, so that their chains start in the
//   first wave and run under the 64 leg columns, which follow one thread per
//   (lane, column), column by column.
//
// What limits them.  shoot_legs and the leg columns fill the card (65,536 to
// 67,584 threads at 1024 lanes) and are bound by the arithmetic of their
// 192-384 dependent RK4 steps a thread.  The manifold chain is bound by its
// latency: a launch has at most 10,240 rows (2 finite-difference columns and
// 8 rungs a lane), which with a thread a row is less than a warp for each
// of the card's schedulers, so a launch takes one thread's 1,280 dependent
// steps whatever its width (3.2 ms at 1 row and 3.5 ms at 10,240 in float64
// on an H100 at 700 W, benchmark/shoot_chain.py).  The operation-count bound
// (ops/cr3bp.py: *_ops over the FP64 or FP32 peak, 0.11 ms there) is not the
// floor at these widths: the chain is, and each of its stages waits on two
// square roots and six divisions (ode6; four and ten in ode12).
//
// The float32 chain over a group of lanes.  A row runs on kChainLanes = 8
// lanes of one warp, each holding the whole state and running the RK4 update
// alike; only a stage's six gravity terms (c u) / r^3 are spread, one a lane
// (lanes 6 and 7 compute an unread one): the lane computes its term from one
// reciprocal square root of its primary's distance (CUDA's double rsqrt
// rounded once to float; 1 / r^3 = ir^3) and products, the group exchanges
// the terms by __shfl_sync once a stage, and every lane then assembles the
// derivative as manifold.ode6_c does.  This spends the SMs that a launch of
// at most 10,240 rows leaves idle on a shorter chain a lane: a stage waits on
// one reciprocal square root, not on two square roots and six divisions.
// Lanes holding the same values run the same instructions, so they stay
// equal, and a row's result depends neither on how many rows share its
// launch nor on where it lies; a warp that runs the chain is whole (a group
// past the last row runs that row and stores nothing).  The float64 chain
// keeps a thread a row: split the same way it ran 1.6-1.8x faster, but its
// changed roundings moved the float64 solver's verdicts on phase datagen's
// uniform guesses below chip_smoke.py's agreement gate (PERF.md).
// Every other expression follows the plain version's order of operations
// (physics/cr3bp.py:eom_c, manifold.py:ode6_c, dynamics_f64._ode12,
// physics/dual.py); nvcc contracts multiplies and adds into FMAs, so the
// kernels agree with the plain versions to a tolerance, not bit for bit.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kNvar = 66;
constexpr int kNres = 7;
constexpr int kCoastSteps = 32;
constexpr int kSegSteps = 16;
constexpr int kHaloSteps = 256;
constexpr int kManifoldSteps = 1024;
constexpr int kThreads = 128;

// The mission's constants, from physics/cr3bp.py (passed in, one source).
struct Consts {
  double mu;        // CR3BP mass ratio
  double a_coef;    // TU_S^2 / (DU_KM * 1000): thrust/mass -> LU/TU^2
  double mdot_div;  // Isp * G0 * 1000
  double tu_s;      // seconds per time unit
};

// --- dual numbers ----------------------------------------------------------

template <class T>
struct Dual {
  T v, d;
};

template <class T>
struct RealOf {
  using type = T;
};
template <class T>
struct RealOf<Dual<T>> {
  using type = typename RealOf<T>::type;
};

template <class T>
struct Lift {
  __device__ static T of(T v) { return v; }
};
template <class T>
struct Lift<Dual<T>> {
  __device__ static Dual<T> of(typename RealOf<T>::type v) {
    return {Lift<T>::of(v), Lift<T>::of(0)};
  }
};

template <class T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a, const Dual<T>& b) {
  return {a.v + b.v, a.d + b.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a, typename RealOf<T>::type b) {
  return {a.v + b, a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator+(typename RealOf<T>::type b, const Dual<T>& a) {
  return {b + a.v, a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, const Dual<T>& b) {
  return {a.v - b.v, a.d - b.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a, typename RealOf<T>::type b) {
  return {a.v - b, a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(typename RealOf<T>::type b, const Dual<T>& a) {
  return {b - a.v, -a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a) {
  return {-a.v, -a.d};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, const Dual<T>& b) {
  return {a.v * b.v, a.v * b.d + a.d * b.v};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a, typename RealOf<T>::type b) {
  return {a.v * b, a.d * b};
}
template <class T>
__device__ __forceinline__ Dual<T> operator*(typename RealOf<T>::type b, const Dual<T>& a) {
  return {a.v * b, a.d * b};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, const Dual<T>& b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(const Dual<T>& a, typename RealOf<T>::type b) {
  return {a.v / b, a.d / b};
}
template <class T>
__device__ __forceinline__ Dual<T> operator/(typename RealOf<T>::type b, const Dual<T>& a) {
  const T q = b / a.v;
  return {q, -(q * a.d) / a.v};
}

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
template <class T>
__device__ __forceinline__ Dual<T> sqrt_(const Dual<T>& a) {
  using R = typename RealOf<T>::type;
  const T s = sqrt_(a.v);
  return {s, a.d * (R(0.5) / s)};
}

// 1 / sqrt(x): CUDA's double rsqrt (within 1 ulp); in float32 through it,
// rounded once to float.
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }
__device__ __forceinline__ float rsqrt_(float x) {
  return static_cast<float>(rsqrt(static_cast<double>(x)));
}
template <class T>
__device__ __forceinline__ Dual<T> rsqrt_(const Dual<T>& a) {
  using R = typename RealOf<T>::type;
  const T y = rsqrt_(a.v);
  return {y, a.d * ((R(-0.5) * y) * (y * y))};
}

__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
template <class T>
__device__ __forceinline__ Dual<T> sin_(const Dual<T>& a) {
  return {sin_(a.v), a.d * cos_(a.v)};
}
template <class T>
__device__ __forceinline__ Dual<T> cos_(const Dual<T>& a) {
  return {cos_(a.v), -(a.d * sin_(a.v))};
}

template <class T>
__device__ __forceinline__ T pow2_(const T& x) {
  return x * x;
}
template <class T>
__device__ __forceinline__ Dual<T> pow2_(const Dual<T>& a) {
  using R = typename RealOf<T>::type;
  return {pow2_(a.v), (R(2) * a.v) * a.d};
}
template <class T>
__device__ __forceinline__ T pow3_(const T& x) {
  return (x * x) * x;
}
template <class T>
__device__ __forceinline__ Dual<T> pow3_(const Dual<T>& a) {
  using R = typename RealOf<T>::type;
  return {pow3_(a.v), (R(3) * pow2_(a.v)) * a.d};
}

__device__ __forceinline__ bool finite_(float x) { return isfinite(x); }
__device__ __forceinline__ bool finite_(double x) { return isfinite(x); }

// min(max(x, lo), hi) and max(x, c), NaN passing through as in the plain
// version; their derivatives: 1 inside, 1/2 on a bound (jnp.clip/maximum).
template <class T>
__device__ __forceinline__ T clip_(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
template <class T>
__device__ __forceinline__ T max_(T x, T c) {
  return x < c ? c : x;
}
template <class T>
__device__ __forceinline__ T clip_d(T x, T lo, T hi) {
  return (x == lo || x == hi) ? T(0.5) : ((x > lo && x < hi) ? T(1) : T(0));
}
template <class T>
__device__ __forceinline__ T max_d(T x, T c) {
  return x == c ? T(0.5) : (x > c ? T(1) : T(0));
}

// --- vector fields (manifold.ode6_c, cr3bp.eom_c, dynamics_f64._ode12) ------

// Ballistic CR3BP on [x y z vx vy vz].
template <class S>
__device__ __forceinline__ void ode6(const S (&s)[6], S (&ds)[6], const Consts& c) {
  using R = typename RealOf<S>::type;
  const R mu = R(c.mu), one_mu = R(1.0 - c.mu), neg_one_mu = R(-(1.0 - c.mu));
  const S xp = s[0] + mu;
  const S xm = (s[0] - R(1)) + mu;
  const S yz = s[1] * s[1];
  const S zz = s[2] * s[2];
  const S r1 = sqrt_((pow2_(xp) + yz) + zz);
  const S r2 = sqrt_((pow2_(xm) + yz) + zz);
  const S r13 = pow3_(r1), r23 = pow3_(r2);
  ds[0] = s[3];
  ds[1] = s[4];
  ds[2] = s[5];
  ds[3] = ((s[0] - (one_mu * xp) / r13) - (mu * xm) / r23) + R(2) * s[4];
  ds[4] = ((s[1] - (one_mu * s[1]) / r13) - (mu * s[1]) / r23) - R(2) * s[3];
  ds[5] = (neg_one_mu * s[2]) / r13 - (mu * s[2]) / r23;
}

// Low-thrust CR3BP on [x y z vx vy vz m] with direction u and throttle thr.
template <class S>
__device__ __forceinline__ void eom7(const S (&s)[7], const S (&u)[3], const S& thr, double thrust,
                                     S (&ds)[7], const Consts& c) {
  using R = typename RealOf<S>::type;
  const R mu = R(c.mu), one_mu = R(1.0 - c.mu), neg_one_mu = R(-(1.0 - c.mu));
  const S xp = s[0] + mu;
  const S xm = (s[0] - R(1)) + mu;
  const S yy = pow2_(s[1]);
  const S zz = pow2_(s[2]);
  const S r1 = sqrt_((pow2_(xp) + yy) + zz);
  const S r2 = sqrt_((pow2_(xm) + yy) + zz);
  const S r13 = pow3_(r1), r23 = pow3_(r2);
  const S ax = ((s[0] - (one_mu * xp) / r13) - (mu * xm) / r23) + R(2) * s[4];
  const S ay = ((s[1] - (one_mu * s[1]) / r13) - (mu * s[1]) / r23) - R(2) * s[3];
  const S az = (neg_one_mu * s[2]) / r13 - (mu * s[2]) / r23;
  S m = s[6];
  if constexpr (std::is_same<S, R>::value) m = max_(m, R(1e-6));  // the duals' mass never nears it
  const S a_mag = ((thr * R(thrust)) / m) * R(c.a_coef);
  ds[0] = s[3];
  ds[1] = s[4];
  ds[2] = s[5];
  ds[3] = ax + a_mag * u[0];
  ds[4] = ay + a_mag * u[1];
  ds[5] = az + a_mag * u[2];
  ds[6] = (((-thr) * R(thrust)) / R(c.mdot_div)) * R(c.tu_s);
}

// Ballistic state and its tangent through the first variational equations.
__device__ __forceinline__ void ode12(const double (&sv)[12], double (&dsv)[12], const Consts& c) {
  const double mu = c.mu;
  double s[6], ds[6];
  for (int i = 0; i < 6; ++i) s[i] = sv[i];
  ode6(s, ds, c);
  for (int i = 0; i < 6; ++i) dsv[i] = ds[i];
  const double x = sv[0], y = sv[1], z = sv[2];
  const double dx = sv[6], dy = sv[7], dz = sv[8], dvx = sv[9], dvy = sv[10], dvz = sv[11];
  const double yz2 = y * y + z * z;
  double g[2][3];
  const double ux[2] = {x + mu, x + (mu - 1.0)};
  const double mk[2] = {1.0 - mu, mu};
  for (int k = 0; k < 2; ++k) {
    const double r2 = ux[k] * ux[k] + yz2;
    const double r = sqrt(r2);
    const double ir3 = mk[k] / (r * r2);
    const double ir5_3 = (3.0 * mk[k]) / ((r * r2) * r2);
    const double cd = ir5_3 * ((ux[k] * dx + y * dy) + z * dz);
    g[k][0] = cd * ux[k] - ir3 * dx;
    g[k][1] = cd * y - ir3 * dy;
    g[k][2] = cd * z - ir3 * dz;
  }
  dsv[6] = dvx;
  dsv[7] = dvy;
  dsv[8] = dvz;
  dsv[9] = ((g[0][0] + g[1][0]) + dx) + 2.0 * dvy;
  dsv[10] = ((g[0][1] + g[1][1]) + dy) - 2.0 * dvx;
  dsv[11] = g[0][2] + g[1][2];
}

// One RK4 step of the field f on N components with step dt (a real or a dual).
template <int N, class S, class D, class F>
__device__ __forceinline__ void rk4_step(S (&s)[N], const D& dt, F&& f) {
  using R = typename RealOf<S>::type;
  S k1[N], k2[N], k3[N], k4[N], t[N];
  const D h = R(0.5) * dt;
  f(s, k1);
  for (int i = 0; i < N; ++i) t[i] = s[i] + h * k1[i];
  f(t, k2);
  for (int i = 0; i < N; ++i) t[i] = s[i] + h * k2[i];
  f(t, k3);
  for (int i = 0; i < N; ++i) t[i] = s[i] + dt * k3[i];
  f(t, k4);
  const D h6 = dt / R(6);
  for (int i = 0; i < N; ++i)
    s[i] = s[i] + h6 * (((k1[i] + R(2) * k2[i]) + R(2) * k3[i]) + k4[i]);
}

// --- shooting legs -----------------------------------------------------------

template <class S>
__device__ void coast(S (&s)[7], const S& dt, double thrust, const Consts& c) {
  const S zero = Lift<S>::of(0);
  const S u[3] = {zero, zero, zero};
  for (int i = 0; i < kCoastSteps; ++i)
    rk4_step<7>(s, dt, [&](const S (&x)[7], S (&dx)[7]) { eom7(x, u, zero, thrust, dx, c); });
}

// Segments k0, k0 + step, ... (count n) at kSegSteps steps of dt each, with
// the direction and throttle that seg(k, u, thr) gives.
template <class S, class Seg>
__device__ void segments(S (&s)[7], int k0, int step, int n, const S& dt, double thrust,
                         const Consts& c, Seg&& seg) {
  for (int j = 0, k = k0; j < n; ++j, k += step) {
    S u[3], thr;
    seg(k, u, thr);
    for (int i = 0; i < kSegSteps; ++i)
      rk4_step<7>(s, dt, [&](const S (&x)[7], S (&dx)[7]) { eom7(x, u, thr, thrust, dx, c); });
  }
}

// The plain controls of segment k: u = (cos b cos a, cos b sin a, sin b) and
// the throttle clipped to [0, 1].
template <class T>
__device__ __forceinline__ void plain_segment(const T* th, int k, T (&u)[3], T& thr) {
  const T a = th[3 + 3 * k], b = th[4 + 3 * k];
  thr = clip_(th[5 + 3 * k], T(0), T(1));
  u[0] = cos_(b) * cos_(a);
  u[1] = cos_(b) * sin_(a);
  u[2] = sin_(b);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
shoot_legs_kernel(const T* __restrict__ theta, const T* __restrict__ tgt,
                  const T* __restrict__ spiral, double thrust, int n_segments, int full,
                  Consts c, T* __restrict__ out, uint8_t* __restrict__ finite, int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const T* th = theta + static_cast<size_t>(m) * kNvar;
  const int n_fwd = (n_segments + 1) / 2;
  const T dt_seg = (max_(th[0], T(1e-3)) / T(n_segments)) / T(kSegSteps);
  auto seg = [&](int k, T (&u)[3], T& thr) { plain_segment(th, k, u, thr); };

  T sf[7];
  for (int i = 0; i < 7; ++i) sf[i] = spiral[i];
  coast(sf, max_(th[1], T(0)) / T(kCoastSteps), thrust, c);
  segments(sf, 0, 1, full ? n_segments : n_fwd, dt_seg, thrust, c, seg);
  bool ok = true;
  if (full) {
    coast(sf, max_(th[2], T(0)) / T(kCoastSteps), thrust, c);
    for (int i = 0; i < 7; ++i) {
      out[static_cast<size_t>(m) * 7 + i] = sf[i];
      ok = ok && finite_(sf[i]);
    }
    finite[m] = ok;
    return;
  }
  T sb[7];
  for (int i = 0; i < 6; ++i) sb[i] = tgt[static_cast<size_t>(m) * 6 + i];
  for (int i = 0; i < 6; ++i) ok = ok && finite_(sb[i]);
  sb[6] = clip_(th[63], T(301), T(752));
  coast(sb, (-max_(th[2], T(0))) / T(kCoastSteps), thrust, c);
  segments(sb, n_segments - 1, -1, n_segments - n_fwd, -dt_seg, thrust, c, seg);
  T r[kNres];
  for (int i = 0; i < 6; ++i) r[i] = sf[i] - sb[i];
  r[6] = (sf[6] - sb[6]) / T(100);
  for (int i = 0; i < 7; ++i) ok = ok && finite_(sf[i]) && finite_(sb[i]);
  for (int i = 0; i < kNres; ++i) out[static_cast<size_t>(m) * kNres + i] = ok ? r[i] : T(1e6);
  finite[m] = ok;
}

// --- the float32 manifold chain over a group of lanes ---------------------------

// Lanes a row of the float32 manifold chain takes: manifold_target<float> and
// shoot_jvp's target columns (2, 4 and 8 were measured; PERF.md).  Lane j < 6
// computes the stage's gravity term j, that of primary j % 2 (0 the Earth, 1
// the Moon) in component j / 2, (c u) / r^3: the only square root and
// divisions of the ballistic field (manifold.ode6_c).  Lanes 6 and 7 compute
// an unread term, so that every lane runs the same instructions.
constexpr int kChainLanes = 8;
constexpr int kChainTerms = 6;

// Lane j's part of a stage, set once a launch: its primary's distance along
// x, u = (x + c1) + c2 (x + mu, or (x - 1) + mu as ode6_c forms it), and its
// term's numerator cn * (u, y or z), the component w.
struct ChainJob {
  float c1, c2, cn;
  int w;
};

__device__ __forceinline__ ChainJob chain_job(int j, const Consts& c) {
  const int k = j % 2, i = j / 2;
  ChainJob jb;
  jb.c1 = k == 0 ? float(c.mu) : -1.f;
  jb.c2 = k == 0 ? 0.f : float(c.mu);
  jb.cn = j >= kChainTerms ? 1.f
          : k == 1         ? float(c.mu)
          : i == 2         ? float(-(1.0 - c.mu))
                           : float(1.0 - c.mu);
  jb.w = j >= kChainTerms ? 0 : i;
  return jb;
}

// A value of lane src of this lane's group (whole warps run the chain).
__device__ __forceinline__ float shfl_(float x, int src) {
  return __shfl_sync(0xffffffffu, x, src, kChainLanes);
}
template <class T>
__device__ __forceinline__ Dual<T> shfl_(const Dual<T>& x, int src) {
  return {shfl_(x.v, src), shfl_(x.d, src)};
}

// The ballistic field at t over a row's group of lanes (S a float32 real or
// dual): each lane computes its term, with its primary's inverse distance
// from one reciprocal square root (1 / r^3 = ir^3) where ode6_c takes a
// square root and divisions, takes the others' from their lanes, and
// assembles the whole derivative as ode6_c does, in its order of operations.
template <class S>
__device__ __forceinline__ void chain_field(const S (&t)[6], S (&dt)[6], const ChainJob& jb) {
  using R = typename RealOf<S>::type;
  const S yy = t[1] * t[1], zz = t[2] * t[2];
  const S u = (t[0] + jb.c1) + jb.c2;
  const S ir3 = pow3_(rsqrt_((pow2_(u) + yy) + zz));
  const S num = jb.w == 0 ? u : (jb.w == 1 ? t[1] : t[2]);
  const S val = (jb.cn * num) * ir3;
  S g[kChainTerms];
#pragma unroll
  for (int v = 0; v < kChainTerms; ++v) g[v] = shfl_(val, v);
  dt[0] = t[3];
  dt[1] = t[4];
  dt[2] = t[5];
  dt[3] = ((t[0] - g[0]) - g[1]) + R(2) * t[4];
  dt[4] = ((t[1] - g[2]) - g[3]) - R(2) * t[3];
  dt[5] = g[4] - g[5];
}

// One RK4 step of the chain's field.
template <class S, class D>
__device__ __forceinline__ void chain_step(S (&s)[6], const D& dt, const ChainJob& jb) {
  rk4_step<6>(s, dt, [&](const S (&a)[6], S (&da)[6]) { chain_field(a, da, jb); });
}

// 1024 ballistic steps backward over length from seed (in place): a thread
// alone (float64), or over the chain's group of lanes.
template <class S, class D>
__device__ __forceinline__ void back_integrate(S (&s)[6], const D& dt, const Consts& c) {
  for (int i = 0; i < kManifoldSteps; ++i)
    rk4_step<6>(s, dt, [&](const S (&x)[6], S (&dx)[6]) { ode6(x, dx, c); });
}
template <class S, class D>
__device__ __forceinline__ void back_integrate(S (&s)[6], const D& dt, const ChainJob& jb) {
  for (int i = 0; i < kManifoldSteps; ++i) chain_step(s, dt, jb);
}

// The halo phase of the float32 target: state and tangent on Dual<float>.
__device__ __forceinline__ void halo_phase_f32(const float* s0, const float* v0, float dt,
                                               float (&x)[6], float (&v)[6],
                                               const ChainJob& jb) {
  Dual<float> s[6];
  for (int i = 0; i < 6; ++i) s[i] = {s0[i], v0[i]};
  for (int i = 0; i < kHaloSteps; ++i) chain_step(s, dt, jb);
  for (int i = 0; i < 6; ++i) {
    x[i] = s[i].v;
    v[i] = s[i].d;
  }
}

// --- manifold target -----------------------------------------------------------

// float64: a thread a row, the first design (the lane split changed the float64
// verdicts of phase datagen's gate; see the notes above).  float32: row m =
// t / kChainLanes runs on the lanes j = t % kChainLanes of its group; a group
// past the last row runs the last row and stores nothing, a warp wholly past
// it returns, so every warp that runs the chain is whole; lane j < 6 stores
// component j.
template <class T>
__global__ void __launch_bounds__(kThreads)
manifold_target_kernel(const T* __restrict__ state0, const T* __restrict__ period,
                       const T* __restrict__ vstable, const T* __restrict__ tau_frac,
                       const T* __restrict__ length, Consts c, T* __restrict__ out, int M) {
  if constexpr (std::is_same<T, double>::value) {
    const int m = blockIdx.x * blockDim.x + threadIdx.x;
    if (m >= M) return;
    const T dt = (clip_(tau_frac[m], T(0), T(1)) * period[m]) / T(kHaloSteps);
    T x[6], v[6];
    double sv[12];
    for (int i = 0; i < 6; ++i) {
      sv[i] = state0[static_cast<size_t>(m) * 6 + i];
      sv[6 + i] = vstable[static_cast<size_t>(m) * 6 + i];
    }
    for (int i = 0; i < kHaloSteps; ++i)
      rk4_step<12>(sv, dt, [&](const double (&a)[12], double (&da)[12]) { ode12(a, da, c); });
    for (int i = 0; i < 6; ++i) {
      x[i] = sv[i];
      v[i] = sv[6 + i];
    }
    T nrm = v[0] * v[0];
    for (int i = 1; i < 6; ++i) nrm = nrm + v[i] * v[i];
    nrm = sqrt_(nrm) + T(1e-30);
    T s[6];
    for (int i = 0; i < 6; ++i) s[i] = x[i] + T(1e-4) * (v[i] / nrm);
    back_integrate(s, (-length[m]) / T(kManifoldSteps), c);
    for (int i = 0; i < 6; ++i) out[static_cast<size_t>(m) * 6 + i] = s[i];
  } else {
    constexpr int G = kChainLanes;
    const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if ((t & ~31LL) >= static_cast<long long>(M) * G) return;
    const int row = static_cast<int>(t / G), j = static_cast<int>(t % G);
    const int m = row < M ? row : M - 1;
    const ChainJob jb = chain_job(j, c);
    const T dt = (clip_(tau_frac[m], T(0), T(1)) * period[m]) / T(kHaloSteps);
    T x[6], v[6];
    halo_phase_f32(state0 + static_cast<size_t>(m) * 6, vstable + static_cast<size_t>(m) * 6, dt,
                   x, v, jb);
    T nrm = v[0] * v[0];
    for (int i = 1; i < 6; ++i) nrm = nrm + v[i] * v[i];
    nrm = sqrt_(nrm) + T(1e-30);
    T s[6];
    for (int i = 0; i < 6; ++i) s[i] = x[i] + T(1e-4) * (v[i] / nrm);
    back_integrate(s, (-length[m]) / T(kManifoldSteps), jb);
    if (row < M && j < 6) out[static_cast<size_t>(m) * 6 + j] = s[j];
  }
}

// --- float32 Jacobian ------------------------------------------------------------

// Threads of each target column: L groups of kChainLanes, whole warps.
__host__ __device__ inline long long jvp_target_threads(int L) {
  return (static_cast<long long>(L) * kChainLanes + 31) / 32 * 32;
}

// The target columns come first, so that their chains start in the first
// wave: threads [0, R) run column 64 and [R, 2R) column 65, a lane a group
// of kChainLanes as in manifold_target (the groups past L masked); then one
// thread per (column < 64, lane), column by column.  Mirrored by
// ops/cr3bp.py: jvp_layout.
__global__ void __launch_bounds__(kThreads)
shoot_jvp_kernel(const float* __restrict__ theta, const float* __restrict__ tgt,
                 const float* __restrict__ state0, const float* __restrict__ period,
                 const float* __restrict__ vstable, const float* __restrict__ spiral,
                 double thrust, int n_segments, float min_mani, float max_mani, Consts c,
                 float* __restrict__ J, int L) {
  using D = Dual<float>;
  constexpr int G = kChainLanes;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per_col = jvp_target_threads(L);
  if (t >= 2 * per_col + static_cast<long long>(64) * L) return;
  int col, lane, j = 0, stride = 1;
  bool store = true;
  if (t < 2 * per_col) {
    col = 64 + static_cast<int>(t / per_col);
    const long long u = t % per_col;
    const int grp = static_cast<int>(u / G);
    j = static_cast<int>(u % G);
    stride = G;
    store = grp < L;
    lane = store ? grp : L - 1;
  } else {
    col = static_cast<int>((t - 2 * per_col) / L);
    lane = static_cast<int>((t - 2 * per_col) % L);
  }
  const float* th = theta + static_cast<size_t>(lane) * kNvar;
  const int n_fwd = (n_segments + 1) / 2;
  const float seg_dt0 = max_(th[0], 1e-3f);
  float out[kNres];

  if (col < 64) {
    // the legs against the fixed target, one variable seeded
    const bool fwd = col <= 1 || (col >= 3 && col < 3 + 3 * n_fwd);
    const bool bwd = col == 0 || col == 2 || col == 63 ||
                     (col >= 3 + 3 * n_fwd && col < 3 + 3 * n_segments);
    const D t_shoot = {seg_dt0, col == 0 ? max_d(th[0], 1e-3f) : 0.f};
    const D dt_seg = (t_shoot / float(n_segments)) / float(kSegSteps);
    auto seg = [&](int k, D (&u)[3], D& thr) {
      const D a = {th[3 + 3 * k], col == 3 + 3 * k ? 1.f : 0.f};
      const D b = {th[4 + 3 * k], col == 4 + 3 * k ? 1.f : 0.f};
      const float r = th[5 + 3 * k];
      thr = {clip_(r, 0.f, 1.f), col == 5 + 3 * k ? clip_d(r, 0.f, 1.f) : 0.f};
      u[0] = cos_(b) * cos_(a);
      u[1] = cos_(b) * sin_(a);
      u[2] = sin_(b);
    };
    for (int i = 0; i < kNres; ++i) out[i] = 0.f;
    if (fwd) {
      D s[7];
      for (int i = 0; i < 7; ++i) s[i] = {spiral[i], 0.f};
      const D t_c1 = {max_(th[1], 0.f), col == 1 ? max_d(th[1], 0.f) : 0.f};
      coast(s, t_c1 / float(kCoastSteps), thrust, c);
      segments(s, 0, 1, n_fwd, dt_seg, thrust, c, seg);
      for (int i = 0; i < kNres; ++i) out[i] = s[i].d;
    }
    if (bwd) {
      D s[7];
      for (int i = 0; i < 6; ++i) s[i] = {tgt[static_cast<size_t>(lane) * 6 + i], 0.f};
      s[6] = {clip_(th[63], 301.f, 752.f), col == 63 ? clip_d(th[63], 301.f, 752.f) : 0.f};
      const D t_c2 = {max_(th[2], 0.f), col == 2 ? max_d(th[2], 0.f) : 0.f};
      coast(s, (-t_c2) / float(kCoastSteps), thrust, c);
      segments(s, n_segments - 1, -1, n_segments - n_fwd, -dt_seg, thrust, c, seg);
      for (int i = 0; i < kNres; ++i) out[i] = out[i] - s[i].d;
    }
  } else {
    // the target's columns: the phase (64) and the arc length (65)
    const ChainJob jb = chain_job(j, c);
    const float* s0 = state0 + static_cast<size_t>(lane) * 6;
    const float* v0 = vstable + static_cast<size_t>(lane) * 6;
    const float tau_c = clip_(th[64], 0.f, 1.f);
    const float len = clip_(th[65], min_mani, max_mani);
    const float dt_h = (tau_c * period[lane]) / float(kHaloSteps);
    D seed[6];
    D dt_b = {(-len) / float(kManifoldSteps), 0.f};
    if (col == 64) {
      using H = Dual<D>;
      const float d_tau = clip_d(th[64], 0.f, 1.f) * clip_d(tau_c, 0.f, 1.f);
      const H dt = {{dt_h, 0.f}, {(d_tau * period[lane]) / float(kHaloSteps), 0.f}};
      H s[6];
      for (int i = 0; i < 6; ++i) s[i] = {{s0[i], v0[i]}, {0.f, 0.f}};
      for (int i = 0; i < kHaloSteps; ++i) chain_step(s, dt, jb);
      D x[6], v[6];
      for (int i = 0; i < 6; ++i) {
        x[i] = {s[i].v.v, s[i].d.v};
        v[i] = {s[i].v.d, s[i].d.d};
      }
      D nrm = v[0] * v[0];
      for (int i = 1; i < 6; ++i) nrm = nrm + v[i] * v[i];
      nrm = sqrt_(nrm) + 1e-30f;
      for (int i = 0; i < 6; ++i) seed[i] = x[i] + 1e-4f * (v[i] / nrm);
    } else {
      float x[6], v[6];
      halo_phase_f32(s0, v0, dt_h, x, v, jb);
      float nrm = v[0] * v[0];
      for (int i = 1; i < 6; ++i) nrm = nrm + v[i] * v[i];
      nrm = sqrtf(nrm) + 1e-30f;
      for (int i = 0; i < 6; ++i) seed[i] = {x[i] + 1e-4f * (v[i] / nrm), 0.f};
      dt_b.d = (-clip_d(th[65], min_mani, max_mani)) / float(kManifoldSteps);
    }
    back_integrate(seed, dt_b, jb);
    // the backward leg from that target, the controls and times as they are
    D s[7];
    for (int i = 0; i < 6; ++i) s[i] = seed[i];
    s[6] = {clip_(th[63], 301.f, 752.f), 0.f};
    const float dt_seg = (seg_dt0 / float(n_segments)) / float(kSegSteps);
    coast(s, D{(-max_(th[2], 0.f)) / float(kCoastSteps), 0.f}, thrust, c);
    segments(s, n_segments - 1, -1, n_segments - n_fwd, D{-dt_seg, 0.f}, thrust, c,
             [&](int k, D (&u)[3], D& thr) {
               float uf[3], tf;
               plain_segment(th, k, uf, tf);
               for (int i = 0; i < 3; ++i) u[i] = {uf[i], 0.f};
               thr = {tf, 0.f};
             });
    for (int i = 0; i < kNres; ++i) out[i] = -s[i].d;
  }
  out[6] = out[6] / 100.f;
  if (store)
    for (int i = 0; i < kNres; ++i)
      if (i % stride == j) J[(static_cast<size_t>(lane) * kNres + i) * kNvar + col] = out[i];
}

inline Consts consts(double mu, double a_coef, double mdot_div, double tu_s) {
  return Consts{mu, a_coef, mdot_div, tu_s};
}

inline int blocks_for(long long threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

template <class T>
int launch_shoot_legs(const void* theta, const void* tgt, const void* spiral, double thrust,
                      int n_segments, int full, double mu, double a_coef, double mdot_div,
                      double tu_s, void* out, void* finite, int M, void* stream) {
  if (M < 1 || n_segments < 1 || n_segments > 20 || (!full && tgt == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  shoot_legs_kernel<T><<<blocks_for(M), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(theta), static_cast<const T*>(tgt), static_cast<const T*>(spiral),
      thrust, n_segments, full, consts(mu, a_coef, mdot_div, tu_s), static_cast<T*>(out),
      static_cast<uint8_t*>(finite), M);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_manifold_target(const void* state0, const void* period, const void* vstable,
                           const void* tau_frac, const void* length, double mu, double a_coef,
                           double mdot_div, double tu_s, void* out, int M, void* stream) {
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads =
      static_cast<long long>(M) * (std::is_same<T, double>::value ? 1 : kChainLanes);
  manifold_target_kernel<T><<<blocks_for(threads), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(state0), static_cast<const T*>(period),
      static_cast<const T*>(vstable), static_cast<const T*>(tau_frac),
      static_cast<const T*>(length), consts(mu, a_coef, mdot_div, tu_s), static_cast<T*>(out),
      M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// theta [M, 66], tgt [M, 6] (unused and may be null with full = 1), spiral
// [7], out [M, 7], finite [M] (uint8): contiguous, one dtype.  Returns a
// cudaError_t.
int rdm_shoot_legs_f64(const void* theta, const void* tgt, const void* spiral, double thrust,
                       int n_segments, int full, double mu, double a_coef, double mdot_div,
                       double tu_s, void* out, void* finite, int M, void* stream) {
  return launch_shoot_legs<double>(theta, tgt, spiral, thrust, n_segments, full, mu, a_coef,
                                   mdot_div, tu_s, out, finite, M, stream);
}

int rdm_shoot_legs_f32(const void* theta, const void* tgt, const void* spiral, double thrust,
                       int n_segments, int full, double mu, double a_coef, double mdot_div,
                       double tu_s, void* out, void* finite, int M, void* stream) {
  return launch_shoot_legs<float>(theta, tgt, spiral, thrust, n_segments, full, mu, a_coef,
                                  mdot_div, tu_s, out, finite, M, stream);
}

// state0 [M, 6], period [M], vstable [M, 6], tau_frac [M], length [M],
// out [M, 6]: contiguous, one dtype.
int rdm_manifold_target_f64(const void* state0, const void* period, const void* vstable,
                            const void* tau_frac, const void* length, double mu, double a_coef,
                            double mdot_div, double tu_s, void* out, int M, void* stream) {
  return launch_manifold_target<double>(state0, period, vstable, tau_frac, length, mu, a_coef,
                                        mdot_div, tu_s, out, M, stream);
}

int rdm_manifold_target_f32(const void* state0, const void* period, const void* vstable,
                            const void* tau_frac, const void* length, double mu, double a_coef,
                            double mdot_div, double tu_s, void* out, int M, void* stream) {
  return launch_manifold_target<float>(state0, period, vstable, tau_frac, length, mu, a_coef,
                                       mdot_div, tu_s, out, M, stream);
}

// theta [L, 66], tgt [L, 6], state0 [L, 6], period [L], vstable [L, 6],
// spiral [7], J [L, 7, 66]: contiguous float32.
int rdm_shoot_jvp_f32(const void* theta, const void* tgt, const void* state0, const void* period,
                      const void* vstable, const void* spiral, double thrust, int n_segments,
                      double min_mani, double max_mani, double mu, double a_coef,
                      double mdot_div, double tu_s, void* J, int L, void* stream) {
  if (L < 1 || n_segments < 1 || n_segments > 20) return static_cast<int>(cudaErrorInvalidValue);
  shoot_jvp_kernel<<<blocks_for(2 * jvp_target_threads(L) + 64LL * L), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const float*>(tgt),
      static_cast<const float*>(state0), static_cast<const float*>(period),
      static_cast<const float*>(vstable), static_cast<const float*>(spiral), thrust, n_segments,
      static_cast<float>(min_mani), static_cast<float>(max_mani),
      consts(mu, a_coef, mdot_div, tu_s), static_cast<float*>(J), L);
  return static_cast<int>(cudaGetLastError());
}

// The lanes a row of the float32 chain takes as built (ops/cr3bp.py: LANES).
int rdm_shoot_chain_lanes() { return kChainLanes; }

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
