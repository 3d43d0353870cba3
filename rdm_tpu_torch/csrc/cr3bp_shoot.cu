// Shooting kernels of the batched warm-start solver for Hopper, sm_90a:
// fixed-step RK4 through the Earth-Moon CR3BP with low thrust, in float64 and
// float32 (physics/solver_gpu.py, ops/cr3bp.py).
//
// No Pallas kernel of the JAX package computes these: there the whole solver
// is one vmapped XLA program (rdm_tpu/physics/solver_tpu.py) whose cost is its
// lax.scan integrations (_shoot_forward/_shoot_backward :150-186, the
// finite differences of _jac_fd_df :690-720, the manifold target of
// physics/manifold.py:40-167 and dynamics_df.py:154-242).  These kernels take
// their place, every state in registers from start to end:
//
// * shoot_legs<T>, one thread per (row, leg), a row being a base point or a
//   ladder rung: the forward leg from the spiral end and the backward leg
//   from the row's target (32 coast + 16 x n_fwd segment steps each, 192 at
//   20 segments) on two adjacent lanes, which exchange their end states; the
//   7-residual with the finite flag, 1e6 in every entry where a leg or the
//   target is not finite.  full = 1 integrates the whole forward arc
//   instead, a thread a row (shoot_arc).
// * shoot_legs_fd: the float64 Jacobian's 66 residual rows a lane (theta
//   with h_j added to variable j), a thread per leg that a column moves and
//   per base leg (fd_jobs: 69 a lane at 20 segments, where the 66 trial rows
//   as shoot_legs rows integrate 132 legs), then a small kernel that forms
//   each column's residual from its two legs.  Each leg reads the values the
//   trial row holds (FdRow), so the rows are shoot_legs' on the trial rows
//   bit for bit.
// * manifold_target<T>, the manifold chain: 256 halo-phase steps carrying
//   the stable direction, then 1024 ballistic steps backward, a row on a
//   group of lanes of one warp.  float64 carries the direction with the
//   variational equations (the 12-dim system of dynamics_f64._ode12) on
//   kChainLanes64 lanes; float32 with the tangent of the RK4 map (each step
//   on Dual<float>) on kChainLanes lanes, as the JAX package's two
//   precisions do.
// * shoot_jvp_f32: the float32 Jacobian of the residual on Dual<float>; the
//   phase column 64 differentiates the tangent transport itself on
//   Dual<Dual<float>>, the length column 65 the back-integration's step.
//   Its two target columns come first in the grid, a group of kChainLanes
//   lanes a lane on the same chain code, so that their chains start in the
//   first wave; they stop at the target's tangent dT.  The leg jobs follow:
//   a job per (lane, leg, column) runs its leg once, 192 steps (t_shoot's
//   column moves both legs: a job each).  Six backward jobs seed the leg's
//   start state: its sensitivity Phi to the target, so columns 64-65 are
//   -Phi dT, formed with column 0 (its forward tangent minus its backward
//   one) by a second, small launch.
//
// What limits them.  Each kernel is a chain of dependent RK4 steps whose
// stages wait on square roots and divisions, and the widest launches also
// fill the card's FP64 issue.  A launch of shoot_legs takes one leg's chain,
// 192 steps, however few rows it has (0.5 ms in float64 on an H100 at 700 W,
// benchmark/shoot_chain.py); the two-leg thread it replaces took 384.
// shoot_legs_fd at 1024 lanes runs 70,656 leg threads in one wave, each
// leg once.  The manifold chain has at most 10,240 rows a launch (2
// finite-difference columns and 8 rungs a lane), too few threads at one a
// row to hide its latency: a launch took one thread's 1,280 dependent steps
// whatever its width (3.0 ms at 1 row, 3.4 at 10,240 in float64).  The
// operation-count bound (ops/cr3bp.py: *_ops over the FP64 or FP32 peak) is
// not the floor at these widths: the chain is.
//
// The manifold chain over a group of lanes.  Every lane of a row's group
// holds the whole state and runs the RK4 update alike; only a stage's square
// roots and divisions are spread over the lanes and exchanged by
// __shfl_sync.  Lanes holding the same values run the same instructions, so
// they stay equal, and a row's result depends neither on how many rows share
// its launch nor on where it lies; a warp that runs the chain is whole (a
// group past the last row runs that row and stores nothing).
// float32 (kChainLanes = 8): lane j < 6 computes the stage's gravity term j,
// (c u) / r^3, from one reciprocal square root of its primary's distance
// (CUDA's double rsqrt rounded once to float; 1 / r^3 = ir^3) and products;
// lanes 6 and 7 compute an unread one.  float64 (kChainLanes64 = 4): each
// lane takes one square root and up to three of the stage's divisions, the
// one-thread kernel's operations on the same operands, each rounded once by
// an intrinsic and fused where nvcc fused that kernel, so the targets are
// that kernel's bit for bit (the notes at kChainLanes64).
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

// --- the low-thrust vector field (cr3bp.eom_c) ----------------------------------

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
// the throttle clipped to [0, 1]; th a row's variables (a pointer, or a
// finite-difference row: FdRow).
template <class T, class Th>
__device__ __forceinline__ void plain_segment(const Th& th, int k, T (&u)[3], T& thr) {
  const T a = th[3 + 3 * k], b = th[4 + 3 * k];
  thr = clip_(th[5 + 3 * k], T(0), T(1));
  u[0] = cos_(b) * cos_(a);
  u[1] = cos_(b) * sin_(a);
  u[2] = sin_(b);
}

// One shooting leg of the row th into s: forward from the spiral end (coast
// t_c1, segments [0, n_fwd)), or backward from the target tgt with the mass
// variable (coast t_c2, segments n_segments - 1 down to n_fwd), every value
// as the plain version forms it.  Both directions run the same instructions
// on selected operands, so the two lanes of a row do not diverge.
template <class T, class Th>
__device__ __forceinline__ void leg(bool fwd, const Th& th, const T* spiral, const T* tgt,
                                    double thrust, int n_segments, const Consts& c, T (&s)[7]) {
  const int n_fwd = (n_segments + 1) / 2;
  const T dt_seg = (max_(th[0], T(1e-3)) / T(n_segments)) / T(kSegSteps);
  for (int i = 0; i < 6; ++i) s[i] = fwd ? spiral[i] : tgt[i];
  s[6] = fwd ? spiral[6] : clip_(th[63], T(301), T(752));
  const T tc = fwd ? max_(th[1], T(0)) : -max_(th[2], T(0));
  const int k0 = fwd ? 0 : n_segments - 1, step = fwd ? 1 : -1;
  const int n = fwd ? n_fwd : n_segments - n_fwd;
  const T dt = fwd ? dt_seg : -dt_seg;
  auto seg = [&](int k, T (&u)[3], T& thr) { plain_segment(th, k, u, thr); };
  coast(s, tc / T(kCoastSteps), thrust, c);
  segments(s, k0, step, n, dt, thrust, c, seg);
}

// A thread per (row, leg): row m's forward leg on the even lane 2m, its
// backward leg on the odd lane beside it; the pair exchanges its end states
// and the forward lane stores the residual and the finite flag.  A pair is
// whole in its warp, so the shuffles name its two lanes only.
template <class T>
__global__ void __launch_bounds__(kThreads)
shoot_legs_kernel(const T* __restrict__ theta, const T* __restrict__ tgt,
                  const T* __restrict__ spiral, double thrust, int n_segments, Consts c,
                  T* __restrict__ out, uint8_t* __restrict__ finite, int M) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int m = static_cast<int>(t >> 1);
  if (m >= M) return;
  const bool fwd = (t & 1) == 0;
  const T* tg = tgt + static_cast<size_t>(m) * 6;
  T s[7], o[7];
  leg(fwd, theta + static_cast<size_t>(m) * kNvar, spiral, tg, thrust, n_segments, c, s);
  const unsigned pair = 3u << (threadIdx.x & 30);
  for (int i = 0; i < 7; ++i) o[i] = __shfl_xor_sync(pair, s[i], 1);
  if (!fwd) return;
  bool ok = true;
  for (int i = 0; i < 6; ++i) ok = ok && finite_(tg[i]);
  T r[kNres];
  for (int i = 0; i < 6; ++i) r[i] = s[i] - o[i];
  r[6] = (s[6] - o[6]) / T(100);
  for (int i = 0; i < 7; ++i) ok = ok && finite_(s[i]) && finite_(o[i]);
  for (int i = 0; i < kNres; ++i) out[static_cast<size_t>(m) * kNres + i] = ok ? r[i] : T(1e6);
  finite[m] = ok;
}

// The whole forward arc of a row, a thread a row: coast t_c1, every segment,
// coast t_c2 (the terminal mass).
template <class T>
__global__ void __launch_bounds__(kThreads)
shoot_arc_kernel(const T* __restrict__ theta, const T* __restrict__ spiral, double thrust,
                 int n_segments, Consts c, T* __restrict__ out, uint8_t* __restrict__ finite,
                 int M) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const T* th = theta + static_cast<size_t>(m) * kNvar;
  const T dt_seg = (max_(th[0], T(1e-3)) / T(n_segments)) / T(kSegSteps);
  auto seg = [&](int k, T (&u)[3], T& thr) { plain_segment(th, k, u, thr); };
  T sf[7];
  for (int i = 0; i < 7; ++i) sf[i] = spiral[i];
  coast(sf, max_(th[1], T(0)) / T(kCoastSteps), thrust, c);
  segments(sf, 0, 1, n_segments, dt_seg, thrust, c, seg);
  coast(sf, max_(th[2], T(0)) / T(kCoastSteps), thrust, c);
  bool ok = true;
  for (int i = 0; i < 7; ++i) {
    out[static_cast<size_t>(m) * 7 + i] = sf[i];
    ok = ok && finite_(sf[i]);
  }
  finite[m] = ok;
}

// --- the float64 Jacobian's residual rows -----------------------------------------

// Row j of a lane's forward differences: theta with h_j added to variable
// j, each entry computed as the trial row theta + diag(h) holds it (an
// entry off the diagonal is theta + 0.0: a -0.0 becomes +0.0); col -1 is
// the base point.
struct FdRow {
  const double* th;
  const double* h;
  int col;
  __device__ __forceinline__ double operator[](int i) const {
    return __dadd_rn(th[i], i == col ? h[i] : 0.0);
  }
};

// The legs of a lane (mirrored by ops/cr3bp.py: fd_jobs, fd_job_of): job 0
// and 1 the base point's forward and backward legs; then every leg a column
// moves, column by column: 2, 3 column 0 (both legs), 4 column 1 (forward),
// 5 column 2 (backward), 6 + j column 3 + j of the segments' controls
// (forward below 3 + 3 n_fwd), 6 + 3 n + i column 63 + i (backward: the mass,
// the phase and the arc length through the target).
__host__ __device__ inline int fd_jobs(int n_segments) { return 9 + 3 * n_segments; }

__device__ __forceinline__ void fd_job(int q, int n_segments, int& col, bool& fwd) {
  const int n_fwd = (n_segments + 1) / 2;
  if (q < 6) {
    const int cols[6] = {-1, -1, 0, 0, 1, 2};
    col = cols[q];
    fwd = q == 0 || q == 2 || q == 4;
  } else if (q < 6 + 3 * n_segments) {
    col = q - 3;
    fwd = col < 3 + 3 * n_fwd;
  } else {
    col = q - 6 - 3 * n_segments + 63;
    fwd = false;
  }
}

// The job whose end state column col takes for its forward (fwd) or
// backward leg: the column's own where it moves that leg, else the base's.
__device__ __forceinline__ int fd_job_of(int col, bool fwd, int n_segments) {
  const int n_fwd = (n_segments + 1) / 2;
  const bool seg = col >= 3 && col < 3 + 3 * n_segments;
  if (fwd) {
    if (col == 0) return 2;
    if (col == 1) return 4;
    return seg && col < 3 + 3 * n_fwd ? col + 3 : 0;
  }
  if (col == 0) return 3;
  if (col == 2) return 5;
  if (seg) return col >= 3 + 3 * n_fwd ? col + 3 : 1;
  return col >= 63 ? col - 57 + 3 * n_segments : 1;
}

// A thread per (job, lane), job by job: the leg's end state into legs
// [job][lane][7] and its finite flag.  kFdThreads a block and kFdBlocks
// blocks an SM keep the 1,024-lane grid (70,656 threads at 20 segments) in
// one wave on 132 SMs: ptxas fits 96 registers and spills 136 bytes, which
// costs less than the second wave that 122 unspilled registers take (0.83
// against 1.08-1.19 ms; 64- and 32-thread blocks time as 128; PERF.md).
constexpr int kFdThreads = 128, kFdBlocks = 5;

__global__ void __launch_bounds__(kFdThreads, kFdBlocks)
fd_legs_kernel(const double* __restrict__ theta, const double* __restrict__ h,
               const double* __restrict__ tgt, const double* __restrict__ tgt_moved,
               const double* __restrict__ spiral, double thrust, int n_segments, Consts c,
               double* __restrict__ legs, uint8_t* __restrict__ ok, int L) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(fd_jobs(n_segments)) * L) return;
  const int q = static_cast<int>(t / L), lane = static_cast<int>(t % L);
  int col;
  bool fwd;
  fd_job(q, n_segments, col, fwd);
  const FdRow th{theta + static_cast<size_t>(lane) * kNvar, h + static_cast<size_t>(lane) * kNvar,
                 col};
  const double* tg = col >= 64 ? tgt_moved + (static_cast<size_t>(lane) * 2 + (col - 64)) * 6
                               : tgt + static_cast<size_t>(lane) * 6;
  double s[7];
  leg(fwd, th, spiral, tg, thrust, n_segments, c, s);
  bool f = true;
  for (int i = 0; i < 7; ++i) {
    legs[t * 7 + i] = s[i];
    f = f && finite_(s[i]);
  }
  ok[t] = f;
}

// A thread per (lane, column): the residual of the column's trial row from
// its two legs' end states, as shoot_legs_kernel forms it.
__global__ void __launch_bounds__(kThreads)
fd_rows_kernel(const double* __restrict__ tgt, const double* __restrict__ tgt_moved,
               const double* __restrict__ legs, const uint8_t* __restrict__ ok, int n_segments,
               double* __restrict__ out, int L) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(L) * kNvar) return;
  const int lane = static_cast<int>(t / kNvar), col = static_cast<int>(t % kNvar);
  const size_t qf = static_cast<size_t>(fd_job_of(col, true, n_segments)) * L + lane;
  const size_t qb = static_cast<size_t>(fd_job_of(col, false, n_segments)) * L + lane;
  const double* tg = col >= 64 ? tgt_moved + (static_cast<size_t>(lane) * 2 + (col - 64)) * 6
                               : tgt + static_cast<size_t>(lane) * 6;
  const double* sf = legs + qf * 7;
  const double* sb = legs + qb * 7;
  bool good = ok[qf] && ok[qb];
  for (int i = 0; i < 6; ++i) good = good && finite_(tg[i]);
  double r[kNres];
  for (int i = 0; i < 6; ++i) r[i] = sf[i] - sb[i];
  r[6] = (sf[6] - sb[6]) / 100.0;
  for (int i = 0; i < kNres; ++i) out[t * kNres + i] = good ? r[i] : 1e6;
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

// 1024 ballistic steps backward over length from seed (in place) over the
// chain's group of lanes.
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

// --- the float64 manifold chain over a group of lanes ---------------------------

// Lanes a row of manifold_target<double> takes (2 and 4 were measured;
// PERF.md).  A row's 1,280 RK4 steps run on kChainLanes64 lanes of one warp
// that all hold the whole state; a stage's square roots and divisions are
// spread over them and exchanged with __shfl_sync.  Every operation is
// written with an intrinsic that rounds it once (__fma_rn, __dmul_rn,
// __dadd_rn, __dsub_rn, __dsqrt_rn, __ddiv_rn), fused exactly where nvcc
// (12.9, -O3, sm_90a) fused the one-thread kernel this chain replaced: the
// same fields (ode6, dynamics_f64._ode12) in plain operators, a thread a
// row.  So nvcc has nothing left to contract, and the chain gives that
// kernel's bits: each lane divides the same operands the one thread
// divided, and division and square root round correctly.  Its fusions, read
// from its SASS (PERF.md): in the halo phase (ode12 with ode6 inside it,
// z^2 shared) ode6's distances (x_p^2 + y^2) + z^2 with x_p^2 fused and
// (x_m^2 + y^2) + z^2 with y^2 fused, ode12's y^2 + z^2 and u_k^2 + that
// with the first square fused, the dot (u dx + y dy) + z dz with the last
// two products fused, and each g = c u - i dx with c u fused; in the
// back-integration ode6's distances with both squares after the first
// fused; the direction's norm v0^2 + v1^2 + ... with every square but v1^2
// fused; RK4's s + h k and s + h6 (sum) fused; the sums of the field's
// terms and 2 k as the source writes them (a doubling is exact).
constexpr int kChainLanes64 = 4;

// The constants of the chain's fields, computed as the one-thread code
// computes them, and the lane's place in its row's group.
struct Lane64 {
  double mu, one_mu, neg_one_mu, mu_m1, one_mu3, mu3;
  int j;
};

__device__ __forceinline__ Lane64 lane64(int j, const Consts& c) {
  Lane64 L;
  L.mu = c.mu;
  L.one_mu = __dsub_rn(1.0, c.mu);
  L.neg_one_mu = -L.one_mu;
  L.mu_m1 = __dsub_rn(c.mu, 1.0);
  L.one_mu3 = __dmul_rn(3.0, L.one_mu);
  L.mu3 = __dmul_rn(3.0, c.mu);
  L.j = j;
  return L;
}

__device__ __forceinline__ double shfl64(double x, int src) {
  return __shfl_sync(0xffffffffu, x, src, kChainLanes64);
}

// The halo phase's field (dynamics_f64._ode12: the state and its tangent
// through the variational equations).  Its ten quotients: per primary p (0
// the Earth, 1 the Moon) ode6's three gravity terms c_p (u, y, z) / r^3 and
// the variational m_p / (r r^2), 3 m_p / (r r^2 r^2) from a second distance.
// Job 2 v + p (v 0: ode6's, 1: the variational) takes one square root and
// those divisions (a variational job divides m_p / (r r^2) twice, so that
// every lane runs the same instructions); 4 lanes run a job each, 2 lanes
// jobs p and 2 + p.
__device__ __forceinline__ void field12(const double (&t)[12], double (&d)[12], const Lane64& L) {
  constexpr int G = kChainLanes64, J = 4 / G;
  const double x = t[0], y = t[1], z = t[2];
  const double dx = t[6], dy = t[7], dz = t[8];
  const double xp = __dadd_rn(x, L.mu), xm = __dadd_rn(__dsub_rn(x, 1.0), L.mu);
  const double ux1 = __dadd_rn(x, L.mu_m1);
  const double yy = __dmul_rn(y, y), zz = __dmul_rn(z, z), yz2 = __fma_rn(y, y, zz);
  const double q6[2] = {__dadd_rn(__fma_rn(xp, xp, yy), zz),
                        __dadd_rn(__fma_rn(y, y, __dmul_rn(xm, xm)), zz)};
  const double qv[2] = {__fma_rn(xp, xp, yz2), __fma_rn(ux1, ux1, yz2)};
  double mine[J][3];
#pragma unroll
  for (int u = 0; u < J; ++u) {
    const int job = G == 4 ? L.j : 2 * u + L.j;
    const bool var = job >= 2, p = job & 1;
    const double arg = var ? qv[p] : q6[p];
    const double r = __dsqrt_rn(arg);
    const double pr = __dmul_rn(var ? arg : r, r);           // r r, or r r^2
    const double den = __dmul_rn(pr, var ? arg : r);         // r^3, or r r^2 r^2
    const double c6 = p ? L.mu : L.one_mu;                   // ode6's c_p, m_p
    const double n0 = var ? c6 : __dmul_rn(c6, p ? xm : xp);
    const double n1 = var ? (p ? L.mu3 : L.one_mu3) : __dmul_rn(c6, y);
    const double n2 = var ? c6 : __dmul_rn(p ? L.mu : L.neg_one_mu, z);
    mine[u][0] = __ddiv_rn(n0, var ? pr : den);
    mine[u][1] = __ddiv_rn(n1, den);
    mine[u][2] = __ddiv_rn(n2, var ? pr : den);
  }
  double q[2][2][3];                                         // [v][p][term]
#pragma unroll
  for (int v = 0; v < 2; ++v)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < 3 - v; ++i)
        q[v][p][i] = shfl64(mine[G == 4 ? 0 : v][i], G == 4 ? 2 * v + p : p);
  d[0] = t[3];
  d[1] = t[4];
  d[2] = t[5];
  d[3] = __dadd_rn(__dsub_rn(__dsub_rn(x, q[0][0][0]), q[0][1][0]), __dmul_rn(2.0, t[4]));
  d[4] = __dsub_rn(__dsub_rn(__dsub_rn(y, q[0][0][1]), q[0][1][1]), __dmul_rn(2.0, t[3]));
  d[5] = __dsub_rn(q[0][0][2], q[0][1][2]);
  double g[2][3];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const double ux = p ? ux1 : xp, ir3 = q[1][p][0];
    const double cd = __dmul_rn(q[1][p][1], __fma_rn(z, dz, __fma_rn(y, dy, __dmul_rn(ux, dx))));
    g[p][0] = __fma_rn(cd, ux, -__dmul_rn(ir3, dx));
    g[p][1] = __fma_rn(cd, y, -__dmul_rn(ir3, dy));
    g[p][2] = __fma_rn(cd, z, -__dmul_rn(ir3, dz));
  }
  d[6] = t[9];
  d[7] = t[10];
  d[8] = t[11];
  d[9] = __dadd_rn(__dadd_rn(__dadd_rn(g[0][0], g[1][0]), dx), __dmul_rn(2.0, t[10]));
  d[10] = __dsub_rn(__dadd_rn(__dadd_rn(g[0][1], g[1][1]), dy), __dmul_rn(2.0, t[9]));
  d[11] = __dadd_rn(g[0][2], g[1][2]);
}

// The back-integration's field (manifold.ode6_c): per primary one square
// root and three divisions.  2 lanes: lane p takes primary p; 4 lanes: lane
// j takes primary j % 2, the u and y terms (j < 2) or the z term (its second
// division a copy).
__device__ __forceinline__ void field6(const double (&t)[6], double (&d)[6], const Lane64& L) {
  constexpr int G = kChainLanes64;
  const double x = t[0], y = t[1], z = t[2];
  const double xp = __dadd_rn(x, L.mu), xm = __dadd_rn(__dsub_rn(x, 1.0), L.mu);
  const double yy = __dmul_rn(y, y);
  const double q6[2] = {__fma_rn(z, z, __fma_rn(xp, xp, yy)),
                        __fma_rn(z, z, __fma_rn(y, y, __dmul_rn(xm, xm)))};
  const int p = L.j & 1;
  const double r = __dsqrt_rn(q6[p]);
  const double den = __dmul_rn(__dmul_rn(r, r), r);
  const double c6 = p ? L.mu : L.one_mu;
  const double nu = __dmul_rn(c6, p ? xm : xp), ny = __dmul_rn(c6, y);
  const double nz = __dmul_rn(p ? L.mu : L.neg_one_mu, z);
  const bool zlane = G == 4 && L.j >= 2;
  const double m0 = __ddiv_rn(zlane ? nz : nu, den), m1 = __ddiv_rn(ny, den);
  const double m2 = G == 4 ? m0 : __ddiv_rn(nz, den);
  double q[2][3];                                            // [p][term]
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    q[k][0] = shfl64(m0, k);
    q[k][1] = shfl64(m1, k);
    q[k][2] = shfl64(m2, G == 4 ? 2 + k : k);
  }
  d[0] = t[3];
  d[1] = t[4];
  d[2] = t[5];
  d[3] = __dadd_rn(__dsub_rn(__dsub_rn(x, q[0][0]), q[1][0]), __dmul_rn(2.0, t[4]));
  d[4] = __dsub_rn(__dsub_rn(__dsub_rn(y, q[0][1]), q[1][1]), __dmul_rn(2.0, t[3]));
  d[5] = __dsub_rn(q[0][2], q[1][2]);
}

// One RK4 step, each operation rounded once: s + h k as an FMA, the stage
// sum in the source's order, h = dt / 2 and h6 = dt / 6 given.
template <int N, class F>
__device__ __forceinline__ void rk4_rn(double (&s)[N], double dt, double h, double h6, F&& f) {
  double k1[N], k2[N], k3[N], k4[N], t[N];
  f(s, k1);
  for (int i = 0; i < N; ++i) t[i] = __fma_rn(h, k1[i], s[i]);
  f(t, k2);
  for (int i = 0; i < N; ++i) t[i] = __fma_rn(h, k2[i], s[i]);
  f(t, k3);
  for (int i = 0; i < N; ++i) t[i] = __fma_rn(dt, k3[i], s[i]);
  f(t, k4);
  for (int i = 0; i < N; ++i)
    s[i] = __fma_rn(h6, __dadd_rn(__dadd_rn(__dadd_rn(k1[i], __dmul_rn(2.0, k2[i])),
                                            __dmul_rn(2.0, k3[i])), k4[i]), s[i]);
}

// Row m's float64 target on the lanes of its group: 256 halo steps, the
// seed 1e-4 along the normalised transported direction, 1024 steps back.
__device__ __forceinline__ void chain64(const double* s0, const double* v0, double period,
                                        double tau_frac, double length, const Lane64& L,
                                        double (&s)[6]) {
  const double dt = __ddiv_rn(__dmul_rn(clip_(tau_frac, 0.0, 1.0), period), double(kHaloSteps));
  const double h = __dmul_rn(0.5, dt), h6 = __ddiv_rn(dt, 6.0);
  double sv[12];
  for (int i = 0; i < 6; ++i) {
    sv[i] = s0[i];
    sv[6 + i] = v0[i];
  }
  for (int i = 0; i < kHaloSteps; ++i)
    rk4_rn(sv, dt, h, h6, [&](const double (&a)[12], double (&da)[12]) { field12(a, da, L); });
  double nrm = __dmul_rn(sv[7], sv[7]);
  nrm = __fma_rn(sv[6], sv[6], nrm);
  for (int i = 2; i < 6; ++i) nrm = __fma_rn(sv[6 + i], sv[6 + i], nrm);
  nrm = __dadd_rn(__dsqrt_rn(nrm), 1e-30);
  for (int i = 0; i < 6; ++i) s[i] = __fma_rn(1e-4, __ddiv_rn(sv[6 + i], nrm), sv[i]);
  const double db = __ddiv_rn(-length, double(kManifoldSteps));
  const double hb = __dmul_rn(0.5, db), h6b = __ddiv_rn(db, 6.0);
  for (int i = 0; i < kManifoldSteps; ++i)
    rk4_rn(s, db, hb, h6b, [&](const double (&a)[6], double (&da)[6]) { field6(a, da, L); });
}

// --- manifold target -----------------------------------------------------------

// Row m = t / G runs on the lanes j = t % G of its group (G kChainLanes64 in
// float64, kChainLanes in float32); a group past the last row runs the last
// row and stores nothing, a warp wholly past it returns, so every warp that
// runs the chain is whole; lane j stores components j, j + G, ... below 6.
template <class T>
__global__ void __launch_bounds__(kThreads)
manifold_target_kernel(const T* __restrict__ state0, const T* __restrict__ period,
                       const T* __restrict__ vstable, const T* __restrict__ tau_frac,
                       const T* __restrict__ length, Consts c, T* __restrict__ out, int M) {
  constexpr bool f64 = std::is_same<T, double>::value;
  constexpr int G = f64 ? kChainLanes64 : kChainLanes;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((t & ~31LL) >= static_cast<long long>(M) * G) return;
  const int row = static_cast<int>(t / G), j = static_cast<int>(t % G);
  const int m = row < M ? row : M - 1;
  if constexpr (f64) {
    double s[6];
    chain64(state0 + static_cast<size_t>(m) * 6, vstable + static_cast<size_t>(m) * 6, period[m],
            tau_frac[m], length[m], lane64(j, c), s);
    if (row < M)
      for (int i = j; i < 6; i += G) out[static_cast<size_t>(m) * 6 + i] = s[i];
  } else {
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

// The leg columns: a job per (lane, leg, column) integrates its leg once
// on Dual<float>, the column's tangent seeded where it enters.  The jobs,
// in the grid's order (mirrored by ops/cr3bp.py: jvp_jobs): on the forward
// leg t_shoot, t_c1 and each forward segment's controls (a, b, throttle);
// on the backward leg t_shoot, t_c2, the mass, each backward segment's
// controls, and the six components of its start state (the target), whose
// tangents give the leg's sensitivity Phi [7 x 6] to its target.  A job
// carrying 2 or 3 tangents on one real trajectory, and a job on a pair of
// lanes that split the field by primary, were measured and lost (PERF.md).
// kSeedState + i: the code of a job seeded on the start state component i.
constexpr int kSeedState = 100;

// The per-lane scratch between shoot_jvp's two launches (floats): t_shoot's
// forward and backward tangents, Phi, and the target's tangents dT/dtheta
// for the phase (64) and the arc length (65) from the chain.
constexpr int kScrF0 = 0, kScrB0 = 7, kScrPhi = 14, kScrDT = 14 + 7 * 6;
constexpr int kJvpScratch = kScrDT + 2 * 6;

// Leg jobs a lane: 2 + 3 n_fwd forward, 9 + 3 (n_segments - n_fwd) backward.
__host__ __device__ inline int jvp_leg_jobs(int n_segments) { return 11 + 3 * n_segments; }

// Job q's column, and whether it runs the forward leg.
__device__ __forceinline__ bool jvp_job(int q, int n_segments, int& col) {
  const int n_fwd = (n_segments + 1) / 2, n_f = 2 + 3 * n_fwd;
  if (q < n_f) {
    col = q < 2 ? q : q + 1;                                 // t_shoot, t_c1, segments
    return true;
  }
  const int r = q - n_f, n_b = 3 + 3 * (n_segments - n_fwd);
  if (r < 3)
    col = r == 0 ? 0 : (r == 1 ? 2 : 63);                    // t_shoot, t_c2, mass
  else if (r < n_b)
    col = r + 3 * n_fwd;                                     // backward segments
  else
    col = kSeedState + (r - n_b);                            // the start state
  return false;
}

// A job's leg: forward from the spiral end or backward from the lane's
// target, as leg() runs it, the tangent seeded where its column enters
// (t_shoot and the coast times at the start, a segment's controls at that
// segment, the mass and the start state at the start).  Both directions run
// the same instructions on selected operands, so that a warp of mixed jobs
// does not diverge.
__device__ __forceinline__ void jvp_leg(bool fwd, int col, const float* th, const float* spiral,
                                        const float* tgt, double thrust, int n_segments,
                                        const Consts& c, Dual<float> (&s)[7]) {
  using D = Dual<float>;
  auto var = [&](float v, int k, float dv) { return D{v, col == k ? dv : 0.f}; };
  const int n_fwd = (n_segments + 1) / 2;
  const D t_shoot = var(max_(th[0], 1e-3f), 0, max_d(th[0], 1e-3f));
  const D dt_seg = (t_shoot / float(n_segments)) / float(kSegSteps);
  for (int i = 0; i < 6; ++i) s[i] = var(fwd ? spiral[i] : tgt[i], kSeedState + i, 1.f);
  const D mass = var(clip_(th[63], 301.f, 752.f), 63, clip_d(th[63], 301.f, 752.f));
  s[6] = fwd ? D{spiral[6], 0.f} : mass;
  const D t_c1 = var(max_(th[1], 0.f), 1, max_d(th[1], 0.f));
  const D t_c2 = var(max_(th[2], 0.f), 2, max_d(th[2], 0.f));
  const D tc = fwd ? t_c1 : -t_c2;
  const int k0 = fwd ? 0 : n_segments - 1, step = fwd ? 1 : -1;
  const int n = fwd ? n_fwd : n_segments - n_fwd;
  const D dt = fwd ? dt_seg : -dt_seg;
  auto seg = [&](int k, D (&u)[3], D& thr) {
    const D a = var(th[3 + 3 * k], 3 + 3 * k, 1.f);
    const D b = var(th[4 + 3 * k], 4 + 3 * k, 1.f);
    const float r = th[5 + 3 * k];
    thr = var(clip_(r, 0.f, 1.f), 5 + 3 * k, clip_d(r, 0.f, 1.f));
    u[0] = cos_(b) * cos_(a);
    u[1] = cos_(b) * sin_(a);
    u[2] = sin_(b);
  };
  coast(s, tc / float(kCoastSteps), thrust, c);
  segments(s, k0, step, n, dt, thrust, c, seg);
}

// Threads of each target column: L groups of kChainLanes, whole warps.
__host__ __device__ inline long long jvp_target_threads(int L) {
  return (static_cast<long long>(L) * kChainLanes + 31) / 32 * 32;
}

// Threads of shoot_jvp_kernel's grid at L lanes.
__host__ __device__ inline long long jvp_threads(int L, int n_segments) {
  return 2 * jvp_target_threads(L) + static_cast<long long>(jvp_leg_jobs(n_segments)) * L;
}

// The target columns come first, so that their chains start in the first
// wave: threads [0, R) run column 64 and [R, 2R) column 65, a lane a group
// of kChainLanes as in manifold_target (the groups past L masked), each to
// the target's tangent dT; then the leg jobs, job by job, L threads each.
// A leg job stores its column's entries of J (a backward column as 0 - its
// tangent: the residual is the forward leg's end less the backward one's),
// or t_shoot's tangents or a column of Phi into the scratch; shoot_jvp_combine_kernel forms the rest.  Mirrored
// by ops/cr3bp.py: jvp_layout.
__global__ void __launch_bounds__(kThreads)
shoot_jvp_kernel(const float* __restrict__ theta, const float* __restrict__ tgt,
                 const float* __restrict__ state0, const float* __restrict__ period,
                 const float* __restrict__ vstable, const float* __restrict__ spiral,
                 double thrust, int n_segments, float min_mani, float max_mani, Consts c,
                 float* __restrict__ J, float* __restrict__ scratch, int L) {
  using D = Dual<float>;
  constexpr int G = kChainLanes;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per_col = jvp_target_threads(L);
  if (t >= jvp_threads(L, n_segments)) return;
  if (t < 2 * per_col) {
    // the target's columns: the phase (64) and the arc length (65)
    const int col = 64 + static_cast<int>(t / per_col);
    const long long u = t % per_col;
    const int grp = static_cast<int>(u / G), j = static_cast<int>(u % G);
    const int lane = grp < L ? grp : L - 1;
    const float* th = theta + static_cast<size_t>(lane) * kNvar;
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
    if (grp < L && j < 6)
      scratch[static_cast<size_t>(lane) * kJvpScratch + kScrDT + (col - 64) * 6 + j] = seed[j].d;
    return;
  }
  {
    // the legs against the fixed target, a column a thread
    const long long v = t - 2 * per_col;
    const int q = static_cast<int>(v / L), lane = static_cast<int>(v % L);
    int col;
    const bool fwd = jvp_job(q, n_segments, col);
    const float* th = theta + static_cast<size_t>(lane) * kNvar;
    D s[7];
    jvp_leg(fwd, col, th, spiral, tgt + static_cast<size_t>(lane) * 6, thrust, n_segments, c, s);
    float* w = scratch + static_cast<size_t>(lane) * kJvpScratch;
    float out[kNres];
    for (int i = 0; i < kNres; ++i) out[i] = fwd ? s[i].d : 0.f - s[i].d;
    out[6] = out[6] / 100.f;
    for (int i = 0; i < kNres; ++i) {
      if (col == 0)
        w[(fwd ? kScrF0 : kScrB0) + i] = s[i].d;
      else if (col >= kSeedState)
        w[kScrPhi + i * 6 + (col - kSeedState)] = s[i].d;
      else
        J[(static_cast<size_t>(lane) * kNres + i) * kNvar + col] = out[i];
    }
  }
}

// A thread per (lane, row of J): column 0 from t_shoot's two legs (forward
// minus backward), the target columns as
// -Phi dT (the target's tangent carried through the backward leg: exact in
// real arithmetic, as a tangent's transport is linear in its seed), and
// zeros in the columns of segments past n_segments.
__global__ void __launch_bounds__(kThreads)
shoot_jvp_combine_kernel(const float* __restrict__ scratch, int n_segments,
                         float* __restrict__ J, int L) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(L) * kNres) return;
  const int lane = static_cast<int>(t / kNres), i = static_cast<int>(t % kNres);
  const float* w = scratch + static_cast<size_t>(lane) * kJvpScratch;
  float* row = J + static_cast<size_t>(t) * kNvar;
  float out = w[kScrF0 + i] - w[kScrB0 + i];
  row[0] = i == 6 ? out / 100.f : out;
  for (int cc = 0; cc < 2; ++cc) {
    const float* dT = w + kScrDT + cc * 6;
    const float* phi = w + kScrPhi + i * 6;
    float acc = phi[0] * dT[0];
    for (int k = 1; k < 6; ++k) acc = acc + phi[k] * dT[k];
    out = -acc;
    row[64 + cc] = i == 6 ? out / 100.f : out;
  }
  for (int col = 3 + 3 * n_segments; col < 63; ++col) row[col] = 0.f;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Consts c = consts(mu, a_coef, mdot_div, tu_s);
  if (full)
    shoot_arc_kernel<T><<<blocks_for(M), kThreads, 0, st>>>(
        static_cast<const T*>(theta), static_cast<const T*>(spiral), thrust, n_segments, c,
        static_cast<T*>(out), static_cast<uint8_t*>(finite), M);
  else
    shoot_legs_kernel<T><<<blocks_for(2LL * M), kThreads, 0, st>>>(
        static_cast<const T*>(theta), static_cast<const T*>(tgt), static_cast<const T*>(spiral),
        thrust, n_segments, c, static_cast<T*>(out), static_cast<uint8_t*>(finite), M);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_manifold_target(const void* state0, const void* period, const void* vstable,
                           const void* tau_frac, const void* length, double mu, double a_coef,
                           double mdot_div, double tu_s, void* out, int M, void* stream) {
  if (M < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads =
      static_cast<long long>(M) * (std::is_same<T, double>::value ? kChainLanes64 : kChainLanes);
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

// theta [L, 66], h [L, 66], tgt [L, 6], tgt_moved [L, 2, 6], spiral [7];
// legs [9 + 3 n_segments, L, 7] and ok [9 + 3 n_segments, L] (uint8) the
// legs' end states and flags between the two launches; out [L, 66, 7]:
// contiguous float64.  Returns a cudaError_t.
int rdm_shoot_legs_fd_f64(const void* theta, const void* h, const void* tgt,
                          const void* tgt_moved, const void* spiral, double thrust,
                          int n_segments, double mu, double a_coef, double mdot_div, double tu_s,
                          void* legs, void* ok, void* out, int L, void* stream) {
  if (L < 1 || n_segments < 1 || n_segments > 20) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long legs_threads = static_cast<long long>(fd_jobs(n_segments)) * L;
  fd_legs_kernel<<<static_cast<int>((legs_threads + kFdThreads - 1) / kFdThreads), kFdThreads, 0,
                   st>>>(
      static_cast<const double*>(theta), static_cast<const double*>(h),
      static_cast<const double*>(tgt), static_cast<const double*>(tgt_moved),
      static_cast<const double*>(spiral), thrust, n_segments, consts(mu, a_coef, mdot_div, tu_s),
      static_cast<double*>(legs), static_cast<uint8_t*>(ok), L);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  fd_rows_kernel<<<blocks_for(static_cast<long long>(L) * kNvar), kThreads, 0, st>>>(
      static_cast<const double*>(tgt), static_cast<const double*>(tgt_moved),
      static_cast<const double*>(legs), static_cast<const uint8_t*>(ok), n_segments,
      static_cast<double*>(out), L);
  return static_cast<int>(cudaGetLastError());
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
// spiral [7], J [L, 7, 66], scratch [L, rdm_shoot_jvp_scratch()] between the
// two launches: contiguous float32.
int rdm_shoot_jvp_f32(const void* theta, const void* tgt, const void* state0, const void* period,
                      const void* vstable, const void* spiral, double thrust, int n_segments,
                      double min_mani, double max_mani, double mu, double a_coef,
                      double mdot_div, double tu_s, void* J, void* scratch, int L,
                      void* stream) {
  if (L < 1 || n_segments < 1 || n_segments > 20) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  shoot_jvp_kernel<<<blocks_for(jvp_threads(L, n_segments)), kThreads, 0, st>>>(
      static_cast<const float*>(theta), static_cast<const float*>(tgt),
      static_cast<const float*>(state0), static_cast<const float*>(period),
      static_cast<const float*>(vstable), static_cast<const float*>(spiral), thrust, n_segments,
      static_cast<float>(min_mani), static_cast<float>(max_mani),
      consts(mu, a_coef, mdot_div, tu_s), static_cast<float*>(J), static_cast<float*>(scratch),
      L);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  shoot_jvp_combine_kernel<<<blocks_for(static_cast<long long>(L) * kNres), kThreads, 0, st>>>(
      static_cast<const float*>(scratch), n_segments, static_cast<float*>(J), L);
  return static_cast<int>(cudaGetLastError());
}

// shoot_jvp's floats of scratch a lane and its leg jobs a lane
// (ops/cr3bp.py: JVP_SCRATCH, jvp_jobs).
int rdm_shoot_jvp_scratch() { return kJvpScratch; }
int rdm_shoot_jvp_leg_jobs(int n_segments) { return jvp_leg_jobs(n_segments); }

// The lanes a row of the float32 and the float64 chain take as built
// (ops/cr3bp.py: LANES).
int rdm_shoot_chain_lanes() { return kChainLanes; }
int rdm_shoot_chain_lanes_f64() { return kChainLanes64; }

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
