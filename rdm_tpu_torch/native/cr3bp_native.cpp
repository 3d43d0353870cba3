// Native CR3BP warm-start validation oracle (manifold-faithful).
//
// The reference delegates all astrodynamics to the external prebuilt
// `pydylan` C++ package (CR3BP equations of motion, Halo orbits, SNOPT
// NLP solve; SURVEY.md section 2.6; wiring at
// GTO_Halo_DM/data_generation_scripts/
// cr3bp_earth_mission_simulator_boundary_diffusion_warmstart.py:87-224).
// This translation unit is the framework's own native equivalent of that
// NLP's local solve:
//
//  * free variables = the FULL 66-dim warm start [t_shoot, t_c1, t_c2,
//    20 x (alpha, beta, throttle), mass, halo-phase-fraction,
//    manifold-length];
//  * start boundary: the fixed GTO-spiral end state (:148);
//  * end boundary: the StableLeft stable-manifold arc of the L1 halo,
//    parametrised by the orbit phase (guess[-2], un-normalised by the
//    halo period, :165) and arc length in [5, 11] (guess[-1])
//    (:155-157) — per-sample halo family data (seed state, period,
//    stable eigenvector) is interpolated host-side from
//    rdm_tpu_torch/physics/halo.py's family table and passed in;
//  * forward-backward shooting (the reference's evaluation
//    transcription, :192): forward from the spiral boundary, backward
//    from the manifold target (terminal mass = the mass variable), the
//    7-dim residual is the midpoint defect + mass binding;
//  * Levenberg-Marquardt local solve = feasibility; an optional
//    projected-gradient mass-ascent phase with a stationarity
//    certificate = the reference's `solver_mode optimal` / inform 1
//    (:116-127).
//
// Batch entry points fan out over a std::thread pool, mirroring the
// reference's ThreadPoolExecutor SNOPT fan-out
// (Benchmark/gto_halo_multithreading.py:607-667).
//
// Units, dynamics, and every step count match rdm_tpu/physics/
// {cr3bp,manifold,solver_tpu}.py exactly (f64 here vs f32 there).  This
// is the PyTorch port's own copy of rdm_tpu/native/cr3bp_native.cpp; its
// code is the same, so both packages' oracles grade alike on one host.

#include <atomic>
#include <cmath>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#if defined(__SSE2__) || defined(__x86_64__)
#include <xmmintrin.h>
#endif

namespace {

constexpr double MU_EARTH = 398600.435507;  // km^3/s^2
constexpr double MU_MOON = 4902.800118;
constexpr double MU = MU_MOON / (MU_EARTH + MU_MOON);
constexpr double DU_KM = 384400.0;
const double TU_S = std::sqrt(DU_KM * DU_KM * DU_KM / (MU_EARTH + MU_MOON));
constexpr double G0 = 9.80665e-3;  // km/s^2
constexpr double ISP_S = 1000.0;

// Mirrors solver_tpu.py / manifold.py exactly.
constexpr int NVAR = 66;
constexpr int NRES = 7;
constexpr double MASS_SCALE = 100.0;
// Default mass-variable box: the reference's min/max_mass_to_sample
// window (408-470 kg) — also the training-data normalisation window, so
// solved masses stay inside the diffusion model's unit hypercube.
constexpr double MASS_MIN = 408.0;
constexpr double MASS_MAX = 470.0;
constexpr int COAST_STEPS = 32;
constexpr int SEG_STEPS = 16;
constexpr int N_HALO_STEPS = 256;
constexpr int N_MANIFOLD_STEPS = 1024;
constexpr double MANIFOLD_EPS = 1e-4;
constexpr int OPT_BUDGET = 96;      // extra iterations for the ascent phase
constexpr double OPT_GAIN_KG = 2.0;  // initial mass-target ratchet step
constexpr double OPT_GAIN_MAX = 64.0;  // kg cap for the growing ratchet
constexpr double OPT_GAIN_TOL = 0.25;  // kg: collapse => inform 1

struct State7 {
  double v[7];  // x y z vx vy vz m
};

// d/dt of [x y z vx vy vz m]: CR3BP gravity + rotating-frame terms +
// low-thrust acceleration + Tsiolkovsky mass flow (cr3bp.py:eom).
inline void eom(const State7& s, const double u[3], double throttle,
                double thrust_n, State7& ds) {
  const double x = s.v[0], y = s.v[1], z = s.v[2];
  const double vx = s.v[3], vy = s.v[4], vz = s.v[5];
  const double m = s.v[6] > 1e-6 ? s.v[6] : 1e-6;
  const double dx1 = x + MU, dx2 = x - 1.0 + MU;
  const double r1 = std::sqrt(dx1 * dx1 + y * y + z * z);
  const double r2 = std::sqrt(dx2 * dx2 + y * y + z * z);
  const double r13 = r1 * r1 * r1, r23 = r2 * r2 * r2;
  const double one_mu = 1.0 - MU;
  const double amag =
      throttle * thrust_n / m * (TU_S * TU_S / (DU_KM * 1000.0));
  ds.v[0] = vx;
  ds.v[1] = vy;
  ds.v[2] = vz;
  ds.v[3] = x - one_mu * dx1 / r13 - MU * dx2 / r23 + 2.0 * vy + amag * u[0];
  ds.v[4] = y - one_mu * y / r13 - MU * y / r23 - 2.0 * vx + amag * u[1];
  ds.v[5] = -one_mu * z / r13 - MU * z / r23 + amag * u[2];
  ds.v[6] = -throttle * thrust_n / (ISP_S * G0 * 1000.0) * TU_S;
}

inline void axpy(State7& out, const State7& a, double h, const State7& b) {
  for (int i = 0; i < 7; ++i) out.v[i] = a.v[i] + h * b.v[i];
}

// Fixed-step RK4, identical stencil to cr3bp.py:_rk4_step/propagate.
void propagate(State7& s, const double u[3], double throttle, double thrust_n,
               double tof, int n_steps) {
  const double dt = tof / n_steps;
  State7 k1, k2, k3, k4, tmp;
  for (int i = 0; i < n_steps; ++i) {
    eom(s, u, throttle, thrust_n, k1);
    axpy(tmp, s, 0.5 * dt, k1);
    eom(tmp, u, throttle, thrust_n, k2);
    axpy(tmp, s, 0.5 * dt, k2);
    eom(tmp, u, throttle, thrust_n, k3);
    axpy(tmp, s, dt, k3);
    eom(tmp, u, throttle, thrust_n, k4);
    for (int j = 0; j < 7; ++j)
      s.v[j] += dt / 6.0 * (k1.v[j] + 2.0 * k2.v[j] + 2.0 * k3.v[j] + k4.v[j]);
  }
}

inline double jacobi_energy(const State7& s) {
  const double x = s.v[0], y = s.v[1], z = s.v[2];
  const double dx1 = x + MU, dx2 = x - 1.0 + MU;
  const double r1 = std::sqrt(dx1 * dx1 + y * y + z * z);
  const double r2 = std::sqrt(dx2 * dx2 + y * y + z * z);
  const double omega = 0.5 * (x * x + y * y) + (1.0 - MU) / r1 + MU / r2;
  const double v2 = s.v[3] * s.v[3] + s.v[4] * s.v[4] + s.v[5] * s.v[5];
  return 0.5 * v2 - omega;
}

// --- ballistic 6-state + tangent-vector dynamics (manifold.py twin) ----

// d/dt of [x..vz] and, via the variational equations, of a tangent v.
inline void eom12(const double s[6], const double t[6], double ds[6],
                  double dt[6]) {
  const double x = s[0], y = s[1], z = s[2];
  const double dx1 = x + MU, dx2 = x - 1.0 + MU;
  const double r1s = dx1 * dx1 + y * y + z * z;
  const double r2s = dx2 * dx2 + y * y + z * z;
  const double r1 = std::sqrt(r1s), r2 = std::sqrt(r2s);
  const double r13 = r1 * r1s, r23 = r2 * r2s;
  const double r15 = r13 * r1s, r25 = r23 * r2s;
  const double one_mu = 1.0 - MU;

  ds[0] = s[3];
  ds[1] = s[4];
  ds[2] = s[5];
  ds[3] = x - one_mu * dx1 / r13 - MU * dx2 / r23 + 2.0 * s[4];
  ds[4] = y - one_mu * y / r13 - MU * y / r23 - 2.0 * s[3];
  ds[5] = -one_mu * z / r13 - MU * z / r23;

  // Hessian of the effective potential Omega (halo.py:_uxx)
  double H[3][3];
  const double rv1[3] = {dx1, y, z};
  const double rv2[3] = {dx2, y, z};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double h = (i == j && i < 2) ? 1.0 : 0.0;
      h -= one_mu * ((i == j ? 1.0 : 0.0) / r13 - 3.0 * rv1[i] * rv1[j] / r15);
      h -= MU * ((i == j ? 1.0 : 0.0) / r23 - 3.0 * rv2[i] * rv2[j] / r25);
      H[i][j] = h;
    }
  dt[0] = t[3];
  dt[1] = t[4];
  dt[2] = t[5];
  dt[3] = H[0][0] * t[0] + H[0][1] * t[1] + H[0][2] * t[2] + 2.0 * t[4];
  dt[4] = H[1][0] * t[0] + H[1][1] * t[1] + H[1][2] * t[2] - 2.0 * t[3];
  dt[5] = H[2][0] * t[0] + H[2][1] * t[1] + H[2][2] * t[2];
}

void propagate12(double s[6], double t[6], double tof, int n_steps) {
  const double dt = tof / n_steps;
  double k1s[6], k2s[6], k3s[6], k4s[6];
  double k1t[6], k2t[6], k3t[6], k4t[6];
  double ts[6], tt[6];
  for (int i = 0; i < n_steps; ++i) {
    eom12(s, t, k1s, k1t);
    for (int j = 0; j < 6; ++j) {
      ts[j] = s[j] + 0.5 * dt * k1s[j];
      tt[j] = t[j] + 0.5 * dt * k1t[j];
    }
    eom12(ts, tt, k2s, k2t);
    for (int j = 0; j < 6; ++j) {
      ts[j] = s[j] + 0.5 * dt * k2s[j];
      tt[j] = t[j] + 0.5 * dt * k2t[j];
    }
    eom12(ts, tt, k3s, k3t);
    for (int j = 0; j < 6; ++j) {
      ts[j] = s[j] + dt * k3s[j];
      tt[j] = t[j] + dt * k3t[j];
    }
    eom12(ts, tt, k4s, k4t);
    for (int j = 0; j < 6; ++j) {
      s[j] += dt / 6.0 * (k1s[j] + 2.0 * k2s[j] + 2.0 * k3s[j] + k4s[j]);
      t[j] += dt / 6.0 * (k1t[j] + 2.0 * k2t[j] + 2.0 * k3t[j] + k4t[j]);
    }
  }
}

void propagate6(double s[6], double tof, int n_steps) {
  // ballistic: reuse the 7-state integrator with zero thrust
  State7 st;
  std::memcpy(st.v, s, 6 * sizeof(double));
  st.v[6] = 1.0;
  const double zero_u[3] = {0.0, 0.0, 0.0};
  propagate(st, zero_u, 0.0, 0.0, tof, n_steps);
  std::memcpy(s, st.v, 6 * sizeof(double));
}

// Stable-manifold arc end state (manifold.py:manifold_target twin):
// halo seed -> phase tau (transporting the stable eigenvector) ->
// eps-perturb -> integrate BACKWARD length time units.
void manifold_target(const double halo_seed[6], double period,
                     const double vstable[6], double tau_frac, double length,
                     double out[6]) {
  double s[6], t[6];
  std::memcpy(s, halo_seed, sizeof(s));
  std::memcpy(t, vstable, sizeof(t));
  double tf = tau_frac < 0.0 ? 0.0 : (tau_frac > 1.0 ? 1.0 : tau_frac);
  propagate12(s, t, tf * period, N_HALO_STEPS);
  double n = 0.0;
  for (int j = 0; j < 6; ++j) n += t[j] * t[j];
  n = std::sqrt(n) + 1e-300;
  for (int j = 0; j < 6; ++j) out[j] = s[j] + MANIFOLD_EPS * t[j] / n;
  propagate6(out, -length, N_MANIFOLD_STEPS);
}

// --- forward-backward shooting (solver_tpu.py twins) -------------------

// Guess layout per prepare_training_data.py (SURVEY.md 2.6): [t_shoot,
// t_c1, t_c2, n_seg x (alpha, beta, r), mass, halo_period_frac,
// manifold_len].
void shoot_forward(const double* g, int n_segments, int n_fwd,
                   double thrust_n, const double* spiral_end, State7& out) {
  State7 s;
  std::memcpy(s.v, spiral_end, sizeof(s.v));
  const double zero_u[3] = {0.0, 0.0, 0.0};
  const double t_shoot = g[0] > 1e-3 ? g[0] : 1e-3;
  const double t_c1 = g[1] > 0.0 ? g[1] : 0.0;
  propagate(s, zero_u, 0.0, thrust_n, t_c1, COAST_STEPS);
  const double seg_dt = t_shoot / n_segments;
  for (int k = 0; k < n_fwd; ++k) {
    const double alpha = g[3 + 3 * k];
    const double beta = g[3 + 3 * k + 1];
    double r = g[3 + 3 * k + 2];
    r = r < 0.0 ? 0.0 : (r > 1.0 ? 1.0 : r);
    const double u[3] = {std::cos(beta) * std::cos(alpha),
                         std::cos(beta) * std::sin(alpha), std::sin(beta)};
    propagate(s, u, r, thrust_n, seg_dt, SEG_STEPS);
  }
  out = s;
}

void shoot_backward(const double* g, int n_segments, int n_fwd,
                    double thrust_n, const double target6[6], State7& out) {
  State7 s;
  std::memcpy(s.v, target6, 6 * sizeof(double));
  double m = g[63];
  // physical sanity only — the NLP's mass box is enforced by clamp_vars
  s.v[6] = m < 301.0 ? 301.0 : (m > 752.0 ? 752.0 : m);
  const double zero_u[3] = {0.0, 0.0, 0.0};
  const double t_shoot = g[0] > 1e-3 ? g[0] : 1e-3;
  const double t_c2 = g[2] > 0.0 ? g[2] : 0.0;
  propagate(s, zero_u, 0.0, thrust_n, -t_c2, COAST_STEPS);
  const double seg_dt = t_shoot / n_segments;
  for (int k = n_segments - 1; k >= n_fwd; --k) {
    const double alpha = g[3 + 3 * k];
    const double beta = g[3 + 3 * k + 1];
    double r = g[3 + 3 * k + 2];
    r = r < 0.0 ? 0.0 : (r > 1.0 ? 1.0 : r);
    const double u[3] = {std::cos(beta) * std::cos(alpha),
                         std::cos(beta) * std::sin(alpha), std::sin(beta)};
    propagate(s, u, r, thrust_n, -seg_dt, SEG_STEPS);
  }
  out = s;
}

void shoot_full(const double* g, int n_segments, double thrust_n,
                const double* spiral_end, State7& out) {
  shoot_forward(g, n_segments, n_segments, thrust_n, spiral_end, out);
  const double zero_u[3] = {0.0, 0.0, 0.0};
  const double t_c2 = g[2] > 0.0 ? g[2] : 0.0;
  propagate(out, zero_u, 0.0, thrust_n, t_c2, COAST_STEPS);
}

struct HaloData {
  const double* seed;     // [6]
  double period;
  const double* vstable;  // [6]
  double min_mani, max_mani;
};

// 7-vector matching residual given a PRECOMPUTED manifold target:
// the forward/backward midpoint defect (6) + mass binding (1).
void residual7_with_target(const double* g, int n_segments, double thrust_n,
                           const double* spiral_end, const double target6[6],
                           double r_out[NRES]) {
  const int n_fwd = (n_segments + 1) / 2;
  State7 sf, sb;
  shoot_forward(g, n_segments, n_fwd, thrust_n, spiral_end, sf);
  shoot_backward(g, n_segments, n_fwd, thrust_n, target6, sb);
  bool finite = true;
  for (int i = 0; i < 7; ++i)
    finite &= std::isfinite(sf.v[i]) && std::isfinite(sb.v[i]);
  if (!finite) {
    for (int i = 0; i < NRES; ++i) r_out[i] = 1e6;
    return;
  }
  for (int i = 0; i < 6; ++i) r_out[i] = sf.v[i] - sb.v[i];
  r_out[6] = (sf.v[6] - sb.v[6]) / MASS_SCALE;
}

void compute_target(const double* g, const HaloData& h, double target6[6]) {
  double L = g[65];
  L = L < h.min_mani ? h.min_mani : (L > h.max_mani ? h.max_mani : L);
  manifold_target(h.seed, h.period, h.vstable, g[64], L, target6);
}

void residual7(const double* g, int n_segments, double thrust_n,
               const double* spiral_end, const HaloData& h,
               double r_out[NRES]) {
  double target6[6];
  compute_target(g, h, target6);
  bool finite = true;
  for (int i = 0; i < 6; ++i) finite &= std::isfinite(target6[i]);
  if (!finite) {
    for (int i = 0; i < NRES; ++i) r_out[i] = 1e6;
    return;
  }
  residual7_with_target(g, n_segments, thrust_n, spiral_end, target6, r_out);
}

inline void clamp_vars(double* g, int n_segments, double max_shoot,
                       double max_coast, double min_shoot, double min_mani,
                       double max_mani, double mass_min = MASS_MIN,
                       double mass_max = MASS_MAX) {
  const double lo_shoot = min_shoot > 1e-3 ? min_shoot : 1e-3;
  g[0] = g[0] < lo_shoot ? lo_shoot : (g[0] > max_shoot ? max_shoot : g[0]);
  for (int i = 1; i <= 2; ++i)
    g[i] = g[i] < 0.0 ? 0.0 : (g[i] > max_coast ? max_coast : g[i]);
  for (int k = 0; k < n_segments; ++k) {
    double& r = g[3 + 3 * k + 2];
    r = r < 0.0 ? 0.0 : (r > 1.0 ? 1.0 : r);
  }
  g[63] = g[63] < mass_min ? mass_min : (g[63] > mass_max ? mass_max : g[63]);
  g[64] = g[64] < 0.0 ? 0.0 : (g[64] > 1.0 ? 1.0 : g[64]);
  g[65] = g[65] < min_mani ? min_mani : (g[65] > max_mani ? max_mani : g[65]);
}

// Solve the N x N system (J J^T + lambda I) a = -r by Gaussian
// elimination with partial pivoting; the min-norm LM step is d = J^T a.
template <int N>
bool solve_res(double A[N][N], const double b[N], double x[N]) {
  double M[N][N + 1];
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j < N; ++j) M[i][j] = A[i][j];
    M[i][N] = b[i];
  }
  for (int c = 0; c < N; ++c) {
    int p = c;
    for (int rr = c + 1; rr < N; ++rr)
      if (std::fabs(M[rr][c]) > std::fabs(M[p][c])) p = rr;
    if (std::fabs(M[p][c]) < 1e-300) return false;
    if (p != c)
      for (int j = 0; j <= N; ++j) std::swap(M[p][j], M[c][j]);
    for (int rr = 0; rr < N; ++rr) {
      if (rr == c) continue;
      const double f = M[rr][c] / M[c][c];
      for (int j = c; j <= N; ++j) M[rr][j] -= f * M[c][j];
    }
  }
  for (int i = 0; i < N; ++i) x[i] = M[i][N] / M[i][i];
  return true;
}

inline double norm_res(const double r[NRES]) {
  double acc = 0.0;
  for (int i = 0; i < NRES; ++i) acc += r[i] * r[i];
  return std::sqrt(acc);
}

struct Problem {
  int n_segments;
  double thrust;
  const double* spiral_end;
  double max_shoot, max_coast, min_shoot;
  double mass_min = MASS_MIN, mass_max = MASS_MAX;
};

// Structure-aware finite-difference Jacobian: columns 0..62 only move the
// shooting legs (the manifold target is reused), columns 63..65 move the
// backward leg / target — 66 leg evaluations but only ~4 target
// evaluations per Jacobian, where a naive FD would pay 66 targets.
void jacobian_fd(const double* g, const Problem& p, const HaloData& h,
                 const double r0[NRES], double* J /* NRES x NVAR */) {
  double target6[6];
  compute_target(g, h, target6);
  double trial[NVAR], rp[NRES];
  for (int v = 0; v < NVAR; ++v) {
    const double hstep = 1e-6 * (std::fabs(g[v]) + 1.0);
    std::memcpy(trial, g, sizeof(trial));
    trial[v] += hstep;
    if (v < 63) {
      residual7_with_target(trial, p.n_segments, p.thrust, p.spiral_end,
                            target6, rp);
    } else {
      residual7(trial, p.n_segments, p.thrust, p.spiral_end, h, rp);
    }
    for (int i = 0; i < NRES; ++i) J[i * NVAR + v] = (rp[i] - r0[i]) / hstep;
  }
}

// Levenberg-Marquardt refinement; returns iterations used (a final stuck
// iteration is not counted — solver_tpu.py matches this).
int lm_refine(double* g, const Problem& p, const HaloData& h, int max_iters,
              double tol, double* r_out, double* cost_out) {
  double r[NRES];
  clamp_vars(g, p.n_segments, p.max_shoot, p.max_coast, p.min_shoot,
             h.min_mani, h.max_mani, p.mass_min, p.mass_max);
  residual7(g, p.n_segments, p.thrust, p.spiral_end, h, r);
  double cost = norm_res(r);
  double lambda = 1e-3;
  std::vector<double> J(NRES * NVAR);
  double trial[NVAR];

  int it = 0;
  for (; it < max_iters && cost > tol; ++it) {
    jacobian_fd(g, p, h, r, J.data());
    double JJt[NRES][NRES];
    for (int i = 0; i < NRES; ++i)
      for (int j = 0; j < NRES; ++j) {
        double acc = 0.0;
        for (int v = 0; v < NVAR; ++v)
          acc += J[i * NVAR + v] * J[j * NVAR + v];
        JJt[i][j] = acc;
      }
    bool improved = false;
    for (int attempt = 0; attempt < 8 && !improved; ++attempt) {
      double A[NRES][NRES];
      for (int i = 0; i < NRES; ++i)
        for (int j = 0; j < NRES; ++j)
          A[i][j] = JJt[i][j] + (i == j ? lambda : 0.0);
      double neg_r[NRES], a[NRES];
      for (int i = 0; i < NRES; ++i) neg_r[i] = -r[i];
      if (!solve_res(A, neg_r, a)) {
        lambda *= 10.0;
        continue;
      }
      std::memcpy(trial, g, sizeof(trial));
      for (int v = 0; v < NVAR; ++v) {
        double dv = 0.0;
        for (int i = 0; i < NRES; ++i) dv += J[i * NVAR + v] * a[i];
        trial[v] += dv;
      }
      clamp_vars(trial, p.n_segments, p.max_shoot, p.max_coast, p.min_shoot,
                 h.min_mani, h.max_mani, p.mass_min, p.mass_max);
      double rt[NRES];
      residual7(trial, p.n_segments, p.thrust, p.spiral_end, h, rt);
      const double ct = norm_res(rt);
      if (std::isfinite(ct) && ct < cost) {
        std::memcpy(g, trial, sizeof(trial));
        std::memcpy(r, rt, sizeof(r));
        cost = ct;
        lambda = lambda > 1e-12 ? lambda * 0.3 : 1e-12;
        improved = true;
      } else {
        lambda *= 10.0;
      }
    }
    if (!improved) break;  // stuck in a flat/cliff region: report as-is
  }
  std::memcpy(r_out, r, sizeof(r));
  *cost_out = cost;
  return it;
}

// Feasibility LM + mass-ascent ratchet fused into one loop —
// solver_tpu.py:_ratchet_loop twin (same accept/ratchet/terminate rules;
// sequential lambda attempts here vs the parallel ladder there).  The
// mass objective is the analytic 8th residual row (m_target - g[63]) /
// MASS_SCALE against a target that ratchets up `gain` kg whenever the
// lane is feasible; gain collapse below OPT_GAIN_TOL after repeated
// failed attempts certifies a constrained local optimum (inform 1).
// Returns accepted-iteration count; writes the final gain and whether a
// feasible point was ever seen (the reported solution is the best
// feasible-with-max-mass snapshot).
int ratchet_refine(double* g, const Problem& p, const HaloData& h,
                   int base_iters, int total_iters, double tol, double* r_out,
                   double* cost_out, double* gain_out, bool* has_best_out) {
  constexpr int NR8 = NRES + 1;
  double r[NRES];
  clamp_vars(g, p.n_segments, p.max_shoot, p.max_coast, p.min_shoot,
             h.min_mani, h.max_mani, p.mass_min, p.mass_max);
  residual7(g, p.n_segments, p.thrust, p.spiral_end, h, r);
  double c7 = norm_res(r);
  double lambda = 1e-3;
  double gain = OPT_GAIN_KG;
  bool feas = c7 < tol;
  double m_tgt = g[63] + (feas ? gain : 0.0);

  double best[NVAR], best_r[NRES];
  double best_c7 = c7;
  bool has_b = feas;
  if (feas) {
    std::memcpy(best, g, sizeof(best));
    std::memcpy(best_r, r, sizeof(best_r));
  }

  std::vector<double> J(NR8 * NVAR);
  double trial[NVAR], rt[NRES];
  int it = 0;
  // lanes that never reached feasibility only get the feasibility budget
  // (solver_tpu.py twin: keeps optimal/feasible ratios commensurable)
  while (it < (has_b ? total_iters : base_iters)) {
    if (c7 < tol && gain < OPT_GAIN_TOL) break;  // ratchet converged
    const bool row_active = has_b;
    const double mass_before = g[63];
    jacobian_fd(g, p, h, r, J.data());           // rows 0..6
    // the analytic mass row stays INACTIVE until first feasibility —
    // an active zero-residual row would pin g[63] and change which
    // guesses the feasibility phase can solve (solver_tpu.py twin)
    for (int v = 0; v < NVAR; ++v)
      J[NRES * NVAR + v] = (has_b && v == 63) ? -1.0 / MASS_SCALE : 0.0;
    double r8[NR8];
    std::memcpy(r8, r, sizeof(r));
    r8[NRES] = has_b ? (m_tgt - g[63]) / MASS_SCALE : 0.0;
    const double c8 = std::sqrt(r8[NRES] * r8[NRES] + c7 * c7);
    double JJt[NR8][NR8];
    for (int i = 0; i < NR8; ++i)
      for (int j = 0; j < NR8; ++j) {
        double acc = 0.0;
        for (int v = 0; v < NVAR; ++v)
          acc += J[i * NVAR + v] * J[j * NVAR + v];
        JJt[i][j] = acc;
      }
    bool improved = false;
    for (int attempt = 0; attempt < 8 && !improved; ++attempt) {
      double A[NR8][NR8];
      for (int i = 0; i < NR8; ++i)
        for (int j = 0; j < NR8; ++j)
          A[i][j] = JJt[i][j] + (i == j ? lambda : 0.0);
      double neg_r[NR8], a[NR8];
      for (int i = 0; i < NR8; ++i) neg_r[i] = -r8[i];
      if (!solve_res(A, neg_r, a)) {
        lambda *= 10.0;
        continue;
      }
      std::memcpy(trial, g, sizeof(trial));
      for (int v = 0; v < NVAR; ++v) {
        double dv = 0.0;
        for (int i = 0; i < NR8; ++i) dv += J[i * NVAR + v] * a[i];
        trial[v] += dv;
      }
      clamp_vars(trial, p.n_segments, p.max_shoot, p.max_coast, p.min_shoot,
                 h.min_mani, h.max_mani, p.mass_min, p.mass_max);
      residual7(trial, p.n_segments, p.thrust, p.spiral_end, h, rt);
      const double c7t = norm_res(rt);
      const double m8 = has_b ? (m_tgt - trial[63]) / MASS_SCALE : 0.0;
      const double c8t = std::sqrt(c7t * c7t + m8 * m8);
      if (std::isfinite(c8t) && c8t < c8) {
        std::memcpy(g, trial, sizeof(trial));
        std::memcpy(r, rt, sizeof(r));
        c7 = c7t;
        lambda = lambda > 1e-12 ? lambda * 0.3 : 1e-12;
        improved = true;
      } else {
        lambda *= 10.0;
      }
    }
    feas = c7 < tol;
    if (improved) {
      ++it;
      if (feas && (!has_b || g[63] > best[63])) {
        std::memcpy(best, g, sizeof(best));
        std::memcpy(best_r, r, sizeof(best_r));
        best_c7 = c7;
        has_b = true;
      }
    } else if (!feas) {
      break;  // infeasible and the ladder cannot move: done
    }
    // gain grows only when the step extracted >= 30% of the targeted
    // gain, else halves (solver_tpu.py:_ratchet_loop twin)
    if (row_active) {
      const bool ratchet_ok = improved && (g[63] - mass_before) > 0.3 * gain;
      gain = ratchet_ok
                 ? (gain * 1.5 < OPT_GAIN_MAX ? gain * 1.5 : OPT_GAIN_MAX)
                 : gain * 0.5;
    }
    m_tgt = feas ? g[63] + gain : g[63];
  }

  if (has_b) {
    std::memcpy(g, best, sizeof(best));
    std::memcpy(r, best_r, sizeof(best_r));
    c7 = best_c7;
  }
  std::memcpy(r_out, r, NRES * sizeof(double));
  *cost_out = c7;
  *gain_out = has_b ? gain : 1e6;
  *has_best_out = has_b;
  return it;
}

// First-order achievable mass-increase rate at g (solver_tpu.py:
// _mass_rate twin): project e_mass onto the constraint null space, zero
// components pushing through an active box bound, re-project.
double mass_rate(const double* g, const Problem& p, const HaloData& h,
                 const double r[NRES]) {
  std::vector<double> J(NRES * NVAR);
  jacobian_fd(g, p, h, r, J.data());
  double JJt[NRES][NRES];
  for (int i = 0; i < NRES; ++i)
    for (int j = 0; j < NRES; ++j) {
      double acc = 0.0;
      for (int v = 0; v < NVAR; ++v)
        acc += J[i * NVAR + v] * J[j * NVAR + v];
      JJt[i][j] = acc + (i == j ? 1e-8 : 0.0);
    }
  auto proj = [&](const double in[NVAR], double out[NVAR]) {
    double jv[NRES], a[NRES];
    for (int i = 0; i < NRES; ++i) {
      double acc = 0.0;
      for (int v = 0; v < NVAR; ++v) acc += J[i * NVAR + v] * in[v];
      jv[i] = acc;
    }
    if (!solve_res(JJt, jv, a)) {
      std::memcpy(out, in, NVAR * sizeof(double));
      return;
    }
    for (int v = 0; v < NVAR; ++v) {
      double jta = 0.0;
      for (int i = 0; i < NRES; ++i) jta += J[i * NVAR + v] * a[i];
      out[v] = in[v] - jta;
    }
  };
  double e63[NVAR] = {0.0}, d[NVAR], d2[NVAR];
  e63[63] = 1.0;
  proj(e63, d);
  // active box bounds (clamp_vars' box)
  const double lo_shoot = p.min_shoot > 1e-3 ? p.min_shoot : 1e-3;
  auto mask = [&](int v, double lo, double hi) {
    if (g[v] <= lo + 1e-6 && d[v] < 0.0) d[v] = 0.0;
    if (g[v] >= hi - 1e-6 && d[v] > 0.0) d[v] = 0.0;
  };
  mask(0, lo_shoot, p.max_shoot);
  mask(1, 0.0, p.max_coast);
  mask(2, 0.0, p.max_coast);
  for (int k = 0; k < p.n_segments; ++k)
    mask(3 + 3 * k + 2, 0.0, 1.0);
  mask(63, p.mass_min, p.mass_max);
  mask(64, 0.0, 1.0);
  mask(65, h.min_mani, h.max_mani);
  proj(d, d2);
  return d2[63] > 0.0 ? d2[63] : 0.0;
}

// Pin a defined FP environment for the duration of a batch call.  The
// embedding process may have FTZ/DAZ set on the calling thread (XLA's CPU
// runtime enables both), which flushes the ~1e-300-scale pivots of the LM
// normal-equation solve to zero and changes refinement trajectories —
// results must not depend on who called us last.  New std::threads inherit
// the creator's MXCSR, so the guard is applied per executing thread.
#if defined(__SSE2__) || defined(__x86_64__)
struct FpEnvGuard {
  unsigned int saved;
  FpEnvGuard() : saved(_mm_getcsr()) {
    _mm_setcsr(saved & ~0x8040u);  // clear FTZ (bit 15) and DAZ (bit 6)
  }
  ~FpEnvGuard() { _mm_setcsr(saved); }
};
#else
struct FpEnvGuard {};
#endif

void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    FpEnvGuard fp;
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto worker = [&]() {
    FpEnvGuard fp;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
  };
  unsigned hw = std::thread::hardware_concurrency();
  int t = n_threads < static_cast<int>(hw ? hw : 1)
              ? n_threads
              : static_cast<int>(hw ? hw : 1);
  t = t < n ? t : n;
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Single constant-control propagation (test hook for JAX parity).
void cr3bp_propagate(const double* s0, const double* u, double throttle,
                     double thrust_n, double tof, int n_steps, double* out) {
  State7 s;
  std::memcpy(s.v, s0, sizeof(s.v));
  propagate(s, u, throttle, thrust_n, tof, n_steps);
  std::memcpy(out, s.v, sizeof(s.v));
}

double cr3bp_jacobi_energy(const double* s0) {
  State7 s;
  std::memcpy(s.v, s0, sizeof(s.v));
  return jacobi_energy(s);
}

// Manifold-arc end state (test hook for manifold.py parity).
void cr3bp_manifold_target(const double* halo_seed, double period,
                           const double* vstable, double tau_frac,
                           double length, double* out6) {
  manifold_target(halo_seed, period, vstable, tau_frac, length, out6);
}

// Batched evaluate (no refinement): the forward-backward midpoint defect
// of each guess as-is — the native twin of oracle.evaluate_warmstarts.
// halo_* carry the per-sample family data interpolated host-side from
// rdm_tpu_torch/physics/halo.py.
void cr3bp_evaluate_batch(const double* guesses, int n, int n_segments,
                          double thrust_n, const double* spiral_end,
                          const double* halo_seeds, const double* halo_periods,
                          const double* halo_vstables, double min_mani,
                          double max_mani, double* cost, double* pos_err,
                          double* vel_err, double* final_mass,
                          int n_threads) {
  parallel_for(n, n_threads, [&](int i) {
    HaloData h{halo_seeds + 6 * i, halo_periods[i], halo_vstables + 6 * i,
               min_mani, max_mani};
    double r[NRES];
    residual7(guesses + NVAR * i, n_segments, thrust_n, spiral_end, h, r);
    cost[i] = norm_res(r);
    pos_err[i] = std::sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
    vel_err[i] = std::sqrt(r[3] * r[3] + r[4] * r[4] + r[5] * r[5]);
    State7 term;
    shoot_full(guesses + NVAR * i, n_segments, thrust_n, spiral_end, term);
    final_mass[i] = std::isfinite(term.v[6]) ? term.v[6] : -1.0;
  });
}

// Batched raw residual evaluation: the 7-vector forward-backward
// residual of each row (no norms, no refinement).  This is the hook the
// second-solver cross-check (scripts/second_solver_crosscheck.py) builds
// scipy TRF/SLSQP solves on: an algorithmically different optimizer
// minimising the IDENTICAL f64 residual, so graded feasibility can be
// tested for solver-family invariance.
void cr3bp_residual_batch(const double* guesses, int n, int n_segments,
                          double thrust_n, const double* spiral_end,
                          const double* halo_seeds, const double* halo_periods,
                          const double* halo_vstables, double min_mani,
                          double max_mani, double* r_out, int n_threads) {
  parallel_for(n, n_threads, [&](int i) {
    HaloData h{halo_seeds + 6 * i, halo_periods[i], halo_vstables + 6 * i,
               min_mani, max_mani};
    residual7(guesses + NVAR * i, n_segments, thrust_n, spiral_end, h,
              r_out + NRES * i);
  });
}

// Batched LM solve ("SNOPT-lite"): refined guesses written in place of a
// copy of the inputs; optimal != 0 additionally runs the mass-ascent
// phase and reports its stationarity certificate.
void cr3bp_refine_batch(const double* guesses, int n, int n_segments,
                        double thrust_n, const double* spiral_end,
                        const double* halo_seeds, const double* halo_periods,
                        const double* halo_vstables, double min_mani,
                        double max_mani, int max_iters, double tol,
                        double max_shoot, double max_coast, double min_shoot,
                        double mass_min, double mass_max,
                        int optimal, double* refined, double* cost,
                        double* pos_err, double* vel_err, double* final_mass,
                        double* terminal_mass, int* iters,
                        double* stationarity, double* opt_gain,
                        int n_threads) {
  std::memcpy(refined, guesses, sizeof(double) * NVAR * n);
  parallel_for(n, n_threads, [&](int i) {
    HaloData h{halo_seeds + 6 * i, halo_periods[i], halo_vstables + 6 * i,
               min_mani, max_mani};
    Problem p{n_segments, thrust_n, spiral_end, max_shoot, max_coast,
              min_shoot, mass_min, mass_max};
    double* g = refined + NVAR * i;
    double r[NRES], c;
    int it;
    double stat = 1e6, gain_f = 1e6;
    if (optimal) {
      bool has_b = false;
      it = ratchet_refine(g, p, h, max_iters, max_iters + OPT_BUDGET, tol,
                          r, &c,
                          &gain_f, &has_b);
      if (has_b) stat = mass_rate(g, p, h, r);
    } else {
      it = lm_refine(g, p, h, max_iters, tol, r, &c);
    }
    cost[i] = c;
    pos_err[i] = std::sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
    vel_err[i] = std::sqrt(r[3] * r[3] + r[4] * r[4] + r[5] * r[5]);
    final_mass[i] = c < 1e5 ? g[63] : -1.0;
    State7 term;
    shoot_full(g, n_segments, thrust_n, spiral_end, term);
    terminal_mass[i] = std::isfinite(term.v[6]) ? term.v[6] : -1.0;
    iters[i] = it;
    stationarity[i] = stat;
    opt_gain[i] = gain_f;
  });
}

}  // extern "C"
