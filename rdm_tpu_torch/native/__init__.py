"""ctypes bindings for the port's native CR3BP oracle (``cr3bp_native.cpp``).

The shared library is compiled at first use, never when this module is
imported, with ``g++ -O3 -march=native -std=c++17`` into
``rdm_tpu_torch/_build/``.  Its file name carries a hash of the source and
the command, so a stale library is never loaded.  The compiler writes a
unique temporary name that is then renamed into place atomically, and the
library is loaded only if it is owned by this user (or root) and not
world-writable.  A build failure raises with g++'s message to every caller
that uses the library; ``available()`` answers False for a caller that
only asks.

Public surface:

* ``available()`` / ``build_error()``;
* ``propagate(s0, u, throttle, thrust_n, tof, n_steps)``: one
  constant-control arc, f64;
* ``jacobi_energy(state)``;
* ``manifold_target(seed, period, vstable, tau_frac, length)``: the end
  state of a stable-manifold arc;
* ``evaluate_batch(...)``: the forward-backward midpoint defect of every
  guess as it is, on a std::thread pool;
* ``residual_batch(...)``: the raw [N, 7] residual vectors;
* ``refine_batch(...)``: the Levenberg-Marquardt local solve of every warm
  start against the manifold boundary condition, with the optional
  mass-ascent phase.

The per-sample halo family data (seed state, period and stable eigenvector
at each sample's energy) comes from ``rdm_tpu_torch.physics.halo.interp_seed``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import stat
import subprocess
import threading
import uuid
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cr3bp_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> str:
    """The library's path; its name hashes the source and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcr3bp_native_{h.hexdigest()[:16]}.so")


def _build(final: str) -> None:
    """Compile to a unique temporary name beside ``final`` and rename it
    into place; raise with g++'s message if it fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = os.path.join(BUILD_DIR, f".{os.path.basename(final)}.{uuid.uuid4().hex}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native oracle build failed (g++ exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.rename(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _safe_to_load(path: str) -> bool:
    """Only libraries owned by this user (or root) and not world-writable."""
    st = os.stat(path)
    return st.st_uid in (os.getuid(), 0) and not st.st_mode & stat.S_IWOTH


def _load() -> ctypes.CDLL:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(_build_error)
        path = library_path()
        try:
            if not os.path.exists(path):
                _build(path)
            if not _safe_to_load(path):
                raise RuntimeError(f"refusing to load {path}: not owned by this user "
                                   "or world-writable")
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            raise RuntimeError(_build_error) from e

        D = ctypes.POINTER(ctypes.c_double)
        I = ctypes.POINTER(ctypes.c_int)
        c_d, c_i = ctypes.c_double, ctypes.c_int
        lib.cr3bp_propagate.argtypes = [D, D, c_d, c_d, c_d, c_i, D]
        lib.cr3bp_propagate.restype = None
        lib.cr3bp_jacobi_energy.argtypes = [D]
        lib.cr3bp_jacobi_energy.restype = c_d
        lib.cr3bp_manifold_target.argtypes = [D, c_d, D, c_d, c_d, D]
        lib.cr3bp_manifold_target.restype = None
        lib.cr3bp_evaluate_batch.argtypes = [
            D, c_i, c_i, c_d, D,          # guesses, n, n_segments, thrust, spiral
            D, D, D, c_d, c_d,            # halo seeds/periods/vstables, mani bounds
            D, D, D, D, c_i]              # cost, pos, vel, mass, n_threads
        lib.cr3bp_evaluate_batch.restype = None
        lib.cr3bp_residual_batch.argtypes = [
            D, c_i, c_i, c_d, D,          # guesses, n, n_segments, thrust, spiral
            D, D, D, c_d, c_d,            # halo seeds/periods/vstables, mani bounds
            D, c_i]                       # r_out [n,7], n_threads
        lib.cr3bp_residual_batch.restype = None
        lib.cr3bp_refine_batch.argtypes = [
            D, c_i, c_i, c_d, D,          # guesses, n, n_segments, thrust, spiral
            D, D, D, c_d, c_d,            # halo data, mani bounds
            c_i, c_d, c_d, c_d, c_d,      # max_iters, tol, shoot/coast bounds
            c_d, c_d, c_i,                # mass box, optimal
            D, D, D, D, D, D, I, D, D,    # refined, cost, pos, vel, mass, tmass, iters, stat, opt_gain
            c_i]                          # n_threads
        lib.cr3bp_refine_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library builds and loads (building it if needed)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def build_error() -> Optional[str]:
    """g++'s message when the build failed, else None."""
    available()
    return _build_error


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(a, shape, name) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float64)
    if a.shape != shape:
        raise ValueError(f"{name} has shape {a.shape}, expected {shape}")
    return a


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else (os.cpu_count() or 1)


def propagate(s0, u, throttle: float, thrust_n: float, tof: float,
              n_steps: int) -> np.ndarray:
    lib = _load()
    s0, u = _f64(s0, (7,), "s0"), _f64(u, (3,), "u")
    out = np.empty(7, np.float64)
    lib.cr3bp_propagate(_dptr(s0), _dptr(u), float(throttle), float(thrust_n),
                        float(tof), int(n_steps), _dptr(out))
    return out


def jacobi_energy(state) -> float:
    lib = _load()
    s = np.ascontiguousarray(state, np.float64)
    if s.size < 6:
        raise ValueError(f"state has {s.size} values, expected at least 6")
    s = np.concatenate([s.ravel()[:6], [0.0]])     # the library reads 7 values
    return float(lib.cr3bp_jacobi_energy(_dptr(s)))


def manifold_target(seed, period: float, vstable, tau_frac: float,
                    length: float) -> np.ndarray:
    lib = _load()
    seed, vs = _f64(seed, (6,), "seed"), _f64(vstable, (6,), "vstable")
    out = np.empty(6, np.float64)
    lib.cr3bp_manifold_target(_dptr(seed), float(period), _dptr(vs),
                              float(tau_frac), float(length), _dptr(out))
    return out


def _halo_arrays(halo_energies, n):
    """The per-sample halo family data for the library."""
    from ..physics import halo

    sd = halo.interp_seed(np.asarray(halo_energies, np.float64))
    return (_f64(np.atleast_2d(sd["state0"]), (n, 6), "halo seeds"),
            _f64(np.atleast_1d(sd["period"]), (n,), "halo periods"),
            _f64(np.atleast_2d(sd["vstable"]), (n, 6), "halo vstables"))


def _batch_inputs(guesses, spiral_end):
    g = np.ascontiguousarray(guesses, np.float64)
    if g.ndim != 2 or g.shape[1] != 66:
        raise ValueError(f"guesses have shape {g.shape}, expected (N, 66)")
    return g, _f64(spiral_end, (7,), "spiral_end")


def evaluate_batch(guesses, halo_energies, spiral_end,
                   n_segments: int = 20, thrust: float = 1.0,
                   min_manifold_length: float = 5.0,
                   max_manifold_length: float = 11.0,
                   n_threads: int = 0):
    """Forward-backward defect of every guess as it is.  Returns
    (cost[N], pos_err[N], vel_err[N], final_mass[N])."""
    lib = _load()
    g, sp = _batch_inputs(guesses, spiral_end)
    n = g.shape[0]
    seeds, periods, vstables = _halo_arrays(halo_energies, n)
    cost, pos, vel, mass = (np.empty(n, np.float64) for _ in range(4))
    lib.cr3bp_evaluate_batch(
        _dptr(g), n, int(n_segments), float(thrust), _dptr(sp),
        _dptr(seeds), _dptr(periods), _dptr(vstables),
        float(min_manifold_length), float(max_manifold_length),
        _dptr(cost), _dptr(pos), _dptr(vel), _dptr(mass), _threads(n_threads))
    return cost, pos, vel, mass


def residual_batch(guesses, halo_energies, spiral_end,
                   n_segments: int = 20, thrust: float = 1.0,
                   min_manifold_length: float = 5.0,
                   max_manifold_length: float = 11.0,
                   n_threads: int = 0, halo_data=None):
    """Raw [N, 7] forward-backward residual vectors (no refinement).
    ``halo_data`` may carry precomputed ``(seeds[N,6], periods[N],
    vstables[N,6])``."""
    lib = _load()
    g, sp = _batch_inputs(guesses, spiral_end)
    n = g.shape[0]
    if halo_data is None:
        seeds, periods, vstables = _halo_arrays(halo_energies, n)
    else:
        seeds, periods, vstables = (_f64(a, s, name) for a, s, name in zip(
            halo_data, ((n, 6), (n,), (n, 6)), ("halo seeds", "halo periods", "halo vstables")))
    r = np.empty((n, 7), np.float64)
    lib.cr3bp_residual_batch(
        _dptr(g), n, int(n_segments), float(thrust), _dptr(sp),
        _dptr(seeds), _dptr(periods), _dptr(vstables),
        float(min_manifold_length), float(max_manifold_length),
        _dptr(r), _threads(n_threads))
    return r


def refine_batch(guesses, halo_energies, spiral_end,
                 n_segments: int = 20, thrust: float = 1.0,
                 max_iters: int = 30, tol: float = 1e-3,
                 max_shoot: float = 40.0, max_coast: float = 15.0,
                 min_shoot: float = 0.0,
                 min_manifold_length: float = 5.0,
                 max_manifold_length: float = 11.0,
                 min_mass: float = 408.0, max_mass: float = 470.0,
                 solver_mode: str = "optimal",
                 n_threads: int = 0):
    """Levenberg-Marquardt solve of every warm start against the manifold
    boundary condition; ``min_mass``/``max_mass`` bound the terminal-mass
    variable.

    Returns a dict: refined[N,66], cost[N], pos_err[N], vel_err[N],
    final_mass[N] (the solved mass variable), terminal_mass[N] (forward
    propagated), iters[N], stationarity[N], opt_gain[N] (the final ratchet
    step in kg: its collapse below the tolerance certifies inform 1)."""
    lib = _load()
    g, sp = _batch_inputs(guesses, spiral_end)
    n = g.shape[0]
    seeds, periods, vstables = _halo_arrays(halo_energies, n)
    refined = np.empty_like(g)
    cost, pos, vel, mass, tmass, stat_, opt_gain = (np.empty(n, np.float64) for _ in range(7))
    iters = np.empty(n, np.int32)
    optimal = 0 if str(solver_mode) == "feasible" else 1
    lib.cr3bp_refine_batch(
        _dptr(g), n, int(n_segments), float(thrust), _dptr(sp),
        _dptr(seeds), _dptr(periods), _dptr(vstables),
        float(min_manifold_length), float(max_manifold_length),
        int(max_iters), float(tol), float(max_shoot), float(max_coast),
        float(min_shoot), float(min_mass), float(max_mass), optimal,
        _dptr(refined), _dptr(cost), _dptr(pos),
        _dptr(vel), _dptr(mass), _dptr(tmass),
        iters.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _dptr(stat_),
        _dptr(opt_gain), _threads(n_threads))
    return {"refined": refined, "cost": cost, "pos_err": pos,
            "vel_err": vel, "final_mass": mass, "terminal_mass": tmass,
            "iters": iters, "stationarity": stat_, "opt_gain": opt_gain}
