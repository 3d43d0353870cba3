"""Solver results -> the [N, 67] normalised training pickle.

Per result dict (the oracle's output): drop it unless ``final_mass > 408``,
then normalise [classifier, times, 20 x cartesian controls, fuel mass, halo
period (divided by the halo orbit's period at that energy), manifold
length] to [0, 1].  The period comes from pydylan when it is installed,
else from the package's halo family table (``physics/halo.py``), else from
a linear fit around L1 (``_halo_period_fallback``).
"""
from __future__ import annotations

import functools
import os
import pickle
from typing import List

import numpy as np

MIN_SHOOT, MAX_SHOOT = 0.0, 40.0
MIN_COAST, MAX_COAST = 0.0, 15.0
MIN_HE, MAX_HE = 0.008, 0.095
MIN_MASS, MAX_MASS = 408.0, 470.0
MIN_MANIFOLD, MAX_MANIFOLD = 5.0, 11.0


def spherical_to_cart(r, alpha, beta):
    return np.array([r * np.cos(alpha) * np.cos(beta),
                     r * np.sin(alpha) * np.cos(beta),
                     r * np.sin(beta)])


def _halo_period_fallback(halo_energy: float) -> float:
    """L1 halo-family period from the in-plane frequency of the CR3BP
    linearised at L1 (about 2.69 TU), grown linearly with the energy: within
    a few percent over [0.008, 0.095], enough for normalisation."""
    from ..physics import cr3bp as dyn

    mu = dyn.CR3BP_MU
    x = dyn.l1_position()
    r1, r2 = abs(x + mu), abs(1 - mu - x)
    c2 = (1 - mu) / r1**3 + mu / r2**3
    beta1 = 2 - c2 / 2
    omega_p = np.sqrt(-beta1 + np.sqrt(beta1**2 + (c2 - 1) * (1 + 2 * c2)))
    period0 = 2 * np.pi / omega_p
    return float(period0 * (1.0 + 0.6 * halo_energy))


@functools.lru_cache(maxsize=4096)
def get_halo_period(halo_energy: float) -> float:
    """Orbit period of the L1 halo at ``E_L1 + halo_energy``, memoised (a
    dataset has only a handful of distinct energies)."""
    try:
        import pydylan
        earth, moon = pydylan.Body("Earth"), pydylan.Body("Moon")
        cr3bp = pydylan.eom.CR3BP(primary=earth, secondary=moon)
        l1 = cr3bp.find_equilibrium_point(pydylan.enum.LibrationPoint.L1)
        halo = pydylan.periodic_orbit.Halo(
            cr3bp, pydylan.enum.LibrationPoint.L1, l1[1] + halo_energy, 8000.)
        assert halo.solve_for_orbit() == pydylan.enum.OrbitGenerationResult.Success
        return halo.orbit_period
    except ImportError:
        try:
            from ..physics import halo as _halo
            return float(np.atleast_1d(_halo.interp_seed(float(halo_energy))["period"])[0])
        except Exception:
            return _halo_period_fallback(halo_energy)


def normalize_result(result: dict, num_segments: int = 20,
                     thrust: float = 1.0) -> np.ndarray | None:
    """One solver result dict -> its normalised 67-vector, or None when its
    final mass is not above 408 kg."""
    control = np.asarray(result["results.control"], float)
    if control[-3] <= MIN_MASS:
        return None
    classifier = float(result["cost_alpha"])
    out = [
        (classifier - MIN_HE) / (MAX_HE - MIN_HE),
        (control[0] - MIN_SHOOT) / (MAX_SHOOT - MIN_SHOOT),
        (control[1] - MIN_COAST) / (MAX_COAST - MIN_COAST),
        (control[2] - MIN_COAST) / (MAX_COAST - MIN_COAST),
    ]
    for i in range(num_segments):
        alpha, beta, r = control[3 + 3 * i: 3 + 3 * (i + 1)]
        cart = spherical_to_cart(r, alpha, beta)
        out.extend(((cart + thrust) / (2 * thrust)).tolist())
    out.append((control[-3] - MIN_MASS) / (MAX_MASS - MIN_MASS))
    out.append(control[-2] / get_halo_period(classifier))
    out.append((control[-1] - MIN_MANIFOLD) / (MAX_MANIFOLD - MIN_MANIFOLD))
    return np.asarray(out, np.float32)


def prepare_training_data(directory: str, output_dir: str | None = None,
                          num_segments: int = 20, thrust: float = 1.0,
                          save_every: int = 10_000, max_count: int = 150_000):
    """Normalise every result pickle of ``directory`` (sorted by name) and
    write ``training_data_boundary_{n}.pkl`` every ``save_every`` rows and
    at the end; returns the row count."""
    output_dir = output_dir or directory
    control_list: List[np.ndarray] = []
    counter = 0
    for filename in sorted(os.listdir(directory)):
        if not filename.endswith(".pkl"):
            continue
        with open(os.path.join(directory, filename), "rb") as f:
            data = pickle.load(f)
        vec = normalize_result(data[0], num_segments, thrust)
        if vec is None:
            continue
        control_list.append(vec)
        counter += 1
        if counter % save_every == 0:
            _save(output_dir, control_list, counter)
        if counter >= max_count:
            break
    if control_list:
        _save(output_dir, control_list, counter)
    return counter


def _save(directory, control_list, counter):
    path = os.path.join(directory, f"training_data_boundary_{counter}.pkl")
    with open(path, "wb") as f:
        pickle.dump(np.asarray(control_list), f)
    print(f"All control vectors have been combined and saved to {path}")
