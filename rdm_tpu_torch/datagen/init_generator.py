"""Initial guesses for CR3BP data generation.

Modes: ``uniform_sample`` (a random 66-vector in physical units, drawn from
``np.random.RandomState(seed)`` in the reference's order, so each seed gives
the JAX package's guess bit for bit), ``from_pickle`` / ``from_diffusion``
(warm starts read from a file) and ``gt_example`` (a fixed guess).  File
paths are constructor arguments.
"""
from __future__ import annotations

import pickle
from typing import Optional

import numpy as np


class CR3BPInitGenerator:
    def __init__(self, initial_guess_sample_mode: str, thrust: float,
                 min_mass_to_sample: float, max_mass_to_sample: float,
                 min_manifold_length: float, max_manifold_length: float,
                 pickle_path: Optional[str] = None,
                 diffusion_path: Optional[str] = None,
                 gt_initial_guess: Optional[np.ndarray] = None):
        self.initial_guess_sample_mode = initial_guess_sample_mode
        self.thrust = thrust
        self.min_mass_to_sample = min_mass_to_sample
        self.max_mass_to_sample = max_mass_to_sample
        self.min_manifold_length = min_manifold_length
        self.max_manifold_length = max_manifold_length
        self.pickle_path = pickle_path
        self.diffusion_path = diffusion_path
        self.gt_initial_guess = gt_initial_guess

    def get_earth_initial_guess(self, seed: int, number_of_segments: int,
                                maximum_shooting_time: float,
                                minimum_shooting_time: float):
        """``(halo_energy, [guess])`` for ``seed``; ``from_diffusion`` returns
        the file's [N, 67] array (halo energy first)."""
        mode = self.initial_guess_sample_mode

        if mode == "from_pickle":
            with open(self.pickle_path, "rb") as f:
                data = pickle.load(f)
            return data[0]["cost_alpha"], [np.asarray(data[0]["results.control"])]

        if mode == "from_diffusion":
            with open(self.diffusion_path, "rb") as f:
                return pickle.load(f)

        if mode == "gt_example":
            if self.gt_initial_guess is None:
                raise ValueError("gt_example mode needs gt_initial_guess")
            return 1.0, [np.array(self.gt_initial_guess, copy=True)]

        if mode == "uniform_sample":
            rs = np.random.RandomState(seed=seed)
            halo_energy = float(rs.uniform(0.008, 0.095, 1)[0])
            n = number_of_segments
            theta = rs.uniform(0, 2 * np.pi, n)
            psi = rs.uniform(0, 2 * np.pi, n)
            r = rs.uniform(0, 1, n)
            t_shooting = rs.uniform(minimum_shooting_time, maximum_shooting_time, 1)
            t_init = rs.uniform(0, 15.0, 1)
            t_final = rs.uniform(0, 15.0, 1)
            mass = rs.uniform(self.min_mass_to_sample, self.max_mass_to_sample, 1)
            manifold_start = rs.uniform(0, 1, 1)
            manifold_length = rs.uniform(self.min_manifold_length,
                                         self.max_manifold_length, 1)
            guess = [t_shooting[0], t_init[0], t_final[0]]
            for j in range(n):
                guess += [theta[j], psi[j], r[j]]
            guess += [mass[0], manifold_start[0], manifold_length[0]]
            return halo_energy, [np.asarray(guess)]

        raise ValueError(f"unknown initial_guess_sample_mode {mode}")
