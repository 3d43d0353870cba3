"""What the study scripts share: the repository's default inputs, where
their results go (``benchmark_results/torch/``, never over the JAX
package's checked-in artifacts), Wilson intervals and the ground-truth
inverse pipeline."""
from __future__ import annotations

import json
import os
import pickle
from types import SimpleNamespace

import numpy as np

from ..benchmark.common import REPO_ROOT

FLAGSHIP_RUN = os.path.join(REPO_ROOT, "Training Runs", "2026.08.17_184657")
FLAGSHIP_SAMPLES = os.path.join(REPO_ROOT, "benchmark_results", "round2_flagship_1024",
                                "gto_halo", "generated_samples.npy")
GT_PKL = os.path.join(REPO_ROOT, "datasets", "training_data_boundary_80073.pkl")
RESULTS = os.path.join(REPO_ROOT, "benchmark_results", "torch")
# a checkout of the reference repository, whose sample artifacts are inputs of
# the oracle studies: only where --reference_root or this variable names one
REFERENCE_ROOT_ENV = "RDM_REFERENCE_ROOT"


def default_out(name: str) -> str:
    return os.path.join(RESULTS, name)


def write_json(path: str, blob) -> None:
    """Write ``blob`` to ``path`` through a temporary file (a partial run
    leaves the last whole artifact)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(blob, f, indent=2)
    os.replace(path + ".tmp", path)


def wilson_ci(k: int, n: int, z: float = 1.96) -> tuple:
    """95 % Wilson score interval of a binomial proportion k / n."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    den = 1 + z * z / n
    centre = (p + z * z / (2 * n)) / den
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return (max(0.0, centre - half), min(1.0, centre + half))


def rounded_ci(k: int, n: int) -> list:
    return [round(v, 4) for v in wilson_ci(k, n)]


def grade(guesses, energies, backend: str, device, precision: str = "f32",
          **kw) -> dict:
    """Grade warm starts [N, 66] on the card (``tpu``:
    ``refine_warmstarts_gpu`` in ``precision`` on ``device``) or on the host
    (``native``: the C++ oracle, float64)."""
    if backend == "native":
        from ..physics.oracle import evaluate_warmstarts_native
        return evaluate_warmstarts_native(guesses, energies, **kw)
    from ..physics.solver_gpu import refine_warmstarts_gpu
    return refine_warmstarts_gpu(guesses, energies, precision=precision, device=device, **kw)


def load_rows(path: str, n: int | None = None) -> np.ndarray:
    with open(path, "rb") as f:
        rows = np.asarray(pickle.load(f))
    return rows if n is None else rows[:n]


def gt_inverse(rows: np.ndarray) -> tuple:
    """Normalised training rows [N, 67] (unit-cube values, no
    standardisation) through the benchmark's inverse pipeline: the
    physical halo energies [N] and warm starts [N, 66]."""
    from ..benchmark.gto_halo import GTOHaloBenchmarker

    bench = GTOHaloBenchmarker.__new__(GTOHaloBenchmarker)   # the pipeline reads lm.cfg.data
    bench.lm = SimpleNamespace(cfg=SimpleNamespace(data={"gto_mean": 0.0, "gto_std": 1.0}))
    bench.total_spherical_clips = bench.total_spherical_elements = 0
    phys = bench._inverse_pipeline(np.asarray(rows))
    return phys[:, 0], phys[:, 1:]


def reference_root() -> str | None:
    """The reference checkout that ``RDM_REFERENCE_ROOT`` names, or None."""
    return os.environ.get(REFERENCE_ROOT_ENV) or None


def reference_path(root: str | None, rel: str) -> str | None:
    """``rel`` under the reference checkout ``root``, if it exists there;
    otherwise None, with one line saying the set is skipped."""
    if root is None:
        print(f"{rel}: no --reference_root or {REFERENCE_ROOT_ENV} given; set skipped")
        return None
    path = os.path.join(root, rel)
    if not os.path.exists(path):
        print(f"{path} is absent; set skipped")
        return None
    return path


def load_reference_set(path: str) -> np.ndarray:
    """A reference ``samples.npy``: [N, 67] physical units with the halo
    period slot in time units, re-normalised here to the orbit-phase
    fraction the oracle reads."""
    from ..datagen import get_halo_period

    s = np.load(path).astype(np.float64)
    s[:, -2] = s[:, -2] / np.array([get_halo_period(float(h)) for h in s[:, 0]])
    return s
