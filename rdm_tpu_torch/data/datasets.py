"""The GTO halo training data, in NCHW.

The training set is a pickle of [N, 67] float32 rows, each a trajectory's
parameters normalised to [0, 1].  Preprocessing follows the reference:

* label = column 0 (the normalised halo energy);
* pad 67 -> 81 with zeros, standardise with ``(v - mean) / std`` (the
  reference's constants 0.4652 / 0.1811 by default; the flagship run sets
  0 / 1 and so trains on the unit cube), reshape to (1, 9, 9).

The whole set is a few tens of MB, so it is held as arrays and batches are
gathered from them: on the host by ``get_dataset``'s epoch iterators (the
same numpy seeds and per-process shares, and so the same batches, as the
JAX package's), or on the card by the trainer's on-device step.
"""
from __future__ import annotations

import pickle
import warnings
from typing import Iterator, Tuple

import numpy as np

GTO_MEAN = 0.4652
GTO_STD = 0.1811


def make_synthetic_gto_pkl(path: str, n: int = 1024, seed: int = 0) -> str:
    """Write an [n, 67] training pickle of uniform rows in [0.05, 0.95]
    (a stand-in for the real set in tests)."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(0.05, 0.95, size=(n, 67)).astype(np.float32)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


class GTOHaloImageDataset:
    """The GTO rows as (N, 1, 9, 9) images with (N, 1) labels.

    A standardisation that moves more than 1 % of the real values (the
    67 columns, not the padding) out of [0, 1], the reflected SDE's domain,
    warns: it is the reference's default and trains a degraded model.
    """

    def __init__(self, pkl_path: str, mean: float = GTO_MEAN, std: float = GTO_STD):
        with open(pkl_path, "rb") as f:
            data = pickle.load(f)
        data = np.asarray(data, dtype=np.float32)
        if data.ndim != 2 or data.shape[1] > 81:
            raise ValueError(f"expected [N, <=81] trajectory vectors, got {data.shape}")
        self.raw = data
        self.mean, self.std = float(mean), float(std)
        n, d = data.shape
        self.labels = data[:, :1].copy()
        padded = np.zeros((n, 81), np.float32)
        padded[:, :d] = data
        padded = (padded - self.mean) / self.std
        frac_out = float(((padded[:, :d] < 0.0) | (padded[:, :d] > 1.0)).mean())
        if frac_out > 0.01:
            warnings.warn(
                f"GTOHaloImageDataset: standardisation (mean={self.mean}, "
                f"std={self.std}) pushed {frac_out:.0%} of training values "
                f"outside the reflected SDE's [0,1] domain — this is the "
                f"reference-faithful but degraded configuration.  Set "
                f"data.gto_mean=0 data.gto_std=1 to train on the unit cube "
                f"as designed.", stacklevel=2)
        self.images = padded.reshape(n, 1, 9, 9)

    def __len__(self):
        return self.images.shape[0]

    def __getitem__(self, idx):
        return self.images[idx], self.labels[idx]


def _epoch_iterator(images, labels, batch: int, seed: int, shuffle: bool = True,
                    shard: Tuple[int, int] = (1, 0)) -> Iterator:
    """Infinite batch iterator over one process's share, reshuffled every
    epoch from ``seed``: with ``shard=(n_proc, proc_idx)`` each epoch's order
    is cut to ``order[proc_idx::n_proc]``, as the JAX package's iterator does
    (every process draws the same permutation).  A share smaller than one
    batch is sampled with replacement from the whole set."""
    n_proc, proc_idx = shard
    rng = np.random.default_rng(seed)
    n = images.shape[0]
    while True:
        order = rng.permutation(n) if shuffle else np.arange(n)
        order = order[proc_idx::n_proc]
        for i in range(0, len(order) - batch + 1, batch):
            sel = order[i:i + batch]
            yield images[sel], labels[sel]
        if len(order) < batch:
            sel = rng.integers(0, n, size=batch)
            yield images[sel], labels[sel]


def load_arrays(config) -> Tuple[np.ndarray, np.ndarray]:
    """The whole training set as (images NCHW, labels) numpy arrays."""
    name = config.data.dataset
    if name != "GTOHaloImage":
        raise NotImplementedError(f"dataset {name} is not ported (only GTOHaloImage)")
    ds = GTOHaloImageDataset(config.data.pkl_path,
                             mean=config.data.get("gto_mean", GTO_MEAN),
                             std=config.data.get("gto_std", GTO_STD))
    return ds.images, ds.labels


def get_dataset(config, evaluation: bool = False, shard: Tuple[int, int] | None = None):
    """Infinite iterators of (images NCHW, labels) batches for one process:
    ``(train, eval)`` (seeds 0 and 1, shuffled), or with ``evaluation`` one
    unshuffled iterator of evaluation batches (seed 7).  Batch sizes are
    global: with ``shard=(n_proc, proc_idx)`` (default: this process's
    world size and rank) each process yields its ``batch // n_proc`` rows
    of its share of every epoch."""
    from ..parallel.mesh import per_rank, rank, world_size
    n_proc, proc = (world_size(), rank()) if shard is None else shard
    images, labels = load_arrays(config)
    if evaluation:
        return _epoch_iterator(images, labels, config.eval.batch_size // n_proc, seed=7,
                               shuffle=False, shard=(n_proc, proc))
    train_b = per_rank(config.training.batch_size, "Train", n_proc)
    eval_b = per_rank(config.eval.batch_size, "Eval", n_proc)
    return (_epoch_iterator(images, labels, train_b, seed=0, shard=(n_proc, proc)),
            _epoch_iterator(images, labels, eval_b, seed=1, shard=(n_proc, proc)))
