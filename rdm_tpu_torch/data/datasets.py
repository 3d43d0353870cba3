"""The training data, in NCHW: the GTO halo set, and the image sets of the
other model families (CIFAR-10, ImageNet32, ImageNet64C).

The training set is a pickle of [N, 67] float32 rows, each a trajectory's
parameters normalised to [0, 1].  Preprocessing follows the reference:

* label = column 0 (the normalised halo energy);
* pad 67 -> 81 with zeros, standardise with ``(v - mean) / std`` (the
  reference's constants 0.4652 / 0.1811 by default; the flagship run sets
  0 / 1 and so trains on the unit cube), reshape to (1, 9, 9).

The image sets are read whole into float arrays in [0, 1]: CIFAR-10 from
its ``cifar-10-batches-py`` pickles, the ImageNet sets from folders of
image files under ``config.dataroot`` (PIL, imported only there).
Unconditional sets get zero labels [N, 1]; ImageNet64C's labels are the
class indices [N, 1] from its ``dataset.json``.

The GTO set is a few tens of MB, so it is held as arrays and batches are
gathered from them: on the host by ``get_dataset``'s epoch iterators (the
same numpy seeds and per-process shares, and so the same batches, as the
JAX package's), or on the card by the trainer's on-device step.
"""
from __future__ import annotations

import json
import os
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


def load_cifar10(dataroot: str, train: bool = True):
    """CIFAR-10 from the ``cifar-10-batches-py`` pickles: (images [N, 3, 32,
    32] float32 in [0, 1], labels [N, 1] float32)."""
    base = os.path.join(dataroot, "cifar-10-batches-py")
    files = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for name in files:
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8))
        ys.append(np.asarray(d[b"labels"], np.int64))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32)
    y = np.concatenate(ys)[:, None].astype(np.float32)
    return x.astype(np.float32) / 255.0, y


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the ImageNet folder datasets read image files with PIL "
                          "(the Pillow package), which is not installed") from e
    return Image


def _read_rgb(Image, path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32).transpose(2, 0, 1) / 255.0


def load_image_folder(root: str) -> np.ndarray:
    """Every image file of ``root``, by sorted name: [N, 3, H, W] float32 in
    [0, 1]."""
    Image = _pil_image()
    return np.stack([_read_rgb(Image, os.path.join(root, p)) for p in sorted(os.listdir(root))])


def load_image_folder_class(root: str):
    """The images and labels that ``root/dataset.json`` lists (``{"labels":
    [[file, class], ...]}``): ([N, 3, H, W], [N, 1] float32)."""
    Image = _pil_image()
    with open(os.path.join(root, "dataset.json")) as f:
        pairs = json.load(f)["labels"]
    imgs = [_read_rgb(Image, os.path.join(root, rel)) for rel, _ in pairs]
    return np.stack(imgs), np.asarray([label for _, label in pairs], np.float32)[:, None]


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


def load_arrays(config, evaluation: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """The whole training (or, with ``evaluation``, validation) set as
    (images NCHW, labels) numpy arrays; the GTO set has one split."""
    name = config.data.dataset
    if name == "GTOHaloImage":
        ds = GTOHaloImageDataset(config.data.pkl_path,
                                 mean=config.data.get("gto_mean", GTO_MEAN),
                                 std=config.data.get("gto_std", GTO_STD))
        return ds.images, ds.labels
    if name == "CIFAR10":
        return load_cifar10(config.dataroot, train=not evaluation)
    if name == "ImageNet32":
        split = "valid_32x32" if evaluation else "train_32x32"
        images = load_image_folder(os.path.join(config.dataroot, "ds_imagenet", split))
        return images, np.zeros((len(images), 1), np.float32)
    if name == "ImageNet64C":
        split = "valid" if evaluation else "train"
        return load_image_folder_class(os.path.join(config.dataroot, "imagenet-64x64", split))
    if name == "GTOHalo":
        raise NotImplementedError("the 1-D GTOHalo set (the legacy pipeline) is not ported")
    raise ValueError(f"{name} is not valid")


def get_dataset(config, evaluation: bool = False, shard: Tuple[int, int] | None = None):
    """Infinite iterators of (images NCHW, labels) batches for one process:
    ``(train, eval)`` (seeds 0 and 1, shuffled), or with ``evaluation`` one
    unshuffled iterator of evaluation batches (seed 7).  Batch sizes are
    global: with ``shard=(n_proc, proc_idx)`` (default: this process's
    world size and rank) each process yields its ``batch // n_proc`` rows
    of its share of every epoch."""
    from ..parallel.mesh import per_rank, rank, world_size
    n_proc, proc = (world_size(), rank()) if shard is None else shard
    images, labels = load_arrays(config, evaluation=evaluation)
    if evaluation:
        return _epoch_iterator(images, labels, config.eval.batch_size // n_proc, seed=7,
                               shuffle=False, shard=(n_proc, proc))
    train_b = per_rank(config.training.batch_size, "Train", n_proc)
    eval_b = per_rank(config.eval.batch_size, "Eval", n_proc)
    return (_epoch_iterator(images, labels, train_b, seed=0, shard=(n_proc, proc)),
            _epoch_iterator(images, labels, eval_b, seed=1, shard=(n_proc, proc)))
