"""The port's GTO data path against the JAX package's, on a synthetic pickle
and on the first rows of the in-tree training pickle."""
import os
import pickle
import warnings

import numpy as np
import pytest

from rdm_tpu import data as jax_data
from rdm_tpu.config import load_config as jax_load_config
from rdm_tpu_torch import data
from rdm_tpu_torch.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_PKL = os.path.join(ROOT, "datasets", "training_data_boundary_80073.pkl")


@pytest.fixture(scope="module")
def real_rows_pkl(tmp_path_factory):
    """The first 600 rows of the in-tree training set, as a pickle."""
    with open(REAL_PKL, "rb") as f:
        rows = np.asarray(pickle.load(f), np.float32)[:600]
    path = tmp_path_factory.mktemp("real") / "rows.pkl"
    with open(path, "wb") as f:
        pickle.dump(rows, f)
    return str(path)


def test_synthetic_pickle_is_the_jax_packages(tmp_path):
    a = data.make_synthetic_gto_pkl(str(tmp_path / "a.pkl"), n=64, seed=3)
    b = jax_data.make_synthetic_gto_pkl(str(tmp_path / "b.pkl"), n=64, seed=3)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        np.testing.assert_array_equal(pickle.load(fa), pickle.load(fb))


@pytest.mark.parametrize("mean,std", [(0.0, 1.0), (data.GTO_MEAN, data.GTO_STD)])
@pytest.mark.parametrize("source", ["synthetic", "real"])
def test_dataset_matches_jax(tmp_path, real_rows_pkl, source, mean, std):
    pkl = (real_rows_pkl if source == "real"
           else data.make_synthetic_gto_pkl(str(tmp_path / "s.pkl"), n=200, seed=1))
    with warnings.catch_warnings(record=True) as ours_w:
        warnings.simplefilter("always")
        ours = data.GTOHaloImageDataset(pkl, mean=mean, std=std)
    with warnings.catch_warnings(record=True) as theirs_w:
        warnings.simplefilter("always")
        theirs = jax_data.GTOHaloImageDataset(pkl, mean=mean, std=std)
    # the same warning when standardisation leaves the unit cube
    assert len(ours_w) == len(theirs_w)
    assert (len(ours_w) > 0) == (mean != 0.0)
    assert ours.images.shape == (len(theirs), 1, 9, 9)
    np.testing.assert_array_equal(ours.images, theirs.images.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    np.testing.assert_array_equal(ours.labels[:, 0], ours.raw[:, 0])


def test_epoch_iterators_give_the_jax_batches(real_rows_pkl):
    overrides = [f"data.pkl_path={real_rows_pkl}", "data.gto_mean=0", "data.gto_std=1",
                 "training.batch_size=128", "eval.batch_size=256"]
    cfg, jcfg = load_config("train", overrides), jax_load_config("train", overrides)
    ours_train, ours_eval = data.get_dataset(cfg)
    theirs_train, theirs_eval = jax_data.get_dataset(jcfg, distributed=False)
    # 600 rows: four batches of 128 per epoch, then a reshuffle; eval batches
    # of 256: two per epoch
    for ours, theirs, n in ((ours_train, theirs_train, 9), (ours_eval, theirs_eval, 5)):
        for _ in range(n):
            (oi, ol), (ti, tl) = next(ours), next(theirs)
            np.testing.assert_array_equal(oi, ti.transpose(0, 3, 1, 2))
            np.testing.assert_array_equal(ol, tl)
    ours_ev = data.get_dataset(cfg, evaluation=True)
    theirs_ev = jax_data.get_dataset(jcfg, evaluation=True, distributed=False)
    np.testing.assert_array_equal(next(ours_ev)[0], next(theirs_ev)[0].transpose(0, 3, 1, 2))


def test_tiny_set_samples_with_replacement(tmp_path):
    pkl = data.make_synthetic_gto_pkl(str(tmp_path / "t.pkl"), n=5)
    cfg = load_config("train", [f"data.pkl_path={pkl}", "training.batch_size=8",
                                "eval.batch_size=8", "data.gto_mean=0", "data.gto_std=1"])
    images, labels = next(data.get_dataset(cfg)[0])
    assert images.shape == (8, 1, 9, 9) and labels.shape == (8, 1)


def test_load_arrays_and_unported_datasets(real_rows_pkl):
    cfg = load_config("train", [f"data.pkl_path={real_rows_pkl}"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        images, labels = data.load_arrays(cfg)
    assert images.shape == (600, 1, 9, 9) and images.dtype == np.float32
    # the image sets are ported (they need their files under dataroot); the
    # 1-D set of the legacy pipeline is not yet
    cfg.data.dataset, cfg.dataroot = "CIFAR10", "/nonexistent"
    with pytest.raises(FileNotFoundError):
        data.load_arrays(cfg)
    cfg.data.dataset = "GTOHalo"
    with pytest.raises(NotImplementedError):
        data.load_arrays(cfg)
