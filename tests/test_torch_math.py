"""The port's cube and RVESDE against the reference goldens and the JAX
functions on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.ops import cube as jcube
from rdm_tpu.ops import resize as jresize
from rdm_tpu.sde import RVESDE as JRVESDE
from rdm_tpu_torch.ops import cube, resize
from rdm_tpu_torch.sde import RVESDE, get_sde
from rdm_tpu_torch.config import ConfigDict

torch.set_num_threads(1)  # the suite runs in parallel worker processes


def _well_conditioned(x, x0, sigma, k=4.0):
    """Elements within k sigma of x0 (reflected distance): where a sample
    of the heat kernel lands.  Outside, the f32 series denominators
    underflow and any two implementations agree only in finiteness."""
    d = np.minimum.reduce([np.abs(x - x0), np.abs(x + x0), np.abs(2 - x - x0),
                           np.abs(x - x0 + 2), np.abs(x - x0 - 2)])
    return d <= k * sigma.reshape(sigma.shape + (1,) * (x.ndim - 1))


def test_reflect_and_inside_golden(golden_math):
    g = golden_math
    x = torch.from_numpy(g["x_wide"])
    np.testing.assert_allclose(cube.reflect(x).numpy(), g["reflect"], atol=1e-6)
    np.testing.assert_array_equal(cube.inside(x).numpy(), g["inside"])


def test_reflect_matches_jax():
    x = np.random.default_rng(0).normal(scale=4.0, size=(16, 1, 9, 9)).astype(np.float32)
    # same float32 algebra (mod 2, mirror): equal to the last bit
    np.testing.assert_array_equal(cube.reflect(torch.from_numpy(x)).numpy(),
                                  np.asarray(jcube.reflect(jnp.asarray(x))))


def test_score_hk_golden(golden_math):
    g = golden_math
    ours = cube.score_hk(torch.from_numpy(g["x_in"]), torch.from_numpy(g["x0_in"]),
                         torch.from_numpy(g["sigma"])).numpy()
    mask = _well_conditioned(g["x_in"], g["x0_in"], g["sigma"])
    assert mask.mean() > 0.5
    # tolerance of the JAX package's own golden test (tests/test_cube.py)
    np.testing.assert_allclose(ours[mask], g["score_hk"][mask], rtol=2e-4, atol=2e-4)
    assert np.isfinite(ours).all()


def test_score_hk_matches_jax(golden_math):
    g = golden_math
    ours = cube.score_hk(torch.from_numpy(g["x_in"]), torch.from_numpy(g["x0_in"]),
                         torch.from_numpy(g["sigma"])).numpy()
    theirs = np.asarray(jcube.score_hk(jnp.asarray(g["x_in"]), jnp.asarray(g["x0_in"]),
                                       jnp.asarray(g["sigma"])))
    mask = _well_conditioned(g["x_in"], g["x0_in"], g["sigma"])
    # both float32 with the same series; only summation order differs
    np.testing.assert_allclose(ours[mask], theirs[mask], rtol=1e-4, atol=1e-5)


def test_sample_hk_stays_inside():
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((64, 1, 9, 9), generator=gen)
    s = cube.sample_hk(x, torch.full((64,), 3.0), generator=gen)
    assert bool(cube.inside(s).all())


def test_rvesde_golden(golden_math):
    g = golden_math
    sde = RVESDE(sigma_min=0.01, sigma_max=5.0, N=1000)
    x = torch.from_numpy(g["x_in"])
    t = torch.from_numpy(g["sde_t"])
    _, diffusion = sde.sde(x, t)
    _, std = sde.marginal_prob(x, t)
    _, G = sde.discretize(x, t)
    # tolerances of the JAX package's golden test (tests/test_sde.py)
    np.testing.assert_allclose(diffusion.numpy(), g["sde_diffusion"], rtol=1e-5)
    np.testing.assert_allclose(std.numpy(), g["sde_std"], rtol=1e-5)
    np.testing.assert_allclose(G.numpy(), g["sde_G"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sde.discrete_sigmas().numpy(), g["discrete_sigmas"], rtol=1e-5)


def test_rvesde_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(8, 1, 9, 9)).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, size=(8,)).astype(np.float32)
    score = rng.normal(size=x.shape).astype(np.float32)
    ours, theirs = RVESDE(0.01, 5.0, 1000), JRVESDE(0.01, 5.0, 1000)
    xt, tt, st = map(torch.from_numpy, (x, t, score))
    xj, tj, sj = map(jnp.asarray, (x, t, score))
    # float32 on both sides; 1e-6 relative covers pow/exp rounding
    for a, b in zip(ours.reverse_sde(xt, tt, st), theirs.reverse_sde(xj, tj, sj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    for a, b in zip(ours.discretize(xt, tt), theirs.discretize(xj, tj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.marginal_prob(xt, tt)[1].numpy(),
                               np.asarray(theirs.marginal_prob(xj, tj)[1]), rtol=1e-6)


def test_get_sde_from_config():
    cfg = ConfigDict.wrap({"sde": {"name": "vesde", "sigma_min": 0.01, "sigma_max": 5,
                                   "num_scales": 1000}})
    sde = get_sde(cfg)
    assert (sde.sigma_min, sde.sigma_max, sde.N, sde.T) == (0.01, 5.0, 1000, 1.0)


@pytest.mark.parametrize("size_in,size_out", [((8, 8), (9, 9)), ((4, 4), (9, 9)),
                                              ((9, 9), (4, 4)), ((2, 3), (5, 7))])
def test_nearest_resize_matches_jax_gather_rule(size_in, size_out):
    x = np.random.default_rng(2).normal(size=(2, 3) + size_in).astype(np.float32)
    ours = resize.nearest_resize(torch.from_numpy(x), size_out).numpy()
    theirs = np.asarray(jresize.nearest_resize(jnp.asarray(x.transpose(0, 2, 3, 1)), size_out))
    np.testing.assert_array_equal(ours, theirs.transpose(0, 3, 1, 2))


def test_upsample2x_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 3, 4, 4)).astype(np.float32)
    ours = resize.upsample2x_nearest(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jresize.upsample2x_nearest(jnp.asarray(x.transpose(0, 2, 3, 1))))
    np.testing.assert_array_equal(ours, theirs.transpose(0, 3, 1, 2))
