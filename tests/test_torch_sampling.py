"""The port's PC sampler and guided score against the JAX package, with
the same inputs and the same noise handed to both sides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import NCSNpp as JNCSNpp
from rdm_tpu.models.registry import get_cf_score_fn as jax_get_cf_score_fn
from rdm_tpu.sampling import pc as jpc
from rdm_tpu.sde import RVESDE as JRVESDE
from rdm_tpu_torch.models import NCSNpp
from rdm_tpu_torch.models.convert import state_dict_from_jax
from rdm_tpu_torch.models.registry import get_cf_score_fn
from rdm_tpu_torch.sampling import get_pc_sampler, get_sampling_fn, pc
from rdm_tpu_torch.config import ConfigDict
from rdm_tpu_torch.sde import RVESDE

torch.set_num_threads(1)  # the suite runs in parallel worker processes


def _inputs(seed, B=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(B, 1, 9, 9)).astype(np.float32)
    t = rng.uniform(0.05, 1.0, size=(B,)).astype(np.float32)
    score = rng.normal(scale=3.0, size=x.shape).astype(np.float32)
    return x, t, score


def test_euler_maruyama_step_matches_jax():
    x, t, score = _inputs(0)
    key = jax.random.PRNGKey(3)
    z = np.array(jax.random.normal(key, x.shape, jnp.float32))   # the JAX step's draw
    jupdate = jpc.reflected_euler_maruyama(JRVESDE(0.01, 5.0, 1000),
                                           lambda xx, tt: jnp.asarray(score))
    jx, jmean = jupdate(jnp.asarray(x), jnp.asarray(t), key)
    update = pc.reflected_euler_maruyama(RVESDE(0.01, 5.0, 1000),
                                         lambda xx, tt: torch.from_numpy(score))
    tx, tmean = update(torch.from_numpy(x), torch.from_numpy(t), lambda: torch.from_numpy(z))
    # float32 both sides, the same operations in the same order
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("zero_score", [False, True])
def test_langevin_step_matches_jax(zero_score):
    x, t, score = _inputs(1)
    if zero_score:                      # the degenerate-score guard
        score = np.zeros_like(score)
    key = jax.random.PRNGKey(5)
    _, kn = jax.random.split(key)       # the JAX corrector's noise key
    z = np.array(jax.random.normal(kn, x.shape, jnp.float32))
    jupdate = jpc.reflected_langevin(JRVESDE(0.01, 5.0, 1000),
                                     lambda xx, tt: jnp.asarray(score), 0.16, 1)
    jx, jmean = jupdate(jnp.asarray(x), jnp.asarray(t), key)
    update = pc.reflected_langevin(RVESDE(0.01, 5.0, 1000),
                                   lambda xx, tt: torch.from_numpy(score), 0.16, 1)
    tx, tmean = update(torch.from_numpy(x), torch.from_numpy(t), lambda: torch.from_numpy(z))
    # float32; the norms reduce in another order
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-5)
    assert np.isfinite(tx.numpy()).all()
    if zero_score:
        np.testing.assert_array_equal(tx.numpy(), x)


@pytest.mark.parametrize("corrector,calls_per_step", [("none", 1), ("langevin", 2)])
def test_sampler_runs_n_minus_1_updates(corrector, calls_per_step):
    N, B = 7, 3
    sde = RVESDE(0.01, 5.0, N)
    calls, ts = [], []

    def score_fn(x, t):
        calls.append(1)
        ts.append(float(t[0]))
        return torch.zeros_like(x)

    sampler = get_pc_sampler(sde, (B, 1, 9, 9), corrector=corrector, snr=0.16, eps=1e-3)
    x, nfe = sampler(score_fn, torch.Generator().manual_seed(0))
    assert len(calls) == calls_per_step * (N - 1)
    expected_t = np.linspace(1.0, 1e-3, N)[:-1].repeat(calls_per_step)
    np.testing.assert_allclose(ts, expected_t, rtol=1e-6)
    assert nfe == N * 2
    assert x.shape == (B, 1, 9, 9) and bool(((x >= 0) & (x <= 1)).all())


def test_final_denoiser_output_is_used():
    sde = RVESDE(0.01, 5.0, 5)
    zero = lambda x, t: torch.zeros_like(x)
    seen = []

    def denoiser_fn(x, t):
        seen.append(float(t[0]))
        return x - 0.25          # (x - denoiser(x)).clamp(0, 1) == 0.25

    sampler = get_pc_sampler(sde, (2, 1, 9, 9), denoiser="network", eps=1e-3)
    x, _ = sampler(zero, torch.Generator().manual_seed(0), denoiser_fn=denoiser_fn)
    assert seen == [pytest.approx(1e-3)]
    np.testing.assert_allclose(x.numpy(), 0.25)

    # One update (N = 2) with a zero score: the mean is the injected prior.
    sde2 = RVESDE(0.01, 5.0, 2)
    z = torch.full((2, 1, 9, 9), 0.5)
    plain = get_pc_sampler(sde2, (2, 1, 9, 9), denoiser="none")
    mean = get_pc_sampler(sde2, (2, 1, 9, 9), denoiser="mean")
    x_plain, _ = plain(zero, torch.Generator().manual_seed(1), z=z)
    x_mean, _ = mean(zero, torch.Generator().manual_seed(1), z=z)
    np.testing.assert_array_equal(x_mean.numpy(), z.numpy())
    assert not torch.equal(x_plain, x_mean)


def test_get_sampling_fn_dispatch():
    cfg = ConfigDict.wrap({"sampling": {"method": "pc", "predictor": "euler_maruyama",
                                        "corrector": "none", "denoiser": "none",
                                        "snr": 0.01, "n_steps_each": 1}})
    assert callable(get_sampling_fn(cfg, RVESDE(0.01, 5.0, 10), (2, 1, 9, 9), 1e-5))
    cfg.sampling.method = "ode"
    with pytest.raises(NotImplementedError):
        get_sampling_fn(cfg, RVESDE(0.01, 5.0, 10), (2, 1, 9, 9), 1e-5)


@pytest.mark.parametrize("weight", [0.0, 0.1])
def test_cf_score_fn_matches_jax(weight):
    small = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(9,), dropout=0.0)
    jmodel = JNCSNpp(**small)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 9, 9, 1)), jnp.full((2,), 0.5), jnp.zeros((2, 1)))
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32),
                          shapes["params"])
    model = NCSNpp(**small, attn_kernel=True)
    model.load_state_dict(state_dict_from_jax(params), strict=True)

    x, t, _ = _inputs(2, B=3)
    labels = rng.uniform(size=(3, 1)).astype(np.float32)
    jsde, sde = JRVESDE(0.01, 5.0, 1000), RVESDE(0.01, 5.0, 1000)
    jfn = jax.jit(jax_get_cf_score_fn(jsde, jmodel, params, jnp.asarray(labels), weight))
    theirs = np.asarray(jfn(jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t)))
    fn = get_cf_score_fn(sde, model, torch.from_numpy(labels), weight)
    with torch.no_grad():
        ours = fn(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    # float32 both sides; convolutions sum in another order
    np.testing.assert_allclose(ours.transpose(0, 2, 3, 1), theirs, rtol=1e-4, atol=1e-5)
