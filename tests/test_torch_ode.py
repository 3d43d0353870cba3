"""The port's probability-flow ODE sampler against the JAX package's, with
the same float32 inputs, the same weights and the same injected prior."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.config import ConfigDict as JConfigDict
from rdm_tpu.models import NCSNpp as JNCSNpp
from rdm_tpu.models.registry import get_cf_score_fn as jax_get_cf_score_fn
from rdm_tpu.sampling import get_sampling_fn as jax_get_sampling_fn
from rdm_tpu.sampling import ode as jode
from rdm_tpu.sde import RVESDE as JRVESDE
from rdm_tpu_torch.config import ConfigDict
from rdm_tpu_torch.models import NCSNpp
from rdm_tpu_torch.models.convert import state_dict_from_jax
from rdm_tpu_torch.models.registry import get_cf_score_fn
from rdm_tpu_torch.sampling import get_sampling_fn, ode
from rdm_tpu_torch.sde import RVESDE

torch.set_num_threads(1)  # the suite runs in parallel worker processes

B = 3
SMALL = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(9,), dropout=0.0)


@pytest.mark.parametrize("t0,t1", [(1.0, 1e-3), (0.0, 2.0)])
def test_dopri45_matches_jax(t0, t1):
    """The solver alone on a right-hand side of products only (no sums for
    a compiler to fuse): the same step sequence, so the same NFE and y."""
    y0 = np.random.default_rng(0).uniform(size=(4, 81)).astype(np.float32)
    run = jax.jit(lambda y: jode._dopri45(lambda t, v: -t * v * v, jnp.float32(t0),
                                          jnp.float32(t1), y, 1e-5, 1e-5))
    jy, jnfe = run(jnp.asarray(y0))
    y, nfe = ode._dopri45(lambda t, v: -t * v * v, torch.tensor(t0), torch.tensor(t1),
                          torch.from_numpy(y0), 1e-5, 1e-5)
    assert nfe == int(jnfe) and nfe > 7
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-6)


def test_dopri45_takes_one_step_size_for_the_batch():
    """The error norm is a mean over the whole batch: a sample integrated
    beside others takes their step sequence, not its own."""
    def f(t, v):
        return -t * v * v

    y0 = torch.tensor([[0.1], [1.0]])
    one, nfe_one = ode._dopri45(f, torch.tensor(1.0), torch.tensor(1e-3), y0[:1], 1e-5, 1e-5)
    both, nfe_both = ode._dopri45(f, torch.tensor(1.0), torch.tensor(1e-3), y0, 1e-5, 1e-5)
    assert (nfe_one, nfe_both) == (35, 56)
    assert float(both[0, 0]) != float(one[0, 0])
    exact = 1.0 / (1.0 / 0.1 - 0.5 + 0.5e-6)          # 1/y = t^2/2 + const
    np.testing.assert_allclose([float(one[0, 0]), float(both[0, 0])], exact, rtol=1e-6)


@pytest.mark.parametrize("moll", [200, 0])
def test_make_bump_matches_jax(moll):
    x = np.random.default_rng(1).uniform(-0.1, 1.1, size=(4, 81)).astype(np.float32)
    x[0, :3] = (0.0, 1.0, 0.5)
    theirs = np.asarray(jode.make_bump(moll)(jnp.asarray(x)))
    ours = ode.make_bump(moll)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-7)
    if moll == 0:
        np.testing.assert_array_equal(ours, x)      # the drift is multiplied by x


@pytest.fixture(scope="module")
def tiny():
    """A float32 NCSN++ (nf 16, ch_mult (1, 2), one res block) with the same
    weights, 0.05 N(0, 1), on both sides: 308 evaluations, the samples within
    1.2e-6.  The two networks agree to about 5e-6 of the score's largest
    value in one forward, and the flow magnifies that with the weights: at
    0.1 N(0, 1) both take 469 evaluations and end 1.2e-4 apart; at 0.2 the
    step control sits at its stability limit (about 28 rejections) and the
    two take different step sequences, although the solver alone agrees
    exactly (``test_dopri45_matches_jax``)."""
    rng = np.random.default_rng(7)
    jmodel = JNCSNpp(**SMALL)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 9, 9, 1)), jnp.full((2,), 0.5), jnp.zeros((2, 1)))
    params = jax.tree.map(lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32),
                          shapes["params"])
    model = NCSNpp(**SMALL)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.eval()
    z = rng.uniform(0.01, 0.99, size=(B, 1, 9, 9)).astype(np.float32)
    labels = rng.uniform(size=(B, 1)).astype(np.float32)
    return jmodel, params, model, z, labels


def _jax_sample(tiny, sampler, denoise):
    jmodel, params, _, z, labels = tiny
    jsde = JRVESDE(0.01, 5.0, 1000)
    denoiser_fn = ((lambda x, t: jmodel.apply({"params": params}, x, t)) if denoise else None)

    def run(zz):
        score_fn = jax_get_cf_score_fn(jsde, jmodel, params, jnp.asarray(labels), 0.0)
        return sampler(jsde)(score_fn, jax.random.PRNGKey(0), denoiser_fn=denoiser_fn, z=zz)

    x, nfe = jax.jit(run)(jnp.asarray(z.transpose(0, 2, 3, 1)))
    return np.asarray(x).transpose(0, 3, 1, 2), int(nfe)


def _port_sample(tiny, sampler, denoise):
    _, _, model, z, labels = tiny
    sde = RVESDE(0.01, 5.0, 1000)
    denoiser_fn = model if denoise else None
    score_fn = get_cf_score_fn(sde, model, torch.from_numpy(labels), 0.0)
    x, nfe = sampler(sde)(score_fn, torch.Generator().manual_seed(0), denoiser_fn=denoiser_fn,
                          z=torch.from_numpy(z))
    return x.numpy(), nfe


@pytest.mark.parametrize("denoise", [False, True])
def test_ode_sampler_matches_jax(tiny, denoise):
    theirs, jnfe = _jax_sample(
        tiny, lambda s: jode.get_ode_sampler(s, (B, 9, 9, 1), eps=1e-5), denoise)
    ours, nfe = _port_sample(
        tiny, lambda s: ode.get_ode_sampler(s, (B, 1, 9, 9), eps=1e-5), denoise)
    assert nfe == jnfe and nfe % 7 == int(denoise)
    # float32 both sides; the networks' convolutions sum in another order
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)
    if denoise:
        assert ours.min() >= 0.0 and ours.max() <= 1.0


def test_get_sampling_fn_ode_matches_jax(tiny):
    plain = {"method": "ode", "predictor": "euler_maruyama", "corrector": "none",
             "denoiser": "none", "snr": 0.01, "n_steps_each": 1, "moll": 100,
             "side_eps": 0.05}
    jcfg = JConfigDict({"sampling": JConfigDict(plain)})
    cfg = ConfigDict.wrap({"sampling": dict(plain)})
    theirs, jnfe = _jax_sample(
        tiny, lambda s: jax_get_sampling_fn(jcfg, s, (B, 9, 9, 1), 1e-5), False)
    ours, nfe = _port_sample(
        tiny, lambda s: get_sampling_fn(cfg, s, (B, 1, 9, 9), 1e-5), False)
    assert nfe == jnfe
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)


def test_ode_init_is_the_inset_uniform():
    """Without ``z`` the sampler starts from (1 - 2 side_eps) U + side_eps,
    U drawn from the generator, and a zero score leaves it unchanged."""
    sde = RVESDE(0.01, 5.0, 10)
    sampler = ode.get_ode_sampler(sde, (2, 1, 9, 9), eps=1e-3, side_eps=0.05)
    x, nfe = sampler(lambda x, t: torch.zeros_like(x), torch.Generator().manual_seed(3))
    u = torch.rand((2, 1, 9, 9), generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(x.numpy(), (0.9 * u + 0.05).numpy())
    assert nfe % 7 == 0 and nfe > 0
