"""The port's ``GaussianDiffusion1D`` against the reference golden and the
JAX package: every field of ``tests/golden/diffusion1d_golden.npz``
(schedules, conversions, posterior, ``p_mean_variance``, the NA loss, the
DDIM trajectory from ``z0``), ``p_losses`` for all eight loss types with the
JAX package's draws rebuilt from its key and fed in, the ancestral and DDIM
samplers and ``interpolate`` on rebuilt per-step noises, and the
``ValueError`` without a constraint function.

The golden is in the reference's torch layout (B, 1, L), the port's own.
Tolerances: the golden at the JAX tests' own (``tests/test_diffusion1d.py``);
against the JAX package rtol 1e-5 (atol 1e-6) with the 0.5 x mock model
and 1e-4 / 1e-5 with a U-Net (float32 sums in another order)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.diffusion1d import GaussianDiffusion1D as JDiffusion
from rdm_tpu.models.unet1d import UNet1D as JUNet1D
from rdm_tpu_torch.diffusion1d import GaussianDiffusion1D, linear_beta_schedule
from rdm_tpu_torch.models import convert
from rdm_tpu_torch.models.unet1d import UNet1D

torch.set_num_threads(1)  # the suite runs in parallel worker processes

GOLD = os.path.join(os.path.dirname(__file__), "golden", "diffusion1d_golden.npz")
LOSS_TYPES = ("NA", "one_over_t", "gt_threshold", "gt_scaled", "gt_std", "gt_std_absolute",
              "gt_std_threshold", "gt_log_likelihood")


class MockModel:
    """out = 0.5 * x, the model of the golden's fixtures."""
    channels = 1

    def __call__(self, x, t, classes=None, generator=None):
        return 0.5 * x

    def forward_with_cond_scale(self, x, t, classes, cond_scale=1.0, rescaled_phi=0.0):
        return 0.5 * x


class JMockModel:
    channels = 1

    def apply(self, variables, x, t, classes=None, rngs=None, cond_drop_prob=None):
        return 0.5 * x

    def forward_with_cond_scale(self, params, x, t, classes, cond_scale=1.0,
                                rescaled_phi=0.0):
        return 0.5 * x


def constraint(xp):
    """A toy violation over the flattened sequence, in either package."""
    def fn(x_flat, classes, scale):
        return (xp.abs(x_flat[:, 0] - classes[:, 0]) + (x_flat ** 2).mean(1)) * scale
    return fn


def t_(a):
    return torch.from_numpy(np.asarray(a))


def ncl(a):
    """JAX (B, L, C[, S]) -> the port's (B, C, L[, S])."""
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.swapaxes(a, 1, 2).copy())


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLD)


@pytest.fixture(scope="module")
def diff():
    return GaussianDiffusion1D(MockModel(), seq_length=67, timesteps=40)


def test_schedules_golden(golden, diff):
    for name, rtol in (("betas", 1e-6), ("alphas_cumprod", 1e-6), ("posterior_variance", 1e-5),
                       ("posterior_log_variance_clipped", 1e-5), ("posterior_mean_coef1", 1e-5),
                       ("posterior_mean_coef2", 1e-5), ("loss_weight", 1e-6)):
        np.testing.assert_allclose(getattr(diff, name).numpy(), golden[name], rtol=rtol)
        assert getattr(diff, name).dtype == torch.float32
    np.testing.assert_allclose(linear_beta_schedule(40).astype(np.float32),
                               golden["linear_betas"], rtol=1e-6)


def test_conversions_and_posterior_golden(golden, diff):
    x0, noise, t = t_(golden["x_start"]), t_(golden["noise"]), t_(golden["t"])
    x_t = diff.q_sample(x0, t, noise)
    np.testing.assert_allclose(x_t.numpy(), golden["x_t"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(diff.predict_start_from_noise(x_t, t, noise).numpy(),
                               golden["pred_x0"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(diff.predict_noise_from_start(x_t, t, t_(golden["pred_x0"])).numpy(),
                               golden["pred_noise_rt"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(diff.predict_v(x0, t, noise).numpy(), golden["v"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(diff.predict_start_from_v(x_t, t, t_(golden["v"])).numpy(),
                               golden["x0_from_v"], rtol=1e-4, atol=1e-4)
    mean, _, logvar = diff.q_posterior(x0, x_t, t)
    np.testing.assert_allclose(mean.numpy(), golden["post_mean"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(logvar.numpy()[:, 0, 0], golden["post_logvar"][:, 0, 0], rtol=1e-4)


def test_p_mean_variance_and_loss_golden(golden, diff):
    x_t, t, classes = t_(golden["x_t"]), t_(golden["t"]), t_(golden["classes"])
    mean, _, logvar, x0_hat = diff.p_mean_variance(x_t, t, classes, 6.0, 0.7)
    np.testing.assert_allclose(mean.numpy(), golden["p_mean"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(logvar.numpy(), golden["p_logvar"], rtol=1e-4)
    np.testing.assert_allclose(x0_hat.numpy(), golden["x0_hat"], rtol=1e-4, atol=1e-5)
    loss = diff.p_losses(t_(golden["x_start"]), t, classes, noise=t_(golden["noise"]))
    np.testing.assert_allclose(float(loss), float(golden["loss_na"]), rtol=1e-4)


def test_ddim_trajectory_golden(golden):
    diff = GaussianDiffusion1D(MockModel(), seq_length=67, timesteps=40, sampling_timesteps=10)
    assert diff.is_ddim_sampling
    z0 = t_(golden["z0"])
    out = diff.ddim_sample(t_(golden["classes"]), tuple(z0.shape), cond_scale=6.0, z=z0)
    np.testing.assert_allclose(out.numpy(), golden["ddim_out"], rtol=1e-4, atol=1e-5)


def jax_draws(key, B, L, T, S):
    """The draws of the JAX package's ``__call__`` / ``p_losses`` under
    ``key``: t, x_t's noise, the guided sample's and the ground truth's."""
    k_t, k_loss = jax.random.split(key)
    t = jax.random.randint(k_t, (B,), 0, T)
    k_noise, k_ps, k_gt = jax.random.split(k_loss, 3)
    noise = jax.random.normal(k_noise, (B, L, 1), jnp.float32)
    ps = jax.random.normal(k_ps, (B, L, 1), jnp.float32)
    gt = jax.random.normal(k_gt, (B, L, 1, S), jnp.float32)
    return {"t": t_(np.asarray(t).astype(np.int64)), "noise": ncl(noise), "ps_noise": ncl(ps),
            "gt_noise": ncl(gt)}


def _pair(clt, model, jmodel, by_sigma="False", S=4, L=8, T=16):
    kw = dict(seq_length=L, timesteps=T, constraint_loss_type=clt, constraint_gt_sample_num=S,
              constraint_violation_weight=1.0, normalize_xt_by_mean_sigma=by_sigma,
              max_sample_step_with_constraint_loss=10)
    fns = ({}, {}) if clt == "NA" else ({"constraint_fn": constraint(jnp)},
                                        {"constraint_fn": constraint(torch)})
    return JDiffusion(jmodel, **kw, **fns[0]), GaussianDiffusion1D(model, **kw, **fns[1])


@pytest.mark.parametrize("by_sigma", ["False", "True"])
def test_p_losses_every_type_against_jax(by_sigma):
    B, L, T, S = 6, 8, 16, 4
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (B, L, 1)).astype(np.float32)
    classes = rng.uniform(0, 1, (B, 1)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    draws = jax_draws(key, B, L, T, S)
    for clt in LOSS_TYPES:
        jd, pd = _pair(clt, MockModel(), JMockModel(), by_sigma, S, L, T)
        ref = float(jd(None, key, jnp.asarray(img), jnp.asarray(classes)))
        ours = float(pd(ncl(img), t_(classes), **draws))
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6, err_msg=clt)


def test_p_losses_through_the_unet_against_jax():
    """The guided sample inside the loss runs the U-Net's 2B forward."""
    B, L, T, S = 4, 66, 16, 3
    kw = dict(dim=8, channels=1, dim_mults=(1, 2, 4), embed_class_layers_dims=(8, 8),
              class_dim=1, cond_drop_prob=0.0, mask_val=-1.0, seq_length=L, legacy=True)
    jm = JUNet1D(**kw)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, L, 1)),
                            jnp.zeros((2,)), jnp.zeros((2, 1)))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
                          shapes)
    model = UNet1D(**kw)
    model.load_state_dict(convert.unet1d_state_dict_from_jax(params, True), strict=True)
    jd, pd = _pair("gt_std", model, jm, "True", S, L, T)
    img = rng.uniform(0, 1, (B, L, 1)).astype(np.float32)
    classes = rng.uniform(0, 1, (B, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = float(jax.jit(jd.__call__)(params, key, jnp.asarray(img), jnp.asarray(classes)))
    ours = float(pd(ncl(img), t_(classes), **jax_draws(key, B, L, T, S)).detach())
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def scan_noises(key, n, shape):
    """The per-step noises of the JAX package's scans, (n, B, C, L): each
    step (key, k) = split(key), normal(k)."""
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(ncl(jax.random.normal(k, shape, jnp.float32)))
    return torch.stack(out)


@pytest.mark.parametrize("sampler", ["ancestral", "ddim_eta_0.5"])
def test_samplers_against_jax(sampler):
    B, L, T = 3, 8, 12
    ddim = sampler != "ancestral"
    kw = dict(seq_length=L, timesteps=T, sampling_timesteps=5 if ddim else None,
              ddim_sampling_eta=0.5 if ddim else 0.0)
    jd, pd = JDiffusion(JMockModel(), **kw), GaussianDiffusion1D(MockModel(), **kw)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((B, L, 1)).astype(np.float32)
    classes = rng.uniform(0, 1, (B, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    fn = jd.ddim_sample if ddim else jd.p_sample_loop
    ref = fn(None, key, jnp.asarray(classes), z.shape, 6.0, 0.7, z=jnp.asarray(z))
    _, k_scan = jax.random.split(key)
    noises = scan_noises(k_scan, 5 if ddim else T, z.shape)
    pfn = pd.ddim_sample if ddim else pd.p_sample_loop
    ours = pfn(t_(classes), (B, 1, L), 6.0, 0.7, z=ncl(z), noises=noises)
    np.testing.assert_allclose(ours.numpy(), ncl(ref).numpy(), rtol=1e-5, atol=1e-6)


def test_interpolate_against_jax():
    B, L, T = 2, 8, 12
    jd = JDiffusion(JMockModel(), seq_length=L, timesteps=T)
    pd = GaussianDiffusion1D(MockModel(), seq_length=L, timesteps=T)
    rng = np.random.default_rng(4)
    x1, x2 = (rng.uniform(-1, 1, (B, L, 1)).astype(np.float32) for _ in range(2))
    classes = np.zeros((B, 1), np.float32)
    key = jax.random.PRNGKey(2)
    ref = jd.interpolate(None, key, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(classes),
                         lam=0.3)
    k1, k2, k_scan = jax.random.split(key, 3)
    ours = pd.interpolate(ncl(x1), ncl(x2), t_(classes), lam=0.3,
                          noise1=ncl(jax.random.normal(k1, x1.shape)),
                          noise2=ncl(jax.random.normal(k2, x2.shape)),
                          noises=scan_noises(k_scan, T - 1, x1.shape))
    np.testing.assert_allclose(ours.numpy(), ncl(ref).numpy(), rtol=1e-5, atol=1e-6)


def test_sample_draws_from_the_generator_and_constraint_types_need_a_function():
    pd = GaussianDiffusion1D(MockModel(), seq_length=8, timesteps=6)
    classes = torch.zeros((2, 1))
    a = pd.sample(classes, generator=torch.Generator().manual_seed(1))
    b = pd.sample(classes, generator=torch.Generator().manual_seed(1))
    assert a.shape == (2, 1, 8) and torch.equal(a, b)
    with pytest.raises(ValueError):
        GaussianDiffusion1D(MockModel(), seq_length=8, timesteps=16, constraint_loss_type="gt_std")
