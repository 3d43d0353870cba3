"""The port's NCSN++ against the reference goldens and the JAX package,
with weights carried over through ``models.convert``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import NCSNpp as JNCSNpp
from rdm_tpu_torch.config import load_hydra_config_from_run
from rdm_tpu_torch.models import NCSNpp, create_model
from rdm_tpu_torch.models.convert import ema_param_order, ema_state_dict, state_dict_from_jax
from rdm_tpu_torch.training.checkpoints import latest_checkpoint, restore_checkpoint

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden", "ncsnpp_golden.npz")
FLAGSHIP = os.path.join(ROOT, "Training Runs", "2026.08.17_184657")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLD)


def golden_sd(golden):
    return {k[3:]: torch.from_numpy(golden[k]) for k in golden.files if k.startswith("sd.")}


@pytest.mark.parametrize("attn_kernel", [True, False])
def test_golden_outputs(golden, attn_kernel):
    sd = golden_sd(golden)
    model = NCSNpp(attn_kernel=attn_kernel)
    assert list(model.state_dict()) == list(sd)        # reference names and order
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) == int(golden["n_params"])
    x, sigma, labels = (torch.from_numpy(golden[k]) for k in ("x", "sigma", "labels"))
    with torch.no_grad():
        out_cond = model(x, sigma, labels).numpy()
        out_uncond = model(x, sigma, torch.zeros_like(labels)).numpy()
    # the tolerance of the JAX package's golden test (tests/test_ncsnpp.py)
    np.testing.assert_allclose(out_cond, golden["out_cond"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out_uncond, golden["out_uncond"], rtol=1e-4, atol=1e-5)


SMALL = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(9, 4), dropout=0.0)


def small_models_and_params(seed=0):
    """A 2-level nf=16 NCSN++ with attention at both resolutions (so the
    middle attention block exists too): the JAX module, random Flax params
    in its tree layout, and the port's model carrying those params."""
    jmodel = JNCSNpp(**SMALL)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 9, 9, 1)), jnp.full((2,), 0.5), jnp.zeros((2, 1)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32), shapes["params"])
    port = NCSNpp(**SMALL, attn_kernel=True)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmodel, params, port


def test_small_model_matches_jax_f32():
    jmodel, params, port = small_models_and_params()
    assert hasattr(port, "mid_attn")
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(3, 9, 9, 1)).astype(np.float32)
    sigma = np.array([0.02, 0.5, 4.0], np.float32)
    labels = rng.uniform(size=(3, 1)).astype(np.float32)
    theirs = np.asarray(jax.jit(jmodel.apply)({"params": params}, x, sigma, labels))
    with torch.no_grad():
        ours = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                    torch.from_numpy(sigma), torch.from_numpy(labels)).numpy()
    # float32 both sides; convolutions and GroupNorm sum in another order
    np.testing.assert_allclose(ours.transpose(0, 2, 3, 1), theirs, rtol=1e-4, atol=1e-5)


def test_ema_state_dict_order():
    sd = {"time_embed.W": torch.zeros(2), "a": torch.zeros(3), "b": torch.zeros(1)}
    assert ema_param_order(sd) == ["a", "b"]
    ema = ema_state_dict(sd, [torch.ones(3), torch.full((1,), 2.0)])
    assert list(ema) == list(sd)
    assert float(ema["a"].sum()) == 3.0 and float(ema["b"]) == 2.0
    assert ema["time_embed.W"] is sd["time_embed.W"]
    with pytest.raises(ValueError):
        ema_state_dict(sd, [torch.ones(3)])


@pytest.fixture(scope="module")
def flagship_ckpt():
    return restore_checkpoint(latest_checkpoint(os.path.join(FLAGSHIP, "checkpoints")))


def test_flagship_checkpoint_restores(flagship_ckpt):
    ck = flagship_ckpt
    assert ck.step == 100001 and ck.ema is not None
    assert list(ck.ema) == list(ck.model)
    # EMA and live weights differ, the frozen Fourier features do not
    assert not torch.equal(ck.ema["out_conv.weight"], ck.model["out_conv.weight"])
    assert torch.equal(ck.ema["time_embed.W"], ck.model["time_embed.W"])


@pytest.fixture(scope="module")
def jax_flagship_ema():
    """The flagship's EMA weights as the JAX package restores them."""
    from rdm_tpu.models.ema import EMAState
    from rdm_tpu.training import checkpoints as jcheckpoints
    from rdm_tpu.training import get_optimizer
    from rdm_tpu.training.state import TrainState

    cfg = load_hydra_config_from_run(FLAGSHIP)
    # The JAX restore needs only the tree structure of a train state.
    shapes = jax.eval_shape(JNCSNpp.from_config(cfg).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 9, 9, 1)), jnp.full((2,), 0.5),
                            jnp.zeros((2, 1)))["params"]
    template = TrainState(step=0, params=shapes,
                          opt_state=jax.eval_shape(get_optimizer(cfg).init, shapes),
                          ema=EMAState(decay=0.999, num_updates=np.int32(0),
                                       shadow_params=shapes))
    jstate = jcheckpoints.restore_checkpoint(
        os.path.join(FLAGSHIP, "checkpoints", "checkpoint_10.pth"), template)
    return jstate.ema.shadow_params


FLAGSHIP_INPUTS = dict(x=np.random.default_rng(4).uniform(size=(4, 9, 9, 1)).astype(np.float32),
                       sigma=np.array([0.01, 0.1, 1.0, 5.0], np.float32),
                       labels=np.random.default_rng(5).uniform(size=(4, 1)).astype(np.float32))


def jax_scores(cfg, params):
    """The JAX package's scores at batch 4 on the seeded inputs, NHWC."""
    apply = jax.jit(JNCSNpp.from_config(cfg).apply)
    return np.asarray(apply({"params": params}, *FLAGSHIP_INPUTS.values()), np.float32)


def port_scores(cfg, sd):
    port = create_model(cfg)
    port.load_state_dict(sd, strict=True)
    x, sigma, labels = FLAGSHIP_INPUTS.values()
    with torch.no_grad():
        ours = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                    torch.from_numpy(sigma), torch.from_numpy(labels))
    return ours.float().numpy().transpose(0, 2, 3, 1)


def per_sample_max(a):
    return np.abs(a).reshape(a.shape[0], -1).max(1)


def test_flagship_outputs_match_jax_f32(flagship_ckpt, jax_flagship_ema):
    """checkpoint_10.pth restored by both packages (EMA weights), full width,
    batch 4, float32: the same scores."""
    cfg = load_hydra_config_from_run(FLAGSHIP)
    cfg.model.precision = "float32"
    ours, theirs = port_scores(cfg, flagship_ckpt.ema), jax_scores(cfg, jax_flagship_ema)
    # float32 through ~40 layers of trained weights, summation order differs
    # in every conv and norm; the score's scale spans 1e-3 (sigma 5) to 20
    # (sigma 0.1), so each sample is held to 1e-3 of its own largest value.
    scale = per_sample_max(theirs)
    err = per_sample_max(ours - theirs)
    assert np.all(err <= 1e-3 * scale), (err, scale)


@pytest.mark.parametrize("attn_pallas", [True, False])
def test_flagship_outputs_match_jax_bf16(flagship_ckpt, jax_flagship_ema, attn_pallas):
    """The flagship as it samples: float32 parameters, bfloat16 compute.
    The JAX side runs its Pallas attention kernel in interpret mode (the
    run's own setting) or its XLA block.

    Each block agrees with its JAX twin to a bfloat16 step or two on the
    same inputs (tests/test_torch_layers.py, test_torch_attention.py), but
    the whole network cannot be held that tight: a sum that lands next to a
    rounding boundary rounds the other way on one side, and the later
    layers carry the step on.  At sigma 5 the score is ~1e-2 while the
    activations are O(1), so such steps move it by several times its own
    size; the JAX package's Pallas and XLA attention paths differ by as
    much from each other.  So the yardstick is how far bfloat16 moves the
    JAX output from its float32 output, per sample: the port's bfloat16
    output stays within 2 of those of the JAX bfloat16 output (two
    independent roundings of one computation differ by about 1.4), and is
    itself no closer to float32 than 1/20 of it (a port that computed in
    float32 would sit 1e-4 of it away).
    """
    cfg = load_hydra_config_from_run(FLAGSHIP)
    assert cfg.model.precision == "bfloat16"
    cfg.model.attn_pallas = attn_pallas
    ours, theirs = port_scores(cfg, flagship_ckpt.ema), jax_scores(cfg, jax_flagship_ema)
    cfg.model.precision = "float32"
    exact = jax_scores(cfg, jax_flagship_ema)
    spread = per_sample_max(theirs - exact)
    assert np.all(per_sample_max(ours - theirs) <= 2 * spread), (
        per_sample_max(ours - theirs) / spread)
    assert np.all(per_sample_max(ours - exact) >= spread / 20), (
        per_sample_max(ours - exact) / spread)
