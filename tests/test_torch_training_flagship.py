"""One bfloat16 training step of the flagship checkpoint in the port against
the JAX package: the loss and the gradient of every trainable parameter."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import NCSNpp as JNCSNpp
from rdm_tpu.models.ema import EMAState
from rdm_tpu.sde import RVESDE as JRVESDE
from rdm_tpu.training import checkpoints as jax_checkpoints
from rdm_tpu.training import get_loss_fn as jax_get_loss_fn
from rdm_tpu.training import get_optimizer as jax_get_optimizer
from rdm_tpu.training.state import TrainState as JTrainState
from rdm_tpu_torch.config import load_hydra_config_from_run
from rdm_tpu_torch.models import create_model
from rdm_tpu_torch.models.convert import state_dict_from_jax
from rdm_tpu_torch.sde import RVESDE
from rdm_tpu_torch.training.checkpoints import restore_checkpoint
from rdm_tpu_torch.training.losses import get_loss_fn

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "Training Runs", "2026.08.17_184657")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def flagship_jax_params():
    cfg = load_hydra_config_from_run(FLAGSHIP)
    shapes = jax.eval_shape(JNCSNpp.from_config(cfg).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 9, 9, 1)), jnp.full((2,), 0.5),
                            jnp.zeros((2, 1)))["params"]
    template = JTrainState(step=0, params=shapes,
                           opt_state=jax.eval_shape(jax_get_optimizer(cfg).init, shapes),
                           ema=EMAState(decay=0.999, num_updates=np.int32(0),
                                        shadow_params=shapes))
    return jax_checkpoints.restore_checkpoint(
        os.path.join(FLAGSHIP, "checkpoints", "checkpoint_10.pth"), template).params


def test_flagship_bf16_step_matches_jax(flagship_jax_params):
    """checkpoint_10.pth (live weights), batch 4, the flagship's bfloat16
    compute with its attention kernels (JAX: Pallas in interpret mode),
    dropout and label drop off so that both sides draw nothing: the loss and
    the gradients of every trainable parameter.

    As for the forward (test_torch_ncsnpp.py), the yardstick is how far
    bfloat16 moves the JAX result from its float32 result: two roundings of
    one computation land on different sides of a rounding boundary here and
    there, and the later layers carry the step on.  The port's loss lies
    within twice that distance of the float32 loss (measured: 1.14); the
    gradients, as one vector, within twice of the JAX bfloat16 gradients
    (measured: 0.65) and no closer to float32 than a twentieth of it (1.08).
    One tensor's distance is a noisy yardstick (its few elements may all
    sit near rounding boundaries on one side), so each parameter's gradient
    is held to four times JAX's distance from float32 (measured: at most
    2.44, for the first attention block's q bias, which the longest
    backward chain reaches).
    """
    ck = restore_checkpoint(os.path.join(FLAGSHIP, "checkpoints", "checkpoint_10.pth"))
    rng = np.random.default_rng(3)
    batch = rng.uniform(0.05, 0.95, (4, 9, 9, 1)).astype(np.float32)
    labels = rng.uniform(size=(4, 1)).astype(np.float32)
    t = np.array([0.05, 0.3, 0.6, 0.95], np.float32)
    z = rng.standard_normal((4, 9, 9, 1)).astype(np.float32)

    def config(precision):
        cfg = load_hydra_config_from_run(FLAGSHIP)
        cfg.model.update(dropout=0.0, cond_drop_prob=0.0, precision=precision)
        return cfg

    def jax_grads(precision):
        lf = jax_get_loss_fn(JRVESDE(0.01, 5, 1000), JNCSNpp.from_config(config(precision)),
                             train=True, reduce_mean=False, likelihood_weighting=False)
        f = jax.jit(jax.value_and_grad(
            lambda p: lf(p, batch, labels, jax.random.PRNGKey(0), t=t, z=z)))
        # Compiled whole (op by op it costs three times as long), with every
        # bfloat16 rounding the program writes kept: XLA would otherwise
        # carry fused intermediates in float32, which neither the port nor
        # an eager run does.
        f = f.lower(flagship_jax_params).compile(
            compiler_options={"xla_allow_excess_precision": False})
        loss, g = f(flagship_jax_params)
        return float(loss), state_dict_from_jax(jax.device_get(g))

    (jl, jg), (fl, fg) = jax_grads("bfloat16"), jax_grads("float32")
    cfg = config("bfloat16")
    assert cfg.model.attn_pallas is True
    model = create_model(cfg)
    model.load_state_dict(ck.model, strict=True)
    loss = get_loss_fn(RVESDE(0.01, 5, 1000), train=True, reduce_mean=False,
                       likelihood_weighting=False)(
        model, nchw(batch), torch.from_numpy(labels), torch.Generator(),
        t=torch.from_numpy(t), z=nchw(z))
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    assert abs(float(loss) - fl) <= 2 * abs(jl - fl), (float(loss), jl, fl)
    ours = torch.cat([g.flatten() for g in grads])
    bf16 = torch.cat([jg[n].flatten() for n, _ in named])
    f32 = torch.cat([fg[n].flatten() for n, _ in named])
    spread = float((bf16 - f32).norm())
    assert float((ours - bf16).norm()) <= 2 * spread
    assert float((ours - f32).norm()) >= spread / 20
    for (n, _), g in zip(named, grads):
        assert g.dtype == torch.float32
        assert float((g - fg[n]).norm()) <= 4 * float((jg[n] - fg[n]).norm()), n
