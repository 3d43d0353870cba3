"""Checkpoints between the port and the JAX package, in both directions, and
resume: save, restore and go on equals a run that never stopped."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import NCSNpp as JNCSNpp
from rdm_tpu.models.ema import EMAState
from rdm_tpu.models.torch_import import ncsnpp_params_to_torch
from rdm_tpu.training import checkpoints as jax_checkpoints
from rdm_tpu.training import get_optimizer as jax_get_optimizer
from rdm_tpu.training.state import TrainState as JTrainState
from rdm_tpu_torch.config import load_config, load_hydra_config_from_run
from rdm_tpu_torch.models import NCSNpp, create_model
from rdm_tpu_torch.models.convert import ema_param_order, state_dict_from_jax
from rdm_tpu_torch.sde import RVESDE
from rdm_tpu_torch.training import checkpoints
from rdm_tpu_torch.training.losses import make_train_step
from rdm_tpu_torch.training.state import init_train_state

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "Training Runs", "2026.08.17_184657")
SMALL = ["model.nf=16", "model.ch_mult=[1,2]", "model.num_res_blocks=1", "optim.warmup=2"]


def jax_template(cfg):
    """A JAX train state of the right tree structure (the restore needs only
    that)."""
    shapes = jax.eval_shape(JNCSNpp.from_config(cfg).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 9, 9, 1)), jnp.full((2,), 0.5),
                            jnp.zeros((2, 1)))["params"]
    return JTrainState(step=0, params=shapes,
                       opt_state=jax.eval_shape(jax_get_optimizer(cfg).init, shapes),
                       ema=EMAState(decay=0.999, num_updates=np.int32(0), shadow_params=shapes))


def trained_state(cfg, steps, seed=0, state=None):
    """A small model trained for ``steps`` steps with dropout and label drop
    on; every step's batch and draws are seeded by its index."""
    if state is None:
        model = NCSNpp.from_config(cfg).init_weights(torch.Generator().manual_seed(seed))
        state = init_train_state(model, cfg)
    step = make_train_step(RVESDE(0.01, 5, 1000))
    for _ in range(steps):
        k = state.step
        rng = np.random.default_rng(100 + k)
        batch = torch.from_numpy(rng.uniform(0.05, 0.95, (6, 1, 9, 9)).astype(np.float32))
        step(state, batch, batch[:, :, 0, 0], torch.Generator().manual_seed(k))
    return state


def test_port_checkpoint_restores_through_jax(tmp_path):
    cfg = load_config("train", SMALL)
    state = trained_state(cfg, 3)
    path = str(tmp_path / "checkpoint_1.pth")
    checkpoints.save_checkpoint(path, state, config=cfg)
    raw = torch.load(path, weights_only=False)
    assert set(raw) == {"step", "model", "optimizer", "ema", "scaler", "config"}
    assert raw["scaler"] is None and raw["ema"]["num_updates"] == 3
    restored = jax_checkpoints.restore_checkpoint(path, jax_template(cfg))
    assert int(restored.step) == 3 and int(restored.ema.num_updates) == 3
    sd = state.model.state_dict()
    theirs = ncsnpp_params_to_torch(jax.device_get(restored.params))
    theirs_ema = ncsnpp_params_to_torch(jax.device_get(restored.ema.shadow_params))
    for name in ema_param_order(sd):
        np.testing.assert_array_equal(theirs[name], sd[name].numpy())
    for name, shadow in zip(ema_param_order(sd), state.ema.shadow_params):
        np.testing.assert_array_equal(theirs_ema[name], shadow.numpy())


@pytest.fixture(scope="module")
def flagship_file():
    return os.path.join(FLAGSHIP, "checkpoints", "checkpoint_10.pth")


def test_flagship_checkpoint_restores_adam_state(flagship_file):
    """The JAX package resumes the flagship with its Adam moments and count
    (100,000 updates, so the learning rate is past warmup); so does the
    port: a fresh Adam would restart warmup at learning rate 0."""
    ck = checkpoints.restore_checkpoint(flagship_file)
    assert ck.optimizer["count"] == 100000 and ck.optimizer["schedule_count"] == 100000
    assert ck.ema_num_updates == 100000
    jstate = jax_checkpoints.restore_checkpoint(flagship_file,
                                                jax_template(load_hydra_config_from_run(FLAGSHIP)))
    adam = jstate.opt_state[1]
    mu, nu = state_dict_from_jax(adam.mu), state_dict_from_jax(adam.nu)
    cfg = load_hydra_config_from_run(FLAGSHIP)
    state = init_train_state(create_model(cfg), cfg)
    checkpoints.load_into_state(state, ck)
    assert state.step == 100001 and state.optimizer.count == 100000
    assert state.optimizer.learning_rate(state.optimizer.schedule_count) == float(np.float32(5e-4))
    assert "time_embed.W" not in ck.optimizer["mu"]
    for name, m, v in zip(state.optimizer.names, state.optimizer.mu, state.optimizer.nu):
        assert torch.equal(m, mu[name]) and torch.equal(v, nu[name]), name
    assert float(sum(v.abs().sum() for v in state.optimizer.nu)) > 0
    for name, shadow in zip(state.optimizer.names, state.ema.shadow_params):
        assert torch.equal(shadow, ck.ema[name])


def test_save_restore_resume_equals_uninterrupted(tmp_path):
    cfg = load_config("train", SMALL)
    straight = trained_state(cfg, 4)
    first = trained_state(cfg, 2)
    path = str(tmp_path / "meta.pth")
    checkpoints.save_checkpoint(path, first, config=cfg)
    fresh = init_train_state(NCSNpp.from_config(cfg), cfg)
    checkpoints.load_into_state(fresh, checkpoints.restore_checkpoint(path))
    resumed = trained_state(cfg, 2, state=fresh)
    assert resumed.step == straight.step == 4
    assert resumed.optimizer.count == straight.optimizer.count
    for a, b in zip(resumed.params, straight.params):
        assert torch.equal(a, b)
    for a, b in zip(resumed.ema.shadow_params, straight.ema.shadow_params):
        assert torch.equal(a, b)
    for a, b in zip(resumed.optimizer.mu + resumed.optimizer.nu,
                    straight.optimizer.mu + straight.optimizer.nu):
        assert torch.equal(a, b)


def test_missing_checkpoint_returns_none(tmp_path):
    assert checkpoints.restore_checkpoint(str(tmp_path / "none.pth")) is None
