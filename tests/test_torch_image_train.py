"""The image pairings of ``tests/test_trainer_image_e2e.py:CASES`` (CIFAR-10
with DDPM++, ImageNet32 with VDM, ImageNet64C with the class-conditional
ADM) train two steps and snapshot-sample through the port's trainer on
seeded fixtures; ADM and VDM checkpoints cross between the packages in both
directions with the Adam state.  Checkpoints carry float32 values, so the
crossings are exact."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_trainer_image_e2e import CASES

from rdm_tpu.config import load_config as jax_load_config
from rdm_tpu.models import registry as jregistry
from rdm_tpu.models.ema import EMAState
from rdm_tpu.training import checkpoints as jax_checkpoints
from rdm_tpu.training import get_optimizer as jax_get_optimizer
from rdm_tpu.training.state import TrainState as JTrainState
from rdm_tpu_torch.config import load_config, save_config_snapshot
from rdm_tpu_torch.models import convert, create_model
from rdm_tpu_torch.training import checkpoints, trainer
from rdm_tpu_torch.training.state import init_train_state

torch.set_num_threads(1)  # the suite runs in parallel worker processes

RUN = ["training.batch_size=8", "eval.batch_size=8", "training.n_iters=2",
       "training.snapshot_freq=2", "training.eval_freq=1",
       "training.snapshot_freq_for_preemption=2", "sde.num_scales=4", "optim.warmup=2"]


def overrides(name, dataroot=None):
    case = CASES[name]
    extra = [f"dataroot={dataroot}"] if dataroot else []
    return [f"data={case['data']}", f"model={case['model']}"] + extra + RUN + case["overrides"]


@pytest.mark.parametrize("name", list(CASES))
def test_image_config_trains(name, tmp_path):
    case = CASES[name]
    dataroot = tmp_path / "data"
    os.makedirs(dataroot)
    case["fixture"](str(dataroot))
    cfg = load_config("train", overrides(name, dataroot) + ["+device=cpu"])
    work_dir = str(tmp_path / "work")
    os.makedirs(work_dir)
    save_config_snapshot(cfg, work_dir)
    trainer.run(cfg, work_dir)

    with open(os.path.join(work_dir, "logs")) as f:
        log = f.read()
    losses = re.findall(r"step: (\d+), training_loss: ([\d.e+-]+)", log)
    assert len(losses) == 3 and all(np.isfinite(float(v)) for _, v in losses)
    evals = re.findall(r"step: (\d+), evaluation_loss: ([\d.e+-]+)", log)
    assert len(evals) == 3 and all(np.isfinite(float(v)) for _, v in evals)
    path = os.path.join(work_dir, "checkpoints", "checkpoint_1.pth")
    ck = checkpoints.restore_checkpoint(path)
    state = init_train_state(create_model(cfg), cfg)
    checkpoints.load_into_state(state, ck)
    assert state.step == 3 and state.optimizer.count == 3
    sample = np.load(os.path.join(work_dir, "samples", "iter_2", "sample_0.npy"))
    assert sample.shape == case["sample_shape"] and sample.dtype == np.uint8


FAMILY_CASES = {"adm": "imagenet64c_adm", "vdm": "imagenet32_vdm"}


def jax_template(cfg):
    model = jregistry.create_model(cfg)
    size = cfg.data.image_size
    labels = jnp.zeros((2, 1)) if cfg.model.name == "adm" else None
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, size, size, 3)), jnp.full((2,), 0.5),
                            labels)["params"]
    return JTrainState(step=0, params=shapes,
                       opt_state=jax.eval_shape(jax_get_optimizer(cfg).init, shapes),
                       ema=EMAState(decay=cfg.model.ema_rate, num_updates=np.int32(0),
                                    shadow_params=shapes))


def port_state(cfg, seed=0):
    """The port's state after one update from seeded gradients (moments and
    counts not zero) and one EMA step."""
    model = create_model(cfg).init_weights(torch.Generator().manual_seed(seed))
    state = init_train_state(model, cfg)
    gen = torch.Generator().manual_seed(seed + 1)
    grads = [1e-2 * torch.randn(p.shape, generator=gen) for p in state.params]
    _, norm = state.optimizer.check(torch.zeros(()), grads)
    state.optimizer.apply(grads, norm)
    state.ema.update(state.params)
    state.step = 1
    return state


@pytest.mark.parametrize("family", list(FAMILY_CASES))
def test_port_checkpoint_resumes_in_jax(family, tmp_path):
    name = FAMILY_CASES[family]
    cfg = load_config("train", overrides(name))
    state = port_state(cfg)
    path = str(tmp_path / "checkpoint_1.pth")
    checkpoints.save_checkpoint(path, state, config=cfg)
    raw = torch.load(path, weights_only=False)
    assert set(raw["model"]) == set(state.model.state_dict())      # reference names
    jcfg = jax_load_config("train", overrides(name))
    restored = jax_checkpoints.restore_checkpoint(path, jax_template(jcfg), model_name=family)
    from_jax = convert.FAMILIES[family][0]
    theirs = from_jax(jax.device_get(restored.params))
    theirs_ema = from_jax(jax.device_get(restored.ema.shadow_params))
    adam, schedule = restored.opt_state[1], restored.opt_state[2]
    mu, nu = from_jax(adam.mu), from_jax(adam.nu)
    assert int(restored.step) == 1 and int(adam.count) == 1 and int(schedule.count) == 1
    for n, p, s, m, v in zip(state.optimizer.names, state.params, state.ema.shadow_params,
                             state.optimizer.mu, state.optimizer.nu):
        assert torch.equal(theirs[n], p.detach()) and torch.equal(theirs_ema[n], s), n
        assert torch.equal(mu[n], m) and torch.equal(nu[n], v), n
    assert float(sum(v.abs().sum() for v in state.optimizer.nu)) > 0


@pytest.mark.parametrize("family", list(FAMILY_CASES))
def test_jax_checkpoint_resumes_in_port(family, tmp_path):
    """The JAX package writes ADM and VDM checkpoints with an empty ``model``
    entry and the weights in ``native_params``; the port restores them, with
    the Adam state, and goes on training."""
    name = FAMILY_CASES[family]
    jcfg = jax_load_config("train", overrides(name))
    template = jax_template(jcfg)
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
                          template.params)
    tx = jax_get_optimizer(jcfg)
    update = jax.jit(tx.update)
    grads = jax.tree.map(lambda p: (1e-2 * rng.normal(size=p.shape)).astype(np.float32), params)
    _, opt_state = update(grads, tx.init(params), params)
    shadow = jax.tree.map(lambda p: 0.5 * p, params)
    jstate = JTrainState(step=np.int32(5), params=params, opt_state=opt_state,
                         ema=EMAState(decay=jcfg.model.ema_rate, num_updates=np.int32(5),
                                      shadow_params=shadow))
    path = str(tmp_path / "checkpoint_1.pth")
    jax_checkpoints.save_checkpoint(path, jax.device_get(jstate), config=jcfg, model_name=family)
    assert torch.load(path, weights_only=False)["model"] == {}

    cfg = load_config("train", overrides(name))
    ck = checkpoints.restore_checkpoint(path)          # the family from the checkpoint's config
    state = init_train_state(create_model(cfg), cfg)
    checkpoints.load_into_state(state, ck)
    from_jax = convert.FAMILIES[family][0]
    ours_params, ours_ema = from_jax(params), from_jax(shadow)
    opt_state = jax.device_get(opt_state)
    adam = opt_state[1]
    mu, nu = from_jax(jax.device_get(adam.mu)), from_jax(jax.device_get(adam.nu))
    assert state.step == 5 and state.ema.num_updates == 5
    assert state.optimizer.count == int(adam.count) == 1 and state.optimizer.schedule_count == 1
    for n, p, s, m, v in zip(state.optimizer.names, state.params, state.ema.shadow_params,
                             state.optimizer.mu, state.optimizer.nu):
        assert torch.equal(p.detach(), ours_params[n]) and torch.equal(s, ours_ema[n]), n
        assert torch.equal(m, mu[n]) and torch.equal(v, nu[n]), n

    # the next update from the same gradients: optax's and the port's agree
    g = [torch.from_numpy(np.asarray(t)) for t in
         (from_jax(grads)[n] for n in state.optimizer.names)]
    _, norm = state.optimizer.check(torch.zeros(()), g)
    state.optimizer.apply(g, norm)
    updates, _ = update(grads, opt_state, params)
    theirs = from_jax(jax.device_get(jax.jit(optax.apply_updates)(params, updates)))
    for n, p in zip(state.optimizer.names, state.params):
        np.testing.assert_allclose(p.detach().numpy(), theirs[n].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=n)
