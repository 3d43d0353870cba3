"""The port's training step against the JAX package: EMA, the optimizer
chain, the loss, a 5-step run in float32, one bfloat16 step of the flagship
checkpoint (test_torch_training_flagship.py), dropout and the guarded
update, all on the same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from rdm_tpu.config import load_config as jax_load_config
from rdm_tpu.models import NCSNpp as JNCSNpp
from rdm_tpu.models import ema as jax_ema
from rdm_tpu.sde import RVESDE as JRVESDE
from rdm_tpu.training import get_loss_fn as jax_get_loss_fn
from rdm_tpu.training import get_optimizer as jax_get_optimizer
from rdm_tpu.training import make_train_step as jax_make_train_step
from rdm_tpu.training.losses import _guarded_update as jax_guarded_update
from rdm_tpu.training.state import TrainState as JTrainState
from rdm_tpu_torch.config import load_config
from rdm_tpu_torch.models import NCSNpp
from rdm_tpu_torch.models.convert import state_dict_from_jax
from rdm_tpu_torch.models.ema import ExponentialMovingAverage
from rdm_tpu_torch.models.layers import apply_dropout
from rdm_tpu_torch.sde import RVESDE
from rdm_tpu_torch.training.losses import (ClipAdamWarmup, get_loss_fn, guarded_update,
                                           make_eval_step, make_train_step)
from rdm_tpu_torch.training.state import TrainState, init_train_state

torch.set_num_threads(1)  # the suite runs in parallel worker processes

SMALL = ["model.nf=16", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
         "model.attn_resolutions=[9]", "model.dropout=0.0", "model.cond_drop_prob=0.0",
         "optim.warmup=2", "optim.lr=0.001"]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def small_setup(seed=0):
    """The small NCSN++ of both packages (nf 16, two levels, attention at
    9x9) on the same random float32 weights."""
    jcfg, cfg = jax_load_config("train", SMALL), load_config("train", SMALL)
    jmodel = JNCSNpp.from_config(jcfg)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 9, 9, 1)), jnp.full((2,), 0.5), jnp.zeros((2, 1)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32),
                          shapes["params"])
    model = NCSNpp.from_config(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return jcfg, cfg, jmodel, params, model


def step_inputs(K, B, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 0.95, (K, B, 9, 9, 1)).astype(np.float32),
            rng.uniform(size=(K, B, 1)).astype(np.float32),
            rng.uniform(1e-5, 1.0, (K, B)).astype(np.float32),
            rng.standard_normal((K, B, 9, 9, 1)).astype(np.float32))


# ---------------------------------------------------------------------------
# EMA and optimizer

def test_ema_matches_jax():
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jstate = jax_ema.init(p0, decay=0.999)
    ours = ExponentialMovingAverage([torch.from_numpy(p) for p in p0], decay=0.999)
    for k in range(12):
        pk = [rng.normal(size=s).astype(np.float32) for s in shapes]
        jstate = jax_ema.update(jstate, pk)
        ours.update([torch.from_numpy(p) for p in pk])
        assert ours.num_updates == int(jstate.num_updates)
        for a, b in zip(ours.shadow_params, jstate.shadow_params):
            # float32 on both sides, the same operations in the same order
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_optimizer_and_guarded_update_match_optax():
    """Six guarded updates through both packages on the same gradients: the
    first at learning rate 0 (warmup), one whose norm triggers clipping, one
    with a NaN (skipped: only the step advances), then ordinary ones."""
    cfg = jax_load_config("train", ["optim.warmup=3", "optim.lr=0.01", "optim.grad_clip=0.5"])
    tx = jax_get_optimizer(cfg)
    rng = np.random.default_rng(1)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(6,)).astype(np.float32)}
    jstate = JTrainState(step=jnp.int32(0), params=p0, opt_state=tx.init(p0),
                         ema=jax_ema.init(p0, 0.999))
    named = [(k, torch.from_numpy(v.copy())) for k, v in p0.items()]
    ours = TrainState(step=0, model=None,
                      optimizer=ClipAdamWarmup(named, lr=0.01, warmup=3, grad_clip=0.5),
                      ema=ExponentialMovingAverage([p for _, p in named], 0.999))
    scales = [0.05, 3.0, 0.05, 0.05, 0.05, 0.05]     # step 2 has norm ~10: clipped
    for k, scale in enumerate(scales):
        g = {n: (scale * rng.normal(size=v.shape)).astype(np.float32) for n, v in p0.items()}
        if k == 2:
            g["b"][1] = np.nan
        loss = np.float32(1.0)
        before = [p.clone() for p in ours.params]
        jstate = jax_guarded_update(jstate, jnp.asarray(loss), g, tx)
        applied = guarded_update(ours, torch.tensor(loss), [torch.from_numpy(g[n]) for n in p0])
        assert applied == (k != 2)
        assert ours.step == int(jstate.step) == k + 1
        adam, sched = jstate.opt_state[1], jstate.opt_state[2]
        assert ours.optimizer.count == int(adam.count)
        assert ours.optimizer.schedule_count == int(sched.count)
        if k == 0 or k == 2:   # learning rate 0, or skipped: parameters unchanged
            for a, b in zip(ours.params, before):
                assert torch.equal(a, b)
        for i, n in enumerate(p0):
            # float32 both sides; pow and sqrt may differ by an ulp
            for mine, theirs in ((ours.params[i], jstate.params[n]),
                                 (ours.optimizer.mu[i], adam.mu[n]),
                                 (ours.optimizer.nu[i], adam.nu[n]),
                                 (ours.ema.shadow_params[i], jstate.ema.shadow_params[n])):
                np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5,
                                           atol=1e-7)
    assert ours.optimizer.count == 5                     # the NaN step did not count


def test_learning_rate_schedule():
    opt = ClipAdamWarmup([("w", torch.zeros(2))], lr=5e-4, warmup=10000)
    assert opt.learning_rate(0) == 0.0
    assert opt.learning_rate(100000) == float(np.float32(5e-4))
    assert opt.learning_rate(5000) == float(np.float32(5e-4) * np.float32(0.5))


# ---------------------------------------------------------------------------
# Loss and steps

@pytest.mark.parametrize("likelihood_weighting,reduce_mean", [(False, False), (True, True)])
def test_loss_with_t_z_overrides_matches_jax(likelihood_weighting, reduce_mean):
    jcfg, cfg, jmodel, params, model = small_setup()
    batch, labels, t, z = (a[0] for a in step_inputs(1, 6))
    jloss = jax_get_loss_fn(JRVESDE(0.01, 5, 1000), jmodel, train=False, reduce_mean=reduce_mean,
                            likelihood_weighting=likelihood_weighting)
    theirs = float(jax.jit(jloss)(params, batch, labels, jax.random.PRNGKey(0), t=t, z=z))
    loss_fn = get_loss_fn(RVESDE(0.01, 5, 1000), train=False, reduce_mean=reduce_mean,
                          likelihood_weighting=likelihood_weighting)
    with torch.no_grad():
        ours = float(loss_fn(model, nchw(batch), torch.from_numpy(labels), None,
                             t=torch.from_numpy(t), z=nchw(z)))
    # float32; convolutions and norms sum in another order
    assert abs(ours - theirs) <= 1e-5 * abs(theirs), (ours, theirs)


def test_five_train_steps_match_jax_f32():
    """Five make_train_step updates of both packages from the same weights on
    the same batches, labels, t and z, with dropout and label drop off, in
    float32: the loss of every step and the final parameters."""
    jcfg, cfg, jmodel, params, model = small_setup()
    K = 5
    batches, labels, ts, zs = step_inputs(K, 8)
    tx = jax_get_optimizer(jcfg)
    jstate = JTrainState(step=jnp.asarray(0, jnp.int32), params=params,
                         opt_state=tx.init(params),
                         ema=jax_ema.init(params, decay=jcfg.model.ema_rate))
    jstep = jax.jit(jax_make_train_step(JRVESDE(0.01, 5, 1000), jmodel, tx))
    state = init_train_state(model, cfg)
    step = make_train_step(RVESDE(0.01, 5, 1000))
    gen = torch.Generator().manual_seed(0)
    for k in range(K):
        jstate, jl = jstep(jstate, batches[k], labels[k], jax.random.PRNGKey(k),
                           t=ts[k], z=zs[k])
        loss = step(state, nchw(batches[k]), torch.from_numpy(labels[k]), gen,
                    t=torch.from_numpy(ts[k]), z=nchw(zs[k]))
        # float32; measured at most 8e-7 relative
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl)), (k, loss, jl)
    assert state.step == int(jstate.step) == K and state.optimizer.count == K
    theirs = state_dict_from_jax(jax.device_get(jstate.params))
    lr_sum = 0.001 * (0 + 0.5 + 1 + 1 + 1)    # the warmup schedule's steps
    for name, ours in model.state_dict().items():
        err = float((ours - theirs[name]).abs().max())
        if name.endswith("NIN_1.b"):
            # The attention's k bias has a gradient of zero in exact
            # arithmetic (softmax ignores a shift that is the same for every
            # key); both packages feed Adam rounding noise there, which it
            # scales up to steps of size lr.  Measured: 0.0034 of the summed
            # learning rates.
            assert err <= 0.01 * lr_sum, (name, err)
        else:
            # every other parameter moves the same in both (measured: < 1e-6)
            assert err <= 1e-5, (name, err)


def test_train_mode_label_drop_and_dropout():
    """Label drop with probability 1 gives the unconditional output, with
    probability 0 the conditional one; dropout draws from the generator."""
    _, cfg, _, _, model = small_setup()
    x = torch.rand(3, 1, 9, 9, generator=torch.Generator().manual_seed(0))
    sigma = torch.tensor([0.05, 0.5, 2.0])
    labels = torch.rand(3, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        cond = model(x, sigma, labels)
        uncond = model(x, sigma, torch.zeros_like(labels))
        model.cond_drop_prob = 1.0
        assert torch.equal(model(x, sigma, labels, train=True,
                                 generator=torch.Generator()), uncond)
        model.cond_drop_prob = 0.0
        assert torch.equal(model(x, sigma, labels, train=True,
                                 generator=torch.Generator()), cond)
        for blk in model.modules():
            if hasattr(blk, "dropout"):
                blk.dropout = 0.5
        a = model(x, sigma, labels, train=True, generator=torch.Generator().manual_seed(3))
        b = model(x, sigma, labels, train=True, generator=torch.Generator().manual_seed(3))
        c = model(x, sigma, labels, train=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, cond)
    with pytest.raises(ValueError):
        model(x, sigma, labels, train=True)


def test_dropout_matches_flax_bf16():
    """On the same keep mask, the port's bfloat16 dropout equals Flax's bit
    for bit (the keep probability rounds to bfloat16 before the division);
    multiplying by 1/(1-p), as F.dropout does, differs in about one kept
    value of seven (measured: 13.8 %)."""
    rng = np.random.default_rng(0)
    h = rng.normal(size=(64, 32, 9, 9)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    hj = jnp.asarray(h, jnp.bfloat16)
    theirs = fnn.Dropout(0.2, deterministic=False).apply({}, hj, rng=key)
    mask = np.array(jax.random.bernoulli(key, 0.8, h.shape))
    theirs = np.asarray(theirs.astype(jnp.float32))
    ht = torch.from_numpy(h).to(torch.bfloat16)
    ours = apply_dropout(ht, torch.from_numpy(mask), 0.2).float().numpy()
    np.testing.assert_array_equal(ours, theirs)
    scaled = (ht * (1.0 / 0.8)).float().numpy()[mask]
    assert (scaled != theirs[mask]).mean() > 0.05


def test_non_finite_step_is_skipped():
    _, cfg, _, _, model = small_setup()
    state = init_train_state(model, cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = torch.full((4, 1, 9, 9), float("nan"))
    loss = make_train_step(RVESDE(0.01, 5, 1000))(state, batch, torch.zeros(4, 1),
                                                  torch.Generator().manual_seed(0))
    assert not torch.isfinite(loss)
    assert state.step == 1 and state.optimizer.count == 0 and state.ema.num_updates == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(float(m.abs().sum()) == 0 for m in state.optimizer.mu)


def test_eval_step_uses_ema_weights_and_restores_live():
    _, cfg, _, _, model = small_setup()
    state = init_train_state(model, cfg)
    with torch.no_grad():
        for s in state.ema.shadow_params:
            s.mul_(0.5)
    live = {k: v.clone() for k, v in model.state_dict().items()}
    batch, labels, t, z = (a[0] for a in step_inputs(1, 4))
    gen = lambda: torch.Generator().manual_seed(5)
    ema_loss = make_eval_step(RVESDE(0.01, 5, 1000))(state, nchw(batch),
                                                     torch.from_numpy(labels), gen())
    for k, v in model.state_dict().items():
        assert torch.equal(v, live[k]), k
    state.ema.copy_to(state.params)
    direct = get_loss_fn(RVESDE(0.01, 5, 1000), train=False, reduce_mean=False,
                         likelihood_weighting=False)(model, nchw(batch),
                                                      torch.from_numpy(labels), gen())
    assert float(ema_loss) == float(direct)
