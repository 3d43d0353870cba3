"""The trainer's settings the port once refused: the remat policies, weight
decay against the JAX package's optax chain, and host batches
(``training.data_on_device=false``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.config import load_config as jax_load_config
from rdm_tpu.training import get_optimizer as jax_get_optimizer
from rdm_tpu_torch import data, run_train
from rdm_tpu_torch.config import load_config
from rdm_tpu_torch.models import NCSNpp
from rdm_tpu_torch.sde import RVESDE
from rdm_tpu_torch.training import checkpoints
from rdm_tpu_torch.training.losses import (_save_dots, get_loss_fn, get_optimizer,
                                           make_train_step)
from rdm_tpu_torch.training.state import init_train_state
from telemetry.plot_losses import parse_log_file

torch.set_num_threads(1)  # the suite runs in parallel worker processes

# dropout and the label drop on, the attention block through its fused
# function (the kernel's plain version on the CPU): every draw and the custom
# autograd.Function inside the recomputed region
REMAT = ["model.nf=16", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
         "model.attn_resolutions=[9]", "model.dropout=0.3", "model.cond_drop_prob=0.5",
         "model.attn_pallas=true"]


def remat_inputs():
    model = NCSNpp.from_config(load_config("train", REMAT)).init_weights(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    batch = torch.from_numpy(rng.uniform(0.05, 0.95, (6, 1, 9, 9)).astype(np.float32))
    labels = torch.from_numpy(rng.uniform(size=(6, 1)).astype(np.float32))
    return model, batch, labels


def loss_grads_state(model, batch, labels, remat):
    """The loss, the gradients, the generator's state after them and how
    many times the network's forward ran."""
    gen = torch.Generator().manual_seed(3)
    forwards = []
    hook = model.register_forward_pre_hook(lambda module, inputs: forwards.append(1))
    loss_fn = get_loss_fn(RVESDE(0.01, 5, 1000), train=True, remat=remat)
    loss = loss_fn(model, batch, labels, gen)
    params = [p for p in model.parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, params)
    hook.remove()
    return float(loss.detach()), grads, gen.get_state(), len(forwards)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gives_the_gradients_and_generator_state_of_none(remat):
    """The recomputed forward draws the masks the forward drew (the
    generator is rewound for it and put back after), so the loss, every
    gradient and the generator's state after the step equal those of
    ``none``, bit for bit in float32 on the CPU (the same operations on the
    same values)."""
    model, batch, labels = remat_inputs()
    loss0, g0, s0, n0 = loss_grads_state(model, batch, labels, "none")
    loss1, g1, s1, n1 = loss_grads_state(model, batch, labels, remat)
    assert (n0, n1) == (1, 2)                    # the backward ran the forward again
    assert loss1 == loss0
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)
    assert torch.equal(s1, s0)
    # the masks matter: another generator seed gives other gradients
    gen = torch.Generator().manual_seed(4)
    loss = get_loss_fn(RVESDE(0.01, 5, 1000), train=True, remat=remat)(model, batch, labels,
                                                                      gen)
    assert float(loss) != loss0


def test_remat_train_step_equals_none():
    """One make_train_step step under each policy from the same weights:
    the same parameters and generator state."""
    out = {}
    for remat in ("none", "dots", "full"):
        model, batch, labels = remat_inputs()
        state = init_train_state(model, load_config("train", REMAT))
        gen = torch.Generator().manual_seed(5)
        make_train_step(RVESDE(0.01, 5, 1000), remat=remat)(state, batch, labels, gen)
        out[remat] = ([p.detach().clone() for p in state.params], gen.get_state())
    for remat in ("dots", "full"):
        assert all(torch.equal(a, b) for a, b in zip(out[remat][0], out["none"][0]))
        assert torch.equal(out[remat][1], out["none"][1])


def test_dots_policy_saves_products_and_convolutions_only():
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default, aten.bmm.default,
               aten.convolution.default):
        assert _save_dots(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.add.Tensor, aten.native_group_norm.default, aten.silu.default,
               aten.rand.default):
        assert _save_dots(None, op) == CheckpointPolicy.PREFER_RECOMPUTE
    with pytest.raises(ValueError, match="remat policy"):
        get_loss_fn(RVESDE(0.01, 5, 1000), train=True, remat="offload")


@pytest.mark.parametrize("optimizer", ["Adam", "AdamW"])
def test_weight_decay_matches_optax(optimizer):
    """Three updates at weight_decay 0.01 (warmup and clipping on) through
    the port's optimizer and the JAX package's optax chain, on the same
    gradients: parameters and moments within 1e-6."""
    over = [f"optim.optimizer={optimizer}", "optim.weight_decay=0.01", "optim.warmup=2",
            "optim.lr=0.01", "optim.grad_clip=1.0"]
    tx = jax_get_optimizer(jax_load_config("train", over))
    rng = np.random.default_rng(1)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(6,)).astype(np.float32)}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jopt = tx.init(jparams)
    named = [(k, torch.from_numpy(v.copy())) for k, v in p0.items()]
    opt = get_optimizer(load_config("train", over), named)
    assert opt.weight_decay == pytest.approx(0.01)
    for k in range(3):
        g = {n: (0.5 * rng.normal(size=v.shape)).astype(np.float32) for n, v in p0.items()}
        updates, jopt = tx.update(g, jopt, jparams)
        jparams = {n: jparams[n] + updates[n] for n in jparams}
        grads = [torch.from_numpy(g[n]) for n in p0]
        _, norm = opt.check(torch.tensor(1.0), grads)
        opt.apply(grads, norm)
        for i, n in enumerate(p0):
            np.testing.assert_allclose(opt.params[i].numpy(), np.asarray(jparams[n]),
                                       rtol=0, atol=1e-6)
        np.testing.assert_allclose(opt.mu[0].numpy(), np.asarray(
            next(st for st in jopt if hasattr(st, "mu")).mu["a"]), rtol=0, atol=1e-6)


def test_host_batches_train_on_cpu(tmp_path, monkeypatch):
    """``training.data_on_device=false``: the batches come from the host's
    epoch iterator (the log names its first batch's labels), two steps
    run, and the checkpoint restores."""
    monkeypatch.chdir(tmp_path)
    pkl = data.make_synthetic_gto_pkl(str(tmp_path / "train.pkl"), n=40)
    args = ["+device=cpu", "model.nf=16", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
            "data.gto_mean=0", "data.gto_std=1", "training.batch_size=8",
            "eval.batch_size=8", "training.log_freq=1", "training.eval_freq=1",
            "training.snapshot_freq=1", "training.snapshot_freq_for_preemption=5",
            "sde.num_scales=4", "training.n_iters=1", "training.data_on_device=false",
            f"data.pkl_path={pkl}"]
    run = tmp_path / run_train.main(args)
    steps, losses, esteps, elosses = parse_log_file(str(run / "logs"))
    assert steps == [0, 1] and esteps == [0, 1]
    assert np.all(np.isfinite(losses)) and np.all(np.isfinite(elosses))
    cfg = load_config("train", args)
    first = next(data.get_dataset(cfg)[0])[1][:10].ravel()
    with open(run / "logs") as f:
        log = f.read()
    assert f"First batch class labels: {first}" in log
    assert "on-device sampling" not in log
    ck = checkpoints.restore_checkpoint(str(run / "checkpoints" / "checkpoint_1.pth"))
    assert ck.step == 2 and ck.optimizer["count"] == 2
