"""The port's ``Trainer1D``, its checkpoints and the two 1-D CLIs against the
JAX package: one update (clip, Adam, two accumulated microbatches, the EMA)
against the optax chain of ``rdm_tpu.diffusion1d.trainer1d`` from the same
parameters and gradients; the 90/10 split and the batch rows of the JAX
trainer's loop; ``model-epoch-N.pt`` both ways (a JAX-saved file restores in
the port with its weights, EMA, Adam count and moments and step; a
port-saved file samples through the JAX ``sample_1d.main`` and loads
through the JAX ``Trainer1D.load``); and both port CLIs on ``--device cpu``.

Tolerances: parameters and moments after an update within 2e-6 relative,
or 1e-6 of the array's largest magnitude where an update nearly cancels
(float32; the bias corrections are powers computed by XLA and by numpy);
the EMA and every checkpointed array bit for bit."""
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sample_1d as jax_sample_1d
from rdm_tpu.diffusion1d import GaussianDiffusion1D as JDiffusion
from rdm_tpu.diffusion1d.trainer1d import Trainer1D as JTrainer1D
from rdm_tpu.models.unet1d import UNet1D as JUNet1D
from rdm_tpu_torch import sample_1d, train_1d
from rdm_tpu_torch.diffusion1d import GaussianDiffusion1D
from rdm_tpu_torch.diffusion1d.trainer1d import Trainer1D
from rdm_tpu_torch.models import convert
from rdm_tpu_torch.models.unet1d import UNet1D
from rdm_tpu_torch.training.checkpoints import restore_unet1d_checkpoint

torch.set_num_threads(1)  # the suite runs in parallel worker processes

L = 66
TINY = dict(dim=8, channels=1, dim_mults=(1, 2), embed_class_layers_dims=(8, 8), class_dim=1,
            cond_drop_prob=0.1, mask_val=-1.0, seq_length=L, legacy=True)
TINY_FLAGS = ["--unet_dim", "8", "--unet_dim_mults", "1,2", "--embed_class_layers_dims", "8,8",
              "--timesteps", "4", "--seq_length", str(L)]


def random_tree(seed, base=0.0):
    shapes = jax.eval_shape(JUNet1D(**TINY).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, L, 1)), jnp.zeros((2,)), jnp.zeros((2, 1)))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (base + 0.3 * rng.standard_normal(s.shape)).astype(np.float32),
                        shapes)


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


def port_trainer(tmp_path, n=40, device="cpu", **kw):
    rng = np.random.default_rng(0)
    data = rng.uniform(0, 1, (n, 1, L)).astype(np.float32)
    labels = rng.uniform(0, 1, (n, 1)).astype(np.float32)

    class DS:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return data[i], labels[i]

    diffusion = GaussianDiffusion1D(UNet1D(**TINY), seq_length=L, timesteps=4)
    return Trainer1D(diffusion, DS(), train_batch_size=8, results_folder=str(tmp_path),
                     device=device, **kw), DS()


def sd_list(trainer, tree):
    sd = convert.unet1d_state_dict_from_jax(tree, True)
    return [sd[n] for n, _ in trainer.model.named_parameters()]


def jax_chain():
    """The chain of ``rdm_tpu.diffusion1d.trainer1d.Trainer1D`` at its
    defaults (train_lr 1e-4, betas (0.9, 0.99), max_grad_norm 1)."""
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4, b1=0.9, b2=0.99))


def test_update_and_ema_match_the_optax_chain(tmp_path):
    trainer, _ = port_trainer(tmp_path)
    params = random_tree(1)
    with torch.no_grad():
        for p, v in zip(trainer.params, sd_list(trainer, params)):
            p.copy_(v)
    tx = jax_chain()
    state = jax.jit(tx.init)(params)

    @jax.jit
    def jax_update(params, state, g1, g2):
        acc = jax.tree.map(jnp.zeros_like, params)
        for g in (g1, g2):
            acc = jax.tree.map(lambda a, g: a + g / 2, acc, g)
        updates, state = tx.update(acc, state, params)
        return optax.apply_updates(params, updates), state

    # the first two updates clip (norms about 30), the third does not
    for step, scale in enumerate((1.0, 1.0, 1e-3)):
        g1, g2 = (jax.tree.map(lambda v: v * scale, random_tree(10 * step + k)) for k in (2, 3))
        params, state = jax_update(params, state, g1, g2)
        loss = trainer.apply_gradients([sd_list(trainer, g1), sd_list(trainer, g2)],
                                       [torch.tensor(1.0), torch.tensor(2.0)])
        assert loss == 1.5
    ours = convert.unet1d_tree_from_state_dict(trainer.model.state_dict(), True)
    adam = state[1][0]
    opt = trainer.optimizer.state_dict()
    assert opt["count"] == int(adam.count) == 3
    for mine, theirs in ((ours, params), (convert.unet1d_tree_from_state_dict(opt["mu"], True),
                                          adam.mu),
                         (convert.unet1d_tree_from_state_dict(opt["nu"], True), adam.nu)):
        fa, fb = flat(mine), flat(theirs)
        for k in fb:
            np.testing.assert_allclose(fa[k], fb[k], rtol=2e-6,
                                       atol=1e-6 * float(np.abs(fb[k]).max()), err_msg=k)

    # the EMA: 100 updates of burn-in (beta 0), then the warmup
    jt = JTrainer1D.__new__(JTrainer1D)
    jt.ema_decay = trainer.ema_decay
    ema = random_tree(4)
    with torch.no_grad():
        for e, v in zip(trainer.ema_params, sd_list(trainer, ema)):
            e.copy_(v)
    live = convert.unet1d_tree_from_state_dict(trainer.model.state_dict(), True)
    for step in (990, 1010, 5000):
        trainer.step = step
        beta = jt._ema_beta(step // 10)
        assert trainer._ema_beta(step // 10) == beta
        ema = jax.jit(lambda e, p: jax.tree.map(lambda e, p: e * beta + p * (1 - beta), e, p))(
            ema, live)
        trainer.update_ema()
    assert_trees_equal(convert.unet1d_tree_from_state_dict(trainer._named(trainer.ema_params),
                                                           True), ema)


class _MockFlax:
    """A stand-in for the U-Net in the JAX trainer's loop (no network)."""
    channels = 1

    def init(self, rngs, *args):
        return {"params": {"w": jnp.zeros(3)}}


def test_split_and_batch_rows_equal_the_jax_trainers(tmp_path, monkeypatch):
    trainer, ds = port_trainer(tmp_path / "port", n=40, train_num_steps=12)
    jt = JTrainer1D(JDiffusion(_MockFlax(), seq_length=L, timesteps=4), ds, train_batch_size=8,
                    results_folder=str(tmp_path / "jax"), train_num_steps=12)
    assert np.array_equal(trainer.train_data, jt.train_data.transpose(0, 2, 1))
    assert np.array_equal(trainer.val_data, jt.val_data.transpose(0, 2, 1))
    assert np.array_equal(trainer.train_labels, jt.train_labels)
    assert trainer.batches_per_epoch == jt.batches_per_epoch == 5

    jax_rows, port_rows = [], []

    def jax_update(params, opt_state, seqs, classes, key):
        jax_rows.append(np.asarray(seqs).transpose(0, 1, 3, 2))
        return params, opt_state, 0.0

    def port_update(seqs, classes):
        port_rows.append(torch.stack(seqs).numpy())
        return 0.0

    jt._update, jt._val_loss = jax_update, lambda *a: 0.0
    jt.save = lambda milestone: None
    monkeypatch.setattr(trainer, "update", port_update)
    monkeypatch.setattr(trainer, "compute_validation_loss", lambda: 0.0)
    monkeypatch.setattr(trainer, "save", lambda milestone: None)
    jt.train()
    trainer.train()
    assert len(port_rows) == len(jax_rows) == 12
    assert all(np.array_equal(a, b) for a, b in zip(port_rows, jax_rows))


def jax_trainer_shell(folder, params):
    """A JAX ``Trainer1D`` whose state is set by hand (its own ``save`` and
    ``load`` run; no network is initialised)."""
    jt = JTrainer1D.__new__(JTrainer1D)
    jt.results_folder = folder
    jt.tx = jax_chain()
    jt.params = params
    jt.opt_state = jax.jit(jt.tx.init)(params)
    jt.ema_params = params
    jt.step = 0
    return jt


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    params, ema = random_tree(5), random_tree(6)
    jt = jax_trainer_shell(tmp_path, params)
    _, jt.opt_state = jax.jit(jt.tx.update)(random_tree(7), jt.opt_state, params)
    jt.ema_params, jt.step = ema, 7
    jt.save("epoch-2")

    trainer, _ = port_trainer(tmp_path)
    trainer.load("epoch-2")
    assert trainer.step == 7
    assert_trees_equal(convert.unet1d_tree_from_state_dict(trainer.model.state_dict(), True),
                       params)
    assert_trees_equal(convert.unet1d_tree_from_state_dict(trainer._named(trainer.ema_params),
                                                           True), ema)
    opt = trainer.optimizer.state_dict()
    adam = jt.opt_state[1][0]
    assert opt["count"] == int(adam.count) == 1
    assert_trees_equal(convert.unet1d_tree_from_state_dict(opt["mu"], True), adam.mu)
    assert_trees_equal(convert.unet1d_tree_from_state_dict(opt["nu"], True), adam.nu)
    # and training goes on from there
    loss = trainer.update([torch.from_numpy(trainer.train_data[:8])],
                          [torch.from_numpy(trainer.train_labels[:8])])
    assert np.isfinite(loss) and trainer.optimizer.count == 2


def test_port_checkpoint_samples_and_loads_in_the_jax_package(tmp_path):
    data = np.random.default_rng(0).uniform(0, 1, (48, 67)).astype(np.float32)
    pkl = tmp_path / "d.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(data, f)
    out = tmp_path / "res"
    trainer = train_1d.main(["--data_path", str(pkl), *TINY_FLAGS, "--batch_size", "8",
                             "--max_epoch", "2", "--training_data_num", "48",
                             "--result_folder", str(out), "--device", "cpu"])
    run = out / "unet_8_mults_1_2_embed_class_8_8_timesteps_4_objective_pred_noise_batch_size_8"
    assert str(trainer.results_folder) == str(run)
    metrics = [json.loads(line) for line in open(run / "metrics.jsonl")]
    losses = [m["train_loss"] for m in metrics if "train_loss" in m]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert sum("val_loss" in m for m in metrics) == 2
    ckpt = sorted(run.glob("model-epoch-*.pt"))[-1]
    milestone = ckpt.stem[len("model-"):]

    # the JAX package's sampler takes the port's file; both CLIs condition
    # on the same energies for one seed and keep the physical ranges
    sample_flags = ["--checkpoint", str(ckpt), "--sample_num", "6", "--batch_size", "6",
                    *TINY_FLAGS]
    theirs = tmp_path / "jax.pkl"
    jax_sample_1d.main(sample_flags + ["--output", str(theirs)])
    with open(theirs, "rb") as f:
        jax_full = pickle.load(f)
    ours = sample_1d.main(sample_flags + ["--output", str(tmp_path / "port.pkl"),
                                          "--device", "cpu"])
    for full in (jax_full, ours):
        assert full.shape == (6, 67) and np.isfinite(full).all()
        assert (full[:, 0] >= 0.008).all() and (full[:, 0] <= 0.095).all()
        assert (full[:, 1] >= 0).all() and (full[:, 1] <= 40).all()
        ctrl = full[:, 4:64].reshape(-1, 20, 3)
        assert (ctrl[:, :, 2] >= 0).all() and (ctrl[:, :, 2] <= 1.0).all()
        assert (full[:, 64] >= 408).all() and (full[:, 64] <= 470).all()
    assert np.array_equal(ours[:, 0], jax_full[:, 0])

    # the JAX trainer resumes from it: weights, EMA, Adam state, step
    ck = restore_unet1d_checkpoint(str(ckpt))
    jt = jax_trainer_shell(run, random_tree(9))
    jt.load(milestone)
    assert jt.step == ck.step and ck.step in (6, 12)
    assert_trees_equal(jt.params, convert.unet1d_tree_from_state_dict(ck.model, True))
    assert_trees_equal(jt.ema_params, convert.unet1d_tree_from_state_dict(ck.ema, True))
    adam = jt.opt_state[1][0]
    assert int(adam.count) == ck.optimizer["count"] == ck.step
    assert_trees_equal(adam.mu, convert.unet1d_tree_from_state_dict(ck.optimizer["mu"], True))
    # the port resumes from its own file
    again, _ = port_trainer(tmp_path / "again")
    again.results_folder = run
    again.load(milestone)
    assert again.step == ck.step and again.optimizer.count == ck.step
    assert all(torch.equal(e, ck.ema[n])
               for (n, _), e in zip(again.model.named_parameters(), again.ema_params))


def test_entry_points_need_a_card_or_an_explicit_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_trainer(tmp_path, device=None)
