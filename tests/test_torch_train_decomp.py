"""The training step's decomposition (twin of
scripts/profile_train_decomp.py) against the JAX package on the CPU at a
small config: the target and the guarded update of its components, the
byte counter and the flop count of the forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from rdm_tpu.config import load_config as jax_load_config
from rdm_tpu.models import NCSNpp as JNCSNpp
from rdm_tpu.models import ema as jax_ema
from rdm_tpu.ops import cube as jcube
from rdm_tpu.sde import get_sde as jax_get_sde
from rdm_tpu.training import get_optimizer as jax_get_optimizer
from rdm_tpu.training.losses import _guarded_update as jax_guarded_update
from rdm_tpu.training.state import TrainState as JTrainState
from rdm_tpu_torch.benchmark import costs
from rdm_tpu_torch.benchmark import profile_train_decomp as decomp
from rdm_tpu_torch.models.convert import state_dict_from_jax
from rdm_tpu_torch.models.layers import NIN, AttnBlockpp
from rdm_tpu_torch.ops import attention as attn_ops
from rdm_tpu_torch.training.state import init_train_state, trainable_parameters

torch.set_num_threads(1)  # the suite runs in parallel worker processes

SMALL = ["model.nf=16", "model.ch_mult=[1,2]", "model.num_res_blocks=1",
         "model.attn_resolutions=[9]", "optim.warmup=2", "optim.lr=0.001"]
B = 4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def test_target_matches_score_hk():
    """t, z, marginal_prob, reflect and score_hk on the same x, t and z."""
    s = decomp.Setup(B, "cpu", SMALL)
    jsde = jax_get_sde(jax_load_config("train", SMALL))
    rng = np.random.default_rng(3)
    x = rng.uniform(0.05, 0.95, (B, 9, 9, 1)).astype(np.float32)
    t = rng.uniform(1e-5, 1.0, B).astype(np.float32)
    z = rng.standard_normal((B, 9, 9, 1)).astype(np.float32)
    mean, std = jsde.marginal_prob(jnp.asarray(x), jnp.asarray(t))
    perturbed = jcube.reflect(mean + std[:, None, None, None] * jnp.asarray(z))
    want = np.asarray(jcube.score_hk(perturbed, mean, std)).transpose(0, 3, 1, 2)
    got = decomp.target(s.sde, nchw(x), torch.from_numpy(t), nchw(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_opt_component_matches_guarded_update():
    """Two iterations of ``opt`` (frozen gradients of 1e-4) against the JAX
    package's _guarded_update on the same parameters: the first at learning
    rate 0 (warmup 2), the second at half of it."""
    jcfg = jax_load_config("train", SMALL)
    jmodel = JNCSNpp.from_config(jcfg)
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 9, 9, 1)), jnp.full((2,), 0.5), jnp.zeros((2, 1)))
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32),
                          shapes["params"])
    s = decomp.Setup(B, "cpu", SMALL)
    s.model.load_state_dict(state_dict_from_jax(params), strict=True)
    s.state = init_train_state(s.model, s.cfg)
    opt = decomp.components(s)["opt"]

    tx = jax_get_optimizer(jcfg)
    jstate = JTrainState(step=jnp.int32(0), params=params, opt_state=tx.init(params),
                         ema=jax_ema.init(params, jcfg.model.ema_rate))
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * decomp.FROZEN_GRAD, params)
    update = jax.jit(lambda st: jax_guarded_update(st, jnp.float32(1.0), grads, tx))
    for _ in range(decomp.K1):
        opt()
        jstate = update(jstate)
    assert s.state.step == int(jstate.step) == decomp.K1
    want = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    moved = 0
    for name, p in trainable_parameters(s.model):
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
        moved += int(not np.array_equal(p.detach().numpy(),
                                        state_dict_from_jax(params)[name].numpy()))
    assert moved > 0


def test_byte_counter_sums_inputs_and_outputs():
    a = torch.rand(100)
    with costs.ByteCounter() as counter:
        b = a * 2.0                  # reads 400 bytes, writes 400
        c = b + a                    # reads 800, writes 400
        torch.exp(c)                 # reads 400, writes 400
        a.view(10, 10)               # a view moves nothing
    assert counter.bytes == 800 + 1200 + 800 and counter.ops == 3


def _conv_dense_flops(model, x, time_cond, labels):
    """Twice the multiply-adds of every convolution and dense layer (the
    1x1 NINs included), from their shapes (hooks on the modules); each
    attention block's four NINs and two products by its input's shape."""
    total = []
    in_attn = {id(n) for m in model.modules() if isinstance(m, AttnBlockpp)
               for n in m.modules() if isinstance(n, NIN)}

    def conv(m, inp, out):
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        total.append(2 * out.numel() * k)

    def dense(m, inp, out):
        total.append(2 * out.numel() * m.in_features)

    def nin(m, inp, out):
        total.append(2 * out.numel() * m.W.shape[0])

    def attn(m, inp, out):
        Bx, C, H, W = inp[0].shape
        L = H * W
        total.append(2 * Bx * (4 * L * C * C + 2 * L * L * C))

    hooks = []
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, nn.Linear):
            hooks.append(m.register_forward_hook(dense))
        elif isinstance(m, NIN) and id(m) not in in_attn:
            hooks.append(m.register_forward_hook(nin))
        elif isinstance(m, AttnBlockpp):
            hooks.append(m.register_forward_hook(attn))
    with torch.no_grad():
        model(x, time_cond, labels, train=False)
    for h in hooks:
        h.remove()
    return sum(total)


@pytest.mark.parametrize("nf", [16, 64])
def test_fwd_flops_are_the_products_of_the_layers(nf):
    """At nf 16 the attention block runs its plain version (counted by the
    flop counter); at nf 64 it takes the kernel's wrapper (the CPU runs the
    plain version inside, unseen, and the formula counts it)."""
    s = decomp.Setup(B, "cpu", [f"model.nf={nf}", *SMALL[1:]])
    c = costs.count_costs(decomp.components(s)["fwd"])
    _, time_cond = s.sde.marginal_prob(torch.zeros_like(s.x), torch.full((B,), decomp.T_FWD))
    want = _conv_dense_flops(s.model, s.x, time_cond, s.labels)
    assert c["flops"] == want
    n_attn = sum(isinstance(m, AttnBlockpp) for m in s.model.modules())
    assert c["modeled"].get("fused_attn_block", 0) == (n_attn if nf == 64 else 0)
    assert c["bytes"] > 0 and c["counted"]["aten_ops"] > 0


def _count_full_step(device):
    """count_costs of one full step at nf 64 (the attention wrappers' path):
    the wrappers' launches during it and what it modeled."""
    s = decomp.Setup(B, device, ["model.nf=64", *SMALL[1:]])
    full = decomp.components(s)["full"]
    wrappers = (attn_ops.fused_attn_block, attn_ops.fused_attn_block_bwd)
    saved = attn_ops.FusedAttnBlockFn.__dict__["forward"]
    before = [w.launches for w in wrappers]
    c = costs.count_costs(full)
    if device == "cuda":
        torch.cuda.synchronize()
    assert (attn_ops.fused_attn_block, attn_ops.fused_attn_block_bwd) == wrappers
    assert attn_ops.FusedAttnBlockFn.__dict__["forward"] is saved
    n_attn = sum(isinstance(m, AttnBlockpp) for m in s.model.modules())
    return ([w.launches - b for w, b in zip(wrappers, before)],
            [c["modeled"].get(w.__name__) for w in wrappers], n_attn)


def test_count_costs_leaves_the_wrappers_and_their_counts():
    """On the CPU the wrappers run their plain versions and launch nothing:
    a count models every call and leaves the counts as they were."""
    launched, modeled, n_attn = _count_full_step("cpu")
    assert launched == [0, 0] and modeled == [n_attn, n_attn] and n_attn > 0


@pytest.mark.gpu
def test_count_costs_adds_the_launches_it_models_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    launched, modeled, n_attn = _count_full_step("cuda")
    assert launched == modeled == [n_attn, n_attn]


def test_main_runs_every_component_on_the_cpu(capsys):
    r = decomp.main(["--device", "cpu", "--batch", "2", "--batches", "2",
                     "--skip_rbg", *sum((["--override", o] for o in SMALL[:3]), [])])
    assert list(r["components"]) == list(decomp.COMPONENTS)
    for m in r["components"].values():
        assert np.isfinite(m["ms"]) and m["gb"] > 0
    assert r["components"]["full"]["gflop"] > r["components"]["fwd"]["gflop"] > 0
    assert r["scaling"][0]["batch"] == 2
    assert "none to compare" in capsys.readouterr().out
