"""With ``model.resblock_pallas`` on, NCSN++ asks once per resblock, when it
builds the block, whether a CUDA kernel takes the block's shape
(``ops.resblock.route``): the flagship's 17 blocks take the tensor-core
body, every block at nf 32 (and of DDPM++) the tiled body, and a shape no
body takes would run the fused block's plain version on any device.

CPU: the routing decision, which function each block's forward reaches, and
an nf-32 NCSN++ against the JAX package with ``resblock_pallas`` on (its
Pallas resblock in interpret mode).  Card (marker ``gpu``): one nf-32
forward launches the resblock kernel once for each of its 17 blocks, all
through the tiled body.
"""
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu_torch.config import load_config
from rdm_tpu_torch.models import NCSNpp, create_model
from rdm_tpu_torch.models.convert import state_dict_from_jax
from rdm_tpu_torch.models.layers import ResnetBlockDDPMpp
from rdm_tpu_torch.ops import resblock as rb_ops

torch.set_num_threads(1)  # the suite runs in parallel worker processes

NF32 = ["model.nf=32", "model.precision=bfloat16", "model.resblock_pallas=true"]
INPUTS = dict(x=np.random.default_rng(7).uniform(size=(4, 9, 9, 1)).astype(np.float32),
              sigma=np.array([0.01, 0.1, 1.0, 5.0], np.float32),
              labels=np.random.default_rng(8).uniform(size=(4, 1)).astype(np.float32))


def resblocks(model):
    return [m for m in model.modules() if isinstance(m, ResnetBlockDDPMpp)]


def port_forward(model, device="cpu"):
    x, sigma, labels = INPUTS.values()
    with torch.no_grad():
        out = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(device),
                    torch.from_numpy(sigma).to(device), torch.from_numpy(labels).to(device))
    return out.float().cpu().numpy().transpose(0, 2, 3, 1)


def test_nf32_routes_every_resblock_to_the_plain_fused_block(caplog, monkeypatch):
    """Every nf-32 resblock is routed to the kernel wrapper (the tiled body
    takes its shapes), with no routing log line; on the CPU the wrapper runs
    the fused block's plain version, once a block.  The routing reads the
    wrappers when the model is built, so they are replaced first."""
    calls, plain = [], []
    wrapper, ref = rb_ops.fused_resblock, rb_ops.fused_resblock_reference
    monkeypatch.setattr(rb_ops, "fused_resblock",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    monkeypatch.setattr(rb_ops, "fused_resblock_reference",
                        lambda *a, **k: plain.append(1) or ref(*a, **k))
    with caplog.at_level(logging.WARNING, logger="rdm_tpu_torch.models.ncsnpp"):
        model = create_model(load_config("train", NF32))
    blocks = resblocks(model)
    assert len(blocks) == 17
    assert all(b.use_kernel and b.fused_forward is rb_ops.fused_resblock for b in blocks)
    assert not [r for r in caplog.records if "takes this shape" in r.getMessage()]
    model.init_weights(torch.Generator().manual_seed(0)).eval()
    out = port_forward(model)
    assert len(calls) == 17 and len(plain) == 17
    assert out.shape == (4, 9, 9, 1) and np.isfinite(out).all()


def test_flagship_keeps_all_17_resblocks_on_the_kernel(caplog, monkeypatch):
    calls = []
    wrapper = rb_ops.fused_resblock
    monkeypatch.setattr(rb_ops, "fused_resblock", lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    with caplog.at_level(logging.WARNING, logger="rdm_tpu_torch.models.ncsnpp"):
        model = NCSNpp(resblock_kernel=True, dtype=torch.bfloat16)
    assert not caplog.records
    assert all(b.use_kernel and b.fused_forward is rb_ops.fused_resblock
               for b in resblocks(model))
    model.init_weights(torch.Generator().manual_seed(0)).eval()
    port_forward(model)
    assert len(calls) == 17                     # the wrapper: the kernel on a CUDA tensor


def random_params(shapes, seed=0):
    """Seeded weights for the JAX parameter tree: matrices and convolution
    kernels N(0, 1 / fan-in), GroupNorm scales 1 + N(0, 0.01), every other
    vector N(0, 0.01)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        if len(s.shape) >= 2:
            a = rng.normal(size=s.shape) / math.sqrt(math.prod(s.shape[:-1]))
        else:
            a = 0.1 * rng.normal(size=s.shape)
            if jax.tree_util.keystr(path).endswith("['scale']"):
                a = a + 1.0
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def per_sample_max(a):
    return np.abs(a).reshape(a.shape[0], -1).max(1)


def test_nf32_matches_jax_resblock_pallas_bf16():
    """The nf-32 NCSN++ with ``resblock_pallas`` on, bfloat16 compute,
    float32 parameters, on the same numpy inputs and weights: the JAX
    package through its Pallas resblock (interpret mode on the CPU), the
    port through the fused block's plain version.  The tolerance is that of
    ``tests/test_torch_ncsnpp.py::test_flagship_outputs_match_jax_bf16``
    (the existing whole-network resblock parity test): per sample, the port
    stays within 2x of how far bfloat16 moves the JAX output from its
    float32 output, and is no closer to float32 than 1/20 of that."""
    from rdm_tpu.models import NCSNpp as JNCSNpp   # here: the card's machine lacks flax

    cfg = load_config("train", NF32)
    jmodel = JNCSNpp.from_config(cfg)
    assert jmodel.resblock_pallas and jmodel.dtype == jnp.bfloat16
    shapes = jax.eval_shape(jmodel.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 9, 9, 1)), jnp.full((2,), 0.5),
                            jnp.zeros((2, 1)))["params"]
    params = random_params(shapes)
    port = create_model(cfg)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    ours = port_forward(port.eval())
    theirs = np.asarray(jax.jit(jmodel.apply)({"params": params}, *INPUTS.values()), np.float32)
    cfg.model.precision = "float32"
    exact = np.asarray(jax.jit(JNCSNpp.from_config(cfg).apply)({"params": params},
                                                               *INPUTS.values()), np.float32)
    spread = per_sample_max(theirs - exact)
    assert np.all(spread > 0)
    assert np.all(per_sample_max(ours - theirs) <= 2 * spread), (
        per_sample_max(ours - theirs) / spread)
    assert np.all(per_sample_max(ours - exact) >= spread / 20), (
        per_sample_max(ours - exact) / spread)


@pytest.mark.gpu
def test_nf32_forward_on_the_card_launches_the_resblock_kernel_for_every_block():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = create_model(load_config("train", NF32)).init_weights(
        torch.Generator().manual_seed(0)).to("cuda").eval()
    rb_ops.fused_resblock.launches = 0
    rb_ops.fused_resblock_tiled.launches = 0
    out = port_forward(model, "cuda")
    assert rb_ops.fused_resblock.launches == 17 and rb_ops.fused_resblock_tiled.launches == 17
    assert out.shape == (4, 9, 9, 1) and np.isfinite(out).all()
