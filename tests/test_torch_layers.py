"""The port's NCSN++ blocks against the JAX package's, one block at a time,
on the same inputs and carried weights, in float32 and in bfloat16.

A whole bfloat16 network cannot be held tight to the JAX one: a sum that
lands next to a rounding boundary rounds the other way on one side, and the
later layers carry that step on.  One block on the same inputs can: both
sides round at the same points, so they differ by a unit in the last place
here and there.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import NCSNpp as JNCSNpp
from rdm_tpu.models import layers as jlayers
from rdm_tpu_torch.models import NCSNpp, layers
from rdm_tpu_torch.models.convert import _conv, _linear, _resblock, state_dict_from_jax

torch.set_num_threads(1)  # the suite runs in parallel worker processes

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tolerance(dtype_name, scale):
    # float32: summation order only.  bfloat16: a value rounded the other way
    # is one unit in the last place, up to 2^-7 of the output's largest
    # magnitude; allow two such units for a block's internal roundings.
    return (1e-5 if dtype_name == "float32" else 2 * 2.0 ** -7) * scale


def random_params(module, seed, *args):
    shapes = jax.eval_shape(module.init, {"params": jax.random.PRNGKey(0)}, *args)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32),
                        shapes["params"])


def carried(convert, params):
    sd = {}
    convert(params, "m", sd)
    return {k[2:]: v for k, v in sd.items()}


def inputs(rng, shape, jdt, tdt):
    """One array in the compute type, the same values on both sides."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(tdt)
    return jnp.asarray(x.float().numpy()).astype(jdt), x


def nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("in_ch,out_ch", [(16, 32), (32, 32)])
def test_resblock_matches_jax(dtype_name, in_ch, out_ch):
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(in_ch + out_ch)
    jx, x = inputs(rng, (3, in_ch, 9, 9), jdt, tdt)
    jtemb, temb = inputs(rng, (3, 64), jdt, tdt)
    jx = jx.transpose(0, 2, 3, 1)
    jblock = jlayers.ResnetBlockDDPMpp(act=jax.nn.swish, out_ch=out_ch, dropout=0.0,
                                       skip_rescale=True, dtype=jdt)
    params = random_params(jblock, 1, jx, jtemb)
    block = layers.ResnetBlockDDPMpp(torch.nn.functional.silu, in_ch, out_ch, temb_dim=64,
                                     dropout=0.0, skip_rescale=True, dtype=tdt)
    block.load_state_dict(carried(_resblock, params), strict=True)
    assert hasattr(block, "NIN_0") == (in_ch != out_ch)
    theirs = np.asarray(jblock.apply({"params": params}, jx, jtemb), np.float32)
    with torch.no_grad():
        out = block(x, temb)
    assert out.dtype == tdt
    err = np.abs(nhwc(out) - theirs).max()
    assert err <= tolerance(dtype_name, np.abs(theirs).max()), err


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("kind,size", [("down", 9), ("down", 4), ("up", 4)])
def test_resample_matches_jax(dtype_name, kind, size):
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(size)
    jx, x = inputs(rng, (2, 32, size, size), jdt, tdt)
    jx = jx.transpose(0, 2, 3, 1)
    jcls, cls = ((jlayers.Downsample, layers.Downsample) if kind == "down"
                 else (jlayers.Upsample, layers.Upsample))
    jmod = jcls(with_conv=True, dtype=jdt)
    params = random_params(jmod, 2, jx)
    mod = cls(32, with_conv=True, dtype=tdt)
    mod.load_state_dict(carried(lambda p, name, sd: _conv(p["conv"]["conv"], name + ".Conv_0", sd),
                                params), strict=True)
    theirs = np.asarray(jmod.apply({"params": params}, jx), np.float32)
    with torch.no_grad():
        out = mod(x)
    ours = nhwc(out)
    assert out.dtype == tdt and ours.shape == theirs.shape
    err = np.abs(ours - theirs).max()
    assert err <= tolerance(dtype_name, np.abs(theirs).max()), err
    if dtype_name == "bfloat16":
        # One float32 sum per output, rounded once, then the bias added in
        # bfloat16: nearly every value has the same bits on both sides.
        # Adding the bias before the rounding changes about a quarter.
        assert np.mean(ours != theirs) <= 0.02, np.mean(ours != theirs)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_dense_matches_jax(dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(5)
    jx, x = inputs(rng, (64, 128), jdt, tdt)
    jmod = flax.linen.Dense(256, dtype=jdt)
    params = random_params(jmod, 5, jx)
    mod = layers.Dense(128, 256, dtype=tdt)
    mod.load_state_dict(carried(_linear, params), strict=True)
    theirs = np.asarray(jmod.apply({"params": params}, jx), np.float32)
    with torch.no_grad():
        ours = mod(x)
    assert ours.dtype == tdt
    ours = ours.float().numpy()
    err = np.abs(ours - theirs).max()
    assert err <= tolerance(dtype_name, np.abs(theirs).max()), err
    if dtype_name == "bfloat16":
        # as for the convolutions in test_resample_matches_jax
        assert np.mean(ours != theirs) <= 0.02, np.mean(ours != theirs)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_time_and_label_embedding_matches_jax(dtype_name):
    """Fourier features of log(sigma) in float32, the two-layer time MLP
    and the label embedding in the compute type, as the network sums them."""
    jdt, tdt = DTYPES[dtype_name]
    small = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(9,), dropout=0.0)
    jmodel = JNCSNpp(**small, dtype=jdt)
    x = np.zeros((4, 9, 9, 1), np.float32)
    sigma = np.array([0.01, 0.1, 1.0, 5.0], np.float32)
    labels = np.random.default_rng(3).uniform(size=(4, 1)).astype(np.float32)
    params = random_params(jmodel, 3, x, sigma, labels)
    _, state = jax.jit(lambda p, *args: jmodel.apply(
        p, *args, capture_intermediates=True, mutable=["intermediates"]))(
        {"params": params}, x, sigma, labels)
    inter = state["intermediates"]
    theirs = np.asarray(inter["time_mlp1"]["__call__"][0] + inter["label_emb"]["__call__"][0],
                        np.float32)

    port = NCSNpp(**small, dtype=tdt)
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    seen = {}
    port.time_mlp[2].register_forward_hook(lambda m, i, o: seen.__setitem__("mlp", o))
    port.label_emb.register_forward_hook(lambda m, i, o: seen.__setitem__("label", o))
    with torch.no_grad():
        port(torch.zeros(4, 1, 9, 9), torch.from_numpy(sigma), torch.from_numpy(labels))
    ours = seen["mlp"] + seen["label"]
    assert ours.dtype == tdt
    err = np.abs(ours.float().numpy() - theirs).max()
    assert err <= tolerance(dtype_name, np.abs(theirs).max()), err
