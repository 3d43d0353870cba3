"""The port's FIR resampling (``ops/fir.py``), the layer zoo's ``FIRConv2d``,
``ResnetBlockBigGANpp`` and ``Combine``, and the normalization zoo, each
against the JAX package on the same inputs and carried weights.

Tolerances: float32 agrees to 1e-5 of the output's largest magnitude
(summation order only); a bfloat16 block to two units in the last place of
that magnitude (2 * 2^-7), as in ``tests/test_torch_layers.py``.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import layers as jlayers
from rdm_tpu.models import normalization as jnorm
from rdm_tpu.ops import fir as jfir
from rdm_tpu_torch.models import layers, normalization
from rdm_tpu_torch.ops import fir

torch.set_num_threads(1)  # the suite runs in parallel worker processes

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tolerance(dtype_name, scale):
    return (1e-5 if dtype_name == "float32" else 2 * 2.0 ** -7) * scale


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def close(ours, theirs, dtype_name="float32"):
    theirs = np.asarray(theirs, np.float32)
    err = float(np.abs(ours - theirs).max())
    assert err <= tolerance(dtype_name, float(np.abs(theirs).max())), err


def random_params(module, seed, *args):
    shapes = jax.eval_shape(module.init, {"params": jax.random.PRNGKey(0)}, *args)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32),
                        shapes["params"])


def compiled(fn, *args):
    """``fn`` compiled with every bfloat16 rounding kept (XLA otherwise
    carries fused intermediates in float32, which the port does not)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


# ---------------------------------------------------------------------------
# ops/fir.py

RNG = np.random.default_rng(0)
X = RNG.normal(size=(2, 8, 8, 3)).astype(np.float32)
W = RNG.normal(size=(3, 3, 3, 5)).astype(np.float32)


@pytest.mark.parametrize("kernel", [[1, 3, 3, 1], [1, 1], [1, 2, 1]])
@pytest.mark.parametrize("op", ["upsample_2d", "downsample_2d"])
def test_fir_resample_matches_jax(op, kernel):
    close(nhwc(getattr(fir, op)(nchw(X), kernel)), getattr(jfir, op)(X, kernel))


@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 2)), (2, 1, (-1, 2, 1, -2)),
                                         (1, 2, (2, 1, 0, 3)), (3, 2, 1)])
def test_upfirdn2d_matches_jax(up, down, pad):
    k = jfir._setup_kernel([1, 3, 3, 1])
    close(nhwc(fir.upfirdn2d(nchw(X), k, up=up, down=down, pad=pad)),
          jfir.upfirdn2d(X, k, up=up, down=down, pad=pad))


def test_naive_resample_matches_jax():
    close(nhwc(fir.naive_upsample_2d(nchw(X))), jfir.naive_upsample_2d(X))
    close(nhwc(fir.naive_downsample_2d(nchw(X))), jfir.naive_downsample_2d(X))


@pytest.mark.parametrize("op", ["upsample_conv_2d", "conv_downsample_2d"])
def test_fused_conv_resample_matches_jax(op):
    """The corrected up path (the reference's raises) and the fused down path."""
    ours = getattr(fir, op)(nchw(X), oihw(W), [1, 3, 3, 1])
    theirs = getattr(jfir, op)(X, W, [1, 3, 3, 1])
    assert nhwc(ours).shape == np.asarray(theirs).shape
    close(nhwc(ours), theirs)


# ---------------------------------------------------------------------------
# layers: FIRConv2d, Combine, ResnetBlockBigGANpp

@pytest.mark.parametrize("up,down", [(False, False), (True, False), (False, True)])
def test_fir_conv2d_matches_jax(up, down):
    jm = jlayers.FIRConv2d(5, up=up, down=down)
    p = random_params(jm, 1, jnp.zeros((2, 8, 8, 3)))
    m = layers.FIRConv2d(3, 5, up=up, down=down)
    m.load_state_dict({"weight": oihw(p["weight"]), "bias": t_(p["bias"])}, strict=True)
    with torch.no_grad():
        close(nhwc(m(nchw(X))), jm.apply({"params": p}, X))


@pytest.mark.parametrize("method", ["cat", "sum"])
def test_combine_matches_jax(method):
    y = RNG.normal(size=(2, 8, 8, 5)).astype(np.float32)
    jm = jlayers.Combine(5, method=method)
    p = random_params(jm, 2, jnp.zeros((2, 8, 8, 3)), jnp.zeros((2, 8, 8, 5)))
    m = layers.Combine(3, 5, method=method)
    m.load_state_dict({"Conv_0.weight": oihw(p["conv"]["conv"]["kernel"]),
                       "Conv_0.bias": t_(p["conv"]["conv"]["bias"])}, strict=True)
    with torch.no_grad():
        close(nhwc(m(nchw(X), nchw(y))), jm.apply({"params": p}, X, y))


def biggan_state_dict(p):
    sd = {}
    for ours, theirs in (("GroupNorm_0", "norm0"), ("GroupNorm_1", "norm1")):
        sd[ours + ".weight"], sd[ours + ".bias"] = t_(p[theirs]["scale"]), t_(p[theirs]["bias"])
    for ours, theirs in (("Conv_0", "conv0"), ("Conv_1", "conv1"), ("Conv_2", "shortcut")):
        if theirs in p:
            sd[ours + ".weight"] = oihw(p[theirs]["conv"]["kernel"])
            sd[ours + ".bias"] = t_(p[theirs]["conv"]["bias"])
    sd["Dense_0.weight"] = t_(np.asarray(p["temb_proj"]["kernel"]).T)
    sd["Dense_0.bias"] = t_(p["temb_proj"]["bias"])
    return sd


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("in_ch,out_ch,up,down,use_fir", [
    (16, 32, False, False, False), (16, 16, True, False, False), (16, 32, False, True, False),
    (16, 16, True, False, True), (16, 32, False, True, True)])
def test_biggan_block_matches_jax(dtype_name, in_ch, out_ch, up, down, use_fir):
    jdt, tdt = DTYPES[dtype_name]
    jm = jlayers.ResnetBlockBigGANpp(act=jax.nn.silu, out_ch=out_ch, up=up, down=down,
                                     fir=use_fir, dtype=jdt)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, in_ch, 8, 8)).astype(np.float32)).to(tdt)
    temb = rng.normal(size=(2, 24)).astype(np.float32)
    xj = jnp.asarray(nhwc(x)).astype(jdt)
    p = random_params(jm, 4, xj, jnp.asarray(temb))
    m = layers.ResnetBlockBigGANpp(torch.nn.functional.silu, in_ch, out_ch, temb_dim=24, up=up,
                                   down=down, fir=use_fir, dtype=tdt)
    m.load_state_dict(biggan_state_dict(p), strict=True)
    theirs = compiled(lambda p, x, t: jm.apply({"params": p}, x, t), p, xj, jnp.asarray(temb))
    with torch.no_grad():
        ours = m(x, torch.from_numpy(temb))
    assert ours.dtype == tdt
    close(nhwc(ours), theirs, dtype_name)


def test_biggan_block_dropout_draws_from_the_generator():
    m = layers.ResnetBlockBigGANpp(torch.nn.functional.silu, 8, 8, temb_dim=4, dropout=0.5)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.3, generator=torch.Generator().manual_seed(0))
    x, temb = torch.randn(2, 8, 4, 4), torch.randn(2, 4)
    with torch.no_grad():
        a = m(x, temb, train=True, generator=torch.Generator().manual_seed(1))
        b = m(x, temb, train=True, generator=torch.Generator().manual_seed(1))
        c = m(x, temb, train=True, generator=torch.Generator().manual_seed(2))
        d = m(x, temb)
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


# ---------------------------------------------------------------------------
# normalization zoo

XN = np.random.default_rng(5).normal(size=(3, 6, 6, 8)).astype(np.float32) * 2 + 0.5
Y = np.array([0, 2, 1], np.int32)


def _plus_one(a):
    return t_(np.asarray(a) + 1.0)


NORMS = {
    # name: (JAX module, port module, carried state dict, conditional)
    "InstanceNorm2d": (lambda: jnorm.InstanceNorm2d(), lambda: normalization.InstanceNorm2d(8),
                       lambda p: {"weight": t_(p["scale"]), "bias": t_(p["bias"])}, False),
    "VarianceNorm2d": (lambda: jnorm.VarianceNorm2d(bias=True),
                       lambda: normalization.VarianceNorm2d(8, bias=True),
                       lambda p: {"alpha": _plus_one(p["alpha"]), "beta": t_(p["beta"])}, False),
    "InstanceNorm2dPlus": (lambda: jnorm.InstanceNorm2dPlus(),
                           lambda: normalization.InstanceNorm2dPlus(8),
                           lambda p: {"alpha": _plus_one(p["alpha"]),
                                      "gamma": _plus_one(p["gamma"]), "beta": t_(p["beta"])},
                           False),
    "NoneNorm2d": (lambda: jnorm.NoneNorm2d(), lambda: normalization.NoneNorm2d(8),
                   lambda p: {}, False),
    "ConditionalInstanceNorm2d": (lambda: jnorm.ConditionalInstanceNorm2d(num_classes=3),
                                  lambda: normalization.ConditionalInstanceNorm2d(8, 3),
                                  lambda p: {"embed.weight": t_(p["embed"])}, True),
    "ConditionalVarianceNorm2d": (lambda: jnorm.ConditionalVarianceNorm2d(num_classes=3),
                                  lambda: normalization.ConditionalVarianceNorm2d(8, 3),
                                  lambda p: {"embed.weight": t_(p["embed"])}, True),
    "ConditionalNoneNorm2d": (lambda: jnorm.ConditionalNoneNorm2d(num_classes=3, bias=False),
                              lambda: normalization.ConditionalNoneNorm2d(8, 3, bias=False),
                              lambda p: {"embed.weight": t_(p["embed"])}, True),
    "ConditionalInstanceNorm2dPlus": (
        lambda: jnorm.ConditionalInstanceNorm2dPlus(num_classes=3),
        lambda: normalization.ConditionalInstanceNorm2dPlus(8, 3),
        lambda p: {"embed.weight": t_(p["embed"])}, True),
}


@pytest.mark.parametrize("name", list(NORMS))
def test_norm_matches_jax(name):
    make_j, make_t, carry, conditional = NORMS[name]
    jm, m = make_j(), make_t()
    args = (jnp.asarray(XN), jnp.asarray(Y)) if conditional else (jnp.asarray(XN),)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)}, *args)
    rng = np.random.default_rng(6)
    p = jax.tree.map(lambda s: (0.3 * rng.normal(size=s.shape)).astype(np.float32),
                     shapes.get("params", {}))
    m.load_state_dict(carry(p), strict=True)
    theirs = jm.apply({"params": p}, *args)
    with torch.no_grad():
        ours = m(nchw(XN), torch.from_numpy(Y)) if conditional else m(nchw(XN))
    close(nhwc(ours), theirs)


@pytest.mark.parametrize("train", [True, False])
def test_conditional_batch_norm_matches_flax(train):
    """Batch statistics and the running averages' update in training (flax's
    momentum 0.99, biased variances), the running averages otherwise."""
    jm = jnorm.ConditionalBatchNorm2d(num_classes=3)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(XN), jnp.asarray(Y))
    rng = np.random.default_rng(7)
    table = (0.3 * rng.normal(size=variables["params"]["embed"].shape)).astype(np.float32)
    stats = {"mean": rng.normal(size=8).astype(np.float32),
             "var": rng.uniform(0.5, 2, size=8).astype(np.float32)}
    v = {"params": {"embed": table}, "batch_stats": {"BatchNorm_0": stats}}
    if train:
        theirs, new = jm.apply(v, XN, Y, train=True, mutable=["batch_stats"])
        new = new["batch_stats"]["BatchNorm_0"]
    else:
        theirs, new = jm.apply(v, XN, Y, train=False), stats
    m = normalization.ConditionalBatchNorm2d(8, 3)
    m.load_state_dict({"embed.weight": t_(table), "running_mean": t_(stats["mean"]),
                       "running_var": t_(stats["var"])}, strict=True)
    m.train(train)
    with torch.no_grad():
        close(nhwc(m(nchw(XN), torch.from_numpy(Y))), theirs)
    np.testing.assert_allclose(m.running_mean.numpy(), new["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), new["var"], rtol=1e-5, atol=1e-6)


def test_get_normalization_registry():
    class Cfg(dict):
        __getattr__ = dict.__getitem__

    def cfg(norm):
        return Cfg(model=Cfg(normalization=norm, num_classes=4))

    assert isinstance(normalization.get_normalization(cfg("InstanceNorm"))(8),
                      normalization.InstanceNorm2d)
    assert isinstance(normalization.get_normalization(cfg("InstanceNorm++"))(8),
                      normalization.InstanceNorm2dPlus)
    assert isinstance(normalization.get_normalization(cfg("VarianceNorm"))(8),
                      normalization.VarianceNorm2d)
    gn = normalization.get_normalization(cfg("GroupNorm"))(64, num_groups=8)
    assert isinstance(gn, layers.GroupNorm) and gn.num_groups == 8 and gn.eps == 1e-6
    cond = normalization.get_normalization(cfg("InstanceNorm++"), conditional=True)(8)
    assert isinstance(cond, normalization.ConditionalInstanceNorm2dPlus)
    assert cond.embed.weight.shape == (4, 24)
    with pytest.raises(NotImplementedError):
        normalization.get_normalization(cfg("GroupNorm"), conditional=True)
    with pytest.raises(ValueError):
        normalization.get_normalization(cfg("LayerNorm"))
    # the JAX package's GroupNorm entry has eps 1e-6 as well
    assert isinstance(jnorm.get_normalization(cfg("GroupNorm"))(num_features=64), fnn.GroupNorm)
