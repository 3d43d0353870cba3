"""The port's 1-D U-Net and the legacy layer blocks against the reference
golden and the JAX package: the golden's state dict loaded with
``strict=True``, both variants on the same weights (carried by
``models.convert``) through the plain forward with and without the labels
and through classifier-free guidance, the converters' round trip, the
registry, the label dropout, and every block of ``models.legacy_blocks``.

Tolerances: the golden at the JAX test's own (rtol 5e-4 / atol 5e-5 for
``out``, 5e-4 / 5e-4 for ``out_cfg``, ``tests/test_diffusion1d.py``);
float32 against JAX to 1e-5 of the output's largest magnitude."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.models import legacy_blocks as jlb
from rdm_tpu.models import unet1d as junet
from rdm_tpu_torch.config import load_config
from rdm_tpu_torch.models import convert, create_model, get_model, legacy_blocks
from rdm_tpu_torch.models.unet1d import UNet1D

torch.set_num_threads(1)  # the suite runs in parallel worker processes

GOLD = os.path.join(os.path.dirname(__file__), "golden", "unet1d_golden.npz")

# (legacy, seq_length, extra options): the GTO_Halo_DM original at its 66
# columns, the RDM registry model at 67 (odd lengths through every resize),
# and the RDM model with learned Fourier time features
VARIANTS = {"legacy": (True, 66, {}), "rdm": (False, 67, {}),
            "rdm_learned_time": (False, 67, {"learned_sinusoidal_cond": True})}
SMALL = dict(dim=8, channels=1, dim_mults=(1, 2, 4), embed_class_layers_dims=(8, 8),
             class_dim=1, mask_val=-1.0, resnet_block_groups=4)


def close(ours, theirs):
    theirs = np.asarray(theirs, np.float32)
    scale = float(np.abs(theirs).max())
    err = float(np.abs(np.asarray(ours, np.float32) - theirs).max())
    assert err <= 1e-5 * scale, (err, scale)


def random_params(module, seed, *args, static=()):
    """0.3 N(0, 1) for every parameter (norm scales around 1), from the
    module's shapes; no JAX initialiser runs.  ``static`` follows ``args``
    as Python values."""
    init = functools.partial(lambda *a: module.init(*a, *static))
    shapes = jax.eval_shape(init, {"params": jax.random.PRNGKey(0)}, *args)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        base = 1.0 if path[-1].key in ("scale", "g") else 0.0
        return (base + 0.3 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def nlc(t):
    return np.asarray(t, np.float32).transpose(0, 2, 1)


def inputs(seq_length, seed=0, B=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, 1, seq_length)).astype(np.float32)
    t = np.array([0.0, 17.0, 249.0][:B], np.float32)
    c = rng.uniform(0, 1, (B, 1)).astype(np.float32)
    return x, t, c


def test_golden_loads_strict_and_matches():
    g = np.load(GOLD)
    model = UNet1D(dim=16, channels=1, dim_mults=(1, 2, 4), embed_class_layers_dims=(16, 16),
                   class_dim=1, cond_drop_prob=0.0, mask_val=-1.0, seq_length=66, legacy=True)
    sd = {k[3:]: torch.from_numpy(g[k]) for k in g.files if k.startswith("sd.")}
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) == int(g["n_params"])
    x, t, c = (torch.from_numpy(g[k]) for k in ("x", "t", "classes"))
    with torch.no_grad():
        out = model(x, t, c, cond_drop_prob=0.0).numpy()
        out_cfg = model.forward_with_cond_scale(x, t, c, cond_scale=5.0).numpy()
    np.testing.assert_allclose(out, g["out"], rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(out_cfg, g["out_cfg"], rtol=5e-4, atol=5e-4)


GUIDANCE = ((1.0, 0.0), (1.0, 0.7), (5.0, 0.0), (5.0, 0.7))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_jax_on_the_same_weights(variant):
    legacy, L, extra = VARIANTS[variant]
    jm = junet.UNet1D(**SMALL, seq_length=L, cond_drop_prob=0.0, legacy=legacy, **extra)
    x, t, c = inputs(L, seed=1)
    params = random_params(jm, 2, nlc(x), t, c)

    @jax.jit
    def jax_outputs(p, x, t, c):
        outs = [jm.apply({"params": p}, x, t, c, cond_drop_prob=q) for q in (0.0, 1.0)]
        outs += [jm.forward_with_cond_scale(p, x, t, c, cond_scale=w, rescaled_phi=phi)
                 for w, phi in GUIDANCE]
        return outs

    ref = jax_outputs(params, nlc(x), t, c)
    model = UNet1D(**SMALL, seq_length=L, cond_drop_prob=0.0, legacy=legacy, **extra)
    model.load_state_dict(convert.unet1d_state_dict_from_jax(params, legacy), strict=True)
    xt, tt, ct = (torch.from_numpy(a) for a in (x, t, c))
    with torch.no_grad():
        ours = [model(xt, tt, ct, cond_drop_prob=q) for q in (0.0, 1.0)]
        ours += [model.forward_with_cond_scale(xt, tt, ct, cond_scale=w, rescaled_phi=phi)
                 for w, phi in GUIDANCE]
    for o, r in zip(ours, ref):
        close(nlc(o.numpy()), r)
    # cond_scale 1 is the conditional forward itself, bit for bit
    assert torch.equal(ours[2], ours[0]) and torch.equal(ours[3], ours[0])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_converters_round_trip(variant):
    legacy, L, extra = VARIANTS[variant]
    jm = junet.UNet1D(**SMALL, seq_length=L, legacy=legacy, **extra)
    x, t, c = inputs(L)
    params = random_params(jm, 3, nlc(x), t, c)
    sd = convert.unet1d_state_dict_from_jax(params, legacy)
    model = UNet1D(**SMALL, seq_length=L, legacy=legacy, **extra)
    model.load_state_dict(sd, strict=True)
    back = convert.unet1d_tree_from_state_dict(sd, legacy)
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    assert all(np.array_equal(np.asarray(flat[k]), flat_back[k]) for k in flat)
    with pytest.raises(ValueError):
        convert.unet1d_tree_from_state_dict(sd, not legacy)


def test_registry_and_config_build_the_rdm_model():
    assert get_model("unet1d") is UNet1D
    cfg = load_config("train", ["model=unet1d"])
    model = create_model(cfg)
    assert isinstance(model, UNet1D) and not model.legacy
    jm = junet.UNet1D(dim=64, seq_length=67, dim_mults=(1, 2, 4),
                      embed_class_layers_dims=(64, 64))
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 67, 1)), jnp.zeros((2,)), jnp.zeros((2, 1)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax == 4_206_849


def test_published_legacy_width_counts_like_jax():
    kw = dict(dim=128, channels=1, dim_mults=(4, 4, 8), embed_class_layers_dims=(256, 512),
              class_dim=1, seq_length=66, legacy=True)
    with torch.device("meta"):
        model = UNet1D(**kw)
    shapes = jax.eval_shape(junet.UNet1D(**kw).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((2, 66, 1)), jnp.zeros((2,)), jnp.zeros((2, 1)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax == 73_802_497


def test_label_dropout_keeps_rows_where_the_draw_reaches_p():
    model = UNet1D(**SMALL, seq_length=66, legacy=True, cond_drop_prob=0.5)
    model.init_weights(torch.Generator().manual_seed(0))
    x, t, c = (torch.from_numpy(a) for a in inputs(66, B=3))
    u = torch.rand((3, 1), generator=torch.Generator().manual_seed(5))
    dropped = torch.where(u >= 0.5, c, torch.full_like(c, -1.0))
    with torch.no_grad():
        out = model(x, t, c, generator=torch.Generator().manual_seed(5))
        want = model(x, t, dropped, cond_drop_prob=0.0)
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# models.legacy_blocks

def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


_BLOCK_NAMES = {"adapt": "adapt_convs", "output": "output_convs"}


def blocks_state_dict(params, conv_lists=True) -> dict:
    """A Flax tree of ``rdm_tpu.models.legacy_blocks`` -> the port's names:
    ``convK`` -> ``convs.K`` (the CRP and MSF blocks' lists, with
    ``conv_lists``), ``adaptK`` -> ``adapt_convs.K``, ``output`` ->
    ``output_convs``; conv kernels HWIO -> OIHW, dense (I, O) -> (O, I),
    GroupNorm scale -> weight."""
    sd = {}
    for path, value in jax.tree_util.tree_flatten_with_path(params)[0]:
        mods = []
        for p in (k.key for k in path[:-1]):
            stem = p.rstrip("0123456789")
            if stem in ("conv", "adapt") and stem != p and conv_lists:
                mods += ["convs" if stem == "conv" else "adapt_convs", p[len(stem):]]
            else:
                mods.append(_BLOCK_NAMES.get(p, p))
        leaf, value = path[-1].key, np.asarray(value, np.float32)
        if leaf == "kernel":
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join(mods + [leaf])] = torch.from_numpy(np.ascontiguousarray(value))
    return sd


def run_block(jmod, tmod, seed, jargs, targs, static=()):
    params = random_params(jmod, seed, *jargs, static=static)
    conv_lists = not isinstance(tmod, legacy_blocks.DDPMResnetBlock)
    tmod.load_state_dict(blocks_state_dict(params, conv_lists), strict=True)
    ref = jmod.apply({"params": params}, *jargs, *static)
    with torch.no_grad():
        return tmod(*targs, *static), ref


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("maxpool", [True, False])
def test_crp_and_rcu_blocks(maxpool):
    x = _x((2, 7, 7, 8), 0)
    out, ref = run_block(jlb.CRPBlock(8, 2, maxpool=maxpool),
                         legacy_blocks.CRPBlock(8, 2, maxpool=maxpool), 1, (x,), (nchw(x),))
    close(out.numpy(), nchw(ref).numpy())
    out, ref = run_block(jlb.RCUBlock(8, 2, 2), legacy_blocks.RCUBlock(8, 2, 2), 2,
                         (x,), (nchw(x),))
    close(out.numpy(), nchw(ref).numpy())


@pytest.mark.parametrize("target", [(12, 12), (5, 5)])
def test_msf_and_refine_blocks(target):
    """Bilinear resizes up (12 x 12) and down (5 x 5, antialiased) to the
    common shape."""
    xs = [_x((2, 8, 8, 8), 3), _x((2, 4, 4, 6), 4)]
    txs = [nchw(a) for a in xs]
    out, ref = run_block(jlb.MSFBlock(8), legacy_blocks.MSFBlock((8, 6), 8), 5, (xs,), (txs,),
                         static=(target,))
    close(out.numpy(), nchw(ref).numpy())
    out, ref = run_block(jlb.RefineBlock(8, end=True),
                         legacy_blocks.RefineBlock((8, 6), 8, end=True), 6, (xs,), (txs,),
                         static=(target,))
    close(out.numpy(), nchw(ref).numpy())


@pytest.mark.parametrize("conv_shortcut", [True, False])
def test_ddpm_resnet_block(conv_shortcut):
    x, temb = _x((2, 6, 6, 8), 7), _x((2, 12), 8)
    out, ref = run_block(jlb.DDPMResnetBlock(jax.nn.silu, 16, 12, conv_shortcut=conv_shortcut),
                         legacy_blocks.DDPMResnetBlock(torch.nn.functional.silu, 8, 16, 12,
                                                       conv_shortcut=conv_shortcut),
                         9, (x, temb), (nchw(x), torch.from_numpy(temb)))
    close(out.numpy(), nchw(ref).numpy())


def test_timestep_embedding():
    t = np.array([0.0, 3.0, 999.0], np.float32)
    for dim in (16, 17):
        ref = jlb.get_timestep_embedding(jnp.asarray(t), dim)
        out = legacy_blocks.get_timestep_embedding(torch.from_numpy(t), dim)
        close(out.numpy(), ref)
