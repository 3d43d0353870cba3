"""The port's ADM and VDM against the reference goldens and the JAX package:
golden forwards loaded with ``strict=True``, forwards on the same weights
(carried by ``models.convert``), one training step's loss and gradients on
the same t, z and masks, the registry and the full-width parameter counts.

Tolerances: the goldens at the JAX package's (rtol 5e-4, atol 5e-5,
``tests/test_adm_vdm.py``); float32 against JAX to 1e-5 of the output's
largest magnitude; a bfloat16 block to two units in the last place of that
magnitude (2 * 2^-7, ``tests/test_torch_layers.py``)."""
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rdm_tpu.config import load_config as jax_load_config
from rdm_tpu.models import adm as jadm
from rdm_tpu.models import registry as jregistry
from rdm_tpu.models import vdm as jvdm
from rdm_tpu.sde import RVESDE as JRVESDE
from rdm_tpu.training import get_loss_fn as jax_get_loss_fn
from rdm_tpu_torch.config import load_config
from rdm_tpu_torch.models import adm, convert, create_model, get_model, layers, vdm
from rdm_tpu_torch.sde import RVESDE
from rdm_tpu_torch.training.losses import get_loss_fn

torch.set_num_threads(1)  # the suite runs in parallel worker processes

GOLD_DIR = os.path.join(os.path.dirname(__file__), "golden")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

SMALL_ADM = dict(img_resolution=16, model_channels=32, channel_mult=(1, 2), channel_mult_emb=2,
                 num_blocks=1, attn_resolutions=(8,))
SMALL_VDM = dict(channels=16, num_blocks=2, attention=True, num_channels=3, sigma_min=0.01,
                 sigma_max=5.0, image_fourier_start=1, image_fourier_end=3)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def close(ours, theirs, dtype_name="float32"):
    theirs = np.asarray(theirs, np.float32)
    scale = float(np.abs(theirs).max())
    err = float(np.abs(ours - theirs).max())
    assert err <= (1e-5 if dtype_name == "float32" else 2 * 2.0 ** -7) * scale, (err, scale)


def random_params(module, seed, *args, **kwargs):
    """Random weights for every parameter (the zero-initialised closing
    convs included), 0.2 N(0, 1)."""
    shapes = jax.eval_shape(module.init, {"params": jax.random.PRNGKey(0)}, *args, **kwargs)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32),
                        shapes["params"])


def compiled(fn, *args):
    """``fn`` compiled with every bfloat16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def golden(name):
    g = np.load(os.path.join(GOLD_DIR, f"{name}_golden.npz"))
    return g, {k[3:]: torch.from_numpy(g[k]) for k in g.files if k.startswith("sd.")}


# ---------------------------------------------------------------------------
# goldens

def test_adm_golden_loads_strict_and_matches():
    g, sd = golden("adm")
    model = adm.ADM(img_resolution=16, in_channels=3, out_channels=3, label_dim=10,
                    model_channels=32, channel_mult=(1, 2), channel_mult_emb=2, num_blocks=1,
                    attn_resolutions=(8,), dropout=0.0)
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) == int(g["n_params"])
    with torch.no_grad():
        out = model(torch.from_numpy(g["x"]), torch.from_numpy(g["noise_labels"]),
                    torch.from_numpy(g["onehot"]))
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=5e-4, atol=5e-5)


def test_vdm_golden_loads_strict_and_matches():
    g, sd = golden("vdm")
    model = vdm.VDM(channels=32, num_blocks=2, attention=True, dropout=0.0, num_channels=3,
                    sigma_min=0.01, sigma_max=5.0, scale_by_sigma=True)
    model.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in model.parameters()) == int(g["n_params"])
    with torch.no_grad():
        out = model(torch.from_numpy(g["x"]), torch.from_numpy(g["sigma"]))
    np.testing.assert_allclose(out.numpy(), g["out"], rtol=5e-4, atol=5e-5)


def test_golden_state_dicts_cross_the_converters():
    """Golden state dict -> JAX tree (the JAX package's own import shim) ->
    the port's state dict is the identity, and the port's tree is the shim's."""
    from rdm_tpu.models.torch_import import adm_params_from_torch, vdm_params_from_torch
    for name, shim, from_jax, to_tree in (
            ("adm", adm_params_from_torch, convert.adm_state_dict_from_jax,
             convert.adm_tree_from_state_dict),
            ("vdm", vdm_params_from_torch, convert.vdm_state_dict_from_jax,
             convert.vdm_tree_from_state_dict)):
        _, sd = golden(name)
        tree = shim({k: v.numpy() for k, v in sd.items()})
        back = from_jax(tree)
        assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
        ours = to_tree(sd)
        assert jax.tree.structure(ours) == jax.tree.structure(tree)
        assert all(np.array_equal(a, b)
                   for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(tree)))


# ---------------------------------------------------------------------------
# forwards against the JAX package

@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("in_ch,out_ch,up,down,attention", [
    (32, 64, False, False, True), (64, 64, True, False, False), (32, 32, False, True, False),
    (64, 64, False, True, True)])
def test_unet_block_matches_jax(dtype_name, in_ch, out_ch, up, down, attention):
    jdt, tdt = DTYPES[dtype_name]
    jm = jadm.UNetBlock(out_ch, emb_channels=48, up=up, down=down, attention=attention,
                        dtype=jdt)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, in_ch, 8, 8)).astype(np.float32)).to(tdt)
    emb = rng.normal(size=(2, 48)).astype(np.float32)
    xj = jnp.asarray(nhwc(x)).astype(jdt)
    p = random_params(jm, 2, xj, jnp.asarray(emb))
    m = adm.UNetBlock(in_ch, out_ch, 48, up=up, down=down, attention=attention, dtype=tdt)
    m.load_state_dict(convert.adm_state_dict_from_jax(p), strict=True)
    theirs = compiled(lambda p, x, e: jm.apply({"params": p}, x, e), p, xj, jnp.asarray(emb))
    with torch.no_grad():
        ours = m(x, torch.from_numpy(emb))
    assert ours.dtype == tdt
    close(nhwc(ours), theirs, dtype_name)


def test_wrapped_adm_matches_jax_f32():
    """WrappedADM in float32: integer labels, [B, 1] labels, one-hot labels and
    None (the zero label), the log(sigma / 2) noise label and the sigma
    division."""
    jm = jadm.WrappedADM(num_channels=3, num_classes=10, dropout=0.0, dtype=jnp.float32,
                         **SMALL_ADM)
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
    sigma = np.array([0.05, 0.7, 3.0], np.float32)
    ints = np.array([3, 7, 0], np.int32)
    p = random_params(jm, 4, x, sigma, ints)
    m = adm.WrappedADM(num_channels=3, num_classes=10, dropout=0.0, dtype=torch.float32,
                       **SMALL_ADM)
    m.load_state_dict(convert.adm_state_dict_from_jax(p), strict=True)
    onehot = np.eye(10, dtype=np.float32)[ints]
    column = ints[:, None].astype(np.float32)
    apply = jax.jit(lambda p, labels: jm.apply({"params": p}, x, sigma, labels))
    for labels_j, labels_t in ((ints, torch.from_numpy(ints)), (column, torch.from_numpy(column)),
                               (onehot, torch.from_numpy(onehot)), (None, None)):
        theirs = apply(p, labels_j)
        with torch.no_grad():
            ours = m(nchw(x), torch.from_numpy(sigma), labels_t)
        assert ours.dtype == torch.float32
        close(nhwc(ours), theirs)


@pytest.mark.parametrize("labelled", [True, False])
def test_wrapped_adm_matches_jax_bf16(labelled):
    """WrappedADM in bfloat16, its default, against the JAX package compiled
    with every bfloat16 rounding kept.

    Module by module: each module of the ADM (the map layers, the label
    embedding, the input conv, every block with its skip concatenation,
    out_norm and out_conv) is given the JAX package's input to it and held
    to two units in the last place of its output's largest magnitude, the
    rule of the single blocks above.  End to end the blocks' roundings
    compound (measured: 1.8-2.2 units from the float32 model on either
    side, 2.2-2.9 between the two), so the whole forward is held to the
    float32 model (the JAX package in float32, the same weights): per
    sample, no further from it than the JAX package's bfloat16 forward is,
    plus one unit."""
    rng = np.random.default_rng(9)
    x = rng.uniform(size=(3, 16, 16, 3)).astype(np.float32)
    sigma = np.array([0.05, 0.7, 3.0], np.float32)
    ints = np.array([3, 7, 0], np.int32)
    labels_j, labels_t = (ints, torch.from_numpy(ints)) if labelled else (None, None)
    jms = {dt: jadm.WrappedADM(num_channels=3, num_classes=10, dropout=0.0, dtype=dt,
                               **SMALL_ADM) for dt in (jnp.bfloat16, jnp.float32)}
    p = random_params(jms[jnp.bfloat16], 10, x, sigma, ints)
    m = adm.WrappedADM(num_channels=3, num_classes=10, dropout=0.0, **SMALL_ADM)
    assert m.dtype == torch.bfloat16
    m.load_state_dict(convert.adm_state_dict_from_jax(p), strict=True)
    theirs, state = compiled(lambda p, s: jms[jnp.bfloat16].apply(
        {"params": p}, x, s, labels_j, capture_intermediates=True), p, sigma)
    f32 = np.asarray(compiled(lambda p, s: jms[jnp.float32].apply({"params": p}, x, s, labels_j),
                              p, sigma))

    # module by module, each on the JAX package's input to it
    seen = {k: v["__call__"][0] for k, v in state["intermediates"]["model"].items()
            if k != "__call__"}
    net = m.model

    def held(module, name, *inputs):
        with torch.no_grad():
            ours = module(*inputs)
        dtype_name = "float32" if seen[name].dtype == jnp.float32 else "bfloat16"
        assert ours.dtype == DTYPES[dtype_name][1], (name, ours.dtype)
        ours = ours.float().numpy()
        close(ours.transpose(0, 2, 3, 1) if ours.ndim == 4 else ours, seen[name], dtype_name)

    def t(a):
        a = np.array(a, np.float32)
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2) if a.ndim == 4
                                                     else a)).to(
            torch.float32 if a.ndim == 2 else torch.bfloat16)

    held(net.map_layer0, "map_layer0", t(seen["map_noise"]))
    held(net.map_layer1, "map_layer1", torch.nn.functional.silu(t(seen["map_layer0"])))
    onehot = np.eye(10, dtype=np.float32)[ints] if labelled else np.zeros((3, 10), np.float32)
    held(net.map_label, "map_label", torch.from_numpy(onehot))
    emb = torch.nn.functional.silu(t(seen["map_layer1"]) + t(seen["map_label"]))
    h, skips = t(jnp.asarray(x, jnp.bfloat16)), []
    for name, block in net.enc.items():
        held(block, f"enc_{name}", h, *(() if name.endswith("_conv") else (emb,)))
        h = t(seen[f"enc_{name}"])
        skips.append(h)
    for name, block in net.dec.items():
        if "_block" in name:
            h = torch.cat([h, skips.pop()], dim=1)
        held(block, f"dec_{name}", h, emb)
        h = t(seen[f"dec_{name}"])
    held(net.out_norm, "out_norm", h)
    held(net.out_conv, "out_conv", torch.nn.functional.silu(t(seen["out_norm"])))

    # end to end, against the float32 model
    with torch.no_grad():
        ours = m(nchw(x), torch.from_numpy(sigma), labels_t)
    assert ours.dtype == torch.float32
    ours, theirs = nhwc(ours), np.asarray(theirs)
    for i in range(len(x)):
        ulp = 2.0 ** -7 * float(np.abs(f32[i]).max())
        assert np.abs(ours[i] - f32[i]).max() <= np.abs(theirs[i] - f32[i]).max() + ulp, i


@pytest.mark.parametrize("attention", [True, False])
def test_vdm_matches_jax_f32(attention):
    cfg = dict(SMALL_VDM, attention=attention)
    jm = jvdm.VDM(dropout=0.0, **cfg)
    rng = np.random.default_rng(5)
    x = rng.uniform(size=(2, 8, 8, 3)).astype(np.float32)
    sigma = np.array([0.02, 2.5], np.float32)
    p = random_params(jm, 6, x, sigma)
    m = vdm.VDM(dropout=0.0, **cfg)
    m.load_state_dict(convert.vdm_state_dict_from_jax(p), strict=True)
    tree = convert.vdm_tree_from_state_dict(m.state_dict())
    assert jax.tree.structure(tree) == jax.tree.structure(p)
    with torch.no_grad():
        ours = m(nchw(x), torch.from_numpy(sigma))
    close(nhwc(ours), jm.apply({"params": p}, x, sigma))


# ---------------------------------------------------------------------------
# one training step: loss and gradients on the same t, z and masks

class _Draws:
    """The port's uniform draws (label drop first, then each dropout mask),
    recorded, then served in the same order to the JAX side in NHWC: its
    ``jax.random.uniform`` of the label drop and a Flax ``Dropout`` that
    keeps where ``u < 1 - rate``, as ``layers.dropout_mask`` does."""

    def __init__(self):
        self.draws = []

    def record(self, real):
        def draw(shape, generator, device=None):
            u = real(shape, generator, device)
            self.draws.append(u.numpy())
            return u
        return draw

    def jax_side(self, monkeypatch):
        queue = [u if u.ndim == 2 else u.transpose(0, 2, 3, 1) for u in self.draws]
        real_uniform = jax.random.uniform

        def uniform(key, shape=(), *args, **kwargs):
            if queue and tuple(shape) == queue[0].shape and queue[0].ndim == 2:
                return jnp.asarray(queue.pop(0))
            return real_uniform(key, shape, *args, **kwargs)

        class MaskDropout(flax.linen.Module):
            rate: float
            deterministic: bool = False

            @flax.linen.compact
            def __call__(self, x):
                if self.deterministic or self.rate == 0:
                    return x
                u = queue.pop(0)
                assert u.shape == x.shape
                keep = 1.0 - self.rate
                return jnp.where(jnp.asarray(u) < keep, x / keep, jnp.zeros_like(x))

        monkeypatch.setattr(jax.random, "uniform", uniform)
        monkeypatch.setattr(flax.linen, "Dropout", MaskDropout)
        return queue


def training_loss_and_grads(family, dtype_name, monkeypatch):
    """One training loss with dropout 0.1 (and ADM's label dropout 0.5) on
    given t and z, in ``dtype_name``: the port's loss and gradients (by
    parameter name) and ``jax.value_and_grad`` of the JAX package's loss
    (compiled with every bfloat16 rounding kept), on the same weights and
    masks."""
    jdt, tdt = DTYPES[dtype_name]
    rng = np.random.default_rng(7)
    B = 4
    if family == "adm":
        jm = jadm.WrappedADM(num_channels=3, num_classes=10, dropout=0.1, label_dropout=0.5,
                             dtype=jdt, **SMALL_ADM)
        m = adm.WrappedADM(num_channels=3, num_classes=10, dropout=0.1, label_dropout=0.5,
                           dtype=tdt, **SMALL_ADM)
        size, labels = 16, rng.integers(0, 10, size=(B, 1)).astype(np.float32)
        from_jax = convert.adm_state_dict_from_jax
    else:
        assert dtype_name == "float32"
        jm = jvdm.VDM(dropout=0.1, **SMALL_VDM)
        m = vdm.VDM(dropout=0.1, **SMALL_VDM)
        size, labels = 8, None
        from_jax = convert.vdm_state_dict_from_jax
    batch = rng.uniform(0.05, 0.95, (B, size, size, 3)).astype(np.float32)
    t = np.array([0.05, 0.3, 0.6, 0.95], np.float32)
    z = rng.standard_normal((B, size, size, 3)).astype(np.float32)
    p = random_params(jm, 8, batch, np.ones(B, np.float32), labels)
    m.load_state_dict(from_jax(p), strict=True)

    with monkeypatch.context() as mp:
        draws = _Draws()
        mp.setattr(layers, "uniform_draw", draws.record(layers.uniform_draw))
        mp.setattr(adm, "uniform_draw", draws.record(adm.uniform_draw))
        loss = get_loss_fn(RVESDE(0.01, 5, 1000), train=True, reduce_mean=False,
                           likelihood_weighting=False)(
            m, nchw(batch), None if labels is None else torch.from_numpy(labels),
            torch.Generator().manual_seed(0), t=torch.from_numpy(t), z=nchw(z))
        named = list(m.named_parameters())
        grads = torch.autograd.grad(loss, [q for _, q in named])
    assert len(draws.draws) == (1 if family == "adm" else 0) + sum(
        1 for mod in m.modules() if getattr(mod, "dropout", 0) > 0)

    with monkeypatch.context() as mp:
        queue = draws.jax_side(mp)
        lf = jax_get_loss_fn(JRVESDE(0.01, 5, 1000), jm, train=True, reduce_mean=False,
                             likelihood_weighting=False)
        jl, jg = compiled(jax.value_and_grad(
            lambda q: lf(q, batch, labels, jax.random.PRNGKey(0), t=t, z=z)), p)
    assert not queue                                   # every draw was used, in order
    ours = {name: g.float() for (name, _), g in zip(named, grads)}
    theirs = {k: v.float() for k, v in from_jax(jax.device_get(jg)).items()}
    assert set(ours) == set(theirs)
    return float(loss.detach()), ours, float(jl), theirs


@pytest.mark.parametrize("family", ["adm", "vdm"])
def test_training_loss_and_grads_match_jax(family, monkeypatch):
    """float32: the loss within 1e-5 relative and every parameter's
    gradient within 1e-5 of the model's largest gradient entry of
    ``jax.value_and_grad`` of the JAX package's loss.  Measured: 1.3e-7 and
    4e-7."""
    loss, ours, jl, theirs = training_loss_and_grads(family, "float32", monkeypatch)
    assert abs(loss - jl) <= 1e-5 * abs(jl), (loss, jl)
    scale = max(float(g.abs().max()) for g in theirs.values())
    for name, g in ours.items():
        err = float((g - theirs[name]).abs().max())
        assert err <= 1e-5 * scale, (name, err, scale)


def test_training_loss_and_grads_bf16_adm(monkeypatch):
    """WrappedADM's training loss and gradients in bfloat16, its default.
    The backward passes round at points neither package fixes (the JAX
    package's bfloat16 gradients lie 0.14 of the largest entry from its own
    float32 ones, the port's 0.012), so both are held to the float32
    gradients of the JAX package on the same weights and masks: the port's
    loss and each parameter's gradient no further from them than the JAX
    package's bfloat16 ones are, plus one unit in the last place (2^-7 of
    the loss, and of that parameter's largest float32 gradient entry)."""
    loss, ours, jl, theirs = training_loss_and_grads("adm", "bfloat16", monkeypatch)
    _, _, ref_loss, ref = training_loss_and_grads("adm", "float32", monkeypatch)
    assert abs(loss - ref_loss) <= abs(jl - ref_loss) + 2.0 ** -7 * abs(ref_loss), (
        loss, jl, ref_loss)
    for name, g in ours.items():
        ulp = 2.0 ** -7 * float(ref[name].abs().max())
        assert float((g - ref[name]).abs().max()) <= (
            float((theirs[name] - ref[name]).abs().max()) + ulp), name


# ---------------------------------------------------------------------------
# registry and full width

def test_registry_and_configs():
    assert get_model("adm") is adm.WrappedADM and get_model("vdm") is vdm.VDM
    assert jregistry.get_model("adm") is jadm.WrappedADM
    with torch.device("meta"):
        a = create_model(load_config("train", ["data=imagenet64c", "model=adm"]))
        v = create_model(load_config("train", ["data=cifar10", "model=vdm"]))
        d = create_model(load_config("train", ["data=cifar10", "model=ddpmpp"]))
    assert isinstance(a, adm.WrappedADM) and a.dtype == torch.bfloat16 and a.num_classes == 1000
    assert a.model.label_dropout == 0.2       # train.yaml's training.drop_label
    assert isinstance(v, vdm.VDM) and v.dtype == torch.float32 and len(v.enc) == 32
    assert d.nf == 128 and d.ch_mult == (1, 2, 2, 2) and d.channels == 3


@pytest.mark.parametrize("data,model,count", [
    ("imagenet64c", "adm", chip_smoke.FAMILY_PARAMS["adm"]),
    ("cifar10", "vdm", chip_smoke.FAMILY_PARAMS["vdm"]),
    ("cifar10", "ddpmpp", chip_smoke.FAMILY_PARAMS["ddpmpp"])])
def test_full_width_parameter_counts(data, model, count):
    """The configs' full-width models have the JAX package's parameter count
    (``jax.eval_shape``: nothing is computed), which ``chip_smoke.py``
    checks on the card."""
    overrides = [f"data={data}", f"model={model}"]
    cfg = jax_load_config("train", overrides)
    size = cfg.data.image_size
    labels = jnp.zeros((1,)) if model == "adm" else None
    shapes = jax.eval_shape(jregistry.create_model(cfg).init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, size, size, 3)), jnp.ones((1,)), labels)
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"])) == count
    with torch.device("meta"):
        ours = create_model(load_config("train", overrides))
    assert sum(q.numel() for q in ours.parameters()) == count
