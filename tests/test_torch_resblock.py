"""The port's fused resblock against the JAX package.

CPU: the plain version ``fused_resblock_reference`` (which the wrapper runs
for CPU tensors) against the JAX Pallas kernel ``fused_resblock`` in
interpret mode on the same seeded inputs; the gradient of
``FusedResblockFn`` against the JAX custom VJP (float32) and against
``jax.vjp`` of the JAX twin ``_jnp_reference`` (bfloat16: the JAX custom VJP
raises there, see ROADMAP); the module gate of ``ResnetBlockDDPMpp``.
Card (marker ``gpu``): the CUDA kernel against the plain version.
"""
import functools
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rdm_tpu.ops.pallas.resblock import _jnp_reference
from rdm_tpu.ops.pallas.resblock import fused_resblock as jax_fused_resblock
from rdm_tpu_torch.models import NCSNpp, create_model
from rdm_tpu_torch.models.layers import ResnetBlockDDPMpp
from rdm_tpu_torch.ops import resblock as rb_ops

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_STEP = 2.0 ** -8
# (H, C_in, C_out): both shortcut kinds and the three spatial sizes
SHAPES = [(9, 64, 64), (9, 192, 64), (4, 64, 128), (4, 256, 128), (2, 128, 128)]
GRAD_SHAPES = [(9, 64, 64), (4, 64, 128)]
# the eight (H, C_in, C_out) of the flagship's 17 resblocks
FLAGSHIP_SHAPES = [(9, 64, 64), (4, 64, 128), (4, 128, 128), (2, 128, 128), (2, 256, 128),
                   (4, 256, 128), (9, 192, 64), (9, 128, 64)]
PARAMS = ("gns0", "gnb0", "w0", "b0", "gns1", "gnb1", "w1", "b1", "wn", "bn")


def groups(c):
    return min(c // 4, 32)


def make_inputs(B, H, ci, co, seed):
    """NHWC x, tembv (B, C_out), the block's parameters in the JAX layout
    (HWIO convolutions) and an output cotangent, as float32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x = f(B, H, H, ci)
    p = dict(tembv=0.5 * f(B, co), gns0=1 + 0.1 * f(ci), gnb0=0.1 * f(ci),
             w0=f(3, 3, ci, co) / math.sqrt(9 * ci), b0=0.1 * f(co),
             gns1=1 + 0.1 * f(co), gnb1=0.1 * f(co),
             w1=f(3, 3, co, co) / math.sqrt(9 * co), b1=0.1 * f(co))
    if ci != co:
        p["wn"], p["bn"] = f(ci, co) / math.sqrt(ci), 0.1 * f(co)
    g = f(B, H, H, co)
    return x, p, g


def torch_params(p, device="cpu"):
    """The parameters in the port's layouts (convolutions OIHW), None for an
    absent shortcut."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out = []
    for k in PARAMS:
        if k not in p:
            out.append(None)
        elif k in ("w0", "w1"):
            out.append(t(p[k].transpose(3, 2, 0, 1)))
        else:
            out.append(t(p[k]))
    return out


def nchw(a, dtype, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(device, dtype)


def kw(ci, co):
    return dict(groups0=groups(ci), groups1=groups(co), skip_rescale=True)


def run_port(x, p, dtype, fn=rb_ops.fused_resblock):
    ci, co = x.shape[-1], p["w0"].shape[-1]
    out = fn(nchw(x, dtype), torch.from_numpy(p["tembv"]).to(dtype), *torch_params(p),
             **kw(ci, co))
    return out.float().numpy().transpose(0, 2, 3, 1)


def jax_args(x, p, dt):
    """x and tembv in ``dt``, the parameters float32, for the JAX kernel."""
    return ([jnp.asarray(x, dt), jnp.asarray(p["tembv"], dt)]
            + [jnp.asarray(p[k]) if k in p else None for k in PARAMS])


def jax_kernel(x, p, dt):
    ci, co = x.shape[-1], p["w0"].shape[-1]
    fn = jax.jit(functools.partial(jax_fused_resblock, **kw(ci, co), block_b=4, interpret=True))
    return np.asarray(fn(*jax_args(x, p, dt)).astype(jnp.float32))


def jax_twin_vjp(x, p, g, dt):
    """jax.vjp of the JAX twin ``_jnp_reference`` (what the JAX custom VJP
    differentiates) with the cotangent in ``dt``: gradients of x, tembv and
    the float32 parameters (zeros stand in for an absent shortcut)."""
    B, H, _, ci = x.shape
    co = p["w0"].shape[-1]
    ref = functools.partial(_jnp_reference, H=H, W=H, groups0=groups(ci), groups1=groups(co),
                            eps=1e-6, rescale=1 / math.sqrt(2.0), has_shortcut=ci != co)
    args = jax_args(x, p, dt)
    args[0] = args[0].reshape(B, H * H, ci)
    args[4], args[8] = args[4].reshape(9, ci, co), args[8].reshape(9, co, co)
    if ci == co:
        args[10], args[11] = jnp.zeros((ci, co)), jnp.zeros((co,))
    return jax.jit(lambda a, c: jax.vjp(ref, *a)[1](c))(
        args, jnp.asarray(g.reshape(B, H * H, co), dt))


# The JAX side of the bfloat16 comparisons runs in a process of its own with
# XLA's excess precision off: by default XLA's CPU compiler keeps some
# bfloat16 results in float32 where the next operation reads them, and then
# 22-30 % of the output's elements move by a bfloat16 step against the
# kernel's rounding points; with the flag off it rounds where the kernel does.
JAX_BF16_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    sys.path.insert(0, {tests!r})
    from test_torch_resblock import GRAD_SHAPES, SHAPES, jax_kernel, jax_twin_vjp, make_inputs
    out = {{}}
    for H, ci, co in SHAPES:
        x, p, g = make_inputs(5, H, ci, co, seed=H + ci + co + 1)
        out[f"out_{{H}}_{{ci}}_{{co}}"] = jax_kernel(x, p, jnp.bfloat16)
    for H, ci, co in GRAD_SHAPES:
        x, p, g = make_inputs(5, H, ci, co, seed=H + ci + co + 2)
        grads = jax_twin_vjp(x, p, g, jnp.bfloat16)
        for i, a in enumerate(grads):
            out[f"grad_{{H}}_{{ci}}_{{co}}_{{i}}"] = np.asarray(a.astype(jnp.float32))
        out[f"grad_{{H}}_{{ci}}_{{co}}_dtype"] = np.asarray([str(a.dtype) for a in grads])
    np.savez({path!r}, **out)
""")


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_bf16") / "resblock.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    script = JAX_BF16_SCRIPT.format(tests=os.path.join(ROOT, "tests"), path=path)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(path)


def bf16_step_of(a):
    """One bfloat16 step (unit in the last place) at the magnitude of ``a``'s
    largest element."""
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


@pytest.mark.parametrize("H,ci,co", SHAPES)
def test_plain_matches_jax_kernel_f32(H, ci, co):
    x, p, _ = make_inputs(5, H, ci, co, seed=H + ci + co)
    ours, theirs = run_port(x, p, torch.float32), jax_kernel(x, p, jnp.float32)
    # float32 both sides, same algebra; the sums (up to 9 * 256 terms per
    # convolution) run in another order (measured: 3.0e-7 of the scale)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("H,ci,co", SHAPES)
def test_plain_matches_jax_kernel_bf16(jax_bf16, H, ci, co):
    x, p, _ = make_inputs(5, H, ci, co, seed=H + ci + co + 1)
    ours, theirs = run_port(x, p, torch.bfloat16), jax_bf16[f"out_{H}_{ci}_{co}"]
    # The same rounding points; a float32 sum that lands next to a bfloat16
    # rounding boundary may round the other way on one side, and the later
    # stages carry the step on.  Bound: one bfloat16 step at the output's
    # largest value, and at most 2 % of the elements differ at all (the
    # module path, which rounds elsewhere, differs in about half of them).
    # Measured: bit-equal at three shapes; at (9, 64, 64) 0.6 % of the
    # elements differ, by at most that one step.
    err = np.abs(ours - theirs)
    assert err.max() <= bf16_step_of(theirs), (err.max(), bf16_step_of(theirs))
    assert (ours != theirs).mean() <= 0.02, (ours != theirs).mean()


def port_grads(x, p, g, dtype):
    """Gradients of x, tembv and the parameters through ``FusedResblockFn``
    (CPU: the plain forward, the twin's backward), in the JAX layouts."""
    ci, co = x.shape[-1], p["w0"].shape[-1]
    xt = nchw(x, dtype).requires_grad_(True)
    tv = torch.from_numpy(p["tembv"]).to(dtype).requires_grad_(True)
    params = [None if t is None else t.requires_grad_(True) for t in torch_params(p)]
    out = rb_ops.FusedResblockFn.apply(xt, tv, *params, groups(ci), groups(co), True)
    assert out.dtype == dtype
    out.backward(nchw(g, dtype))
    grads = [xt.grad.float().numpy().transpose(0, 2, 3, 1), tv.grad.float().numpy()]
    for k, t in zip(PARAMS, params):
        if t is None:
            grads.append(None)
            continue
        assert t.grad.dtype == torch.float32, k
        a = t.grad.numpy()
        grads.append(a.transpose(2, 3, 1, 0) if k in ("w0", "w1") else a)
    return grads


@pytest.mark.parametrize("H,ci,co", GRAD_SHAPES)
def test_grads_match_jax_custom_vjp_f32(H, ci, co):
    x, p, g = make_inputs(3, H, ci, co, seed=H + ci + co + 2)
    args = jax_args(x, p, jnp.float32)
    live = [i for i, a in enumerate(args) if a is not None]

    def f(*vals):
        full = list(args)
        for i, v in zip(live, vals):
            full[i] = v
        return jax_fused_resblock(*full, **kw(ci, co), block_b=4, interpret=True)

    grads = jax.jit(lambda vals, c: jax.vjp(f, *vals)[1](c))(
        [args[i] for i in live], jnp.asarray(g))
    theirs = dict(zip(live, grads))
    ours = port_grads(x, p, g, torch.float32)
    for i, name in enumerate(("x", "tembv") + PARAMS):
        if i not in theirs:
            assert ours[i] is None, name
            continue
        b = np.asarray(theirs[i]).reshape(ours[i].shape)
        # float32 both sides, the same twin differentiated; sums in another
        # order: 1e-5 of each gradient's scale
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(ours[i] - b).max() <= 1e-5 * scale, (name, np.abs(ours[i] - b).max())


@pytest.mark.parametrize("H,ci,co", GRAD_SHAPES)
def test_grads_match_jax_twin_vjp_bf16(jax_bf16, H, ci, co):
    x, p, g = make_inputs(5, H, ci, co, seed=H + ci + co + 2)
    ours = port_grads(x, p, g, torch.bfloat16)
    key = f"grad_{H}_{ci}_{co}"
    assert list(jax_bf16[key + "_dtype"]) == ["bfloat16"] * 2 + ["float32"] * 10
    for i, name in enumerate(("x", "tembv") + PARAMS):
        if ours[i] is None:
            continue
        theirs = jax_bf16[f"{key}_{i}"].reshape(ours[i].shape)
        err = np.abs(ours[i] - theirs)
        scale = max(1.0, float(np.abs(theirs).max()))
        # Both differentiate the same twin: its recomputed activations round
        # to bfloat16 where a float32 value next to a rounding boundary may
        # round the other way on one side (SiLU and rsqrt differ in the last
        # float32 place), and the later sums carry the step on.  x: 2 bf16
        # steps at its scale and nearly every element within one step
        # (measured: 1.08 steps, 0.04 % of the elements beyond one).  tembv:
        # JAX sums its token cotangents in bfloat16, the port in float32 and
        # rounds once: 4 steps (measured: 3.4).  The float32 parameter
        # gradients, sums of such values: one step of their scale (measured:
        # at most 0.22).
        tol = {"x": 2, "tembv": 4}.get(name, 1) * BF16_STEP * scale
        assert err.max() <= tol, (name, err.max(), tol)
        if name == "x":
            assert (err <= BF16_STEP * np.maximum(np.abs(theirs), 1.0)).mean() > 0.99


# ---------------------------------------------------------------------------
# The module gate

def block_and_inputs(ci, co, dtype, dropout=0.0, use_kernel=True, seed=0):
    torch.manual_seed(seed)
    blk = ResnetBlockDDPMpp(F.silu, ci, co, temb_dim=32, dropout=dropout, skip_rescale=True,
                            init_scale=0.1, use_kernel=use_kernel, dtype=dtype)
    with torch.no_grad():
        for t in blk.parameters():
            t.normal_(0.0, 0.2)
    x = torch.randn(3, ci, 9, 9).to(dtype)
    temb = torch.randn(3, 32)
    return blk, x, temb


def fused_of(blk, x, temb):
    nin = (blk.NIN_0.W, blk.NIN_0.b) if hasattr(blk, "NIN_0") else (None, None)
    return rb_ops.fused_resblock_reference(
        x, blk.Dense_0(blk.act(temb)), blk.GroupNorm_0.weight, blk.GroupNorm_0.bias,
        blk.Conv_0.weight, blk.Conv_0.bias, blk.GroupNorm_1.weight, blk.GroupNorm_1.bias,
        blk.Conv_1.weight, blk.Conv_1.bias, *nin, groups0=groups(x.shape[1]),
        groups1=groups(blk.Conv_0.weight.shape[0]), skip_rescale=True)


@pytest.mark.parametrize("ci,co", [(64, 64), (64, 128)])
def test_gate_bf16_without_dropout_takes_the_fused_block(ci, co, monkeypatch):
    blk, x, temb = block_and_inputs(ci, co, torch.bfloat16, dropout=0.2)
    calls = []
    apply = rb_ops.FusedResblockFn.apply
    monkeypatch.setattr(rb_ops.FusedResblockFn, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    with torch.no_grad():
        out = blk(x, temb)                          # evaluation: dropout inactive
        blk.dropout = 0.0
        out_nodrop = blk(x, temb, train=True, generator=torch.Generator().manual_seed(0))
        blk.use_kernel = False
        module = blk(x, temb)
    assert len(calls) == 2
    ref = fused_of(blk, x, temb)
    for o in (out, out_nodrop):
        assert o.dtype == torch.bfloat16 and torch.equal(o, ref)
    # the module path rounds elsewhere: many elements differ by a bf16 step
    assert (module != ref).float().mean() > 0.1


def test_gate_train_with_dropout_takes_the_module_path(monkeypatch):
    blk, x, temb = block_and_inputs(64, 128, torch.bfloat16, dropout=0.2)
    monkeypatch.setattr(rb_ops.FusedResblockFn, "apply",
                        lambda *a: pytest.fail("fused block under active dropout"))
    with torch.no_grad():
        out = blk(x, temb, train=True, generator=torch.Generator().manual_seed(3))
        blk.use_kernel = False
        ref = blk(x, temb, train=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("case", ["float32", "no_temb"])
def test_gate_f32_or_without_temb_takes_the_module_path(case, monkeypatch):
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    blk, x, temb = block_and_inputs(64, 64, dtype)
    if case == "no_temb":
        temb = None
    monkeypatch.setattr(rb_ops.FusedResblockFn, "apply",
                        lambda *a: pytest.fail("fused block outside the gate"))
    with torch.no_grad():
        out = blk(x, temb)
        blk.use_kernel = False
        ref = blk(x, temb)
    assert torch.equal(out, ref)


def test_gate_keeps_state_dict_and_model_wiring():
    for ci, co in [(64, 64), (64, 128)]:
        a = ResnetBlockDDPMpp(F.silu, ci, co, temb_dim=32, use_kernel=True).state_dict()
        b = ResnetBlockDDPMpp(F.silu, ci, co, temb_dim=32).state_dict()
        assert list(a) == list(b) and all(a[k].shape == b[k].shape for k in a)
    plain, fused = NCSNpp(), NCSNpp(resblock_kernel=True)
    assert list(plain.state_dict()) == list(fused.state_dict())
    blocks = [m for m in fused.modules() if isinstance(m, ResnetBlockDDPMpp)]
    assert len(blocks) == 17 and all(m.use_kernel for m in blocks)
    assert not any(m.use_kernel for m in plain.modules() if isinstance(m, ResnetBlockDDPMpp))
    from rdm_tpu_torch.config import load_config
    cfg = load_config("train", ["model.resblock_pallas=true", "model.precision=bfloat16"])
    model = create_model(cfg)
    assert all(m.use_kernel for m in model.modules() if isinstance(m, ResnetBlockDDPMpp))
    shapes = sorted({(m.GroupNorm_0.num_channels, m.Conv_0.weight.shape[0])
                     for m in blocks})
    assert {(ci, co) for _, ci, co in FLAGSHIP_SHAPES} == set(shapes)


def test_module_gradients_reach_every_parameter():
    blk, x, temb = block_and_inputs(64, 128, torch.bfloat16)
    x.requires_grad_(True)
    temb.requires_grad_(True)
    blk(x, temb).float().square().sum().backward()
    assert x.grad is not None and x.grad.dtype == torch.bfloat16 and temb.grad is not None
    for name, t in blk.named_parameters():
        assert t.grad is not None and t.grad.dtype == torch.float32, name
        assert float(t.grad.abs().sum()) > 0, name


def test_wrapper_takes_plain_version_on_cpu_and_raises_elsewhere():
    x, p, _ = make_inputs(3, 9, 64, 64, seed=1)
    before = rb_ops.fused_resblock.launches
    a = run_port(x, p, torch.float32)
    b = run_port(x, p, torch.float32, fn=rb_ops.fused_resblock_reference)
    np.testing.assert_array_equal(a, b)
    assert rb_ops.fused_resblock.launches == before       # no kernel launched
    xm = torch.empty((2, 64, 9, 9), device="meta")
    params = [None if t is None else t.to("meta") for t in torch_params(p)]
    with pytest.raises(ValueError):
        rb_ops.fused_resblock(xm, torch.empty((2, 64), device="meta"), *params, **kw(64, 64))
    assert rb_ops.kernel_takes(9, 9, 192, 64) and not rb_ops.kernel_takes(9, 9, 64, 128)
    assert all(rb_ops.kernel_takes(H, H, ci, co) for H, ci, co in FLAGSHIP_SHAPES)


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("H,ci,co", FLAGSHIP_SHAPES)
@pytest.mark.parametrize("B", [64, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, H, ci, co, B, dtype):
    x, p, _ = make_inputs(B, H, ci, co, seed=B + H + ci + co)
    xt = nchw(x, dtype, cuda_device)
    tv = torch.from_numpy(p["tembv"]).to(cuda_device, dtype)
    params = torch_params(p, cuda_device)
    before = rb_ops.fused_resblock.launches
    out = rb_ops.fused_resblock(xt, tv, *params, **kw(ci, co))
    ref = rb_ops.fused_resblock_reference(xt, tv, *params, **kw(ci, co))
    torch.cuda.synchronize()
    assert rb_ops.fused_resblock.launches == before + 1
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    # float32: summation order only; bfloat16: the same rounding points, a
    # sum next to a rounding boundary may round the other way and carry a
    # step on: 4 bf16 steps at the output's largest magnitude
    assert err <= (1e-4 if dtype == torch.float32 else 4 * BF16_STEP) * scale, err


@pytest.mark.gpu
def test_kernel_rejects_unsupported(cuda_device):
    x, p, _ = make_inputs(2, 9, 64, 128, seed=0)     # (9, C_out 128) is not a kernel shape
    xt = nchw(x, torch.bfloat16, cuda_device)
    tv = torch.from_numpy(p["tembv"]).to(cuda_device)
    with pytest.raises(ValueError):
        rb_ops.fused_resblock(xt, tv, *torch_params(p, cuda_device), **kw(64, 128))
    x, p, _ = make_inputs(2, 9, 64, 64, seed=0)
    xt = nchw(x, torch.float16, cuda_device)
    tv = torch.from_numpy(p["tembv"]).to(cuda_device)
    with pytest.raises(ValueError):
        rb_ops.fused_resblock(xt, tv, *torch_params(p, cuda_device), **kw(64, 64))
