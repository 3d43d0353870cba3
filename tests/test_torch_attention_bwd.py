"""The backward of the port's fused attention block against the JAX package.

CPU: the plain backward ``fused_attn_block_bwd_reference`` (which the
wrapper and ``FusedAttnBlockFn`` run for CPU tensors) against the JAX custom
VJP of ``fused_attn_block`` (Pallas kernels in interpret mode), against
autograd of the plain forward, and ``torch.autograd.gradcheck`` of the
Function in float64; a plain model of the tensor-core body's tiling (tokens
padded to 16 rows a warp, gradients summed per slot) against the plain
backward and the JAX VJP, with the padded rows' values exactly zero.  Card
(marker ``gpu``): the CUDA backward kernel against the plain backward, and
two runs against each other.
"""
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

from rdm_tpu.ops.pallas.attention import fused_attn_block as jax_fused_attn_block
from rdm_tpu_torch.models.layers import AttnBlockpp
from rdm_tpu_torch.ops import attention as attn_ops

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("gamma", "beta", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp")
CASES = [(8, 64, 16), (5, 64, 16), (4, 128, 32)]   # (B, C, groups); B = 5 is ragged
BF16_STEP = 2.0 ** -8


def make_inputs(B, C, H, W, seed):
    """NHWC activations, the block's parameters and an output cotangent, as
    float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    p = {"gamma": 1.0 + 0.1 * rng.normal(size=C), "beta": 0.1 * rng.normal(size=C)}
    for n in "qkvp":
        p["w" + n] = rng.normal(size=(C, C)) / math.sqrt(C)
        p["b" + n] = 0.1 * rng.normal(size=C)
    g = rng.normal(size=(B, H, W, C)).astype(np.float32)
    return x, {k: v.astype(np.float32) for k, v in p.items()}, g


def nchw(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


def port_bwd(x, p, g, groups, dtype, fn=attn_ops.fused_attn_block_bwd_reference):
    """The port's gradients as float32 numpy: dx in NHWC, then the ten
    parameter gradients."""
    out = fn(nchw(x, dtype), nchw(g, dtype), *(torch.from_numpy(p[k]) for k in ORDER),
             groups=groups, skip_rescale=True)
    dx = out[0].float().numpy().transpose(0, 2, 3, 1)
    return [dx] + [o.numpy() for o in out[1:]]


def jax_vjp(x, p, g, groups, dtype):
    """The JAX custom VJP (interpret mode): gradients of x (in ``dtype``) and of
    the float32 parameters, as the model differentiates the block."""
    f = lambda xx, *ps: jax_fused_attn_block(xx, *ps, groups=groups, skip_rescale=True,
                                             block_b=4, interpret=True)
    _, vjp = jax.vjp(f, jnp.asarray(x, dtype), *(jnp.asarray(p[k]) for k in ORDER))
    return vjp(jnp.asarray(g, dtype))


@pytest.mark.parametrize("B,C,groups", CASES)
def test_plain_bwd_matches_jax_vjp_f32(B, C, groups):
    x, p, g = make_inputs(B, C, 9, 9, seed=B + C)
    theirs = [np.asarray(a) for a in jax_vjp(x, p, g, groups, jnp.float32)]
    ours = port_bwd(x, p, g, groups, torch.float32)
    for name, a, b in zip(("dx",) + ORDER, ours, theirs):
        assert a.shape == b.shape, name
        # float32 both sides, same algebra; the sums (up to B*L terms) run in
        # another order: 1e-5 of the gradient's scale (measured: under 1e-6)
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= 1e-5 * scale, (name, np.abs(a - b).max(), scale)


# The JAX side of the bfloat16 comparison runs in a process of its own with
# XLA's excess precision off.  By default XLA's CPU compiler may keep a
# bfloat16 product in float32 where the next operation reads it (it did so for
# gs = g * rescale and ds here: 17-31 % of the elements of dWk, dWp and dbp
# then moved by more than a bfloat16 step); with the flag off it rounds at
# every point the kernel's source rounds, as the port does.
JAX_BF16_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    sys.path.insert(0, {tests!r})
    from test_torch_attention_bwd import CASES, jax_vjp, make_inputs
    out = {{}}
    for B, C, groups in CASES:
        x, p, g = make_inputs(B, C, 9, 9, seed=B + C + 1)
        grads = jax_vjp(x, p, g, groups, jnp.bfloat16)
        for i, a in enumerate(grads):
            out[f"{{B}}_{{C}}_{{i}}"] = np.asarray(a.astype(jnp.float32))
        out[f"{{B}}_{{C}}_dtype"] = np.asarray([str(a.dtype) for a in grads])
    np.savez({path!r}, **out)
""")


@pytest.fixture(scope="module")
def jax_bf16_grads(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_bf16") / "grads.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    script = JAX_BF16_SCRIPT.format(tests=os.path.join(ROOT, "tests"), path=path)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(path)


@pytest.mark.parametrize("B,C,groups", CASES)
def test_plain_bwd_matches_jax_vjp_bf16(jax_bf16_grads, B, C, groups):
    x, p, g = make_inputs(B, C, 9, 9, seed=B + C + 1)
    ours = port_bwd(x, p, g, groups, torch.bfloat16)
    dtypes = list(jax_bf16_grads[f"{B}_{C}_dtype"])
    # the JAX VJP returns dx in bfloat16 and float32 parameter gradients
    assert dtypes == ["bfloat16"] + ["float32"] * 10, dtypes
    for i, name in enumerate(("dx",) + ORDER):
        theirs = jax_bf16_grads[f"{B}_{C}_{i}"]
        err = np.abs(ours[i] - theirs)
        scale = max(1.0, float(np.abs(theirs).max()))
        # The same rounding points on both sides; a float32 sum that lands
        # next to a bfloat16 rounding boundary rounds the other way on one
        # side and carries a step on.  dx: 4 bf16 steps at its scale and
        # nearly every element within one step (measured: 0.7 of a step at
        # the scale, 0.01 % of the elements beyond one step).  Parameter
        # gradients are float32 sums of such values: one bf16 step of their
        # scale (measured: at most 0.1 of it).
        if name == "dx":
            assert err.max() <= 4 * BF16_STEP * scale, err.max()
            assert (err <= BF16_STEP * np.maximum(np.abs(theirs), 1.0)).mean() > 0.99
        else:
            assert err.max() <= BF16_STEP * scale, (name, err.max(), scale)


def test_param_grads_are_float32_and_unrounded():
    """The Function takes the float32 master weights, so autograd hands back
    float32 gradients that a bfloat16 working type never rounded, as the JAX
    VJP does (a Function given the cast weights would have them rounded)."""
    x, p, g = make_inputs(4, 64, 9, 9, seed=11)
    xt = nchw(x, torch.bfloat16).requires_grad_()
    params = [torch.from_numpy(p[k]).requires_grad_() for k in ORDER]
    out = attn_ops.FusedAttnBlockFn.apply(xt, *params, 16, True, True)
    out.backward(nchw(g, torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    for prm in params:
        assert prm.grad.dtype == torch.float32
    dwq = params[2].grad
    assert (dwq != dwq.to(torch.bfloat16).float()).float().mean() > 0.9
    theirs = np.asarray(jax_vjp(x, p, g, 16, jnp.bfloat16)[3])
    assert theirs.dtype == np.float32
    assert (theirs != np.asarray(jnp.asarray(theirs).astype(jnp.bfloat16)
                                 .astype(jnp.float32))).mean() > 0.9


def test_plain_bwd_matches_autograd_of_plain_forward_f32():
    x, p, g = make_inputs(3, 64, 9, 9, seed=12)
    xt = nchw(x, torch.float32).requires_grad_()
    params = [torch.from_numpy(p[k]).requires_grad_() for k in ORDER]
    out = attn_ops.fused_attn_block_reference(xt, *params, groups=16)
    out.backward(nchw(g, torch.float32))
    auto = [xt.grad.numpy().transpose(0, 2, 3, 1)] + [prm.grad.numpy() for prm in params]
    ours = port_bwd(x, p, g, 16, torch.float32)
    for name, a, b in zip(("dx",) + ORDER, ours, auto):
        # same float32 algebra; autograd orders some sums differently
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= 1e-5 * scale, (name, np.abs(a - b).max())


def test_function_gradcheck_f64():
    x, p, _ = make_inputs(2, 64, 3, 3, seed=13)
    xt = nchw(x, torch.float64).requires_grad_()
    params = [torch.from_numpy(p[k]).double().requires_grad_() for k in ORDER]
    fn = lambda xx, *ps: attn_ops.FusedAttnBlockFn.apply(xx, *ps, 16, True, True)
    # float64 throughout, so finite differences and the analytic backward
    # agree to the usual gradcheck tolerances
    assert torch.autograd.gradcheck(fn, (xt, *params), eps=1e-6, atol=1e-5, rtol=1e-4,
                                    fast_mode=True)


def test_bwd_wrapper_takes_plain_version_on_cpu():
    x, p, g = make_inputs(3, 64, 9, 9, seed=14)
    before = attn_ops.fused_attn_block_bwd.launches
    a = port_bwd(x, p, g, 16, torch.float32, fn=attn_ops.fused_attn_block_bwd)
    b = port_bwd(x, p, g, 16, torch.float32)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    assert attn_ops.fused_attn_block_bwd.launches == before   # no kernel launched


def test_module_gradients_reach_every_parameter():
    """AttnBlockpp goes through the Function: the block's parameters and its
    input get gradients (a kernel output filled outside autograd would leave
    everything below the block without one)."""
    blk = AttnBlockpp(64, skip_rescale=True, init_scale=0.1, use_kernel=True,
                      dtype=torch.bfloat16, tokens=81)
    with torch.no_grad():
        for prm in blk.parameters():
            prm.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(prm.numel()))
    x = torch.randn(2, 64, 9, 9, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    blk(x).float().square().sum().backward()
    assert x.grad is not None and float(x.grad.abs().sum()) > 0
    for name, prm in blk.named_parameters():
        assert prm.grad is not None and prm.grad.dtype == torch.float32, name


# ---------------------------------------------------------------------------
# The padding argument of the tensor-core backward body

def kernel_tiling_bwd(x, g, params, groups, n_slots, skip_rescale=True):
    """A plain PyTorch model of how ``csrc/fused_attn_block_bwd.cu``'s
    tensor-core body tiles the backward: each sample's tokens padded to ROWS =
    32 * ceil(L / 32) (16 rows a warp, an even number of warps) with h and gs
    zero on the padded rows and the padded keys masked to -inf; the weight
    and bias gradients contracted over all ROWS rows, sample by sample, into
    ``n_slots`` slots (slot s takes samples s, s + n_slots, ...) summed in
    slot order.  Returns the gradients in the order of
    ``fused_attn_block_bwd_reference``, and the values the kernel relies on
    being exactly zero: p at the padded keys, and do, dp, ds, dq, dk, dv and
    dh on the padded rows."""
    dt = x.dtype
    B, C, H, W = x.shape
    L, cg = H * W, C // groups
    R = 32 * -(-L // 32)
    f32 = torch.float32
    T = lambda t: t.to(dt).to(f32)
    gamma, beta, wq, bq, wk, bk, wv, bv, wp, bp = (torch.as_tensor(a).to(dt).to(f32)
                                                   for a in params)
    rs = attn_ops._rescale(skip_rescale)
    rs_t = attn_ops.round_to(rs, dt)
    scale, inv_n = float(C) ** -0.5, 1.0 / (cg * L)
    shapes = [(C,), (C,), (C, C), (C,), (C, C), (C,), (C, C), (C,), (C, C), (C,)]
    slots = [[torch.zeros(s, dtype=f32) for s in shapes] for _ in range(min(B, n_slots))]
    dxs, zeros = [], []
    for b in range(B):
        xg = x[b].reshape(groups, cg * L).to(f32)
        mu = xg.sum(-1, keepdim=True) * inv_n
        inv = torch.rsqrt((xg * xg).sum(-1, keepdim=True) * inv_n - mu * mu + attn_ops.GN_EPS)
        xhat = ((xg - mu) * inv).reshape(C, L).t()                        # (L, C)
        gt = g[b].to(dt).reshape(C, L).t().to(f32)
        h, gs = torch.zeros(R, C), torch.zeros(R, C)
        h[:L] = T(xhat * gamma + beta)
        gs[:L] = T(gt * rs_t)
        nin = lambda t, w, bias: T(T(t @ w) + bias)
        q, k, v = nin(h, wq, bq), nin(h, wk, bk), nin(h, wv, bv)
        s = (q @ k.t()) * scale
        s[:, L:] = -math.inf
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = p / p.sum(-1, keepdim=True)
        pt = T(p)
        o = T(pt @ v)
        do = T(gs @ wp.t())
        dp = do @ v.t()
        ds = T(p * (dp - (dp * p).sum(-1, keepdim=True)) * scale)
        dq, dk, dv = T(ds @ k), T(ds.t() @ q), T(pt.t() @ do)
        dh = dq @ wq.t() + dk @ wk.t() + dv @ wv.t()
        zeros += [p[:, L:], do[L:], dp[L:], ds[L:], ds[:, L:], dq[L:], dk[L:], dv[L:], dh[L:]]
        dhr = dh[:L]
        dxhat = (dhr * gamma).t().reshape(groups, cg * L)
        xh = xhat.t().reshape(groups, cg * L)
        m1 = dxhat.sum(-1, keepdim=True) * inv_n
        m2 = (dxhat * xh).sum(-1, keepdim=True) * inv_n
        dxs.append(((inv * (dxhat - m1 - xh * m2)).reshape(C, L) + gt.t() * rs).to(dt))
        parts = [(dhr * xhat).sum(0), dhr.sum(0), h.t() @ dq, dq.sum(0), h.t() @ dk, dk.sum(0),
                 h.t() @ dv, dv.sum(0), o.t() @ gs, gs.sum(0)]
        for acc, part in zip(slots[b % n_slots], parts):
            acc += part
    grads = [sum(slot[i] for slot in slots) for i in range(10)]
    return [torch.stack(dxs).reshape(B, C, H, W)] + grads, zeros


def _tiling_grads(x, p, g, groups, dtype, n_slots=3):
    ours, zeros = kernel_tiling_bwd(nchw(x, dtype), nchw(g, dtype), [p[k] for k in ORDER],
                                    groups, n_slots)
    for z in zeros:
        assert torch.equal(z, torch.zeros_like(z))
    return [ours[0].float().numpy().transpose(0, 2, 3, 1)] + [a.numpy() for a in ours[1:]]


@pytest.mark.parametrize("B,H,W", [(5, 9, 9), (3, 7, 7), (4, 8, 12)])
def test_kernel_tiling_matches_plain_and_jax_f32(B, H, W):
    """Padded rows add exactly nothing: the model of the kernel's tiling
    (81 tokens padded to 96, 49 to 64; 96 unpadded) gives the unpadded plain
    backward's gradients and the JAX VJP's, up to float32 summation order."""
    x, p, g = make_inputs(B, 64, H, W, seed=20 + B)
    ours = _tiling_grads(x, p, g, 16, torch.float32)
    plain = port_bwd(x, p, g, 16, torch.float32)
    theirs = [np.asarray(a) for a in jax_vjp(x, p, g, 16, jnp.float32)]
    for name, a, b, c in zip(("dx",) + ORDER, ours, plain, theirs):
        # padded rows only add zeros; matmuls over 96 instead of 81 terms and
        # the slot order change only the float32 summation order
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= 1e-5 * scale, (name, np.abs(a - b).max())
        assert np.abs(a - c).max() <= 1e-5 * scale, (name, np.abs(a - c).max())


@pytest.mark.parametrize("B,C,groups", [c for c in CASES if c[1] == 64])
def test_kernel_tiling_matches_jax_vjp_bf16(jax_bf16_grads, B, C, groups):
    """The same model in bfloat16 (the body's only type) against the JAX VJP,
    with the tolerances of ``test_plain_bwd_matches_jax_vjp_bf16``."""
    x, p, g = make_inputs(B, C, 9, 9, seed=B + C + 1)
    ours = _tiling_grads(x, p, g, groups, torch.bfloat16)
    for i, name in enumerate(("dx",) + ORDER):
        theirs = jax_bf16_grads[f"{B}_{C}_{i}"]
        err = np.abs(ours[i] - theirs)
        scale = max(1.0, float(np.abs(theirs).max()))
        if name == "dx":
            assert err.max() <= 4 * BF16_STEP * scale, err.max()
        else:
            assert err.max() <= BF16_STEP * scale, (name, err.max(), scale)


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(B, C, H, W, dtype, device, seed):
    x, p, g = make_inputs(B, C, H, W, seed)
    return (nchw(x, dtype).to(device), nchw(g, dtype).to(device),
            [torch.from_numpy(p[k]).to(device) for k in ORDER])


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,groups,H,W", [(256, 64, 16, 9, 9), (3, 64, 16, 9, 9),
                                            (64, 128, 32, 9, 9), (16, 128, 32, 8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain(cuda_device, B, C, groups, H, W, dtype):
    x, g, params = _card_inputs(B, C, H, W, dtype, cuda_device, seed=B + C)
    before = attn_ops.fused_attn_block_bwd.launches
    ours = attn_ops.fused_attn_block_bwd(x, g, *params, groups=groups)
    ref = attn_ops.fused_attn_block_bwd_reference(x, g, *params, groups=groups)
    torch.cuda.synchronize()
    assert attn_ops.fused_attn_block_bwd.launches == before + 1
    scales = {name: max(1.0, float(b.float().abs().max()))
              for name, b in zip(("dx",) + ORDER, ref)}
    # dbk is zero in exact arithmetic (softmax ignores a shift that all keys
    # share): both versions return the summed rounding noise of B*L values of
    # dk, whose size is that of dq, so it is held to the scale of dbq
    scales["bk"] = max(scales["bk"], scales["bq"])
    for name, a, b in zip(("dx",) + ORDER, ours, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        err = float((a.float() - b.float()).abs().max())
        # float32: summation order only; bfloat16: as against the JAX VJP
        tol = (1e-4 if dtype == torch.float32
               else (4 if name == "dx" else 1) * BF16_STEP) * scales[name]
        assert err <= tol, (name, err, tol)


@pytest.mark.gpu
def test_bwd_kernel_is_deterministic(cuda_device):
    x, g, params = _card_inputs(4096, 64, 9, 9, torch.bfloat16, cuda_device, seed=7)
    a = attn_ops.fused_attn_block_bwd(x, g, *params, groups=16)
    b = attn_ops.fused_attn_block_bwd(x, g, *params, groups=16)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.gpu
def test_module_on_card_launches_both_kernels(cuda_device):
    blk = AttnBlockpp(64, skip_rescale=True, use_kernel=True, dtype=torch.bfloat16,
                      tokens=81)
    blk.to(cuda_device)
    x = torch.randn(8, 64, 9, 9, device=cuda_device, requires_grad=True)
    f0, b0 = attn_ops.fused_attn_block.launches, attn_ops.fused_attn_block_bwd.launches
    blk(x).float().sum().backward()
    assert attn_ops.fused_attn_block.launches == f0 + 1
    assert attn_ops.fused_attn_block_bwd.launches == b0 + 1
    assert blk.NIN_0.W.grad.dtype == torch.float32
