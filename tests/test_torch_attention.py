"""The fused attention block of the port against the JAX package.

CPU: the plain version ``fused_attn_block_reference`` (which the wrapper
runs for CPU tensors) against the JAX Pallas kernel in interpret mode and
against the JAX XLA ``AttnBlockpp``, on the same seeded inputs.
Card (marker ``gpu``): the CUDA kernel against the plain version.
"""
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.ops.pallas.attention import fused_attn_block as jax_fused_attn_block
from rdm_tpu_torch.models import NCSNpp
from rdm_tpu_torch.models.layers import AttnBlockpp
from rdm_tpu_torch.ops import attention as attn_ops

torch.set_num_threads(1)  # the suite runs in parallel worker processes


def make_inputs(B, C, H, W, seed):
    """NHWC activations and the block's parameters as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    p = {"gamma": 1.0 + 0.1 * rng.normal(size=C), "beta": 0.1 * rng.normal(size=C)}
    for n in "qkvp":
        p["w" + n] = rng.normal(size=(C, C)) / math.sqrt(C)
        p["b" + n] = 0.1 * rng.normal(size=C)
    return x, {k: v.astype(np.float32) for k, v in p.items()}


ORDER = ("gamma", "beta", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp")


def run_port(x_nhwc, p, groups, dtype, fn=attn_ops.fused_attn_block):
    x = torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy()).to(dtype)
    out = fn(x, *(torch.from_numpy(p[k]) for k in ORDER), groups=groups, skip_rescale=True)
    return out.float().numpy().transpose(0, 2, 3, 1)


def run_jax_kernel(x_nhwc, p, groups, dtype):
    out = jax_fused_attn_block(jnp.asarray(x_nhwc, dtype), *(jnp.asarray(p[k]) for k in ORDER),
                               groups=groups, skip_rescale=True, block_b=4, interpret=True)
    return np.asarray(out.astype(jnp.float32))


CASES = [(8, 64, 16), (8, 128, 32), (5, 64, 16)]   # (B, C, groups); B = 5 is ragged


@pytest.mark.parametrize("B,C,groups", CASES)
def test_plain_matches_jax_kernel_f32(B, C, groups):
    x, p = make_inputs(B, C, 9, 9, seed=C + B)
    ours = run_port(x, p, groups, torch.float32)
    theirs = run_jax_kernel(x, p, groups, jnp.float32)
    # float32 on both sides, same algebra; only summation order differs
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("B,C,groups", CASES)
def test_plain_matches_jax_kernel_bf16(B, C, groups):
    x, p = make_inputs(B, C, 9, 9, seed=C + B + 1)
    ours = run_port(x, p, groups, torch.bfloat16)
    theirs = run_jax_kernel(x, p, groups, jnp.bfloat16)
    # Same rounding points in bfloat16; a float32 sum that lands next to a
    # bf16 rounding boundary may round the other way on one side.  Bound:
    # 4 bf16 steps (2^-8 relative each) at the output's magnitude, and nearly
    # every element within one step.
    scale = max(1.0, float(np.abs(theirs).max()))
    err = np.abs(ours - theirs)
    assert err.max() <= 4 * 2.0 ** -8 * scale, err.max()
    assert (err <= 2.0 ** -8 * np.maximum(np.abs(theirs), 1.0)).mean() > 0.99


@pytest.mark.parametrize("B,C,groups", CASES)
def test_module_matches_jax_xla_attnblock(B, C, groups):
    """The port's AttnBlockpp (kernel path, CPU -> plain version) against the
    JAX XLA AttnBlockpp with the same carried weights, float32."""
    from rdm_tpu.models.layers import AttnBlockpp as JAttnBlockpp   # needs flax

    x, p = make_inputs(B, C, 9, 9, seed=C + B + 2)
    params = {"norm": {"scale": p["gamma"], "bias": p["beta"]},
              "q": {"W": p["wq"], "b": p["bq"]}, "k": {"W": p["wk"], "b": p["bk"]},
              "v": {"W": p["wv"], "b": p["bv"]}, "proj": {"W": p["wp"], "b": p["bp"]}}
    theirs = np.asarray(JAttnBlockpp(skip_rescale=True).apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x)))
    blk = AttnBlockpp(C, skip_rescale=True, use_kernel=True, tokens=81)
    sd = {"GroupNorm_0.weight": p["gamma"], "GroupNorm_0.bias": p["beta"]}
    for i, n in enumerate("qkvp"):
        sd[f"NIN_{i}.W"], sd[f"NIN_{i}.b"] = p["w" + n], p["b" + n]
    blk.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        ours = blk(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    # float32; Flax GroupNorm and the fused block differ in summation order
    np.testing.assert_allclose(ours.transpose(0, 2, 3, 1), theirs, rtol=1e-5, atol=3e-5)


def test_wrapper_takes_plain_version_on_cpu():
    x, p = make_inputs(3, 64, 9, 9, seed=9)
    before = attn_ops.fused_attn_block.launches
    a = run_port(x, p, 16, torch.float32)
    b = run_port(x, p, 16, torch.float32, fn=attn_ops.fused_attn_block_reference)
    np.testing.assert_array_equal(a, b)
    assert attn_ops.fused_attn_block.launches == before   # no kernel launched


def test_wrapper_raises_on_other_devices():
    x = torch.empty((2, 64, 9, 9), device="meta")
    p = [torch.empty(s, device="meta") for s in [(64,)] * 2 + [(64, 64), (64,)] * 4]
    with pytest.raises(ValueError):
        attn_ops.fused_attn_block(x, *p, groups=16)


def test_unsupported_width_routes_to_plain_at_construction(caplog):
    """A shape no kernel takes is routed to the plain versions once, when the
    block is built, with a log line: a width outside the envelope (48) and
    float32 at C 32 (the tiled body is bfloat16 only).  C 32 in bfloat16
    (the nf-32 NCSN++) and the flagship's width keep the kernel."""
    with caplog.at_level(logging.WARNING, logger="rdm_tpu_torch.models.layers"):
        narrow = AttnBlockpp(32, skip_rescale=True, use_kernel=True, dtype=torch.bfloat16,
                             tokens=81)
        odd = AttnBlockpp(48, skip_rescale=True, use_kernel=True, dtype=torch.bfloat16,
                          tokens=81)
        narrow32 = AttnBlockpp(32, skip_rescale=True, use_kernel=True, tokens=81)
        wide = AttnBlockpp(64, skip_rescale=True, use_kernel=True, tokens=81)
    assert narrow.use_kernel and wide.use_kernel
    assert not odd.use_kernel and not narrow32.use_kernel
    logged = [r.getMessage() for r in caplog.records]
    assert len(logged) == 2 and "width 48" in logged[0] and "width 32" in logged[1], logged
    x, _ = make_inputs(2, 48, 9, 9, seed=4)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    before = attn_ops.fused_attn_block.launches
    with torch.no_grad():
        out = odd(xt)
    assert out.shape == xt.shape and torch.isfinite(out.float()).all()
    assert attn_ops.fused_attn_block.launches == before
    model = NCSNpp(nf=32, attn_kernel=True, dtype=torch.bfloat16)
    blocks = [m for m in model.modules() if isinstance(m, AttnBlockpp)]
    assert blocks and all(m.use_kernel for m in blocks)


def test_rows_per_chunk():
    assert attn_ops.rows_per_chunk(64, 81) == 81      # flagship: one chunk
    assert attn_ops.rows_per_chunk(128, 81) == 81
    r = attn_ops.rows_per_chunk(128, 128)
    assert 1 <= r < 128
    # k^T, v, h, and per chunk row one row of q and of scores; plus the
    # kernel's static group statistics
    smem = 4 * (128 * 128 + 128 * 128 + 128 * 129 + r * (129 + 128)) + 2 * 4 * 128
    assert smem <= 232448
    assert attn_ops.rows_per_chunk(128, 128 - 7) >= r


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,groups,H,W", [(1024, 64, 16, 9, 9), (3, 64, 16, 9, 9),
                                            (64, 128, 32, 9, 9), (16, 128, 32, 8, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda_device, B, C, groups, H, W, dtype):
    x, p = make_inputs(B, C, H, W, seed=B + C)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(cuda_device, dtype)
    params = [torch.from_numpy(p[k]).to(cuda_device) for k in ORDER]
    before = attn_ops.fused_attn_block.launches
    out = attn_ops.fused_attn_block(xt, *params, groups=groups)
    ref = attn_ops.fused_attn_block_reference(xt, *params, groups=groups)
    torch.cuda.synchronize()
    assert attn_ops.fused_attn_block.launches == before + 1
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    # float32: summation order only; bfloat16: up to 4 bf16 steps (see above)
    assert err <= (1e-4 if dtype == torch.float32 else 4 * 2.0 ** -8) * scale, err


@pytest.mark.gpu
def test_kernel_rejects_unsupported(cuda_device):
    x, p = make_inputs(2, 32, 9, 9, seed=0)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(cuda_device)
    params = [torch.from_numpy(p[k]).to(cuda_device) for k in ORDER]
    with pytest.raises(ValueError):
        attn_ops.fused_attn_block(xt, *params, groups=8)
    x, p = make_inputs(2, 64, 9, 9, seed=0)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(cuda_device)
    params = [torch.from_numpy(p[k]).to(cuda_device) for k in ORDER]
    with pytest.raises(ValueError):
        attn_ops.fused_attn_block(xt.transpose(2, 3), *params, groups=16)
    with pytest.raises(ValueError):
        attn_ops.fused_attn_block(xt.half(), *params, groups=16)
