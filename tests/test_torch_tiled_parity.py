"""The plain versions of the fused attention block and the fused resblock at
the shapes of DDPM++ on CIFAR-10 and of the nf-32 NCSN++ against the JAX
package's Pallas kernels (interpret mode) on the same seeded inputs: the
attention forward and VJP at C 256, L 256 (16 x 16) and at C 32, L 81, the
resblock at (32, 384 -> 128), (16, 128 -> 256) and (4, 512 -> 256), in
float32 and in bfloat16.  These plain versions are what the tiled CUDA
bodies are held to on the card (``tests/test_torch_tiled_kernels.py``).

The bfloat16 JAX side runs in a process of its own with XLA's excess
precision off, as in ``tests/test_torch_attention_bwd.py``: without it XLA's
CPU compiler keeps some bfloat16 results in float32 and skips the kernels'
roundings.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention_bwd import ORDER, jax_vjp, make_inputs, port_bwd
from test_torch_resblock import jax_kernel
from test_torch_resblock import make_inputs as rb_inputs
from test_torch_resblock import run_port as rb_port

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_STEP = 2.0 ** -8
# (B, C, H, groups): DDPM++'s attention (16 x 16, C 256) and the nf-32 NCSN++'s
ATTN = [(2, 256, 16, 32), (2, 32, 9, 8)]
# (H, C_in, C_out) of DDPM++'s resblocks: the widest input, a widening NIN, the 4 x 4 level
RESBLOCKS = [(32, 384, 128), (16, 128, 256), (4, 512, 256)]
RB_BATCH = 2


def port_attn(x, p, groups, dtype):
    from rdm_tpu_torch.ops import attention as attn_ops
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype)
    out = attn_ops.fused_attn_block_reference(xt, *(torch.from_numpy(p[k]) for k in ORDER),
                                              groups=groups, skip_rescale=True)
    return out.float().numpy().transpose(0, 2, 3, 1)


def jax_attn(x, p, groups, dtype):
    from rdm_tpu.ops.pallas.attention import fused_attn_block
    out = fused_attn_block(jnp.asarray(x, dtype), *(jnp.asarray(p[k]) for k in ORDER),
                           groups=groups, skip_rescale=True, block_b=2, interpret=True)
    return np.asarray(out.astype(jnp.float32))


JAX_BF16_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    sys.path.insert(0, {tests!r})
    from test_torch_tiled_parity import ATTN, RB_BATCH, RESBLOCKS, jax_attn
    from test_torch_attention_bwd import jax_vjp, make_inputs
    from test_torch_resblock import jax_kernel, make_inputs as rb_inputs
    out = {{}}
    for B, C, H, groups in ATTN:
        x, p, g = make_inputs(B, C, H, H, seed=C + H + 1)
        out[f"attn_{{C}}"] = jax_attn(x, p, groups, jnp.bfloat16)
        for i, a in enumerate(jax_vjp(x, p, g, groups, jnp.bfloat16)):
            out[f"vjp_{{C}}_{{i}}"] = np.asarray(a.astype(jnp.float32))
    for H, ci, co in RESBLOCKS:
        x, p, g = rb_inputs(RB_BATCH, H, ci, co, seed=H + ci + co + 1)
        out[f"rb_{{H}}_{{ci}}_{{co}}"] = jax_kernel(x, p, jnp.bfloat16)
    np.savez({path!r}, **out)
""")


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_bf16") / "tiled.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    script = JAX_BF16_SCRIPT.format(tests=os.path.join(ROOT, "tests"), path=path)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(path)


@pytest.mark.parametrize("B,C,H,groups", ATTN)
def test_attention_plain_matches_jax_kernel_f32(B, C, H, groups):
    x, p, _ = make_inputs(B, C, H, H, seed=C + H)
    ours, theirs = port_attn(x, p, groups, torch.float32), jax_attn(x, p, groups, jnp.float32)
    # float32 both sides, same algebra; the sums (up to 256 terms) run in
    # another order: 1e-5 of the output's scale
    scale = max(1.0, float(np.abs(theirs).max()))
    assert np.abs(ours - theirs).max() <= 1e-5 * scale, np.abs(ours - theirs).max()


@pytest.mark.parametrize("B,C,H,groups", ATTN)
def test_attention_plain_matches_jax_kernel_bf16(jax_bf16, B, C, H, groups):
    x, p, _ = make_inputs(B, C, H, H, seed=C + H + 1)
    ours, theirs = port_attn(x, p, groups, torch.bfloat16), jax_bf16[f"attn_{C}"]
    # the same rounding points; a float32 sum next to a bf16 rounding
    # boundary may round the other way on one side: 4 bf16 steps at the
    # output's scale, and nearly every element within one step
    scale = max(1.0, float(np.abs(theirs).max()))
    err = np.abs(ours - theirs)
    assert err.max() <= 4 * BF16_STEP * scale, err.max()
    assert (err <= BF16_STEP * np.maximum(np.abs(theirs), 1.0)).mean() > 0.99


@pytest.mark.parametrize("B,C,H,groups", ATTN)
def test_attention_plain_bwd_matches_jax_vjp_f32(B, C, H, groups):
    x, p, g = make_inputs(B, C, H, H, seed=C + H + 2)
    theirs = [np.asarray(a) for a in jax_vjp(x, p, g, groups, jnp.float32)]
    ours = port_bwd(x, p, g, groups, torch.float32)
    for name, a, b in zip(("dx",) + ORDER, ours, theirs):
        # float32 both sides; the sums over B * 256 tokens run in another
        # order: 1e-5 of each gradient's scale
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= 1e-5 * scale, (name, np.abs(a - b).max(), scale)


@pytest.mark.parametrize("B,C,H,groups", ATTN)
def test_attention_plain_bwd_matches_jax_vjp_bf16(jax_bf16, B, C, H, groups):
    x, p, g = make_inputs(B, C, H, H, seed=C + H + 1)
    ours = port_bwd(x, p, g, groups, torch.bfloat16)
    for i, name in enumerate(("dx",) + ORDER):
        theirs = jax_bf16[f"vjp_{C}_{i}"]
        err = np.abs(ours[i] - theirs)
        scale = max(1.0, float(np.abs(theirs).max()))
        # as tests/test_torch_attention_bwd.py: dx within 4 bf16 steps at its
        # scale and nearly every element within one; the float32 parameter
        # gradients, sums of such values, within one bf16 step of their scale
        if name == "dx":
            assert err.max() <= 4 * BF16_STEP * scale, err.max()
            assert (err <= BF16_STEP * np.maximum(np.abs(theirs), 1.0)).mean() > 0.99
        else:
            assert err.max() <= BF16_STEP * scale, (name, err.max(), scale)


@pytest.mark.parametrize("H,ci,co", RESBLOCKS)
def test_resblock_plain_matches_jax_kernel_f32(H, ci, co):
    x, p, _ = rb_inputs(RB_BATCH, H, ci, co, seed=H + ci + co)
    ours, theirs = rb_port(x, p, torch.float32), jax_kernel(x, p, jnp.float32)
    # float32 both sides; each convolution sums up to 9 * 512 terms in
    # another order: 1e-5 of the output's scale
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("H,ci,co", RESBLOCKS)
def test_resblock_plain_matches_jax_kernel_bf16(jax_bf16, H, ci, co):
    x, p, _ = rb_inputs(RB_BATCH, H, ci, co, seed=H + ci + co + 1)
    ours, theirs = rb_port(x, p, torch.bfloat16), jax_bf16[f"rb_{H}_{ci}_{co}"]
    # as tests/test_torch_resblock.py: one bf16 step at the output's largest
    # value, and at most 2 % of the elements differ at all
    err = np.abs(ours - theirs)
    step = 2.0 ** (np.floor(np.log2(np.abs(theirs).max())) - 7)
    assert err.max() <= step, (err.max(), step)
    assert (ours != theirs).mean() <= 0.02, (ours != theirs).mean()
