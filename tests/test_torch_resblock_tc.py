"""The layouts of the fused resblock's bfloat16 tensor-core kernel.

CPU: the host side the kernel needs, ``ops.resblock.weight_panels`` (the
weights as the stages its ring streams, swizzled) and ``gather_table``
(each token row's neighbour row per tap, or the zero row), read by a plain
PyTorch consumer that forms the products as the kernel does, stage by
stage and row by gathered row; held against ``F.conv2d`` and against the
JAX Pallas ``_kernel`` in interpret mode (float32, so that only the
layouts and the order of the sums differ).  The kernel's geometry lives in
its source; the CPU tests take a copy of its groups (``GROUPS``).
Card (marker ``gpu``): ``resblock_plan`` (the built library's plan) against
that copy, the shared-memory limit and the samples it promises; the kernel
against its plain version at the eight flagship shapes, at B 1024, 3, a
batch that no persistent grid divides (1025) and 4096 (every ring stage
refilled many times).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rdm_tpu.ops.pallas.resblock import fused_resblock as jax_fused_resblock
from rdm_tpu_torch.ops import _build
from rdm_tpu_torch.ops import resblock as rb_ops

torch.set_num_threads(1)  # the suite runs in parallel worker processes

FLAGSHIP_SHAPES = [(9, 64, 64), (4, 64, 128), (4, 128, 128), (2, 128, 128), (2, 256, 128),
                   (4, 256, 128), (9, 192, 64), (9, 128, 64)]
BF16_STEP = 2.0 ** -8
# samples and padded token rows of a group of the bfloat16 kernel, by H
# (csrc/fused_resblock.cu: Tc; the plan test holds the library to it)
GROUPS = {9: (4, 384), 4: (8, 128), 2: (16, 64)}
FLAGSHIP_COUNTS = {(9, 64, 64): 2, (4, 64, 128): 1, (4, 128, 128): 1, (2, 128, 128): 4,
                   (2, 256, 128): 3, (4, 256, 128): 3, (9, 192, 64): 1, (9, 128, 64): 2}


def groups(c):
    return min(c // 4, 32)


def weight_stages(ci, co):
    """Stages of C_out x 64 weights a group consumes: the NIN's, conv0's and
    conv1's, 64 input channels each (a tap at a time for the convolutions)."""
    return (ci // 64 if ci != co else 0) + 9 * ci // 64 + 9 * co // 64


def make_params(H, ci, co, seed, B=None):
    """Module-layout float32 parameters (None for an absent NIN), and x,
    tembv for B samples."""
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g)
    params = [1 + 0.1 * f(ci), 0.1 * f(ci), f(co, ci, 3, 3) / math.sqrt(9 * ci), 0.1 * f(co),
              1 + 0.1 * f(co), 0.1 * f(co), f(co, co, 3, 3) / math.sqrt(9 * co), 0.1 * f(co)]
    params += [f(ci, co) / math.sqrt(ci), 0.1 * f(co)] if ci != co else [None, None]
    if B is None:
        return params
    return f(B, ci, H, H), 0.5 * f(B, co), params


def logical_stage(panel):
    """A stage (C_out, 64) as the kernel's ldmatrix reads it: logical chunk
    j of output channel n from slot j ^ (n % 8)."""
    co = panel.shape[0]
    n = torch.arange(co)[:, None]
    return panel.reshape(co, 8, 8)[n, torch.arange(8)[None, :] ^ (n % 8)].reshape(co, 64)


def implicit_gemm(rows, panels, table, first, taps):
    """The kernel's product on its own layouts: ``rows`` (R + 1, C) token-
    major activations whose row R is zero; for each tap the rows the table
    gives, times the stages from ``first`` on (C / 64 of them a tap), summed
    in float32.  taps == 1 is the NIN over the centre tap.  Returns the (R,
    C_out) sums and the next stage."""
    R, c = table.shape[1], rows.shape[1]
    acc = torch.zeros(R, panels.shape[1])
    stage = first
    for t in range(taps):
        a = rows[table[4 if taps == 1 else t].long()]
        for c0 in range(0, c, 64):
            acc += a[:, c0:c0 + 64] @ logical_stage(panels[stage]).t()
            stage += 1
    return acc, stage


def token_rows(x, rows):
    """NCHW samples as the kernel's token-major rows, padded to ``rows``,
    plus the zero row."""
    B, C = x.shape[:2]
    t = x.reshape(B, C, -1).transpose(1, 2).reshape(-1, C)
    return torch.cat([t, torch.zeros(rows + 1 - t.shape[0], C)])


@pytest.mark.parametrize("H", [9, 4, 2])
def test_gather_table_points_at_neighbours_or_the_zero_row(H):
    samples, plan_rows = GROUPS[H]
    table = rb_ops.gather_table_np(H, samples, plan_rows)
    L = H * H
    assert table.shape == (9, plan_rows) and table.dtype == np.int16
    for r in range(plan_rows):
        for t in range(9):
            dy, dx = t // 3 - 1, t % 3 - 1
            s, p = divmod(r, L)
            y, x = divmod(p, H)
            inside = r < samples * L and 0 <= y + dy < H and 0 <= x + dx < H
            assert table[t, r] == (s * L + (y + dy) * H + x + dx if inside else plan_rows)
    assert (table[4, :samples * L] == np.arange(samples * L)).all()


@pytest.mark.parametrize("H,ci,co", [(9, 192, 64), (4, 64, 128), (2, 256, 128), (9, 64, 64)])
def test_panels_and_table_give_the_convolutions(H, ci, co):
    """The plain consumer of the kernel's layouts against F.conv2d (both
    convolutions, the NIN against its einsum), float32."""
    samples, rows = GROUPS[H]
    x, _, params = make_params(H, ci, co, seed=H + ci + co, B=samples)
    panels = rb_ops.weight_panels(params[2], params[6], params[8])
    assert panels.shape == (weight_stages(ci, co), co, 64)
    table = torch.from_numpy(rb_ops.gather_table_np(H, samples, rows))
    L = H * H
    stage = 0
    if ci != co:
        nin, stage = implicit_gemm(token_rows(x, rows), panels, table, 0, 1)
        want = torch.einsum("bchw,cd->bhwd", x, params[8]).reshape(-1, co)
        torch.testing.assert_close(nin[:samples * L], want, rtol=1e-5, atol=1e-5)
    conv0, stage = implicit_gemm(token_rows(x, rows), panels, table, stage, 9)
    want = F.conv2d(x, params[2], padding=1).permute(0, 2, 3, 1).reshape(-1, co)
    torch.testing.assert_close(conv0[:samples * L], want, rtol=1e-5, atol=1e-5)
    h = torch.randn(samples, co, H, H, generator=torch.Generator().manual_seed(7))
    conv1, stage = implicit_gemm(token_rows(h, rows), panels, table, stage, 9)
    want = F.conv2d(h, params[6], padding=1).permute(0, 2, 3, 1).reshape(-1, co)
    torch.testing.assert_close(conv1[:samples * L], want, rtol=1e-5, atol=1e-5)
    assert stage == weight_stages(ci, co)
    # rows past the samples (where the group has any) gather only the zero row
    assert bool((conv0[samples * L:] == 0).all())


def block_on_kernel_layouts(x, tembv, params, groups0, groups1, rescale):
    """The whole block as the kernel computes it for one group, on its
    layouts (float32, so the rounding points are identities): the shortcut,
    GroupNorm_0 and SiLU, conv0 + b0 + tembv, GroupNorm_1 and SiLU, conv1 +
    b1, the residual; NCHW out."""
    B, ci, H, _ = x.shape
    co = params[2].shape[0]
    L = H * H
    rows = GROUPS[H][1]
    panels = rb_ops.weight_panels(params[2], params[6], params[8])
    table = torch.from_numpy(rb_ops.gather_table_np(H, B, rows))

    def gn_silu(t, groups, scale, bias):
        tg = t.reshape(B, groups, -1)
        mu = tg.mean(-1, keepdim=True)
        var = (tg * tg).mean(-1, keepdim=True) - mu * mu
        hh = ((tg - mu) * torch.rsqrt(var + rb_ops.GN_EPS)).reshape(t.shape)
        return F.silu(hh * scale[None, :, None, None] + bias[None, :, None, None])

    stage = 0
    if params[8] is None:
        xs = x.permute(0, 2, 3, 1).reshape(-1, ci)
    else:
        xs, stage = implicit_gemm(token_rows(x, rows), panels, table, 0, 1)
        xs = xs[:B * L] + params[9]
    a0 = gn_silu(x, groups0, params[0], params[1])
    h, stage = implicit_gemm(token_rows(a0, rows), panels, table, stage, 9)
    h = (h[:B * L] + params[3]).reshape(B, L, co) + tembv[:, None, :]
    a1 = gn_silu(h.transpose(1, 2).reshape(B, co, H, H), groups1, params[4], params[5])
    h2, stage = implicit_gemm(token_rows(a1, rows), panels, table, stage, 9)
    out = (xs + h2[:B * L] + params[7]) * rescale
    return out.reshape(B, H, H, co).permute(0, 3, 1, 2)


@pytest.mark.parametrize("H,ci,co", [(9, 64, 64), (9, 192, 64), (4, 64, 128), (2, 256, 128)])
def test_block_on_kernel_layouts_matches_jax_kernel_f32(H, ci, co):
    """A ragged group (fewer samples than the kernel's group holds)."""
    B = GROUPS[H][0] - 1
    x, tembv, params = make_params(H, ci, co, seed=3 * H + ci + co, B=B)
    ours = block_on_kernel_layouts(x, tembv, params, groups(ci), groups(co), 1 / math.sqrt(2.0))
    hwio = lambda p: None if p is None else jnp.asarray(
        (p.permute(2, 3, 1, 0) if p.dim() == 4 else p).numpy())
    jargs = [jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(tembv.numpy())]
    jargs += [hwio(p) for p in params]
    fn = jax.jit(functools.partial(jax_fused_resblock, groups0=groups(ci), groups1=groups(co),
                                   skip_rescale=True, block_b=4, interpret=True))
    theirs = np.asarray(fn(*jargs)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4)
    # and against the plain version the wrapper runs on the CPU
    ref = rb_ops.fused_resblock_reference(x, tembv, *params, groups0=groups(ci),
                                          groups1=groups(co))
    torch.testing.assert_close(ours, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("H,ci,co", FLAGSHIP_SHAPES)
def test_panels_hold_each_stage_in_the_rings_order(H, ci, co):
    """Stage by stage, the panels are the NIN's (C_in / 64 stages), then
    conv0's and conv1's tap by tap (tap (dy + 1) * 3 + (dx + 1)), 64 input
    channels a stage, each output channel's row swizzled by its index."""
    params = make_params(H, ci, co, seed=5 * H + ci + co)
    panels = rb_ops.weight_panels(params[2], params[6], params[8])
    want = [] if params[8] is None else [params[8][c0:c0 + 64].t() for c0 in range(0, ci, 64)]
    for w in (params[2], params[6]):
        want += [w[:, c0:c0 + 64, t // 3, t % 3] for t in range(9) for c0 in range(0, w.shape[1], 64)]
    assert len(want) == panels.shape[0] == weight_stages(ci, co)
    for stage, w in zip(panels, want):
        assert torch.equal(logical_stage(stage), w)


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def modeled_weight_bytes(plan, B, sms):
    """Weight bytes a launch reads from L2 by the plan: once per persistent
    block where the stages stay resident, once per group where they stream."""
    groups = -(-B // plan.samples)
    return (min(groups, sms) if plan.resident else groups) * plan.weight_stages * plan.stage_bytes


@pytest.mark.gpu
@pytest.mark.parametrize("H,ci,co", FLAGSHIP_SHAPES)
def test_plan_fits_and_reads_less_weight_than_one_block_a_sample_group(cuda_device, H, ci, co):
    """The plan lives in the kernel's source (the library builds with nvcc)."""
    plan = rb_ops.resblock_plan(H, ci, co)
    assert (plan.samples, plan.rows) == GROUPS[H]
    assert plan.smem_bytes <= _build.SMEM_LIMIT
    assert 1 <= plan.stages <= plan.weight_stages == weight_stages(ci, co)
    assert plan.resident == ((H, ci, co) == (9, 64, 64))
    assert plan.rows % 16 == 0 and plan.rows >= plan.samples * H * H
    weights = plan.weight_stages * plan.stage_bytes
    assert weights == 2 * (9 * ci * co + 9 * co * co + (ci * co if ci != co else 0))
    # a group of several samples streams the weights once (once per block
    # where resident), not once per sample
    assert plan.samples >= 4
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert modeled_weight_bytes(plan, 1024, sms) <= -(-1024 // plan.samples) * weights


@pytest.mark.gpu
def test_plans_read_under_1_1_gb_of_weights_per_forward(cuda_device):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    total = sum(n * modeled_weight_bytes(rb_ops.resblock_plan(*k), 1024, sms)
                for k, n in FLAGSHIP_COUNTS.items())
    assert total < 1.1e9      # the scalar kernel read 2.78 GB


@pytest.mark.gpu
@pytest.mark.parametrize("H,ci,co", FLAGSHIP_SHAPES)
@pytest.mark.parametrize("B", [1024, 3, 1025, 4096])
def test_tc_kernel_matches_plain(cuda_device, H, ci, co, B):
    x, tembv, params = make_params(H, ci, co, seed=B + H + ci + co, B=B)
    x, tembv = x.to(cuda_device, torch.bfloat16), tembv.to(cuda_device, torch.bfloat16)
    params = [None if p is None else p.to(cuda_device) for p in params]
    kw = dict(groups0=groups(ci), groups1=groups(co))
    before = rb_ops.fused_resblock.launches
    out = rb_ops.fused_resblock(x, tembv, *params, **kw)
    again = rb_ops.fused_resblock(x, tembv, *params, **kw)
    ref = rb_ops.fused_resblock_reference(x, tembv, *params, **kw)
    torch.cuda.synchronize()
    assert rb_ops.fused_resblock.launches == before + 2
    assert torch.equal(out, again)
    assert bool(torch.isfinite(out.float()).all())
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    # the same rounding points; a sum next to a rounding boundary may round
    # the other way and carry a step on: 4 bf16 steps at the output's scale
    assert err <= 4 * BF16_STEP * scale, err
