"""The tiled bodies of the fused attention block (forward and backward) and
of the fused resblock: the shapes of DDPM++ on CIFAR-10 and of the nf-32
NCSN++, where one sample does not fit a block's shared memory.

CPU: which body each shape takes, the envelope the routing reads, the tiled
plans (launches, grids, shared memory within 227 KB) at every DDPM++ and
nf-32 shape, and the routing of both configs when the model is built (every
block keeps its kernel, no log line).  Card (marker ``gpu``): each tiled
kernel against its plain version at those shapes, the backward twice bit
for bit, and the built libraries' plans against the ones computed here.
This file imports no JAX: the card's machine runs it.
"""
import logging
import math

import numpy as np
import pytest
import torch

from rdm_tpu_torch.config import load_config
from rdm_tpu_torch.models import create_model
from rdm_tpu_torch.models.layers import AttnBlockpp, ResnetBlockDDPMpp
from rdm_tpu_torch.ops import _build
from rdm_tpu_torch.ops import attention as attn_ops
from rdm_tpu_torch.ops import resblock as rb_ops

torch.set_num_threads(1)  # the suite runs in parallel worker processes

BF16_STEP = 2.0 ** -8
DDPMPP = ["data=cifar10", "model=ddpmpp", "model.precision=bfloat16", "model.attn_pallas=true",
          "model.resblock_pallas=true"]
NF32 = ["model.nf=32", "model.precision=bfloat16", "model.attn_pallas=true",
        "model.resblock_pallas=true"]
# (H, C_in, C_out) -> count: DDPM++'s 70 resblocks a forward
DDPMPP_RESBLOCKS = {(32, 128, 128): 8, (32, 256, 128): 8, (32, 384, 128): 1,
                    (16, 128, 256): 1, (16, 256, 256): 7, (16, 512, 256): 9,
                    (8, 256, 256): 8, (8, 512, 256): 9, (4, 256, 256): 10, (4, 512, 256): 9}
# the nf-32 NCSN++'s 17 resblocks
NF32_RESBLOCKS = {(9, 32, 32): 2, (9, 64, 32): 2, (9, 96, 32): 1, (4, 32, 64): 1,
                  (4, 64, 64): 1, (4, 128, 64): 3, (2, 64, 64): 4, (2, 128, 64): 3}
# (C, L, groups) of the attention blocks: DDPM++ (17 a forward), nf 32 (5)
ATTN_SHAPES = {"ddpmpp": (256, 256, 32), "nf32": (32, 81, 8)}


def groups(c):
    return min(c // 4, 32)


def resblock_shapes(model):
    """(nominal H, C_in, C_out) -> count over the model's resblocks, each at
    the resolution of its level."""
    levels, n = len(model.ch_mult), model.num_res_blocks
    located = [(b, i // n) for i, b in enumerate(model.down_blocks)]
    located += [(model.mid_block1, levels - 1), (model.mid_block2, levels - 1)]
    located += [(b, levels - 1 - i // (n + 1)) for i, b in enumerate(model.up_blocks)]
    out = {}
    for b, level in located:
        key = (model._resolution(level), b.Conv_0.weight.shape[1], b.Conv_0.weight.shape[0])
        out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("C,L,dtype,body", [
    (256, 256, torch.bfloat16, "tiled"), (32, 81, torch.bfloat16, "tiled"),
    (64, 256, torch.bfloat16, "tiled"), (128, 129, torch.bfloat16, "tiled"),
    (128, 128, torch.bfloat16, "scalar"), (64, 81, torch.bfloat16, "tensor_cores"),
    (64, 81, torch.float32, "scalar")])
def test_attention_body_of_each_shape(C, L, dtype, body):
    assert attn_ops.attn_body(C, L, dtype) == body


@pytest.mark.parametrize("C,L,dtype", [(32, 81, torch.float32), (256, 256, torch.float32),
                                       (48, 81, torch.bfloat16), (256, 257, torch.bfloat16),
                                       (512, 16, torch.bfloat16)])
def test_attention_envelope_excludes(C, L, dtype):
    with pytest.raises(ValueError):
        attn_ops.attn_body(C, L, dtype)


@pytest.mark.parametrize("B", [64, 3, 1])
@pytest.mark.parametrize("which", sorted(ATTN_SHAPES))
def test_attention_tiled_plan(which, B):
    """The tiled attention's plan at the configs' shapes: shared memory
    within a block's 227 KB, every query row in a tile, the keys padded to
    16 and inside the instantiated key tiles, the weight gradients' splits
    covering every token row once, and the products' grids."""
    C, L, _ = ATTN_SHAPES[which]
    plan = attn_ops.tiled_plan(B, C, L)
    assert max(plan.fwd_smem_bytes, plan.bwd_smem_bytes) <= _build.SMEM_LIMIT
    assert plan.query_tiles * attn_ops.TILED_QUERY_ROWS >= L
    assert plan.padded_tokens % 16 == 0 and L <= plan.padded_tokens < L + 16
    assert plan.padded_tokens <= 16 * plan.key_tiles
    rows = B * plan.padded_tokens
    assert plan.grad_chunk % 32 == 0 and plan.grad_splits <= 64
    assert (plan.grad_splits - 1) * plan.grad_chunk < rows <= plan.grad_splits * plan.grad_chunk
    t = lambda n: -(-n // 64)
    assert plan.gemm_tiles[0] == (t(L), t(3 * C)) and plan.gemm_tiles[7] == (t(C + 1), t(3 * C))
    assert all(g == (t(L), t(C)) for g in plan.gemm_tiles[1:7])
    if which == "ddpmpp":
        assert (plan.fwd_smem_bytes, plan.bwd_smem_bytes) == (168960, 202752)
        assert (plan.query_tiles, plan.key_tiles, plan.padded_tokens) == (4, 16, 256)
    else:
        assert (plan.query_tiles, plan.key_tiles, plan.padded_tokens) == (2, 8, 96)


def test_resblock_body_of_each_shape():
    for H, ci, co in [*DDPMPP_RESBLOCKS, *NF32_RESBLOCKS]:
        assert rb_ops.resblock_body(H, H, ci, co, torch.bfloat16) == "tiled", (H, ci, co)
        assert rb_ops.route(H, H, ci, co, torch.bfloat16) is rb_ops.fused_resblock
        with pytest.raises(ValueError):
            rb_ops.resblock_body(H, H, ci, co, torch.float32)
        assert rb_ops.route(H, H, ci, co, torch.float32) is rb_ops.fused_resblock_reference
    assert rb_ops.resblock_body(9, 9, 64, 64, torch.bfloat16) == "tensor_cores"
    assert rb_ops.resblock_body(9, 9, 64, 64, torch.float32) == "scalar"
    for H, ci, co in [(9, 64, 48), (128, 64, 64)]:
        assert rb_ops.route(H, H, ci, co, torch.bfloat16) is rb_ops.fused_resblock_reference


@pytest.mark.parametrize("B", [64, 3])
@pytest.mark.parametrize("H,ci,co", [*DDPMPP_RESBLOCKS, *NF32_RESBLOCKS])
def test_resblock_tiled_plan(H, ci, co, B):
    """Grids of the tiled resblock: each convolution covers B H W token rows
    and C_out columns in 64 x 64 tiles, the NIN (where the width changes)
    a sample's tokens per z; one GroupNorm block a (sample, group); the
    GEMM's shared memory (one stage of A and of B) is static, 10 KB."""
    plan = rb_ops.tiled_resblock_plan(B, H, ci, co, groups(ci), groups(co))
    t = lambda n: -(-n // 64)
    assert plan.launches == (5 if ci != co else 4)
    assert plan.conv0_grid == plan.conv1_grid == (t(B * H * H), t(co), 1)
    assert plan.nin_grid == ((t(H * H), t(co), B) if ci != co else (0, 0, 0))
    assert (plan.gn0_blocks, plan.gn1_blocks) == (B * groups(ci), B * groups(co))
    assert plan.conv0_grid[0] * 64 >= B * H * H > (plan.conv0_grid[0] - 1) * 64
    assert plan.gemm_smem_bytes == 10240 <= 48 * 1024 <= _build.SMEM_LIMIT


def test_ddpmpp_routes_every_block_to_the_kernels(caplog):
    """model=ddpmpp with both kernels on, bfloat16: all 17 attention blocks
    (C 256, 16 x 16) and all 70 resblocks keep their kernels, with no
    routing log line."""
    with caplog.at_level(logging.WARNING):
        model = create_model(load_config("train", DDPMPP))
    attn = [m for m in model.modules() if isinstance(m, AttnBlockpp)]
    assert len(attn) == 17 and all(m.use_kernel for m in attn)
    assert {m.NIN_0.W.shape[0] for m in attn} == {256}
    assert resblock_shapes(model) == DDPMPP_RESBLOCKS
    assert all(m.use_kernel and m.fused_forward is rb_ops.fused_resblock
               for m in model.modules() if isinstance(m, ResnetBlockDDPMpp))
    assert not [r for r in caplog.records if "kernel" in r.getMessage()]
    assert sum(p.numel() for p in model.parameters()) == 104_701_571


def test_nf32_routes_every_block_to_the_kernels(caplog):
    with caplog.at_level(logging.WARNING):
        model = create_model(load_config("train", NF32))
    attn = [m for m in model.modules() if isinstance(m, AttnBlockpp)]
    assert len(attn) == 5 and all(m.use_kernel for m in attn)
    assert resblock_shapes(model) == NF32_RESBLOCKS
    assert all(m.use_kernel and m.fused_forward is rb_ops.fused_resblock
               for m in model.modules() if isinstance(m, ResnetBlockDDPMpp))
    assert not caplog.records


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def attn_case(B, C, L, seed, device):
    rng = np.random.default_rng(seed)
    to = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    x = to(rng.normal(size=(B, C, 1, L))).to(torch.bfloat16)
    g = to(rng.normal(size=(B, C, 1, L))).to(torch.bfloat16)
    p = [1.0 + 0.1 * rng.normal(size=C), 0.1 * rng.normal(size=C)]
    for _ in range(4):
        p += [rng.normal(size=(C, C)) / math.sqrt(C), 0.1 * rng.normal(size=C)]
    return x, g, [to(a) for a in p]


ATTN_CASES = [(64, 256, 256, 32), (3, 256, 256, 32), (64, 32, 81, 8), (5, 32, 81, 8),
              (4, 128, 200, 32), (2, 64, 256, 16), (3, 256, 49, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,L,G", ATTN_CASES)
def test_tiled_attention_matches_plain(cuda_device, B, C, L, G):
    x, _, params = attn_case(B, C, L, B + C + L, cuda_device)
    assert attn_ops.attn_body(C, L, torch.bfloat16) == "tiled"
    before = attn_ops.fused_attn_block_tiled.launches
    out = attn_ops.fused_attn_block(x, *params, groups=G)
    ref = attn_ops.fused_attn_block_reference(x, *params, groups=G)
    torch.cuda.synchronize()
    assert attn_ops.fused_attn_block_tiled.launches == before + 1
    err = (out.float() - ref.float()).abs()
    scale = max(1.0, float(ref.float().abs().max()))
    # the same rounding points; a float32 sum next to a bf16 rounding
    # boundary rounds the other way and carries a step on: 4 bf16 steps at
    # the output's scale, and nearly every element within one step
    assert float(err.max()) <= 4 * BF16_STEP * scale, float(err.max())
    assert float((err <= BF16_STEP * ref.float().abs().clamp(min=1.0)).float().mean()) > 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("B,C,L,G", ATTN_CASES)
def test_tiled_attention_bwd_matches_plain(cuda_device, B, C, L, G):
    x, g, params = attn_case(B, C, L, B + C + L + 1, cuda_device)
    before = attn_ops.fused_attn_block_bwd_tiled.launches
    ours = attn_ops.fused_attn_block_bwd(x, g, *params, groups=G)
    again = attn_ops.fused_attn_block_bwd(x, g, *params, groups=G)
    ref = attn_ops.fused_attn_block_bwd_reference(x, g, *params, groups=G)
    torch.cuda.synchronize()
    assert attn_ops.fused_attn_block_bwd_tiled.launches == before + 2
    scales = [max(1.0, float(c.float().abs().max())) for c in ref]
    # dbk is zero in exact arithmetic (softmax ignores a shift that all keys
    # share): both versions return the summed rounding noise of B L values of
    # dk, whose size is that of dq, so it is held to the scale of dbq
    scales[6] = max(scales[6], scales[4])
    for name, a, b, c, scale in zip(("dx",) + attn_ops.PARAM_NAMES, ours, again, ref, scales):
        assert torch.equal(a, b), name                      # fixed summation order
        assert a.shape == c.shape and a.dtype == c.dtype, name
        err = float((a.float() - c.float()).abs().max())
        # dx: 4 bf16 steps at its scale; the float32 parameter gradients are
        # sums of such values: one bf16 step of their scale
        tol = (4 if name == "dx" else 1) * BF16_STEP * scale
        assert err <= tol, (name, err, scale)


RB_CASES = [(8, H, ci, co) for H, ci, co in DDPMPP_RESBLOCKS] + \
           [(64, H, ci, co) for H, ci, co in NF32_RESBLOCKS] + [(3, 32, 384, 128), (5, 9, 96, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,ci,co", RB_CASES)
def test_tiled_resblock_matches_plain(cuda_device, B, H, ci, co):
    rng = np.random.default_rng(B + H + ci + co)
    to = lambda *s, sc=1.0, off=0.0: torch.tensor(
        (off + sc * rng.normal(size=s)).astype(np.float32), device=cuda_device)
    x = to(B, ci, H, H).to(torch.bfloat16)
    tv = to(B, co, sc=0.5).to(torch.bfloat16)
    params = [to(ci, off=1.0, sc=0.1), to(ci, sc=0.1), to(co, ci, 3, 3, sc=1 / math.sqrt(9 * ci)),
              to(co, sc=0.1), to(co, off=1.0, sc=0.1), to(co, sc=0.1),
              to(co, co, 3, 3, sc=1 / math.sqrt(9 * co)), to(co, sc=0.1)]
    params += [to(ci, co, sc=1 / math.sqrt(ci)), to(co, sc=0.1)] if ci != co else [None, None]
    kw = dict(groups0=groups(ci), groups1=groups(co), skip_rescale=True)
    assert rb_ops.resblock_body(H, H, ci, co, torch.bfloat16) == "tiled"
    before = rb_ops.fused_resblock_tiled.launches
    out = rb_ops.fused_resblock(x, tv, *params, **kw)
    again = rb_ops.fused_resblock(x, tv, *params, **kw)
    ref = rb_ops.fused_resblock_reference(x, tv, *params, **kw)
    torch.cuda.synchronize()
    assert rb_ops.fused_resblock_tiled.launches == before + 2 and torch.equal(out, again)
    err = (out.float() - ref.float()).abs()
    scale = max(1.0, float(ref.float().abs().max()))
    # the same rounding points as the plain version: 4 bf16 steps at the
    # output's largest magnitude, nearly every element within one step
    assert float(err.max()) <= 4 * BF16_STEP * scale, float(err.max())
    assert float((err <= BF16_STEP * ref.float().abs().clamp(min=1.0)).float().mean()) > 0.99


@pytest.mark.gpu
def test_built_plans_match(cuda_device):
    for C, L, G in ATTN_SHAPES.values():
        for B in (64, 3):
            assert attn_ops.built_tiled_plan(B, C, L, G) == tuple(attn_ops.tiled_plan(B, C, L)[:9])
    for H, ci, co in [*DDPMPP_RESBLOCKS, *NF32_RESBLOCKS]:
        for B in (64, 3):
            ours = rb_ops.tiled_resblock_plan(B, H, ci, co, groups(ci), groups(co)).flat()
            assert rb_ops.built_tiled_resblock_plan(B, H, ci, co, groups(ci), groups(co)) == ours


@pytest.mark.gpu
def test_tiled_wrappers_refuse(cuda_device):
    x, _, params = attn_case(2, 256, 256, 0, cuda_device)
    with pytest.raises(ValueError):
        attn_ops.fused_attn_block(x.float(), *params, groups=32)     # float32 at C 256
    x, _, params = attn_case(2, 64, 81, 0, cuda_device)
    with pytest.raises(ValueError):                                  # the tensor-core body's
        attn_ops.fused_attn_block_tiled(x, *params, groups=16)
    with pytest.raises(ValueError):
        rb_ops.fused_resblock_tiled(torch.zeros(2, 64, 9, 9, device=cuda_device),
                                    torch.zeros(2, 64, device=cuda_device),
                                    *[torch.zeros(s, device=cuda_device) for s in
                                      [(64,), (64,), (64, 64, 3, 3), (64,), (64,), (64,),
                                       (64, 64, 3, 3), (64,)]], None, None,
                                    groups0=16, groups1=16)
