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
import os

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


def check_gemm_plan(plan, M, N, K, conv_H=None, a_mn=False, samples=None, max_splits=16):
    """A product's plan on the Hopper GEMM: its tiles cover M and N (per
    sample where ``samples`` is given: M rows of each of them), its splits
    cover K's stages once, on tap and 64-channel-chunk boundaries, at most
    ``max_splits`` of them, its shared memory fits a block, and its A box is
    a legal TMA box: K-major 64 x 128 rows, MN-major (``a_mn``) 64 x 64 K
    rows (two a stage), or the convolution's (64, W, nh, nb)."""
    cdiv = lambda a, b: -(-a // b)
    assert plan.bm == 128 and plan.bn in (64, 128) and (plan.bn == 128) == (N >= 128)
    assert plan.tiles_n * plan.bn >= N > (plan.tiles_n - 1) * plan.bn
    taps = 9 if conv_H else 1
    assert K % taps == 0 and plan.steps == taps * cdiv(K // taps, 64)
    assert plan.chunk >= 1 and (plan.splits - 1) * plan.chunk < plan.steps <= plan.splits * plan.chunk
    assert plan.splits == 1 or (2 * plan.tiles_m * plan.tiles_n < 132
                                and plan.splits <= max_splits)
    assert plan.blocks == min(plan.tiles_m * plan.tiles_n * plan.splits, 132)
    assert plan.smem_bytes <= _build.SMEM_LIMIT and plan.stages >= 3
    box = plan.box
    assert box[0] * 2 == 128 and all(1 <= d <= 256 for d in box)   # one 128-byte swizzle row
    if conv_H:
        H = conv_H
        B = M // (H * H)
        _, W, nh, nb = box
        assert W == H and nh * W * nb <= 128 and (nb == 1 or nh == H)
        # the tiles are nh whole image rows of one sample, or nb whole samples
        assert plan.tiles_m == cdiv(B, nb) * cdiv(H, nh)
        assert nb * H * H >= min(128, H * H) or nh * W >= 128 - W
    else:
        assert box[1:] == ((64, 1, 1) if a_mn else (128, 1, 1))
        assert plan.tiles_m == (samples or 1) * cdiv(M, 128)
    # every stride of the tensor maps is a multiple of 16 bytes
    assert (K // taps) * 2 % 16 == 0 or samples


def source_launches(function: str) -> dict:
    """The launches that ``function`` of ``csrc/fused_attn_block_tiled.cu``
    makes, counted in its text: kernel launches, the backward's products, the
    ds kernel, the forward's first three launches, and its clock marks."""
    src = open(os.path.join(_build.CSRC_DIR, "fused_attn_block_tiled.cu")).read()
    body = src[src.index(f"int {function}("):]
    body = body[:body.index("\n}\n")]
    return {"kernels": body.count("<<<"), "products": body.count("bwd_product<"),
            "ds": body.count("dispatch_ds("), "forward_core": body.count("forward_core("),
            "marks": body.count("clock.mark()")}


@pytest.mark.parametrize("B", [64, 3, 1])
@pytest.mark.parametrize("which", sorted(ATTN_SHAPES))
def test_attention_tiled_plan(which, B):
    """The tiled attention's plan at the configs' shapes: shared memory
    within a block's 227 KB, every query row in a 128-row tile of both
    attention kernels, the keys padded to 16 and inside the key tiles they
    are built for; every product on the Hopper GEMM: the forward's two and
    the backward's do and dh over all B Lp rows, dq, dk and dv per sample
    (dk's and dv's A MN-major), none of them split, and the weight gradients
    (both operands MN-major) with K over every sample's 64-token stages,
    split; the backward's launch count as the source counts it."""
    C, L, _ = ATTN_SHAPES[which]
    cdiv = lambda a, b: -(-a // b)
    plan = attn_ops.tiled_plan(B, C, L)
    assert max(plan.fwd_smem_bytes, plan.ds_smem_bytes) <= _build.SMEM_LIMIT
    assert plan.query_tiles * attn_ops.TILED_FWD_ROWS >= L > (plan.query_tiles - 1) * 128
    assert plan.padded_tokens % 16 == 0 and L <= plan.padded_tokens < L + 16
    assert plan.key_tiles in (1, 2, 4) and L <= 64 * plan.key_tiles
    assert plan.threads == 288
    rows = B * plan.padded_tokens
    check_gemm_plan(plan.qkv, rows, 3 * C, C)
    check_gemm_plan(plan.proj, rows, C, C)
    check_gemm_plan(plan.do, rows, C, C, max_splits=1)
    for p, a_mn in ((plan.dq, False), (plan.dk, True), (plan.dv, True)):
        check_gemm_plan(p, L, C, L, a_mn=a_mn, samples=B, max_splits=1)
    check_gemm_plan(plan.dh, rows, C, 3 * C, max_splits=1)
    for p, N in ((plan.dwqkv, 3 * C), (plan.dwp, C)):
        check_gemm_plan(p, C, N, B * 64 * cdiv(L, 64), a_mn=True,
                        max_splits=attn_ops.TILED_GRAD_SPLITS)
    splits = (plan.qkv.splits > 1) + (plan.proj.splits > 1)
    assert plan.fwd_launches == 4 + splits and plan.bwd_launches == 14 + (plan.qkv.splits > 1)
    n = source_launches("rdm_attn_tiled_bwd")
    assert plan.bwd_launches == 3 * n["forward_core"] + n["kernels"] + n["products"] + n["ds"] \
        + (plan.qkv.splits > 1)
    assert n["marks"] == len(attn_ops.TILED_BWD_PARTS) + 1
    assert len(plan.flat()) == 8 + 9 * 14
    if which == "ddpmpp":
        assert (plan.fwd_smem_bytes, plan.ds_smem_bytes) == (164928, 197696)
        assert (plan.query_tiles, plan.key_tiles, plan.padded_tokens) == (2, 4, 256)
    else:
        assert (plan.query_tiles, plan.key_tiles, plan.padded_tokens) == (1, 2, 96)
    if B == 64:
        # the weight gradients' splits fill the card
        assert plan.dwqkv.blocks >= 96 and plan.dwp.blocks >= 64


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


@pytest.mark.parametrize("B", [64, 3, 1])
@pytest.mark.parametrize("H,ci,co", [*DDPMPP_RESBLOCKS, *NF32_RESBLOCKS])
def test_resblock_tiled_plan(H, ci, co, B):
    """The tiled resblock's products on the Hopper GEMM: each convolution's
    tiles cover B H W token rows and C_out columns (whole image rows of a
    sample, or whole samples, in a 4-D TMA box), its split-K chunks cover K
    = 9 C_in once on tap and channel-chunk boundaries, the NIN (where the
    width changes) a plain product of K = C_in; shared memory within a
    block's; GroupNorm blocks of whole groups of a sample, 16 channels a
    block where the groups are narrower; at B 64 the tiles or their splits
    fill at least 96 of the 132 SMs."""
    plan = rb_ops.tiled_resblock_plan(B, H, ci, co, groups(ci), groups(co))
    M = B * H * H
    check_gemm_plan(plan.conv0, M, co, 9 * ci, conv_H=H)
    check_gemm_plan(plan.conv1, M, co, 9 * co, conv_H=H)
    if ci != co:
        check_gemm_plan(plan.nin, M, co, ci)
    else:
        assert plan.nin.flat() == (0,) * 14
    products = [p for p in (plan.conv0, plan.nin, plan.conv1) if p.splits]
    assert plan.launches == 2 + sum(1 + (p.splits > 1) for p in products)
    for blocks, c in ((plan.gn0_blocks, ci), (plan.gn1_blocks, co)):
        # whole groups a block, a power of two of them, 16 channels where they are narrower
        gpb = B * groups(c) // blocks
        assert blocks * gpb == B * groups(c) and groups(c) % gpb == 0 and gpb & (gpb - 1) == 0
        cg = c // groups(c)
        assert gpb * cg <= max(16, cg)
        assert 2 * gpb * cg > 16 or groups(c) % (2 * gpb) != 0    # no more would do
    assert (plan.gemm_threads, plan.gn_threads) == (416, 256)
    assert len(plan.flat()) == 47
    if B == 64 and (H, ci, co) in DDPMPP_RESBLOCKS:
        for p in (plan.conv0, plan.conv1):
            assert p.tiles_m * p.tiles_n * p.splits >= 96, p


@pytest.mark.parametrize("ci,co", [(128, 256), (96, 32), (64, 64)])
def test_tiled_resblock_params_layout(ci, co):
    """The tiled resblock's parameters as its source reads them: bfloat16,
    each convolution weight (C_out, 9 C) with column tap * C + c, the NIN as
    Wn^T, the vectors unchanged."""
    g = torch.Generator().manual_seed(ci + co)
    shapes = [(ci,), (ci,), (co, ci, 3, 3), (co,), (co,), (co,), (co, co, 3, 3), (co,)]
    shapes += [(ci, co), (co,)] if ci != co else []
    raw = [torch.randn(s, generator=g) for s in shapes] + ([None, None] if ci == co else [])
    args = rb_ops.tiled_params(raw)
    bf = torch.bfloat16
    for i in (0, 1, 3, 4, 5, 7, 9):
        if raw[i] is not None:
            assert args[i].dtype == bf and torch.equal(args[i], raw[i].to(bf))
    for i in (2, 6):
        w = raw[i]
        for dy in range(3):
            for dx in range(3):
                tap = dy * 3 + dx
                c = w.shape[1]
                assert torch.equal(args[i][:, tap * c:(tap + 1) * c], w[:, :, dy, dx].to(bf))
    assert (args[8] is None) == (ci == co)
    if ci != co:
        assert torch.equal(args[8], raw[8].t().to(bf)) and args[8].is_contiguous()


@pytest.mark.parametrize("C", [256, 32])
def test_tiled_attention_params_layout(C):
    """The tiled forward's parameters as its source reads them: gamma, beta,
    [Wq | Wk | Wv]^T, [bq | bk | bv], Wp^T, bp in bfloat16."""
    g = torch.Generator().manual_seed(C)
    raw = [torch.randn(C, generator=g), torch.randn(C, generator=g)]
    for _ in range(4):
        raw += [torch.randn(C, C, generator=g), torch.randn(C, generator=g)]
    gamma, beta, wqkv_t, bqkv, wp_t, bp = attn_ops.tiled_fwd_params(raw)
    bf = torch.bfloat16
    assert torch.equal(gamma, raw[0].to(bf)) and torch.equal(beta, raw[1].to(bf))
    assert torch.equal(wqkv_t, torch.cat([raw[2], raw[4], raw[6]], 1).t().to(bf))
    assert torch.equal(bqkv, torch.cat([raw[3], raw[5], raw[7]]).to(bf))
    assert torch.equal(wp_t, raw[8].t().to(bf)) and torch.equal(bp, raw[9].to(bf))
    assert all(a.is_contiguous() for a in (wqkv_t, wp_t))


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
           [(64, H, ci, co) for H, ci, co in NF32_RESBLOCKS] + [(3, 32, 384, 128), (5, 9, 96, 32)] + \
           [(2, 64, 64, 128)]   # GroupNorm's groups too wide for shared memory: its streamed path


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
            assert attn_ops.built_tiled_plan(B, C, L, G) == attn_ops.tiled_plan(B, C, L).flat()
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
