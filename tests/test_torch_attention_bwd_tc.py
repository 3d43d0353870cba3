"""The tensor-core body of the fused attention backward.

CPU: which body a shape takes (``ops.attention.attn_body``: bfloat16 at C 64
and L <= 96 takes the tensor-core body, every other shape and float32 the
scalar one), and the backward's launcher, which refuses parameters off the
card.
Card (marker ``gpu``): the built library's plan names the same body, and
the tensor-core body against the plain backward at B 4096 (32 samples a
slot), 4097 and 3 (no slot count divides them), 1, and at L 49 and 96,
within the tolerances of ``test_torch_attention_bwd.py``; two runs bit for
bit.
"""
import math

import numpy as np
import pytest
import torch

from rdm_tpu_torch.ops import attention as attn_ops

torch.set_num_threads(1)  # the suite runs in parallel worker processes

BF16_STEP = 2.0 ** -8
NAMES = ("dx", "gamma", "beta", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp")


def make_case(B, C, H, W, dtype, seed, device="cpu"):
    """x, g (NCHW, ``dtype``) and the ten float32 parameters from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, C, H, W)).astype(np.float32)
    g = rng.normal(size=(B, C, H, W)).astype(np.float32)
    p = [1.0 + 0.1 * rng.normal(size=C), 0.1 * rng.normal(size=C)]
    for _ in range(4):
        p += [rng.normal(size=(C, C)) / math.sqrt(C), 0.1 * rng.normal(size=C)]
    to = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return to(x).to(dtype), to(g).to(dtype), [to(a) for a in p]


@pytest.mark.parametrize("C,L,dtype,body", [
    (64, 81, torch.bfloat16, "tensor_cores"), (64, 49, torch.bfloat16, "tensor_cores"),
    (64, 96, torch.bfloat16, "tensor_cores"), (64, 1, torch.bfloat16, "tensor_cores"),
    (64, 97, torch.bfloat16, "scalar"), (64, 128, torch.bfloat16, "scalar"),
    (128, 81, torch.bfloat16, "scalar"), (64, 81, torch.float32, "scalar")])
def test_bwd_body_is_fixed_by_the_shape(C, L, dtype, body):
    assert attn_ops.attn_body(C, L, dtype) == body


def test_bwd_launcher_refuses_parameters_off_the_card():
    _, _, params = make_case(1, 64, 9, 9, torch.bfloat16, 0)
    with pytest.raises(ValueError):
        attn_ops._bwd_launcher(*params, C=64, L=81, dtype=torch.bfloat16, groups=16)


@pytest.mark.parametrize("L,dtype", [(81, torch.bfloat16), (81, torch.float32),
                                     (128, torch.bfloat16)])
def test_bwd_args_carry_wp_transposed(L, dtype):
    """The kernel reads Wp^T in place of Wp, contiguous and cast; the scalar
    body also reads Wq^T, Wk^T, Wv^T, the tensor-core body no transposed
    copy (it transposes while staging the weights)."""
    _, _, params = make_case(1, 64, 1, L, dtype, 1)
    args = attn_ops._bwd_args(params, 64, L, dtype, torch.device("cpu"))
    tc = attn_ops.attn_body(64, L, dtype) == "tensor_cores"
    assert len(args) == (10 if tc else 13)
    assert all(a.is_contiguous() and a.dtype == dtype for a in args)
    torch.testing.assert_close(args[8], params[8].t().to(dtype), rtol=0, atol=0)
    for i, a in enumerate(args[:8] + args[9:10]):
        j = i if i < 8 else 9
        torch.testing.assert_close(a, params[j].to(dtype), rtol=0, atol=0)
    for a, w in zip(args[10:], (params[2], params[4], params[6])):
        torch.testing.assert_close(a, w.t().to(dtype), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C,L,dtype", [(64, 81, torch.bfloat16), (64, 49, torch.bfloat16),
                                       (64, 96, torch.bfloat16), (64, 16, torch.bfloat16),
                                       (64, 97, torch.bfloat16), (128, 81, torch.bfloat16),
                                       (64, 81, torch.float32), (128, 128, torch.float32)])
def test_library_plan_names_the_body(cuda_device, C, L, dtype):
    plan = attn_ops.bwd_plan(C, L, dtype)
    assert plan.body == attn_ops.attn_body(C, L, dtype)
    if plan.body == "tensor_cores":
        assert plan.threads == 32 * (-(-L // 32) * 2)
        assert plan.stages == (2 if L <= 81 else 1)
        assert plan.smem_bytes <= 232448


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W", [(4096, 9, 9), (4097, 9, 9), (3, 9, 9), (1, 9, 9),
                                   (300, 7, 7), (130, 8, 12)])
def test_tc_bwd_matches_plain(cuda_device, B, H, W):
    C, L = 64, H * W
    assert attn_ops.attn_body(C, L, torch.bfloat16) == "tensor_cores"
    x, g, params = make_case(B, C, H, W, torch.bfloat16, B + L, cuda_device)
    before = attn_ops.fused_attn_block_bwd.launches
    ours = attn_ops.fused_attn_block_bwd(x, g, *params, groups=16)
    again = attn_ops.fused_attn_block_bwd(x, g, *params, groups=16)
    ref = attn_ops.fused_attn_block_bwd_reference(x, g, *params, groups=16)
    torch.cuda.synchronize()
    assert attn_ops.fused_attn_block_bwd.launches == before + 2
    for a, b in zip(ours, again):
        assert torch.equal(a, b)
    scales = {n: max(1.0, float(b.float().abs().max())) for n, b in zip(NAMES, ref)}
    # dbk is zero in exact arithmetic (softmax ignores a shift that all keys
    # share): both versions return the summed rounding noise of B*L values of
    # dk, whose size is that of dq, so it is held to the scale of dbq
    scales["bk"] = max(scales["bk"], scales["bq"])
    for n, a, b in zip(NAMES, ours, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, n
        assert bool(torch.isfinite(a.float()).all()), n
        err = float((a.float() - b.float()).abs().max())
        # the same rounding points; sums in another order may round a bf16
        # value the other way and carry a step on: dx within 4 steps of its
        # scale, the float32 parameter gradients within one
        tol = (4 if n == "dx" else 1) * BF16_STEP * scales[n]
        assert err <= tol, (n, err, tol)


def test_phase_stamps_apply_to_the_source():
    """``benchmark/phases.py`` stamps the tensor-core body's sample loop by its
    text: the top of the loop, the sample's arrival and each of the seven
    barriers its phases name, once each."""
    from rdm_tpu_torch.benchmark import phases

    src = phases.stamped_source()
    assert [src.count(f"PHASE_STAMP({k})") for k in range(len(phases.PHASES) + 2)] == [1] * 9
    assert "rdm_phase_cycles" in src
