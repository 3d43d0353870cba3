"""Which body of the fused attention forward a shape takes, and the
tensor-core body on the card.

CPU: ``ops.attention.attn_body`` (bfloat16 at C 64 and L <= 96 takes the
tensor-core body, every other shape and float32 the scalar one), and the
launchers that both redesigned kernels' wrappers build, which prepare
parameters for the card and refuse anything else.
Card (marker ``gpu``): the tensor-core body against the plain version at
B 1024, 4096 (every stage of a group refilled many times), 3 and 1025 (no
persistent grid divides it), C 64, L 81 and at the L <= 96 edges, two runs
bit for bit.
"""
import math

import numpy as np
import pytest
import torch

from rdm_tpu_torch.ops import attention as attn_ops
from rdm_tpu_torch.ops import resblock as rb_ops

torch.set_num_threads(1)  # the suite runs in parallel worker processes

BF16_STEP = 2.0 ** -8


def make_params(C, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    p = [1.0 + 0.1 * rng.normal(size=C), 0.1 * rng.normal(size=C)]
    for _ in range(4):
        p += [rng.normal(size=(C, C)) / math.sqrt(C), 0.1 * rng.normal(size=C)]
    return [torch.tensor(np.asarray(a, np.float32), device=device) for a in p]


@pytest.mark.parametrize("C,L,dtype,body", [
    (64, 81, torch.bfloat16, "tensor_cores"), (64, 96, torch.bfloat16, "tensor_cores"),
    (64, 1, torch.bfloat16, "tensor_cores"), (64, 97, torch.bfloat16, "scalar"),
    (64, 128, torch.bfloat16, "scalar"), (128, 81, torch.bfloat16, "scalar"),
    (64, 81, torch.float32, "scalar")])
def test_attn_body_is_fixed_by_the_shape(C, L, dtype, body):
    assert attn_ops.attn_body(C, L, dtype) == body


def test_launchers_refuse_parameters_off_the_card():
    with pytest.raises(ValueError):
        attn_ops._launcher(*make_params(64, 0), C=64, L=81, dtype=torch.bfloat16, groups=16)
    g = torch.Generator().manual_seed(0)
    f = lambda *s: torch.randn(s, generator=g)
    params = [f(64), f(64), f(64, 64, 3, 3), f(64), f(64), f(64), f(64, 64, 3, 3), f(64),
              None, None]
    with pytest.raises(ValueError):
        rb_ops._launcher(*params, H=9, dtype=torch.bfloat16, groups0=16, groups1=16)


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W", [(1024, 9, 9), (4096, 9, 9), (3, 9, 9), (1025, 9, 9),
                                   (5, 8, 12), (7, 4, 8), (2, 1, 1)])
def test_tc_body_matches_plain(cuda_device, B, H, W):
    C, L = 64, H * W
    assert attn_ops.attn_body(C, L, torch.bfloat16) == "tensor_cores"
    rng = np.random.default_rng(B + L)
    x = torch.tensor(rng.normal(size=(B, C, H, W)).astype(np.float32),
                     device=cuda_device).to(torch.bfloat16)
    params = make_params(C, B, cuda_device)
    before = attn_ops.fused_attn_block.launches
    out = attn_ops.fused_attn_block(x, *params, groups=16)
    again = attn_ops.fused_attn_block(x, *params, groups=16)
    ref = attn_ops.fused_attn_block_reference(x, *params, groups=16)
    torch.cuda.synchronize()
    assert attn_ops.fused_attn_block.launches == before + 2
    assert torch.equal(out, again)
    assert bool(torch.isfinite(out.float()).all())
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    # the same rounding points; a sum next to a rounding boundary may round
    # the other way and carry a step on: 4 bf16 steps at the output's scale
    assert err <= 4 * BF16_STEP * scale, err
