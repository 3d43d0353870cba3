"""The port's bare attention core against the JAX package.

CPU: the plain version ``attention_core_reference`` (which the wrapper runs
for CPU tensors) against the JAX Pallas kernel ``attention_core`` in
interpret mode on the same seeded inputs, float32 and bfloat16 with both
softmax settings.  Card (marker ``gpu``): the CUDA kernel against the plain
version.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rdm_tpu.ops.pallas.attention import attention_core as jax_attention_core
from rdm_tpu_torch.ops import attention as attn_ops

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_STEP = 2.0 ** -8
# (B, L, C): the flagship's 81 tokens x 64 channels, the largest shape the
# kernel takes, and a narrow one; B = 5 and 3 are ragged against block_b 4
SHAPES = [(5, 81, 64), (3, 128, 128), (4, 16, 32)]


def make_qkv(B, L, C, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, C)).astype(np.float32) for _ in range(3)]


def run_port(qkv, dtype, softmax_f32=True, fn=attn_ops.attention_core):
    out = fn(*(torch.from_numpy(a).to(dtype) for a in qkv), softmax_f32=softmax_f32)
    assert out.dtype == dtype
    return out.float().numpy()


def run_jax(qkv, dt, softmax_f32=True):
    out = jax_attention_core(*(jnp.asarray(a, dt) for a in qkv), softmax_f32=softmax_f32,
                             block_b=4, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("B,L,C", SHAPES)
def test_plain_matches_jax_kernel_f32(B, L, C):
    qkv = make_qkv(B, L, C, seed=B + L + C)
    # float32 both sides, same algebra; sums in another order
    np.testing.assert_allclose(run_port(qkv, torch.float32), run_jax(qkv, jnp.float32),
                               rtol=2e-5, atol=2e-5)


# As for the fused blocks, the bfloat16 JAX side runs in a process of its own
# with XLA's excess precision off, so that it rounds at every point its
# source rounds.
JAX_BF16_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import jax.numpy as jnp
    sys.path.insert(0, {tests!r})
    from test_torch_attention_core import SHAPES, make_qkv, run_jax
    out = {{}}
    for B, L, C in SHAPES:
        qkv = make_qkv(B, L, C, seed=B + L + C + 1)
        for f32 in (True, False):
            out[f"{{B}}_{{L}}_{{C}}_{{f32}}"] = run_jax(qkv, jnp.bfloat16, softmax_f32=f32)
    np.savez({path!r}, **out)
""")


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_bf16") / "core.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    script = JAX_BF16_SCRIPT.format(tests=os.path.join(ROOT, "tests"), path=path)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return np.load(path)


@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize("B,L,C", SHAPES)
def test_plain_matches_jax_kernel_bf16(jax_bf16, B, L, C, softmax_f32):
    qkv = make_qkv(B, L, C, seed=B + L + C + 1)
    ours = run_port(qkv, torch.bfloat16, softmax_f32)
    theirs = jax_bf16[f"{B}_{L}_{C}_{softmax_f32}"]
    # The same rounding points; a float32 sum next to a bfloat16 rounding
    # boundary may round the other way on one side: one bf16 step at the
    # output's magnitude, and nearly every element within one step of its
    # own (measured: half a step, 0.008 % of the elements differ; bit-equal
    # without the float32 softmax).
    scale = max(1.0, float(np.abs(theirs).max()))
    err = np.abs(ours - theirs)
    assert err.max() <= BF16_STEP * scale, err.max()
    assert (err <= BF16_STEP * np.maximum(np.abs(theirs), 1.0)).mean() > 0.99


def test_softmax_settings_differ_in_bf16():
    """Without the float32 softmax the probabilities round in bfloat16 at
    every step, which moves the output (the test above tells them apart)."""
    qkv = make_qkv(4, 81, 64, seed=7)
    a = run_port(qkv, torch.bfloat16, True)
    b = run_port(qkv, torch.bfloat16, False)
    assert (a != b).mean() > 0.05
    np.testing.assert_array_equal(run_port(qkv, torch.float32, True),
                                  run_port(qkv, torch.float32, False))


def test_wrapper_takes_plain_version_on_cpu_and_raises_elsewhere():
    qkv = make_qkv(3, 81, 64, seed=9)
    before = attn_ops.attention_core.launches
    np.testing.assert_array_equal(
        run_port(qkv, torch.float32),
        run_port(qkv, torch.float32, fn=attn_ops.attention_core_reference))
    assert attn_ops.attention_core.launches == before    # no kernel launched
    q = torch.empty((2, 81, 64), device="meta")
    with pytest.raises(ValueError):
        attn_ops.attention_core(q, q, q)


@pytest.mark.parametrize("B,L,C", [(64, 81, 64), (16, 128, 128)])
def test_3xtf32_split_meets_the_float32_tolerance(B, L, C):
    """The float32 kernel's 3xTF32 split, emulated in plain torch (TF32
    rounding of the low 13 mantissa bits to nearest, as cvt.rna.tf32.f32
    does; hi x lo + lo x hi + hi x hi), holds the tolerance the card holds
    the kernel to: 1e-5 at the output's scale of the plain version."""
    q, k, v = (torch.from_numpy(a) for a in make_qkv(B, L, C, B + L + C))
    ref = attn_ops.attention_core_reference(q, k, v)
    ours = attn_ops.attention_core_3xtf32(q, k, v)
    scale = max(1.0, float(ref.abs().max()))
    assert float((ours - ref).abs().max()) <= 1e-5 * scale
    # TF32 alone would not: one product's rounding moves p v by about 1e-3
    hi = attn_ops.tf32_round
    s = torch.matmul(hi(q), hi(k).transpose(-1, -2)) * C ** -0.5
    one = torch.matmul(hi(torch.softmax(s, -1)), hi(v))
    assert float((one - ref).abs().max()) > 1e-4 * scale


def test_tf32_round_is_cvt_rna():
    """TF32 keeps 10 mantissa bits: the low 13 bits of the float32 pattern
    rounded to nearest, ties away from zero, for either sign."""
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 3 * 2.0 ** -12, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 1.0 + 2.0 ** -10, 3.0])
    assert torch.equal(attn_ops.tf32_round(x), want)
    assert not (attn_ops.tf32_round(torch.randn(1000)).view(torch.int32) & 0x1FFF).any()


def test_core_plan_fits_every_accepted_shape():
    """The kernel's plan for every (L, C) the wrapper takes: keys and
    channels padded to whole tiles; in bfloat16 one warp per 16 query rows
    in each consumer group and a producer warp, two staged samples of each
    group's own; in float32 one sample a block; all of it within one
    block's shared memory."""
    for L in range(1, 129):
        for C in range(8, 129, 8):
            plan = attn_ops.core_plan(L, C)
            assert plan.key_tiles in (2, 4, 6, 8) and L <= 16 * plan.key_tiles < L + 32
            assert plan.channel_tiles == (4 if C <= 64 else 8)
            assert plan.groups == (1 if plan.key_tiles * plan.channel_tiles >= 32 else 2)
            assert plan.warps == plan.groups * -(-L // 16) + 1
            sample = 3 * 16 * plan.key_tiles * 16 * plan.channel_tiles * 2
            assert plan.samples_in_flight == 2 * plan.groups
            assert plan.smem_bytes == 1024 + plan.samples_in_flight * (sample + 16)
            assert plan.smem_bytes <= 232448
            # float32: a sample a block, one warp per 16 query rows, q, k and v
            # staged as 16 key_tiles rows of C + 4 floats
            f32 = attn_ops.core_plan(L, C, torch.float32)
            assert f32[:2] == plan[:2] and (f32.groups, f32.samples_in_flight) == (1, 1)
            assert f32.warps == -(-L // 16) and f32.warps * 16 <= 16 * f32.key_tiles
            assert f32.smem_bytes == 3 * 16 * f32.key_tiles * (C + 4) * 4 <= 232448
    # the flagship's shape: 2 groups of 6 warps and a producer, 4 samples of 36,864 bytes
    assert attn_ops.core_plan(81, 64) == (6, 4, 2, 13, 4, 148544)
    assert attn_ops.core_plan(128, 128) == (8, 8, 1, 9, 2, 197664)    # the largest
    assert attn_ops.core_plan(81, 64, torch.float32) == (6, 4, 1, 6, 1, 78336)
    assert attn_ops.core_plan(128, 128, torch.float32) == (8, 8, 1, 8, 1, 202752)
    for L, C in [(0, 64), (129, 64), (81, 136), (81, 60), (81, 0)]:
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(ValueError):
                attn_ops.core_plan(L, C, dtype)


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,C", [(1024, 81, 64), (3, 81, 64), (16, 128, 128), (8, 16, 32)])
@pytest.mark.parametrize("dtype,softmax_f32", [(torch.float32, True), (torch.bfloat16, True),
                                               (torch.bfloat16, False)])
def test_kernel_matches_plain(cuda_device, B, L, C, dtype, softmax_f32):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in make_qkv(B, L, C, B + L))
    before = attn_ops.attention_core.launches
    out = attn_ops.attention_core(q, k, v, softmax_f32)
    ref = attn_ops.attention_core_reference(q, k, v, softmax_f32)
    torch.cuda.synchronize()
    assert attn_ops.attention_core.launches == before + 1
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    # float32: summation order only; bfloat16: the same rounding points, a
    # sum next to a boundary may round the other way: 2 bf16 steps
    assert err <= (1e-5 if dtype == torch.float32 else 2 * BF16_STEP) * scale, err


@pytest.mark.gpu
def test_kernel_rejects_unsupported(cuda_device):
    for shape in [(2, 129, 64), (2, 81, 136), (2, 81, 60)]:
        q = torch.zeros(shape, device=cuda_device)
        with pytest.raises(ValueError):
            attn_ops.attention_core(q, q, q)
    q = torch.zeros((2, 81, 64), device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError):
        attn_ops.attention_core(q, q, q)


def card_qkv(B, L, C, seed, device):
    return [torch.from_numpy(a).to(device, torch.bfloat16) for a in make_qkv(B, L, C, seed)]


def check_bf16(out, ref):
    # the same rounding points; a sum next to a boundary may round the other
    # way: 2 bf16 steps at the output's scale
    err = float((out.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    assert bool(torch.isfinite(out.float()).all())
    assert err <= 2 * BF16_STEP * scale, err


@pytest.mark.gpu
@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize("C", [8, 32, 64, 128])
@pytest.mark.parametrize("L", [1, 16, 81, 128])
@pytest.mark.parametrize("B", [1, 3, 1025])
def test_bf16_kernel_shapes_and_edges(cuda_device, B, L, C, softmax_f32):
    """Batches that no grid divides evenly (each block walks samples in
    turn, two in flight), one token to the most, narrow to wide channels."""
    q, k, v = card_qkv(B, L, C, B + L + C, cuda_device)
    before = attn_ops.attention_core.launches
    out = attn_ops.attention_core(q, k, v, softmax_f32)
    ref = attn_ops.attention_core_reference(q, k, v, softmax_f32)
    torch.cuda.synchronize()
    assert attn_ops.attention_core.launches == before + 1
    check_bf16(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize("L,C", [(81, 64), (128, 128), (16, 32)])
def test_bf16_kernel_many_samples_per_block(cuda_device, L, C, softmax_f32):
    """B 4096: a block takes about 31 samples, so each ring stage is refilled
    many times over; every sample must still be computed from its own q, k,
    v (a stage reused before its earlier load landed would mix samples)."""
    q, k, v = card_qkv(4096, L, C, 5, cuda_device)
    out = attn_ops.attention_core(q, k, v, softmax_f32)
    ref = attn_ops.attention_core_reference(q, k, v, softmax_f32)
    torch.cuda.synchronize()
    check_bf16(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize("L", [17, 81])
def test_padded_keys_carry_no_weight(cuda_device, L, softmax_f32):
    """The last real key scores far above the rest and the keys past it
    (padding up to a whole tile) would dominate if they took any weight:
    p puts nearly all its mass on key L - 1, as the plain version does."""
    B, C = 8, 64
    q, k, v = card_qkv(B, L, C, 11, cuda_device)
    q = q.abs()
    k[:, L - 1] = 4.0                  # scores about 4 sqrt(C) E|q| above the others
    v[:, L - 1] = -3.0
    out = attn_ops.attention_core(q, k, v, softmax_f32)
    ref = attn_ops.attention_core_reference(q, k, v, softmax_f32)
    torch.cuda.synchronize()
    check_bf16(out, ref)
    assert float((out.float() + 3.0).abs().max()) < 0.05


@pytest.mark.gpu
def test_bf16_kernel_rejects_views_off_a_16_byte_boundary(cuda_device):
    x = torch.zeros(2 * 81 * 64 + 8, device=cuda_device, dtype=torch.bfloat16)
    view = x[1:1 + 2 * 81 * 64].view(2, 81, 64)            # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        attn_ops.attention_core(view, view, view)
