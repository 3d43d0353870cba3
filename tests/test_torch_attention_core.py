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


def test_core_rows_per_chunk():
    assert attn_ops.core_rows_per_chunk(64, 81) == 81      # flagship: one chunk
    r = attn_ops.core_rows_per_chunk(128, 128)
    assert 1 <= r < 128
    # k^T and v, and per chunk row one row of q and of scores
    assert 4 * (128 * 128 + 128 * 128 + r * (129 + 128)) <= 232448


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
