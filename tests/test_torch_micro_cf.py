"""The port's channels-first primitives (``rdm_tpu_torch.ops.micro_cf``)
against the TPU kernels of ``scripts/micro_pallas_cf.py``.

CPU: the script is loaded as it is (not edited, not copied) and run at
TB = 4 (N = 324) with its Pallas kernels in interpret mode; ``slope`` is
replaced by one call whose output, and the output of each ``pallas_call``
inside it, is kept, and ``jax.random.normal`` returns this test's
numpy-seeded arrays, so both sides see the same inputs.  The plain
versions, which the wrappers run for CPU tensors, must match: the
transposes and the roll sum bit for bit, the dots within one bf16 step.
Card (marker ``gpu``): each CUDA kernel against its plain version at the
script's full size (N = 20,736).
"""
import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rdm_tpu_torch.ops import micro_cf

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "micro_pallas_cf.py")
C, TB, L = 64, 4, 81
N = TB * L


def bf16_ulp(a):
    """One bfloat16 step (unit in the last place) at each element's magnitude."""
    a = np.abs(np.asarray(a, np.float64))
    tiny = np.finfo(np.float32).tiny
    return 2.0 ** (np.floor(np.log2(np.maximum(a, tiny))) - 7)


@pytest.fixture
def jax_script(monkeypatch):
    """Run one ``bench_*`` function of the TPU script with its kernels in
    interpret mode: returns ``run(bench, *args, arrays)`` -> (the output of
    the function it times, the outputs of its pallas_calls in order)."""
    spec = importlib.util.spec_from_file_location("micro_pallas_cf", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "TB", TB)
    monkeypatch.setattr(mod, "N", N)
    calls = []

    def pallas_call(*a, **k):
        f = functools.partial(pl.pallas_call, interpret=True)(*a, **k)

        def run(*args):
            out = f(*args)
            calls.append(np.asarray(out.astype(jnp.float32)))
            return out
        return run

    monkeypatch.setattr(mod, "pl", types.SimpleNamespace(pallas_call=pallas_call,
                                                         BlockSpec=pl.BlockSpec))
    timed = []

    def slope(fn, x):
        # one call, eagerly, so that each pallas_call's output is concrete
        with jax.disable_jit():
            timed.append(np.asarray(fn(x).astype(jnp.float32)))
        return 1.0

    monkeypatch.setattr(mod, "slope", slope)

    def run(bench, *args, arrays):
        def normal(key, shape, dtype=jnp.float32):
            return jnp.asarray(arrays[tuple(shape)], dtype)
        calls.clear()
        timed.clear()
        with monkeypatch.context() as m:
            m.setattr(jax.random, "normal", normal)
            getattr(mod, bench)(*args)
        return timed[0], list(calls)

    return run


def bf16_array(shape, seed):
    """Seeded normals already on the bf16 grid, so both sides read the same
    values whatever they round."""
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def to_bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def test_transpose_pair_matches_pallas_bit_for_bit(jax_script):
    x = bf16_array((N, C), 0)
    out, (fwd, back) = jax_script("bench_transpose", arrays={(N, C): x})
    ours_fwd = micro_cf.cf_transpose(to_bf16(x))                 # :49, (N, C) -> (C, N)
    ours_back = micro_cf.cf_transpose(to_bf16(fwd))              # :56, (C, N) -> (N, C)
    assert ours_fwd.shape == (C, N) and ours_back.shape == (N, C)
    np.testing.assert_array_equal(ours_fwd.float().numpy(), fwd)
    np.testing.assert_array_equal(ours_back.float().numpy(), back)
    np.testing.assert_array_equal(back, out)
    np.testing.assert_array_equal(out, x)


def test_masked_roll_sum_matches_pallas_bit_for_bit(jax_script):
    x = bf16_array((C, N), 1)
    out, (kernel_out,) = jax_script("bench_roll", arrays={(C, N): x})
    ours = micro_cf.cf_masked_roll_sum(to_bf16(x)).float().numpy()
    np.testing.assert_array_equal(kernel_out, out)
    # the same float32 sum in the same order, rounded once: bit for bit
    np.testing.assert_array_equal(ours, out)


def test_masked_roll_sum_wraps_across_image_rows_only_inside_a_sample():
    """The mask tests the flattened 81-token position alone: a +1 tap at
    the end of an image row reads the next row's first token, a tap that
    leaves the sample reads nothing."""
    x = torch.zeros((1, 2 * L), dtype=torch.bfloat16)
    x[0, 9] = 1.0                              # sample 0: row 1, column 0
    x[0, L] = 2.0                              # sample 1: token 0
    out = micro_cf.cf_masked_roll_sum(x, shifts=(1,)).float()[0]
    assert out[8] == 1.0                       # row 0, column 8: +1 wraps to row 1
    assert out[L - 1] == 0.0                   # the last token does not reach sample 1
    assert out[L - 2] == 0.0


@pytest.mark.parametrize("K", [C, 3 * C])
def test_dots_match_pallas_within_one_bf16_step(jax_script, K):
    taps = micro_cf.dots_taps(C, K)
    w, x = bf16_array((taps, C, K), 2 + K), bf16_array((K, N), 3 + K)
    out, (kernel_out,) = jax_script("bench_dots", K, arrays={(taps, C, K): w, (K, N): x})
    np.testing.assert_array_equal(out[:C], kernel_out)
    for r in range(1, K // C):                 # the script stacks K / C copies
        np.testing.assert_array_equal(out[r * C:(r + 1) * C], kernel_out)
    ours = micro_cf.cf_dots(to_bf16(w), to_bf16(x), K).float().numpy()
    assert ours.shape == (C, N)
    # Both sides sum the same float32 products (exact: bf16 x bf16) in
    # another order, then round once.  Two float32 sums of the same n =
    # taps * K terms differ by at most 2 n u sum|terms| (u = 2^-24), and
    # rounding each to bfloat16 adds at most one step at the result's
    # magnitude: so each element is within one bf16 step of its value plus
    # that float32 allowance, which is about a tenth of a step for a typical
    # element and matters only next to zero.  Measured on the CPU: 99.98 %
    # (K 64) and 99.99 % (K 192) of the elements bit-equal, the rest one
    # step apart.
    n = taps * K
    f32_allow = 2 * n * 2.0 ** -24 * sum(np.abs(w[t]) @ np.abs(x) for t in range(taps))
    err = np.abs(ours - kernel_out)
    assert np.all(err <= bf16_ulp(kernel_out) + f32_allow), (err / bf16_ulp(kernel_out)).max()
    bit_equal = float((ours == kernel_out).mean())
    print(f"dots K={K}: {100 * bit_equal:.2f} % bit-equal, "
          f"worst {float((err / bf16_ulp(kernel_out)).max()):.2f} bf16 steps")


def test_roll_sum_library_yardstick_is_the_same_function():
    """The script's library yardstick for the roll sum, one ``F.conv1d``
    over the samples as rows, sums the same 8 exact terms, zero padding in
    place of the mask: on the CPU it equals the plain version bit for bit."""
    from rdm_tpu_torch.scripts.micro_cf import roll_sum_conv1d

    x = to_bf16(bf16_array((C, N), 6))
    y = roll_sum_conv1d(x)(x)
    assert y.shape == (C, N) and y.dtype == torch.bfloat16
    assert torch.equal(y, micro_cf.cf_masked_roll_sum_reference(x))


def test_wrappers_take_plain_versions_on_cpu_and_check_inputs():
    x = to_bf16(bf16_array((C, N), 4))
    w = to_bf16(bf16_array((9, C, C), 5))
    before = (micro_cf.cf_transpose.launches, micro_cf.cf_masked_roll_sum.launches,
              micro_cf.cf_dots.launches)
    assert torch.equal(micro_cf.cf_transpose(x), micro_cf.cf_transpose_reference(x))
    assert torch.equal(micro_cf.cf_masked_roll_sum(x), micro_cf.cf_masked_roll_sum_reference(x))
    assert torch.equal(micro_cf.cf_dots(w, x, C), micro_cf.cf_dots_reference(w, x, C))
    assert before == (micro_cf.cf_transpose.launches, micro_cf.cf_masked_roll_sum.launches,
                      micro_cf.cf_dots.launches)              # no kernel launched
    with pytest.raises(ValueError, match="dtype"):
        micro_cf.cf_transpose(x.float())
    with pytest.raises(ValueError, match="dimensions"):
        micro_cf.cf_masked_roll_sum(x[None])
    with pytest.raises(ValueError, match="taps"):
        micro_cf.cf_dots(w[:3], x, C)                          # K = C takes 9 taps
    with pytest.raises(ValueError, match="device"):
        micro_cf.cf_transpose(torch.empty((8, 8), dtype=torch.bfloat16, device="meta"))
    assert micro_cf.dots_plan(9, 64).smem_bytes <= 232448
    assert micro_cf.dots_plan(3, 192).smem_bytes <= 232448


def test_dots_plan():
    """The dots kernel's ring: all of w (taps x ceil(K / 64) panels of
    64 x 64), one or two K x 64 x tiles of each of the 3 consumer
    warpgroups' own, a 16 x 64 output stage for each of the 12 consumer
    warps and the barriers, within one block's shared memory; no plan past a
    TMA box of 256 rows."""
    assert micro_cf.dots_plan(9, 64) == (6, 1024 + 9 * 8192 + 24576 + 72 + 6 * (8192 + 16))
    assert micro_cf.dots_plan(3, 192) == (3, 1024 + 9 * 8192 + 24576 + 24 + 3 * (24576 + 16))
    for K in range(16, 257, 16):
        taps = micro_cf.dots_taps(64, K)
        plan = micro_cf.dots_plan(taps, K)
        assert plan.stages in (3, 6) and plan.smem_bytes <= 232448
    assert micro_cf.dots_plan(3, 256).stages == 3
    assert micro_cf.dots_plan(3, 272) is None


def test_knockout_variants_still_apply_to_the_sources():
    """``benchmark/knockouts.py`` edits the kernel sources by their text; each
    edit must still find its text, so that the tool keeps measuring what it
    names."""
    from rdm_tpu_torch.benchmark import knockouts

    for name, (fname, old, _) in knockouts.EDITS.items():
        edited_file, src = knockouts.edited_source(name)
        assert edited_file == fname
        with open(os.path.join(ROOT, "rdm_tpu_torch", "csrc", fname)) as f:
            assert (src != f.read()) == (old is not None), name


# ---------------------------------------------------------------------------
# On the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_randn(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(20736, 64), (64, 20736), (8, 24), (200, 72)])
def test_transpose_kernel_is_exact(cuda_device, shape):
    x = card_randn(shape, 0, cuda_device)
    before = micro_cf.cf_transpose.launches
    out = micro_cf.cf_transpose(x)
    torch.cuda.synchronize()
    assert micro_cf.cf_transpose.launches == before + 1
    assert torch.equal(out, micro_cf.cf_transpose_reference(x))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [20736, 648, 81 * 56])
def test_roll_sum_kernel_is_exact(cuda_device, N):
    x = card_randn((64, N), 1, cuda_device)
    before = micro_cf.cf_masked_roll_sum.launches
    out = micro_cf.cf_masked_roll_sum(x)
    torch.cuda.synchronize()
    assert micro_cf.cf_masked_roll_sum.launches == before + 1
    assert torch.equal(out, micro_cf.cf_masked_roll_sum_reference(x))


@pytest.mark.gpu
@pytest.mark.parametrize("K", [16, 64, 192])
# one tile; ragged; 324 tiles (2 or 3 per SM); 397 tiles (over 3 per SM),
# ragged; 1321 tiles (10 or 11 per SM: each ring stage refilled again and again)
@pytest.mark.parametrize("N", [8, 200, 20736, 64 * 132 * 3 + 8, 64 * 132 * 10 + 8])
def test_dots_kernel_within_one_bf16_step(cuda_device, K, N):
    taps = micro_cf.dots_taps(64, K)
    w, x = card_randn((taps, 64, K), 2, cuda_device), card_randn((K, N), 3, cuda_device)
    before = micro_cf.cf_dots.launches
    out = micro_cf.cf_dots(w, x, K).float()
    ref = micro_cf.cf_dots_reference(w, x, K).float()
    torch.cuda.synchronize()
    assert micro_cf.cf_dots.launches == before + 1
    # one bf16 step at each element plus the float32 allowance of two sums
    # in another order (see test_dots_match_pallas_within_one_bf16_step)
    f32_allow = 2 * taps * K * 2.0 ** -24 * (w.float().abs().sum(0) @ x.float().abs())
    ulp = torch.from_numpy(bf16_ulp(ref.cpu().numpy())).to(cuda_device).float()
    assert bool(((out - ref).abs() <= ulp + f32_allow).all())


@pytest.mark.gpu
def test_dots_kernel_raises_without_a_plan(cuda_device):
    w, x = card_randn((3, 64, 272), 7, cuda_device), card_randn((272, 64), 8, cuda_device)
    with pytest.raises(ValueError, match="K <= 256"):
        micro_cf.cf_dots(w, x, 272)


@pytest.mark.gpu
def test_wrappers_raise_on_views_off_a_16_byte_boundary(cuda_device):
    x = card_randn((64, 20736 + 8), 4, cuda_device)
    view = x.view(-1)[1:1 + 64 * 20736].view(64, 20736)      # contiguous, 2 bytes off
    w = card_randn((9, 64, 64), 5, cuda_device)
    for call in (lambda: micro_cf.cf_transpose(view), lambda: micro_cf.cf_masked_roll_sum(view),
                 lambda: micro_cf.cf_dots(w, view, 64)):
        with pytest.raises(ValueError, match="16-byte"):
            call()


@pytest.mark.gpu
def test_script_counts_the_kernel_runs_of_graph_replays(cuda_device):
    from rdm_tpu_torch.scripts import micro_cf as script

    x = card_randn((64, 648), 6, cuda_device)
    before, replayed = micro_cf.cf_transpose.launches, script.replayed_runs["cf_transpose"]
    script._run_us(lambda k: [micro_cf.cf_transpose(x) for _ in range(k)], 3, cuda_device)
    # 2 eager warm-up calls and 3 captured ones; each captured call runs at
    # the untimed replay and at each of the REPEATS timed ones
    assert micro_cf.cf_transpose.launches == before + 5
    assert script.replayed_runs["cf_transpose"] == replayed + 3 * script.REPEATS
