"""The port's trace entry point (twin of scripts/trace.py) on the CPU: it
writes a Chrome trace of the real program, and the sampling it traces is
the PC sampler's on the same generator.  The program itself is held to the
JAX package by the sampling and training tests of earlier slices."""
import json

import torch

from rdm_tpu_torch.benchmark import trace
from rdm_tpu_torch.models.registry import get_cf_score_fn
from rdm_tpu_torch.sampling import get_pc_sampler
from rdm_tpu_torch.sde import RVESDE

torch.set_num_threads(1)  # the suite runs in parallel worker processes


def _events(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events}


def test_sample_trace_is_the_pc_sampler(tmp_path):
    r = trace.main(["--device", "cpu", "--batch", "4", "--steps", "3",
                    "--outdir", str(tmp_path)])
    assert r["path"] == str(tmp_path / "trace_sample.json") and r["trace_bytes"] > 0
    names = _events(r["path"])
    assert any("conv" in n for n in names) and any("group_norm" in n for n in names)
    assert r["steps_traced"] == 2 and r["idle_share"] is None
    assert r["attn_launches_by_wrapper"] == {"fwd": 0, "bwd": 0}   # the CPU runs plain versions

    cfg, model = trace.flagship_model("cpu", train=False)
    sde = RVESDE(cfg.sde.sigma_min, cfg.sde.sigma_max, 3)
    sampler = get_pc_sampler(sde, (4, 1, 9, 9), eps=1e-5)
    score_fn = get_cf_score_fn(sde, model, torch.zeros((4, 1)), 0.0)
    with torch.no_grad():
        want = sampler(score_fn, torch.Generator().manual_seed(1))[0]
    assert torch.equal(r["output"], want)


def test_train_trace_holds_the_backward(tmp_path):
    r = trace.main(["--device", "cpu", "--batch", "4", "--steps", "3", "--what", "train",
                    "--outdir", str(tmp_path)])
    assert r["steps_traced"] == trace.TRAIN_STEPS
    names = _events(r["path"])
    assert any("convolution_backward" in n for n in names)
    assert any("_foreach" in n for n in names)      # the optimizer's update
    assert torch.isfinite(r["output"]) and r["output"].dim() == 0


def test_kernel_name_tests():
    assert trace.is_attn_fwd("void fused_attn_block_tc_kernel<64, 81>(Params)")
    assert not trace.is_attn_fwd("void fused_attn_block_bwd_tc_kernel<64>(Params)")
    assert trace.is_attn_bwd("void fused_attn_block_bwd_tc_kernel<64>(Params)")
    assert not trace.is_attn_bwd("void fused_attn_block_kernel<float, 64>(Params)")
