"""Where the tiled attention block's time goes, launch by launch, on the card.

    python -m rdm_tpu_torch.benchmark.tiled_attn_parts [--shapes ddpmpp,nf32] [--reps 3]

For each shape (DDPM++: B 64, C 256, L 256, 32 groups; nf-32 NCSN++: B 64,
C 32, L 81, 8 groups), bfloat16 activations and float32 parameters made
from a seed: the forward and the backward of the tiled body timed cold
(CUDA-graph slopes, x and g rotating over more than twice the L2), beside
autograd of the unfused library block (F.group_norm, matmul NINs, SDPA; its
forward included, as the kernel recomputes the forward) and the bounds of
``benchmark.costs``; then each launch of both directions (``launch_ms``:
CUDA events between the launches, the L2 flushed and the card queued first,
the mean of ``--reps`` calls).  One JSON line a shape, each naming the card
and its power limit.  It needs the card.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from rdm_tpu_torch.benchmark import costs
from rdm_tpu_torch.benchmark.common import parts_ms
from rdm_tpu_torch.ops import attention as attn_ops
from rdm_tpu_torch.scripts import micro_cf as micro_cf_script

SHAPES = {"ddpmpp": (64, 256, 256, 32), "nf32": (64, 32, 81, 8)}


def inputs(B, C, L, seed, device):
    rng = np.random.default_rng(seed)
    to = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    x = to(rng.normal(size=(B, C, 1, L))).to(torch.bfloat16)
    g = to(rng.normal(size=(B, C, 1, L))).to(torch.bfloat16)
    p = [1.0 + 0.1 * rng.normal(size=C), 0.1 * rng.normal(size=C)]
    for _ in range(4):
        p += [rng.normal(size=(C, C)) / math.sqrt(C), 0.1 * rng.normal(size=C)]
    return x, g, [to(a) for a in p]


def library_block(x, params, groups):
    """The block unfused from PyTorch's own calls, in x's type (the yardstick,
    not the port's path)."""
    F = torch.nn.functional
    gamma, beta, wq, bq, wk, bk, wv, bv, wp, bp = params
    B, C, H, W = x.shape
    h = F.group_norm(x, groups, gamma, beta, attn_ops.GN_EPS).flatten(2).transpose(1, 2)
    q, k, v = (torch.matmul(h, w) + b for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    o = F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None])[:, 0]
    out = (x.flatten(2).transpose(1, 2) + torch.matmul(o, wp) + bp) * (1 / math.sqrt(2.0))
    return out.transpose(1, 2).reshape(B, C, H, W)


def measure(which: str, reps: int, device) -> dict:
    B, C, L, G = SHAPES[which]
    x, g, params = inputs(B, C, L, B + C + L, device)
    kw = dict(groups=G, skip_rescale=True)
    gen = torch.Generator(device=device)
    make = lambda i: torch.randn(x.shape, generator=gen.manual_seed(300 + i),
                                 device=device).to(torch.bfloat16)
    make2 = lambda i: (make(2 * i), make(2 * i + 1))
    nbytes = x.numel() * x.element_size()
    lib_params = [p.to(torch.bfloat16) for p in params]

    def library_fwd_bwd(t):
        xx = t[0].detach().requires_grad_(True)
        ps = [p.detach().requires_grad_(True) for p in lib_params]
        return torch.autograd.grad(library_block(xx, ps, G), [xx, *ps], t[1])

    res = {"which": which, "B": B, "C": C, "L": L, "groups": G}
    with torch.no_grad():
        res["fwd_ms"] = micro_cf_script.cold_us(
            lambda t: attn_ops.fused_attn_block(t, *params, **kw), make, nbytes, device,
            (2, 8)) / 1e3
    res["bwd_ms"] = micro_cf_script.cold_us(
        lambda t: attn_ops.fused_attn_block_bwd(*t, *params, **kw), make2, 2 * nbytes, device,
        (2, 6)) / 1e3
    res["bwd_library_ms"] = micro_cf_script.cold_us(library_fwd_bwd, make2, 2 * nbytes, device,
                                                    (2, 6)) / 1e3
    for key, cost in (("fwd", costs.attn_fwd_cost), ("bwd", costs.attn_bwd_cost)):
        res[key + "_bound_ms"], res[key + "_bound_by"] = costs.bound_ms(
            *cost(B, C, L, 2), costs.PEAK_FLOPS[torch.bfloat16])
    with torch.no_grad():
        res["fwd_launch_ms"] = parts_ms(lambda: attn_ops.tiled_attn_launch_ms(
            x, *params, **kw), reps)
    launcher = attn_ops._tiled_bwd_launcher(*params, **kw)
    res["bwd_launch_ms"] = parts_ms(lambda: attn_ops.tiled_attn_bwd_launch_ms(
        x, g, *params, **kw, launcher=launcher), reps)
    res["bwd_launch_sum_ms"] = sum(res["bwd_launch_ms"].values())
    res["plan"] = attn_ops.tiled_plan(B, C, L)._asdict()
    return res


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shapes", default="ddpmpp,nf32", help=f"of {sorted(SHAPES)}")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tiled_attn_parts: needs a CUDA card")
    device = torch.device("cuda")
    card = micro_cf_script.describe(device)
    out = []
    for which in args.shapes.split(","):
        res = measure(which, args.reps, device)
        res["card"] = card
        print(json.dumps(res, default=str), flush=True)
        out.append(res)
    return out


if __name__ == "__main__":
    main()
