"""What a piece of eager PyTorch work costs in bytes moved and operations.

PyTorch has no ``cost_analysis()``: an eager program is a sequence of aten
operations, each its own kernel.  ``count_costs`` runs a callable under two
dispatch modes:

* ``torch.utils.flop_counter.FlopCounterMode`` counts the operations of the
  products and convolutions it knows (matmuls, convolutions, attention);
  elementwise work, reductions and normalisations count no operations;
* ``ByteCounter`` adds up, for every aten operation that is not a view, the
  bytes of its tensor inputs and outputs: each operation reads its inputs and
  writes its outputs once, the eager counterpart of XLA's "bytes accessed".

The hand-written attention kernels are called through ctypes from inside
``ops.attention``'s wrappers, where no dispatch mode sees them.  Inside
``count_costs`` each direction of the block that calls a wrapper runs with
the modes off (on the CPU, where the wrapper runs its plain version, those
aten operations are not counted either, so a count does not depend on the
device) and adds the kernel's bytes and operations from the formulas below,
which are also the formulas of the smoke's bounds: ``modeled`` holds those,
``counted`` what the modes saw.
No L2 or HBM counter is readable on the card machine, so neither is a
measured traffic.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..ops import attention as attn_ops

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; dense tensor-core FLOP/s
# for bf16 and TF32; float32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_FLOPS_TF32 = 495e12


def bound_ms(nbytes: float, ops: float, flops_per_s: float) -> tuple:
    """Least time in ms for work that moves ``nbytes`` and does ``ops`` at
    ``flops_per_s``: the larger of the two times at the card's peaks, and
    which of them ("bytes" or "operations") it is."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_fwd_cost(B: int, C: int, L: int, elt: int) -> tuple:
    """(bytes, operations) of one fused attention block: x read and the
    output written once, the four C x C weights and six vectors once; the
    q/k/v and output products (4 x 2 L C^2 a sample), the scores and p.v
    (2 x 2 L^2 C)."""
    return ((2 * B * C * L + 4 * C * C + 6 * C) * elt,
            B * (4 * 2 * L * C * C + 2 * 2 * L * L * C))


def attn_bwd_cost(B: int, C: int, L: int, elt: int) -> tuple:
    """(bytes, operations) of the block's backward: x and g read, dx written
    once, the parameters and their float32 gradients beside them; the
    recomputed q, k, v, scores and p.v (6 L C^2 + 4 L^2 C a sample) and the
    backward products (16 L C^2 + 8 L^2 C)."""
    return (3 * B * C * L * elt + (4 * C * C + 6 * C) * (elt + 4),
            B * (22 * L * C * C + 12 * L * L * C))


def resblock_cost(B: int, H: int, ci: int, co: int, elt: int) -> tuple:
    """(bytes, operations) of one fused resblock: x, tembv and the
    parameters read once, the output written once; the two 3x3 convolutions
    and the NIN shortcut (a multiply-add counts 2)."""
    L = H * H
    shortcut = ci * co if ci != co else 0
    weights = 9 * ci * co + 9 * co * co + shortcut + 2 * ci + 4 * co + (co if shortcut else 0)
    return ((B * L * (ci + co) + B * co + weights) * elt,
            2 * B * L * (9 * ci * co + 9 * co * co + shortcut))


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class ByteCounter(TorchDispatchMode):
    """Adds the bytes of every non-view aten operation's tensor inputs and
    outputs to ``self.bytes`` (an in-place operation reads and writes its
    tensor: both count)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.ops += 1
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs or {})))
            self.bytes += sum(_nbytes(t) for t in tree_leaves(out))
        return out


@contextlib.contextmanager
def _modeled_attention(tally: dict):
    """For the duration, each direction of ``ops.attention.FusedAttnBlockFn``
    that takes the kernels' wrappers runs with the dispatch modes off and adds
    the formulas' bytes and operations to ``tally``; the plain direction stays
    counted by the modes.  The wrappers and their launch counts are left
    alone."""
    fn = attn_ops.FusedAttnBlockFn
    saved = fn.__dict__["forward"], fn.__dict__["backward"]
    fwd, bwd = fn.forward, fn.backward

    def modeled(direction, cost, key, x, use_kernel, *call):
        if not use_kernel:
            return direction(*call)
        B, C, H, W = x.shape
        nbytes, flops = cost(B, C, H * W, x.element_size())
        tally[key] = tally.get(key, 0) + 1
        tally["bytes"] += nbytes
        tally["flops"] += flops
        with _disable_current_modes():
            return direction(*call)

    def forward(ctx, x, *args):
        return modeled(fwd, attn_fwd_cost, "fused_attn_block", x, args[-1], ctx, x, *args)

    def backward(ctx, g):
        return modeled(bwd, attn_bwd_cost, "fused_attn_block_bwd", g, ctx.opts[-1], ctx, g)

    fn.forward, fn.backward = staticmethod(forward), staticmethod(backward)
    try:
        yield
    finally:
        fn.forward, fn.backward = saved


def count_costs(fn) -> dict:
    """Run ``fn()`` once under the counters: ``counted`` (operations and
    bytes of the aten operations the dispatch modes saw, and how many),
    ``modeled`` (bytes and operations of the hand-written kernel calls, by
    the formulas above, and the calls by wrapper), and their sums."""
    tally = {"bytes": 0, "flops": 0}
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    with _modeled_attention(tally), flops, nbytes:
        fn()
    counted = {"flops": int(flops.get_total_flops()), "bytes": int(nbytes.bytes),
               "aten_ops": nbytes.ops}
    return {"flops": counted["flops"] + tally["flops"],
            "bytes": counted["bytes"] + tally["bytes"],
            "counted": counted, "modeled": tally}
