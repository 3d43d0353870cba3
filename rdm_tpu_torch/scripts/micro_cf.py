"""Microbenchmarks of the channels-first primitives of a resblock redesign:
the port's twin of the TPU script ``scripts/micro_pallas_cf.py``.

    python -m rdm_tpu_torch.scripts.micro_cf [--device cpu] [--tb 256]

It runs on the card unless ``--device`` names another device.  At C = 64
channels and N = 81 * TB lanes it prints, in the TPU script's order, one
line each for the device, cuDNN's 3x3 convolution on (TB, 64, 9, 9)
channels-last (a library yardstick, the counterpart of XLA's convolution,
not a kernel of the port), the channels-first dots at K 64 (9 taps) and
K 192 (3 dy-slices), the 8 masked lane-rolls and the transpose pair
(N, C) -> (C, N) -> (N, C), all in bfloat16 through ``ops.micro_cf``.  Each
line gives microseconds per call and, for the products, TFLOP/s; on the
card also the bound (H100 SXM data-sheet peaks: 3.35 TB/s, 989 TFLOP/s
bf16), the share of it reached, and the time of one PyTorch call that
computes the same function: cuBLAS for the dots, ``x.t().contiguous()`` for
the transposes, and for the roll sum one ``F.conv1d`` with a filter of ones
at the shifts (``roll_sum_conv1d``).  These yardsticks are timed here only;
``ops.micro_cf`` never calls them.

Timing on the card.  *Chained*: the GPU form of the TPU script's slope.
Each call consumes the previous output, as its scan carry does; K1 = 50 and
K2 = 500 chained calls are each captured as one CUDA graph (so no host
launch cost enters), replayed between CUDA events, and the time per call is
(t2 - t1) / 450.  Every working set here is 5-11 MB, so a chained run stays
in the 50 MB L2 and can beat the device-memory bound: it is the twin of the
TPU's VMEM-resident measurement.  *Cold*: the same slope with the inputs
rotating over buffers of more than twice the L2 and a fresh output for each
call; it is the time compared with the bound.  On the CPU only the chained
time is taken, with the host clock, and no bound is printed.

Launches.  Each wrapper of ``ops.micro_cf`` counts a call when it launches
its kernel, and a call captured into a CUDA graph launches into the graph
once; the card then runs that kernel at each replay.  ``main`` returns both
numbers per wrapper: ``launches`` (the wrappers' counts) and
``kernel_runs`` (what the card ran: the eager calls plus each captured call
times the replays of its graph).
"""
from __future__ import annotations

import argparse
import math
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import micro_cf

C = 64
L = micro_cf.L_TOKENS
K1, K2 = 50, 500
L2_BYTES = 50e6
# H100 SXM data-sheet peaks: HBM bytes/s and dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
REPEATS = 5
WRAPPERS = (micro_cf.cf_transpose, micro_cf.cf_masked_roll_sum, micro_cf.cf_dots)
# kernel runs that graph replays added beyond the wrappers' counts, by name
replayed_runs = dict.fromkeys((f.__name__ for f in WRAPPERS), 0)


def bound_us(nbytes: float, flops: float = 0.0) -> tuple:
    """The least time on the card for moving ``nbytes`` and doing ``flops``
    bf16 operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e6, flops / PEAK_BF16 * 1e6
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _run_us(body, k, device, repeats=REPEATS):
    """Microseconds for ``body(k)``: on the card the median of ``repeats``
    replays of one CUDA graph of it (after one untimed replay); on the CPU
    the host clock."""
    if device.type != "cuda":
        body(2)
        t0 = time.perf_counter()
        body(k)
        return (time.perf_counter() - t0) * 1e6
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        body(2)                           # first-call set-up outside the capture
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = [f.launches for f in WRAPPERS]
    with torch.cuda.graph(graph):
        keep = body(k)                    # noqa: F841 (outputs stay allocated while replayed)
    for f, b in zip(WRAPPERS, before):
        # counted once at capture, run at each of the 1 + repeats replays
        replayed_runs[f.__name__] += (f.launches - b) * repeats
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(repeats):
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(stop) * 1e3)
    del graph, keep
    return float(np.median(times))


def slope_us(body, device) -> float:
    """(t(K2) - t(K1)) / (K2 - K1) in microseconds per call."""
    return (_run_us(body, K2, device) - _run_us(body, K1, device)) / (K2 - K1)


def chained_us(fn, x, device) -> float:
    """Per call of ``fn`` when each call consumes the previous output."""
    def body(k):
        y = x
        for _ in range(k):
            y = fn(y)
        return y
    return slope_us(body, device)


def cold_us(fn, make_input, nbytes_input, device) -> float:
    """Per call of ``fn`` with its input rotating over buffers of more than
    twice the L2 (``make_input(i)`` makes buffer i) and each call's output
    kept, so that every call reads and writes device memory."""
    bufs = [make_input(i) for i in range(math.ceil(2 * L2_BYTES / nbytes_input) + 1)]
    return slope_us(lambda k: [fn(bufs[i % len(bufs)]) for i in range(k)], device)


def randn(shape, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)


def roll_sum_conv1d(x, L=L, shifts=micro_cf.SHIFTS):
    """The masked roll sum as one ``F.conv1d`` call (a library yardstick,
    not the port's path): each L-token sample of (C, N) ``x`` becomes a row
    of a (C * N / L, 1, L) batch, and a filter of ones at offsets s + m,
    with zero padding m = max |s|, adds ``x[c, n + s]`` where ``n % L + s``
    stays in the sample.  It equals the plain version up to the order of
    the float32 sum.  Returns the function of ``x``, its filter made once."""
    m = max(abs(s) for s in shifts)
    w = torch.zeros((1, 1, 2 * m + 1), dtype=x.dtype, device=x.device)
    w[0, 0, [s + m for s in shifts]] = 1
    C, N = x.shape
    return lambda y: F.conv1d(y.view(C * N // L, 1, L), w, padding=m).view(C, N)


def _card_fields(nbytes, flops, cold, library):
    """The card's numbers of a line: bytes and operations it must move and
    do, its bound, the cold time and its share of the bound, and the
    library call's cold time."""
    b, by = bound_us(nbytes, flops)
    return dict(bytes=nbytes, flops=flops, bound_us=b, bound_by=by, cold_us=cold,
                share_of_bound=b / cold, library_us=library)


def _fmt(r, name):
    line = f"{name:<36s} chained {r['chained_us']:8.2f} us"
    if "cold_us" in r:
        line += f"  cold {r['cold_us']:8.2f} us"
    if r.get("flops"):
        line += f" -> {r['flops'] / r['chained_us'] * 1e-6:6.1f} TF/s chained"
        if "cold_us" in r:
            line += f", {r['flops'] / r['cold_us'] * 1e-6:6.1f} cold"
    if "bound_us" in r:
        line += (f"; bound {r['bound_us']:.2f} us ({r['bound_by']}), "
                 f"{100 * r['share_of_bound']:.1f} % of it")
    if "library" in r and "library_us" in r:
        line += f"; {r['library']}: {r['library_us']:.2f} us"
    return line


def bench_xla_conv(tb, device):
    """cuDNN's 3x3 convolution, SAME padding, on (TB, 64, 9, 9) bf16
    channels-last: the library yardstick of the TPU script's XLA conv."""
    cl = torch.channels_last
    w = randn((C, C, 3, 3), 0, device).contiguous(memory_format=cl)
    fn = lambda y: F.conv2d(y, w, padding=1)
    make = lambda i: randn((tb, C, 9, 9), 1 + i, device).contiguous(memory_format=cl)
    r = dict(chained_us=chained_us(fn, make(0), device), flops=2 * 9 * C * C * L * tb)
    if device.type == "cuda":
        nbytes = 2 * (2 * tb * C * L + 9 * C * C)
        r.update(_card_fields(nbytes, r["flops"], cold_us(fn, make, 2 * tb * C * L, device), None))
    print(_fmt(r, f"cuDNN conv3x3 NHWC (TB={tb}):"), flush=True)
    return r


def bench_dots(K, tb, device):
    """``ops.micro_cf.cf_dots``: taps x (C x K) @ (K x N) with one float32
    sum; for K != C the output is stacked K / C times, as in the TPU script,
    so that the chained call keeps its shape."""
    N = L * tb
    taps = micro_cf.dots_taps(C, K)
    w = randn((taps, C, K), 0, device)

    def fn(y):
        out = micro_cf.cf_dots(w, y, K)
        return torch.cat([out] * (K // C), dim=0) if K != C else out

    make = lambda i: randn((max(K, C), N), 1 + i, device)
    flops = taps * 2 * C * K * N
    r = dict(chained_us=chained_us(fn, make(0), device), flops=flops, library="cuBLAS")
    if device.type == "cuda":
        nbytes = 2 * (taps * C * K + K * N + C * N)
        cold = cold_us(lambda y: micro_cf.cf_dots(w, y, K), make, 2 * K * N, device)
        # one cuBLAS product over the taps stacked along the depth; the
        # repeated x is built outside the timed region
        w2 = w.permute(1, 0, 2).reshape(C, taps * K)
        lib = cold_us(lambda xr: torch.matmul(w2, xr), lambda i: make(i)[:K].repeat(taps, 1),
                      2 * taps * K * N, device)
        r.update(_card_fields(nbytes, flops, cold, lib))
    print(_fmt(r, f"{taps} dots (C={C},K={K})@(K,N={N}):"), flush=True)
    return r


def bench_roll(tb, device):
    """``ops.micro_cf.cf_masked_roll_sum`` on (C, N): 8 masked shifted adds."""
    N = L * tb
    fn = micro_cf.cf_masked_roll_sum
    make = lambda i: randn((C, N), 1 + i, device)
    r = dict(chained_us=chained_us(fn, make(0), device), library="F.conv1d")
    if device.type == "cuda":
        nbytes = 2 * 2 * C * N
        lib = cold_us(roll_sum_conv1d(make(0)), make, nbytes / 2, device)
        r.update(_card_fields(nbytes, 0.0, cold_us(fn, make, nbytes / 2, device), lib))
    print(_fmt(r, "8 masked lane-rolls (C,N):"), flush=True)
    return r


def bench_transpose(tb, device):
    """``ops.micro_cf.cf_transpose`` both ways, (N, C) -> (C, N) -> (N, C),
    beside ``x.t().contiguous()``; on the card also each direction alone."""
    N = L * tb
    fn = lambda y: micro_cf.cf_transpose(micro_cf.cf_transpose(y))
    make_nc = lambda i: randn((N, C), 1 + i, device)
    r = dict(chained_us=chained_us(fn, make_nc(0), device), library="x.t().contiguous() pair")
    each = {}
    if device.type == "cuda":
        nbytes = 2 * C * N
        lib = lambda y: y.t().contiguous().t().contiguous()
        r.update(_card_fields(2 * 2 * nbytes, 0.0, cold_us(fn, make_nc, nbytes, device),
                              cold_us(lib, make_nc, nbytes, device)))
        make_cn = lambda i: randn((C, N), 100 + i, device)
        for key, make in (("nc_to_cn", make_nc), ("cn_to_nc", make_cn)):
            e = dict(cold_us=cold_us(micro_cf.cf_transpose, make, nbytes, device),
                     chained_us=chained_us(lambda y: micro_cf.cf_transpose(y).view(y.shape),
                                           make(0), device),
                     library_us=cold_us(lambda y: y.t().contiguous(), make, nbytes, device))
            e["bound_us"], e["bound_by"] = bound_us(2 * nbytes)
            e["share_of_bound"] = e["bound_us"] / e["cold_us"]
            each[key] = e
    print(_fmt(r, "transpose pair (N,C)<->(C,N):"), flush=True)
    for key, e in each.items():
        print(f"  one way {key}: cold {e['cold_us']:.2f} us, chained {e['chained_us']:.2f} us, "
              f"bound {e['bound_us']:.2f} us ({100 * e['share_of_bound']:.1f} %), "
              f"x.t().contiguous() {e['library_us']:.2f} us", flush=True)
    r["one_way"] = each
    return r


def describe(device) -> str:
    if device.type != "cuda":
        return f"device: {device} (host clock; no card numbers), torch {torch.__version__}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    return (f"device: {device} {torch.cuda.get_device_name(device)} "
            f"[nvidia-smi: {smi[0] if smi else 'not read'}], torch {torch.__version__}")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--tb", type=int, default=256,
                   help="samples of 81 lanes: N = 81 * TB (on the card a multiple of 8)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.tb < 1:
        raise ValueError(f"--tb {args.tb}")
    line = describe(device)
    print(line, flush=True)
    start = {f.__name__: f.launches for f in WRAPPERS}
    replayed_runs.update(dict.fromkeys(start, 0))
    out = {"device": line, "tb": args.tb, "N": L * args.tb,
           "conv": bench_xla_conv(args.tb, device),
           "dots_k64": bench_dots(C, args.tb, device),
           "dots_k192": bench_dots(3 * C, args.tb, device),
           "roll": bench_roll(args.tb, device),
           "transpose_pair": bench_transpose(args.tb, device)}
    out["launches"] = {f.__name__: f.launches - start[f.__name__] for f in WRAPPERS}
    out["kernel_runs"] = {k: n + replayed_runs[k] for k, n in out["launches"].items()}
    if device.type == "cuda":
        print(f"launches (wrapper counts, a graph capture counted once): {out['launches']}; "
              f"kernel runs on the card: {out['kernel_runs']}", flush=True)
    return out


if __name__ == "__main__":
    main()
