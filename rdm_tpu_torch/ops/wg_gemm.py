"""The launch plan of ``csrc/wg_gemm.cuh``'s Hopper GEMM, which every product
of the tiled bodies runs on (``fused_resblock_tiled.cu``: both convolutions
and the NIN; ``fused_attn_block_tiled.cu``: the forward's q/k/v and output
products and the backward's do, dq, dk, dv, dh and weight gradients),
computed here as the source computes it, so that the CPU tests can hold its
tiles, split of K, ring and shared memory to their rules at every shape of
the configs; a card test holds the built library's plan equal to this one."""
from __future__ import annotations

from typing import NamedTuple

# The Hopper GEMM of the tiled bodies (``csrc/wg_gemm.cuh``): 128-row tiles,
# K in stages of 64, persistent blocks of two consumer warpgroups, a producer
# warp and four epilogue warps, at most WG_SMS of them (a constant, so the
# split of K and hence every sum is the same on every card).
WG_BM = 128
WG_THREADS = 416        # two consumer warpgroups, a producer warp, four epilogue warps
WG_SMS = 132
WG_MAX_SPLITS = 16
WG_MAX_N = 1024         # columns of a product at most
WG_TEMB_MAX = 8192      # temb values of a tile's samples kept in shared memory


class GemmPlan(NamedTuple):
    """One product of ``wg_gemm_kernel``, as ``wg_plan`` computes it."""
    bm: int            # tile rows (two warpgroups of 64)
    bn: int            # tile columns: 128, or 64 where N < 128
    tiles_m: int
    tiles_n: int
    steps: int         # stages of K: taps x 64-channel chunks
    chunk: int         # stages of one split of K
    splits: int        # float32 partials summed in this order (1: no split)
    blocks: int        # persistent blocks
    stages: int        # the TMA ring's stages
    smem_bytes: int    # dynamic shared memory of a block
    box: tuple         # the A operand's TMA box (64, W, nh, nb) or (64, 128, 1, 1)

    def flat(self) -> tuple:
        return (*self[:10], *self.box)


NO_GEMM = GemmPlan(*(0,) * 10, (0, 0, 0, 0))


def wg_smem_bytes(bn: int) -> tuple:
    """(ring stages, dynamic shared memory) of ``wg_gemm_kernel<bn>``: the
    stages of a 128 x 64 A box and a bn x 64 B box, the staged output tile,
    the bias (WG_MAX_N values) and a tile's temb rows (WG_TEMB_MAX values),
    the ring's barriers and the staging's two, 1024 bytes of alignment."""
    stages = 5 if bn == 128 else 6
    staging = max(WG_BM * (bn + 8), bn * (WG_BM + 8)) * 2
    return stages, (1024 + stages * (WG_BM * 128 + bn * 128) + staging
                    + 2 * (WG_MAX_N + WG_TEMB_MAX) + (2 * stages + 2) * 8)


def _finish(tiles_m: int, N: int, steps: int, max_splits: int, box: tuple) -> GemmPlan:
    """The plan once the M tiles and the stages are known (``wg_finish_plan``):
    K is split only where the tiles fill less than half of WG_SMS, in at most
    ``max_splits``."""
    cdiv = lambda a, b: -(-a // b)
    bn = 128 if N >= 128 else 64
    tiles_n = cdiv(N, bn)
    tiles = tiles_m * tiles_n
    s = min(WG_SMS // tiles, max_splits, steps) if 2 * tiles < WG_SMS else 1
    chunk = cdiv(steps, s)
    splits = cdiv(steps, chunk)
    stages, smem = wg_smem_bytes(bn)
    return GemmPlan(WG_BM, bn, tiles_m, tiles_n, steps, chunk, splits,
                    min(tiles * splits, WG_SMS), stages, smem, box)


def gemm_plan(conv: bool, B: int, H: int, M: int, N: int, c: int) -> GemmPlan:
    """The plan of an M x N product with K-major operands and K = 9 c (conv: B
    images of H x H) or c: a conv tile is nh whole image rows of one sample or
    nb whole samples (``wg_plan``)."""
    cdiv = lambda a, b: -(-a // b)
    steps = (9 if conv else 1) * cdiv(c, 64)
    if conv:
        nh, nb = (H, WG_BM // (H * H)) if H * H <= WG_BM else (WG_BM // H, 1)
        return _finish(cdiv(B, nb) * cdiv(H, nh), N, steps, WG_MAX_SPLITS, (64, H, nh, nb))
    return _finish(cdiv(M, WG_BM), N, steps, WG_MAX_SPLITS, (64, WG_BM, 1, 1))


def gemm_plan_rows(M: int, N: int, steps: int, mtps: int, samples: int, a_mn: bool,
                   max_splits: int) -> GemmPlan:
    """The plan of a product read through 3-D maps (``wg_plan_rows``): M x N
    outputs over ``steps`` stages of K 64; batched where ``mtps`` > 0 (that
    many M tiles a sample, each reading both operands at its sample); the A
    box 64 x 64 (MN-major, two a stage) or 64 x 128 (K-major)."""
    tiles_m = mtps * samples if mtps else -(-M // WG_BM)
    return _finish(tiles_m, N, steps, max_splits, (64, 64 if a_mn else WG_BM, 1, 1))

