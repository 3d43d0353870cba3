"""Data parallelism over cards: one process per card, replicated state,
the batch split by rank.

Counterpart of the JAX package's ``rdm_tpu/parallel/mesh.py``.  There one
process drives every chip of a ``Mesh(('data',))`` and the SPMD partitioner
inserts the gradient all-reduce.  Here each card has its own process,
started by ``python -m torch.distributed.run`` (torchrun), and the
collectives are explicit:

* ``setup`` reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` from the
  launcher's environment, makes ``cuda:LOCAL_RANK`` the current card and
  joins the process group (NCCL on the card, gloo on the CPU).  Without that
  environment the world is one process and nothing is initialised.
* ``all_reduce_mean_`` averages a list of tensors over the ranks as one
  flattened buffer (the training step's gradients and loss).
* ``broadcast_state_`` copies rank 0's parameters, buffers, Adam moments and
  EMA to every rank (``replicated``).
* ``shard_rows`` takes this rank's contiguous share of a global batch
  (``shard_host_batch``); ``gather_rows`` concatenates every rank's rows.

Batch sizes in configs stay global, as in the JAX package: each rank works
on ``batch // world``.  Under gloo a CUDA tensor is staged through the host
for every collective: that backend is a correctness path (two ranks on one
card), not a fast one.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

# Sources of the model's kernels, built once per host before the ranks use them.
MODEL_SOURCES = ("fused_attn_block", "fused_attn_block_bwd", "fused_resblock")
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def launched() -> bool:
    """Whether a launcher (torchrun) set this process's rank environment."""
    return all(k in os.environ for k in _ENV)


def env_ranks() -> tuple:
    """``(rank, world_size, local_rank)`` from the launcher's environment;
    ``(0, 1, 0)`` without it."""
    if not launched():
        return 0, 1, 0
    return tuple(int(os.environ[k]) for k in _ENV)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def local_rank() -> int:
    return env_ranks()[2]


def setup(device=None, backend: str | None = None, timeout_s: float = 600.0) -> torch.device:
    """This rank's device, with the process group joined when a launcher
    started the process.

    ``device`` None, or ``"cuda"`` without an index, is ``cuda:LOCAL_RANK``
    in a launched process, made the current card before any other CUDA work
    (``resolve_device`` alone returns the current card, which would put
    every rank on card 0); a device with an index, or ``"cpu"``, is taken as
    it is.  ``backend`` None is NCCL on a card and gloo on the CPU; a caller
    may name gloo for CUDA tensors (two ranks on one card, which NCCL
    refuses)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None and launched():
            dev = torch.device("cuda", local_rank())
        if dev.index is not None:
            torch.cuda.set_device(dev)
    if launched() and not initialized():
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def teardown() -> None:
    """Leave the process group, if this process joined one."""
    if initialized():
        dist.destroy_process_group()


def _staged(t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective runs on: a host copy of a CUDA tensor under gloo."""
    if t.is_cuda and dist.get_backend() == "gloo":
        return t.cpu()
    return t


def barrier() -> None:
    if not initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


@torch.no_grad()
def all_reduce_mean_(tensors) -> None:
    """Average ``tensors`` (one dtype) over the ranks in place, as one
    flattened buffer: one collective a call.  Every rank ends with the same
    bits.  A no-op in a world of one."""
    world = world_size()
    if world == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    buf = _staged(flat)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    if buf is not flat:
        flat.copy_(buf)
    flat.div_(world)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


@torch.no_grad()
def broadcast_(tensors, src: int = 0) -> None:
    """Copy rank ``src``'s ``tensors`` to every rank, in place."""
    if world_size() == 1:
        return
    for t in tensors:
        buf = _staged(t)
        dist.broadcast(buf, src=src)
        if buf is not t:
            t.copy_(buf)


def broadcast_state_(state, src: int = 0) -> None:
    """Replicate a ``TrainState`` from rank ``src``: the model's parameters
    and buffers, the Adam moments, the EMA shadow and the counts."""
    if world_size() == 1:
        return
    model = state.model
    broadcast_([*model.parameters(), *model.buffers(), *state.optimizer.mu,
                *state.optimizer.nu, *state.ema.shadow_params], src=src)
    counts = [state.step, state.optimizer.count, state.optimizer.schedule_count,
              state.ema.num_updates]
    dist.broadcast_object_list(counts, src=src)
    (state.step, state.optimizer.count, state.optimizer.schedule_count,
     state.ema.num_updates) = counts


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def per_rank(batch: int, what: str = "Train", world: int | None = None) -> int:
    """This rank's share of a global batch; the global batch must divide
    evenly, as in the JAX package's ``get_dataset``."""
    world = world_size() if world is None else world
    if batch % world != 0:
        raise ValueError(f"{what} batch size {batch} not divisible by {world} hosts")
    return batch // world


def shard_rows(x: torch.Tensor, rank_: int | None = None, world: int | None = None):
    """Rank ``rank_``'s contiguous rows of a global batch ``x``."""
    world = world_size() if world is None else world
    rank_ = rank() if rank_ is None else rank_
    n = per_rank(x.shape[0], world=world)
    return x[rank_ * n:(rank_ + 1) * n]


@torch.no_grad()
def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along the rows, in rank
    order, on every rank."""
    world = world_size()
    if world == 1:
        return x
    buf = _staged(x.contiguous())
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    return torch.cat(parts).to(x.device)


def _reduce_scalar(value: float, op) -> float:
    if world_size() == 1:
        return float(value)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=op)
    return float(t)


def mean_over_ranks(value: float) -> float:
    return _reduce_scalar(value, dist.ReduceOp.SUM) / world_size()


def max_over_ranks(value: float) -> float:
    return _reduce_scalar(value, dist.ReduceOp.MAX)


def rank_seed(seed: int, rank_: int | None = None) -> int:
    """The seed of rank ``rank_``'s generator: ``seed`` itself on rank 0 (a
    one-card run draws what it drew before), a seed derived from
    ``(seed, rank)`` elsewhere; the counterpart of ``fold_in(key,
    process_index)``."""
    rank_ = rank() if rank_ is None else rank_
    if rank_ == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank_)]).generate_state(1)[0])


def prebuild_kernels(device, sources=MODEL_SOURCES) -> None:
    """Build the model's kernels in local rank 0 while the other ranks wait,
    so the ranks of a host do not each run ``nvcc`` at their first launch."""
    if torch.device(device).type != "cuda" or world_size() == 1:
        return
    if local_rank() == 0:
        from ..ops import _build
        _build.build(*sources)
    barrier()
