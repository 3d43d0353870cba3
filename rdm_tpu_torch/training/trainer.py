"""The training loop: one card, or one process per card under torchrun (or
the CPU, when the config names it).

What it keeps of the reference loop:
  * the work-dir layout ``samples/ checkpoints/ checkpoints-meta/checkpoint.pth``
    and the ``logs`` file;
  * ``step: N, training_loss: X`` / ``evaluation_loss`` log lines every
    ``log_freq`` / ``eval_freq`` steps (the telemetry tools parse them);
  * the rolling meta checkpoint every ``snapshot_freq_for_preemption`` steps;
  * a snapshot checkpoint and EMA sampling with classifier-free guidance
    every ``snapshot_freq`` steps and at the last step, saved as
    ``samples/iter_{step}/sample_{rank}.npy`` (uint8, NHWC) and a PNG grid
    when matplotlib is installed;
  * resume from ``checkpoint_path`` or the meta checkpoint, with the
    optimizer state;
  * the stall watchdog (``training.stall_timeout_s``, exit status 17).

By default the GTO dataset is resident on the device and each step gathers
its batch there, with indices drawn (with replacement) from the run's
generator, as the JAX package's default path does.  With
``training.data_on_device=false`` the batches come from the host's epoch
iterators (``data.get_dataset``), as on the JAX package's host path.  All
randomness comes from one ``torch.Generator`` on the device seeded with
``seed`` (default 42); a resumed run starts that stream anew, as the JAX
package restarts its key.  ``training.prng_impl`` selects the JAX
package's random-bit generator and is read and ignored here.

Data parallelism (``parallel.mesh``): launched by ``python -m
torch.distributed.run --nproc_per_node N -m rdm_tpu_torch.run_train ...``,
each rank runs this loop on ``cuda:LOCAL_RANK`` with the same state
(initialised alike, then broadcast from rank 0; a checkpoint is restored by
every rank from the same file) on ``batch // N`` rows a step, and the
training step averages the gradients.  Rank 0 keeps ``seed``; rank r draws
from a seed derived from ``(seed, r)``.  Rank 0 writes the logs and the
checkpoints, with a barrier after each checkpoint; every rank saves its own
snapshot samples; the evaluation loss is averaged over the ranks.
"""
from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from ..benchmark.common import SAMPLING_EPS
from ..data import get_dataset, load_arrays
from ..parallel import mesh
from ..models import create_model
from ..models.registry import get_cf_score_fn, get_score_fn
from ..run_vis import save_grid
from ..sampling import get_sampling_fn
from ..sde import get_sde
from ..utils import get_logger, makedirs
from . import checkpoints
from .losses import make_eval_step, make_train_step, make_train_step_on_device
from .state import init_train_state


class StallWatchdog:
    """Exit the process with status 17 when the loop makes no progress for
    ``timeout_s`` seconds: a hung device call neither returns nor raises,
    so the only way on is a restart from the meta checkpoint by a
    supervising loop, which tells a stall from a crash by the status."""

    EXIT_CODE = 17

    def __init__(self, timeout_s: float, logger):
        self.timeout_s = timeout_s
        self._logger = logger
        self._beat = time.time()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()

    def beat(self):
        self._beat = time.time()

    def stop(self):
        self._stop.set()

    def _watch(self):
        while not self._stop.wait(min(30.0, self.timeout_s / 4)):
            stalled = time.time() - self._beat
            if stalled > self.timeout_s:
                self._logger.error(
                    "STALL WATCHDOG: no training progress for %.0f s "
                    "(device call hung?); exiting %d for supervised "
                    "restart from the meta checkpoint.", stalled, self.EXIT_CODE)
                for h in self._logger.handlers:
                    h.flush()
                os._exit(self.EXIT_CODE)


def _snapshot_sampler(cfg, sde, model, device, classes: bool, batch: int):
    """``sample(generator) -> (B, C, H, W)`` with the model's current
    weights: PC sampling at ``batch`` (the rank's share of the training
    batch), with per-sample guidance weights 4 U(0, 1) and zero labels when
    the data has classes."""
    shape = (batch, cfg.data.num_channels, cfg.data.image_size,
             cfg.data.get("image_width", cfg.data.image_size))
    sampling_fn = get_sampling_fn(cfg, sde, shape, SAMPLING_EPS)

    def sample(generator):
        if classes:
            labels = torch.zeros((shape[0], cfg.model.get("num_classes", 1)), device=device)
            weight = 4.0 * torch.rand((shape[0],), generator=generator, device=device)
            score_fn = get_cf_score_fn(sde, model, labels, weight)
        else:
            score_fn = get_score_fn(sde, model)
        return sampling_fn(score_fn, generator)[0]

    return sample


def run(cfg, work_dir: str, checkpoint_path: str | None = None) -> None:
    sample_dir = os.path.join(work_dir, "samples")
    checkpoint_dir = os.path.join(work_dir, "checkpoints")
    checkpoint_meta = os.path.join(work_dir, "checkpoints-meta", "checkpoint.pth")
    restore_path = checkpoint_path if checkpoint_path else checkpoint_meta
    device = mesh.setup(cfg.get("device"))
    rank, world = mesh.rank(), mesh.world_size()
    if rank == 0:
        for d in (sample_dir, checkpoint_dir, os.path.dirname(checkpoint_meta)):
            makedirs(d)
    mesh.barrier()
    # rank 0 writes the log file; the other ranks log to their console only
    logger = get_logger(os.path.join(work_dir, "logs"), saving=rank == 0)
    mprint = logger.info

    mprint(f"device: {device}"
           + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
           + (f", rank {rank} of {world}" if world > 1 else ""))
    if cfg.data.dataset != "GTOHaloImage":
        raise NotImplementedError(f"dataset {cfg.data.dataset} is not ported")
    batch = mesh.per_rank(cfg.training.batch_size, "Train")
    mesh.per_rank(cfg.eval.batch_size, "Eval")
    mesh.prebuild_kernels(device)

    model = create_model(cfg).init_weights(torch.Generator().manual_seed(0)).to(device)
    sde = get_sde(cfg)
    state = init_train_state(model, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    mprint(f"model: {cfg.model.name} ({n_params:,} params), sde: RVESDE("
           f"{cfg.sde.sigma_min}, {cfg.sde.sigma_max}, N={cfg.sde.num_scales})")

    ckpt = checkpoints.restore_checkpoint(restore_path)
    if ckpt is not None:
        checkpoints.load_into_state(state, ckpt)
        if ckpt.optimizer is None:
            mprint(f"{restore_path} holds no optimizer state this package reads; "
                   "the optimizer starts fresh")
    mesh.broadcast_state_(state)
    initial_step = int(state.step)

    classes = bool(cfg.data.get("classes", False))
    train_iter, eval_iter = get_dataset(cfg)
    data_on_device = cfg.training.get("data_on_device", True) is not False
    remat = cfg.training.get("remat", "none")
    if data_on_device:
        imgs_np, lbls_np = load_arrays(cfg)
        images = torch.from_numpy(imgs_np).to(device)
        labels = torch.from_numpy(lbls_np).to(device)
        mprint(f"dataset resident on device ({(imgs_np.nbytes + lbls_np.nbytes) / 1e6:.1f} MB)")
        device_step = make_train_step_on_device(
            sde, use_labels=classes, reduce_mean=cfg.training.reduce_mean,
            likelihood_weighting=cfg.training.likelihood_weighting,
            batch_size=batch, remat=remat)
    else:
        host_step = make_train_step(sde, reduce_mean=cfg.training.reduce_mean,
                                    likelihood_weighting=cfg.training.likelihood_weighting,
                                    remat=remat)
    eval_step = make_eval_step(sde, reduce_mean=cfg.training.reduce_mean,
                               likelihood_weighting=cfg.training.likelihood_weighting)
    if cfg.training.snapshot_sampling:
        snapshot_sample = _snapshot_sampler(cfg, sde, model, device, classes, batch)

    num_train_steps = cfg.training.n_iters
    if cfg.training.get("prng_impl") is not None:
        mprint(f"training.prng_impl={cfg.training.prng_impl} selects the JAX package's "
               "random-bit generator; ignored here (torch.Generator)")
    mprint(f"Starting training loop at step {initial_step}.")
    generator = torch.Generator(device=device).manual_seed(
        mesh.rank_seed(int(cfg.get("seed", 42))))

    stall_timeout = float(cfg.training.get("stall_timeout_s", 0) or 0)
    watchdog = StallWatchdog(stall_timeout, logger) if stall_timeout > 0 else None

    if data_on_device:
        mprint(f"TRAINING: First batch class labels: {lbls_np[:10].ravel()} "
               "(on-device sampling)")
    t_last = time.time()
    for step in range(initial_step, num_train_steps + 1):
        if watchdog is not None:
            watchdog.beat()
        if data_on_device:
            loss = device_step(state, images, labels, generator)
        else:
            imgs_b, lbls_b = next(train_iter)
            if step == initial_step:
                mprint(f"TRAINING: First batch class labels: {lbls_b[:10].ravel()}")
            loss = host_step(state, torch.from_numpy(imgs_b).to(device),
                             torch.from_numpy(lbls_b).to(device) if classes else None,
                             generator)

        if step % cfg.training.log_freq == 0:
            mprint("step: %d, training_loss: %.5e" % (step, float(loss)))

        if step != 0 and step % cfg.training.snapshot_freq_for_preemption == 0:
            if rank == 0:
                checkpoints.save_checkpoint(checkpoint_meta, state, config=cfg)
            mesh.barrier()

        if step % cfg.training.eval_freq == 0:
            eimgs, elabels = next(eval_iter)
            eval_loss = eval_step(state, torch.from_numpy(eimgs).to(device),
                                  torch.from_numpy(elabels).to(device) if classes else None,
                                  generator)
            eval_loss = mesh.mean_over_ranks(float(eval_loss))
            mprint("step: %d, evaluation_loss: %.5e" % (step, eval_loss))

        if (step != 0 and step % cfg.training.snapshot_freq == 0) or step == num_train_steps:
            save_step = step // cfg.training.snapshot_freq
            if rank == 0:
                checkpoints.save_checkpoint(
                    os.path.join(checkpoint_dir, f"checkpoint_{save_step}.pth"), state,
                    config=cfg)
            mesh.barrier()
            if cfg.training.snapshot_sampling:
                mprint(f"Generating samples at step: {step}")
                with torch.no_grad(), state.ema.average_parameters(state.params):
                    sample = snapshot_sample(generator).float().permute(0, 2, 3, 1).cpu().numpy()
                this_dir = os.path.join(sample_dir, f"iter_{step}")
                makedirs(this_dir)
                np.save(os.path.join(this_dir, f"sample_{rank}"),   # NHWC, as the JAX package
                        np.clip(np.round(sample * 255), 0, 255).astype(np.uint8))
                save_grid(sample, os.path.join(this_dir, f"sample_{rank}.png"))
            dt = time.time() - t_last
            mprint(f"snapshot at step {step} done ({dt:.1f}s since last)")
            t_last = time.time()

    if watchdog is not None:
        watchdog.stop()

