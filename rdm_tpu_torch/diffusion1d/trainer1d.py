"""Trainer of the legacy 1-D DDPM pipeline.

* a 90/10 train/validation split drawn from ``numpy.random.default_rng(
  training_random_seed)``, and batches drawn with replacement from
  ``default_rng(0)``: the JAX package's rows, batch for batch;
* global-norm clipping, then Adam(lr, betas (0.9, 0.99), eps 1e-8)
  (``training.losses.ClipAdamWarmup``, optax's semantics), over gradients
  averaged across ``gradient_accumulate_every`` microbatches; a step is
  applied whatever the loss, as in the reference;
* the EMA of ``ema_pytorch``: every ``ema_update_every`` steps
  ``e = e * beta + p * (1 - beta)`` with ``beta = clip(1 - (1 + n)^(-2/3),
  0, ema_decay)`` after a burn-in of 100 EMA updates (beta 0 before);
* per-epoch validation loss (the live weights), the two best checkpoints
  ``model-epoch-N.pt`` kept, and a ``metrics.jsonl`` of the losses.

A training step reads its loss and gradient norm back in one host
synchronisation.  The weights start from ``UNet1D.init_weights`` with a
generator on the device seeded by ``training_random_seed``; the draws of the
loss come from one seeded with ``training_random_seed + 1``.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..training.checkpoints import restore_unet1d_checkpoint, save_unet1d_checkpoint
from ..training.losses import ClipAdamWarmup


class Trainer1D:
    def __init__(self, diffusion_model, dataset, *, train_batch_size=16,
                 gradient_accumulate_every=1, train_lr=1e-4, train_num_steps=100_000,
                 ema_update_every=10, ema_decay=0.995, adam_betas=(0.9, 0.99),
                 results_folder="./results", max_grad_norm=1.0, training_random_seed=0,
                 device=None, **_):
        self.device = resolve_device(device)
        self.diffusion = diffusion_model
        self.model = diffusion_model.model
        self.batch_size = train_batch_size
        self.gradient_accumulate_every = gradient_accumulate_every
        self.train_num_steps = train_num_steps
        self.ema_update_every = ema_update_every
        self.ema_decay = ema_decay
        self.results_folder = Path(results_folder)
        self.results_folder.mkdir(parents=True, exist_ok=True)
        self.metrics_path = self.results_folder / "metrics.jsonl"

        rng = np.random.default_rng(training_random_seed)
        data = np.stack([np.asarray(dataset[i][0]) for i in range(len(dataset))])
        labels = np.stack([np.atleast_1d(np.asarray(dataset[i][1], np.float32))
                           for i in range(len(dataset))])
        if data.ndim == 2:
            data = data[:, None, :]
        n = len(data)
        perm = rng.permutation(n)
        n_train = int(0.9 * n)
        self.train_data = data[perm[:n_train]].astype(np.float32)
        self.train_labels = labels[perm[:n_train]]
        self.val_data = data[perm[n_train:]].astype(np.float32)
        self.val_labels = labels[perm[n_train:]]
        self.batches_per_epoch = n // self.batch_size

        self.diffusion.to(self.device)
        self.model.init_weights(
            torch.Generator(device=self.device).manual_seed(training_random_seed))
        named = list(self.model.named_parameters())
        self.params = [p for _, p in named]
        self.optimizer = ClipAdamWarmup(named, lr=train_lr, beta1=adam_betas[0],
                                        beta2=adam_betas[1], eps=1e-8, grad_clip=max_grad_norm)
        self.ema_params = [p.detach().clone() for p in self.params]
        self.step = 0
        self.best_checkpoints = []
        self.generator = torch.Generator(device=self.device).manual_seed(training_random_seed + 1)

    # ------------------------------------------------------------------ #
    def _ema_beta(self, opt_step: int) -> float:
        step = max(opt_step - 100, 0)
        if step <= 0:
            return 0.0
        return float(np.clip(1 - (1 + step) ** (-2.0 / 3.0), 0.0, self.ema_decay))

    def _to_device(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def update(self, seqs, classes) -> float:
        """One optimizer step over the microbatches ``seqs`` / ``classes``
        (lists of tensors); returns their mean loss."""
        grads, losses = [], []
        for seq, cls in zip(seqs, classes):
            loss = self.diffusion(seq, cls, generator=self.generator)
            grads.append(torch.autograd.grad(loss, self.params))
            losses.append(loss.detach())
        return self.apply_gradients(grads, losses)

    def apply_gradients(self, micro_grads, micro_losses) -> float:
        """Average the microbatches' gradients and losses (each added in turn
        divided by their count), clip and Adam; one host read of the global
        norm and the loss, which is returned."""
        accum = len(micro_grads)
        grads = [torch.zeros_like(p) for p in self.params]
        loss = torch.zeros((), device=self.device)
        for g, l in zip(micro_grads, micro_losses):
            torch._foreach_add_(grads, torch._foreach_div(list(g), accum))
            loss = loss + l / accum
        norm = torch.sqrt(sum(n * n for n in torch._foreach_norm(grads)))
        norm_value, loss_value = torch.stack([norm, loss.to(norm.dtype)]).tolist()
        self.optimizer.apply(grads, norm_value)
        return loss_value

    @torch.no_grad()
    def update_ema(self) -> None:
        beta = self._ema_beta(self.step // self.ema_update_every)
        decayed = torch._foreach_mul(self.ema_params, beta)
        torch._foreach_add_(decayed, torch._foreach_mul([p.detach() for p in self.params],
                                                        1 - beta))
        for e, d in zip(self.ema_params, decayed):
            e.copy_(d)

    def train(self):
        rng = np.random.default_rng(0)
        best_val = float("inf")
        start = time.perf_counter()
        while self.step < self.train_num_steps:
            seqs, classes = [], []
            for _ in range(self.gradient_accumulate_every):
                idx = rng.integers(0, len(self.train_data), size=self.batch_size)
                seqs.append(self._to_device(self.train_data[idx]))
                classes.append(self._to_device(self.train_labels[idx]))
            loss = self.update(seqs, classes)
            self.step += 1
            self._log({"train_loss": loss, "step": self.step,
                       "time_s": time.perf_counter() - start})

            if self.step % self.ema_update_every == 0:
                self.update_ema()

            if self.step % self.batches_per_epoch == 0 and self.step != 0:
                milestone = self.step // self.batches_per_epoch
                val_loss = self.compute_validation_loss()
                self._log({"val_loss": val_loss, "epoch": milestone})
                if val_loss < best_val:
                    self.save(f"epoch-{milestone}")
                    best_val = val_loss
                    self.update_best_checkpoints(val_loss, f"epoch-{milestone}")
        print("training complete")

    @torch.no_grad()
    def compute_validation_loss(self) -> float:
        """Mean loss over the whole validation batches, batch i's draws from
        a generator seeded with its first row's index i."""
        total, nb = 0.0, 0
        for i in range(0, len(self.val_data) - self.batch_size + 1, self.batch_size):
            gen = torch.Generator(device=self.device).manual_seed(i)
            total += float(self.diffusion(self._to_device(self.val_data[i:i + self.batch_size]),
                                          self._to_device(self.val_labels[i:i + self.batch_size]),
                                          generator=gen))
            nb += 1
        return total / max(nb, 1)

    def update_best_checkpoints(self, val_loss, milestone):
        """Keep the two checkpoints of lowest validation loss."""
        self.best_checkpoints.append(
            (val_loss, str(self.results_folder / f"model-{milestone}.pt")))
        self.best_checkpoints.sort(key=lambda x: x[0])
        if len(self.best_checkpoints) > 2:
            _, path = self.best_checkpoints.pop(2)
            if os.path.exists(path):
                os.remove(path)

    # ------------------------------------------------------------------ #
    def _named(self, tensors) -> dict:
        return {n: t for (n, _), t in zip(self.model.named_parameters(), tensors)}

    def save(self, milestone):
        save_unet1d_checkpoint(str(self.results_folder / f"model-{milestone}.pt"), self.step,
                               self.model.state_dict(), self._named(self.ema_params),
                               self.optimizer.state_dict())

    @torch.no_grad()
    def load(self, milestone):
        ck = restore_unet1d_checkpoint(str(self.results_folder / f"model-{milestone}.pt"))
        self.step = ck.step
        self.model.load_state_dict(ck.model, strict=True)
        ema = ck.ema if ck.ema is not None else ck.model
        for (name, _), e in zip(self.model.named_parameters(), self.ema_params):
            e.copy_(ema[name])
        if ck.optimizer is not None:
            self.optimizer.load_state_dict(ck.optimizer)

    def _log(self, payload: dict):
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(payload) + "\n")
