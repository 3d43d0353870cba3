"""Score-matching loss, optimizer and the training and evaluation steps.

* loss: t ~ U(eps, T), z ~ N(0, 1); perturbed = reflect(mean + std z);
  target = score_hk(perturbed, mean, std); loss = weight ||score - target||^2
  with weight = sigma^2 (or g^2 under likelihood weighting), summed over the
  dimensions times 0.5 when ``reduce_mean`` is off, averaged over the batch.
  ``t`` and ``z`` can be passed in instead of drawn.
* optimizer: global-norm clipping, then Adam, then the linear warmup of the
  learning rate, with optax's semantics (``ClipAdamWarmup``).
* update: skipped when the loss or a gradient is not finite; the parameters,
  the optimizer's moments and counts, and the EMA stay as they were and only
  ``step`` advances.

The step functions update the ``TrainState`` in place.  Each does one host
synchronisation, to read whether the step is finite and the gradient norm.
Randomness (t, z, the dropout and label-drop masks, the on-device batch
indices) comes from the ``torch.Generator`` the caller passes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import cube

f32 = np.float32


def _bcast(v, x):
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


class ClipAdamWarmup:
    """optax's ``chain(clip_by_global_norm(grad_clip), scale_by_adam(beta1,
    beta2, eps), scale_by_schedule(-lr * min(count / warmup, 1)))`` followed
    by ``apply_updates``, in float32:

    * clipping scales every gradient by ``max_norm / norm`` (as
      ``(g / norm) * max_norm``) when ``norm >= max_norm``;
    * Adam keeps ``mu``, ``nu`` and ``count`` and returns
      ``mu_hat / (sqrt(nu_hat) + eps)`` with the bias corrections of
      ``count + 1``;
    * the schedule reads the count of updates applied so far
      (``schedule_count``), so the first update has learning rate 0 under
      warmup.

    A negative ``grad_clip`` turns clipping off.  The parameters are updated
    in place.
    """

    def __init__(self, named_params, lr: float, warmup: int = 0, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8, grad_clip: float = -1.0):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.lr, self.warmup = float(lr), int(warmup)
        self.beta1, self.beta2, self.eps = float(beta1), float(beta2), float(eps)
        self.grad_clip = float(grad_clip)
        self.count = 0
        self.schedule_count = 0
        self.mu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for p in self.params]

    def learning_rate(self, count: int) -> float:
        """The schedule's step size at ``count`` applied updates (float32)."""
        if self.warmup > 0:
            return float(f32(self.lr) * np.minimum(f32(count) / f32(self.warmup), f32(1.0)))
        return float(f32(self.lr))

    @torch.no_grad()
    def check(self, loss, grads):
        """``(finite, global_norm)`` of the loss and gradients, read to the
        host in one synchronisation."""
        finite = torch.isfinite(loss)
        for n in torch._foreach_norm(grads, float("inf")):
            finite = finite & torch.isfinite(n)
        norm = torch.sqrt(sum(n * n for n in torch._foreach_norm(grads)))
        ok, value = torch.stack([finite.to(norm.dtype), norm]).tolist()
        return bool(ok), value

    @torch.no_grad()
    def apply(self, grads, global_norm: float) -> None:
        """One update from finite ``grads`` whose global norm is given."""
        if self.grad_clip >= 0 and not global_norm < self.grad_clip:
            grads = torch._foreach_div(grads, float(f32(global_norm)))
            torch._foreach_mul_(grads, self.grad_clip)
        b1, b2 = self.beta1, self.beta2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1.0 - b2))
        self.count += 1
        n = f32(self.count)
        bc1 = float(f32(1.0) - f32(b1) ** n)
        bc2 = float(f32(1.0) - f32(b2) ** n)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -self.learning_rate(self.schedule_count))
        self.schedule_count += 1
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> dict:
        """Counts and moments, the moments keyed by parameter name."""
        return {"count": self.count, "schedule_count": self.schedule_count,
                "mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.schedule_count = int(state["schedule_count"])
        for name, m, v in zip(self.names, self.mu, self.nu):
            m.copy_(state["mu"][name])
            v.copy_(state["nu"][name])


def get_optimizer(config, named_params) -> ClipAdamWarmup:
    """The optimizer of ``config.optim`` over ``named_params``."""
    opt = config.optim
    if opt.optimizer not in ("Adam", "AdamW"):
        raise NotImplementedError(f"Optimizer {opt.optimizer} not supported yet!")
    if opt.get("weight_decay", 0):
        raise NotImplementedError("weight decay is not ported (every config runs 0)")
    return ClipAdamWarmup(named_params, lr=opt.lr, warmup=opt.get("warmup", 0),
                          beta1=opt.beta1, beta2=opt.beta2, eps=float(opt.eps),
                          grad_clip=opt.get("grad_clip", -1))


def get_loss_fn(sde, train: bool, reduce_mean: bool = True,
                likelihood_weighting: bool = True, eps: float = 1e-5, remat: str = "none"):
    """Returns ``loss_fn(model, batch, class_labels, generator, t=None,
    z=None) -> scalar``; ``t`` and ``z`` replace the draws when given.
    ``remat`` takes only ``"none"`` (the JAX package's recompute policies
    are not ported)."""
    if remat != "none":
        raise NotImplementedError(f"remat policy {remat!r} is not ported (only 'none')")

    def loss_fn(model, batch, class_labels, generator, t=None, z=None):
        B = batch.shape[0]
        if t is None:
            t = torch.rand((B,), generator=generator, dtype=batch.dtype,
                           device=batch.device) * (sde.T - eps) + eps
        if z is None:
            z = torch.randn(batch.shape, generator=generator, dtype=batch.dtype,
                            device=batch.device)
        mean, std = sde.marginal_prob(batch, t)
        perturbed = cube.reflect(mean + _bcast(std, batch) * z)
        _, time_cond = sde.marginal_prob(torch.zeros_like(batch), t)
        score = model(perturbed, time_cond, class_labels, train=train,
                      generator=generator if train else None)
        target = cube.score_hk(perturbed, mean, std)
        if likelihood_weighting:
            _, g = sde.sde(torch.zeros_like(batch), t)
            weight = g ** 2
        else:
            weight = std ** 2
        sq = (_bcast(weight, batch) * (score - target) ** 2).reshape(B, -1)
        per_sample = sq.mean(-1) if reduce_mean else 0.5 * sq.sum(-1)
        return per_sample.mean()

    return loss_fn


def guarded_update(state, loss, grads) -> bool:
    """Optimizer update and EMA step, skipped entirely when the loss or a
    gradient is not finite; ``step`` advances either way.  Returns whether
    the update was applied."""
    finite, norm = state.optimizer.check(loss, grads)
    if finite:
        state.optimizer.apply(grads, norm)
        state.ema.update(state.params)
    state.step += 1
    return finite


def make_train_step(sde, reduce_mean=False, likelihood_weighting=False, remat="none"):
    """``step_fn(state, batch, class_labels, generator, t=None, z=None) ->
    loss``: gradients, the guarded update and the EMA step."""
    loss_fn = get_loss_fn(sde, train=True, reduce_mean=reduce_mean,
                          likelihood_weighting=likelihood_weighting, remat=remat)

    def step_fn(state, batch, class_labels, generator, t=None, z=None):
        loss = loss_fn(state.model, batch, class_labels, generator, t=t, z=z)
        grads = torch.autograd.grad(loss, state.params)
        guarded_update(state, loss, list(grads))
        return loss.detach()

    return step_fn


def make_train_step_on_device(sde, use_labels: bool, batch_size: int, reduce_mean=False,
                              likelihood_weighting=False, remat="none"):
    """``step_fn(state, images, labels, generator) -> loss`` over a dataset
    resident on the device: the batch indices are drawn uniformly with
    replacement from ``generator`` and the batch is gathered there, so
    nothing but the generator's state crosses from the host."""
    train_step = make_train_step(sde, reduce_mean=reduce_mean,
                                 likelihood_weighting=likelihood_weighting, remat=remat)

    def step_fn(state, images, labels, generator):
        idx = torch.randint(0, images.shape[0], (batch_size,), generator=generator,
                            device=images.device)
        return train_step(state, images[idx], labels[idx] if use_labels else None, generator)

    return step_fn


def make_eval_step(sde, reduce_mean=False, likelihood_weighting=False):
    """``eval_fn(state, batch, class_labels, generator) -> loss`` under the
    EMA weights, without dropout; the live weights are put back after."""
    loss_fn = get_loss_fn(sde, train=False, reduce_mean=reduce_mean,
                          likelihood_weighting=likelihood_weighting)

    @torch.no_grad()
    def eval_fn(state, batch, class_labels, generator):
        with state.ema.average_parameters(state.params):
            return loss_fn(state.model, batch, class_labels, generator)

    return eval_fn
