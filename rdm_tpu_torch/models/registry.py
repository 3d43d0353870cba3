"""Model registry and score-function wrappers.

Models are ``nn.Module``s holding their weights; a score function is a
closure ``score_fn(x, t)`` over an SDE and a model."""
from __future__ import annotations

import torch

_MODELS = {}


def register_model(cls=None, *, name=None):
    """Decorator registering a model class under ``name``."""
    def _register(c):
        local_name = name if name is not None else c.__name__
        if local_name in _MODELS:
            raise ValueError(f"Already registered model with name: {local_name}")
        _MODELS[local_name] = c
        return c
    return _register if cls is None else _register(cls)


def get_model(name):
    return _MODELS[name]


def create_model(config):
    """Instantiate the model named by ``config.model.name``."""
    return get_model(config.model.name).from_config(config)


def get_model_fn(model, train: bool = False):
    """``fn(x, time_cond, class_labels)`` evaluating ``model``."""
    def model_fn(x, time_cond, class_labels=None):
        return model(x, time_cond, class_labels, train=train)
    return model_fn


def get_score_fn(sde, model, train: bool = False):
    """Score function: the model conditions on the marginal sigma
    ``sde.marginal_prob(0, t)[1]`` and its output is the score."""
    model_fn = get_model_fn(model, train=train)

    def score_fn(x, t, class_labels=None):
        _, time_cond = sde.marginal_prob(torch.zeros_like(x), t)
        return model_fn(x, time_cond, class_labels)

    return score_fn


def get_cf_score_fn(sde, model, class_labels, weight):
    """Classifier-free-guided score ``(1 + w) s_cond - w s_uncond`` from one
    forward over the 2B batch of conditional and unconditional inputs.

    When ``weight`` is a Python scalar 0 (or None) the combination is
    exactly ``s_cond``, so only the conditional half is evaluated.  A
    tensor weight keeps the general path (per-sample weights of shape [B])."""
    score_fn = get_score_fn(sde, model, train=False)

    if weight is None or (isinstance(weight, (int, float)) and float(weight) == 0.0):
        def cond_score_fn(x, t):
            return score_fn(x, t, class_labels)
        return cond_score_fn

    def weighted_score_fn(x, t):
        B = x.shape[0]
        concat_score = score_fn(torch.cat([x, x], 0), torch.cat([t, t], 0),
                                torch.cat([class_labels, torch.zeros_like(class_labels)], 0))
        s_cond, s_uncond = concat_score[:B], concat_score[B:]
        if isinstance(weight, (int, float)):
            w = torch.full((B,), float(weight), dtype=x.dtype, device=x.device)
        else:
            w = torch.as_tensor(weight, dtype=x.dtype, device=x.device)
        w = w.reshape(-1, *([1] * (x.dim() - 1)))
        return (1.0 + w) * s_cond - w * s_uncond

    return weighted_score_fn
