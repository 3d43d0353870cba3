"""Sampling: registries of predictors, correctors and denoisers, and the
dispatch on ``config.sampling.method``."""
from __future__ import annotations

_PREDICTORS = {}
_CORRECTORS = {}
_DENOISERS = {}


def _make_register(table, kind):
    def register(fn=None, *, name=None):
        def _register(f):
            local = name if name is not None else f.__name__
            if local in table:
                raise ValueError(f"Already registered {kind} with name: {local}")
            table[local] = f
            return f
        return _register if fn is None else _register(fn)
    return register


register_predictor = _make_register(_PREDICTORS, "predictor")
register_corrector = _make_register(_CORRECTORS, "corrector")
register_denoiser = _make_register(_DENOISERS, "denoiser")


def get_predictor(name):
    return _PREDICTORS[name.lower()]


def get_corrector(name):
    return _CORRECTORS[name.lower()]


def get_denoiser(name):
    return _DENOISERS[name.lower()]


from . import pc as _pc  # noqa: E402,F401  (registers the PC components)
from .pc import get_pc_sampler  # noqa: E402,F401


def get_sampling_fn(config, sde, shape, eps):
    """The sampler named by ``config.sampling.method``."""
    method = config.sampling.method.lower()
    if method == "pc":
        return get_pc_sampler(
            sde=sde, shape=shape,
            predictor=config.sampling.predictor,
            corrector=config.sampling.corrector,
            denoiser=config.sampling.denoiser,
            snr=config.sampling.snr,
            n_steps=config.sampling.n_steps_each,
            eps=eps)
    if method == "ode":
        raise NotImplementedError("the probability-flow ODE sampler is not ported yet")
    raise ValueError(f"Sampler name {config.sampling.method} unknown.")
