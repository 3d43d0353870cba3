"""The legacy 1-D DDPM pipeline: beta schedules, ``GaussianDiffusion1D``
and ``Trainer1D``."""
from .schedules import cosine_beta_schedule, linear_beta_schedule  # noqa: F401
from .gaussian_diffusion import GaussianDiffusion1D  # noqa: F401
