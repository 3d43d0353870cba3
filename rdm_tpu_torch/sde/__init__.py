from .base import SDE  # noqa: F401
from .rvesde import RVESDE  # noqa: F401


def get_sde(config):
    """Build the SDE named in ``config.sde.name``."""
    name = config.sde.name.lower()
    if name in ("vesde", "rvesde"):
        return RVESDE(sigma_min=config.sde.sigma_min,
                      sigma_max=config.sde.sigma_max,
                      N=config.sde.num_scales)
    raise ValueError(f"Unknown SDE: {config.sde.name}")
