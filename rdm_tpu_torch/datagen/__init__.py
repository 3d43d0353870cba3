"""Training-data generation: initial guesses and the [N, 67] training pickle."""
from .init_generator import CR3BPInitGenerator  # noqa: F401
from .prepare_training_data import (  # noqa: F401
    get_halo_period,
    normalize_result,
    prepare_training_data,
)
