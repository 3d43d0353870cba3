from .datasets import (GTO_MEAN, GTO_STD, GTOHaloImageDataset, get_dataset,  # noqa: F401
                       load_arrays, make_synthetic_gto_pkl)
