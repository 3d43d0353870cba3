from .datasets import (GTO_MEAN, GTO_STD, GTOHaloImageDataset, get_dataset,  # noqa: F401
                       load_arrays, load_cifar10, load_image_folder, load_image_folder_class,
                       make_synthetic_gto_pkl)
