from .datasets import (GTO_MEAN, GTO_STD, GTOHaloImageDataset,  # noqa: F401
                       GTOHaloTrajectoryDataset, get_dataset,
                       load_arrays, load_cifar10, load_image_folder, load_image_folder_class,
                       make_synthetic_gto_pkl)
