from .gto_halo import GTOHaloBenchmarker, GTOHaloBenchmarkConfig  # noqa: F401
from .ml_statistics import MLStatisticsBenchmarker, MLStatisticsConfig  # noqa: F401
