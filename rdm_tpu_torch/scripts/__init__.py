"""Command-line scripts of the port that are not entry points of the
pipeline: the channels-first microbenchmarks, the data-generation fleet and
the study scripts (warm-start quality against the sampler and the oracle's
budget, the oracle's robustness, regrading), each with ``main(argv)``."""
