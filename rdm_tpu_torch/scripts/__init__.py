"""Command-line scripts of the port that are not entry points of the
pipeline (microbenchmarks)."""
