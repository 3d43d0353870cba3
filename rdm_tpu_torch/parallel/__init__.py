"""Data parallelism: one process per card (``mesh``) and a local launcher
of rank groups (``launch``)."""
