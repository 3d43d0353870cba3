"""Logging in the reference's format.

The ``%(asctime)s - %(message)s`` format and the ``step: N, training_loss:
X`` message layout are what the telemetry tools parse
(``telemetry/plot_losses.py``).
"""
from __future__ import annotations

import logging
import os


def makedirs(dirname: str) -> None:
    os.makedirs(dirname, exist_ok=True)


def get_logger(logpath: str, displaying: bool = True, saving: bool = True,
               debug: bool = False) -> logging.Logger:
    """The root logger, writing to ``logpath`` (appending) and to the
    console; its earlier handlers are removed."""
    logger = logging.getLogger()
    level = logging.DEBUG if debug else logging.INFO
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.setLevel(level)
    formatter = logging.Formatter("%(asctime)s - %(message)s")
    if saving:
        fh = logging.FileHandler(logpath, mode="a")
        fh.setLevel(level)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    if displaying:
        ch = logging.StreamHandler()
        ch.setLevel(level)
        ch.setFormatter(formatter)
        logger.addHandler(ch)
    return logger
