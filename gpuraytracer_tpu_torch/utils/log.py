"""Structured logging to stderr (port of gpuraytracer_tpu/utils/log.py)."""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "gpuraytracer_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
