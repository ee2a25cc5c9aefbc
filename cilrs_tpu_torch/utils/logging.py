"""Structured logging (port of ``cilrs_tpu/utils/logging.py``; the reference
uses bare print everywhere)."""

from __future__ import annotations

import logging
import os
import sys

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "cilrs_tpu_torch") -> logging.Logger:
    """A stderr logger whose level ``CILRS_TPU_LOGLEVEL`` sets (default INFO),
    read when the logger is first configured."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("CILRS_TPU_LOGLEVEL", "INFO").upper())
        logger.propagate = False
    return logger
