"""Logging utilities (port of ``diffdock_tpu/utils/logging.py``; reference
``utils/logging_utils.py``).

A named logger with env-var level control (``DIFFDOCK_TPU_LOGLEVEL``), a
per-PID child logger for subprocess safety, an optional file handler, and
structured run metrics as JSON lines.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Optional

_FMT = "[%(asctime)s] [%(name)s %(levelname)s] %(message)s"


def get_logger(name: str = "diffdock_tpu") -> logging.Logger:
    """The process's ``{name}.{pid}`` logger, writing to stderr at the level
    ``DIFFDOCK_TPU_LOGLEVEL`` gives (INFO by default)."""
    logger = logging.getLogger(f"{name}.{os.getpid()}")
    if not logger.handlers:
        logger.setLevel(os.environ.get("DIFFDOCK_TPU_LOGLEVEL", "INFO").upper())
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.propagate = False
    return logger


def add_file_handler(path: str, name: str = "diffdock_tpu") -> None:
    """Also write :func:`get_logger`'s records to ``path``."""
    h = logging.FileHandler(path)
    h.setFormatter(logging.Formatter(_FMT))
    get_logger(name).addHandler(h)


class MetricsWriter:
    """Run metrics as JSON lines (the reference logs to wandb when
    available). One record per event: ``{"step": int, "phase": str,
    **scalars}``. Appends, flushes per write, and is a no-op when ``path``
    is None."""

    def __init__(self, path: Optional[str] = None):
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    def log(self, step: int, phase: str, **scalars) -> None:
        if self._fh is None:
            return
        rec = {"step": int(step), "phase": phase}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
