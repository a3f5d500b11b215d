"""Structured run metrics (port of ``MetricsWriter`` in ``diffdock_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import os
from typing import Optional


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
