"""Profiling helpers (port of ``diffdock_tpu/utils/profiling.py``): a
``torch.profiler`` trace and phase timers that wait for the device."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch


def _devices(tree) -> set:
    """The CUDA devices of the tensors in a nested list/tuple/dict."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_devices(t) for t in tree)) if tree else set()
    return set()


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (host and, where a card is
    present, device activity) and write a Chrome trace to
    ``log_dir/trace.json`` (open in chrome://tracing or Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Accumulating wall-clock phase timer; waits for the device work of the
    tensors in ``block_on`` so the numbers mean what they say."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in _devices(block_on):
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": v, "count": self.counts[k],
                "mean_s": v / self.counts[k]}
            for k, v in self.totals.items()
        }
