"""The benchmark's own instrumentation of a run (``--trace 1``).

Two sources, both attached from outside the program:

* :class:`Hooks`: forward pre- and post-hooks on the two model modules
  that record a CUDA event pair around every forward (the device-timeline
  time of each forward) and open a profiler range of the same name, so a
  profiled stretch knows which forward the host was in;
* :func:`profile`: ``torch.profiler`` (host and device activity) over a
  stretch of docks, reduced once it ends by :func:`reduce_events` to the
  few numbers the per-layer metrics read: device time by kernel name, the
  device's busy seconds, the runtime's launch calls, and idle seconds by
  what the host was doing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType

# runtime and driver calls that put work on the device; a graph launch counts once
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
SPAN_PREFIX = "bench."


class Hooks:
    """CUDA events around every forward of the given modules (name ->
    module), each tagged with the dock it belongs to (:attr:`dock`)."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.dock: Optional[int] = None
        self.spans: Dict[str, List[Tuple[Optional[int], torch.cuda.Event, torch.cuda.Event]]] = {
            name: [] for name in modules}
        self._open: List[tuple] = []
        self._handles = []
        for name, module in modules.items():
            self._handles.append(module.register_forward_pre_hook(self._pre(name)))
            self._handles.append(module.register_forward_hook(self._post(name)))

    def _pre(self, name: str) -> Callable:
        def hook(_module, _args):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rng = torch.autograd.profiler.record_function(f"{SPAN_PREFIX}{name}_forward")
            rng.__enter__()
            self._open.append((start, rng))
        return hook

    def _post(self, name: str) -> Callable:
        def hook(_module, _args, _out):
            start, rng = self._open.pop()
            rng.__exit__(None, None, None)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.spans[name].append((self.dock, start, end))
        return hook

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def milliseconds(self) -> Dict[str, List[Tuple[Optional[int], float]]]:
        """name -> [(dock, device ms of one forward)], once the device is done."""
        torch.cuda.synchronize()
        return {name: [(dock, s.elapsed_time(e)) for dock, s, e in spans]
                for name, spans in self.spans.items()}


@dataclasses.dataclass
class TraceData:
    """What a profiled stretch of docks leaves for the per-layer metrics."""

    window_s: float  # host wall of the profiled stretch
    busy_s: float  # union of the device's operations
    docks: int
    kernels: Dict[str, Tuple[float, int]]  # device op name -> (seconds, count)
    launches: int
    idle_by_host: Dict[str, float]  # what the host was doing -> idle device seconds

    def device_ops(self, n: int = 10) -> List[list]:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:200], s] for name, (s, _c) in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        top = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]
        return [[label[:200], s] for label, s in top]


def profile(run: Callable[[], int]) -> TraceData:
    """``run()`` (which docks and returns how many) under the profiler,
    device synchronised at both ends; the reduced trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        docks = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return reduce_events(prof.profiler.kineto_results.events(), wall, docks)


def _is_runtime_call(name: str) -> bool:
    """A CUDA runtime or driver API call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ...), as opposed to an operator or a range."""
    return (name.startswith("cuda") and name[4:5].isupper()) or (name.startswith("cu") and name[2:3].isupper())


def busy_runs(intervals: np.ndarray) -> np.ndarray:
    """The union of (start, end) intervals as sorted disjoint runs."""
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new run starts where an interval begins after every earlier one ended
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    first = np.flatnonzero(new)
    run_ends = np.append(ends[first[1:] - 1], ends[-1])
    return np.stack([iv[first, 0], run_ends], axis=1)


def host_labels(ops: List[Tuple[int, int, str]], times: np.ndarray) -> List[str]:
    """For each time, what the host was doing: the innermost benchmark span
    and the innermost host operation open then ("-" where none is). ``ops``
    are (start, end, name) of one thread, properly nested."""
    order = np.argsort(times, kind="stable")
    labels = ["-"] * len(times)
    ops = sorted(ops, key=lambda o: (o[0], -o[1]))
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for q in order:
        t = times[q]
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            span = next((o[2] for o in reversed(stack) if o[2].startswith(SPAN_PREFIX)), "harness")
            labels[q] = f"{span} / {stack[-1][2]}"
    return labels


def reduce_events(events: Iterable, wall_s: float, docks: int) -> TraceData:
    """The profiler's raw events reduced to a :class:`TraceData`. Device
    events are kernels, copies and sets; a host range mirrored on the
    device timeline (a user annotation, or a name the host side also has)
    is not device work."""
    dev, host = [], {}
    launches = 0
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.duration_ns(), name))
        elif _is_runtime_call(name):
            launches += name in LAUNCH_CALLS
        else:
            s = e.start_ns()
            host.setdefault(e.start_thread_id(), []).append((s, s + e.duration_ns(), name))
    host_names = {o[2] for ops in host.values() for o in ops}
    kernels: Dict[str, Tuple[float, int]] = {}
    spans = []
    for s, d, name in dev:
        if name in host_names or name.startswith(SPAN_PREFIX):
            continue
        spans.append((s, s + d))
        tot, cnt = kernels.get(name, (0.0, 0))
        kernels[name] = (tot + d / 1e9, cnt + 1)
    busy, idle = 0.0, {}
    if spans:
        runs = busy_runs(np.asarray(spans, np.int64))
        busy = float((runs[:, 1] - runs[:, 0]).sum()) / 1e9
        if len(runs) > 1 and host:
            gap_start, gap_end = runs[:-1, 1], runs[1:, 0]
            main = max(host.values(), key=len)  # the thread that issued the work
            for label, g in zip(host_labels(main, (gap_start + gap_end) // 2), (gap_end - gap_start) / 1e9):
                idle[label] = idle.get(label, 0.0) + float(g)
    return TraceData(window_s=wall_s, busy_s=busy, docks=docks, kernels=kernels,
                     launches=launches, idle_by_host=idle)
