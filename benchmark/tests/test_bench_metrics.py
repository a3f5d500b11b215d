"""Each per-layer metric's arithmetic on a small recorded trace, and the
end-to-end metrics' arithmetic."""


import contextlib
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from benchmark.harness import main, spec, trace
from benchmark.work.census import Work
from benchmark.work.peaks import TF32_PEAK_FLOPS
from benchmark.work.tp3 import bound_ms, tp3_work


class Event:
    """A stand-in for the profiler's raw event."""

    def __init__(self, name, start, dur, device=False, annotation=False, thread=1):
        self._v = (name, start, dur, device, annotation, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


MS = 1_000_000  # ns


def recorded_events():
    """Two docks' worth of a tiny trace: host spans and operators, the
    runtime's launch calls, kernels (two of them the contraction's) and a
    mirrored range on the device timeline."""
    return [
        Event("bench.score_forward", 0, 10 * MS, annotation=True),
        Event("aten::cat", 1 * MS, 2 * MS),
        Event("cudaLaunchKernel", 1 * MS, 1000),
        Event("cudaLaunchKernel", 4 * MS, 1000),
        Event("cudaLaunchKernel", 6 * MS, 1000),
        Event("cudaMemcpyAsync", 8 * MS, 1000),
        Event("aten::mul", 5 * MS, 4 * MS),
        Event("fused_tp3_kernel", 2 * MS, 1 * MS, device=True),
        Event("fused_tp3_reduce", 3 * MS, 1 * MS, device=True),
        Event("elementwise_kernel", 7 * MS, 2 * MS, device=True),
        Event("Memcpy DtoH", 12 * MS, 1 * MS, device=True),
        Event("bench.score_forward", 0, 10 * MS, device=True, annotation=True),
    ]


def test_reduce_events():
    t = trace.reduce_events(recorded_events(), wall_s=0.02, docks=2)
    assert t.launches == 3
    assert t.busy_s == pytest.approx(5e-3)
    assert set(t.kernels) == {"fused_tp3_kernel", "fused_tp3_reduce", "elementwise_kernel", "Memcpy DtoH"}
    assert t.kernels["fused_tp3_kernel"] == (pytest.approx(1e-3), 1)
    # the gaps between busy runs (4-7 ms and 9-12 ms), by what the host was doing
    assert t.idle_by_host == {"bench.score_forward / aten::mul": pytest.approx(3e-3),
                              "-": pytest.approx(3e-3)}
    assert t.device_ops(1) == [["elementwise_kernel", pytest.approx(2e-3)]]


def test_host_labels_take_the_innermost_open_operation():
    ops = [(0, 100, "bench.dock"), (10, 50, "aten::cat"), (20, 30, "aten::copy_"), (60, 70, "aten::mul")]
    labels = trace.host_labels(ops, np.array([25, 40, 65, 80, 150]))
    assert labels == ["bench.dock / aten::copy_", "bench.dock / aten::cat", "bench.dock / aten::mul",
                      "bench.dock / bench.dock", "-"]


def test_busy_runs():
    runs = trace.busy_runs(np.array([[5, 7], [0, 2], [1, 3], [6, 9]]))
    assert runs.tolist() == [[0, 3], [5, 9]]


CALL = (20, 400, 120, 30, 640, 32, 144)  # F_tot, weights, columns, out, rows, K, H


def ctx():
    """Two complexes, two docks each in the window, one profiled cycle."""
    records = [main.DockRecord(i, i % 2, 0, s, None) for i, s in enumerate([2.0, 1.0, 2.2, 0.9])]
    work = [{"score_bucket": Work({CALL: 10}, 1e9), "confidence_bucket": Work({CALL: 2}, 5e8),
             "score_real": Work({CALL: 10}, 8e8), "confidence_real": Work({CALL: 2}, 4e8)}] * 2
    t = trace.reduce_events(recorded_events(), wall_s=0.02, docks=2)
    return main.Context(cycle=[(28, 1068, 7, 8544), (12, 125, 3, 1000)],
                        buckets=[(32, 1536, 8, 8704), (16, 128, 8, 1024)], poses=10, records=records,
                        window_s=6.1, forward_ms={"score": [(0, 3.0), (0, 5.0), (1, 4.0), (None, 100.0)],
                                                  "confidence": [(0, 2.0), (0, 1.0), (1, 4.0)]},
                        trace=t, work=work)


def read(name):
    return spec.metric_reader(name)(ctx())


def test_pad_pct():
    real = 2 * (28 * 1068 + 12 * 125)
    slots = 2 * (32 * 1536 + 16 * 128)
    assert read("pipeline.pad_pct") == pytest.approx(100 * (1 - real / slots))


def test_forward_times():
    assert read("score.step_wall_ms") == pytest.approx(4.0)  # the untagged forward is not a dock's
    assert read("confidence.wall_ms_per_dock") == pytest.approx(3.5)


def test_tpconv_shares():
    kernel_s = 2e-3
    bound = 2 * 12 * bound_ms(*tp3_work(*CALL))[0]  # one profiled cycle of two complexes
    assert read("fused_tp3_roofline") == pytest.approx(100 * bound / 1e3 / kernel_s)
    assert read("tpconv.device_pct") == pytest.approx(100 * kernel_s / 5e-3)


def test_dispatch_and_device():
    assert read("dispatch.launches_per_dock") == pytest.approx(1.5)
    # busy seconds of the profiled cycle over the same docks' untraced time
    # (each complex's mean dock time in the window: 2.1 + 0.95 s)
    assert read("device.idle_pct") == pytest.approx(100 * (1 - 5e-3 / 3.05))
    flops = 4 * (8e8 + 4e8 + 12 * tp3_work(*CALL)[0])
    assert read("dock.mfu") == pytest.approx(100 * flops / (6.1 * TF32_PEAK_FLOPS))


def test_readers_return_nothing_without_a_reading():
    c = ctx()
    c.trace = trace.TraceData(window_s=1.0, busy_s=0.0, docks=0, kernels={}, launches=0, idle_by_host={})
    c.forward_ms = {}
    for name in ("fused_tp3_roofline", "tpconv.device_pct", "dispatch.launches_per_dock",
                 "device.idle_pct", "score.step_wall_ms", "confidence.wall_ms_per_dock"):
        assert spec.metric_reader(name)(c) is None, name


def test_poses_per_s_weighs_the_mix_and_p95_takes_every_dock():
    recs = [main.DockRecord(i, c, 0, s, None) for i, (c, s) in enumerate(
        [(0, 3.0), (1, 1.0), (2, 1.0), (0, 3.2), (1, 1.2)])]
    # the cycle's poses over the sum of each complex's mean dock time,
    # however many docks of each the window holds
    assert main.poses_per_s(recs, 3, 10) == pytest.approx(30 / (3.1 + 1.1 + 1.0))
    assert main.dock_p95_s(recs) == pytest.approx(np.percentile([3.0, 1.0, 1.0, 3.2, 1.2], 95))


def test_window_judges_the_lead_complexs_last_dock():
    """Besides the docks picked before the window, the check judges the
    lead complex's last dock: a repeat, after the others have docked."""

    @contextlib.contextmanager
    def recording():
        yield [(torch.zeros(2, 4, 3), torch.ones(2, 3), torch.ones(2, 3), torch.ones(2, 2))]

    def dock(c, s):
        time.sleep(0.004)
        return c

    recs, window_s, judged = main.run_window(dock, [(3, 9, 1)] * 3, 0.06, 5, judged=[0, 2],
                                             recording=recording)
    leads = [r.index for r in recs if r.complex == 0]
    assert len(leads) >= 3 and window_s >= 0.06
    assert judged == [0, 2, leads[-1]]
    # only the judged docks keep their steps
    assert [r.index for r in recs if r.states is not None] == judged
    assert recs[leads[-1]].states.shape == (1, 2, 3, 3) and recs[leads[-1]].scores["tor"].shape == (1, 2, 1)
