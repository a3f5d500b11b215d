"""The per-layer metrics read from the program's own record of each dock
(``DockingResult.timings``): each one's arithmetic on hand-made records
of stand-in results, nothing read from results that carry no record, and
the readers on a record the port itself keeps on the CPU."""

import dataclasses
from typing import Dict, List, Optional

import pytest

from benchmark.harness import main, spec

MS = 1_000_000  # ns
NEW = ("sampler.step_ms", "sampler.step_host_ms", "dock.prep_host_ms", "confidence.ms_per_dock",
       "pipeline.pair_pad_pct")


@dataclasses.dataclass
class Span:
    name: str
    parent: int
    start_ns: int
    end_ns: int
    device: Optional[float] = None  # ms on the stream


@dataclasses.dataclass
class Record:
    """A stand-in for the program's record: spans, counts, device ms."""

    spans: List[Span]
    counts: Dict[str, int]

    def device_ms(self, i):
        return self.spans[i].device


@dataclasses.dataclass
class Result:
    timings: Optional[Record] = None


def dock(steps, prep, embed, conf, rank, pair_real, pair_slots):
    """A one-batch dock: ``steps`` as (host ms, device ms) pairs (their
    device ms summed into the diffusion span's), the others as (host ms,
    device ms) or None."""
    spans, t = [Span("dock", -1, 0, 0)], 0

    def add(name, host, device):
        nonlocal t
        spans.append(Span(name, 0, t, t + int(host * MS), device))
        t += int(host * MS)

    add("prep", *prep)
    spans.append(Span("pre_crop", 1, 0, 1 * MS))  # a child of prep: not counted again
    if embed is not None:
        add("embed_receptor", *embed)
    # the steps tile the diffusion span, which alone is timed on the stream
    diffusion = len(spans)
    spans.append(Span("diffusion", 0, t, t, sum(d for _, d in steps)))
    for h, _ in steps:
        spans.append(Span("step", diffusion, t, t + int(h * MS)))
        spans.append(Span("score", len(spans) - 1, t, t))
        t += int(h * MS)
    spans[diffusion].end_ns = t
    add("confidence", *conf)
    add("rank", *rank)
    spans[0].end_ns = t
    return Record(spans, {"pair_real": pair_real, "pair_slots": pair_slots, "score_forwards": len(steps)})


def ctx(results):
    records = [main.DockRecord(i, i % 2, 0, 1.0, r) for i, r in enumerate(results)]
    return main.Context(cycle=[(10, 100, 2, 800)] * 2, buckets=[(16, 128, 8, 1024)] * 2, poses=10,
                        records=records, window_s=2.0, forward_ms={}, trace=None, work=[])


def window():
    a = dock([(10.0, 12.0), (20.0, 22.0)], (5.0, 6.0), (3.0, 4.0), (30.0, 31.0), (2.0, 2.5), 600, 1000)
    b = dock([(30.0, 32.0)], (7.0, 8.0), None, (40.0, 41.5), (1.0, 1.5), 300, 500)
    return [Result(a), Result(b), Result(None)]


def read(name, results):
    return spec.metric_reader(name)(ctx(results))


def test_step_times_on_the_stream_and_on_the_host():
    # the diffusion spans' stream time over their steps; a score span is
    # not a step
    assert read("sampler.step_ms", window()) == pytest.approx((12 + 22 + 32) / 3)
    assert read("sampler.step_host_ms", window()) == pytest.approx((10 + 20 + 30) / 3)


def test_prep_and_ranking_per_dock():
    # prep and embed_receptor summed per dock, over the docks with a record
    assert read("dock.prep_host_ms", window()) == pytest.approx(((5 + 3) + 7) / 2)
    # confidence and rank on the stream, summed per dock
    assert read("confidence.ms_per_dock", window()) == pytest.approx(((31 + 2.5) + (41.5 + 1.5)) / 2)


def test_pair_padding_over_the_window():
    assert read("pipeline.pair_pad_pct", window()) == pytest.approx(100 * (1 - 900 / 1500))


def test_a_dock_in_chunks_sums_its_batches():
    rec = dock([(10.0, 11.0)], (4.0, 4.0), None, (5.0, 6.0), (1.0, 1.0), 100, 400)
    t = rec.spans[0].end_ns
    rec.spans += [Span("prep", 0, t, t + 2 * MS, 2.0), Span("diffusion", 0, t, t, 20.0)]
    d = len(rec.spans) - 1
    rec.spans += [Span("step", d, t, t + 9 * MS), Span("step", d, t, t + 9 * MS),
                  Span("rank", 0, t + 2 * MS, t + 3 * MS, 0.5)]
    assert read("dock.prep_host_ms", [Result(rec)]) == pytest.approx(6.0)
    assert read("confidence.ms_per_dock", [Result(rec)]) == pytest.approx(7.5)
    assert read("sampler.step_ms", [Result(rec)]) == pytest.approx((11 + 20) / 3)
    assert read("sampler.step_host_ms", [Result(rec)]) == pytest.approx((10 + 9 + 9) / 3)


@pytest.mark.parametrize("name", NEW)
def test_nothing_is_read_without_a_record(name):
    assert read(name, [Result(None), object()]) is None


def test_no_device_reading_off_the_card():
    """Spans with no device events (a CPU run): the device metrics read
    nothing, the host ones read."""
    results = window()
    for r in results:
        if r.timings is not None:
            for s in r.timings.spans:
                s.device = None
    assert read("sampler.step_ms", results) is None and read("confidence.ms_per_dock", results) is None
    assert read("sampler.step_host_ms", results) == pytest.approx(20.0)


def test_the_readers_on_the_ports_own_record():
    from diffdock_tpu_torch.utils import profiling

    with profiling.Recorder().record("cpu") as rec:
        with profiling.span("dock"):
            with profiling.span("prep"):
                profiling.count("pair_real", 30)
                profiling.count("pair_slots", 40)
            with profiling.span("diffusion", device=True):
                for _ in range(2):
                    with profiling.span("step"):
                        pass
    results = [Result(rec)]
    assert read("pipeline.pair_pad_pct", results) == pytest.approx(25.0)
    steps = [i for i, s in enumerate(rec.spans) if s.name == "step"]
    assert read("sampler.step_host_ms", results) == pytest.approx(sum(rec.host_ms(i) for i in steps) / 2)
    assert read("dock.prep_host_ms", results) == pytest.approx(rec.host_ms(rec.find("prep")[0]))
    assert read("sampler.step_ms", results) is None
