"""One run of one cell: set-up, the measured window, the check, the result.

Set-up (``setup_s``, from the start of ``benchmark/run.py``): the port's
import and kernels (built once per checkout into its ``_build``), the
weights and the complexes from the seed, and one short dock of each complex
of the cycle at the cell's pose count, which warms every shape the window
uses. The window: one closed-loop client docks the cycle's complexes in
order, each with its own noise, until ``--seconds`` have passed and at
least one whole cycle is done. Then the program's state is freed and the
check (:mod:`benchmark.harness.check`) replays a sample of the window's
docks through the plain reference.

With ``--trace 1`` the window also records CUDA events around every
forward (:class:`~benchmark.harness.trace.Hooks`); after it, one more
cycle runs under the profiler, and once the check is done the work census
(:mod:`benchmark.work.census`) counts each complex's work. The result line
then carries the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import check, inputs, spec
from benchmark.harness.weights import init_specs, make_state_dict

FORBIDDEN = ("jax", "jaxlib", "flax", "diffdock_tpu")


class NoDevice(RuntimeError):
    pass


@dataclasses.dataclass
class DockRecord:
    index: int
    complex: int
    seed: int
    seconds: float
    result: object  # poses, confidence, order (numpy)
    states: Optional[np.ndarray] = None  # (S, P, n_lig, 3) for the docks the check judges
    scores: Optional[dict] = None  # "tr", "rot" (S, P, 3), "tor" (S, P, n_bonds) for the same


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader gets (``metrics/<name>.py``)."""

    cycle: List[tuple]  # (n_lig, n_rec, n_bonds, n_atoms) of each complex
    buckets: List[tuple]  # (nl, nr, nb, na) the program docks each complex in
    poses: int
    records: List[DockRecord]  # the window's docks
    window_s: float
    forward_ms: Dict[str, list]  # module -> [(dock index, device ms)] over the window
    trace: object  # TraceData of the profiled cycle
    work: List[dict]  # per complex: Work at the buckets and at the real sizes


def log(t_start: float, msg: str, marks: Optional[Dict[str, float]] = None) -> None:
    """A progress line on standard error (before the check's last lines);
    ``marks`` gains the seconds since ``t_start`` under ``msg``."""
    t = time.perf_counter() - t_start
    if marks is not None:
        marks[msg] = t
    print(f"[{t:8.2f} s] {msg}", file=sys.stderr, flush=True)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_device(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false: this benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} card(s), {torch.cuda.device_count()} visible")


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi not available"


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def poses_per_s(records: List[DockRecord], cycle_len: int, poses: int) -> float:
    """The cycle's poses over the sum, over its complexes, of each one's
    mean dock time over every dock of it in the window."""
    means = [np.mean([r.seconds for r in records if r.complex == c]) for c in range(cycle_len)]
    return cycle_len * poses / float(np.sum(means))


def dock_p95_s(records: List[DockRecord]) -> float:
    """The 95th percentile (linear) of every dock's time in the window."""
    return float(np.percentile([r.seconds for r in records], 95))


def step_arrays(steps, n_lig: int, n_bonds: int):
    """(states (S, P, n_lig, 3), scores) as numpy from the recorded
    (poses, tr, rot, tor) of every step, real atoms and bonds only."""
    if not steps:
        return None, None
    states = np.stack([p[:, :n_lig].cpu().numpy() for p, *_ in steps])
    scores = {k: np.stack([x[j].cpu().numpy() for x in steps]) for j, k in ((1, "tr"), (2, "rot"))}
    scores["tor"] = np.stack([x[3][:, :n_bonds].cpu().numpy() for x in steps])
    return states, scores


def run_window(dock, sizes, seconds: float, seed: int, judged=(), recording=None,
               hooks=None) -> tuple:
    """Closed loop over the cycle (``sizes``: (n_lig, n_rec, n_bonds, ...)
    of each complex) until ``seconds`` have passed and a whole cycle is
    done: (records, window seconds, the judged docks). The docks in
    ``judged``, and every later dock of the lead complex, run inside
    ``recording()``, which records each step's state and scores; of the
    lead's later docks the last keeps its record and joins the judged
    ones (a repeated dock of a complex, after every other complex has
    docked in between)."""
    n_complexes = len(sizes)
    n_lig = [z[0] for z in sizes]
    n_bonds = [z[2] for z in sizes]
    records: List[DockRecord] = []
    last_lead = None
    t_start = time.perf_counter()
    i = 0
    while i < n_complexes or time.perf_counter() - t_start < seconds:
        c = i % n_complexes
        s = inputs.sub_seed(seed, 2, i)
        if hooks is not None:
            hooks.dock = i
        if i in judged or (c == 0 and i > 0):
            with recording() as steps:
                t0 = time.perf_counter()
                res = dock(c, s)
                dt = time.perf_counter() - t0
            rec = DockRecord(i, c, s, dt, res, *step_arrays(steps, n_lig[c], n_bonds[c]))
            if i not in judged:
                if last_lead is not None:
                    records[last_lead].states = records[last_lead].scores = None
                last_lead = i
        else:
            t0 = time.perf_counter()
            res = dock(c, s)
            rec = DockRecord(i, c, s, time.perf_counter() - t0, res)
        records.append(rec)
        i += 1
    window_s = time.perf_counter() - t_start
    return records, window_s, sorted(set(judged) | ({last_lead} if last_lead is not None else set()))


def run(args: argparse.Namespace, t_start: float, device: str = "cuda",
        root: Path = spec.BENCH_DIR, benchmark: Optional[dict] = None, port_factory=None) -> dict:
    """One run; returns the result line's object. ``port_factory`` builds
    the system under test (the tests' stand-ins); ``device`` is the card
    unless a test drives the rest of a run on the CPU."""
    benchmark = benchmark if benchmark is not None else spec.load_json(spec.find_benchmark(root))
    cell = spec.load_cell(args.workload, benchmark, root)
    if device == "cuda":
        require_device(cell.chips)
    dev = torch.device(device)

    from benchmark.harness import port as port_mod
    from benchmark.reference import dock as ref_dock
    from benchmark.reference.data.complexes import atom_bucket as ref_atom_bucket
    from benchmark.reference.diffusion.schedules import SigmaConfig as RefSigma
    from benchmark.reference.inference.sampler import SamplerConfig as RefSampler
    from benchmark.reference.models.config import ScoreModelConfig as RefConfig

    marks: Dict[str, float] = {}  # set-up's phases, reported beside setup_s
    log(t_start, "imports done", marks)
    cfg, traffic, P = cell.config, cell.traffic, int(cell.traffic["poses"])
    ref_score = ref_dock.build(port_mod.model_config(cfg["score_model"], RefConfig, RefSigma))
    ref_conf = ref_dock.build(port_mod.model_config(cfg["confidence_model"], RefConfig, RefSigma))
    score_sd = make_state_dict(init_specs(ref_score), inputs.sub_seed(args.seed, 0, 0), dev)
    conf_sd = make_state_dict(init_specs(ref_conf), inputs.sub_seed(args.seed, 0, 1), dev)
    log(t_start, "weights made", marks)
    factory = port_factory or port_mod.PortDocker
    system = factory(cfg, score_sd, conf_sd, dev)
    log(t_start, "pipeline built", marks)
    fields = inputs.make_cycle(args.seed, traffic, cfg)
    port_inputs = [system.complex(f, a) for f, a in fields]
    n = len(port_inputs)
    log(t_start, "complexes made", marks)

    def dock(c, s, n_steps=None):
        data, aa = port_inputs[c]
        return system.dock(data, aa, P, s, n_steps=n_steps)

    for c in range(n):
        dock(c, inputs.sub_seed(args.seed, 5, c), n_steps=int(traffic["warmup_steps"]))
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # what set-up made stays alive for the whole run: the collector's full
    # passes in the window need not walk it again (they still run, and
    # the program's own garbage is collected as in any long-lived process)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(t_start, "warm-up docks done", marks)

    hooks = None
    if args.trace:
        from benchmark.harness.trace import Hooks

        hooks = Hooks(system.modules())
    judged = check.checked_docks(args.seed, n, int(cell.limits["docks_checked"]))
    sizes = [(d.n_lig, d.n_rec, d.n_bonds, a.n_atoms) for d, a in port_inputs]
    records, window_s, judged = run_window(dock, sizes, args.seconds, args.seed, judged,
                                           system.recording_steps, hooks)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    log(t_start, f"window: {len(records)} docks in {window_s:.3f} s; per complex mean s "
        + " ".join(f"{np.mean([r.seconds for r in records if r.complex == c]):.4f}" for c in range(n)))
    trace = forward_ms = None
    if args.trace:
        from benchmark.harness.trace import profile

        forward_ms = hooks.milliseconds()
        hooks.dock = None

        def traced_cycle() -> int:
            for c in range(n):
                dock(c, inputs.sub_seed(args.seed, 4, c))
            return n

        trace = profile(traced_cycle)
        hooks.remove()
        log(t_start, f"traced cycle: {trace.window_s:.3f} s wall, busy {trace.busy_s:.3f} s, "
            f"{trace.launches} launches, {len(trace.kernels)} kernel names")
    buckets = [(*system.bucket(d), ref_atom_bucket(a.n_atoms)) for d, a in port_inputs]
    failed = sum(not check.answer_ok(r.result, P, sizes[r.complex][0]) for r in records)

    # the program's state goes before the reference runs
    gc.unfreeze()
    del system, port_inputs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_score.load_state_dict(score_sd, strict=True)
    ref_conf.load_state_dict(conf_sd, strict=True)
    reference = ref_dock.ReferenceDocker(ref_score, ref_conf,
                                         port_mod.sampler_config(cfg["sampler"], RefSampler), dev)
    ref_inputs = [ref_dock.as_reference_data(f, a) for f, a in fields]
    verdict = check.verdict(reference, ref_inputs, records, judged, P, cell.limits["limits"], dev)
    log(t_start, f"check of docks {judged} done: {verdict.per_dock}")

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": verdict.correct and failed == 0, "attempted": len(records), "failed": failed}
    if not args.trace:
        values = {"poses_per_s": poses_per_s(records, n, P), "dock_p95_s": dock_p95_s(records),
                  "peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        from benchmark.work.census import dock_work

        steps = reference.sampler_cfg.num_steps
        work = []
        for (data, aa), sz, bk in zip(ref_inputs, sizes, buckets):
            s_b, c_b = dock_work(reference, data, aa, P, steps, bk)
            s_r, c_r = dock_work(reference, data, aa, P, steps, sz)
            work.append({"score_bucket": s_b, "confidence_bucket": c_b, "score_real": s_r,
                         "confidence_real": c_r})
        log(t_start, "work census done")
        ctx = Context(cycle=sizes, buckets=buckets, poses=P, records=records, window_s=window_s,
                      forward_ms=forward_ms, trace=trace, work=work)
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
        device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["device"] = device_info
    result["card"] = card_line() if dev.type == "cuda" else "cpu"
    # where set-up's seconds went (the port builds its kernels at first use,
    # once per checkout): seconds since the start at each phase's end
    result["setup_marks_s"] = marks
    result["window"] = {"seconds": window_s, "docks": len(records), "checked_docks": judged,
                        "dock_seconds": [r.seconds for r in records], "per_dock_checks": verdict.per_dock}
    result["checks"] = verdict.as_json()
    result["_lines"] = verdict.lines()
    return result


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        result = run(args, t_start)
    except NoDevice as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    lines = result.pop("_lines")
    found = forbidden_modules()
    if found:
        print(f"no result: modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0
