"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--json PATH]

In one process, at the cell's own sizes: for each seed of ``--seeds`` the
docks a run of that seed would judge (:func:`check.checked_docks`, then
the lead complex again, as the lead's second dock of a window), docked
by the program with the seed's weights, inputs and noise and judged by the
reference, as a run judges them; for each seed of ``--control-seeds`` the
same docks by the control (the reference in TF32 in the program's place).
It prints each dock's numbers, then per number the largest program
reading (the lower reading of a limit) and the smallest of the control
seeds' readings, each seed's the worst of its docks as a run compares them
(the upper reading). The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import check, inputs, port, spec  # noqa: E402
from benchmark.harness.main import require_device, step_arrays  # noqa: E402
from benchmark.harness.weights import init_specs, make_state_dict  # noqa: E402
from benchmark.reference import dock as rd  # noqa: E402
from benchmark.reference.diffusion.schedules import SigmaConfig as RefSigma  # noqa: E402
from benchmark.reference.inference.sampler import SamplerConfig as RefSampler  # noqa: E402
from benchmark.reference.models.config import ScoreModelConfig as RefConfig  # noqa: E402


def readings(workload: str, seeds, control_seeds, device: str = "cuda", root: Path = spec.BENCH_DIR,
             benchmark=None) -> dict:
    benchmark = benchmark if benchmark is not None else spec.load_json(spec.find_benchmark(root))
    cell = spec.load_cell(workload, benchmark, root)
    if device == "cuda":
        require_device(cell.chips)
    cfg, traffic, P = cell.config, cell.traffic, int(cell.traffic["poses"])
    n = len(traffic["cycle"])
    ref_score = rd.build(port.model_config(cfg["score_model"], RefConfig, RefSigma))
    ref_conf = rd.build(port.model_config(cfg["confidence_model"], RefConfig, RefSigma))
    specs = init_specs(ref_score), init_specs(ref_conf)
    system = None
    reference = rd.ReferenceDocker(ref_score, ref_conf, port.sampler_config(cfg["sampler"], RefSampler),
                                   device)
    out = {"program": [], "control": []}
    for kind, seed in [("program", s) for s in seeds] + [("control", s) for s in control_seeds]:
        t0 = time.perf_counter()
        score_sd = make_state_dict(specs[0], inputs.sub_seed(seed, 0, 0), device)
        conf_sd = make_state_dict(specs[1], inputs.sub_seed(seed, 0, 1), device)
        reference.model.load_state_dict(score_sd)
        reference.confidence_model.load_state_dict(conf_sd)
        if system is None:
            system = port.PortDocker(cfg, score_sd, conf_sd, device)
        else:
            system.pipe.model.load_state_dict(score_sd)
            system.pipe.confidence_model.load_state_dict(conf_sd)
        fields = inputs.make_cycle(seed, traffic, cfg)
        port_inputs = [system.complex(*f) for f in fields]  # one object per complex, as in a run
        for i in check.checked_docks(seed, n, int(cell.limits["docks_checked"])) + [n]:
            dock_seed = inputs.sub_seed(seed, 2, i)
            data, aa = rd.as_reference_data(*fields[i % n])
            if kind == "program":
                pdata, paa = port_inputs[i % n]
                with system.recording_steps() as steps:
                    res = system.dock(pdata, paa, P, dock_seed)
                states, scores = step_arrays(steps, data.n_lig, data.n_bonds)
            else:
                res, states, scores = check.control(reference, data, aa, P, dock_seed, device)
            nums = check.judge(reference, data, aa, res, states, scores, P, dock_seed, device)
            out[kind].append(dict(seed=seed, dock=i, **nums))
            print(json.dumps({"kind": kind, "seed": seed, "dock": i, **nums}), flush=True)
        print(f"  seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    # a run compares the worst of its judged docks: the lower reading is the
    # largest of the program's, the upper the smallest control seed's worst
    summary = {}
    for k in check.NUMBERS:
        worst = {}
        for d in out["control"]:
            worst[d["seed"]] = max(worst.get(d["seed"], d[k]), d[k])
        summary[k] = {"lower": max((d[k] for d in out["program"]), default=None),
                      "upper": min(worst.values(), default=None)}
    out["summary"] = summary
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--json", default=None)
    a = p.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = readings(a.workload, ints(a.seeds), ints(a.control_seeds))
    print(json.dumps(out["summary"]))
    if a.json:
        Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        Path(a.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
