"""Time the docks of ``chip_smoke.py`` phases 4 (float32) and H2 (bfloat16)
on one CUDA card, and list the bfloat16 kernel plans the docks use.

    python scripts/dock_walls.py [--tree DIR] [--repeats N] [--json PATH]

``--tree`` names a checkout whose ``diffdock_tpu_torch`` is timed (default:
this one), so that two commits can be timed in one session on one card
(run them in turns: old, new, new, old). The dock is phase 4's: the
complex of ``synthetic_aa_complex`` (32 ligand atoms, 320 residues, 6
bonds, 8 atoms per residue, numpy seed 0), DiffDock-L with random weights
(seed 0) ranked by the shipped confidence model (seed 1), 10 poses, 19 of
20 steps, TF32 off, from fixed draws. Each mode gets a warm-up dock, then
``--repeats`` timed docks; the script prints each wall, their median, the
``fused_tp3`` launches by mode of the last dock and every bfloat16 kernel
plan the docks took (rows, K, H -> neighbours per stage, ring slots, every
slice in one block or not). Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--poses", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from diffdock_tpu_torch.data.complexes import synthetic_aa_complex
    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables
    from diffdock_tpu_torch.geometry import use_full_fp32
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2
    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.utils import build

    dev = torch.device("cuda")
    use_full_fp32()
    card = cs.card_line()
    t0 = time.perf_counter()
    build.build_all({"fused_tp3": ft._SOURCES, "factored_tp2": f2._SOURCES, "factored_tp1": f1._SOURCES})
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    so3, torus = get_so3_tables(device=dev), get_torus_tables(device=dev)
    cfg = PRESETS["diffdock_l"]
    ccfg = dataclasses.replace(PRESETS["diffdock_s"], **cs.SHIPPED_CONFIDENCE)
    aa = synthetic_aa_complex(np.random.RandomState(0), n_lig=32, n_rec=320, n_bonds=6, atoms_per_res=8,
                              lm_dim=cfg.lm_embedding_dim)
    data, P = aa.base, args.poses
    report = {"tree": os.path.abspath(args.tree), "card": card, "modes": {}}
    for dtype in ("float32", "bfloat16"):
        pipe = DockingPipeline(dataclasses.replace(cfg, compute_dtype=dtype), 0, SamplerConfig(), so3, torus,
                               device=dev, confidence_cfg=dataclasses.replace(ccfg, compute_dtype=dtype),
                               confidence_weights=1)
        nb = pipe.dock_bucket(data)[0][2]
        drawn = pipe.draw_noise(P, nb, seed=0)
        pipe.dock_complex(data, num_poses=P, seed=1, aa_data=aa)  # the first-call costs
        walls = []
        for _ in range(args.repeats):
            ft.counts.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.dock_complex(data, num_poses=P, seed=0, noise=lambda *a: drawn, aa_data=aa)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = ft.counts.as_dict()
        med = float(np.median(walls))
        report["modes"][dtype] = {"walls_s": walls, "median_s": med, "launches": launches}
        print(f"{dtype:8s} dock, {P} poses: median {med:.4f} s | walls {' '.join(f'{w:.4f}' for w in walls)} "
              f"| launches {launches} | {card}", flush=True)
    plans = []
    for key, plan in ft._plans.items():
        _, rows, K, H, _ = key
        plans.append({"rows": rows, "K": K, "H": H, "KC": plan.KC, "S": plan.S, "whole": bool(plan.whole),
                      "R": plan.R})
    plans.sort(key=lambda p: (p["rows"], p["K"], p["H"]))
    report["bf16_plans"] = plans
    for p in plans:
        print(f"  plan rows={p['rows']} K={p['K']} H={p['H']}: KC {p['KC']} x S {p['S']}, R {p['R']}, "
              f"{'every slice per block' if p['whole'] else 'one slice per block'}")
    print(f"card: {card}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
