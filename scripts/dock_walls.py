"""Time the docks of ``chip_smoke.py`` phases 4 (float32) and H2 (bfloat16)
on one CUDA card, and list the bfloat16 kernel plans the docks use.

    python scripts/dock_walls.py [--tree DIR] [--repeats N] [--blocks] [--json PATH]

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
slice in one block or not). Then it times the float32 contraction at the
float32 dock's ``--contractions`` largest shapes (rows x K x (H+1); one
more dock records them) through ``chip_smoke.time_tp3_blocks``: the whole
call ``fused_tp3(tp, ...)`` as the dock makes it, beside its plain version,
the einsum pair on a coupled tensor built beforehand and the bound (CUDA
events, mean of ``--iters`` calls after 3 warm-up calls). ``--blocks``
times the same at the benchmark cells' largest blocks instead of docking:
DiffDock-L's joint-layer TP at rec<-lig 3200 x 32 (the kernel table's
block) and at bucket (32, 1536) with 10 poses (rec<-lig 15360 x 32,
lig<-rec 320 x 1536, rec<-rec 15360 x 24), v1.0's widest TP at its
rec<-rec 15360 x 24, the confidence model's at lig<-atom 320 x 8704 and
atom<-atom 87040 x 8, and DiffDock-L's torsion head at 80 x 32. The
harness (``chip_smoke.py``) is this checkout's whatever ``--tree`` names.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
SH = "1x0e + 1x1o + 1x2e"
# the torsion head's harmonics: products of two to l = 4
TOR_SH = "1x2e + 1x1o + 1x2o + 1x3o + 1x0e + 1x1e + 1x2e + 1x3e + 1x4e"
DL = "48x0e + 10x1o + 10x1e + 10x0o"
V1 = "48x0e + 10x1o + 10x1e + 48x0o"
CONF = "24x0e + 6x1o + 6x1e + 24x0o"
# --blocks: label -> (irreps_in1, harmonics, irreps_out, H, rows, K)
BLOCKS = {
    "rec<-lig (conv) 3200x32": (DL, SH, DL, 144, 3200, 32),
    "rec<-lig (conv) 15360x32": (DL, SH, DL, 144, 15360, 32),
    "lig<-rec (conv) 320x1536": (DL, SH, DL, 144, 320, 1536),
    "rec<-rec (conv) 15360x24": (DL, SH, DL, 144, 15360, 24),
    "rec<-rec (v1.0) 15360x24": (V1, SH, V1, 144, 15360, 24),
    "lig<-atom (confidence) 320x8704": (CONF, SH, CONF, 72, 320, 8704),
    "atom<-atom (confidence) 87040x8": (CONF, SH, CONF, 72, 87040, 8),
    "torsion (tor_bond_conv) 80x32": (DL, TOR_SH, "48x0o + 48x0e", 144, 80, 32),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--poses", type=int, default=10)
    ap.add_argument("--contractions", type=int, default=6)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--blocks", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from diffdock_tpu_torch.data.complexes import synthetic_aa_complex
    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables
    from diffdock_tpu_torch.geometry import use_full_fp32
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.models import tpconv
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2
    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.utils import build

    dev = torch.device("cuda")
    use_full_fp32()
    card = cs.card_line()
    if args.blocks:
        from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct

        blocks = {label: (FullyConnectedTensorProduct(ins, shs, outs), rows, K, H)
                  for label, (ins, shs, outs, H, rows, K) in BLOCKS.items()}
        report = {"tree": os.path.abspath(args.tree), "card": card,
                  "blocks": cs.time_tp3_blocks(blocks, dev, args.iters)}
        print(f"card: {card}")
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(report, indent=1))
        return 0
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
    report["f32_contractions"] = time_contractions(args, cs, tpconv, cfg, ccfg, so3, torus, data, aa, P,
                                                   dev)
    print(f"card: {card}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    return 0


def time_contractions(args, cs, tpconv, cfg, ccfg, so3, torus, data, aa, P, dev) -> dict:
    """The float32 dock's largest contraction shapes, each timed by
    ``chip_smoke.time_tp3_blocks``."""
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig

    shapes, contraction = {}, tpconv.fused_tp3

    def recording(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
        N, K, H = h.shape
        shapes.setdefault((id(tp), N, K, H), (tp, N, K, H))
        return contraction(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)

    tpconv.fused_tp3 = recording  # read by the layers the pipeline builds
    try:
        pipe = DockingPipeline(dataclasses.replace(cfg, compute_dtype="float32"), 0, SamplerConfig(), so3,
                               torus, device=dev,
                               confidence_cfg=dataclasses.replace(ccfg, compute_dtype="float32"),
                               confidence_weights=1)
    finally:
        tpconv.fused_tp3 = contraction
    pipe.dock_complex(data, num_poses=P, seed=1, aa_data=aa)
    del pipe
    largest = sorted(shapes.values(), key=lambda s: -s[1] * s[2] * (s[3] + 1))[:args.contractions]
    return cs.time_tp3_blocks({f"{N} x {K} x {H + 1} ({tp.irreps_in1} -> {tp.irreps_out})": (tp, N, K, H)
                               for tp, N, K, H in largest}, dev, args.iters)


if __name__ == "__main__":
    sys.exit(main())
