#!/usr/bin/env python3
"""Phase L of ``chip_smoke.py`` (the device mesh on one card) alone.

    python3 scripts/mesh_phase.py [--poses 10] [--json PATH]

Phase L reads what phases B, E and G leave in the smoke run's temporary
directory: LM-free random-weight run directories (B), the train CLI's run
directory and dataset cache (E2) and the confidence-train CLI's CG run
directory and pose caches (G2). This script makes them the same way in a
temporary directory (the train and confidence-train CLIs for one epoch at
``chip_smoke.py``'s widths; the kernels built first, one ``nvcc`` per
source), then runs ``chip_smoke.mesh_phase`` on phase 4's complex and
models. It needs one card and prints the card line and phase L's lines.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--poses", type=int, default=10)
    parser.add_argument("--json", type=Path, default=None, help="also write phase L's report here")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    import chip_smoke as cs
    from diffdock_tpu_torch.cli import confidence_train as conf_cli
    from diffdock_tpu_torch.cli import train as train_cli
    from diffdock_tpu_torch.data.complexes import synthetic_aa_complex
    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables
    from diffdock_tpu_torch.geometry import use_full_fp32
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.parallel.mesh import kernel_libraries
    from diffdock_tpu_torch.utils import build

    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = cs.card_line()
    dev = torch.device("cuda")
    use_full_fp32()
    build.build_all(kernel_libraries())
    cfg = PRESETS["diffdock_l"]
    ccfg = dataclasses.replace(PRESETS["diffdock_s"], **cs.SHIPPED_CONFIDENCE)
    aa = synthetic_aa_complex(np.random.RandomState(0), n_lig=32, n_rec=320, n_bonds=6, atoms_per_res=8,
                              lm_dim=cfg.lm_embedding_dim)
    so3, torus = get_so3_tables(device=dev), get_torus_tables(device=dev)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        cs._write_run_dirs(tmp / "runs_no_lm", dataclasses.replace(cfg, lm_embedding_dim=0),
                           dataclasses.replace(ccfg, lm_embedding_dim=0))
        root = tmp / "train"
        root.mkdir()
        (root / "train.txt").write_text("\n".join(cs.TRAIN_COMPLEXES) + "\n")
        if train_cli.main(["--model_preset", "diffdock_l", "--data_dir", str(cs.E2E_SYNTH), "--split_train",
                           str(root / "train.txt"), "--esm_embeddings_dir", str(cs.E2E_SYNTH / "_esm"),
                           "--cache_path", str(root / "cache"), "--log_dir", str(root / "run"),
                           "--batch_size", str(cs.TRAIN_BATCH), "--n_epochs", "1", "--device", "cuda"]) != 0:
            raise cs.PhaseError("the train CLI failed")
        croot = tmp / "confidence"
        croot.mkdir()
        (croot / "train.txt").write_text("\n".join(cs.CONF_COMPLEXES) + "\n")
        if conf_cli.main(["--data_dir", str(cs.E2E_SYNTH), "--split_train", str(croot / "train.txt"),
                          "--cache_path", str(croot / "cache"), "--pose_cache", str(croot / "poses"),
                          "--log_dir", str(croot / "cg"), "--cache_id", "0", "--samples_per_complex",
                          str(cs.CONF_SAMPLES), "--inference_steps", str(cs.CONF_STEPS), "--batch_size",
                          str(cs.CONF_BATCH), "--n_epochs", "1", "--device", "cuda"] + cs.CONF_CG_ARGS) != 0:
            raise cs.PhaseError("the confidence-train CLI failed")
        cs._log(f"[L prerequisites] run directories, train and confidence-train runs | "
                f"{time.perf_counter() - t0:.1f} s")
        report = cs.mesh_phase(args, tmp, cfg, ccfg, aa.base, aa, so3, torus, card, dev)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
