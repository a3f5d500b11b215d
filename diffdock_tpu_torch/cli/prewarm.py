"""Warm the card ahead of an evaluation sweep (port of ``diffdock_tpu/cli/prewarm.py``).

The JAX package compiles each (bucket, poses) docking program into XLA's
persistent cache ahead of a sweep. Eager PyTorch compiles no program; what a
sweep's first dock pays on the card is:

* the hand-written kernels built with ``nvcc`` into ``_build/``
  (``utils/build.py:build_all``, one ``nvcc`` per source, all at once);
* the SO(3) and torus tables built in numpy and cached in ``_build/tables/``
  (``diffusion/tables.py``);
* per process, the first call's set-up (CUDA context, library handles,
  the allocator's growth to the program's shapes).

So this command builds the kernels and caches the tables: that is what it
carries to a later process. It then runs each job's program once
(``DockingPipeline.dock_program``) on a ``synthetic_complex`` at exactly the
job's sizes (the model's config from ``--model_dir``/``--model_preset``,
random weights where no checkpoint is given: the weights' values do not
change the work), printing its seconds and, on the card, its peak memory.
That job loop is a check that each bucket fits in memory, and nothing more:
its set-up dies with the process, so a sweep pays it again. A bucket that
does not fit on the card fails here, not mid-sweep. The job list is the JAX
command's: the cover ladder (``inference/ladder.py``) unless
``--no_cover_ladder``, with ``--fine`` the fine (``--dense``: dense) plan,
with ``--samples_per_complex`` each cover bucket at that pose count, then
each ``--bucket``; identical jobs run once. A second run builds nothing.
"""

from __future__ import annotations

import argparse
import time


def get_parser():
    p = argparse.ArgumentParser(description="warm kernel builds, tables and the allocator ahead of a sweep")
    p.add_argument("--model_preset", default="diffdock_l")
    p.add_argument("--model_dir", default=None,
                   help="read the score-model config from this native "
                        "checkpoint dir so the warmed programs match the "
                        "sweep exactly (overrides --model_preset)")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--confidence_model_dir", default=None,
                   help="also run the confidence model in the warmed "
                        "programs, config read from this native "
                        "checkpoint dir (CG confidence only)")
    p.add_argument("--confidence_ckpt", default=None)
    p.add_argument("--confidence_preset", default=None,
                   help="alternatively build a random confidence model "
                        "from this preset (confidence_mode, old "
                        "architecture by default)")
    p.add_argument("--old_confidence_model",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="architecture for --confidence_preset (the shipped "
                        "confidence checkpoint is the old architecture)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--actual_steps", type=int, default=19)
    p.add_argument("--bucket", action="append", default=[],
                   metavar="NL,NR,NB,POSES",
                   help="extra (bucket, poses) programs to run; "
                        "repeatable. Default: the cover ladder "
                        "(inference/ladder.py)")
    p.add_argument("--no_cover_ladder", action="store_true", default=False,
                   help="only run --bucket entries")
    p.add_argument("--fine", action="store_true", default=False,
                   help="additionally run the fine plan's programs "
                        "(inference/ladder.py:fine_plan, a PDBBind-like "
                        "size mix)")
    p.add_argument("--dense", action="store_true", default=False,
                   help="with --fine: the dense-grid plan instead "
                        "(what bucket_ladder='fine_dense' executes)")
    p.add_argument("--samples_per_complex", type=int, default=None,
                   help="also run each cover bucket at this pose count "
                        "(e.g. 10 for the reference default recipe)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cpu runs every kernel's plain version and builds nothing)")
    return p


def jobs_from_args(args):
    """The (nl, nr, nb, poses) jobs in the JAX command's order, each once."""
    from diffdock_tpu_torch.inference.ladder import COVER_LADDER, fine_plan

    ladder = [] if args.no_cover_ladder else list(COVER_LADDER)
    jobs = list(ladder)
    if args.fine:
        jobs += list(fine_plan(dense=args.dense).keys())
    if args.samples_per_complex:
        jobs += [(nl, nr, nb, args.samples_per_complex) for nl, nr, nb, _ in ladder]
    for spec in args.bucket:
        nl, nr, nb, poses = (int(x) for x in spec.split(","))
        jobs.append((nl, nr, nb, poses))
    return list(dict.fromkeys(jobs))  # dedupe identical (bucket, P) programs


def build_kernels() -> None:
    """Build every hand-written kernel library that is not in ``_build/``
    yet, and say how many needed ``nvcc``."""
    from diffdock_tpu_torch.ops import factored_tp1, factored_tp2, fused_tp3
    from diffdock_tpu_torch.utils import build

    libs = {m.__name__.rsplit(".", 1)[1]: m._SOURCES for m in (fused_tp3, factored_tp2, factored_tp1)}
    missing = [name for name, srcs in libs.items() if not build.library_path(name, srcs).exists()]
    t0 = time.perf_counter()
    build.build_all(libs)
    print(f"kernels: {len(missing)} of {len(libs)} libraries compiled with nvcc"
          f"{' (' + ', '.join(missing) + ')' if missing else ''}, "
          f"{len(libs) - len(missing)} already built in {build.BUILD_DIR} | "
          f"{time.perf_counter() - t0:.1f}s", flush=True)


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from diffdock_tpu_torch.data.complexes import synthetic_complex
    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.train.checkpoints import load_checkpoint
    from diffdock_tpu_torch.utils.convert import state_dict_from_flax

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        build_kernels()
    else:
        print(f"kernels: none built (device {dev}: the plain versions run)", flush=True)

    t0 = time.perf_counter()
    so3 = get_so3_tables(device=dev)
    torus = get_torus_tables(device=dev)
    print(f"tables: SO(3) {tuple(so3.score_norms.shape)} + torus {tuple(torus.score_table.shape)} | "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    if args.model_dir:
        params, cfg, _ = load_checkpoint(args.model_dir, args.ckpt)
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
        weights = state_dict_from_flax(params, cfg)
    else:
        cfg = dataclasses.replace(PRESETS[args.model_preset], compute_dtype=args.compute_dtype)
        weights = 0

    conf_cfg = conf_weights = None
    if args.confidence_model_dir:
        conf_params, conf_cfg, _ = load_checkpoint(args.confidence_model_dir, args.confidence_ckpt)
        conf_weights = state_dict_from_flax(conf_params, conf_cfg)
    elif args.confidence_preset:
        conf_cfg = dataclasses.replace(
            PRESETS[args.confidence_preset],
            confidence_mode=True,
            old_architecture=args.old_confidence_model,
            compute_dtype=args.compute_dtype,
        )
        conf_weights = 1
    if conf_cfg is not None and conf_cfg.all_atoms:
        raise SystemExit(
            "prewarm supports CG confidence models only (an all-atom "
            "confidence program additionally depends on the atom bucket)"
        )

    pipeline = DockingPipeline(
        cfg, weights,
        SamplerConfig(inference_steps=args.inference_steps, actual_steps=args.actual_steps),
        so3, torus, device=dev,
        confidence_cfg=conf_cfg, confidence_weights=conf_weights,
    )

    rng = np.random.RandomState(0)
    for nl, nr, nb, poses in jobs_from_args(args):
        # the job sizes ARE the program's bucket sizes: synthetic_complex is
        # built at exactly these sizes, so the padding is an identity
        data = synthetic_complex(rng, n_lig=nl, n_rec=nr, n_bonds=nb,
                                 lm_dim=cfg.lm_embedding_dim or 1280)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        pipeline.dock_program(data, (nl, nr, nb), poses)
        if cuda:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        peak = (f"peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB" if cuda
                else "peak memory not measured (cpu)")
        print(f"bucket nl={nl} nr={nr} nb={nb} poses={poses}: {dt:.1f}s | {peak}", flush=True)
    print("prewarm complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
