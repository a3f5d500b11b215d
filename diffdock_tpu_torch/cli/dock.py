"""Docking CLI of the port (port of ``diffdock_tpu/cli/dock.py``; the
reference ``inference.py`` equivalent).

Examples::

    python -m diffdock_tpu_torch.cli.dock \
        --protein_path complex/protein.pdb --ligand complex/ligand.sdf \
        --model_dir runs/score --confidence_model_dir runs/confidence \
        --out_dir results/complex --samples_per_complex 10

    python -m diffdock_tpu_torch.cli.dock --protein_ligand_csv pairs.csv \
        --model_dir runs/score --confidence_model_dir runs/confidence --out_dir results

The flags and defaults are the JAX CLI's, with one addition: ``--device``
(default ``cuda``). ``--compute_dtype`` defaults to ``bfloat16``, as in the
JAX CLI, and sets the score model's conv layers only (not its
``final_conv`` and ``tor_bond_conv``, which stay float32 as in the JAX
model); the confidence model keeps its run directory's dtype. ``--model_dir``
and ``--confidence_model_dir`` read native run directories
(``model_parameters.yml`` plus msgpack weights) and the reference's own
(``.pt`` weights plus its args dump), which are converted once into a
``tpu_native*`` subdirectory; a missing directory is downloaded first.
The confidence model may be of the old (v1.0) family or of the new
architectures (a native run directory says which; a reference ``.pt``
directory of a new-architecture model needs ``--no-old_confidence_model``),
coarse-grained or all-atom, as ``models/factory.py:build_model`` builds it.
``--crop_beyond`` crops the receptor per step and ``--pocket_capacity``
compacts it to that many residues.

``--pose_devices N`` shards each complex's poses over N ranks
(``parallel/mesh.py``; 0: every visible card): the CLI starts one rank per
card up to N (``--device cpu``: N CPU ranks), or joins the group that
``torchrun`` describes::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m diffdock_tpu_torch.cli.dock ... --pose_devices 2

Every rank docks its share of the poses; rank 0 alone writes the files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

from diffdock_tpu_torch.models.config import ConfigError


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="diffdock_tpu_torch docking")
    p.add_argument("--config", default=None, help="YAML overriding defaults")
    p.add_argument("--protein_path", default=None)
    p.add_argument("--protein_sequence", default=None,
                   help="fold with ESMFold (not ported: raises)")
    p.add_argument("--ligand", "--ligand_description", dest="ligand",
                   default=None,
                   help="ligand file (.sdf/.mol/.pdb); SMILES needs RDKit and raises")
    p.add_argument("--protein_ligand_csv", default=None,
                   help="CSV with columns complex_name,protein_path,ligand_description")
    p.add_argument("--complex_name", default=None)
    p.add_argument("--out_dir", default="results/user_predictions")
    p.add_argument("--model_dir", default=None,
                   help="run dir with model_parameters.yml + model.msgpack, "
                        "or a reference run dir with .pt weights")
    p.add_argument("--ckpt", default=None,
                   help="weights file inside --model_dir; reference .pt "
                        "names map to the converted .msgpack flavors")
    p.add_argument("--confidence_model_dir", default=None)
    p.add_argument("--confidence_ckpt", default=None,
                   help="weights file inside --confidence_model_dir")
    p.add_argument("--samples_per_complex", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=None,
                   help="poses in flight per forward (reference "
                        "inference.py:78). Default None = all samples at "
                        "once; both are capped at the card's memory bound "
                        "(inference/pipeline.py:auto_pose_chunk)")
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--actual_steps", type=int, default=19)
    p.add_argument("--sigma_schedule", default="expbeta")
    p.add_argument("--inf_sched_alpha", type=float, default=1.0)
    p.add_argument("--inf_sched_beta", type=float, default=1.0)
    p.add_argument("--no_final_step_noise", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="zero the SDE noise at the last executed step "
                        "(reference inference.py:79 default True)")
    p.add_argument("--ode", action="store_true", default=False)
    p.add_argument("--no_random", action="store_true", default=False)
    p.add_argument("--initial_noise_std_proportion", type=float,
                   default=1.4601642460337794)
    p.add_argument("--choose_residue", action="store_true", default=False,
                   help="initial placement at a random receptor residue "
                        "(reference inference.py:86)")
    # low-temperature sampling (reference inference.py:88-96); defaults are
    # the SamplerConfig tuned values from default_inference_args.yaml
    for comp in ("tr", "rot", "tor"):
        p.add_argument(f"--temp_sampling_{comp}", type=float, default=None)
        p.add_argument(f"--temp_psi_{comp}", type=float, default=None)
        p.add_argument(f"--temp_sigma_data_{comp}", type=float, default=None)
    p.add_argument("--old_score_model", action="store_true", default=False,
                   help="a reference .pt score model of the v1.0 "
                        "architecture; a native run dir carries its own")
    p.add_argument("--old_confidence_model", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="a reference .pt confidence model of the v1.0 "
                        "architecture (the shipped default); a native run "
                        "dir carries its own")
    p.add_argument("--loglevel", "-l", "--log", dest="loglevel",
                   default="WARNING")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_preset", default="diffdock_s",
                   help="preset when no --model_dir given (random weights)")
    p.add_argument("--save_visualisation", action="store_true", default=False,
                   help="write rankN_reverseprocess.pdb denoising trajectories")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="the score model's conv-layer compute dtype (the "
                        "confidence model keeps its run directory's)")
    p.add_argument("--crop_beyond", type=float, default=None,
                   help="sigma-dependent receptor crop: each step keeps the "
                        "residues within 3*tr_sigma + crop_beyond of a pose")
    p.add_argument("--bucket_ladder",
                   choices=("fine", "fine_dense", "cover"),
                   default="fine",
                   help="'fine' = minimal-padding geometric buckets; "
                        "'fine_dense' = ~1.2x-spaced rungs; 'cover' = the "
                        "evaluation sweeps' cover ladder (inference/ladder.py)")
    p.add_argument("--pose_devices", type=int, default=1,
                   help="shard each complex's pose batch over this many "
                        "ranks, one per card (0 = every visible card; "
                        "parallel/mesh.py); the pose count is rounded up to "
                        "a multiple of it and the surplus dropped")
    p.add_argument("--pocket_capacity", type=int, default=None,
                   help="with --crop_beyond: compact the receptor to this "
                        "many nearest residues per step instead of masking")
    p.add_argument("--device", default="cuda",
                   help="torch device to dock, and fold a protein_sequence, on ('cuda' or 'cpu')")
    return p


def sampler_config_from_args(args):
    """A SamplerConfig from parsed CLI args. Per-component temperature
    overrides (``--temp_sampling_tr`` etc.) fall back to the tuned
    SamplerConfig defaults when not given."""
    from diffdock_tpu_torch.inference.sampler import SamplerConfig

    base = SamplerConfig()

    def _triple(prefix):
        vals = [getattr(args, f"{prefix}_{c}", None) for c in ("tr", "rot", "tor")]
        return tuple(v if v is not None else d for v, d in zip(vals, getattr(base, prefix)))

    return SamplerConfig(
        inference_steps=args.inference_steps,
        actual_steps=args.actual_steps,
        sigma_schedule=args.sigma_schedule,
        inf_sched_alpha=args.inf_sched_alpha,
        inf_sched_beta=args.inf_sched_beta,
        no_final_step_noise=args.no_final_step_noise,
        ode=args.ode,
        no_random=args.no_random,
        initial_noise_std_proportion=args.initial_noise_std_proportion,
        choose_residue=getattr(args, "choose_residue", False),
        temp_sampling=_triple("temp_sampling"),
        temp_psi=_triple("temp_psi"),
        temp_sigma_data=_triple("temp_sigma_data"),
    )


def _run_dir(model_dir: str, ckpt, confidence_mode: bool, old: bool):
    """(run directory, weights file) to load for ``--model_dir`` or
    ``--confidence_model_dir``: a missing directory is downloaded first
    (reference ``inference.py:123-143``), a reference ``.pt`` directory is
    converted once into a native subdirectory (``utils/download.py``), as
    in the JAX CLI."""
    from diffdock_tpu_torch.utils.download import ensure_downloaded, prepare_model_dir

    files = ensure_downloaded(model_dir)
    if files:
        print(f"downloaded {len(files)} files for {model_dir}", file=sys.stderr)
    run_dir = prepare_model_dir(model_dir, ckpt, confidence_mode=confidence_mode, old=old)
    return run_dir, (ckpt if run_dir == model_dir else None)


def load_pipeline(args):
    """The DockingPipeline the parsed ``args`` ask for, on ``args.device``.
    ``--compute_dtype`` replaces the score model's config's, as in the JAX
    CLI. With ``--pose_devices`` asking for more than one rank the pipeline
    gets this process group's mesh (the process must be one of its ranks:
    see :func:`main`)."""
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.parallel import mesh as mesh_mod
    from diffdock_tpu_torch.train.checkpoints import load_checkpoint
    from diffdock_tpu_torch.utils.convert import state_dict_from_flax

    mesh = None
    if mesh_mod.ranks_for(args.pose_devices, args.device) > 1:
        if not mesh_mod.in_rank():
            raise ConfigError(f"--pose_devices {args.pose_devices}: the pipeline's mesh needs the "
                              "ranks of a process group (the CLI's main starts them)")
        mesh = mesh_mod.make_mesh(device=args.device)
    sampler_cfg = sampler_config_from_args(args)
    if args.model_dir:
        params, cfg, _ = load_checkpoint(*_run_dir(
            args.model_dir, args.ckpt, False, getattr(args, "old_score_model", False)))
        weights = state_dict_from_flax(params, cfg)
    else:
        print(
            "WARNING: no --model_dir given; using RANDOM weights "
            f"({args.model_preset}) — poses will not be meaningful.",
            file=sys.stderr,
        )
        # the preset runs without its LM feature block unless embeddings are
        # given (the evaluate CLI's --esm_embeddings_path), as in the JAX CLI
        cfg = PRESETS[args.model_preset]
        if not getattr(args, "esm_embeddings_path", None):
            cfg = dataclasses.replace(cfg, lm_embedding_dim=0)
        weights = 0
    if args.compute_dtype != cfg.compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    if args.crop_beyond is not None:
        cfg = dataclasses.replace(cfg, crop_beyond=args.crop_beyond)

    conf_cfg = conf_weights = None
    if args.confidence_model_dir:
        # the shipped default confidence model is the v1.0 ("old")
        # architecture (reference inference.py:84)
        conf_params, conf_cfg, _ = load_checkpoint(*_run_dir(
            args.confidence_model_dir, args.confidence_ckpt, True,
            getattr(args, "old_confidence_model", True)))
        conf_weights = state_dict_from_flax(conf_params, conf_cfg)

    return DockingPipeline(
        score_cfg=cfg,
        score_weights=weights,
        sampler_cfg=sampler_cfg,
        device=args.device,
        confidence_cfg=conf_cfg,
        confidence_weights=conf_weights,
        pocket_capacity=args.pocket_capacity,
        bucket_ladder=args.bucket_ladder,
        mesh=mesh,
    )


# reference default_inference_args.yaml keys that have no equivalent here
# but are harmless to accept (no warning)
_ACCEPTED_NOOP_KEYS = {
    "different_schedules",
    "limit_failures",
    "no_model",
    "old_filtering_model",
    "old_score_model",
    "old_confidence_model",
    "resample_rdkit",
    "no_random_pocket",
    "loglevel",
}


def apply_config_overrides(args, overrides):
    """Overlay a YAML config (including the reference's
    ``default_inference_args.yaml``) onto parsed args; unknown keys WARN
    instead of being silently dropped."""
    for k, v in (overrides or {}).items():
        if k == "ligand_description":
            k = "ligand"
        if hasattr(args, k):
            setattr(args, k, v)
        elif k not in _ACCEPTED_NOOP_KEYS:
            print(f"WARNING: unknown config key {k!r} ignored", file=sys.stderr)
    return args


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = get_parser().parse_args(argv)
    if args.config:
        from diffdock_tpu_torch.utils import simple_yaml

        with open(args.config) as f:
            apply_config_overrides(args, simple_yaml.load(f.read()))
    from diffdock_tpu_torch.parallel import mesh as mesh_mod

    ranks = mesh_mod.ranks_for(args.pose_devices, args.device)
    if ranks > 1 and not mesh_mod.in_rank():
        # one rank per card (or CPU rank), each running this main
        return mesh_mod.launch(main, (argv,), ranks, args.device)

    from diffdock_tpu_torch.data.inference_dataset import (
        InferenceDatasetBuilder, InferenceSpec, specs_from_csv,
    )

    if args.protein_ligand_csv:
        specs = specs_from_csv(args.protein_ligand_csv)
        for i, s in enumerate(specs):
            if not s.name and s.protein_path:
                specs[i].name = os.path.splitext(os.path.basename(s.protein_path))[0]
    else:
        if not ((args.protein_path or args.protein_sequence) and args.ligand):
            print("need --protein_path/--protein_sequence + --ligand "
                  "or --protein_ligand_csv", file=sys.stderr)
            return 2
        name = args.complex_name or (
            os.path.splitext(os.path.basename(args.protein_path))[0]
            if args.protein_path else "complex_0"
        )
        specs = [InferenceSpec(name, args.protein_path, args.protein_sequence, args.ligand)]

    pipeline = load_pipeline(args)
    builder = InferenceDatasetBuilder(workdir=args.out_dir, device=args.device)

    failures = 0
    for i, spec in enumerate(specs):
        name = spec.name
        out = os.path.join(args.out_dir, name)
        t0 = time.time()
        try:
            mol, protein, lm = builder.load(spec, seed=i)
            result = pipeline.dock_mol_protein(
                mol, protein, out,
                num_poses=args.samples_per_complex, seed=args.seed,
                lm_embeddings=lm,
                save_trajectory=args.save_visualisation,
                batch_size=args.batch_size,
            )
        except Exception as e:  # noqa: BLE001 — skip-and-continue like the reference
            print(f"[{name}] FAILED: {type(e).__name__}: {e}", file=sys.stderr)
            failures += 1
            continue
        best = (f"{result.confidence[result.order[0]]:.3f}"
                if result.confidence is not None else "n/a")
        print(f"[{name}] {result.poses.shape[0]} poses in {time.time() - t0:.1f}s"
              f" -> {out} (best confidence {best})")
    print(f"done: {len(specs) - failures}/{len(specs)} complexes succeeded")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
