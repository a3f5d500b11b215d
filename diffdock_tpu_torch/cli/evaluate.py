"""Evaluation CLI of the port (port of ``diffdock_tpu/cli/evaluate.py``; the
reference's ``evaluate.py``): dock a test set with known crystal poses,
score the poses by symmetry-corrected RMSD, print the metric table and
write the per-complex arrays.

Example::

    python -m diffdock_tpu_torch.cli.evaluate --data_dir data/PDBBind_processed \
        --split test_names.txt --esm_embeddings_path esm/ \
        --model_dir runs/score --confidence_model_dir runs/confidence \
        --out_dir results/evaluation

Datasets: ``pdbbind`` (``{name}/{name}_protein_processed.pdb`` and
``{name}_ligand.sdf``), ``posebusters`` (``{name}_protein.pdb``, the least
RMSD over every pose of ``{name}_ligands.sdf``) and ``moad`` (DockGen: the
least RMSD over the ligands of the same receptor and formula). Artifacts
under ``--out_dir``, as the JAX CLI writes them: ``rmsds.npy``,
``centroid_distances.npy``, ``run_times.npy``, ``names.npy``,
``confidences.npy``, ``min_self_distances.npy`` (and ``gnina_*.npy`` with
``--gnina_minimize``), each again with a ``no_overlap_`` prefix for
``--no_rec_overlap_names``, and ``metrics.json``.

The flags and defaults are the JAX CLI's, with one addition, as in
``cli/dock.py``: ``--device`` (default ``cuda``). ``--compute_dtype``
defaults to ``bfloat16``, as in the JAX CLI, and reaches the score model
(see ``cli/dock.py``). ``--pose_devices N`` shards each complex's poses
over N ranks, as the dock CLI does; ``--complex_devices N`` (exclusive with
it) docks N complexes at once, one per rank, grouped by size
(``DockingPipeline.dock_batch``; each complex's run time is its group's
wall over the group's size), and a group that fails falls back to the
sequential docks with retries. Either starts its ranks as the dock CLI
does (one per card up to N, 0 for every card; or under ``torchrun``);
rank 0 alone writes the artifacts. ``--crop_beyond`` and ``--pocket_capacity`` crop the
receptor as in the dock CLI, and ``--model_dir`` and
``--confidence_model_dir`` may be reference ``.pt`` run directories; the
confidence model may be of either family, as in the dock CLI (the run
directories of ``cli/confidence_train.py`` included).

One deliberate deviation from the JAX CLI: with an all-atom confidence
model (the shipped default), the dataset is featurized with the receptor's
atoms and each dock gets them, so the confidence model ranks the poses.
The JAX CLI builds its dataset without atoms and docks without them, so
its pipeline refuses every dock there and each complex becomes a penalty
row (ROADMAP, facts of the reference).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description="diffdock_tpu_torch evaluation")
    p.add_argument("--data_dir", required=True,
                   help="PDBBind-layout root (or MOAD root with --dataset moad)")
    p.add_argument("--dataset", default="pdbbind",
                   choices=["pdbbind", "posebusters", "moad"],
                   help="posebusters = {name}_protein.pdb/{name}_ligand.sdf "
                        "layout with min-RMSD over all poses in "
                        "{name}_ligands.sdf; moad = DockGen-style eval with "
                        "min RMSD over all same-formula ground-truth poses")
    p.add_argument("--split", default=None, help="file with complex names")
    p.add_argument("--protein_file", default=None,
                   help="protein file stem, e.g. 'protein_processed' -> "
                        "{name}_protein_processed.pdb")
    p.add_argument("--ligand_file", default=None,
                   help="ligand file stem, e.g. 'ligand' -> {name}_ligand.sdf")
    p.add_argument("--model_dir", default=None)
    p.add_argument("--ckpt", default=None,
                   help="weights file in --model_dir")
    p.add_argument("--confidence_model_dir", default=None)
    p.add_argument("--confidence_ckpt", default=None)
    p.add_argument("--old_confidence_model", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="accepted for reference CLI compatibility; the "
                        "architecture is read from the checkpoint config")
    p.add_argument("--model_preset", default="diffdock_s")
    p.add_argument("--samples_per_complex", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=None,
                   help="poses in flight per forward. Default None: the "
                        "cover ladder entry's pose count with --bucket_ladder "
                        "cover, else all poses; every value is capped at the "
                        "card's memory bound (inference/pipeline.py:"
                        "auto_pose_chunk)")
    p.add_argument("--inference_steps", type=int, default=20)
    p.add_argument("--actual_steps", type=int, default=19)
    p.add_argument("--sigma_schedule", default="expbeta")
    p.add_argument("--inf_sched_alpha", type=float, default=1.0)
    p.add_argument("--inf_sched_beta", type=float, default=1.0)
    p.add_argument("--no_random", action="store_true", default=False)
    p.add_argument("--no_final_step_noise", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="zero the SDE noise at the last executed step "
                        "(reference evaluate.py:123 default False)")
    p.add_argument("--ode", action="store_true", default=False)
    p.add_argument("--initial_noise_std_proportion", type=float,
                   default=-1.0,
                   help="-1.0 = tr_sigma_max Gaussian; DiffDock-L runs pass "
                        "the tuned 1.4601642460337794")
    p.add_argument("--choose_residue", action="store_true", default=False)
    for comp in ("tr", "rot", "tor"):
        p.add_argument(f"--temp_sampling_{comp}", type=float, default=None)
        p.add_argument(f"--temp_psi_{comp}", type=float, default=None)
        p.add_argument(f"--temp_sigma_data_{comp}", type=float, default=None)
    # pocket-knowledge evaluation: start poses at the true pocket center with
    # small translation noise; with --different_schedules the time grid is
    # capped so that translation diffusion starts at pocket_tr_max
    p.add_argument("--pocket_knowledge", action="store_true", default=False)
    p.add_argument("--no_random_pocket", action="store_true", default=False,
                   help="disable initial randomization (pocket eval)")
    p.add_argument("--pocket_tr_max", type=float, default=3.0)
    p.add_argument("--pocket_cutoff", type=float, default=5.0)
    p.add_argument("--different_schedules", action="store_true",
                   default=False)
    p.add_argument("--limit_complexes", type=int, default=0)
    p.add_argument("--out_dir", default="results/evaluation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache_path", default="data/cache_tpu")
    p.add_argument("--esm_embeddings_path", default=None,
                   help="directory of precomputed per-complex LM "
                        "embedding .npy files")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="the score model's conv-layer compute dtype")
    p.add_argument("--gnina_minimize", action="store_true", default=False)
    p.add_argument("--gnina_path", default="gnina")
    p.add_argument("--gnina_full_dock", action="store_true", default=False)
    p.add_argument("--gnina_autobox_add", type=float, default=4.0)
    p.add_argument("--gnina_poses_to_optimize", type=int, default=1)
    p.add_argument("--crop_beyond", type=float, default=None,
                   help="sigma-dependent receptor crop: each step keeps the "
                        "residues within 3*tr_sigma + crop_beyond of a pose")
    p.add_argument("--pocket_capacity", type=int, default=None,
                   help="with --crop_beyond: compact the receptor to this "
                        "many nearest residues per step instead of masking")
    p.add_argument("--bucket_ladder",
                   choices=("fine", "fine_dense", "cover"),
                   default="cover",
                   help="'cover' (default for sweeps) pads each complex to "
                        "the cover ladder (inference/ladder.py); 'fine' = "
                        "minimal-padding geometric buckets; 'fine_dense' = "
                        "~1.2x-spaced rungs")
    p.add_argument("--pose_devices", type=int, default=1,
                   help="shard each complex's pose batch over this many "
                        "ranks (0 = every visible card; see cli.dock)")
    p.add_argument("--complex_devices", type=int, default=1,
                   help="dock this many complexes concurrently, one per "
                        "rank (DockingPipeline.dock_batch; 0 = every "
                        "visible card), grouped by size; per-complex "
                        "run_times are the group's wall over its size. "
                        "Mutually exclusive with --pose_devices.")
    p.add_argument("--max_retries", type=int, default=3,
                   help="dock retries with halved pose batches before a "
                        "complex is recorded as a penalty row")
    p.add_argument("--no_rec_overlap_names", default=None,
                   help="file listing complexes whose receptor is unseen in "
                        "the train set (one name per line); every metric is "
                        "additionally reported restricted to those with a "
                        "no_overlap_ prefix")
    p.add_argument("--restrict_cpu", action="store_true", default=False,
                   help="cap host BLAS/OMP pools and torch's threads at "
                        "--num_cpu")
    p.add_argument("--num_cpu", type=int, default=16,
                   help="thread cap applied by --restrict_cpu")
    p.add_argument("--dataset_statistics",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="print dataset geometry statistics after loading")
    p.add_argument("--device", default="cuda",
                   help="torch device to dock on ('cuda' or 'cpu')")
    return p


def restrict_cpu_threads(threads: int) -> None:
    """Cap the host's thread pools (reference ``evaluate.py:186-196``): the
    environment variables reach libraries loaded afterwards, and torch's
    own pool is capped directly."""
    import torch

    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
                "VECLIB_MAXIMUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(threads)
    torch.set_num_threads(threads)


def true_pocket_center(data, pocket_cutoff: float):
    """Ground-truth pocket center (reference ``utils/sampling.py:20-29``):
    the mean of the receptor residues within ``pocket_cutoff`` of any true
    ligand atom, or the closest residue when none is; in the complex's
    centered frame."""
    rec = np.asarray(data.rec_pos)[np.asarray(data.rec_mask, bool)]
    lig = np.asarray(data.lig_pos)[np.asarray(data.lig_mask, bool)]
    d = np.linalg.norm(rec[:, None] - lig[None], axis=-1)
    label = (d < pocket_cutoff).any(axis=1)
    if label.any():
        return rec[label].mean(axis=0)
    print(f"  no pocket residue below {pocket_cutoff} A, taking closest at "
          f"{d.min():.2f}")
    return rec[d.min(axis=1).argmin()]


def dock_with_retry(pipeline, data, num_poses, seed, max_retries=3,
                    batch_size=None, pocket_center=None, aa_data=None):
    """Dock with batch-halving recovery (reference ``evaluate.py:523-527``):
    on a failure, retry the same number of poses with half the poses in
    flight that actually ran (``pipeline.effective_pose_chunk``), until
    halving no longer shrinks the program (one pose, or one per rank of a
    pose mesh)."""
    chunk = batch_size
    for attempt in range(max_retries):
        try:
            return pipeline.dock_complex(
                data, num_poses=num_poses, seed=seed, aa_data=aa_data,
                batch_size=chunk, pocket_center=pocket_center,
            )
        except Exception as e:  # noqa: BLE001 — reference-style halving
            ran = pipeline.effective_pose_chunk(data, num_poses, chunk)
            chunk = max(1, ran // 2)
            if attempt == max_retries - 1 or pipeline.effective_pose_chunk(data, num_poses, chunk) >= ran:
                raise
            print(f"  retry with pose chunks of {chunk}: "
                  f"{type(e).__name__}: {e}")
    raise RuntimeError("unreachable")


def build_pipeline(args):
    """The DockingPipeline of parsed evaluate ``args``, through the dock
    CLI's ``load_pipeline``, with the pocket-knowledge options applied to
    its sampler."""
    from diffdock_tpu_torch.cli.dock import load_pipeline

    dock_args = argparse.Namespace(
        model_dir=args.model_dir,
        ckpt=args.ckpt,
        confidence_model_dir=args.confidence_model_dir,
        confidence_ckpt=args.confidence_ckpt,
        old_confidence_model=args.old_confidence_model,
        model_preset=args.model_preset,
        inference_steps=args.inference_steps,
        actual_steps=args.actual_steps,
        sigma_schedule=args.sigma_schedule,
        inf_sched_alpha=args.inf_sched_alpha,
        inf_sched_beta=args.inf_sched_beta,
        no_final_step_noise=args.no_final_step_noise,
        ode=args.ode, no_random=args.no_random,
        initial_noise_std_proportion=args.initial_noise_std_proportion,
        choose_residue=args.choose_residue,
        compute_dtype=args.compute_dtype,
        crop_beyond=args.crop_beyond,
        pocket_capacity=args.pocket_capacity,
        bucket_ladder=args.bucket_ladder,
        esm_embeddings_path=args.esm_embeddings_path,
        # one mesh serves either layout: poses within a complex
        # (--pose_devices) or one complex per rank (--complex_devices)
        pose_devices=devices_flag(args),
        device=args.device,
        **{
            f"{pre}_{c}": getattr(args, f"{pre}_{c}")
            for pre in ("temp_sampling", "temp_psi", "temp_sigma_data")
            for c in ("tr", "rot", "tor")
        },
    )
    pipeline = load_pipeline(dock_args)

    if args.pocket_knowledge or args.no_random_pocket:
        import dataclasses

        sc = pipeline.score_cfg.sigma
        t_max = 1.0
        if args.pocket_knowledge and args.different_schedules:
            # start translation diffusion at pocket_tr_max (reference
            # evaluate.py:317-321)
            t_max = (np.log(args.pocket_tr_max) - np.log(sc.tr_sigma_min)) / (
                np.log(sc.tr_sigma_max) - np.log(sc.tr_sigma_min)
            )
        pipeline.sampler_cfg = dataclasses.replace(
            pipeline.sampler_cfg,
            no_random_pocket=args.no_random_pocket,
            pocket_tr_max=(args.pocket_tr_max if args.pocket_knowledge else None),
            t_max=t_max,
        )
    return pipeline


def devices_flag(args) -> int:
    """The rank count the run asks for: ``--complex_devices`` when set,
    else ``--pose_devices``."""
    return args.complex_devices if args.complex_devices != 1 else args.pose_devices


def predock_groups(pipeline, entries, num_poses, seed, batch_size, pocket_of):
    """The complex-parallel pre-dock: ``entries`` ((name, data) pairs) by
    ascending bucket in groups of one complex per rank, each docked by
    ``pipeline.dock_batch``; {name: (result, the group's wall over its
    size)}. A group that fails is left out (its complexes fall back to
    the sequential docks)."""
    from diffdock_tpu_torch.data.complexes import AAComplexData, bucket_sizes

    def base(d):
        return d.base if isinstance(d, AAComplexData) else d

    entries = sorted(entries, key=lambda e: bucket_sizes(base(e[1]).n_lig, base(e[1]).n_rec,
                                                         base(e[1]).n_bonds))
    done = {}
    for s in range(0, len(entries), pipeline.mesh_size):
        grp = entries[s : s + pipeline.mesh_size]
        aa = [d if isinstance(d, AAComplexData) else None for _, d in grp]
        t0 = time.time()
        try:
            rs = pipeline.dock_batch([base(d) for _, d in grp], num_poses=num_poses, seed=seed,
                                     aa_datas=aa if any(a is not None for a in aa) else None,
                                     pocket_centers=[pocket_of(base(d)) for _, d in grp],
                                     batch_size=batch_size)
        except Exception as e:  # noqa: BLE001 — the group falls back to sequential docks
            print(f"batch dock failed ({type(e).__name__}: {e}); "
                  f"{len(grp)} complexes fall back to sequential")
            continue
        dt = (time.time() - t0) / len(grp)
        for (n, _), r in zip(grp, rs):
            done[n] = (r, dt)
    return done


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    args = get_parser().parse_args(argv)
    if args.restrict_cpu:
        restrict_cpu_threads(args.num_cpu)
    if args.complex_devices != 1 and args.pose_devices != 1:
        raise SystemExit(
            "--complex_devices and --pose_devices are mutually exclusive "
            "(both shard the same 1-axis mesh)"
        )
    from diffdock_tpu_torch.parallel import mesh as mesh_mod

    ranks = mesh_mod.ranks_for(devices_flag(args), args.device)
    if ranks > 1 and not mesh_mod.in_rank():
        return mesh_mod.launch(main, (argv,), ranks, args.device)

    from diffdock_tpu_torch.data.chem import read_molecule_file
    from diffdock_tpu_torch.data.complexes import AAComplexData
    from diffdock_tpu_torch.data.datasets import ComplexDataset, DatasetConfig, pdbbind_specs
    from diffdock_tpu_torch.eval.gnina import gnina_minimize_pose
    from diffdock_tpu_torch.eval.metrics import min_self_distances
    from diffdock_tpu_torch.eval.rmsd import molecular_automorphisms, symmetry_rmsd

    # fail fast on a bad names file: emit_metric_tables reads it only after
    # the sweep
    if args.no_rec_overlap_names and not os.path.isfile(args.no_rec_overlap_names):
        raise SystemExit(f"--no_rec_overlap_names file not found: {args.no_rec_overlap_names}")

    pipeline = build_pipeline(args)
    mesh = pipeline.mesh
    main_rank = mesh is None or mesh.is_main

    protein_stem = args.protein_file or (
        "protein" if args.dataset == "posebusters" else "protein_processed"
    )
    ligand_stem = args.ligand_file or "ligand"
    # the all-atom confidence model needs the receptor's atoms (the one
    # deviation from the JAX CLI, see the module docstring)
    all_atoms = pipeline.confidence_cfg is not None and pipeline.confidence_cfg.all_atoms
    timings = {"preprocess_s": 0.0, "dock_s": 0.0, "rmsd_s": 0.0, "tables_s": 0.0}

    t_pre = time.perf_counter()
    if args.dataset == "moad":
        from diffdock_tpu_torch.data.moad import MOADConfig, MOADDataset

        moad = MOADDataset(MOADConfig(
            moad_dir=args.data_dir, cache_dir=args.cache_path,
            split="test", limit_complexes=args.limit_complexes,
        ))
        with mesh_mod.main_first(mesh):
            moad.preprocess()
        eval_names = moad.names
        get_data = moad.get_by_name
        get_mol = lambda name: read_molecule_file(  # noqa: E731
            os.path.join(moad._ligand_dir(), name + ".pdb")
        ).remove_hs()
        # DockGen metric: the least RMSD over every same-formula ground truth
        get_refs = moad.alternative_ground_truths
        get_receptor_pdb = lambda name: moad._receptor_path(name[:6])  # noqa: E731
    else:
        specs = pdbbind_specs(
            args.data_dir, args.split,
            protein_suffix=f"_{protein_stem}.pdb",
            ligand_suffix=f"_{ligand_stem}.sdf",
            esm_embeddings_dir=args.esm_embeddings_path,
        )
        if args.limit_complexes:
            specs = specs[: args.limit_complexes]
        ds = ComplexDataset(specs, DatasetConfig(cache_dir=args.cache_path, all_atoms=all_atoms))
        with mesh_mod.main_first(mesh):
            ds.preprocess()
        if args.dataset_statistics and main_rank:
            ds.print_statistics()
        spec_by_name = {s.name: s for s in specs}
        eval_names = ds.names
        get_data = ds.get
        get_mol = lambda name: read_molecule_file(  # noqa: E731
            spec_by_name[name].ligand_path
        ).remove_hs()
        get_receptor_pdb = lambda name: spec_by_name[name].protein_path  # noqa: E731
        if args.dataset == "posebusters":
            # the least RMSD over every pose in {name}_ligands.sdf
            # (reference datasets/pdbbind.py:392-404)
            from diffdock_tpu_torch.data.chem import parse_sdf

            def get_refs(name):
                path = os.path.join(args.data_dir, name, f"{name}_ligands.sdf")
                if not os.path.exists(path):
                    return None
                with open(path) as f:
                    mols = parse_sdf(f.read())
                refs = [m.remove_hs().coords for m in mols]
                print(f"[{name}] {len(refs)} alternative poses")
                return refs or None
        else:
            get_refs = None
    timings["preprocess_s"] = time.perf_counter() - t_pre
    print(f"evaluating {len(eval_names)} complexes")

    P = args.samples_per_complex

    def pocket_of(data):
        return true_pocket_center(data, args.pocket_cutoff) if args.pocket_knowledge else None

    pre_docked, data_cache = {}, {}
    if args.complex_devices != 1 and pipeline.mesh_size > 1:
        # the complexes loaded here serve the loop below once each
        t_load = time.perf_counter()
        data_cache = {n: d for n, d in ((n, get_data(n)) for n in eval_names) if d is not None}
        timings["preprocess_s"] += time.perf_counter() - t_load
        pre_docked = predock_groups(pipeline, list(data_cache.items()), P, args.seed,
                                    args.batch_size, pocket_of)
    names, rmsd_rows, centroid_rows, run_times, clash_rows = [], [], [], [], []
    conf_rows, gnina_rmsd_rows, gnina_score_rows = [], [], []
    failures = 0
    for name in eval_names:
        t_load = time.perf_counter()
        data = data_cache.pop(name) if name in data_cache else get_data(name)
        timings["preprocess_s"] += time.perf_counter() - t_load
        if data is None:
            continue
        aa_data = data if isinstance(data, AAComplexData) else None
        if aa_data is not None:
            data = aa_data.base
        t0 = time.time()
        try:
            if name in pre_docked:
                result, amortized = pre_docked[name]
            else:
                result = dock_with_retry(
                    pipeline, data, P, args.seed,
                    max_retries=args.max_retries,
                    batch_size=args.batch_size, pocket_center=pocket_of(data),
                    aa_data=aa_data,
                )
                amortized = time.time() - t0
        except Exception as e:  # noqa: BLE001 — penalty row, keep counts
            timings["dock_s"] += time.time() - t0
            print(f"[{name}] failed: {type(e).__name__}: {e}")
            failures += 1
            names.append(name)
            rmsd_rows.append(np.full(P, 10000.0))
            centroid_rows.append(np.full(P, 10000.0))
            clash_rows.append(np.full(P, 10000.0))
            conf_rows.append(np.full(P, -10000.0))
            # NaN keeps run_times.npy index-aligned with names.npy (excluded
            # from the runtime metrics)
            run_times.append(float("nan"))
            if args.gnina_minimize:
                gnina_rmsd_rows.append(np.full(args.gnina_poses_to_optimize, 10000.0))
                gnina_score_rows.append(np.full(args.gnina_poses_to_optimize, -10000.0))
            continue
        timings["dock_s"] += amortized
        run_times.append(amortized)

        t_rmsd = time.perf_counter()
        mol = get_mol(name)
        bonds = [(i, j) for i, j, _ in mol.bonds]
        perms = molecular_automorphisms(mol.elements, bonds)
        ordered = result.poses[result.order]
        refs = get_refs(name) if get_refs is not None else None
        if refs is None:
            refs = [np.asarray(data.lig_pos) + np.asarray(data.original_center)]
        rmsds = np.min(
            [symmetry_rmsd(r, ordered, mol.elements, bonds, perms=perms) for r in refs],
            axis=0,
        )
        centroids = np.min(
            [np.linalg.norm(ordered.mean(axis=1) - r.mean(axis=0), axis=-1) for r in refs],
            axis=0,
        )
        if args.gnina_minimize:
            # rescoring (reference evaluate.py:434-472): minimize the
            # top-confidence poses with gnina and take their RMSDs again
            g_rmsds, g_scores = [], []
            for pose in ordered[: args.gnina_poses_to_optimize]:
                gpos, gmol, gscore = gnina_minimize_pose(
                    mol, pose, get_receptor_pdb(name),
                    binary=args.gnina_path,
                    full_dock=args.gnina_full_dock,
                    autobox_add=args.gnina_autobox_add,
                )
                gbonds = [(i, j) for i, j, _ in gmol.bonds]
                try:
                    gr = np.min([
                        symmetry_rmsd(r, gpos[None], gmol.elements, gbonds)[0]
                        for r in refs
                    ])
                except Exception:  # noqa: BLE001 — uncorrected fallback
                    gr = float(np.min([
                        np.sqrt(((gpos - r) ** 2).sum(-1).mean())
                        for r in refs if r.shape == gpos.shape
                    ] or [np.inf]))
                g_rmsds.append(gr)
                g_scores.append(gscore)
            gnina_rmsd_rows.append(np.asarray(g_rmsds))
            gnina_score_rows.append(np.asarray(g_scores))
        clash_rows.append([min_self_distances(p, bonds) for p in ordered])
        timings["rmsd_s"] += time.perf_counter() - t_rmsd
        names.append(name)
        rmsd_rows.append(rmsds)
        centroid_rows.append(centroids)
        conf = result.confidence if result.confidence is not None else np.zeros(P)
        conf_rows.append(np.asarray(conf)[result.order])
        print(f"[{name}] top-1 rmsd {rmsds[0]:.2f} A ({run_times[-1]:.1f}s)")

    print(f"{failures} failures due to exceptions")
    if not main_rank:  # rank 0 writes the artifacts
        return 0
    t_tables = time.perf_counter()
    table = emit_metric_tables(
        args.out_dir, names, rmsd_rows, centroid_rows, run_times,
        conf_rows, clash_rows, failures,
        no_rec_overlap_names=args.no_rec_overlap_names,
        gnina_rmsd_rows=gnina_rmsd_rows if args.gnina_minimize else None,
        gnina_score_rows=gnina_score_rows if args.gnina_minimize else None,
    )
    timings["tables_s"] = time.perf_counter() - t_tables
    print(json.dumps(table, indent=2))
    print(f"timings: {json.dumps(timings)}")
    return 0


def emit_metric_tables(out_dir, names, rmsd_rows, centroid_rows, run_times,
                       conf_rows, clash_rows, failures,
                       no_rec_overlap_names=None,
                       gnina_rmsd_rows=None, gnina_score_rows=None):
    """Write the per-complex arrays and ``metrics.json``; every metric is
    reported over all complexes and again, with a ``no_overlap_`` prefix,
    over the complexes named in ``no_rec_overlap_names`` (reference
    ``evaluate.py:555-640``)."""
    from diffdock_tpu_torch.eval.metrics import compute_metric_table, gnina_metric_table

    os.makedirs(out_dir, exist_ok=True)
    names_arr = np.asarray(names)
    all_rmsds = np.asarray(rmsd_rows)
    all_centroids = np.asarray(centroid_rows)
    all_run_times = np.asarray(run_times)
    all_conf = np.asarray(conf_rows)
    all_clash = np.asarray(clash_rows)

    selections = [("", np.ones(len(names_arr), dtype=bool))]
    if no_rec_overlap_names:
        with open(no_rec_overlap_names) as f:
            overlap_free = {ln.strip() for ln in f if ln.strip()}
        sel = np.asarray([n in overlap_free for n in names], dtype=bool)
        if sel.sum() == 0:
            print("no_rec_overlap: no evaluated complex in names file, skipping split")
        else:
            selections.append(("no_overlap_", sel))

    table = {}
    for prefix, sel in selections:
        rmsds = all_rmsds[sel]
        centroids = all_centroids[sel]
        rt = all_run_times[sel]
        np.save(os.path.join(out_dir, f"{prefix}rmsds.npy"), rmsds)
        np.save(os.path.join(out_dir, f"{prefix}centroid_distances.npy"), centroids)
        np.save(os.path.join(out_dir, f"{prefix}run_times.npy"), rt)
        np.save(os.path.join(out_dir, f"{prefix}names.npy"), names_arr[sel])
        np.save(os.path.join(out_dir, f"{prefix}confidences.npy"), all_conf[sel])
        np.save(os.path.join(out_dir, f"{prefix}min_self_distances.npy"), all_clash[sel])

        sub = compute_metric_table(rmsds, centroids, rt)
        if len(all_clash):
            # steric clash proxy (reference evaluate.py:486-505)
            sub["steric_clash_fraction"] = float((all_clash[sel][:, 0] < 0.4).mean() * 100)
        if gnina_rmsd_rows is not None and len(gnina_rmsd_rows):
            g_rmsds = np.asarray(gnina_rmsd_rows)[sel]
            g_scores = np.asarray(gnina_score_rows)[sel]
            np.save(os.path.join(out_dir, f"{prefix}gnina_rmsds.npy"), g_rmsds)
            np.save(os.path.join(out_dir, f"{prefix}gnina_scores.npy"), g_scores)
            sub.update(gnina_metric_table(g_rmsds, g_scores))
        table.update({prefix + k: v for k, v in sub.items()})
    table["failures"] = failures
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        json.dump(table, f, indent=2)
    return table


if __name__ == "__main__":
    raise SystemExit(main())
