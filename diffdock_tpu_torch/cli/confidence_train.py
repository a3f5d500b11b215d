"""Confidence-model training CLI of the port (port of
``diffdock_tpu/cli/confidence_train.py``; the reference's
``confidence/confidence_train.py``).

Example::

    python -m diffdock_tpu_torch.cli.confidence_train --data_dir data/PDBBind_processed \\
        --split_train train_names.txt --score_model_dir runs/score \\
        --log_dir runs/confidence --pose_cache runs/confidence_poses --all_atoms

Two phases:

1. pose generation: the score model (``--score_model_dir``, or random
   weights at ``--ns/--nv/--num_conv_layers/--num_prot_emb_layers`` with
   the JAX CLI's warning) docks every training complex through the port's
   ``DockingPipeline``, ``--samples_per_complex`` poses from seed
   ``seed + i + 7919 * cache_id``, labelled with their (symmetry) RMSD to
   the crystal pose and cached per complex as the JAX CLI's
   ``{name}[.id{N}].npz`` (``--cache_id``); ``--cache_ids_to_combine``
   skips generation and trains on the union of those caches;
2. training of the confidence model (the coarse-grained model in
   confidence mode, or ``AAScoreModel`` with ``--all_atoms``, both of the
   new architecture, as the JAX CLI builds them): BCE for one
   ``--rmsd_classification_cutoff``, CE over the bins for several, MSE
   with ``--rmsd_prediction``; each epoch a ``numpy`` permutation from
   ``--seed`` orders the complexes and draws one cached pose per complex,
   each step's dropout masks come from a generator seeded with
   ``epoch * 1000 + start``, and ``metrics.jsonl`` and ``last_model.msgpack``
   (with ``model_parameters.yml``) are written, which the port's dock and
   evaluate CLIs and the JAX package read.

Every complex is padded to one shared bucket with normalized bonded,
receptor-kNN (and, all-atom, atom-kNN and atoms-per-residue) widths, as
the JAX CLI pads them. The flags and defaults are the JAX CLI's, plus
``--device`` (default ``cuda``).

``--pose_devices N`` shards the generation docks' poses over N ranks and
``--data_parallel N`` the training batches (0: every visible card; the
batch is rounded up to a multiple of N by wrapping its indices, as in the
JAX CLI, and each rank's dropout masks come from the step's seed folded
with its rank). The CLI starts the ranks as the dock CLI does, or joins a
``torchrun`` group. The port runs one group for both phases, so two counts
above 1 must be equal; a phase asked to run on one rank runs on rank 0
(the generated poses are then sent to the other ranks, and a group that
only generates ends after it). Rank 0 alone writes the caches, the run
directory and ``metrics.jsonl``.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description="diffdock_tpu_torch confidence-model training")
    p.add_argument("--data_dir", default=None)
    p.add_argument("--split_train", default=None)
    p.add_argument("--score_model_dir", default=None)
    p.add_argument("--log_dir", default="workdir/confidence_model")
    p.add_argument("--cache_path", default="data/cache_tpu")
    p.add_argument("--pose_cache", default="data/confidence_poses")
    p.add_argument("--samples_per_complex", type=int, default=8)
    p.add_argument("--cache_id", type=int, default=None,
                   help="tag generated pose files as {name}.id{N}.npz so several partial "
                        "generation runs can accumulate (reference cache_creation_id)")
    p.add_argument("--cache_ids_to_combine", type=int, nargs="+", default=None,
                   help="skip generation; train on the union of the given cache ids' pose "
                        "files, poses concatenated per complex")
    p.add_argument("--inference_steps", type=int, default=8)
    p.add_argument("--rmsd_classification_cutoff", type=float, nargs="+", default=[2.0],
                   help="one cutoff -> BCE; several -> CE over RMSD bins")
    p.add_argument("--rmsd_prediction", action="store_true", default=False,
                   help="regress RMSD instead of classifying")
    p.add_argument("--n_epochs", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--all_atoms", action="store_true", default=False)
    p.add_argument("--ns", type=int, default=16)
    p.add_argument("--nv", type=int, default=4)
    p.add_argument("--num_conv_layers", type=int, default=2)
    p.add_argument("--num_prot_emb_layers", type=int, default=0)
    p.add_argument("--limit_complexes", type=int, default=0)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", type=int, default=1,
                   help="ranks to shard the training batches over, one per card "
                        "(0 = every visible card)")
    p.add_argument("--pose_devices", type=int, default=1,
                   help="ranks to shard the generation docks' poses over, one per card "
                        "(0 = every visible card)")
    p.add_argument("--device", default="cuda", help="torch device to train on ('cuda' or 'cpu')")
    return p


def phase_ranks(args):
    """(ranks of the generation docks, ranks of training): each flag's
    count (0: every visible card; inside a ``torchrun`` group, its size).
    ``ConfigError`` when both exceed 1 and differ: the port runs one
    process group for both phases."""
    from diffdock_tpu_torch.models.config import ConfigError
    from diffdock_tpu_torch.parallel.mesh import ranks_for

    pose, dp = (ranks_for(args.pose_devices, args.device, allow_one=True),
                ranks_for(args.data_parallel, args.device, allow_one=True))
    if pose > 1 and dp > 1 and pose != dp:
        raise ConfigError(f"--pose_devices {args.pose_devices} gives {pose} ranks and --data_parallel "
                          f"{args.data_parallel} {dp}: the two phases share one process group")
    if max(pose, dp) == 1:
        ranks_for(1, args.device)  # refused inside a larger group
    return pose, dp


def load_complexes(args):
    """({name: padded numpy complex}, {name: (elements, bonds) or None}):
    ``--synthetic`` complexes padded as the JAX CLI pads them, or the
    PDBBind layout padded to one shared bucket with normalized widths."""
    from diffdock_tpu_torch.data.complexes import (
        AAComplexData,
        atom_bucket,
        bucket_sizes,
        pad_aa_to,
        pad_to,
        synthetic_aa_complex,
        synthetic_complex,
    )

    if args.synthetic:
        rng = np.random.RandomState(args.seed)
        if args.all_atoms:
            datas = {str(i): pad_aa_to(synthetic_aa_complex(rng, n_lig=12, n_rec=32, n_bonds=3),
                                       16, 64, 8, 256)
                     for i in range(args.synthetic)}
        else:
            datas = {str(i): pad_to(synthetic_complex(rng, n_lig=12, n_rec=32, n_bonds=3), 16, 64, 8)
                     for i in range(args.synthetic)}
        return datas, {n: None for n in datas}

    from diffdock_tpu_torch.data.chem import read_molecule_file
    from diffdock_tpu_torch.data.datasets import ComplexDataset, DatasetConfig, pdbbind_specs

    specs = pdbbind_specs(args.data_dir, args.split_train)
    if args.limit_complexes:
        specs = specs[: args.limit_complexes]
    ds = ComplexDataset(specs, DatasetConfig(cache_dir=args.cache_path, all_atoms=args.all_atoms))
    ds.preprocess()
    datas = {n: ds.get(n) for n in ds.names}
    if datas:
        bases = {n: (d.base if isinstance(d, AAComplexData) else d) for n, d in datas.items()}
        buckets = [bucket_sizes(b.n_lig, b.n_rec, b.n_bonds) for b in bases.values()]
        nl, nr, nb = (max(b[i] for b in buckets) for i in range(3))
        # one width per data-dependent column count, so the batches stack
        kb = max(4, *(b.lig_bond_nbr.shape[1] for b in bases.values()))
        kr = max(b.rec_nbr.shape[1] for b in bases.values())
        if args.all_atoms:
            na = max(atom_bucket(d.n_atoms) for d in datas.values())
            ka = max(np.asarray(d.atom_nbr).shape[1] for d in datas.values())
            ar = max(np.asarray(d.res_atom_idx).shape[1] for d in datas.values())
            datas = {n: pad_aa_to(d, nl, nr, nb, na, kb=kb, kr=kr, ka=ka, ar=ar) for n, d in datas.items()}
        else:
            datas = {n: pad_to(d, nl, nr, nb, kb=kb, kr=kr) for n, d in datas.items()}
    topo = {}
    for s in specs:
        if s.name in datas:
            mol = read_molecule_file(s.ligand_path).remove_hs()
            topo[s.name] = (mol.elements, [(i, j) for i, j, _ in mol.bonds])
    return datas, topo


def score_pipeline(args, mesh=None):
    """The pose generator: the score model of ``--score_model_dir``, or
    random weights at the CLI's widths (the JAX CLI's warning); ``mesh``
    shards its poses."""
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.models.config import ScoreModelConfig
    from diffdock_tpu_torch.train.checkpoints import load_checkpoint
    from diffdock_tpu_torch.utils.convert import state_dict_from_flax

    if args.score_model_dir:
        params, score_cfg, _ = load_checkpoint(args.score_model_dir)
        weights = state_dict_from_flax(params, score_cfg)
    else:
        print("WARNING: random score-model weights (pose labels still valid)")
        score_cfg = ScoreModelConfig(ns=args.ns, nv=args.nv, num_conv_layers=args.num_conv_layers,
                                     num_prot_emb_layers=args.num_prot_emb_layers)
        weights = 0
    return DockingPipeline(
        score_cfg, weights,
        SamplerConfig(inference_steps=args.inference_steps, actual_steps=args.inference_steps),
        device=args.device, mesh=mesh,
    )


def generate_poses(args, datas, topo, pipeline_factory=score_pipeline, mesh=None):
    """Phase 1: {name: (poses, rmsds)} from the pose caches, generating (and
    caching) what ``--cache_id`` lacks; ``--cache_ids_to_combine`` reads
    only. The pipeline is built only when something is generated. On a
    pose mesh (``mesh``) every rank takes part in each dock, and rank 0
    writes the caches."""
    from diffdock_tpu_torch.data.complexes import AAComplexData
    from diffdock_tpu_torch.train.confidence import (
        generate_poses_for_complex,
        load_pose_cache,
        pose_cache_file,
    )

    pose_cache = Path(args.pose_cache)
    main_rank = mesh is None or mesh.is_main
    if main_rank:
        pose_cache.mkdir(parents=True, exist_ok=True)
    samples, pipeline = {}, None
    for i, (name, data) in enumerate(datas.items()):
        if args.cache_ids_to_combine is not None:
            got = load_pose_cache(pose_cache, name, args.cache_ids_to_combine)
            if got is None:
                raise FileNotFoundError(
                    f"no pose cache for '{name}' under any of cache ids "
                    f"{args.cache_ids_to_combine} in {pose_cache}")
            samples[name] = got
            continue
        got = load_pose_cache(pose_cache, name, None if args.cache_id is None else [args.cache_id])
        if got is not None:
            samples[name] = got
            continue
        if pipeline is None:
            pipeline = pipeline_factory(args) if mesh is None else pipeline_factory(args, mesh)
        el_bonds = topo.get(name)
        gen_data = data.base if isinstance(data, AAComplexData) else data
        # cache_id folds into the seed so each accumulation run generates new poses
        poses, rmsds = generate_poses_for_complex(
            pipeline, gen_data, args.samples_per_complex,
            seed=args.seed + i + 7919 * (args.cache_id or 0),
            elements=None if el_bonds is None else el_bonds[0],
            bonds=None if el_bonds is None else el_bonds[1],
        )
        if main_rank:
            np.savez_compressed(pose_cache_file(pose_cache, name, args.cache_id), poses=poses, rmsds=rmsds)
        samples[name] = (poses, rmsds)
        if main_rank:
            print(f"[{name}] generated {len(rmsds)} poses, min rmsd {rmsds.min():.2f}")
    return samples


def confidence_config(args, num_outputs: int, data_parallel: bool = False):
    """The confidence model's config as the JAX CLI builds and records it
    (``data_parallel``: batch statistics over the ranks too)."""
    from diffdock_tpu_torch.models.config import ScoreModelConfig
    from diffdock_tpu_torch.train.trainer import training_model_config

    return training_model_config(ScoreModelConfig(
        ns=args.ns, nv=args.nv, num_conv_layers=args.num_conv_layers,
        num_prot_emb_layers=args.num_prot_emb_layers, confidence_mode=True,
        all_atoms=args.all_atoms, num_confidence_outputs=num_outputs,
    ), data_parallel=data_parallel)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = get_parser().parse_args(argv)
    import torch

    from diffdock_tpu_torch.parallel import mesh as mesh_mod

    pose_ranks, dp_ranks = phase_ranks(args)
    world = max(pose_ranks, dp_ranks)
    if world > 1 and not mesh_mod.in_rank():
        return mesh_mod.launch(main, (argv,), world, args.device)
    mesh = mesh_mod.make_mesh(device=args.device) if world > 1 else None
    main_rank = mesh is None or mesh.is_main

    from diffdock_tpu_torch.data.complexes import AAComplexData, to_device
    from diffdock_tpu_torch.data.loaders import stack_padded
    from diffdock_tpu_torch.geometry import use_full_fp32
    from diffdock_tpu_torch.models.factory import build_model
    from diffdock_tpu_torch.train.checkpoints import save_checkpoint
    from diffdock_tpu_torch.train.confidence import (
        ConfidenceTrainConfig,
        create_confidence_train_state,
        make_confidence_train_step,
    )
    from diffdock_tpu_torch.utils.convert import flax_from_model
    from diffdock_tpu_torch.utils.logging import MetricsWriter

    use_full_fp32()
    dev = mesh.device if mesh is not None else torch.device(args.device)
    with mesh_mod.main_first(mesh):  # rank 0 writes the dataset cache
        datas, topo = load_complexes(args)
    if not datas:
        print("no training complexes", file=sys.stderr)
        return 1
    if mesh is None:
        samples = generate_poses(args, datas, topo)
    elif pose_ranks > 1:
        samples = generate_poses(args, datas, topo, mesh=mesh)
    else:
        # generation on one rank: rank 0's poses for every rank
        samples = mesh.broadcast(generate_poses(args, datas, topo) if main_rank else None)
    if dp_ranks == 1 and not main_rank:
        return 0  # a group that only generated: rank 0 trains alone
    train_mesh = mesh if dp_ranks > 1 else None

    # --- phase 2: train the confidence model ---
    tcfg = ConfidenceTrainConfig(
        rmsd_classification_cutoff=tuple(args.rmsd_classification_cutoff),
        rmsd_prediction=args.rmsd_prediction,
        samples_per_complex=args.samples_per_complex, lr=args.lr,
    )
    conf_cfg = confidence_config(args, tcfg.num_outputs, data_parallel=dp_ranks > 1)
    model = build_model(conf_cfg)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    model.to(dev)
    state = create_confidence_train_state(model, tcfg)
    train_step = make_confidence_train_step(model, tcfg, mesh=train_mesh)
    if train_mesh is not None:
        train_step = mesh_mod.shard_confidence_train_step(train_step, train_mesh)
    # a sharded batch's leading axis is a multiple of the ranks: the last
    # partial batch wraps its indices (duplicates are harmless), as in the
    # JAX CLI
    step_bs = -(-args.batch_size // dp_ranks) * dp_ranks

    def center_of(d):
        return np.asarray((d.base if isinstance(d, AAComplexData) else d).original_center)

    names = list(datas)
    rng_np = np.random.RandomState(args.seed)
    if main_rank:
        os.makedirs(args.log_dir, exist_ok=True)
        metrics_log = MetricsWriter(os.path.join(args.log_dir, "metrics.jsonl"))
    kind = "mse" if tcfg.rmsd_prediction else ("bce" if tcfg.num_outputs == 1 else "ce")
    try:
        for epoch in range(args.n_epochs):
            order = rng_np.permutation(len(names))
            losses, accs = [], []
            for start in range(0, len(order), step_bs):
                idx = order[start : start + step_bs]
                if len(idx) % dp_ranks:
                    idx = np.resize(idx, step_bs)
                batch_names = [names[j] for j in idx]
                batch = to_device(stack_padded([datas[n] for n in batch_names]), dev)
                pose_sel = [rng_np.randint(samples[n][0].shape[0]) for n in batch_names]
                poses = np.stack([samples[n][0][k] - center_of(datas[n])
                                  for n, k in zip(batch_names, pose_sel)]).astype(np.float32)
                labels = tcfg.labels_from_rmsds([samples[n][1][k] for n, k in zip(batch_names, pose_sel)])
                seed = epoch * 1000 + start
                gen = torch.Generator(device=dev).manual_seed(
                    seed if train_mesh is None else mesh_mod.fold_seed(seed, train_mesh.rank))
                state, m = train_step(state, batch, torch.as_tensor(poses, device=dev),
                                      torch.as_tensor(labels, device=dev), gen)
                losses.append(float(m["loss"]))
                accs.append(float(m["accuracy"]))
            print(f"epoch {epoch}: {kind} {np.mean(losses):.4f} acc {np.mean(accs):.3f}")
            if main_rank:
                metrics_log.log(epoch, "train", loss=float(np.mean(losses)),
                                accuracy=float(np.mean(accs)), kind=kind)
                save_checkpoint(args.log_dir, flax_from_model(model), conf_cfg, extra={"epoch": epoch},
                                weights_name="last_model.msgpack")
    finally:
        if main_rank:
            metrics_log.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
