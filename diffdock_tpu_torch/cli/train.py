"""Score-model training CLI of the port (port of ``diffdock_tpu/cli/train.py``;
the reference's ``train.py``).

Example::

    python -m diffdock_tpu_torch.cli.train --model_preset diffdock_l \
        --data_dir data/PDBBind_processed --split_train train_names.txt \
        --split_val val_names.txt --esm_embeddings_dir esm/ \
        --log_dir runs/score --batch_size 16 --n_epochs 400

An epoch loop over bucketed batches (``ComplexDataset.bucketed_batches``;
with ``--dataset moad|pdbsidechain``, ``--combined_training`` or
``--triple_training`` the stream of ``data/loaders.py:build_train_source``
through ``iter_bucketed_batches``; or ``--synthetic N`` random complexes)
with the train step of
``train/trainer.py``, the validation loss, optional validation docking,
the plateau and layer-warmup schedulers, and the JAX CLI's run directory
under ``--log_dir``: ``model_parameters.yml``, ``train_state.msgpack``,
``last_model``, ``last_ema_model``, ``best_ema_model``, ``best_model``, the
two ``*_inference_epoch_model`` flavours and the secondary one (all
``.msgpack``), ``metrics.jsonl`` and ``history.json``. The port's dock and
the JAX package load what it writes, and ``--restart_dir`` resumes a JAX
run here (and the reverse).

The flags and defaults are the JAX CLI's, plus ``--device`` (default
``cuda``). One seeded ``torch.Generator`` on the device draws the noise and
the dropout masks. The data sources follow the JAX CLI: ``--triple_training``
implies ``--combined_training``; MOAD reads ``--moad_dir`` (``--chain_cutoff``,
``--unroll_clusters``), PDBSidechain ``--pdbsidechain_dir``
(``--remove_second_segment``); there the epoch's items come from
``source.epoch_items(epoch)``, no validation-loss set is read (the JAX CLI
reads ``--split_val`` only for PDBBind alone) and validation docking docks
the first items of ``source.epoch_items(10_000 + epoch)``. The JAX CLI
initializes its flax model from an example batch; the port's model needs
none. A ``--backbone_loss_weight`` or ``--sidechain_loss_weight`` above 0
builds the model with the sidechain head (``sidechain_pred``), as the JAX
CLI does, and the train step adds the weighted auxiliary losses.

``--data_parallel`` trains on every visible card, one rank each
(``parallel/mesh.py``; ``--device cpu``: ``DIFFDOCK_TPU_CPU_DEVICES`` CPU
ranks), or on the ranks of the group that ``torchrun`` describes: every
rank builds the same batches, takes its shard (``shard_train_step``) with
noise and dropout from its own generator (the run's seed folded with the
rank), the batch norms aggregate over the ranks (the run directory records
``bn_axis_names`` ``("batch", "dp")``, as the JAX CLI's does), and the
gradients and metrics are averaged before the update. A batch that does
not split evenly over the ranks is skipped, as the JAX CLI's failing
sharded step skips it; the validation loss is rank 0's, and rank 0 alone
docks for validation and writes the run directory.

Deviations from the JAX CLI: the validation set is featurized with the
ESM embeddings of ``--esm_embeddings_dir`` (the JAX CLI reads it without
them, so a DiffDock-L model with LM features cannot take its validation
batches), validation docking docks the validation set when there is one
(the JAX CLI docks the first training complexes), and a failed step
raises unless it ran out of device memory (the JAX CLI skips any failed
batch; here a kernel that fails to build or launch must stop the run), and
under ``--data_parallel`` an out-of-memory step stops the run too (the
other ranks would wait for it).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description="diffdock_tpu_torch training")
    p.add_argument("--config", default=None)
    p.add_argument("--log_dir", default="workdir/score_model")
    p.add_argument("--data_dir", default=None,
                   help="PDBBind-layout root (name/name_protein_processed.pdb)")
    p.add_argument("--split_train", default=None)
    p.add_argument("--split_val", default=None)
    p.add_argument("--esm_embeddings_dir", default=None)
    p.add_argument("--cache_path", default="data/cache_tpu")
    p.add_argument("--n_epochs", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--w_decay", type=float, default=0.0)
    p.add_argument("--ema_rate", type=float, default=0.999)
    p.add_argument("--tr_weight", type=float, default=0.33)
    p.add_argument("--rot_weight", type=float, default=0.33)
    p.add_argument("--tor_weight", type=float, default=0.33)
    p.add_argument("--backbone_loss_weight", type=float, default=0.0)
    p.add_argument("--sidechain_loss_weight", type=float, default=0.0)
    p.add_argument("--num_workers", type=int, default=1)
    p.add_argument("--limit_complexes", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", action="store_true", default=False)
    p.add_argument("--model_preset", default="diffdock_s")
    p.add_argument("--ns", type=int, default=None)
    p.add_argument("--nv", type=int, default=None)
    p.add_argument("--num_conv_layers", type=int, default=None)
    p.add_argument("--num_prot_emb_layers", type=int, default=None)
    p.add_argument("--restart_dir", default=None,
                   help="resume full train state (params+EMA+optimizer+step)")
    p.add_argument("--pretrain_dir", default=None,
                   help="initialize weights only (reference --pretrain_dir)")
    p.add_argument("--val_inference_freq", type=int, default=0,
                   help="every N epochs run reverse diffusion on val complexes")
    p.add_argument("--num_inference_complexes", type=int, default=20)
    p.add_argument("--inference_samples", type=int, default=4)
    p.add_argument("--inference_steps", type=int, default=8)
    p.add_argument("--scheduler", default=None, choices=[None, "plateau", "layer_linear_warmup"])
    p.add_argument("--scheduler_patience", type=int, default=20)
    p.add_argument("--warmup_dur", type=int, default=4)
    p.add_argument("--lr_start_factor", type=float, default=0.001)
    p.add_argument("--inference_secondary_metric", default=None,
                   help="extra valinf metric tracked by its own checkpoint flavor")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic complexes (smoke/benchmark)")
    p.add_argument("--dataset", default="pdbbind", choices=["pdbbind", "moad", "pdbsidechain"])
    p.add_argument("--combined_training", action="store_true", default=False)
    p.add_argument("--triple_training", action="store_true", default=False)
    p.add_argument("--moad_dir", default=None)
    p.add_argument("--pdbsidechain_dir", default=None)
    p.add_argument("--chain_cutoff", type=float, default=None)
    p.add_argument("--unroll_clusters", action="store_true", default=False)
    p.add_argument("--remove_second_segment", action="store_true", default=False)
    p.add_argument("--device", default="cuda", help="torch device to train on ('cuda' or 'cpu')")
    return p


def build_dataset(args, split, esm_dir, mesh=None):
    from diffdock_tpu_torch.data.datasets import ComplexDataset, DatasetConfig, pdbbind_specs

    specs = pdbbind_specs(args.data_dir, split, esm_embeddings_dir=esm_dir)
    if args.limit_complexes:
        specs = specs[: args.limit_complexes]
    ds = ComplexDataset(specs, DatasetConfig(cache_dir=args.cache_path))
    from diffdock_tpu_torch.parallel.mesh import main_first

    with main_first(mesh):  # rank 0 writes the cache, the others read it
        ds.preprocess(num_workers=args.num_workers)
    return ds


def _synthetic_batches(args, lm_dim: int):
    from diffdock_tpu_torch.data.complexes import pad_to, synthetic_complex
    from diffdock_tpu_torch.data.loaders import stack_batch

    rng = np.random.RandomState(args.seed)
    datas = [pad_to(synthetic_complex(rng, n_lig=16, n_rec=64, n_bonds=4, lm_dim=lm_dim), 16, 64, 8)
             for _ in range(args.synthetic)]

    def batches(epoch):
        order = np.random.RandomState(epoch).permutation(len(datas))
        for i in range(0, len(order), args.batch_size):
            yield stack_batch([(str(j), datas[j]) for j in order[i : i + args.batch_size]], (16, 64, 8))

    return datas, batches


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = get_parser().parse_args(argv)
    if args.config:
        from diffdock_tpu_torch.utils import simple_yaml

        with open(args.config) as f:
            for k, v in (simple_yaml.load(f.read()) or {}).items():
                if hasattr(args, k):
                    setattr(args, k, v)

    import torch

    from diffdock_tpu_torch.parallel import mesh as mesh_mod

    # --data_parallel: every visible card (0), or the torchrun group
    ranks = mesh_mod.ranks_for(0 if args.data_parallel else 1, args.device)
    if ranks > 1 and not mesh_mod.in_rank():
        return mesh_mod.launch(main, (argv,), ranks, args.device)
    mesh = mesh_mod.make_mesh(device=args.device) if ranks > 1 else None
    main_rank = mesh is None or mesh.is_main

    from diffdock_tpu_torch.data.complexes import to_device
    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables
    from diffdock_tpu_torch.geometry import use_full_fp32
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.models.score_model import CGScoreModel
    from diffdock_tpu_torch.train.checkpoints import (
        load_checkpoint, load_train_state, save_checkpoint, save_train_state,
    )
    from diffdock_tpu_torch.train.noise import draw_noise
    from diffdock_tpu_torch.train.trainer import (
        TrainConfig, create_train_state, make_eval_step, make_optimizer, make_train_step,
        training_model_config,
    )
    from diffdock_tpu_torch.train.validation import PlateauScheduler, inference_epoch
    from diffdock_tpu_torch.utils.convert import flax_from_model, state_dict_from_flax
    from diffdock_tpu_torch.utils.logging import MetricsWriter

    cfg = PRESETS[args.model_preset]
    overrides = {k: getattr(args, k) for k in ("ns", "nv", "num_conv_layers", "num_prot_emb_layers")
                 if getattr(args, k) is not None}
    if args.backbone_loss_weight > 0 or args.sidechain_loss_weight > 0:
        # the reference enables the head whenever either weight is nonzero
        # (utils/utils.py:274-275)
        overrides["sidechain_pred"] = True
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg = training_model_config(cfg, data_parallel=args.data_parallel)
    tc = TrainConfig(lr=args.lr, w_decay=args.w_decay, ema_rate=args.ema_rate,
                     tr_weight=args.tr_weight, rot_weight=args.rot_weight,
                     tor_weight=args.tor_weight, backbone_weight=args.backbone_loss_weight,
                     sidechain_weight=args.sidechain_loss_weight)

    dev = torch.device(args.device)
    use_full_fp32()
    so3 = get_so3_tables(device=dev)
    torus = get_torus_tables(device=dev)
    model = CGScoreModel(cfg)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    model.to(dev)
    # one generator on the device for the noise and the dropout masks; a
    # rank's own stream of the seed on a mesh
    gen = torch.Generator(device=dev).manual_seed(
        args.seed + 1 if mesh is None else mesh_mod.fold_seed(args.seed + 1, mesh.rank))
    model.set_generator(gen)

    val_ds = None
    if args.synthetic:
        datas, batches = _synthetic_batches(args, cfg.lm_embedding_dim)
        val_items = lambda n, epoch: [(str(i), datas[i]) for i in range(min(n, len(datas)))]  # noqa: E731
    elif args.dataset != "pdbbind" or args.combined_training or args.triple_training:
        from diffdock_tpu_torch.data.loaders import build_train_source, iter_bucketed_batches

        if args.triple_training:
            args.combined_training = True
        source = build_train_source(args)
        print(f"dataset({args.dataset}{'+combined' if args.combined_training else ''}): "
              f"{len(source)} complexes/epoch")

        def batches(epoch):
            yield from iter_bucketed_batches(source.epoch_items(epoch), args.batch_size)

        def val_items(n, epoch):
            return list(itertools.islice(source.epoch_items(10_000 + epoch), n))
    else:
        if not args.data_dir:
            raise ValueError("need --data_dir or --synthetic")
        ds = build_dataset(args, args.split_train, args.esm_embeddings_dir, mesh)
        print(f"dataset: {len(ds)} complexes ready")

        def batches(epoch):
            yield from ds.bucketed_batches(args.batch_size, shuffle_seed=epoch)

        if args.split_val:
            val_ds = build_dataset(args, args.split_val, args.esm_embeddings_dir, mesh)
            print(f"val dataset: {len(val_ds)} complexes ready")
        inf_ds = val_ds if val_ds is not None and len(val_ds) else ds
        val_items = lambda n, epoch: [(nm, inf_ds.get(nm)) for nm in inf_ds.names[:n]]  # noqa: E731

    state = create_train_state(model, tc)

    def load_weights(run_dir):
        variables, _, _ = load_checkpoint(run_dir)
        sd = state_dict_from_flax(variables, cfg)
        model.load_state_dict({**model.state_dict(), **sd}, strict=True)
        with torch.no_grad():
            for k, e in state.ema_params.items():
                e.copy_(state.params[k])

    if args.restart_dir:
        try:
            load_train_state(args.restart_dir, model, state)
            print(f"restarted from {args.restart_dir} at step {state.step}")
        except (OSError, ValueError, KeyError) as e:
            # the reference falls back to the weights when the full state
            # fails (train.py:187-200)
            print(f"full train state unavailable ({e}); falling back to weights-only restart")
            load_weights(args.restart_dir)
    elif args.pretrain_dir:
        load_weights(args.pretrain_dir)
        print(f"pretrained weights loaded from {args.pretrain_dir}")

    step = make_train_step(model, tc, so3, torus, mesh=mesh)
    if mesh is not None:
        step = mesh_mod.shard_train_step(step, mesh)
    eval_step = make_eval_step(model, tc, so3, torus)

    if main_rank:
        os.makedirs(args.log_dir, exist_ok=True)
        metrics_log = MetricsWriter(os.path.join(args.log_dir, "metrics.jsonl"))
    best_loss, best_inf_metric, best_secondary = float("inf"), -1.0, -1.0
    history = []
    plateau = (PlateauScheduler(patience=args.scheduler_patience)
               if args.scheduler in ("plateau", "layer_linear_warmup") else None)
    layer_warmup = None
    if args.scheduler == "layer_linear_warmup":
        from diffdock_tpu_torch.train.schedulers import LayerWarmupScheduler, layer_warmup_mask

        layer_warmup = LayerWarmupScheduler(num_conv_layers=cfg.num_conv_layers,
                                            warmup_dur=args.warmup_dur,
                                            lr_start_factor=args.lr_start_factor)
        print(f"layer_linear_warmup: frozen stages until epoch {layer_warmup.total_warmup_epochs}")

    def save(name, params, extra):
        if not main_rank:
            return
        tree = flax_from_model(model, params=params)
        save_checkpoint(args.log_dir, tree, cfg, extra=extra, weights_name=name)

    def fresh_opt_state():
        return make_optimizer(tc).init({k: p.detach() for k, p in state.params.items()})

    for epoch in range(args.n_epochs):
        t0 = time.time()
        if layer_warmup is not None:
            stage, scale, changed = layer_warmup.epoch_update(epoch)
            if changed:
                # a stage transition recreates the optimizer (reference
                # utils/utils.py:152-153)
                state.param_mask = layer_warmup_mask(state.params, stage, cfg.num_conv_layers)
                state.opt_state = fresh_opt_state()
                print(f"  warmup stage {stage}")
            if epoch == layer_warmup.total_warmup_epochs:
                # warmup -> plateau handoff: the optimizer again at full lr,
                # the EMA re-initialized (reference train.py:51-53)
                state.opt_state = fresh_opt_state()
                with torch.no_grad():
                    for k, e in state.ema_params.items():
                        e.copy_(state.params[k])
                print("  warmup complete: lr restored, EMA re-initialized")
            if epoch <= layer_warmup.total_warmup_epochs:
                state.lr_scale = scale

        losses = []
        for names, batch in batches(epoch):
            n_batch = batch.lig_cat.shape[0]
            if mesh is not None and n_batch % mesh.size:
                # the JAX CLI's sharded step fails on it and skips it
                print(f"  batch {names[:2]}... of {n_batch} does not split over {mesh.size} ranks: skipped")
                continue
            batch = to_device(batch, dev)
            draws = draw_noise(gen, n_batch // (mesh.size if mesh else 1), batch.rot_u.shape[1], dev)
            if mesh is not None:
                state, metrics = step(state, batch, draws)
                losses.append(float(metrics["loss"]))
                continue
            try:
                state, metrics = step(state, batch, draws)
            except torch.cuda.OutOfMemoryError as e:
                # the reference's OOM recovery (utils/training.py:187-205)
                print(f"  batch {names[:2]}... out of memory: {e}")
                torch.cuda.empty_cache()
                continue
            losses.append(float(metrics["loss"]))
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        history.append(mean_loss)
        print(f"epoch {epoch}: loss {mean_loss:.4f} ({len(losses)} steps, {time.time() - t0:.1f}s)")
        if main_rank:
            metrics_log.log(epoch, "train", loss=mean_loss, steps=len(losses),
                            wall_s=time.time() - t0, lr_scale=state.lr_scale)

        # held-out validation loss (reference test_epoch + best-by-val-loss)
        if val_ds is not None and len(val_ds):
            vgen = torch.Generator(device=dev).manual_seed(args.seed + 100 + epoch)
            val_losses = []
            for _, vbatch in val_ds.bucketed_batches(args.batch_size):
                vbatch = to_device(vbatch, dev)
                vdraws = draw_noise(vgen, vbatch.lig_cat.shape[0], vbatch.rot_u.shape[1], dev)
                val_losses.append(float(eval_step(state, vbatch, vdraws)["loss"]))
            if val_losses:
                mean_loss = float(np.mean(val_losses))
                if mesh is not None:
                    # rank 0's, so that every rank's scheduler takes the
                    # same decisions
                    mean_loss = mesh.broadcast(mean_loss)
                print(f"  val loss {mean_loss:.4f} ({len(val_losses)} batches)")
                if main_rank:
                    metrics_log.log(epoch, "val", loss=mean_loss, batches=len(val_losses))

        in_warmup = layer_warmup is not None and epoch < layer_warmup.total_warmup_epochs
        if plateau is not None and not in_warmup:
            prev = plateau.scale
            plateau.step(mean_loss)
            if plateau.scale != prev:
                state.lr_scale = plateau.scale
                print(f"  plateau lr scale -> {plateau.scale:.4f}")

        if main_rank and args.val_inference_freq and (epoch + 1) % args.val_inference_freq == 0:
            from diffdock_tpu_torch.inference.pipeline import DockingPipeline
            from diffdock_tpu_torch.inference.sampler import SamplerConfig

            ema_sd = {**model.state_dict(), **state.ema_params}
            pipe = DockingPipeline(
                dataclasses.replace(cfg, bn_axis_names=()), ema_sd,
                SamplerConfig(inference_steps=args.inference_steps,
                              actual_steps=args.inference_steps),
                so3, torus, device=dev,
            )
            metrics_inf = inference_epoch(pipe, dict(val_items(args.num_inference_complexes, epoch)),
                                          args.num_inference_complexes, args.inference_samples,
                                          seed=epoch)
            del pipe
            print(f"  val inference: {metrics_inf}")
            metrics_log.log(epoch, "val_inference", **metrics_inf)
            m = metrics_inf.get("valinf_min_rmsds_lt2", -1.0)
            if m > best_inf_metric:
                best_inf_metric = m
                extra = {"epoch": epoch, "valinf_min_rmsds_lt2": m}
                save("best_ema_inference_epoch_model.msgpack", state.ema_params, extra)
                save("best_inference_epoch_model.msgpack", None, extra)
            if args.inference_secondary_metric:
                m2 = metrics_inf.get(args.inference_secondary_metric, -1.0)
                if m2 > best_secondary:
                    best_secondary = m2
                    save("best_ema_secondary_epoch_model.msgpack", state.ema_params,
                         {"epoch": epoch, args.inference_secondary_metric: m2})

        if main_rank:
            save_train_state(args.log_dir, model, state, cfg, tc, extra={"epoch": epoch})
        save("last_model.msgpack", None, {"epoch": epoch})
        save("last_ema_model.msgpack", state.ema_params, {"epoch": epoch})
        if mean_loss < best_loss:
            best_loss = mean_loss
            save("best_ema_model.msgpack", state.ema_params, {"epoch": epoch, "loss": mean_loss})
            save("best_model.msgpack", None, {"epoch": epoch, "loss": mean_loss})
    if main_rank:
        metrics_log.close()
        with open(os.path.join(args.log_dir, "history.json"), "w") as f:
            json.dump(history, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
