"""Import a reference PyTorch checkpoint into a run directory (port of
``diffdock_tpu/cli/import_weights.py``).

Usage::

    python -m diffdock_tpu_torch.cli.import_weights \
        --torch_checkpoint workdir/v1.1/score_model/best_ema_inference_epoch_model.pt \
        --out_dir workdir/score_model_native

Writes ``model_parameters.yml`` and ``model.msgpack``
(:func:`diffdock_tpu_torch.train.checkpoints.save_checkpoint`), a run
directory that ``--model_dir`` of either package reads. The config comes
from the reference run's ``model_parameters.yml`` (``--ref_config``, or the
one beside the checkpoint), read with
:mod:`diffdock_tpu_torch.utils.simple_yaml`; without one, from
``--preset`` and the size flags. Unlike the JAX CLI, which warns, a
reference key the importer does not consume, or a model entry it does not
produce, is an error: the directory is not written.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="reference torch checkpoint -> run directory")
    p.add_argument("--torch_checkpoint", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ref_config", default=None,
                   help="reference run's model_parameters.yml; derives the "
                        "full config like the reference factory "
                        "(utils/utils.py:172-281). If absent and the "
                        "checkpoint dir contains model_parameters.yml, it "
                        "is used automatically.")
    p.add_argument("--old", action="store_true", default=False,
                   help="checkpoint uses the v1.0 architecture (the shipped "
                        "default confidence model does, inference.py:84)")
    p.add_argument("--preset", default="diffdock_l")
    p.add_argument("--ns", type=int, default=None)
    p.add_argument("--nv", type=int, default=None)
    p.add_argument("--num_conv_layers", type=int, default=None)
    p.add_argument("--num_prot_emb_layers", type=int, default=None)
    p.add_argument("--confidence_mode", action="store_true", default=False)
    return p


def config_from_args(args):
    """The ScoreModelConfig of parsed ``args``, as the JAX CLI derives it."""
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.utils import simple_yaml
    from diffdock_tpu_torch.utils.torch_import import config_from_reference_args

    ref_config = args.ref_config
    if ref_config is None:
        sibling = os.path.join(os.path.dirname(os.path.abspath(args.torch_checkpoint)),
                               "model_parameters.yml")
        if os.path.exists(sibling):
            ref_config = sibling
    if ref_config:
        with open(ref_config) as f:
            ref_args = simple_yaml.load(f.read()) or {}
        cfg = config_from_reference_args(ref_args, confidence_mode=args.confidence_mode,
                                         old=args.old)
        print(f"config derived from {ref_config}")
    else:
        cfg = PRESETS[args.preset]
        if args.old:
            cfg = dataclasses.replace(
                cfg, old_architecture=True, num_prot_emb_layers=0,
                reduce_pseudoscalars=False, embed_also_ligand=False,
            )
    overrides = {k: getattr(args, k) for k in ("ns", "nv", "num_conv_layers", "num_prot_emb_layers")
                 if getattr(args, k) is not None}
    if args.confidence_mode:
        overrides["confidence_mode"] = True
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def main(argv=None) -> int:
    from diffdock_tpu_torch.train.checkpoints import save_checkpoint
    from diffdock_tpu_torch.utils.convert import load_converted
    from diffdock_tpu_torch.utils.torch_import import load_torch_checkpoint

    args = get_parser().parse_args(argv)
    cfg = config_from_args(args)
    params, stats, report = load_torch_checkpoint(args.torch_checkpoint, cfg)
    load_converted(params, stats, report, cfg)
    save_checkpoint(
        args.out_dir, {"params": params, "batch_stats": stats}, cfg,
        extra={"imported_from": args.torch_checkpoint},
    )
    print(f"imported -> {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
