"""``diffdock-tpu-torch`` console entry point: a subcommand dispatcher over
the port's CLIs (port of ``diffdock_tpu/cli/main.py``, with its command
names).

Each subcommand imports its module only when it runs, so ``--help`` stays
instant and torch is paid for only by the command run.
"""

from __future__ import annotations

import sys

_COMMANDS = {
    "dock": ("diffdock_tpu_torch.cli.dock",
             "dock ligands into receptors (reference inference.py)"),
    "train": ("diffdock_tpu_torch.cli.train",
              "train a score model (reference train.py)"),
    "evaluate": ("diffdock_tpu_torch.cli.evaluate",
                 "benchmark docking on a test split (reference evaluate.py)"),
    "confidence-train": ("diffdock_tpu_torch.cli.confidence_train",
                         "generate poses + train the confidence model "
                         "(reference confidence/confidence_train.py)"),
    "esm-prep": ("diffdock_tpu_torch.cli.esm_prep",
                 "precompute ESM2 language-model embeddings (reference "
                 "datasets/esm_embedding_preparation.py)"),
    "import-weights": ("diffdock_tpu_torch.cli.import_weights",
                       "convert a reference torch checkpoint to native "
                       "params (no reference analogue)"),
    "prewarm": ("diffdock_tpu_torch.cli.prewarm",
                "build the kernels and run the eval bucket ladder once "
                "ahead of a sweep (no reference analogue)"),
}


def _usage() -> str:
    lines = ["usage: diffdock-tpu-torch <command> [args...]", "", "commands:"]
    for name, (_, desc) in _COMMANDS.items():
        lines.append(f"  {name:<18} {desc}")
    lines.append("")
    lines.append("run 'diffdock-tpu-torch <command> --help' for command arguments")
    return "\n".join(lines)


def _apply_restrict_cpu(argv) -> None:
    """--restrict_cpu must cap the BLAS/OpenMP pools BEFORE the subcommand
    module imports numpy/torch: thread counts are read once at library load
    (reference evaluate.py:186-196 sets them pre-import). The dispatcher
    imports nothing heavy itself, so this is the last safe moment."""
    if "--restrict_cpu" not in argv:
        return
    import os

    n = "16"
    if "--num_cpu" in argv:
        i = argv.index("--num_cpu")
        if i + 1 < len(argv):
            n = argv[i + 1]
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
                "VECLIB_MAXIMUM_THREADS", "NUMEXPR_NUM_THREADS"):
        os.environ[var] = n


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    cmd = argv[0]
    if cmd not in _COMMANDS:
        # tolerate underscore spelling (confidence_train etc.)
        alt = cmd.replace("_", "-")
        if alt in _COMMANDS:
            cmd = alt
        else:
            print(f"diffdock-tpu-torch: unknown command {cmd!r}\n", file=sys.stderr)
            print(_usage(), file=sys.stderr)
            return 2
    _apply_restrict_cpu(argv)

    import importlib

    module = importlib.import_module(_COMMANDS[cmd][0])
    return int(module.main(argv[1:]) or 0)


if __name__ == "__main__":
    raise SystemExit(main())
