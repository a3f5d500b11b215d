"""ESM embedding preparation CLI (port of ``diffdock_tpu/cli/esm_prep.py``;
reference ``datasets/esm_embedding_preparation.py`` +
``esm_embeddings_to_pt.py``).

Three subcommands::

    # 1. extract per-chain FASTA from a PDBBind-layout directory
    python -m diffdock_tpu_torch.cli.esm_prep fasta \
        --data_dir data/PDBBind_processed --out prepared.fasta

    # (run `esm extract esm2_t33_650M_UR50D prepared.fasta out_dir \
    #      --repr_layers 33 --include per_tok` elsewhere)

    # 2. fold the esm-extract output into per-complex .npy files
    python -m diffdock_tpu_torch.cli.esm_prep convert \
        --extract_dir out_dir --out_dir data/esm_npy

    # 3. a locally cached HF EsmModel -> the npz both packages read
    #    (needs transformers); set DIFFDOCK_TPU_ESM2_NPZ to it to embed live
    python -m diffdock_tpu_torch.cli.esm_prep convert-hf \
        --model facebook/esm2_t33_650M_UR50D --out esm2.npz
"""

from __future__ import annotations

import argparse
import os
import sys


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ESM embedding preparation")
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fasta", help="extract per-chain FASTA from PDBs")
    f.add_argument("--data_dir", required=True,
                   help="PDBBind-layout root or directory of .pdb files")
    f.add_argument("--protein_suffix", default="_protein_processed.pdb")
    f.add_argument("--out", default="prepared_for_esm.fasta")

    c = sub.add_parser("convert", help="esm-extract .pt dir -> per-complex .npy")
    c.add_argument("--extract_dir", required=True)
    c.add_argument("--out_dir", required=True)

    h = sub.add_parser(
        "convert-hf",
        help="HF EsmModel checkpoint -> the ESM2 npz (models/esm2.py); "
             "set DIFFDOCK_TPU_ESM2_NPZ to the output to run the live LM "
             "on the card",
    )
    h.add_argument("--model", required=True,
                   help="HF model name/dir (loaded local_files_only)")
    h.add_argument("--out", required=True, help="output .npz path")
    return p


def collect_pdb_paths(data_dir: str, protein_suffix: str) -> dict:
    paths = {}
    for entry in sorted(os.listdir(data_dir)):
        full = os.path.join(data_dir, entry)
        if os.path.isdir(full):
            cand = os.path.join(full, entry + protein_suffix)
            if os.path.exists(cand):
                paths[entry] = cand
        elif entry.endswith(".pdb"):
            paths[entry[:-4]] = full
    return paths


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    from diffdock_tpu_torch.data.esm import (
        convert_esm_extract_dir, fasta_records_for_pdbs, write_fasta,
    )

    if args.cmd == "fasta":
        paths = collect_pdb_paths(args.data_dir, args.protein_suffix)
        records = fasta_records_for_pdbs(paths)
        write_fasta(records, args.out)
        print(f"wrote {len(records)} chain records for "
              f"{len(paths)} proteins -> {args.out}")
    elif args.cmd == "convert":
        out = convert_esm_extract_dir(args.extract_dir, args.out_dir)
        print(f"converted {len(out)} complexes -> {args.out_dir}")
    elif args.cmd == "convert-hf":
        try:
            from transformers import EsmModel
        except ImportError as e:
            print(f"esm-prep convert-hf needs the transformers package: {e}", file=sys.stderr)
            return 2

        from diffdock_tpu_torch.models.esm2 import convert_hf_state_dict, save_params

        model = EsmModel.from_pretrained(args.model, local_files_only=True)
        params = convert_hf_state_dict(
            model.state_dict(), model.config.num_hidden_layers
        )
        save_params(params, args.out,
                    num_heads=model.config.num_attention_heads)
        print(f"converted {model.config.num_hidden_layers}-layer ESM2 "
              f"-> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
