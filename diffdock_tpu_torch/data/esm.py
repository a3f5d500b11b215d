"""ESM2 protein-language-model embeddings (port of ``diffdock_tpu/data/esm.py``).

Per-residue ESM2-650M embeddings (1280 wide, repr layer 33) come in three
ways, as in the JAX package:

* :func:`chain_sequences` / :func:`write_fasta` / :func:`fasta_records_for_pdbs`
  — one FASTA record per chain (``{name}_chain_{i}``) for fair-esm's
  ``esm extract``;
* :func:`convert_esm_extract_dir` — its ``.pt`` outputs folded into one
  ``.npy`` per complex, read back through :class:`LazyNpyTable`;
* live, on the card, through the port's own encoder
  (:mod:`diffdock_tpu_torch.models.esm2`): :func:`make_embedder` loads an
  npz named by ``DIFFDOCK_TPU_ESM2_NPZ`` (the JAX package's layout, written
  by ``esm-prep convert-hf``), else :class:`ESM2Embedder` converts locally
  cached HuggingFace weights; without weights they raise ``RuntimeError``.

Rows follow the receptor featurizer's residue order: chains in file order,
residues that carry a C-alpha.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from diffdock_tpu_torch import DEFAULT_DEVICE
from diffdock_tpu_torch.data.chem import ProteinStructure, read_pdb_file
from diffdock_tpu_torch.models.esm2 import (
    ESM2,
    ESM2Config,
    TorchESM2Embedder,
    convert_hf_state_dict,
    load_params,
)

ESM_LAYER = 33  # reference uses repr layer 33 of esm2_t33_650M_UR50D
ESM_DIM = 1280
DEFAULT_MODEL = "facebook/esm2_t33_650M_UR50D"


def chain_sequences(protein: ProteinStructure) -> List[Tuple[str, str]]:
    """(chain_id, sequence) per chain, CA-bearing residues only — the same
    residue set the featurizer keeps, so embedding rows align 1:1."""
    out = []
    for ch in protein.chains():
        seq = protein.sequence(chain=ch)
        if seq:
            out.append((ch, seq))
    return out


def write_fasta(records: Dict[str, str], path: str) -> None:
    """Write ``{label: sequence}`` as FASTA (reference
    ``esm_embedding_preparation.py`` output format: one record per chain
    labelled ``{name}_chain_{i}``)."""
    with open(path, "w") as f:
        for label, seq in records.items():
            f.write(f">{label}\n{seq}\n")


def fasta_records_for_pdbs(pdb_paths: Dict[str, str]) -> Dict[str, str]:
    """``{complex_name: pdb_path}`` -> ``{f"{name}_chain_{i}": seq}``."""
    records: Dict[str, str] = {}
    for name, path in pdb_paths.items():
        protein = read_pdb_file(path)
        for i, (_, seq) in enumerate(chain_sequences(protein)):
            records[f"{name}_chain_{i}"] = seq
    return records


def _load_pt_representation(path: str) -> np.ndarray:
    """Read one ``esm extract`` output file."""
    d = torch.load(path, map_location="cpu", weights_only=False)
    rep = d["representations"][ESM_LAYER]
    return np.asarray(rep.float().numpy(), np.float32)


def convert_esm_extract_dir(extract_dir: str, out_dir: str, verbose: bool = True) -> Dict[str, str]:
    """Fold ``esm extract`` per-record ``.pt`` files into one ``.npy`` per
    complex (chains concatenated in index order) — the join the reference
    does in ``datasets/esm_embeddings_to_pt.py``. Returns
    ``{complex_name: npy_path}``."""
    by_complex: Dict[str, List[Tuple[int, str]]] = {}
    for fn in sorted(os.listdir(extract_dir)):
        if not fn.endswith(".pt"):
            continue
        label = fn[: -len(".pt")]
        if "_chain_" not in label:
            continue
        name, idx = label.rsplit("_chain_", 1)
        by_complex.setdefault(name, []).append((int(idx), os.path.join(extract_dir, fn)))

    os.makedirs(out_dir, exist_ok=True)
    out: Dict[str, str] = {}
    for name, chains in by_complex.items():
        chains.sort()
        emb = np.concatenate([_load_pt_representation(p) for _, p in chains], axis=0)
        path = os.path.join(out_dir, f"{name}.npy")
        np.save(path, emb)
        out[name] = path
        if verbose:
            print(f"[esm] {name}: {emb.shape[0]} residues -> {path}")
    return out


class LazyNpyTable:
    """Dict-like ``{name: (R, 1280) array}`` backed by per-name ``.npy``
    files; loads lazily so datasets with thousands of receptors don't hold
    every embedding in RAM."""

    def __init__(self, directory: str):
        self.directory = Path(directory)

    def __contains__(self, name: str) -> bool:
        return (self.directory / f"{name}.npy").exists()

    def get(self, name: str, default=None):
        path = self.directory / f"{name}.npy"
        if not path.exists():
            return default
        return np.load(path)

    def __getitem__(self, name: str) -> np.ndarray:
        out = self.get(name)
        if out is None:
            raise KeyError(name)
        return out


class ESM2Embedder(TorchESM2Embedder):
    """Live ESM2 embeddings from locally cached HuggingFace weights.

    The JAX package runs ``transformers``' ``EsmModel`` on the CPU; the port
    reads the same weights through ``transformers`` (``local_files_only``:
    nothing is downloaded), converts them with ``convert_hf_state_dict`` and
    runs its own encoder on ``device``. Raises ``RuntimeError`` without
    ``transformers``, without the weights, or for a checkpoint that is not
    ESM2-shaped (rotary positions, no LayerNorm before the blocks)."""

    def __init__(self, model_name: str = DEFAULT_MODEL, device=DEFAULT_DEVICE):
        try:
            from transformers import EsmModel
        except Exception as e:
            raise RuntimeError(f"transformers unavailable: {e}") from e
        try:
            hf = EsmModel.from_pretrained(model_name, local_files_only=True)
        except Exception as e:
            raise RuntimeError(
                f"ESM2 weights for {model_name} not in local HF cache; "
                "precompute embeddings offline (esm extract + "
                "convert_esm_extract_dir) or provide cached weights"
            ) from e
        c = hf.config
        if c.position_embedding_type != "rotary" or c.emb_layer_norm_before:
            raise RuntimeError(f"{model_name} is not an ESM2 checkpoint (position_embedding_type="
                               f"{c.position_embedding_type!r}, emb_layer_norm_before={c.emb_layer_norm_before})")
        cfg = ESM2Config(vocab_size=c.vocab_size, hidden_size=c.hidden_size, num_layers=c.num_hidden_layers,
                         num_heads=c.num_attention_heads, intermediate_size=c.intermediate_size,
                         layer_norm_eps=c.layer_norm_eps, token_dropout=c.token_dropout,
                         mask_token_id=c.mask_token_id, pad_token_id=c.pad_token_id)
        params = convert_hf_state_dict(hf.state_dict(), c.num_hidden_layers)
        super().__init__(ESM2.from_params(params, cfg, device))


def make_embedder(device=DEFAULT_DEVICE):
    """The port's encoder on ``device`` from the npz that
    ``DIFFDOCK_TPU_ESM2_NPZ`` names (written by ``esm-prep convert-hf`` of
    either package), else from locally cached HuggingFace weights
    (:class:`ESM2Embedder`). Raises RuntimeError when neither has weights."""
    npz = os.environ.get("DIFFDOCK_TPU_ESM2_NPZ")
    if npz and os.path.exists(npz):
        params, cfg = load_params(npz)
        return TorchESM2Embedder.from_params(params, cfg, device=device)
    return ESM2Embedder(device=device)


def compute_esm_embeddings_if_available(protein: ProteinStructure,
                                        device=DEFAULT_DEVICE) -> Optional[np.ndarray]:
    """Live ESM2 embeddings when weights are available (a converted npz or
    the local HF cache), else None (callers decide the fallback)."""
    try:
        embedder = make_embedder(device)
    except RuntimeError:
        return None
    return embedder.embed_protein(protein)


def embeddings_for_protein(
    protein: ProteinStructure,
    table: Optional[Dict[str, np.ndarray]] = None,
    name: Optional[str] = None,
    embedder=None,
) -> Optional[np.ndarray]:
    """Resolve per-residue embeddings: precomputed table first, else a live
    embedder, else None (model then runs without LM features)."""
    if table is not None and name is not None and name in table:
        return np.asarray(table[name], np.float32)
    if embedder is not None:
        return embedder.embed_protein(protein)
    return None
