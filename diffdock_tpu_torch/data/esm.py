"""Precomputed ESM2 embeddings (numpy parts of ``diffdock_tpu/data/esm.py``).

Per-residue ESM2-650M embeddings (1280 wide, repr layer 33) are read from
one ``.npy`` per complex, rows in the receptor featurizer's residue order:
chains in file order, residues that carry a C-alpha. The live ESM2
embedder is not ported; a caller may pass any object with an
``embed_protein(protein)`` method.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from diffdock_tpu_torch.data.chem import ProteinStructure

ESM_LAYER = 33  # reference uses repr layer 33 of esm2_t33_650M_UR50D
ESM_DIM = 1280


def chain_sequences(protein: ProteinStructure) -> List[Tuple[str, str]]:
    """(chain_id, sequence) per chain, CA-bearing residues only — the same
    residue set the featurizer keeps, so embedding rows align 1:1."""
    out = []
    for ch in protein.chains():
        seq = protein.sequence(chain=ch)
        if seq:
            out.append((ch, seq))
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
