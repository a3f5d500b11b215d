"""On-the-fly inference complexes (port of ``diffdock_tpu/data/inference_dataset.py``;
reference ``utils/inference_utils.py:118-242``).

Builds featurized complexes directly from user inputs at docking time:

* protein: a PDB path, or an amino-acid sequence passed to an injectable
  ``folder(sequence, out_path) -> pdb_path``; the default
  (:func:`make_esmfold_folder`) runs ESMFold on the builder's ``device``
  through ``transformers`` from locally cached weights and raises without
  them, as the JAX package's does;
* ligand: a structure file (.sdf/.mol/.pdb). SMILES needs RDKit for its 3D
  embedding and raises, as in the JAX package without RDKit;
* per-residue ESM2 embeddings from a precomputed table
  (:class:`~diffdock_tpu_torch.data.esm.LazyNpyTable`) or computed live by
  an embedder (:func:`~diffdock_tpu_torch.data.esm.make_embedder`);
* a per-complex ``success`` flag instead of exceptions: failed inputs are
  reported, not fatal.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from diffdock_tpu_torch import DEFAULT_DEVICE
from diffdock_tpu_torch.data.chem import (
    Molecule,
    ProteinStructure,
    read_molecule_file,
    read_pdb_file,
)
from diffdock_tpu_torch.data.complexes import ComplexData
from diffdock_tpu_torch.data.featurize import build_complex_data


@dataclasses.dataclass
class InferenceSpec:
    """One docking request row (reference CSV columns
    ``complex_name, protein_path, protein_sequence, ligand_description``)."""

    name: str
    protein_path: Optional[str] = None
    protein_sequence: Optional[str] = None
    ligand_description: str = ""


@dataclasses.dataclass
class InferenceComplex:
    name: str
    success: bool
    data: Optional[ComplexData] = None
    mol: Optional[Molecule] = None
    error: Optional[str] = None


def mol_from_smiles(smiles: str, seed: int = 0) -> Molecule:
    """SMILES input needs RDKit's 3D embedding, which the port does not
    use."""
    raise RuntimeError(
        "SMILES ligand input requires RDKit for 3D embedding; provide a "
        "structure file (.sdf/.mol/.pdb) instead"
    )


def fold_sequence(sequence: str, out_path: str, model=None, device=DEFAULT_DEVICE) -> str:
    """Sequence -> structure via ESMFold (reference
    ``generate_ESM_structure``, ``utils/inference_utils.py:87-115``).

    ``model`` is any ``EsmForProteinFolding`` instance (injectable: a fake
    in tests); when absent, loads ``facebook/esmfold_v1`` from the local HF
    cache only (nothing is downloaded) onto ``device`` and raises an
    actionable error otherwise. ``infer_pdbs`` tokenizes internally.
    """
    import torch

    if model is None:
        model = load_esmfold(device)
    # OOM degradation mirroring the reference (utils/inference_utils.py:
    # 87-115): on a memory error, halve the axial-attention chunk size
    # (256 -> 128 -> ... -> 1) and retry
    chunk = None  # model default first (full attention)
    while True:
        try:
            with torch.no_grad():
                pdb_text = model.infer_pdbs([sequence])[0]
            break
        except (MemoryError, RuntimeError) as e:
            if not _is_oom(e):
                raise
            chunk = 256 if chunk is None else chunk // 2
            if chunk < 1:
                raise RuntimeError(
                    "ESMFold out of memory even at chunk_size=1; fold the "
                    "sequence on a larger host or provide --protein_path"
                ) from e
            print(f"ESMFold OOM; retrying with chunk_size {chunk}")
            model.trunk.set_chunk_size(chunk)
    with open(out_path, "w") as f:
        f.write(pdb_text)
    return out_path


def load_esmfold(device=DEFAULT_DEVICE):
    """``facebook/esmfold_v1`` from the local HF cache, in eval mode on
    ``device``; RuntimeError without ``transformers`` or the weights."""
    try:
        from transformers import EsmForProteinFolding
    except Exception as e:
        raise RuntimeError(f"transformers unavailable for ESMFold: {e}") from e
    try:
        model = EsmForProteinFolding.from_pretrained("facebook/esmfold_v1", local_files_only=True)
    except Exception as e:
        raise RuntimeError(
            "ESMFold weights not in local HF cache; provide "
            "--protein_path with a PDB structure instead of a bare "
            "sequence"
        ) from e
    return model.eval().to(device)


def _is_oom(e: BaseException) -> bool:
    if isinstance(e, MemoryError):
        return True
    msg = str(e).lower()
    return "out of memory" in msg or "can't allocate" in msg or (
        "cannot allocate" in msg
    )


def make_esmfold_folder(model=None, device=DEFAULT_DEVICE):
    """A folder callable for :class:`InferenceDatasetBuilder` bound to one
    ESMFold instance: ``model``, else the local weights loaded onto
    ``device`` at the first call, reused across specs."""
    held = [model]

    def _folder(sequence: str, out_path: str) -> str:
        if held[0] is None:
            held[0] = load_esmfold(device)
        return fold_sequence(sequence, out_path, model=held[0])

    return _folder


def read_ligand_description(desc: str, seed: int = 0) -> Molecule:
    """File path if it exists on disk, else treated as SMILES (reference
    ``inference_utils.py:146-162``)."""
    if os.path.exists(desc):
        return read_molecule_file(desc)
    return mol_from_smiles(desc, seed=seed)


class InferenceDatasetBuilder:
    """Turn InferenceSpecs into featurized complexes with success flags."""

    def __init__(
        self,
        c_alpha_max_neighbors: int = 10,
        remove_hs: bool = True,
        esm_embedder=None,
        esm_table: Optional[Dict[str, np.ndarray]] = None,
        workdir: str = ".",
        folder=None,
        device=DEFAULT_DEVICE,
    ):
        self.c_alpha_max_neighbors = c_alpha_max_neighbors
        self.remove_hs = remove_hs
        self.esm_embedder = esm_embedder
        self.esm_table = esm_table
        self.workdir = workdir
        # sequence -> structure hook: callable(sequence, out_path) -> path;
        # the default folds with ESMFold on ``device``
        self.folder = folder or make_esmfold_folder(device=device)

    def _protein(self, spec: InferenceSpec) -> ProteinStructure:
        path = spec.protein_path
        if not path and spec.protein_sequence:
            os.makedirs(self.workdir, exist_ok=True)
            path = self.folder(
                spec.protein_sequence,
                os.path.join(self.workdir, f"{spec.name}_esmfold.pdb"),
            )
        if not path:
            raise ValueError("need protein_path or protein_sequence")
        return read_pdb_file(path)

    def load(
        self, spec: InferenceSpec, seed: int = 0
    ) -> Tuple[Molecule, ProteinStructure, Optional[np.ndarray]]:
        """Resolve a spec to (ligand Molecule, ProteinStructure, optional
        per-residue LM embeddings) without featurizing."""
        protein = self._protein(spec)
        mol = read_ligand_description(spec.ligand_description, seed=seed)
        lm = None
        if self.esm_table is not None and spec.name in self.esm_table:
            lm = np.asarray(self.esm_table[spec.name], np.float32)
        elif self.esm_embedder is not None:
            lm = self.esm_embedder.embed_protein(protein)
        return mol, protein, lm

    def build(self, spec: InferenceSpec, seed: int = 0) -> InferenceComplex:
        try:
            mol, protein, lm = self.load(spec, seed=seed)
            data, heavy = build_complex_data(
                mol, protein, lm,
                c_alpha_max_neighbors=self.c_alpha_max_neighbors,
                remove_hs=self.remove_hs,
            )
            return InferenceComplex(spec.name, True, data, heavy)
        except Exception as e:  # noqa: BLE001 — per-complex success flag
            return InferenceComplex(
                spec.name, False, error=f"{type(e).__name__}: {e}"
            )

    def build_all(
        self, specs: List[InferenceSpec], verbose: bool = True
    ) -> List[InferenceComplex]:
        out = []
        for i, spec in enumerate(specs):
            c = self.build(spec, seed=i)
            if not c.success and verbose:
                print(f"[inference] {spec.name} failed: {c.error}")
            out.append(c)
        return out


def specs_from_csv(path: str) -> List[InferenceSpec]:
    """Reference CSV schema: complex_name, protein_path, protein_sequence,
    ligand_description (``inference.py:160-175``)."""
    specs = []
    with open(path) as f:
        for i, row in enumerate(csv.DictReader(f)):
            name = (row.get("complex_name") or f"complex_{i}").strip()
            specs.append(
                InferenceSpec(
                    name=name,
                    protein_path=(row.get("protein_path") or "").strip() or None,
                    protein_sequence=(
                        row.get("protein_sequence") or ""
                    ).strip() or None,
                    ligand_description=(
                        row.get("ligand_description") or row.get("ligand") or ""
                    ).strip(),
                )
            )
    return specs
