"""PDB sidechain ("van der Mers") dataset, DiffDock-L's data augmentation
(port of ``diffdock_tpu/data/pdb_sidechain.py``; the reference's
``datasets/pdb.py:150-537``).

Protein sidechains serve as pseudo-ligands: pick a residue whose sidechain
has many tertiary contacts, delete a +/-7-residue window around it (so the
model cannot read the answer off the backbone), optionally delete a second
distant window, and train the score model to dock the extracted sidechain
back into the pocket it came from.

* contact counting: residues with heavy atoms within ``max_dist`` (5 A) of
  the candidate's, excluding the +/- ``buffer_residue_num`` (7) sequence
  neighbours (``pdb.py:101-120``, ``fast_identify_valid_vandermers``);
* sampling probability ``max(contacts - min_contacts + 1, 0)``
  (``pdb.py:234-236``);
* segment removal, the second-segment mode with its 10 A closeness
  exclusion (``pdb.py:283-312``), recentring on the kept residues and the
  receptor kNN graph rebuilt;
* the pseudo-ligand: the sidechain's heavy atoms with bonds perceived from
  covalent radii, as the JAX package builds it (the reference featurizes an
  amino-acid SMILES template through RDKit, ``pdb.py:122-148``).

Each protein's receptor arrays and contact counts are cached as one
``.npz`` under the JAX package's names. Every draw uses
``numpy.random.RandomState`` as the JAX module does, so both serve the same
items in the same order.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from diffdock_tpu_torch.data.chem import _COVALENT_RADIUS, Molecule, read_pdb_file
from diffdock_tpu_torch.data.complexes import ComplexData, build_knn_neighbors
from diffdock_tpu_torch.data.featurize import (
    build_ligand_arrays,
    build_receptor_arrays,
    join_complex_arrays,
)

BACKBONE_ATOMS = {"N", "CA", "C", "O", "OXT"}


@dataclasses.dataclass
class PDBSidechainConfig:
    data_dir: str
    cache_dir: str = "data/cache_tpu_pdb"
    c_alpha_max_neighbors: int = 10
    max_dist: float = 5.0
    buffer_residue_num: int = 7
    min_contacts: int = 5
    # a protein qualifies only if some sidechain has at least this many
    # contacts (the reference hardcodes 10, ``pdb.py:280-282``)
    min_best_contacts: int = 10
    remove_second_segment: bool = False
    min_protein_length: int = 30
    max_protein_length: Optional[int] = 3000
    min_sidechain_atoms: int = 3
    multiplicity: int = 1
    limit_complexes: int = 0

    def cache_key(self) -> str:
        import hashlib

        keyed = (self.c_alpha_max_neighbors, self.max_dist, self.buffer_residue_num,
                 self.min_protein_length, self.max_protein_length)
        return hashlib.md5(repr(keyed).encode()).hexdigest()[:10]


def contact_counts(atom_coords: np.ndarray, atom_res: np.ndarray, n_res: int,
                   max_dist: float = 5.0, buffer_residue_num: int = 7) -> np.ndarray:
    """Per-residue count of the non-local residues with any heavy atom within
    ``max_dist`` of one of its own (``pdb.py:101-120``), in chunks of atoms
    to bound memory."""
    n_atoms = atom_coords.shape[0]
    near = np.zeros((n_res, n_res), bool)
    chunk = 2048
    for s in range(0, n_atoms, chunk):
        d = np.linalg.norm(atom_coords[s : s + chunk, None] - atom_coords[None], axis=-1)
        ii, jj = np.nonzero(d < max_dist)
        near[atom_res[s + ii], atom_res[jj]] = True
    idx = np.arange(n_res)
    local = np.abs(idx[:, None] - idx[None, :]) <= buffer_residue_num
    return (near & ~local).sum(axis=1).astype(np.int32)


def sidechain_molecule(residue) -> Optional[Molecule]:
    """The sidechain heavy atoms of one residue as a Molecule with single
    bonds perceived from covalent radii (within the sum plus 0.4 A); None
    below two atoms."""
    names, elements, coords = [], [], []
    for name, xyz in residue.atoms.items():
        el = residue.elements.get(name) or name[:1]
        if el == "H" or name in BACKBONE_ATOMS:
            continue
        names.append(name)
        elements.append(el)
        coords.append(xyz)
    if len(elements) < 2:
        return None
    xyz = np.asarray(coords, np.float32)
    d = np.linalg.norm(xyz[:, None] - xyz[None], axis=-1)
    r = np.asarray([_COVALENT_RADIUS.get(e, 0.76) for e in elements])
    cut = r[:, None] + r[None] + 0.4
    ii, jj = np.nonzero((d < cut) & (d > 0.4))
    bonds = [(int(i), int(j), 1) for i, j in zip(ii, jj) if i < j]
    return Molecule(elements=elements, coords=xyz, bonds=bonds, charges=[0] * len(elements),
                    name=residue.name)


class PDBSidechainDataset:
    """Sidechain-docking pseudo-complexes sampled from a directory of PDBs."""

    def __init__(self, cfg: PDBSidechainConfig):
        self.cfg = cfg
        self.cache = Path(cfg.cache_dir) / f"pdb_sc_{cfg.cache_key()}"
        self.cache.mkdir(parents=True, exist_ok=True)
        names = sorted(fn[:-4] for fn in os.listdir(cfg.data_dir) if fn.endswith(".pdb"))
        if cfg.limit_complexes:
            names = names[: cfg.limit_complexes]
        self.all_names = names
        self._ok: List[str] = []
        self._failures: Dict[str, str] = {}

    def preprocess(self, verbose: bool = True) -> None:
        """Featurize every protein once into the ``.npz`` cache (receptor
        arrays and contact counts); a protein that fails is skipped, as the
        reference skips it."""
        for name in self.all_names:
            out = self.cache / f"{name}.npz"
            if out.exists():
                continue
            try:
                self._preprocess_one(name, out)
            except Exception as e:  # noqa: BLE001 — the reference skips such proteins
                self._failures[name] = f"{type(e).__name__}: {e}"
                if verbose:
                    print(f"[pdb_sc] {name} failed: {e}")
        self._ok = [n for n in self.all_names
                    if (self.cache / f"{n}.npz").exists() and n not in self._failures]

    def _preprocess_one(self, name: str, out: Path) -> None:
        cfg = self.cfg
        protein = read_pdb_file(os.path.join(cfg.data_dir, name + ".pdb"))
        residues = protein.residues_with_ca()
        n_res = len(residues)
        if n_res < cfg.min_protein_length:
            raise ValueError(f"protein too short: {n_res}")
        if cfg.max_protein_length and n_res > cfg.max_protein_length:
            raise ValueError(f"protein too long: {n_res}")
        rec = build_receptor_arrays(protein, None, c_alpha_max_neighbors=cfg.c_alpha_max_neighbors)
        atom_coords, atom_res = [], []
        for ri, res in enumerate(residues):
            for aname, xyz in res.atoms.items():
                el = res.elements.get(aname) or aname[:1]
                if el == "H":
                    continue
                atom_coords.append(xyz)
                atom_res.append(ri)
        atom_coords = np.asarray(atom_coords, np.float32).reshape(-1, 3)
        atom_res = np.asarray(atom_res, np.int32)
        contacts = contact_counts(atom_coords, atom_res, n_res, max_dist=cfg.max_dist,
                                  buffer_residue_num=cfg.buffer_residue_num)
        np.savez_compressed(out, contacts=contacts, **rec)

    # -- access ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ok) * self.cfg.multiplicity

    @property
    def names(self) -> List[str]:
        return list(self._ok)

    def sampling_probabilities(self, contacts: np.ndarray) -> np.ndarray:
        """``max(contacts - min_contacts + 1, 0)`` (``pdb.py:234-236``)."""
        return np.maximum(contacts.astype(np.float64) - self.cfg.min_contacts + 1, 0.0)

    def get(self, idx: int, rng: Optional[np.random.RandomState] = None,
            _retries: int = 8) -> Optional[Tuple[str, ComplexData]]:
        """One sidechain pseudo-complex of protein ``idx`` (``pdb.py:253-345``),
        named ``{protein}_sc{residue}``; a protein without a sidechain of
        enough contacts or atoms passes to a random other one, at most
        ``_retries`` times (then None)."""
        cfg = self.cfg
        rng = rng or np.random.RandomState(idx)
        name = self._ok[idx % len(self._ok)]
        with np.load(self.cache / f"{name}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        contacts = arrays.pop("contacts")
        arrays.pop("chain_ids", None)
        residues = read_pdb_file(os.path.join(cfg.data_dir, name + ".pdb")).residues_with_ca()
        n_res = len(residues)

        probs = self.sampling_probabilities(contacts)
        if contacts.max() < cfg.min_best_contacts or probs.sum() <= 0:
            return self._retry(rng, _retries)
        sc_idx = int(rng.choice(n_res, p=probs / probs.sum()))
        mol = sidechain_molecule(residues[sc_idx])
        if mol is None or mol.num_atoms < cfg.min_sidechain_atoms:
            return self._retry(rng, _retries)

        keep = np.ones(n_res, bool)
        b = cfg.buffer_residue_num
        keep[max(0, sc_idx - b) : min(sc_idx + b + 1, n_res)] = False
        if cfg.remove_second_segment:
            far = np.sum((arrays["rec_pos"] - arrays["rec_pos"][sc_idx]) ** 2, axis=-1) > 10.0**2
            probs2 = probs * far
            probs2[max(0, sc_idx - b) : min(sc_idx + b + 1, n_res)] = 0
            if probs2.sum() <= 0:
                return self._retry(rng, _retries)
            sc2 = int(rng.choice(n_res, p=probs2 / probs2.sum()))
            keep[max(0, sc2 - b) : min(sc2 + b + 1, n_res)] = False

        rec_pos = arrays["rec_pos"][keep]
        extra = rec_pos.mean(0)
        rec_pos = rec_pos - extra
        rec_nbr, rec_nbr_mask = build_knn_neighbors(rec_pos, cfg.c_alpha_max_neighbors)
        scv = arrays.get("side_chain_vecs")
        rec = dict(
            rec_cat=arrays["rec_cat"][keep],
            rec_lm=arrays["rec_lm"][keep],
            rec_mask=arrays["rec_mask"][keep],
            rec_pos=rec_pos,
            rec_nbr=rec_nbr,
            rec_nbr_mask=rec_nbr_mask,
            original_center=(arrays["original_center"] + extra).astype(np.float32),
            side_chain_vecs=None if scv is None else scv[keep],
        )
        lig, _ = build_ligand_arrays(mol, remove_hs=False)
        return f"{name}_sc{sc_idx}", join_complex_arrays(lig, rec)

    def _retry(self, rng, retries: int):
        if retries <= 0 or not self._ok:
            return None
        return self.get(int(rng.randint(len(self._ok))), rng, retries - 1)

    def epoch_iterator(self, seed: int = 0) -> Iterator[Tuple[str, ComplexData]]:
        """One epoch: the proteins in the order of
        ``RandomState(seed).permutation``, ``multiplicity`` times, one
        sampled sidechain each (skipped when the retries run out)."""
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(self._ok))
        for _ in range(self.cfg.multiplicity):
            for idx in order:
                item = self.get(int(idx), rng)
                if item is not None:
                    yield item
