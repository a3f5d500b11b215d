"""Binding MOAD / DockGen dataset (port of ``diffdock_tpu/data/moad.py``;
the reference's ``datasets/moad.py:20-547``), for ``--dataset moad``
evaluation and training.

* receptors live in ``{moad_dir}/pdb_protein/{rec}_protein.pdb`` and are
  shared by every ligand whose name starts with the same 6-char prefix;
* ligands live in ``{moad_dir}/pdb_superligand/{name}.pdb`` (train) or
  ``pdb_ligand`` (val/test), named ``{pdb}_{bio}_{chain}_{count}``;
* ECOD binding-site clusters group the ligands; within a cluster, the
  ligands of one receptor with the same element formula are the
  alternative ground truths of the min-over-ground-truths RMSD;
* training samples the clusters evenly (``moad.py:260-277``): an epoch
  draws one random ligand of each cluster, in a shuffled cluster order,
  ``multiplicity`` times, with ``numpy.random.RandomState(seed)`` as the
  JAX package does, so both serve the same items in the same order.

Receptor and ligand arrays are cached as ``.npz`` files under the same
names as in the JAX package. The cluster pickles
(``MOAD_generalisation_splits.pkl``, ``new_cluster_to_ligands.pkl``) are
read with ``pickle`` when given; without them every receptor's ligands form
one cluster.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from diffdock_tpu_torch.data.chem import read_molecule_file, read_pdb_file
from diffdock_tpu_torch.data.complexes import ComplexData, build_knn_neighbors
from diffdock_tpu_torch.data.featurize import (
    build_ligand_arrays,
    build_receptor_arrays,
    join_complex_arrays,
)


@dataclasses.dataclass
class MOADConfig:
    moad_dir: str
    cache_dir: str = "data/cache_tpu_moad"
    split: str = "train"
    splits_pickle: Optional[str] = None  # MOAD_generalisation_splits.pkl
    clusters_pickle: Optional[str] = None  # new_cluster_to_ligands.pkl
    c_alpha_max_neighbors: int = 10
    remove_hs: bool = True
    limit_complexes: int = 0
    min_ligand_size: int = 2
    max_ligand_size: Optional[int] = None
    max_receptor_size: Optional[int] = 3000
    remove_promiscuous_targets: Optional[int] = None
    unroll_clusters: bool = False
    chain_cutoff: Optional[float] = None
    multiplicity: int = 1
    no_randomness: bool = False

    def cache_key(self) -> str:
        import hashlib

        keyed = dataclasses.replace(
            self, limit_complexes=0, multiplicity=1, no_randomness=False,
            chain_cutoff=None,
        )
        return hashlib.md5(repr(keyed).encode()).hexdigest()[:10]


def apply_chain_cutoff(
    data: ComplexData,
    chain_ids: np.ndarray,
    cutoff: float,
) -> Optional[ComplexData]:
    """Keep only chains with at least one residue within ``cutoff`` A of the
    ground-truth ligand pose; recenter on the kept residues (reference
    ``datasets/moad.py:204-248``). Returns None when no chain qualifies."""
    lig_abs = np.asarray(data.lig_pos)[np.asarray(data.lig_mask)]
    rec_pos = np.asarray(data.rec_pos)
    d = np.linalg.norm(lig_abs[:, None] - rec_pos[None], axis=-1).min(axis=0)
    if d.min() >= cutoff:
        return None
    keep_chain = np.zeros(int(chain_ids.max()) + 1, bool)
    for c in np.unique(chain_ids[d < cutoff]):
        keep_chain[c] = True
    keep = keep_chain[chain_ids]
    if keep.all():
        return data

    rec_pos_k = rec_pos[keep]
    extra = rec_pos_k.mean(0)
    rec_pos_k = rec_pos_k - extra
    rec_nbr, rec_nbr_mask = build_knn_neighbors(
        rec_pos_k, np.asarray(data.rec_nbr).shape[1]
    )
    return data._replace(
        lig_pos=np.asarray(data.lig_pos) - extra,
        rec_cat=np.asarray(data.rec_cat)[keep],
        rec_lm=np.asarray(data.rec_lm)[keep],
        rec_mask=np.asarray(data.rec_mask)[keep],
        rec_pos=rec_pos_k,
        rec_nbr=rec_nbr,
        rec_nbr_mask=rec_nbr_mask,
        original_center=(
            np.asarray(data.original_center) + extra
        ).astype(np.float32),
    )


class MOADDataset:
    """Cluster-balanced MOAD dataset with split receptor/ligand caches."""

    def __init__(self, cfg: MOADConfig):
        self.cfg = cfg
        self.cache = Path(cfg.cache_dir) / f"moad_{cfg.split}_{cfg.cache_key()}"
        (self.cache / "receptors").mkdir(parents=True, exist_ok=True)
        (self.cache / "ligands").mkdir(parents=True, exist_ok=True)

        self.cluster_to_ligands = self._load_clusters()
        if cfg.limit_complexes:
            names = sorted(
                n for ligs in self.cluster_to_ligands.values() for n in ligs
            )[: cfg.limit_complexes]
            names = set(names)
            self.cluster_to_ligands = {
                c: [n for n in ligs if n in names]
                for c, ligs in self.cluster_to_ligands.items()
            }
        self._failures: Dict[str, str] = {}

    # -- lay of the land -------------------------------------------------
    def _load_clusters(self) -> Dict[str, List[str]]:
        cfg = self.cfg
        if cfg.splits_pickle and cfg.clusters_pickle and not cfg.unroll_clusters:
            with open(cfg.splits_pickle, "rb") as f:
                split_key = "PDBBind" if cfg.split == "train" else cfg.split
                split_clusters = pickle.load(f)[split_key]
            with open(cfg.clusters_pickle, "rb") as f:
                cluster_to_ligands = pickle.load(f)
            return {
                c: cluster_to_ligands.get(c, []) for c in split_clusters
            }
        # no cluster metadata: every ligand file is its own cluster
        # (reference unroll_clusters semantics, moad.py:147-151)
        lig_dir = self._ligand_dir()
        clusters: Dict[str, List[str]] = {}
        if os.path.isdir(lig_dir):
            for fn in sorted(os.listdir(lig_dir)):
                if fn.endswith(".pdb"):
                    name = fn[:-4]
                    clusters.setdefault(name[:6], []).append(name)
        return clusters

    def _ligand_dir(self) -> str:
        sub = "pdb_superligand" if self.cfg.split == "train" else "pdb_ligand"
        primary = os.path.join(self.cfg.moad_dir, sub)
        if os.path.isdir(primary):
            return primary
        other = os.path.join(
            self.cfg.moad_dir,
            "pdb_ligand" if sub == "pdb_superligand" else "pdb_superligand",
        )
        return other if os.path.isdir(other) else primary

    def _receptor_path(self, rec_name: str) -> str:
        return os.path.join(
            self.cfg.moad_dir, "pdb_protein", rec_name + "_protein.pdb"
        )

    # -- preprocessing ---------------------------------------------------
    def preprocess(
        self,
        num_workers: int = 0,
        esm_table: Optional[Dict[str, np.ndarray]] = None,
        verbose: bool = True,
    ) -> None:
        """Featurize receptors and ligands into the npz caches
        (idempotent, skip-and-continue on failure like the reference,
        ``moad.py:394-403``)."""
        lig_names = sorted(
            n for ligs in self.cluster_to_ligands.values() for n in ligs
        )
        rec_names = sorted({n[:6] for n in lig_names})

        for rec in rec_names:
            out = self.cache / "receptors" / f"{rec}.npz"
            if out.exists():
                continue
            try:
                protein = read_pdb_file(self._receptor_path(rec))
                lm = esm_table.get(rec) if esm_table else None
                arrays = build_receptor_arrays(
                    protein, lm,
                    c_alpha_max_neighbors=self.cfg.c_alpha_max_neighbors,
                )
                if (
                    self.cfg.max_receptor_size
                    and arrays["rec_pos"].shape[0] > self.cfg.max_receptor_size
                ):
                    raise ValueError(
                        f"receptor too large: {arrays['rec_pos'].shape[0]}"
                    )
                np.savez_compressed(out, **arrays)
            except Exception as e:  # noqa: BLE001 — reference-style skip
                self._failures[rec] = f"{type(e).__name__}: {e}"
                if verbose:
                    print(f"[moad] receptor {rec} failed: {e}")

        for name in lig_names:
            out = self.cache / "ligands" / f"{name}.npz"
            if out.exists():
                continue
            try:
                mol = read_molecule_file(
                    os.path.join(self._ligand_dir(), name + ".pdb")
                )
                arrays, _ = build_ligand_arrays(
                    mol, remove_hs=self.cfg.remove_hs
                )
                n = arrays["lig_cat"].shape[0]
                if n < self.cfg.min_ligand_size:
                    raise ValueError(f"ligand too small: {n}")
                if self.cfg.max_ligand_size and n > self.cfg.max_ligand_size:
                    raise ValueError(f"ligand too large: {n}")
                np.savez_compressed(out, **arrays)
            except Exception as e:  # noqa: BLE001
                self._failures[name] = f"{type(e).__name__}: {e}"
                if verbose:
                    print(f"[moad] ligand {name} failed: {e}")

        self._apply_filters()

    def _apply_filters(self) -> None:
        cfg = self.cfg
        ok_recs = {
            p.stem for p in (self.cache / "receptors").glob("*.npz")
        }
        if cfg.remove_promiscuous_targets is not None:
            # ligand names {pdb}_{bio}_{chain}_{count}: field 3 counts
            # same-target ligands (reference moad.py:370-377)
            promiscuous = set()
            for ligs in self.cluster_to_ligands.values():
                for n in ligs:
                    parts = n.split("_")
                    if (
                        len(parts) > 3
                        and parts[3].isdigit()
                        and int(parts[3]) > cfg.remove_promiscuous_targets
                    ):
                        promiscuous.add(n[:6])
            ok_recs -= promiscuous

        ok_ligs = {p.stem for p in (self.cache / "ligands").glob("*.npz")}
        self.cluster_to_ligands = {
            c: [n for n in ligs if n in ok_ligs and n[:6] in ok_recs]
            for c, ligs in self.cluster_to_ligands.items()
        }
        self.cluster_to_ligands = {
            c: ligs for c, ligs in self.cluster_to_ligands.items() if ligs
        }
        self.clusters = sorted(self.cluster_to_ligands)

    # -- access ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.clusters) * self.cfg.multiplicity

    @property
    def names(self) -> List[str]:
        return sorted(
            n for ligs in self.cluster_to_ligands.values() for n in ligs
        )

    def get_by_name(self, name: str) -> Optional[ComplexData]:
        with np.load(self.cache / "ligands" / f"{name}.npz") as z:
            lig = {k: z[k] for k in z.files}
        with np.load(self.cache / "receptors" / f"{name[:6]}.npz") as z:
            rec = {k: z[k] for k in z.files}
        chain_ids = rec.pop("chain_ids")
        data = join_complex_arrays(lig, rec)
        if self.cfg.chain_cutoff:
            data = apply_chain_cutoff(data, chain_ids, self.cfg.chain_cutoff)
        return data

    def get(self, idx: int, rng: Optional[np.random.RandomState] = None):
        """Cluster-balanced draw (reference ``moad.py:260-277``): ``idx``
        selects the cluster, a random member ligand is served (the first by
        name with ``no_randomness`` or without ``rng``); a complex that the
        chain cutoff empties is drawn again from a random cluster."""
        cluster = self.clusters[idx % len(self.clusters)]
        members = self.cluster_to_ligands[cluster]
        if self.cfg.no_randomness or rng is None:
            name = sorted(members)[0]
        else:
            name = members[rng.randint(len(members))]
        data = self.get_by_name(name)
        if data is None and rng is not None and len(self.clusters) > 1:
            return self.get(rng.randint(len(self.clusters)), rng)
        return name, data

    def alternative_ground_truths(self, name: str) -> List[np.ndarray]:
        """All ground-truth ligand poses for a val/test complex: same
        receptor + identical element formula within the cluster (reference
        multi-ground-truth handling, ``moad.py:497-509``). Returns absolute
        coordinate arrays (the complex's own pose first)."""
        cluster = next(
            (c for c, ligs in self.cluster_to_ligands.items() if name in ligs),
            None,
        )
        with np.load(self.cache / "ligands" / f"{name}.npz") as z:
            own = z["lig_coords"]
            own_cat = z["lig_cat"][:, 0]
        poses = [own]
        if cluster is None:
            return poses
        for other in self.cluster_to_ligands[cluster]:
            if other == name or other[:6] != name[:6]:
                continue
            path = self.cache / "ligands" / f"{other}.npz"
            if not path.exists():
                continue
            with np.load(path) as z:
                cat = z["lig_cat"][:, 0]
                if cat.shape == own_cat.shape and np.all(cat == own_cat):
                    poses.append(z["lig_coords"])
        return poses

    def epoch_iterator(self, seed: int = 0) -> Iterator[Tuple[str, ComplexData]]:
        """One cluster-balanced epoch: the clusters in the order of
        ``RandomState(seed).permutation``, ``multiplicity`` times."""
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(self.clusters))
        for _ in range(self.cfg.multiplicity):
            for idx in order:
                name, data = self.get(int(idx), rng)
                if data is not None:
                    yield name, data
