"""Datasets of featurized complexes (port of ``diffdock_tpu/data/datasets.py``).

Host-side preprocessing of (protein, ligand) pairs into ``ComplexData`` (or
``AAComplexData`` with the receptor's atoms), cached as one ``.npz`` shard
per complex under a directory keyed by the dataset's parameters (the
reference's resumable cache, ``datasets/pdbbind.py:157-257``). The cache is
the JAX package's: ``DatasetConfig`` has the same name, fields and defaults,
so ``cache_key`` is the same, and a shard written by either package loads
in the other with equal arrays. ``bucketed_batches`` is the training
sampler: same-bucket stacked batches in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from diffdock_tpu_torch.data.chem import read_molecule_file, read_pdb_file
from diffdock_tpu_torch.data.complexes import AAComplexData, ComplexData, bucket_sizes
from diffdock_tpu_torch.data.featurize import build_aa_complex_data, build_complex_data

_FIELDS = ComplexData._fields
_AA_FIELDS = tuple(f for f in AAComplexData._fields if f != "base")


def save_complex_npz(path: str, data) -> None:
    """Save a ComplexData or AAComplexData (atom fields get an ``atom__``-
    style prefix so one .npz holds both)."""
    if isinstance(data, AAComplexData):
        payload = {
            f: np.asarray(getattr(data.base, f))
            for f in _FIELDS
            if getattr(data.base, f) is not None
        }
        payload.update({
            f"aa__{f}": np.asarray(getattr(data, f)) for f in _AA_FIELDS
        })
        np.savez_compressed(path, **payload)
    else:
        np.savez_compressed(
            path,
            **{
                f: np.asarray(getattr(data, f))
                for f in _FIELDS
                if getattr(data, f) is not None
            },
        )


def load_complex_npz(path: str):
    with np.load(path) as z:
        # optional trailing fields (e.g. rec_scv) may be absent in shards
        # written by older versions — they default to None
        base = ComplexData(
            **{f: z[f] for f in _FIELDS if f in z.files}
        )
        if f"aa__{_AA_FIELDS[0]}" in z.files:
            return AAComplexData(
                base=base, **{f: z[f"aa__{f}"] for f in _AA_FIELDS}
            )
        return base


@dataclasses.dataclass
class ComplexSpec:
    name: str
    protein_path: str
    ligand_path: str
    lm_embedding_path: Optional[str] = None


@dataclasses.dataclass
class DatasetConfig:
    cache_dir: str = "data/cache_tpu"
    c_alpha_max_neighbors: int = 10
    # radius cap on the receptor kNN graph (None = knn-only, the DiffDock-L
    # default; the reference's radius mode uses 30 A / 15 A)
    receptor_radius: Optional[float] = None
    # featurize receptor heavy atoms too (AAComplexData) for the all-atom
    # confidence model (reference --all_atoms, utils/parsing.py)
    all_atoms: bool = False
    atom_max_neighbors: int = 8
    remove_hs: bool = True
    max_lig_size: Optional[int] = None
    max_receptor_size: Optional[int] = 3000  # reference hard cap
    min_ligand_size: int = 0

    def cache_key(self) -> str:
        return hashlib.md5(repr(self).encode()).hexdigest()[:10]


class ComplexDataset:
    """Preprocess-once, load-fast dataset of featurized complexes."""

    def __init__(self, specs: Sequence[ComplexSpec], cfg: DatasetConfig = DatasetConfig()):
        self.specs = list(specs)
        self.cfg = cfg
        self.cache = Path(cfg.cache_dir) / f"complexes_{cfg.cache_key()}"
        self.cache.mkdir(parents=True, exist_ok=True)
        self._by_name = {s.name: s for s in self.specs}
        self._ok: List[ComplexSpec] = []
        self._failures: Dict[str, str] = {}

    def _path(self, spec: ComplexSpec) -> Path:
        # LM-embedding presence changes the featurized rec_lm width, so it
        # must be part of the shard identity — otherwise a cache built
        # without --esm_embeddings_path silently serves dim-0 rec_lm (and
        # vice versa) when the flag changes between runs
        suffix = "__lm.npz" if spec.lm_embedding_path else ".npz"
        return self.cache / f"{spec.name}{suffix}"

    def preprocess(self, num_workers: int = 0, verbose: bool = True) -> None:
        """Featurize all complexes (idempotent; failures skip-and-continue,
        matching the reference's fault tolerance, ``pdbbind.py:387-390``)."""
        todo = [s for s in self.specs if not self._path(s).exists()]
        if num_workers > 1 and todo:
            import multiprocessing as mp

            with mp.Pool(num_workers, maxtasksperchild=8) as pool:
                results = pool.map(self._preprocess_one_safe, todo)
            for spec, err in zip(todo, results):
                if err:
                    self._failures[spec.name] = err
        else:
            for spec in todo:
                err = self._preprocess_one_safe(spec)
                if err:
                    self._failures[spec.name] = err
                    if verbose:
                        print(f"[dataset] {spec.name} failed: {err}")
        self._ok = [
            s for s in self.specs
            if self._path(s).exists() and s.name not in self._failures
        ]

    def _preprocess_one_safe(self, spec: ComplexSpec) -> Optional[str]:
        try:
            self._preprocess_one(spec)
            return None
        except Exception as e:  # noqa: BLE001 — reference-style skip
            return f"{type(e).__name__}: {e}"

    def _preprocess_one(self, spec: ComplexSpec) -> None:
        mol = read_molecule_file(spec.ligand_path)
        protein = read_pdb_file(spec.protein_path)
        lm = None
        if spec.lm_embedding_path:
            lm = np.load(spec.lm_embedding_path)
            if hasattr(lm, "files"):
                lm = lm[lm.files[0]]
        if self.cfg.all_atoms:
            data, heavy = build_aa_complex_data(
                mol, protein, lm,
                c_alpha_max_neighbors=self.cfg.c_alpha_max_neighbors,
                atom_max_neighbors=self.cfg.atom_max_neighbors,
                remove_hs=self.cfg.remove_hs,
                receptor_radius=self.cfg.receptor_radius,
            )
        else:
            data, heavy = build_complex_data(
                mol, protein, lm,
                c_alpha_max_neighbors=self.cfg.c_alpha_max_neighbors,
                remove_hs=self.cfg.remove_hs,
                receptor_radius=self.cfg.receptor_radius,
            )
        base = data.base if isinstance(data, AAComplexData) else data
        if self.cfg.max_lig_size and base.n_lig > self.cfg.max_lig_size:
            raise ValueError(f"ligand too large: {base.n_lig}")
        if base.n_lig < max(self.cfg.min_ligand_size, 2):
            raise ValueError(f"ligand too small: {base.n_lig}")
        if self.cfg.max_receptor_size and base.n_rec > self.cfg.max_receptor_size:
            raise ValueError(f"receptor too large: {base.n_rec}")
        save_complex_npz(str(self._path(spec)), data)

    # -- access --------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ok)

    @property
    def names(self) -> List[str]:
        return [s.name for s in self._ok]

    def get(self, name: str) -> ComplexData:
        return load_complex_npz(str(self._path(self._by_name[name])))

    def bucketed_batches(self, batch_size: int, shuffle_seed: Optional[int] = None
                         ) -> Iterator[Tuple[List[str], ComplexData]]:
        """Yield (names, stacked numpy ComplexData) with every member padded
        to the batch's common bucket: the names shuffled by
        ``RandomState(shuffle_seed)``, grouped by bucket in first-seen
        order, cut into chunks of ``batch_size``."""
        from diffdock_tpu_torch.data.loaders import stack_batch

        names = list(self.names)
        if shuffle_seed is not None:
            np.random.RandomState(shuffle_seed).shuffle(names)
        buckets: Dict[Tuple[int, int, int], List[str]] = {}
        for name in names:
            d = self.get(name)
            buckets.setdefault(bucket_sizes(d.n_lig, d.n_rec, d.n_bonds), []).append(name)
        for bucket, members in buckets.items():
            for i in range(0, len(members), batch_size):
                chunk = members[i : i + batch_size]
                yield stack_batch([(n, self.get(n)) for n in chunk], bucket)

    def print_statistics(self) -> dict:
        """Dataset geometry statistics at load time (reference
        ``datasets/pdbbind.py:421-452``): receptor radius, molecule
        radius, ligand-center distance from the receptor frame origin,
        plus size distributions. Returns the stats dict (also printed).

        The pass re-reads every cached npz, so the computed stats are
        memoized to ``statistics.json`` in the cache dir (keyed by the
        name list) — repeat evaluations print from the sidecar instead
        of doubling dataset I/O."""
        import hashlib
        import json

        key = hashlib.sha256(
            "\n".join(sorted(self.names)).encode()
        ).hexdigest()[:16]
        sidecar = self.cache / "statistics.json"
        stats = None
        try:
            with open(sidecar) as f:
                stored = json.load(f)
            if stored.get("names_key") == key:
                stats = stored["stats"]
        except (FileNotFoundError, ValueError, KeyError):
            pass

        if stats is None:
            rad_p, rad_m, dist_c, n_lig, n_rec = [], [], [], [], []
            for name in self.names:
                d = self.get(name)
                # an all-atom shard's statistics are its coarse-grained
                # tree's (the JAX package reads only coarse-grained shards)
                d = d.base if isinstance(d, AAComplexData) else d
                rec = np.asarray(d.rec_pos)[np.asarray(d.rec_mask, bool)]
                lig = np.asarray(d.lig_pos)[np.asarray(d.lig_mask, bool)]
                rad_p.append(float(np.linalg.norm(rec, axis=1).max()))
                center = lig.mean(axis=0)
                rad_m.append(
                    float(np.linalg.norm(lig - center, axis=1).max())
                )
                dist_c.append(float(np.linalg.norm(center)))
                n_lig.append(d.n_lig)
                n_rec.append(d.n_rec)
            stats = {}
            for label, arr in (
                ("radius protein", rad_p),
                ("radius molecule", rad_m),
                ("distance protein-mol", dist_c),
                ("ligand atoms", n_lig),
                ("receptor residues", n_rec),
            ):
                a = np.asarray(arr, np.float64)
                stats[label] = {
                    "mean": float(a.mean()) if a.size else 0.0,
                    "std": float(a.std()) if a.size else 0.0,
                    "max": float(a.max()) if a.size else 0.0,
                }
            try:
                with open(sidecar, "w") as f:
                    json.dump({"names_key": key, "stats": stats}, f)
            except OSError:
                pass

        print(f"Number of complexes: {len(self)}")
        for label, s in stats.items():
            print(f"{label}: mean {s['mean']:.3f}, std {s['std']:.3f}, "
                  f"max {s['max']:.3f}")
        return stats


def pdbbind_specs(
    root: str, split_file: Optional[str] = None, protein_suffix: str = "_protein_processed.pdb",
    ligand_suffix: str = "_ligand.sdf", esm_embeddings_dir: Optional[str] = None,
) -> List[ComplexSpec]:
    """Specs for the reference PDBBind directory layout
    (``data/PDBBind_processed/<name>/<name>_protein_processed.pdb`` ...)."""
    if split_file:
        with open(split_file) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    else:
        names = sorted(os.listdir(root))
    specs = []
    for name in names:
        pdir = os.path.join(root, name)
        p = os.path.join(pdir, name + protein_suffix)
        l = os.path.join(pdir, name + ligand_suffix)
        if os.path.exists(p) and os.path.exists(l):
            lm = None
            if esm_embeddings_dir:
                cand = os.path.join(esm_embeddings_dir, f"{name}.npy")
                lm = cand if os.path.exists(cand) else None
            specs.append(ComplexSpec(name, p, l, lm))
    return specs
