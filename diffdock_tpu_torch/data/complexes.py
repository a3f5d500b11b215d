"""The static padded complex schema (numpy parts of ``diffdock_tpu/data/complexes.py``).

One :class:`ComplexData` holds a single protein-ligand complex as
fixed-shape arrays with validity masks: ligand and receptor nodes, dense
receiver-major neighbour lists, rotatable bonds. :class:`AAComplexData`
adds the receptor's heavy atoms for the all-atom confidence model. Both
are built and padded on the host with numpy; :func:`to_device` turns
either into torch tensors. The receptor crops of the reference's
``crop_beyond`` are here too: the mask crop (:func:`apply_rec_keep`), the
pocket compaction on the device (:func:`pocket_indices`,
:func:`compact_receptor`) and the host crop before padding
(:func:`crop_complex`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from diffdock_tpu_torch.data.featurize import LIG_CATEGORICAL_DIMS, REC_ATOM_CATEGORICAL_DIMS
from diffdock_tpu_torch.geometry.torsion import rotatable_bond_mask
from diffdock_tpu_torch.native import knn_graph_native


class ComplexData(NamedTuple):
    """Fields as in the JAX package; numpy arrays or torch tensors."""

    # --- ligand (static across poses/steps) ---
    lig_cat: object  # (NL, 16) int categorical features
    lig_mask: object  # (NL,) bool
    lig_pos: object  # (NL, 3) f32 reference pose (receptor-centered)
    lig_bond_nbr: object  # (NL, KB) int bonded neighbor indices
    lig_bond_mask: object  # (NL, KB) bool
    lig_bond_attr: object  # (NL, KB, 4) f32 bond-type one-hot

    # --- rotatable bonds ---
    rot_u: object  # (B,) int fixed-side atom
    rot_v: object  # (B,) int rotated-side atom
    rot_mask: object  # (B,) bool
    mask_rotate: object  # (B, NL) bool

    # --- receptor (fully static) ---
    rec_cat: object  # (NR, 1) int residue identity
    rec_lm: object  # (NR, LM) f32 language-model embedding (LM may be 0)
    rec_mask: object  # (NR,) bool
    rec_pos: object  # (NR, 3) f32 C-alpha coords (receptor-centered)
    rec_nbr: object  # (NR, KR) int precomputed kNN neighbors
    rec_nbr_mask: object  # (NR, KR) bool

    # --- bookkeeping ---
    original_center: object  # (3,) f32 receptor centroid in input frame

    # --- optional training target ---
    # (NR, 10) [chi/360 (NaN where undefined), N-CA, C-CA] per residue
    # (:func:`diffdock_tpu_torch.data.chi.side_chain_vecs`); the dock never
    # reads it and drops it before padding; training batches carry it
    rec_scv: object = None

    @property
    def n_lig(self) -> int:
        return self.lig_cat.shape[0]

    @property
    def n_rec(self) -> int:
        return self.rec_cat.shape[0]

    @property
    def n_bonds(self) -> int:
        return self.rot_u.shape[0]


class AAComplexData(NamedTuple):
    """All-atom complex: the coarse-grained schema plus receptor heavy atoms
    (the reference's third node type 'atom'); numpy arrays or torch tensors."""

    base: ComplexData
    atom_cat: object  # (NA, 4) int (aa, atomic_num, type2, type3)
    atom_mask: object  # (NA,) bool
    atom_pos: object  # (NA, 3) f32 (receptor-centered)
    atom_nbr: object  # (NA, KA) int atom-atom kNN
    atom_nbr_mask: object  # (NA, KA) bool
    atom_res: object  # (NA,) int parent residue index
    res_atom_idx: object  # (NR, KRA) int atoms of each residue
    res_atom_mask: object  # (NR, KRA) bool

    @property
    def n_atoms(self) -> int:
        return self.atom_cat.shape[0]


def to_device(data, device):
    """numpy ComplexData or AAComplexData -> torch tensors on ``device``
    (indices as int64, masks as bool, coordinates and features as float32)."""
    if isinstance(data, AAComplexData):
        return AAComplexData(to_device(data.base, device),
                             *[_tensor(a, device) for a in data[1:]])
    return ComplexData(*[None if a is None else _tensor(a, device) for a in data])


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        t = torch.from_numpy(a.copy())
    elif np.issubdtype(a.dtype, np.integer):
        t = torch.from_numpy(a.astype(np.int64))
    else:
        t = torch.from_numpy(a.astype(np.float32))
    return t.to(device)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# geometric bucket ladders (ratio ~1.4-1.5), as in the JAX package
LIG_BUCKETS = (16, 24, 32, 48, 64, 96, 128, 192, 256)
REC_BUCKETS = (64, 128, 192, 320, 448, 704, 1024, 1536, 2304, 3072)
BOND_BUCKETS = (8, 16, 32, 64, 128)

# dense (~1.2x-spaced) rungs, for ``bucket_ladder="fine_dense"`` and
# ``inference/ladder.py:fine_plan(dense=True)``: less padding, more shapes
DENSE_LIG_BUCKETS = (16, 20, 24, 28, 32, 40, 48, 56, 64, 80, 96, 128, 192, 256)
DENSE_REC_BUCKETS = (64, 128, 192, 256, 320, 384, 448, 512, 576, 640, 704, 832, 1024, 1152,
                     1280, 1536, 1792, 2048, 2304, 2688, 3072)


def _ladder(n: int, rungs: Tuple[int, ...], quantum: int) -> int:
    for r in rungs:
        if n <= r:
            return r
    return max(_round_up(n, quantum), rungs[-1] + quantum)


def bucket_sizes(n_lig: int, n_rec: int, n_bonds: int, dense: bool = False) -> Tuple[int, int, int]:
    """Round sizes up the geometric bucket ladders (the dense rungs with
    ``dense``); past the last rung, up to multiples of 16 atoms, 64 residues
    and 8 bonds."""
    return (
        _ladder(n_lig, DENSE_LIG_BUCKETS if dense else LIG_BUCKETS, 16),
        _ladder(n_rec, DENSE_REC_BUCKETS if dense else REC_BUCKETS, 64),
        _ladder(max(n_bonds, 1), BOND_BUCKETS, 8),
    )


def atom_bucket(n_atoms: int) -> int:
    """The receptor-atom bucket of the docking pipeline: multiples of 256,
    at least 256."""
    return max(_round_up(n_atoms, 256), 256)


def pad_to(data: ComplexData, nl: int, nr: int, nb: int, kb: int = 4, kr: int = 0) -> ComplexData:
    """Pad a numpy ComplexData to bucket sizes; the bonded-neighbour width
    becomes at least ``kb`` and the receptor kNN width at least ``kr``, as
    in the JAX package."""

    def pad(a, target_rows, fill=0, cols=None):
        a = np.asarray(a)
        pad_width = [(0, target_rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        if cols is not None:
            pad_width[1] = (0, cols - a.shape[1])
        return np.pad(a, pad_width, constant_values=fill)

    cur_nl, cur_nr, cur_nb = data.lig_cat.shape[0], data.rec_cat.shape[0], data.rot_u.shape[0]
    if not (nl >= cur_nl and nr >= cur_nr and nb >= cur_nb):
        raise ValueError(f"pad_to: bucket ({nl}, {nr}, {nb}) smaller than ({cur_nl}, {cur_nr}, {cur_nb})")
    kb = max(kb, data.lig_bond_nbr.shape[1])
    kr = max(kr, data.rec_nbr.shape[1])
    mask_rotate = np.pad(
        np.asarray(data.mask_rotate), [(0, nb - cur_nb), (0, nl - cur_nl)],
        constant_values=False,
    )
    return ComplexData(
        lig_cat=pad(data.lig_cat, nl),
        lig_mask=pad(data.lig_mask, nl, False),
        lig_pos=pad(data.lig_pos, nl),
        lig_bond_nbr=pad(data.lig_bond_nbr, nl, cols=kb),
        lig_bond_mask=pad(data.lig_bond_mask, nl, False, cols=kb),
        lig_bond_attr=pad(data.lig_bond_attr, nl, cols=kb),
        rot_u=pad(data.rot_u, nb),
        rot_v=pad(data.rot_v, nb),
        rot_mask=pad(data.rot_mask, nb, False),
        mask_rotate=mask_rotate,
        rec_cat=pad(data.rec_cat, nr),
        rec_lm=pad(data.rec_lm, nr),
        rec_mask=pad(data.rec_mask, nr, False),
        rec_pos=pad(data.rec_pos, nr),
        rec_nbr=pad(data.rec_nbr, nr, cols=kr),
        rec_nbr_mask=pad(data.rec_nbr_mask, nr, False, cols=kr),
        original_center=np.asarray(data.original_center),
        rec_scv=None if data.rec_scv is None else pad(data.rec_scv, nr),
    )


# ----------------------------------------------------------------------
# receptor crop (reference crop_beyond, utils/utils.py:388-413)
# ----------------------------------------------------------------------
def apply_rec_keep(data: ComplexData, keep) -> ComplexData:
    """Mask crop: the reference filters the precomputed receptor edges (PyG
    ``subgraph``) instead of rebuilding them, so dropping residues is
    zeroing their validity masks. numpy arrays or torch tensors; ``keep``
    (NR,) bool for one complex, or (B, NR) for each complex of a stacked
    batch."""
    if keep.ndim == 1:
        nbr_keep = keep[data.rec_nbr]
    else:
        flat = data.rec_nbr.reshape(keep.shape[0], -1)
        take = (np.take_along_axis(keep, flat, 1) if isinstance(keep, np.ndarray)
                else torch.gather(keep, 1, flat.long()))
        nbr_keep = take.reshape(data.rec_nbr.shape)
    return data._replace(
        rec_mask=data.rec_mask & keep,
        rec_nbr_mask=data.rec_nbr_mask & keep[..., None] & nbr_keep,
    )


def apply_rec_keep_aa(aa: AAComplexData, keep) -> AAComplexData:
    """All-atom mask crop: atoms follow their parent residue (reference
    ``crop_beyond``'s all-atom branch, ``utils/utils.py:394-400``)."""
    atom_keep = aa.atom_mask & keep[aa.atom_res]
    return aa._replace(
        base=apply_rec_keep(aa.base, keep),
        atom_mask=atom_keep,
        atom_nbr_mask=aa.atom_nbr_mask & atom_keep[:, None] & atom_keep[aa.atom_nbr],
        res_atom_mask=aa.res_atom_mask & keep[:, None],
    )


def _min_lig_d2(rec_pos, poses, lig_mask):
    """(P*NL, NR) squared distances of every pose's atoms to every residue,
    and the ligand mask broadcast to the pose batch; numpy or torch."""
    flat = poses.reshape(-1, poses.shape[-1])
    if isinstance(rec_pos, np.ndarray):
        lmask = np.broadcast_to(lig_mask, poses.shape[:-1]).reshape(-1)
    else:
        lmask = lig_mask.expand(poses.shape[:-1]).reshape(-1)
    d2 = ((flat[:, None, :] - rec_pos[None, :, :]) ** 2).sum(-1)
    return d2, lmask


def rec_keep_mask(rec_pos, rec_mask, poses, lig_mask, cutoff):
    """keep[r] = some ligand atom of some pose lies within ``cutoff`` of
    residue r, and r is real (the reference's crop predicate,
    ``utils/utils.py:391``). ``poses`` (..., NL, 3); numpy or torch."""
    d2, lmask = _min_lig_d2(rec_pos, poses, lig_mask)
    within = (d2 < cutoff ** 2) & lmask[:, None]
    if isinstance(within, np.ndarray):
        return within.any(axis=0) & rec_mask
    return within.any(dim=0) & rec_mask


def pocket_indices(rec_pos: torch.Tensor, rec_mask: torch.Tensor, poses: torch.Tensor,
                   lig_mask: torch.Tensor, cutoff, capacity: int):
    """The ``capacity`` residues nearest to any ligand atom of any pose, in
    order of that distance, and which of them are real and within
    ``cutoff``. As ``jax.lax.top_k`` in the JAX package, ties go to the
    lower index: a stable ascending sort of each residue's least squared
    distance, padding residues at infinity."""
    d2, lmask = _min_lig_d2(rec_pos, poses, lig_mask)
    d2 = torch.where(lmask[:, None], d2, torch.full_like(d2, float("inf")))
    mind2 = torch.where(rec_mask, d2.min(dim=0).values, torch.full_like(d2[0], float("inf")))
    vals, idx = torch.sort(mind2, stable=True)
    return idx[:capacity], vals[:capacity] < cutoff ** 2


def compact_receptor(data: ComplexData, idx: torch.Tensor, valid: torch.Tensor) -> ComplexData:
    """Gather crop to a fixed pocket capacity (``idx``, ``valid`` from
    :func:`pocket_indices`): the receptor's dense blocks shrink to
    ``len(idx)`` rows, where :func:`apply_rec_keep` keeps their padded
    extent. Neighbour lists are remapped to the pocket's indices and edges
    to dropped residues masked, the semantics of the reference's
    ``subgraph`` filter."""
    nr, cap = data.rec_mask.shape[0], idx.shape[0]
    inv = torch.full((nr,), -1, dtype=idx.dtype, device=idx.device)
    inv[idx] = torch.arange(cap, dtype=idx.dtype, device=idx.device)
    nbr_local = inv[data.rec_nbr[idx]]
    nbr_mask = data.rec_nbr_mask[idx] & (nbr_local >= 0) & valid[:, None]
    # dropped neighbours map to -1: point them at 0 (masked anyway)
    nbr_local = torch.clamp(nbr_local, min=0)
    nbr_mask = nbr_mask & valid[nbr_local]
    return data._replace(
        rec_cat=data.rec_cat[idx],
        rec_lm=data.rec_lm[idx],
        rec_mask=data.rec_mask[idx] & valid,
        rec_pos=data.rec_pos[idx],
        rec_nbr=nbr_local,
        rec_nbr_mask=nbr_mask,
        rec_scv=None if data.rec_scv is None else data.rec_scv[idx],
    )


def crop_complex(data: ComplexData, keep: np.ndarray) -> ComplexData:
    """Host crop of a numpy complex before padding: the rows of dropped
    residues go, so a large receptor lands in a small bucket. Neighbour
    lists are filtered and remapped, as the reference's ``subgraph``."""
    keep = np.asarray(keep, bool)
    remap = np.cumsum(keep) - 1  # old index -> new index, where kept
    nbr = np.asarray(data.rec_nbr)
    nbr_mask = np.asarray(data.rec_nbr_mask) & keep[nbr]
    new_nbr = remap[nbr]
    new_nbr[~nbr_mask] = 0
    return data._replace(
        rec_cat=np.asarray(data.rec_cat)[keep],
        rec_lm=np.asarray(data.rec_lm)[keep],
        rec_mask=np.asarray(data.rec_mask)[keep],
        rec_pos=np.asarray(data.rec_pos)[keep],
        rec_nbr=new_nbr[keep].astype(np.int32),
        rec_nbr_mask=nbr_mask[keep],
        rec_scv=None if data.rec_scv is None else np.asarray(data.rec_scv)[keep],
    )


def crop_aa_complex(aa: AAComplexData, keep: np.ndarray) -> AAComplexData:
    """:func:`crop_complex` of an all-atom complex: the atoms of dropped
    residues go too, and atom indices are remapped."""
    keep = np.asarray(keep, bool)
    remap = np.cumsum(keep) - 1
    atom_keep = np.asarray(aa.atom_mask) & keep[np.asarray(aa.atom_res)]
    atom_remap = np.cumsum(atom_keep) - 1
    anbr = np.asarray(aa.atom_nbr)
    anbr_mask = np.asarray(aa.atom_nbr_mask) & atom_keep[anbr]
    new_anbr = atom_remap[anbr]
    new_anbr[~anbr_mask] = 0
    res_atom_idx = np.asarray(aa.res_atom_idx)
    res_atom_mask = np.asarray(aa.res_atom_mask) & atom_keep[res_atom_idx]
    new_rai = atom_remap[res_atom_idx]
    new_rai[~res_atom_mask] = 0
    return aa._replace(
        base=crop_complex(aa.base, keep),
        atom_cat=np.asarray(aa.atom_cat)[atom_keep],
        atom_mask=np.asarray(aa.atom_mask)[atom_keep],
        atom_pos=np.asarray(aa.atom_pos)[atom_keep],
        atom_nbr=new_anbr[atom_keep].astype(np.int32),
        atom_nbr_mask=anbr_mask[atom_keep],
        atom_res=remap[np.asarray(aa.atom_res)[atom_keep]].astype(np.int32),
        res_atom_idx=new_rai[keep].astype(np.int32),
        res_atom_mask=res_atom_mask[keep],
    )


def build_knn_neighbors(
    pos: np.ndarray, k: int, max_radius: Optional[float] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side kNN neighbour lists for the receptor graph: each node's k
    nearest other nodes, optionally radius-capped with the nearest kept
    (reference ``process_mols.py:184-188``). The native library
    (:mod:`diffdock_tpu_torch.native`) first, this numpy path without it,
    as in the JAX package; the two may order exact distance ties
    differently."""
    out = knn_graph_native(np.asarray(pos, np.float32), k, max_radius)
    if out is not None:
        return out
    n = pos.shape[0]
    k = min(k, max(n - 1, 1))
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    idx = np.argsort(d, axis=1)[:, :k]
    dist = np.take_along_axis(d, idx, axis=1)
    mask = np.isfinite(dist)
    if max_radius is not None:
        mask &= dist <= max_radius
        # never isolate a node: keep its nearest neighbour even beyond the
        # cutoff
        if n > 1:
            mask[:, 0] |= ~mask.any(axis=1)
    return idx.astype(np.int32), mask


def pad_aa_to(data: AAComplexData, nl: int, nr: int, nb: int, na: int, kb: int = 4,
              kr: int = 0, ka: Optional[int] = None, ar: Optional[int] = None) -> AAComplexData:
    """Pad a numpy AAComplexData to bucket sizes. ``kb``/``kr`` normalize the
    base tree's widths (see :func:`pad_to`); ``ka`` the atom-kNN column
    count and ``ar`` the atoms-per-residue column count."""

    def pad(a, rows, fill=0, cols=None):
        a = np.asarray(a)
        width = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        if cols is not None:
            width[1] = (0, max(cols, a.shape[1]) - a.shape[1])
        return np.pad(a, width, constant_values=fill)

    if na < data.n_atoms:
        raise ValueError(f"pad_aa_to: atom bucket {na} smaller than {data.n_atoms}")
    return AAComplexData(
        base=pad_to(data.base, nl, nr, nb, kb=kb, kr=kr),
        atom_cat=pad(data.atom_cat, na),
        atom_mask=pad(data.atom_mask, na, False),
        atom_pos=pad(data.atom_pos, na),
        atom_nbr=pad(data.atom_nbr, na, cols=ka),
        atom_nbr_mask=pad(data.atom_nbr_mask, na, False, cols=ka),
        atom_res=pad(data.atom_res, na),
        res_atom_idx=pad(data.res_atom_idx, nr, cols=ar),
        res_atom_mask=pad(data.res_atom_mask, nr, False, cols=ar),
    )


def synthetic_complex(
    rng: np.random.RandomState,
    n_lig: int = 12,
    n_rec: int = 48,
    n_bonds: int = 3,
    lm_dim: int = 0,
) -> ComplexData:
    """Random but structurally valid complex for tests and benchmarks; the
    same draws from ``rng`` as the JAX package's ``synthetic_complex``."""
    # ligand: a random chain so rotatable bonds are well-defined
    lig_pos = np.cumsum(rng.randn(n_lig, 3).astype(np.float32) * 0.8, axis=0)
    lig_pos = lig_pos - lig_pos.mean(0)
    bonds = [(i, i + 1) for i in range(n_lig - 1)]

    edge_mask, mask_rotate = rotatable_bond_mask(n_lig, bonds)
    directed = [e for ij in bonds for e in (ij, ij[::-1])]
    rot_edges = [directed[i] for i in np.flatnonzero(edge_mask)]
    rot_edges, mask_rotate = rot_edges[:n_bonds], mask_rotate[:n_bonds]

    kb = 4
    bond_nbr = np.zeros((n_lig, kb), np.int32)
    bond_mask = np.zeros((n_lig, kb), bool)
    bond_attr = np.zeros((n_lig, kb, 4), np.float32)
    deg = np.zeros(n_lig, int)
    for (i, j) in bonds:
        for a, b in ((i, j), (j, i)):
            bond_nbr[a, deg[a]] = b
            bond_mask[a, deg[a]] = True
            bond_attr[a, deg[a], rng.randint(4)] = 1.0
            deg[a] += 1

    rec_pos = (rng.randn(n_rec, 3) * 8.0).astype(np.float32)
    rec_pos = rec_pos - rec_pos.mean(0)
    rec_nbr, rec_nbr_mask = build_knn_neighbors(rec_pos, 10)

    lig_cat = np.stack(
        [rng.randint(0, d, size=n_lig) for d in LIG_CATEGORICAL_DIMS], axis=1
    ).astype(np.int32)

    nb = len(rot_edges)
    return ComplexData(
        lig_cat=lig_cat,
        lig_mask=np.ones(n_lig, bool),
        lig_pos=lig_pos,
        lig_bond_nbr=bond_nbr,
        lig_bond_mask=bond_mask,
        lig_bond_attr=bond_attr,
        rot_u=np.array([e[0] for e in rot_edges], np.int32),
        rot_v=np.array([e[1] for e in rot_edges], np.int32),
        rot_mask=np.ones(nb, bool),
        mask_rotate=mask_rotate.astype(bool),
        rec_cat=rng.randint(0, 20, size=(n_rec, 1)).astype(np.int32),
        rec_lm=np.zeros((n_rec, lm_dim), np.float32),
        rec_mask=np.ones(n_rec, bool),
        rec_pos=rec_pos,
        rec_nbr=rec_nbr,
        rec_nbr_mask=rec_nbr_mask,
        original_center=np.zeros(3, np.float32),
    )


def synthetic_aa_complex(
    rng: np.random.RandomState,
    n_lig: int = 12,
    n_rec: int = 16,
    n_bonds: int = 3,
    atoms_per_res: int = 4,
    lm_dim: int = 0,
    k_atom: int = 6,
) -> AAComplexData:
    """Random all-atom complex: each residue gets a few heavy atoms near its
    C-alpha; the same draws from ``rng`` as the JAX package's
    ``synthetic_aa_complex``."""
    base = synthetic_complex(rng, n_lig=n_lig, n_rec=n_rec, n_bonds=n_bonds, lm_dim=lm_dim)
    na = n_rec * atoms_per_res
    atom_res = np.repeat(np.arange(n_rec), atoms_per_res).astype(np.int32)
    atom_pos = np.asarray(base.rec_pos)[atom_res] + rng.randn(na, 3).astype(np.float32) * 1.5
    atom_cat = np.stack(
        [rng.randint(0, d, size=na) for d in REC_ATOM_CATEGORICAL_DIMS], axis=1
    ).astype(np.int32)
    atom_nbr, atom_nbr_mask = build_knn_neighbors(atom_pos, k_atom)
    res_atom_idx = np.arange(na).reshape(n_rec, atoms_per_res).astype(np.int32)
    return AAComplexData(
        base=base,
        atom_cat=atom_cat,
        atom_mask=np.ones(na, bool),
        atom_pos=atom_pos,
        atom_nbr=atom_nbr,
        atom_nbr_mask=atom_nbr_mask,
        atom_res=atom_res,
        res_atom_idx=res_atom_idx,
        res_atom_mask=np.ones((n_rec, atoms_per_res), bool),
    )
