"""The static padded complex schema (numpy parts of ``diffdock_tpu/data/complexes.py``).

One :class:`ComplexData` holds a single protein-ligand complex as
fixed-shape arrays with validity masks: ligand and receptor nodes, dense
receiver-major neighbour lists, rotatable bonds. :class:`AAComplexData`
adds the receptor's heavy atoms for the all-atom confidence model. Both
are built and padded on the host with numpy; :func:`to_device` turns
either into torch tensors. The receptor crops of the port (``crop_beyond``)
are not copied: neither configuration crops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch



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
    # (:func:`benchmark.reference.data.chi.side_chain_vecs`); the dock never
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
