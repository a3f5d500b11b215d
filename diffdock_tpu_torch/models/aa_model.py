"""The all-atom score/confidence network (port of ``diffdock_tpu/models/aa_model.py``).

Extends the coarse-grained model with a third node set, the receptor's
heavy atoms, and the reference's nine edge types:

  0 lig<-lig   1 lig<-rec   2 lig<-atom
  3 rec<-rec   4 rec<-lig   5 rec<-atom
  6 atom<-atom 7 atom<-lig  8 atom<-rec

(group order = the reference's edge concatenation, ``aa_model.py:407-416``).
The time-independent protein embedding runs jointly over residues and
atoms with four edge groups (0 rec<-rec, 1 atom<-rec, 2 atom<-atom,
3 rec<-atom) and is cached per complex (:class:`AARecCache`). The last
joint conv restricts to the edges into the ligand (groups 0-2); its
residue and atom sets still pass through the joint batch norm. Both modes
share the class: the confidence head and the score heads are the
coarse-grained model's. Kept as the JAX model has them: the rec<-lig and
atom<-lig edges reuse the UNFLIPPED harmonics of the lig<-rec and
lig<-atom vectors, the rec<-atom edges the atom->residue direction, and
the atom graphs embed distances with the ligand distance expansion.

As in ``models/score_model.py``, a forward takes P poses of one complex
(``lig_pos`` (P, NL, 3)) or a stacked batch of P complexes with one pose
each (training). Submodule names follow the flax tree (``rec_emb_{i}`` and
``conv_{i}`` are :class:`~diffdock_tpu_torch.models.tpconv.MultiTPConvLayer`\\ s,
their FCs ``fc_{g}``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from diffdock_tpu_torch.data.complexes import AAComplexData, apply_rec_keep_aa
from diffdock_tpu_torch.diffusion.so3 import SO3Tables
from diffdock_tpu_torch.diffusion.torus import TorusTables
from diffdock_tpu_torch.models.config import ConfigError, ScoreModelConfig
from diffdock_tpu_torch.models.encoders import MLP2, AtomEncoder
from diffdock_tpu_torch.models.score_model import (
    CGScoreModel,
    _batched,
    _check_supported,
    _pairwise,
    _per_edge,
    edge_scalars,
)
from diffdock_tpu_torch.models.tpconv import MultiTPConvLayer, NeighborBlock, gather_nodes
from diffdock_tpu_torch.ops.spherical import spherical_harmonics

# reference rec_atom_feature_dims (copied from diffdock_tpu/models/aa_model.py)
AA_ATOM_CATEGORICAL_DIMS = (38, 119, 23, 38)
# FC groups of the protein embedding, of a joint layer and of the last one
EMBED_GROUPS = (0, 1, 2, 3)
JOINT_GROUPS = tuple(range(9))
LAST_GROUPS = (0, 1, 2)


class AARecCache(NamedTuple):
    """Time-independent receptor embedding, computed once per complex;
    fields (NR, ...) / (NA, ...), or with a leading batch axis."""

    rec_node_attr: torch.Tensor
    atom_node_attr: torch.Tensor
    rec_edge_attr: torch.Tensor  # (NR, KR, ns)
    rec_edge_sh: torch.Tensor
    atom_edge_attr: torch.Tensor  # (NA, KA, ns)
    atom_edge_sh: torch.Tensor
    ar_edge_attr: torch.Tensor  # (NA, 1, ns) atom <- parent residue
    ar_edge_sh: torch.Tensor
    ra_edge_sh: torch.Tensor  # (NR, KRA, sh) residue <- member atoms


def _is_batched(data: AAComplexData) -> bool:
    return data.atom_cat.dim() == 3


def _batched_aa(data: AAComplexData) -> AAComplexData:
    """A one-complex AAComplexData with a leading axis of 1."""
    return AAComplexData(_batched(data.base), *[a[None] for a in data[1:]])


class AAScoreModel(CGScoreModel):
    """The all-atom model of ``cfg`` (``all_atoms=True``); the atom graph
    cutoffs reuse ``lig_max_radius``. ``reference_kernels=True`` routes
    every merged TP contraction through the kernel's plain version."""

    def __init__(self, cfg: ScoreModelConfig, reference_kernels: bool = False):
        nn.Module.__init__(self)
        _check_supported(cfg)
        if not cfg.all_atoms:
            raise ConfigError("AAScoreModel needs all_atoms=True")
        if cfg.smooth_edges:
            # the JAX model asserts: the reference never smooths the all-atom edges
            raise ConfigError("smooth_edges is not supported by the all-atom model")
        self._setup_base(cfg, reference_kernels)
        ns, sig, dist, drop = cfg.ns, cfg.sigma_embed_dim, cfg.distance_embed_dim, cfg.dropout
        self.atom_node_embedding = AtomEncoder(ns, AA_ATOM_CATEGORICAL_DIMS, 0)
        self.atom_edge_embedding = MLP2(dist, ns, drop)
        self.ar_edge_embedding = MLP2(dist, ns, drop)
        self.lr_edge_embedding = MLP2(sig + cfg.cross_distance_embed_dim, ns, drop)
        self.la_edge_embedding = MLP2(sig + dist, ns, drop)

        def multi(i, groups):
            return MultiTPConvLayer(
                self._ladder(i), self.sh_irreps, self._ladder(i + 1), groups=groups,
                differentiate_convolutions=cfg.differentiate_convolutions, residual=True,
                **self._conv)

        npe, n_joint = cfg.num_prot_emb_layers, cfg.num_conv_layers
        self.rec_emb_layers = nn.ModuleList(multi(i, EMBED_GROUPS) for i in range(npe))
        self.conv_layers = nn.ModuleList(
            multi(npe + i, LAST_GROUPS if i == n_joint - 1 else JOINT_GROUPS) for i in range(n_joint))

    # ------------------------------------------------------------------
    def embed_receptor(self, data: AAComplexData) -> AARecCache:
        """The protein embedding of one complex (fields (NR, ...)) or of a
        stacked batch (fields (B, NR, ...))."""
        if _is_batched(data):
            return self._embed_receptor(data)
        return AARecCache(*[a[0] for a in self._embed_receptor(_batched_aa(data))])

    def _embed_receptor(self, ab: AAComplexData) -> AARecCache:
        cfg = self.cfg
        base = ab.base
        rec_attr = self.rec_node_embedding(base.rec_cat, base.rec_lm if cfg.lm_embedding_dim > 0 else None)
        atom_attr = self.atom_node_embedding(ab.atom_cat)

        # rec-rec kNN
        rvec = gather_nodes(base.rec_pos, base.rec_nbr) - base.rec_pos[:, :, None, :]
        rec_edge_attr = self.rec_edge_embedding(self.rec_distance_expansion(torch.linalg.norm(rvec, dim=-1)))
        rec_edge_sh = spherical_harmonics(rvec, cfg.sh_lmax)
        # atom-atom kNN (ligand-scale distance embedding, aa_model.py:583)
        avec = gather_nodes(ab.atom_pos, ab.atom_nbr) - ab.atom_pos[:, :, None, :]
        atom_edge_attr = self.atom_edge_embedding(self.lig_distance_expansion(torch.linalg.norm(avec, dim=-1)))
        atom_edge_sh = spherical_harmonics(avec, cfg.sh_lmax)
        # atom <- parent residue: the vector to the residue
        arvec = gather_nodes(base.rec_pos, ab.atom_res[..., None]) - ab.atom_pos[:, :, None, :]  # (B, NA, 1, 3)
        ar_edge_attr = self.ar_edge_embedding(self.rec_distance_expansion(torch.linalg.norm(arvec, dim=-1)))
        ar_edge_sh = spherical_harmonics(arvec, cfg.sh_lmax)
        # residue <- member atoms reuses the unflipped atom->residue direction
        ravec = base.rec_pos[:, :, None, :] - gather_nodes(ab.atom_pos, ab.res_atom_idx)
        ra_edge_sh = spherical_harmonics(ravec, cfg.sh_lmax)

        for layer in self.rec_emb_layers:
            rec_attr, atom_attr = layer(self._protein_sets(
                ab, rec_attr, atom_attr, rec_edge_attr, rec_edge_sh, atom_edge_attr, atom_edge_sh,
                ar_edge_attr, ar_edge_sh, ra_edge_sh))
        return AARecCache(rec_node_attr=rec_attr, atom_node_attr=atom_attr,
                          rec_edge_attr=rec_edge_attr, rec_edge_sh=rec_edge_sh,
                          atom_edge_attr=atom_edge_attr, atom_edge_sh=atom_edge_sh,
                          ar_edge_attr=ar_edge_attr, ar_edge_sh=ar_edge_sh, ra_edge_sh=ra_edge_sh)

    def _protein_sets(self, ab, rec_attr, atom_attr, rec_edge_attr, rec_edge_sh, atom_edge_attr,
                      atom_edge_sh, ar_edge_attr, ar_edge_sh, ra_edge_sh):
        """Receiver sets of the 4-group protein embedding conv (groups: 0
        rec<-rec, 1 atom<-rec, 2 atom<-atom, 3 rec<-atom, the order of
        aa_model.py:303-309)."""
        ns = self.cfg.ns
        base = ab.base
        rec_rec = NeighborBlock(
            sender_attr=rec_attr, nbr_idx=base.rec_nbr, nbr_mask=base.rec_nbr_mask,
            edge_attr=edge_scalars(ns, rec_attr, rec_attr, rec_edge_attr, base.rec_nbr),
            edge_sh=rec_edge_sh,
        )
        # rec <- its member atoms: edge features reuse the ar embedding
        ra_attr = gather_nodes(ar_edge_attr[:, :, 0], ab.res_atom_idx)
        rec_atom = NeighborBlock(
            sender_attr=atom_attr, nbr_idx=ab.res_atom_idx, nbr_mask=ab.res_atom_mask,
            edge_attr=edge_scalars(ns, rec_attr, atom_attr, ra_attr, ab.res_atom_idx),
            edge_sh=ra_edge_sh,
        )
        atom_res = ab.atom_res[..., None]
        atom_rec = NeighborBlock(
            sender_attr=rec_attr, nbr_idx=atom_res, nbr_mask=ab.atom_mask[..., None],
            edge_attr=edge_scalars(ns, atom_attr, rec_attr, ar_edge_attr, atom_res),
            edge_sh=ar_edge_sh,
        )
        atom_atom = NeighborBlock(
            sender_attr=atom_attr, nbr_idx=ab.atom_nbr, nbr_mask=ab.atom_nbr_mask,
            edge_attr=edge_scalars(ns, atom_attr, atom_attr, atom_edge_attr, ab.atom_nbr),
            edge_sh=atom_edge_sh,
        )
        return [(rec_attr, [rec_rec, rec_atom], (0, 3), base.rec_mask),
                (atom_attr, [atom_rec, atom_atom], (1, 2), ab.atom_mask)]

    # ------------------------------------------------------------------
    def forward(
        self,
        data: AAComplexData,
        lig_pos: torch.Tensor,
        t: torch.Tensor,
        so3_tables: Optional[SO3Tables] = None,
        torus_tables: Optional[TorusTables] = None,
        rec_cache: Optional[AARecCache] = None,
        rec_keep: Optional[torch.Tensor] = None,
    ):
        """Confidence outputs in confidence mode, else scores
        (:class:`~diffdock_tpu_torch.models.score_model.ScoreOutput`), for
        the poses ``lig_pos`` (P, NL, 3): P poses of one complex (``t``
        0-d, ``rec_cache`` from :meth:`embed_receptor` or None), or a
        stacked batch of P complexes with one pose each (``t`` (P,); the
        protein embedding is computed inline). ``rec_keep`` (NR,) bool crops
        the receptor and its atoms of one complex
        (:func:`~diffdock_tpu_torch.data.complexes.apply_rec_keep_aa`); the
        protein embedding is then computed under the crop, so ``rec_cache``
        must be None."""
        cfg = self.cfg
        ns = cfg.ns
        P, nl = lig_pos.shape[:2]
        if rec_keep is not None:
            if rec_cache is not None:
                raise ValueError("rec_keep recomputes the receptor embedding: pass no rec_cache")
            data = apply_rec_keep_aa(data, rec_keep)
        batched = _is_batched(data)
        ab = data if batched else _batched_aa(data)
        base = ab.base
        nr, na = base.rec_pos.shape[1], ab.atom_pos.shape[1]
        dev = lig_pos.device
        t = torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(-1)
        sigmas = self._sigmas(t)
        sigma_emb = self._sigma_embedding(t)  # (B, sig)

        if rec_cache is None:
            rec_cache = self._embed_receptor(ab)
        elif not batched:
            rec_cache = _batched(rec_cache)
        rec_sigma = self.rec_sigma_embedding(sigma_emb)[:, None]  # (B, 1, ns)

        def add_sigma(node):
            return torch.cat([node[..., :ns] + rec_sigma, node[..., ns:]], dim=-1)

        rec_attr, atom_attr = add_sigma(rec_cache.rec_node_attr), add_sigma(rec_cache.atom_node_attr)
        rec_edge_attr = rec_cache.rec_edge_attr + rec_sigma[:, :, None]
        atom_edge_attr = rec_cache.atom_edge_attr + rec_sigma[:, :, None]
        ar_edge_attr = rec_cache.ar_edge_attr + rec_sigma[:, :, None]

        lig_graph = self._ligand_graph(base, lig_pos, sigma_emb)
        lig_attr = self._embed_ligand(base, lig_graph, sigma_emb, P)

        # cross graphs
        cutoff = ((sigmas[0] * 3.0 + 20.0)[:, None, None] if cfg.dynamic_max_cross
                  else cfg.cross_max_distance)
        lrvec, lrdist = _pairwise(base.rec_pos, lig_pos)  # (P, NL, NR, ...)
        lrmask = (lrdist <= cutoff) & base.lig_mask[:, :, None] & base.rec_mask[:, None, :]
        lr_attr = self.lr_edge_embedding(torch.cat(
            [_per_edge(sigma_emb, lrdist.shape), self.cross_distance_expansion(lrdist)], dim=-1))
        lr_sh = spherical_harmonics(lrvec, cfg.sh_lmax)
        # rec<-lig reuses the UNFLIPPED lig<-rec vectors (aa_model.py:412)
        rl_sh = spherical_harmonics(lrvec.transpose(1, 2), cfg.sh_lmax)

        lavec, ladist = _pairwise(ab.atom_pos, lig_pos)  # (P, NL, NA, ...)
        lamask = (ladist <= cfg.lig_max_radius) & base.lig_mask[:, :, None] & ab.atom_mask[:, None, :]
        la_attr = self.la_edge_embedding(torch.cat(
            [_per_edge(sigma_emb, ladist.shape), self.lig_distance_expansion(ladist)], dim=-1))
        la_sh = spherical_harmonics(lavec, cfg.sh_lmax)
        # atom<-lig likewise (aa_model.py:413)
        al_sh = spherical_harmonics(lavec.transpose(1, 2), cfg.sh_lmax)

        rec_idx_all = torch.arange(nr, device=dev).expand(P, nl, nr)
        atom_idx_all = torch.arange(na, device=dev).expand(P, nl, na)
        lig_idx_r = torch.arange(nl, device=dev).expand(P, nr, nl)
        lig_idx_a = torch.arange(nl, device=dev).expand(P, na, nl)
        atom_res = ab.atom_res[..., None]

        for li, layer in enumerate(self.conv_layers):
            bond_block, radius_block = self._lig_blocks_from_graph(base, lig_graph, lig_attr)
            lig_lr = NeighborBlock(
                sender_attr=rec_attr, nbr_idx=rec_idx_all, nbr_mask=lrmask,
                edge_attr=edge_scalars(ns, lig_attr, rec_attr, lr_attr, rec_idx_all), edge_sh=lr_sh)
            lig_la = NeighborBlock(
                sender_attr=atom_attr, nbr_idx=atom_idx_all, nbr_mask=lamask,
                edge_attr=edge_scalars(ns, lig_attr, atom_attr, la_attr, atom_idx_all), edge_sh=la_sh)
            lig_set = (lig_attr, [bond_block, radius_block, lig_lr, lig_la], (0, 0, 1, 2), base.lig_mask)

            if li < len(self.conv_layers) - 1:
                rec_rec = NeighborBlock(
                    sender_attr=rec_attr, nbr_idx=base.rec_nbr, nbr_mask=base.rec_nbr_mask,
                    edge_attr=edge_scalars(ns, rec_attr, rec_attr, rec_edge_attr, base.rec_nbr),
                    edge_sh=rec_cache.rec_edge_sh)
                rec_lig = NeighborBlock(
                    sender_attr=lig_attr, nbr_idx=lig_idx_r, nbr_mask=lrmask.transpose(1, 2),
                    edge_attr=edge_scalars(ns, rec_attr, lig_attr, lr_attr.transpose(1, 2), lig_idx_r),
                    edge_sh=rl_sh)
                ra_attr = gather_nodes(ar_edge_attr[:, :, 0], ab.res_atom_idx)
                rec_atom = NeighborBlock(
                    sender_attr=atom_attr, nbr_idx=ab.res_atom_idx, nbr_mask=ab.res_atom_mask,
                    edge_attr=edge_scalars(ns, rec_attr, atom_attr, ra_attr, ab.res_atom_idx),
                    edge_sh=rec_cache.ra_edge_sh)
                atom_atom = NeighborBlock(
                    sender_attr=atom_attr, nbr_idx=ab.atom_nbr, nbr_mask=ab.atom_nbr_mask,
                    edge_attr=edge_scalars(ns, atom_attr, atom_attr, atom_edge_attr, ab.atom_nbr),
                    edge_sh=rec_cache.atom_edge_sh)
                atom_lig = NeighborBlock(
                    sender_attr=lig_attr, nbr_idx=lig_idx_a, nbr_mask=lamask.transpose(1, 2),
                    edge_attr=edge_scalars(ns, atom_attr, lig_attr, la_attr.transpose(1, 2), lig_idx_a),
                    edge_sh=al_sh)
                atom_rec_block = NeighborBlock(
                    sender_attr=rec_attr, nbr_idx=atom_res, nbr_mask=ab.atom_mask[..., None],
                    edge_attr=edge_scalars(ns, atom_attr, rec_attr, ar_edge_attr, atom_res),
                    edge_sh=rec_cache.ar_edge_sh)
                sets = [lig_set,
                        (rec_attr, [rec_rec, rec_lig, rec_atom], (3, 4, 5), base.rec_mask),
                        (atom_attr, [atom_atom, atom_lig, atom_rec_block], (6, 7, 8), ab.atom_mask)]
            else:
                sets = [lig_set, (rec_attr, [], (), base.rec_mask), (atom_attr, [], (), ab.atom_mask)]
            lig_attr, rec_attr, atom_attr = layer(sets)

        return self._heads(base, lig_pos, lig_attr, sigma_emb, sigmas, so3_tables, torus_tables)

