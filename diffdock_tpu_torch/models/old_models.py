"""The v1.0 (ICLR'23) architecture family (port of
``diffdock_tpu/models/old_models.py``).

``OldCGScoreModel`` (coarse-grained, the DiffDock v1.0 score model) and
``OldAAScoreModel`` (all-atom, the architecture of the shipped default
confidence model) take a batch of poses of one complex, ``lig_pos``
(P, NL, 3). In confidence mode they give (P, num_confidence_outputs
[+ 1 affinity column]); in score mode the coarse-grained model's
translation/rotation and torsion heads on the old ladder's last irreps,
with the sigmas ``t_to_sigma`` of t (:class:`ScoreOutput`). Where the JAX
model runs one pose and is ``vmap``ped, every block here carries a leading
pose axis; pose-independent blocks (the receptor and atom graphs before
the first layer has mixed in ligand messages) keep a batch of 1 and are
computed once per forward. The family has no time-independent receptor
cache: sigma enters through the node encoders, so a dock embeds the
receptor at every step.

Differences from the 'new' family, kept exactly as the JAX package has
them:

* no protein-embedding layers and no ``rec_sigma_embedding``: the sigma
  embedding enters through the node encoders and every edge feature;
* per-edge-type conv stacks with independent tensor products and batch
  norms (``lig/rec/lig_to_rec/rec_to_lig`` in CG, a flat 9-per-layer list
  ``conv_{9l+k}`` in AA);
* ``OldAtomEncoder``'s additive scalar fusion with its ESM slicing overlap;
* reversed cross edges reuse the UNFLIPPED spherical harmonics;
* the CG lig->rec edge features are ordered (base, sender, receiver),
  every other conv's (base, receiver, sender);
* the old irrep ladder always ends in ``ns x0o`` (no reduce_pseudoscalars);
* the AA ligand<-atom edges embed distances with the CROSS distance
  expansion despite their 5 A cutoff.

``use_old_atom_encoder=False`` takes the new encoder, the receptor's
scalar tail (the LM embedding, then sigma) fused as one block.
``odd_parity`` is refused, as by the JAX package. ``rec_keep`` crops the
receptor (the pipeline's ``crop_beyond``), as in the JAX models.
Submodule names follow the flax tree (see ``utils/convert.py``).

While a ``torch.profiler`` session runs, a forward opens ranges
(``utils/profiling.py:profiler_range``): ``embed``, ``conv{l}`` per layer
and ``heads``; each conv's block messages are ranges named by its edge
type (``lig<-lig``, ``lig<-rec``, ..., receiver<-sender; the convs'
``range_name``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from diffdock_tpu_torch.data.complexes import (
    AAComplexData,
    ComplexData,
    apply_rec_keep,
    apply_rec_keep_aa,
)
from diffdock_tpu_torch.diffusion.schedules import t_to_sigma
from diffdock_tpu_torch.diffusion.time_embed import get_timestep_embedding
from diffdock_tpu_torch.models.config import ConfigError, ScoreModelConfig
from diffdock_tpu_torch.models.encoders import AtomEncoder, GaussianSmearing, MLP2, OldAtomEncoder
from diffdock_tpu_torch.models.score_model import (
    CGScoreModel,
    ConfidenceMLP,
    _batched,
    _check_supported as _check_dtype,
    _pairwise,
    edge_scalars,
)
from diffdock_tpu_torch.models.tpconv import NeighborBlock, TPConvLayer, _residual_pad
from diffdock_tpu_torch.ops.irreps import Irreps, get_irrep_seq
from diffdock_tpu_torch.ops.spherical import spherical_harmonics
from diffdock_tpu_torch.utils.profiling import profiler_range

# reference rec_atom_feature_dims (copied from diffdock_tpu/models/aa_model.py)
AA_ATOM_CATEGORICAL_DIMS = (38, 119, 23, 38)
# the all-atom model's conv k of each layer by edge type (receiver<-sender)
AA_EDGE_TYPES = ("lig<-lig", "lig<-rec", "lig<-atom", "atom<-atom", "atom<-lig", "atom<-rec",
                 "rec<-rec", "rec<-lig", "rec<-atom")


def _check_supported(cfg: ScoreModelConfig) -> None:
    if not cfg.old_architecture:
        raise ConfigError("the v1.0 family needs old_architecture=True")
    if cfg.odd_parity:
        # the JAX package refuses it (diffdock_tpu/models/old_models.py:72-83):
        # no shipped old-architecture checkpoint sets it
        raise ConfigError("odd_parity is not supported on the v1.0 (old) architectures; "
                          "use the current CG/AA score models")
    _check_dtype(cfg)


class OldCGScoreModel(nn.Module):
    """Reference ``CGOldModel`` (coarse-grained v1.0, the DiffDock v1.0
    score model). ``reference_kernels=True`` routes every merged TP
    contraction through the kernel's plain version. As in the JAX model,
    ``depthwise_convolution`` does not reach the old convs, and
    ``sidechain_pred`` adds no head."""

    # geometry, edge and head helpers shared with the new family: they read
    # cfg, the modules of the score heads, lig_edge_embedding and
    # lig_distance_expansion
    _edge_weight = CGScoreModel._edge_weight
    reset_parameters = CGScoreModel.reset_parameters
    set_generator = CGScoreModel.set_generator
    _setup_score_heads = CGScoreModel._setup_score_heads
    _center_head = CGScoreModel._center_head
    _torsion_head = CGScoreModel._torsion_head

    # the score model's helpers take a stacked batch and (B,) times; these
    # models take one complex and a 0-d time
    def _ligand_graph(self, data, lig_pos, sigma_emb):
        return CGScoreModel._ligand_graph(self, _batched(data), lig_pos, sigma_emb[None])

    def _lig_blocks_from_graph(self, data, graph, node_attr):
        return CGScoreModel._lig_blocks_from_graph(self, _batched(data), graph, node_attr)

    def _sigma_embedding(self, t: torch.Tensor) -> torch.Tensor:
        return self.timestep_emb(t.reshape(1).to(torch.float32))[0]

    def _score_heads(self, data, lig_pos, lig_attr, sigma_emb, sigmas, so3_tables, torus_tables):
        return CGScoreModel._heads(self, _batched(data), lig_pos, lig_attr, sigma_emb[None],
                                   tuple(s.reshape(1) for s in sigmas), so3_tables, torus_tables)

    def __init__(self, cfg: ScoreModelConfig, reference_kernels: bool = False):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self._setup_old_base(reference_kernels)
        sig = cfg.sigma_embed_dim
        self.cross_edge_embedding = MLP2(sig + cfg.cross_distance_embed_dim, cfg.ns, cfg.dropout)
        # the last layer updates only the ligand: it has no receptor-receiver
        # convs (flax creates no parameters for them either)
        L = cfg.num_conv_layers
        for name, n, edge in (("lig_conv", L, "lig<-lig"), ("rec_conv", L - 1, "rec<-rec"),
                              ("lig_to_rec_conv", L - 1, "rec<-lig"), ("rec_to_lig_conv", L, "lig<-rec")):
            self.add_module(f"{name}_layers", nn.ModuleList(self._old_conv(i) for i in range(n)))
            for layer in getattr(self, f"{name}_layers"):
                layer.range_name = edge
        self._build_heads()

    def _ladder(self, i: int) -> str:
        return self.irrep_seq[min(i, len(self.irrep_seq) - 1)]

    def _old_conv(self, i: int) -> TPConvLayer:
        cfg = self.cfg
        return TPConvLayer(self._ladder(i), self.sh_irreps, self._ladder(i + 1),
                           n_edge_features=3 * cfg.ns, residual=False, batch_norm=cfg.batch_norm,
                           hidden_features=3 * cfg.ns, tp_weights_layers=2,
                           reference_kernels=self.reference_kernels, dropout=cfg.dropout,
                           dtype=cfg.compute_dtype, factored=cfg.factored_tp)

    def _setup_old_base(self, reference_kernels: bool) -> None:
        cfg = self.cfg
        ns, sig, dist = cfg.ns, cfg.sigma_embed_dim, cfg.distance_embed_dim
        self.reference_kernels = reference_kernels
        # the old ladder has no reduce_pseudoscalars branch
        self.irrep_seq = get_irrep_seq(ns, cfg.nv, cfg.use_second_order_repr, False)
        self.sh_irreps = str(Irreps.spherical_harmonics(cfg.sh_lmax))
        self.timestep_emb = get_timestep_embedding(cfg.embedding_type, sig, cfg.embedding_scale)
        if cfg.use_old_atom_encoder:
            self.lig_node_embedding = OldAtomEncoder(ns, cfg.lig_node_categorical_dims, scalar_dim=sig)
            self.rec_node_embedding = OldAtomEncoder(ns, cfg.rec_node_categorical_dims, scalar_dim=sig,
                                                     lm_dim=cfg.lm_embedding_dim)
        else:
            # the new encoder fuses the receptor's whole (LM, sigma) tail
            self.lig_node_embedding = AtomEncoder(ns, cfg.lig_node_categorical_dims, sig)
            self.rec_node_embedding = AtomEncoder(ns, cfg.rec_node_categorical_dims,
                                                  cfg.lm_embedding_dim + sig)
        self.lig_edge_embedding = MLP2(cfg.in_lig_edge_features + sig + dist, ns, cfg.dropout)
        self.rec_edge_embedding = MLP2(sig + dist, ns, cfg.dropout)
        self.lig_distance_expansion = GaussianSmearing(0.0, cfg.lig_max_radius, dist)
        self.rec_distance_expansion = GaussianSmearing(0.0, cfg.rec_max_radius, dist)
        self.cross_distance_expansion = GaussianSmearing(
            0.0, cfg.cross_max_distance, cfg.cross_distance_embed_dim
        )

    def _build_heads(self) -> None:
        """The confidence MLP in confidence mode, else the score heads on
        the old ladder's last irreps."""
        cfg = self.cfg
        if not cfg.confidence_mode:
            self._setup_score_heads(self._ladder(cfg.num_conv_layers), self.reference_kernels)
            return
        # the pooled features: the first ns scalars, plus the final ns x0o
        # block when the ladder is deep enough (old_aa_model.py:284-295);
        # the old layout's affinity is ONE extra output column
        in_dim = 2 * cfg.ns if cfg.num_conv_layers >= 3 else cfg.ns
        out_dim = cfg.num_confidence_outputs + (1 if cfg.affinity_prediction else 0)
        self.confidence_predictor = ConfidenceMLP(in_dim, cfg.ns, out_dim,
                                                  no_batchnorm=cfg.confidence_no_batchnorm,
                                                  dropout=cfg.confidence_dropout)

    # ------------------------------------------------------------------
    def _embed_nodes(self, data: ComplexData, sigma_emb: torch.Tensor):
        """Node encoders with the sigma embedding in the scalar tail:
        (1, NL, ns), (1, NR, ns)."""
        nl, nr = data.lig_cat.shape[0], data.rec_cat.shape[0]
        lig_tail = sigma_emb.expand(nl, sigma_emb.shape[-1])
        rec_tail = sigma_emb.expand(nr, sigma_emb.shape[-1])
        if self.cfg.lm_embedding_dim > 0:
            rec_tail = torch.cat([data.rec_lm, rec_tail], dim=-1)
        lig_attr = self.lig_node_embedding(data.lig_cat, lig_tail)
        rec_attr = self.rec_node_embedding(data.rec_cat, rec_tail)
        return lig_attr[None], rec_attr[None]

    def _rec_graph(self, data: ComplexData, sigma_emb: torch.Tensor):
        """Receptor kNN edges, edge features ordered (sigma, distance)."""
        vec = data.rec_pos[data.rec_nbr] - data.rec_pos[:, None, :]
        dist = torch.linalg.norm(vec, dim=-1)
        raw = torch.cat([sigma_emb.expand(dist.shape + sigma_emb.shape[-1:]),
                         self.rec_distance_expansion(dist)], dim=-1)
        return (self.rec_edge_embedding(raw), spherical_harmonics(vec, self.cfg.sh_lmax),
                self._edge_weight(dist, self.cfg.rec_max_radius))

    def _cross_graph(self, other_pos, other_mask, lig_pos, sigma_emb, tr_sigma, embedding,
                     expansion, cutoff=None):
        """Dense ligand x other block, (P, NL, NX, ...); edge features
        ordered (sigma, distance). The reversed direction reuses the
        UNFLIPPED harmonics."""
        cfg = self.cfg
        if cutoff is None:
            cutoff = tr_sigma * 3.0 + 20.0 if cfg.dynamic_max_cross else cfg.cross_max_distance
        vec, dist = _pairwise(other_pos, lig_pos)  # (P, NL, NX, ...)
        mask = (dist <= cutoff) & other_mask[None, :]
        raw = torch.cat([sigma_emb.expand(dist.shape + sigma_emb.shape[-1:]), expansion(dist)],
                        dim=-1)
        sh = spherical_harmonics(vec, cfg.sh_lmax)
        return mask, embedding(raw), sh, sh.transpose(1, 2), self._edge_weight(dist, cutoff)

    def _old_confidence_head(self, data: ComplexData, lig_attr: torch.Tensor) -> torch.Tensor:
        """Scalar channels (the first ns, plus the final ns x0o block when
        deep enough) mean-pooled over real ligand atoms -> (P, outputs)."""
        ns = self.cfg.ns
        if self.cfg.num_conv_layers >= 3:
            scalar = torch.cat([lig_attr[..., :ns], lig_attr[..., -ns:]], dim=-1)
        else:
            scalar = lig_attr[..., :ns]
        w = data.lig_mask[:, None].to(scalar.dtype)
        pooled = (scalar * w).sum(-2) / torch.clamp(w.sum(), min=1.0)
        return self.confidence_predictor(pooled)

    def _time(self, lig_pos: torch.Tensor, t):
        """((tr, rot, tor) sigmas, sigma embedding) of the 0-d time ``t``:
        in confidence mode every sigma is t itself."""
        t = torch.as_tensor(t, dtype=torch.float32, device=lig_pos.device).reshape(())
        sigmas = (t, t, t) if self.cfg.confidence_mode else t_to_sigma(t, t, t, self.cfg.sigma)
        return sigmas, self._sigma_embedding(t)

    def _output(self, data, lig_pos, lig_attr, sigma_emb, sigmas, so3_tables, torus_tables):
        if self.cfg.confidence_mode:
            return self._old_confidence_head(data, lig_attr)
        return self._score_heads(data, lig_pos, lig_attr, sigma_emb, sigmas, so3_tables, torus_tables)


    # ------------------------------------------------------------------
    def forward(self, data: ComplexData, lig_pos: torch.Tensor, t=0.0, so3_tables=None,
                torus_tables=None, rec_keep: Optional[torch.Tensor] = None):
        """Confidence outputs (P, outputs) in confidence mode (the pipeline
        passes t = 0), else scores (:class:`ScoreOutput`, with the diffusion
        tables), for the poses ``lig_pos`` (P, NL, 3) of one complex at the
        0-d time ``t``; the receptor is embedded in every forward.
        ``rec_keep`` (NR,) bool crops the receptor
        (:func:`~diffdock_tpu_torch.data.complexes.apply_rec_keep`)."""
        with profiler_range("embed"):
            if rec_keep is not None:
                data = apply_rec_keep(data, rec_keep)
            cfg = self.cfg
            ns = cfg.ns
            P, nl = lig_pos.shape[:2]
            nr = data.rec_pos.shape[0]
            dev = lig_pos.device
            sigmas, sigma_emb = self._time(lig_pos, t)
            tr_sigma = sigmas[0]

            lig_attr, rec_attr = self._embed_nodes(data, sigma_emb)
            lig_graph = self._ligand_graph(data, lig_pos, sigma_emb)
            rec_edge_attr, rec_edge_sh, rec_edge_w = self._rec_graph(data, sigma_emb)
            cmask, cross_attr, cross_sh, rev_cross_sh, cross_w = self._cross_graph(
                data.rec_pos, data.rec_mask, lig_pos, sigma_emb, tr_sigma,
                self.cross_edge_embedding, self.cross_distance_expansion,
            )
            cmask = cmask & data.lig_mask[:, None]
            rev_cross_w = None if cross_w is None else cross_w.transpose(1, 2)
            rec_idx_all = torch.arange(nr, device=dev).expand(P, nl, nr)
            lig_idx_all = torch.arange(nl, device=dev).expand(P, nr, nl)
            rec_nbr = data.rec_nbr[None]

        L = cfg.num_conv_layers
        for l in range(L):
            with profiler_range(f"conv{l}"):
                bond_block, radius_block = self._lig_blocks_from_graph(data, lig_graph, lig_attr)
                lig_intra = self.lig_conv_layers[l](None, [bond_block, radius_block])
                r2l_block = NeighborBlock(
                    sender_attr=rec_attr, nbr_idx=rec_idx_all, nbr_mask=cmask,
                    edge_attr=edge_scalars(ns, lig_attr, rec_attr, cross_attr, rec_idx_all),
                    edge_sh=cross_sh, edge_weight=cross_w,
                )
                lig_inter = self.rec_to_lig_conv_layers[l](None, [r2l_block])
                if l < L - 1:
                    rec_rec_block = NeighborBlock(
                        sender_attr=rec_attr, nbr_idx=rec_nbr, nbr_mask=data.rec_nbr_mask[None],
                        edge_attr=edge_scalars(ns, rec_attr, rec_attr, rec_edge_attr[None], rec_nbr),
                        edge_sh=rec_edge_sh[None],
                        edge_weight=None if rec_edge_w is None else rec_edge_w[None],
                    )
                    rec_intra = self.rec_conv_layers[l](None, [rec_rec_block])
                    # lig->rec: edge features (base, SENDER lig, RECEIVER rec)
                    l2r_block = NeighborBlock(
                        sender_attr=lig_attr, nbr_idx=lig_idx_all, nbr_mask=cmask.transpose(1, 2),
                        edge_attr=edge_scalars(ns, rec_attr, lig_attr, cross_attr.transpose(1, 2),
                                              lig_idx_all, swap=True),
                        edge_sh=rev_cross_sh, edge_weight=rev_cross_w,
                    )
                    rl = self.lig_to_rec_conv_layers[l](None, [l2r_block])
                lig_attr = _residual_pad(lig_intra + lig_inter, lig_attr)
                if l < L - 1:
                    rec_attr = _residual_pad(rec_intra + rl, rec_attr)
        with profiler_range("heads"):
            return self._output(data, lig_pos, lig_attr, sigma_emb, sigmas, so3_tables, torus_tables)


class OldAAScoreModel(OldCGScoreModel):
    """Reference ``AAOldModel``, the architecture of the shipped default
    confidence model (either mode). Conv layers live in one flat list
    ``conv_layers`` indexed ``9l + k`` (flax ``conv_{9l+k}``), k in:

      0 lig<-lig  1 lig<-rec  2 lig<-atom
      3 atom<-atom  4 atom<-lig  5 atom<-rec
      6 rec<-rec  7 rec<-lig  8 rec<-atom
    """

    def __init__(self, cfg: ScoreModelConfig, reference_kernels: bool = False):
        nn.Module.__init__(self)
        _check_supported(cfg)
        if not cfg.all_atoms:
            raise ConfigError("OldAAScoreModel needs all_atoms=True")
        self.cfg = cfg
        self._setup_old_base(reference_kernels)
        ns, sig, dist = cfg.ns, cfg.sigma_embed_dim, cfg.distance_embed_dim
        cross = cfg.cross_distance_embed_dim
        self.atom_node_embedding = (
            OldAtomEncoder(ns, AA_ATOM_CATEGORICAL_DIMS, scalar_dim=sig) if cfg.use_old_atom_encoder
            else AtomEncoder(ns, AA_ATOM_CATEGORICAL_DIMS, sig))
        drop = cfg.dropout
        self.atom_edge_embedding = MLP2(sig + dist, ns, drop)
        self.lr_edge_embedding = MLP2(sig + cross, ns, drop)
        self.ar_edge_embedding = MLP2(sig + dist, ns, drop)
        self.la_edge_embedding = MLP2(sig + cross, ns, drop)
        # the last layer has only its ligand-receiver convs (k < 3): the
        # list ends at 9 (L - 1) + 3, as flax's parameter tree does
        L = cfg.num_conv_layers
        self.conv_layers = nn.ModuleList(
            self._old_conv(l) for l in range(L) for _k in range(9 if l < L - 1 else 3)
        )
        for i, layer in enumerate(self.conv_layers):
            layer.range_name = AA_EDGE_TYPES[i % 9]
        self._build_heads()

    def forward(self, data: AAComplexData, lig_pos: torch.Tensor, t=0.0, so3_tables=None,
                torus_tables=None, rec_keep: Optional[torch.Tensor] = None):
        """As :meth:`OldCGScoreModel.forward`, on the all-atom tree;
        ``rec_keep`` (NR,) bool crops the receptor and its atoms
        (:func:`~diffdock_tpu_torch.data.complexes.apply_rec_keep_aa`)."""
        with profiler_range("embed"):
            if rec_keep is not None:
                data = apply_rec_keep_aa(data, rec_keep)
            cfg = self.cfg
            ns = cfg.ns
            base = data.base
            P, nl = lig_pos.shape[:2]
            nr, na = base.rec_pos.shape[0], data.atom_pos.shape[0]
            dev = lig_pos.device
            sigmas, sigma_emb = self._time(lig_pos, t)
            tr_sigma = sigmas[0]

            lig_attr, rec_attr = self._embed_nodes(base, sigma_emb)
            atom_attr = self.atom_node_embedding(
                data.atom_cat, sigma_emb.expand(na, sigma_emb.shape[-1]))[None]

            lig_graph = self._ligand_graph(base, lig_pos, sigma_emb)
            rec_edge_attr, rec_edge_sh, rec_edge_w = self._rec_graph(base, sigma_emb)
            # atom-atom kNN: ligand-scale distance expansion
            avec = data.atom_pos[data.atom_nbr] - data.atom_pos[:, None, :]
            adist = torch.linalg.norm(avec, dim=-1)
            atom_edge_attr = self.atom_edge_embedding(torch.cat(
                [sigma_emb.expand(adist.shape + sigma_emb.shape[-1:]),
                 self.lig_distance_expansion(adist)], dim=-1))
            atom_edge_sh = spherical_harmonics(avec, cfg.sh_lmax)
            atom_edge_w = self._edge_weight(adist, cfg.lig_max_radius)

            # lig <-> rec (dynamic cutoff)
            cmask, lr_attr, lr_sh, rl_sh, lr_w = self._cross_graph(
                base.rec_pos, base.rec_mask, lig_pos, sigma_emb, tr_sigma,
                self.lr_edge_embedding, self.cross_distance_expansion,
            )
            cmask = cmask & base.lig_mask[:, None]
            rl_w = None if lr_w is None else lr_w.transpose(1, 2)
            # lig <-> atom: 5 A cutoff, CROSS distance expansion
            lamask, la_attr, la_sh, al_sh, la_w = self._cross_graph(
                data.atom_pos, data.atom_mask, lig_pos, sigma_emb, tr_sigma,
                self.la_edge_embedding, self.cross_distance_expansion, cutoff=cfg.lig_max_radius,
            )
            lamask = lamask & base.lig_mask[:, None]
            al_w = None if la_w is None else la_w.transpose(1, 2)

            # atom <-> parent residue (weight 1)
            arvec = base.rec_pos[data.atom_res][:, None, :] - data.atom_pos[:, None, :]
            ardist = torch.linalg.norm(arvec, dim=-1)
            ar_attr = self.ar_edge_embedding(torch.cat(
                [sigma_emb.expand(ardist.shape + sigma_emb.shape[-1:]),
                 self.rec_distance_expansion(ardist)], dim=-1))  # (NA, 1, ns)
            ar_sh = spherical_harmonics(arvec, cfg.sh_lmax)
            # rec <- member atoms reuses the unflipped atom->rec direction
            ra_sh = spherical_harmonics(
                base.rec_pos[:, None, :] - data.atom_pos[data.res_atom_idx], cfg.sh_lmax)
            ra_attr = ar_attr[data.res_atom_idx][..., 0, :]  # (NR, KRA, ns)

            rec_idx_all = torch.arange(nr, device=dev).expand(P, nl, nr)
            atom_idx_all = torch.arange(na, device=dev).expand(P, nl, na)
            lig_idx_r = torch.arange(nl, device=dev).expand(P, nr, nl)
            lig_idx_a = torch.arange(nl, device=dev).expand(P, na, nl)
            atom_nbr, rec_nbr = data.atom_nbr[None], base.rec_nbr[None]
            atom_res, res_atom_idx = data.atom_res[None, :, None], data.res_atom_idx[None]

        L = cfg.num_conv_layers
        for l in range(L):
            with profiler_range(f"conv{l}"):
                conv = lambda k: self.conv_layers[9 * l + k]  # noqa: E731
                bond_block, radius_block = self._lig_blocks_from_graph(base, lig_graph, lig_attr)
                lig_update = conv(0)(None, [bond_block, radius_block])
                lr_block = NeighborBlock(
                    sender_attr=rec_attr, nbr_idx=rec_idx_all, nbr_mask=cmask,
                    edge_attr=edge_scalars(ns, lig_attr, rec_attr, lr_attr, rec_idx_all),
                    edge_sh=lr_sh, edge_weight=lr_w,
                )
                lr_update = conv(1)(None, [lr_block])
                la_block = NeighborBlock(
                    sender_attr=atom_attr, nbr_idx=atom_idx_all, nbr_mask=lamask,
                    edge_attr=edge_scalars(ns, lig_attr, atom_attr, la_attr, atom_idx_all),
                    edge_sh=la_sh, edge_weight=la_w,
                )
                la_update = conv(2)(None, [la_block])

                if l < L - 1:
                    atom_block = NeighborBlock(
                        sender_attr=atom_attr, nbr_idx=atom_nbr, nbr_mask=data.atom_nbr_mask[None],
                        edge_attr=edge_scalars(ns, atom_attr, atom_attr, atom_edge_attr[None], atom_nbr),
                        edge_sh=atom_edge_sh[None],
                        edge_weight=None if atom_edge_w is None else atom_edge_w[None],
                    )
                    atom_update = conv(3)(None, [atom_block])
                    al_block = NeighborBlock(
                        sender_attr=lig_attr, nbr_idx=lig_idx_a, nbr_mask=lamask.transpose(1, 2),
                        edge_attr=edge_scalars(ns, atom_attr, lig_attr, la_attr.transpose(1, 2),
                                              lig_idx_a),
                        edge_sh=al_sh, edge_weight=al_w,
                    )
                    al_update = conv(4)(None, [al_block])
                    ar_block = NeighborBlock(
                        sender_attr=rec_attr, nbr_idx=atom_res, nbr_mask=data.atom_mask[None, :, None],
                        edge_attr=edge_scalars(ns, atom_attr, rec_attr, ar_attr[None], atom_res),
                        edge_sh=ar_sh[None],
                    )
                    ar_update = conv(5)(None, [ar_block])
                    rec_block = NeighborBlock(
                        sender_attr=rec_attr, nbr_idx=rec_nbr, nbr_mask=base.rec_nbr_mask[None],
                        edge_attr=edge_scalars(ns, rec_attr, rec_attr, rec_edge_attr[None], rec_nbr),
                        edge_sh=rec_edge_sh[None],
                        edge_weight=None if rec_edge_w is None else rec_edge_w[None],
                    )
                    rec_update = conv(6)(None, [rec_block])
                    rl_block = NeighborBlock(
                        sender_attr=lig_attr, nbr_idx=lig_idx_r, nbr_mask=cmask.transpose(1, 2),
                        edge_attr=edge_scalars(ns, rec_attr, lig_attr, lr_attr.transpose(1, 2),
                                              lig_idx_r),
                        edge_sh=rl_sh, edge_weight=rl_w,
                    )
                    rl_update = conv(7)(None, [rl_block])
                    ra_block = NeighborBlock(
                        sender_attr=atom_attr, nbr_idx=res_atom_idx,
                        nbr_mask=data.res_atom_mask[None],
                        edge_attr=edge_scalars(ns, rec_attr, atom_attr, ra_attr[None], res_atom_idx),
                        edge_sh=ra_sh[None],
                    )
                    ra_update = conv(8)(None, [ra_block])

                lig_attr = _residual_pad(lig_update + la_update + lr_update, lig_attr)
                if l < L - 1:
                    atom_attr = _residual_pad(atom_update + al_update + ar_update, atom_attr)
                    rec_attr = _residual_pad(rec_update + ra_update + rl_update, rec_attr)
        with profiler_range("heads"):
            return self._output(base, lig_pos, lig_attr, sigma_emb, sigmas, so3_tables, torus_tables)


def confidence_launches(cfg: ScoreModelConfig, embed: bool = False) -> int:
    """Merged TP contractions of one confidence forward (one pose chunk) of
    the confidence model of ``cfg``: per layer the ligand receivers' blocks
    (bonded + radius, and the cross blocks), before the last layer the
    receptor (and atom) receivers' blocks, and for the new architectures
    the ligand embedding layers' two blocks each. ``embed``: the count of
    the new architectures' receptor embedding instead (one block per
    embedding layer, four in the all-atom model), which the pipeline runs
    once per pose batch; the old family has none."""
    L, npe = cfg.num_conv_layers, cfg.num_prot_emb_layers
    if embed:
        return 0 if cfg.old_architecture else (4 if cfg.all_atoms else 1) * npe
    lig_emb = 0 if cfg.old_architecture or not cfg.embed_also_ligand else 2 * npe
    if cfg.all_atoms:
        return lig_emb + 4 * L + 6 * (L - 1)
    return lig_emb + 3 * L + 2 * (L - 1)


def build_confidence_model(cfg: ScoreModelConfig, reference_kernels: bool = False) -> nn.Module:
    """The confidence model a config asks for, through
    :func:`diffdock_tpu_torch.models.factory.build_model`."""
    from diffdock_tpu_torch.models.factory import build_model

    if not cfg.confidence_mode:
        raise ConfigError("a confidence model needs confidence_mode=True")
    return build_model(cfg, reference_kernels=reference_kernels)
