"""The coarse-grained score and confidence network (port of ``diffdock_tpu/models/score_model.py``).

``CGScoreModel`` — a heterogeneous equivariant GNN over ligand atoms and
receptor residues. In score mode it ends in the translation/rotation head
and the torsion head; in confidence mode (``cfg.confidence_mode``) every
sigma is ``t`` itself, the score heads are not built, and
:meth:`CGScoreModel._confidence_head` pools the ligand's scalar channels
over its real atoms into :class:`ConfidenceMLP` (with the per-atom head of
``atom_confidence`` and the pose-set head of ``affinity_prediction``,
:meth:`CGScoreModel.predict_affinity`). The all-atom subclass lives in
``models/aa_model.py``; :class:`ConfidenceMLP` also serves the old family's
confidence models (``models/old_models.py``). With ``factored_tp=False``
or ``depthwise_convolution`` the conv layers take the per-edge path
(``models/tpconv.py``) and :meth:`CGScoreModel.step_cache` gives None, as
in the JAX model; ``sidechain_pred`` adds the per-residue sidechain head
(``ScoreOutput.sidechain``, the auxiliary losses' input).

Where the JAX model runs one pose and is ``vmap``ped, this one takes a
batch of poses: ``lig_pos`` is (P, NL, 3) and the outputs are (P, 3),
(P, 3), (P, n_bonds), or (P, outputs) in confidence mode. The
time-independent receptor embedding
(:meth:`CGScoreModel.embed_receptor`) and the pose-independent layer-0
receptor message (:meth:`CGScoreModel.step_cache`) are computed once and
shared by every pose, as in the JAX package. For training the same forward
takes a stacked batch of complexes, one pose each (the JAX trainer's
``vmap`` over complexes): in training mode its batch norms take their
statistics over the whole batch and its dropouts draw from the generator
given to :meth:`CGScoreModel.set_generator`.

Submodule names follow the flax module tree (``rec_emb_{i}`` ->
``rec_emb_layers.{i}``, ``lig_emb_{i}`` -> ``lig_emb_layers.{i}``,
``conv_{i}`` -> ``conv_layers.{i}``); see ``utils/convert.py``.

While a ``torch.profiler`` session runs, the forward opens ranges
(``utils/profiling.py:profiler_range``): ``embed``, ``conv{i}`` for each
joint layer (with a range per neighbour block, ``models/tpconv.py``) and
``heads`` (its convs' blocks as ``center`` and ``torsion``);
:meth:`CGScoreModel.step_cache` opens ``step_cache``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from diffdock_tpu_torch.data.complexes import ComplexData, apply_rec_keep
from diffdock_tpu_torch.diffusion.schedules import t_to_sigma
from diffdock_tpu_torch.diffusion.so3 import SO3Tables
from diffdock_tpu_torch.diffusion.time_embed import get_timestep_embedding
from diffdock_tpu_torch.diffusion.torus import TorusTables
from diffdock_tpu_torch.models.config import ConfigError, ScoreModelConfig
from diffdock_tpu_torch.models.encoders import (
    AtomEncoder,
    Dropout,
    FCBlock,
    FinalNormLayer,
    GaussianSmearing,
    MLP2,
)
from diffdock_tpu_torch.models.tpconv import (
    JointTPConvLayer,
    NeighborBlock,
    TPConvLayer,
    gather_nodes,
)
from diffdock_tpu_torch.ops.batch_norm import MOMENTUM, IrrepsBatchNorm
from diffdock_tpu_torch.ops.irreps import Irreps, get_irrep_seq
from diffdock_tpu_torch.ops.linear import IrrepsLinear
from diffdock_tpu_torch.ops.spherical import irrep1_to_vector, spherical_harmonics
from diffdock_tpu_torch.ops.tensor_product import FullTensorProduct
from diffdock_tpu_torch.utils.profiling import profiler_range


class RecCache(NamedTuple):
    """Time-independent receptor embedding, computed once per complex."""

    node_attr: torch.Tensor  # (NR, F)
    edge_attr: torch.Tensor  # (NR, KR, ns)
    edge_sh: torch.Tensor  # (NR, KR, sh_dim)
    edge_weight: Optional[torch.Tensor] = None  # (NR, KR) smooth-edge ramp


class ScoreOutput(NamedTuple):
    tr: torch.Tensor  # (P, 3)
    rot: torch.Tensor  # (P, 3)
    tor: torch.Tensor  # (P, n_bonds)
    # (P, NR, 10) per-residue [4 chi, N-CA, C-CA] predictions of the
    # sidechain head (``sidechain_pred``); None otherwise
    sidechain: Optional[torch.Tensor] = None


class ScalarBatchNorm(nn.Module):
    """Batch norm over the last axis, flax ``nn.BatchNorm(momentum=0.9)``.
    In evaluation mode the running statistics serve. In training mode
    (``module.training``) the statistics come from every row of the batch,
    all leading axes together (the JAX module's ``pmean`` over its vmapped
    batch axis), with flax's fast variance ``E[x^2] - E[x]^2`` clipped at
    zero, and the running statistics move 0.1 of the way to them. The
    module starts in evaluation mode. With ``mesh`` set
    (``parallel/mesh.py:bind_batch_norms``) the two means are averaged over
    the mesh's ranks, with their gradient (flax's ``pmean`` over ``"dp"``;
    every rank holds as many rows)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.train(False)
        self.mesh = None  # a parallel.mesh.Mesh to average the statistics over

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            return (x - self.running_mean) * inv * self.weight + self.bias
        flat = x.reshape(-1, x.shape[-1])
        mean, mean2 = flat.mean(0), (flat * flat).mean(0)
        if self.mesh is not None:
            mean, mean2 = self.mesh.mean(torch.cat([mean, mean2])).chunk(2)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
            self.running_var.mul_(1 - MOMENTUM).add_(MOMENTUM * var)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class ConfidenceMLP(nn.Module):
    """Dense-BN-ReLU-Dropout x2 + Dense (reference ``cg_model.py:198-208``).
    In training mode the batch norms take their statistics over every row
    they are given: the B pooled rows of a stacked batch (the JAX module's
    ``axis_names=("batch",)``; a norm over one complex's single row would
    output zero and stop every gradient behind it), and the dropouts draw
    from the model's generator. Flax names: ``Dense_{i}`` -> ``layers.{i}``,
    ``BatchNorm_{i}`` -> ``norms.{i}``."""

    def __init__(self, in_dim: int, ns: int, out_dim: int, no_batchnorm: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(in_dim, ns), nn.Linear(ns, ns), nn.Linear(ns, out_dim)])
        self.norms = None if no_batchnorm else nn.ModuleList([ScalarBatchNorm(ns), ScalarBatchNorm(ns)])
        self.drop = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = self.layers[i](x)
            if self.norms is not None:
                x = self.norms[i](x)
            x = self.drop(torch.relu(x))
        return self.layers[2](x)


def _pairwise(sender_pos: torch.Tensor, receiver_pos: torch.Tensor):
    """vec[..., i, j] = sender_pos[..., j] - receiver_pos[..., i]."""
    vec = sender_pos[..., None, :, :] - receiver_pos[..., :, None, :]
    return vec, torch.linalg.norm(vec, dim=-1)


def _check_supported(cfg: ScoreModelConfig) -> None:
    # the JAX CLIs offer these two compute dtypes only
    # (diffdock_tpu/cli/dock.py:93-94), and the kernels take no other
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ConfigError(f"compute_dtype={cfg.compute_dtype}: float32 or bfloat16")


class CGScoreModel(nn.Module):
    """``reference_kernels=True`` routes every merged TP contraction through
    the kernel's plain version instead of the kernel (a numeric oracle for
    the card)."""

    def __init__(self, cfg: ScoreModelConfig, reference_kernels: bool = False):
        super().__init__()
        _check_supported(cfg)
        if cfg.all_atoms:
            raise ConfigError("all_atoms=True is the all-atom model: models/factory.py:build_model "
                              "builds AAScoreModel")
        self._setup_base(cfg, reference_kernels)
        ns, sh, conv = cfg.ns, self.sh_irreps, self._conv
        self.cross_edge_embedding = MLP2(cfg.sigma_embed_dim + cfg.cross_distance_embed_dim, ns,
                                         cfg.dropout)
        npe, n_joint = cfg.num_prot_emb_layers, cfg.num_conv_layers
        self.rec_emb_layers = nn.ModuleList(
            TPConvLayer(self._ladder(i), sh, self._ladder(i + 1), residual=True, **conv)
            for i in range(npe)
        )
        self.conv_layers = nn.ModuleList(
            JointTPConvLayer(
                self._ladder(npe + i), sh, self._ladder(npe + i + 1),
                last_layer=(i == n_joint - 1),
                differentiate_convolutions=cfg.differentiate_convolutions,
                residual=True, **conv,
            )
            for i in range(n_joint)
        )
        if cfg.sidechain_pred and not cfg.confidence_mode:
            # per-residue head on the final receptor features: even and odd
            # halves summed in the forward (reference cg_model.py:173-179)
            self.sidechain_predictor = IrrepsLinear(self._ladder(npe + n_joint),
                                                    "4x0e + 2x1e + 4x0o + 2x1o")

    def _setup_base(self, cfg: ScoreModelConfig, reference_kernels: bool) -> None:
        """The modules the coarse-grained and all-atom models share (the JAX
        model's ``_setup_base``): encoders, edge embeddings, the ligand
        embedding layers and the heads of the mode."""
        self.cfg = cfg
        ns, nv = cfg.ns, cfg.nv
        self.irrep_seq = get_irrep_seq(ns, nv, cfg.use_second_order_repr, cfg.reduce_pseudoscalars)
        self.sh_irreps = sh = str(Irreps.spherical_harmonics(cfg.sh_lmax))
        self.timestep_emb = get_timestep_embedding(
            cfg.embedding_type, cfg.sigma_embed_dim, cfg.embedding_scale
        )
        sig, dist = cfg.sigma_embed_dim, cfg.distance_embed_dim

        self.lig_node_embedding = AtomEncoder(ns, cfg.lig_node_categorical_dims, sig)
        drop = cfg.dropout
        self.lig_edge_embedding = MLP2(cfg.in_lig_edge_features + sig + dist, ns, drop)
        self.rec_node_embedding = AtomEncoder(ns, cfg.rec_node_categorical_dims, cfg.lm_embedding_dim)
        self.rec_edge_embedding = MLP2(dist, ns, drop)
        self.rec_sigma_embedding = MLP2(sig, ns, drop)

        self.lig_distance_expansion = GaussianSmearing(0.0, cfg.lig_max_radius, dist)
        self.rec_distance_expansion = GaussianSmearing(0.0, cfg.rec_max_radius, dist)
        self.cross_distance_expansion = GaussianSmearing(
            0.0, cfg.cross_max_distance, cfg.cross_distance_embed_dim
        )

        # the JAX model's _conv_common: the compute dtype reaches the receptor
        # and ligand embeddings and the joint (all-atom: multi-set) layers,
        # not the score heads' final_conv and tor_bond_conv, which stay float32
        self._conv = dict(
            n_edge_features=3 * ns, hidden_features=3 * ns, batch_norm=cfg.batch_norm,
            tp_weights_layers=cfg.tp_weights_layers, reference_kernels=reference_kernels,
            dropout=drop, dtype=cfg.compute_dtype, factored=cfg.factored_tp,
            depthwise=cfg.depthwise_convolution,
        )
        npe, n_joint = cfg.num_prot_emb_layers, cfg.num_conv_layers
        if cfg.embed_also_ligand:
            self.lig_emb_layers = nn.ModuleList(
                TPConvLayer(self._ladder(i), sh, self._ladder(i + 1), residual=True, **self._conv)
                for i in range(npe)
            )
        if cfg.confidence_mode:
            self._setup_confidence_heads()
        else:
            self._setup_score_heads(self._ladder(npe + n_joint), reference_kernels)

    def _setup_confidence_heads(self) -> None:
        """The pooled confidence MLP (with ``affinity_prediction``, ns more
        outputs: the per-pose affinity features), the per-atom head of
        ``atom_confidence`` and the pose-set affinity head."""
        cfg = self.cfg
        ns = cfg.ns
        kw = dict(no_batchnorm=cfg.confidence_no_batchnorm, dropout=cfg.confidence_dropout)
        in_dim = ns + self._confidence_extra_dim()
        if cfg.atom_confidence:
            # per-atom head: atom confidences and the ns scalars that replace
            # the pooled ones (reference aa_model.py:188-199)
            self.atom_confidence_predictor = ConfidenceMLP(
                in_dim, ns, cfg.atom_num_confidence_outputs + ns, **kw)
            in_dim = ns
        out_dim = cfg.num_confidence_outputs + (ns if cfg.affinity_prediction else 0)
        self.confidence_predictor = ConfidenceMLP(in_dim, ns, out_dim, **kw)
        if cfg.affinity_prediction:
            self.affinity_predictor = ConfidenceMLP(len(cfg.parallel_aggregators) * ns, ns, 1, **kw)

    def _confidence_extra_dim(self) -> int:
        """The ladder's last block the head reads beside the first ns
        scalars once the stack is 3 layers deep: nv x0o with
        ``reduce_pseudoscalars``, else ns x0o."""
        cfg = self.cfg
        if cfg.num_conv_layers + cfg.num_prot_emb_layers < 3:
            return 0
        return cfg.nv if cfg.reduce_pseudoscalars else cfg.ns

    def _setup_score_heads(self, final_ladder: str, reference_kernels: bool) -> None:
        cfg = self.cfg
        ns, sig, dist, drop, sh = (cfg.ns, cfg.sigma_embed_dim, cfg.distance_embed_dim,
                                   cfg.dropout, self.sh_irreps)
        self.center_distance_expansion = GaussianSmearing(0.0, cfg.center_max_distance, dist)
        self.center_edge_embedding = MLP2(dist + sig, ns, drop)
        self.final_conv = TPConvLayer(
            final_ladder, sh, "1x1o + 1x1e" if cfg.odd_parity else "2x1o + 2x1e",
            n_edge_features=2 * ns, residual=False, batch_norm=cfg.batch_norm,
            tp_weights_layers=cfg.tp_weights_layers, reference_kernels=reference_kernels,
            dropout=drop, factored=cfg.factored_tp,
        )
        self.final_conv.range_name = "center"
        self.tr_final_layer = FinalNormLayer(1 + sig, ns, drop)
        self.rot_final_layer = FinalNormLayer(1 + sig, ns, drop)
        if not cfg.no_torsion:
            self.final_edge_embedding = MLP2(dist, ns, drop)
            self.final_tp_tor = FullTensorProduct(sh, "2e")
            tor_out = f"{ns}x0o" if cfg.odd_parity else f"{ns}x0o + {ns}x0e"
            self.tor_bond_conv = TPConvLayer(
                final_ladder, str(self.final_tp_tor.irreps_out), tor_out,
                n_edge_features=3 * ns, residual=False, batch_norm=cfg.batch_norm,
                tp_weights_layers=cfg.tp_weights_layers, reference_kernels=reference_kernels,
                dropout=drop, factored=cfg.factored_tp,
            )
            self.tor_bond_conv.range_name = "torsion"
            self.tor_final_dense1 = nn.Linear(Irreps(tor_out).dim, ns, bias=False)
            self.tor_final_dense2 = nn.Linear(ns, 1, bias=False)
            self.tor_dropout = Dropout(drop)

    def _ladder(self, i: int) -> str:
        return self.irrep_seq[min(i, len(self.irrep_seq) - 1)]

    def _edge_weight(self, dist, max_norm):
        """Cosine edge-weight ramp (reference ``get_edge_weight``); None
        when smooth_edges is off."""
        if not self.cfg.smooth_edges:
            return None
        x = torch.clamp(dist * math.pi / max_norm, max=math.pi)
        return 0.5 * (torch.cos(x) + 1.0)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Random weights with the flax initializers' scales: Linear and FC
        output kernels normal(0, 1/fan_in), biases zero, embeddings
        Glorot-uniform, equivariant linears normal(0, 1), batch norm at
        identity statistics."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.in_features), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                a = math.sqrt(6.0 / (m.num_embeddings + m.embedding_dim))
                m.weight.uniform_(-a, a, generator=generator)
            elif isinstance(m, FCBlock):
                m.out_kernel.normal_(0.0, 1.0 / math.sqrt(m.out_kernel.shape[0]), generator=generator)
                m.out_bias.zero_()
            elif isinstance(m, IrrepsLinear):
                for w in m.parameters(recurse=False):
                    w.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, (IrrepsBatchNorm, ScalarBatchNorm)):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.weight.fill_(1.0)
                m.bias.zero_()

    def set_generator(self, generator: Optional[torch.Generator]) -> None:
        """The generator every dropout mask of this model draws from."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator

    # ------------------------------------------------------------------
    # receptor embedding (time-independent; compute once per complex)
    # ------------------------------------------------------------------
    def embed_receptor(self, data: ComplexData) -> RecCache:
        """The receptor embedding of one complex (fields (NR, ...)) or of a
        stacked batch (fields (B, NR, ...))."""
        if _is_batched(data):
            return self._embed_receptor(data)
        return RecCache(*[None if a is None else a[0] for a in self._embed_receptor(_batched(data))])

    def _embed_receptor(self, db: ComplexData) -> RecCache:
        cfg = self.cfg
        ns = cfg.ns
        rec_scalar = db.rec_lm if cfg.lm_embedding_dim > 0 else None
        node_attr = self.rec_node_embedding(db.rec_cat, rec_scalar)  # (B, NR, F)

        vec = gather_nodes(db.rec_pos, db.rec_nbr) - db.rec_pos[:, :, None, :]
        dist = torch.linalg.norm(vec, dim=-1)
        edge_attr = self.rec_edge_embedding(self.rec_distance_expansion(dist))
        edge_sh = spherical_harmonics(vec, cfg.sh_lmax)
        edge_weight = self._edge_weight(dist, cfg.rec_max_radius)

        for layer in self.rec_emb_layers:
            block = NeighborBlock(
                sender_attr=node_attr, nbr_idx=db.rec_nbr, nbr_mask=db.rec_nbr_mask,
                edge_attr=edge_scalars(ns, node_attr, node_attr, edge_attr, db.rec_nbr),
                edge_sh=edge_sh, edge_weight=edge_weight,
            )
            node_attr = layer(node_attr, [block], db.rec_mask)
        return RecCache(node_attr=node_attr, edge_attr=edge_attr, edge_sh=edge_sh,
                        edge_weight=edge_weight)

    def _rec_rec_block(self, db, rec_node_attr, rec_edge_attr_base, rec_cache) -> NeighborBlock:
        return NeighborBlock(
            sender_attr=rec_node_attr, nbr_idx=db.rec_nbr, nbr_mask=db.rec_nbr_mask,
            edge_attr=edge_scalars(self.cfg.ns, rec_node_attr, rec_node_attr, rec_edge_attr_base, db.rec_nbr),
            edge_sh=rec_cache.edge_sh, edge_weight=rec_cache.edge_weight,
        )

    def _sigma_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """(B,) times -> (B, sigma_embed_dim)."""
        return self.timestep_emb(t.to(torch.float32))

    def _rec_step_attr(self, rec_cache: RecCache, sigma_emb: torch.Tensor):
        """Receptor node features and edge base for one step (the cached
        embedding plus the sigma conditioning, reference cg_model.py:297-301);
        ``rec_cache`` batched, ``sigma_emb`` (B, sig)."""
        ns = self.cfg.ns
        rec_sigma = self.rec_sigma_embedding(sigma_emb)[:, None]  # (B, 1, ns)
        node = rec_cache.node_attr
        node = torch.cat([node[..., :ns] + rec_sigma, node[..., ns:]], dim=-1)
        return node, rec_cache.edge_attr + rec_sigma[:, :, None]

    def step_cache(self, data: ComplexData, t: torch.Tensor, rec_cache: RecCache):
        """Pose-independent per-(complex, step) precompute: the joint layer-0
        rec<-rec factored message, (sum (1, NR, D), counts (1, NR)); None,
        as in the JAX model, when there is no non-last joint layer or its
        convs are not factored (``factored_tp=False``, depthwise)."""
        cfg = self.cfg
        if cfg.num_conv_layers <= 1 or not cfg.factored_tp or cfg.depthwise_convolution:
            return None
        with profiler_range("step_cache"):
            db, cache = _batched(data), _batched(rec_cache)
            t = torch.as_tensor(t, dtype=torch.float32, device=db.rec_pos.device).reshape(1)
            rec_node_attr, rec_edge_attr_base = self._rec_step_attr(cache, self._sigma_embedding(t))
            block = self._rec_rec_block(db, rec_node_attr, rec_edge_attr_base, cache)
            (part,) = self.conv_layers[0].rec_messages([block], (2,))
        return part

    # ------------------------------------------------------------------
    # ligand embedding (per step: positions and sigma change)
    # ------------------------------------------------------------------
    def _ligand_graph(self, db, lig_pos, sigma_emb):
        """Geometry-dependent ligand edge structure, computed once per
        forward; layers only refresh node scalars."""
        cfg = self.cfg
        P, nl = lig_pos.shape[:2]

        # bonded block (static topology, dynamic geometry)
        bvec = gather_nodes(lig_pos, db.lig_bond_nbr) - lig_pos[:, :, None, :]  # (P, NL, KB, 3)
        bdist = torch.linalg.norm(bvec, dim=-1)
        bond_raw = torch.cat(
            [
                db.lig_bond_attr.expand(bdist.shape + db.lig_bond_attr.shape[-1:]),
                _per_edge(sigma_emb, bdist.shape),
                self.lig_distance_expansion(bdist),
            ],
            dim=-1,
        )
        bond_attr = self.lig_edge_embedding(bond_raw)
        bond_sh = spherical_harmonics(bvec, cfg.sh_lmax)

        # all-pairs radius block (the reference's per-step radius_graph)
        rvec, rdist = _pairwise(lig_pos, lig_pos)  # (P, NL, NL, ...)
        eye = torch.eye(nl, dtype=torch.bool, device=lig_pos.device)
        rmask = (
            (rdist <= cfg.lig_max_radius)
            & ~eye
            & db.lig_mask[:, :, None]
            & db.lig_mask[:, None, :]
        )
        radius_raw = torch.cat(
            [
                rdist.new_zeros(rdist.shape + (cfg.in_lig_edge_features,)),
                _per_edge(sigma_emb, rdist.shape),
                self.lig_distance_expansion(rdist),
            ],
            dim=-1,
        )
        radius_attr = self.lig_edge_embedding(radius_raw)
        radius_sh = spherical_harmonics(rvec, cfg.sh_lmax)
        bond_idx = db.lig_bond_nbr.expand((P,) + db.lig_bond_nbr.shape[1:])
        all_idx = torch.arange(nl, device=lig_pos.device).expand(P, nl, nl)
        bond_w = self._edge_weight(bdist, cfg.lig_max_radius)
        radius_w = self._edge_weight(rdist, cfg.lig_max_radius)
        return (bond_attr, bond_sh, bond_idx, radius_attr, radius_sh, rmask, all_idx,
                bond_w, radius_w)

    def _lig_blocks_from_graph(self, db, graph, node_attr):
        ns = self.cfg.ns
        (bond_attr, bond_sh, bond_idx, radius_attr, radius_sh, rmask, all_idx,
         bond_w, radius_w) = graph
        bond_block = NeighborBlock(
            sender_attr=node_attr, nbr_idx=bond_idx,
            nbr_mask=db.lig_bond_mask.expand(bond_idx.shape),
            edge_attr=edge_scalars(ns, node_attr, node_attr, bond_attr, bond_idx),
            edge_sh=bond_sh, edge_weight=bond_w,
        )
        radius_block = NeighborBlock(
            sender_attr=node_attr, nbr_idx=all_idx, nbr_mask=rmask,
            edge_attr=edge_scalars(ns, node_attr, node_attr, radius_attr, all_idx),
            edge_sh=radius_sh, edge_weight=radius_w,
        )
        return bond_block, radius_block

    def _embed_ligand(self, db, lig_graph, sigma_emb, n_poses):
        nl = db.lig_cat.shape[1]
        node_scalar = sigma_emb[:, None, :].expand(sigma_emb.shape[0], nl, sigma_emb.shape[-1])
        node_attr = self.lig_node_embedding(db.lig_cat, node_scalar)
        node_attr = node_attr.expand((n_poses,) + node_attr.shape[1:])
        if self.cfg.embed_also_ligand:
            for layer in self.lig_emb_layers:
                bond_block, radius_block = self._lig_blocks_from_graph(db, lig_graph, node_attr)
                node_attr = layer(node_attr, [bond_block, radius_block], db.lig_mask)
        return node_attr

    # ------------------------------------------------------------------
    # full forward
    # ------------------------------------------------------------------
    def forward(
        self,
        data: ComplexData,
        lig_pos: torch.Tensor,
        t: torch.Tensor,
        so3_tables: Optional[SO3Tables] = None,
        torus_tables: Optional[TorusTables] = None,
        rec_cache: Optional[RecCache] = None,
        step_cache=None,
        rec_keep: Optional[torch.Tensor] = None,
    ):
        """Scores (:class:`ScoreOutput`) or, in confidence mode, confidence
        outputs (see :meth:`_confidence_head`; the tables are then unused)
        for a batch of poses ``lig_pos`` (P, NL, 3).

        Docking: ``data`` is one complex (fields (NL, ...), (NR, ...)), the
        P poses are poses of it and ``t`` is 0-d; ``rec_cache`` and
        ``step_cache`` (:meth:`embed_receptor`, :meth:`step_cache`) may be
        precomputed. Training: ``data`` is a stacked batch of P complexes
        (fields (P, ...)), pose p belongs to complex p and ``t`` is (P,); the
        receptor embedding and the layer-0 rec<-rec message are computed
        inline, under autograd (the JAX trainer's ``vmap`` over complexes).
        ``rec_keep`` (NR,) bool: the receptor crop of ``crop_beyond``
        (:func:`~diffdock_tpu_torch.data.complexes.apply_rec_keep`) for one
        complex, or (P, NR) for each complex of a training batch; the
        receptor embedding is then computed under the crop, so
        ``rec_cache`` and ``step_cache`` must be None."""
        cfg = self.cfg
        ns = cfg.ns
        P, nl = lig_pos.shape[:2]
        with profiler_range("embed"):
            if rec_keep is not None:
                if rec_cache is not None or step_cache is not None:
                    raise ValueError("rec_keep recomputes the receptor embedding: "
                                     "pass no rec_cache or step_cache")
                data = apply_rec_keep(data, rec_keep)
            batched = _is_batched(data)
            db = data if batched else _batched(data)
            nr = db.rec_pos.shape[1]
            t = torch.as_tensor(t, dtype=torch.float32, device=lig_pos.device).reshape(-1)
            tr_sigma, rot_sigma, tor_sigma = self._sigmas(t)
            sigma_emb = self._sigma_embedding(t)  # (B, sig)

            if rec_cache is None:
                rec_cache = self._embed_receptor(db)
            elif not batched:
                rec_cache = _batched(rec_cache)
            rec_node_attr, rec_edge_attr_base = self._rec_step_attr(rec_cache, sigma_emb)

            lig_graph = self._ligand_graph(db, lig_pos, sigma_emb)
            lig_node_attr = self._embed_ligand(db, lig_graph, sigma_emb, P)

            # cross graph (dynamic cutoff, reference cg_model.py:321-324)
            cross_cutoff = ((tr_sigma * 3.0 + 20.0)[:, None, None] if cfg.dynamic_max_cross
                            else cfg.cross_max_distance)
            cvec, cdist = _pairwise(db.rec_pos, lig_pos)  # (P, NL, NR, ...)
            cmask = (cdist <= cross_cutoff) & db.lig_mask[:, :, None] & db.rec_mask[:, None, :]
            cross_raw = torch.cat(
                [_per_edge(sigma_emb, cdist.shape), self.cross_distance_expansion(cdist)], dim=-1
            )
            cross_attr = self.cross_edge_embedding(cross_raw)
            cross_sh = spherical_harmonics(cvec, cfg.sh_lmax)
            rev_cross_sh = spherical_harmonics(-cvec.transpose(1, 2), cfg.sh_lmax)
            cross_w = self._edge_weight(cdist, cross_cutoff)
            rev_cross_w = None if cross_w is None else cross_w.transpose(1, 2)
            rec_idx_all = torch.arange(nr, device=lig_pos.device).expand(P, nl, nr)
            lig_idx_all = torch.arange(nl, device=lig_pos.device).expand(P, nr, nl)

        for li, layer in enumerate(self.conv_layers):
            with profiler_range(f"conv{li}"):
                bond_block, radius_block = self._lig_blocks_from_graph(db, lig_graph, lig_node_attr)
                lig_cross_block = NeighborBlock(
                    sender_attr=rec_node_attr, nbr_idx=rec_idx_all, nbr_mask=cmask,
                    edge_attr=edge_scalars(ns, lig_node_attr, rec_node_attr, cross_attr, rec_idx_all),
                    edge_sh=cross_sh, edge_weight=cross_w,
                )
                lig_blocks = [bond_block, radius_block, lig_cross_block]
                lig_groups = (0, 0, 1)

                rec_extra = None
                if li < len(self.conv_layers) - 1:
                    rec_cross_block = NeighborBlock(
                        sender_attr=lig_node_attr, nbr_idx=lig_idx_all,
                        nbr_mask=cmask.transpose(1, 2),
                        edge_attr=edge_scalars(ns, rec_node_attr, lig_node_attr,
                                               cross_attr.transpose(1, 2), lig_idx_all),
                        edge_sh=rev_cross_sh, edge_weight=rev_cross_w,
                    )
                    if li == 0 and step_cache is not None:
                        rec_blocks, rec_groups, rec_extra = [rec_cross_block], (3,), step_cache
                    else:
                        rec_rec_block = self._rec_rec_block(
                            db, rec_node_attr, rec_edge_attr_base, rec_cache
                        )
                        rec_blocks, rec_groups = [rec_rec_block, rec_cross_block], (2, 3)
                else:
                    rec_blocks, rec_groups = [], ()

                lig_node_attr, rec_node_attr = layer(
                    lig_node_attr, rec_node_attr, lig_blocks, lig_groups,
                    rec_blocks, rec_groups, rec_extra=rec_extra,
                    lig_mask=db.lig_mask, rec_mask=db.rec_mask,
                )
        with profiler_range("heads"):
            out = self._heads(db, lig_pos, lig_node_attr, sigma_emb, (tr_sigma, rot_sigma, tor_sigma),
                              so3_tables, torus_tables)
            if cfg.sidechain_pred and not cfg.confidence_mode:
                sc = self.sidechain_predictor(rec_node_attr)
                out = out._replace(sidechain=sc[..., :10] + sc[..., 10:])
        return out

    def _sigmas(self, t: torch.Tensor):
        """(tr, rot, tor) sigmas of the times ``t`` (B,): in confidence mode
        each is ``t`` itself."""
        if self.cfg.confidence_mode:
            return t, t, t
        return t_to_sigma(t, t, t, self.cfg.sigma)

    def _heads(self, db, lig_pos, lig_node_attr, sigma_emb, sigmas, so3_tables, torus_tables):
        """The confidence head in confidence mode, else the score heads."""
        if self.cfg.confidence_mode:
            return self._confidence_head(db, lig_node_attr)
        tr_sigma, rot_sigma, tor_sigma = sigmas
        P = lig_pos.shape[0]
        tr_pred, rot_pred = self._center_head(
            db, lig_pos, lig_node_attr, sigma_emb, tr_sigma, rot_sigma, so3_tables
        )
        nb = db.rot_u.shape[1]
        if self.cfg.no_torsion or nb == 0:
            tor_pred = lig_pos.new_zeros(P, nb)
        else:
            tor_pred = self._torsion_head(db, lig_pos, lig_node_attr, tor_sigma, torus_tables)
        return ScoreOutput(tr=tr_pred, rot=rot_pred, tor=tor_pred)

    # ------------------------------------------------------------------
    def _confidence_head(self, db, lig_node_attr):
        """(P, num_confidence_outputs [+ ns affinity features]) from the
        ligand's scalar channels (the first ns, plus the ladder's last block
        once 3 layers deep) mean-pooled over its real atoms; with
        ``atom_confidence`` the tuple (that, per-atom confidences (P, NL,
        atom_num_confidence_outputs)), the per-atom head's ns further
        outputs replacing the pooled scalars, as the JAX model returns it."""
        cfg = self.cfg
        ns = cfg.ns
        extra = self._confidence_extra_dim()
        scalar = lig_node_attr[..., :ns]
        if extra:
            scalar = torch.cat([scalar, lig_node_attr[..., -extra:]], dim=-1)
        atom_conf = None
        if cfg.atom_confidence:
            z = self.atom_confidence_predictor(scalar)
            k = cfg.atom_num_confidence_outputs
            atom_conf, scalar = z[..., :k], z[..., k:]
        w = db.lig_mask[..., None].to(scalar.dtype)  # (B, NL, 1)
        pooled = (scalar * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
        out = self.confidence_predictor(pooled)
        return out if atom_conf is None else (out, atom_conf)

    def predict_affinity(self, pose_feats: torch.Tensor) -> torch.Tensor:
        """One affinity (0-d) for a pose set: the per-pose affinity features
        ``pose_feats`` (P, ns), the confidence head's outputs after the
        first ``num_confidence_outputs``, aggregated over the poses (mean,
        max, min, population std, in ``parallel_aggregators`` order) and
        regressed (reference ``aa_model.py:16-19,448-454``)."""
        aggs = {"mean": lambda x: x.mean(0), "max": lambda x: x.max(0).values,
                "min": lambda x: x.min(0).values, "std": lambda x: x.std(0, unbiased=False)}
        feats = torch.cat([aggs[a](pose_feats) for a in self.cfg.parallel_aggregators])
        return self.affinity_predictor(feats[None])[0, 0]

    # ------------------------------------------------------------------
    def _center_head(self, db, lig_pos, lig_node_attr, sigma_emb, tr_sigma, rot_sigma,
                     so3_tables):
        cfg = self.cfg
        ns = cfg.ns
        P, nl = lig_pos.shape[:2]
        w = db.lig_mask[:, :, None].to(lig_pos.dtype)
        center = (lig_pos * w).sum(1) / torch.clamp(w.sum(1), min=1.0)  # (P, 3)

        evec = lig_pos - center[:, None]  # sender (atom) - receiver (center)
        dist = torch.linalg.norm(evec, dim=-1)  # (P, NL)
        edge_attr = torch.cat(
            [self.center_distance_expansion(dist), _per_edge(sigma_emb, dist.shape)], dim=-1
        )
        edge_attr = self.center_edge_embedding(edge_attr)
        if cfg.fixed_center_conv:
            scalars = lig_node_attr[..., :ns]
        else:
            # reference quirk (cg_model.py:374): atom 0's features for all
            scalars = lig_node_attr[:, :1, :ns].expand(P, nl, ns)
        edge_attr = torch.cat([edge_attr, scalars], dim=-1)

        block = NeighborBlock(
            sender_attr=lig_node_attr,
            nbr_idx=torch.arange(nl, device=lig_pos.device).expand(P, 1, nl),
            nbr_mask=db.lig_mask[:, None, :].expand(P, 1, nl),
            edge_attr=edge_attr[:, None],
            edge_sh=spherical_harmonics(evec, cfg.sh_lmax)[:, None],
        )
        global_pred = self.final_conv(None, [block])[:, 0]  # (P, D)

        if cfg.odd_parity:
            tr_pred = irrep1_to_vector(global_pred[:, :3])
            rot_pred = irrep1_to_vector(global_pred[:, 3:6])
        else:
            tr_pred = irrep1_to_vector(global_pred[:, :3] + global_pred[:, 6:9])
            rot_pred = irrep1_to_vector(global_pred[:, 3:6] + global_pred[:, 9:12])

        sig = sigma_emb.expand(P, sigma_emb.shape[-1])
        tr_norm = torch.linalg.norm(tr_pred, dim=-1, keepdim=True)
        tr_pred = tr_pred / torch.clamp(tr_norm, min=1e-12) * self.tr_final_layer(
            torch.cat([tr_norm, sig], dim=-1)
        )
        rot_norm = torch.linalg.norm(rot_pred, dim=-1, keepdim=True)
        rot_pred = rot_pred / torch.clamp(rot_norm, min=1e-12) * self.rot_final_layer(
            torch.cat([rot_norm, sig], dim=-1)
        )
        if cfg.scale_by_sigma:
            tr_pred = tr_pred / tr_sigma[:, None]
            rot_pred = rot_pred * so3_tables.score_norm(rot_sigma)[:, None]
        return tr_pred, rot_pred

    # ------------------------------------------------------------------
    def _torsion_head(self, db, lig_pos, lig_node_attr, tor_sigma, torus_tables):
        cfg = self.cfg
        ns = cfg.ns
        P, nl = lig_pos.shape[:2]
        nb = db.rot_u.shape[1]

        pos_u, pos_v = _take(lig_pos, db.rot_u), _take(lig_pos, db.rot_v)  # (P, B, 3)
        bond_pos = 0.5 * (pos_u + pos_v)
        evec, dist = _pairwise(lig_pos, bond_pos)  # (P, B, NL, ...)
        mask = (
            (dist <= cfg.lig_max_radius)
            & db.lig_mask[:, None, :]
            & db.rot_mask[:, :, None]
        )
        edge_attr = self.final_edge_embedding(self.lig_distance_expansion(dist))

        bond_sh2e = spherical_harmonics(pos_v - pos_u, 2)[..., 4:9]  # (P, B, 5)
        edge_sh = spherical_harmonics(evec, cfg.sh_lmax)
        tor_edge_sh = self.final_tp_tor(edge_sh, bond_sh2e[:, :, None, :])

        bond_attr = _take(lig_node_attr, db.rot_u) + _take(lig_node_attr, db.rot_v)  # (P, B, F)
        send = lig_node_attr[:, None, :, :ns].expand(P, nb, nl, ns)
        recv = bond_attr[:, :, None, :ns].expand(P, nb, nl, ns)
        full_edge_attr = torch.cat([edge_attr, send, recv], dim=-1)

        block = NeighborBlock(
            sender_attr=lig_node_attr,
            nbr_idx=torch.arange(nl, device=lig_pos.device).expand(P, nb, nl),
            nbr_mask=mask,
            edge_attr=full_edge_attr,
            edge_sh=tor_edge_sh,
            edge_weight=self._edge_weight(dist, cfg.lig_max_radius),
        )
        out = self.tor_bond_conv(None, [block], db.rot_mask)  # (P, B, D)
        out = self.tor_dropout(torch.tanh(self.tor_final_dense1(out)))
        tor_pred = self.tor_final_dense2(out)[..., 0]
        if cfg.scale_by_sigma:
            tor_pred = tor_pred * torch.sqrt(torus_tables.score_norm(tor_sigma))[:, None]
        return tor_pred * db.rot_mask


def _is_batched(data: ComplexData) -> bool:
    return data.lig_cat.dim() == 3


def _batched(x):
    """A one-complex ComplexData or RecCache with a leading axis of 1."""
    return type(x)(*[None if a is None else a[None] for a in x])


def _per_edge(sigma_emb: torch.Tensor, shape) -> torch.Tensor:
    """(B, sig) -> ``shape`` + (sig,), the first axis broadcast from B."""
    view = sigma_emb.reshape((sigma_emb.shape[0],) + (1,) * (len(shape) - 1) + sigma_emb.shape[-1:])
    return view.expand(tuple(shape) + sigma_emb.shape[-1:])


def edge_scalars(ns: int, recv_attr, send_attr, base, send_idx, swap: bool = False) -> torch.Tensor:
    """Edge features (base, receiver scalars, sender scalars): the first
    ns channels of the receiver and of each gathered sender after the
    base features; ``swap`` orders them (base, sender, receiver), the old
    CG lig->rec quirk. ``recv_attr`` (B, R, F), ``send_attr`` (B, S, F),
    ``base`` (B, R, K, E), ``send_idx`` (B, R, K); a B of 1 broadcasts."""
    send = gather_nodes(send_attr[..., :ns], send_idx)  # (B, R, K, ns)
    lead = torch.broadcast_shapes(send.shape[:-1], base.shape[:-1], recv_attr.shape[:-1] + (1,))
    recv = recv_attr[:, :, None, :ns].expand(lead + (ns,))
    send = send.expand(lead + (ns,))
    parts = [base.expand(lead + base.shape[-1:])] + ([send, recv] if swap else [recv, send])
    return torch.cat(parts, dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, F), idx (B, M) -> (B, M, F), each row's own indices."""
    return gather_nodes(x, idx[..., None])[:, :, 0]
