"""Typed model configuration (copied from ``diffdock_tpu/models/config.py``).

Field names and defaults mirror the reference training args
(``utils/parsing.py:375-405``) so run configs translate one-to-one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from diffdock_tpu_torch.diffusion.schedules import SigmaConfig


class ConfigError(ValueError):
    """A model configuration requests an unsupported feature combination."""


@dataclasses.dataclass(frozen=True)
class ScoreModelConfig:
    # representation sizes
    ns: int = 16
    nv: int = 4
    num_conv_layers: int = 2
    num_prot_emb_layers: int = 0
    sh_lmax: int = 2
    use_second_order_repr: bool = False
    reduce_pseudoscalars: bool = False
    embed_also_ligand: bool = True

    # graph cutoffs
    lig_max_radius: float = 5.0
    rec_max_radius: float = 30.0
    cross_max_distance: float = 80.0
    dynamic_max_cross: bool = False
    center_max_distance: float = 30.0

    # sigma-dependent receptor crop (reference crop_beyond,
    # utils/utils.py:388-413; sampling.py:104-109 crops at 3*tr_sigma +
    # crop_beyond for the score model, plain crop_beyond for the confidence
    # model). TPU-native realization: the reference FILTERS existing edges
    # (PyG subgraph) rather than rebuilding them, so cropping is exactly a
    # receptor validity mask — computed per step inside jit (see
    # ``rec_keep`` in the model __call__ and the sampler/pipeline wiring).
    crop_beyond: Optional[float] = None

    # embeddings
    in_lig_edge_features: int = 4
    sigma_embed_dim: int = 32
    distance_embed_dim: int = 32
    cross_distance_embed_dim: int = 32
    embedding_type: str = "sinusoidal"
    embedding_scale: float = 1000.0
    lm_embedding_dim: int = 0  # 1280 when ESM embeddings are used

    # regularization / numerics
    batch_norm: bool = True
    dropout: float = 0.0
    tp_weights_layers: int = 2
    smooth_edges: bool = False
    odd_parity: bool = False

    # heads
    no_torsion: bool = False
    scale_by_sigma: bool = True
    fixed_center_conv: bool = True
    confidence_mode: bool = False
    confidence_dropout: float = 0.0
    confidence_no_batchnorm: bool = False
    num_confidence_outputs: int = 1

    # experimental binding-affinity head (reference aa_model.py:176-225,
    # 448-454 + utils/sampling.py:243-268): the confidence head emits ns
    # extra per-pose features which are aggregated over the pose set
    # (mean/max/min/std) and regressed to one affinity per complex
    affinity_prediction: bool = False
    parallel_aggregators: Tuple[str, ...] = ("mean", "max", "min", "std")

    # per-ligand-atom confidence outputs alongside the pose confidence
    # (reference atom_confidence, aa_model.py:188-199,438-446)
    atom_confidence: bool = False
    atom_num_confidence_outputs: int = 1

    # per-residue sidechain/backbone prediction head feeding the auxiliary
    # losses (reference sidechain_pred, cg_model.py:173-179; enabled when
    # sidechain_loss_weight or backbone_loss_weight > 0, utils/utils.py:274)
    sidechain_pred: bool = False

    # grouped conv FCs per edge type (reference differentiate_convolutions)
    differentiate_convolutions: bool = True

    # 'uvu' depthwise tensor-product convolutions + equivariant linear
    # (reference depthwise_convolution, tensor_layers.py:248-292): far fewer
    # TP weights per edge; applies to the ladder convs only
    depthwise_convolution: bool = False

    # v1.0 (ICLR'23) architecture family: separate conv stacks per edge type,
    # sigma embedded through the node encoders, no protein-embedding layers
    # (reference models/old_cg_model.py, old_aa_model.py). The shipped
    # default confidence model is the OLD all-atom architecture
    # (inference.py:84 --old_confidence_model default True).
    old_architecture: bool = False
    # additive scalar encoder of the v1.0 family (utils/utils.py:218
    # defaults use_old_atom_encoder=True for old checkpoints)
    use_old_atom_encoder: bool = True

    # vmap/shard_map axis names over which batch-norm statistics aggregate
    # during training (set by the trainer; empty for inference)
    bn_axis_names: Tuple[str, ...] = ()

    # factored tensor-product convolutions (reduce over neighbors before
    # applying weight tensors) — exact reassociation, much faster on TPU;
    # the naive per-edge path is kept for cross-validation
    factored_tp: bool = True

    # all-atom receptor (third node set; reference model factory picks the
    # AAModel when all_atoms, utils/utils.py:172-281)
    all_atoms: bool = False

    # compute dtype for conv-layer contractions (params and batch norm stay
    # float32; accumulations use float32). 'bfloat16' halves HBM traffic on
    # the dominant edge tensors.
    compute_dtype: str = "float32"

    sigma: SigmaConfig = SigmaConfig()

    @property
    def lig_node_categorical_dims(self) -> Tuple[int, ...]:
        # reference lig_feature_dims (datasets/process_mols.py:59-76)
        from diffdock_tpu_torch.data.featurize import LIG_CATEGORICAL_DIMS

        return LIG_CATEGORICAL_DIMS

    @property
    def rec_node_categorical_dims(self) -> Tuple[int, ...]:
        # reference rec_residue_feature_dims (datasets/process_mols.py:85-87)
        from diffdock_tpu_torch.data.featurize import REC_CATEGORICAL_DIMS

        return REC_CATEGORICAL_DIMS


# Model presets. `diffdock_s` matches the reference's default training args;
# `diffdock_l` matches the published DiffDock-L scale (arXiv:2402.18396;
# large score model: ns=48, nv=10, 3 protein-embedding + 3 joint conv layers,
# dynamic cross cutoff, ESM embeddings).
PRESETS = {
    "diffdock_s": ScoreModelConfig(),
    "diffdock_l": ScoreModelConfig(
        ns=48,
        nv=10,
        num_conv_layers=3,
        num_prot_emb_layers=3,
        dynamic_max_cross=True,
        cross_max_distance=250.0,
        lm_embedding_dim=1280,
        use_second_order_repr=False,
        reduce_pseudoscalars=True,
        embed_also_ligand=True,
        sigma=SigmaConfig(tr_sigma_max=19.0),
    ),
}
