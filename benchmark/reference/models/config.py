"""Typed model configuration (copied from ``diffdock_tpu/models/config.py``).

Field names and defaults mirror the reference training args
(``utils/parsing.py:375-405``) so run configs translate one-to-one. The
reference models only the branches the benchmark's configurations run:
:func:`check_supported` refuses the others (a receptor crop, the
auxiliary heads, depthwise or per-edge convolutions, the Fourier time
embedding), which a later configuration brings with its own copy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from benchmark.reference.diffusion.schedules import SigmaConfig


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

    # sigma-dependent receptor crop (reference crop_beyond): None only
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

    # the auxiliary heads (binding affinity, per-atom confidence, sidechain
    # prediction): off only
    affinity_prediction: bool = False
    parallel_aggregators: Tuple[str, ...] = ("mean", "max", "min", "std")
    atom_confidence: bool = False
    atom_num_confidence_outputs: int = 1
    sidechain_pred: bool = False

    # grouped conv FCs per edge type (reference differentiate_convolutions)
    differentiate_convolutions: bool = True

    # 'uvu' depthwise tensor-product convolutions: off only
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
    # applying weight tensors); the per-edge path is not copied: True only
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
        from benchmark.reference.data.features import LIG_CATEGORICAL_DIMS

        return LIG_CATEGORICAL_DIMS

    @property
    def rec_node_categorical_dims(self) -> Tuple[int, ...]:
        # reference rec_residue_feature_dims (datasets/process_mols.py:85-87)
        from benchmark.reference.data.features import REC_CATEGORICAL_DIMS

        return REC_CATEGORICAL_DIMS


# the fields the reference models at one value only, with that value
ONLY = dict(crop_beyond=None, embedding_type="sinusoidal", affinity_prediction=False, atom_confidence=False,
            sidechain_pred=False, depthwise_convolution=False, factored_tp=True)


def check_supported(cfg: ScoreModelConfig) -> None:
    """Refuse a configuration that takes a branch the reference lacks."""
    off = {k: getattr(cfg, k) for k, v in ONLY.items() if getattr(cfg, k) != v}
    if off:
        raise ConfigError(f"the reference does not model {off}: it has {ONLY}")
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ConfigError(f"compute_dtype={cfg.compute_dtype}: float32 or bfloat16")
