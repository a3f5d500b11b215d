"""Model factory (port of ``diffdock_tpu/models/factory.py``; reference
``utils/utils.py:172-281`` ``get_model``)."""

from __future__ import annotations

from torch import nn

from diffdock_tpu_torch.models.config import ScoreModelConfig


def build_model(cfg: ScoreModelConfig, reference_kernels: bool = False) -> nn.Module:
    """Coarse-grained or all-atom x new or old (v1.0) architecture, by
    config, like the reference factory's four-way dispatch
    (``utils/utils.py:179-224``). ``reference_kernels=True`` routes every
    merged TP contraction through the kernel's plain version."""
    if cfg.old_architecture:
        from diffdock_tpu_torch.models.old_models import OldAAScoreModel, OldCGScoreModel

        cls = OldAAScoreModel if cfg.all_atoms else OldCGScoreModel
    elif cfg.all_atoms:
        from diffdock_tpu_torch.models.aa_model import AAScoreModel

        cls = AAScoreModel
    else:
        from diffdock_tpu_torch.models.score_model import CGScoreModel

        cls = CGScoreModel
    return cls(cfg, reference_kernels=reference_kernels)
