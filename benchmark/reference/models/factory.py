"""Model factory (port of ``diffdock_tpu/models/factory.py``; reference
``utils/utils.py:172-281`` ``get_model``)."""

from __future__ import annotations

from torch import nn

from benchmark.reference.models.config import ScoreModelConfig


def build_model(cfg: ScoreModelConfig, reference_kernels: bool = False) -> nn.Module:
    """Coarse-grained or all-atom x new or old (v1.0) architecture, by
    config, like the reference factory's four-way dispatch
    (``utils/utils.py:179-224``). ``reference_kernels=True`` routes every
    merged TP contraction through the kernel's plain version."""
    if cfg.old_architecture:
        from benchmark.reference.models.old_models import OldAAScoreModel, OldCGScoreModel

        cls = OldAAScoreModel if cfg.all_atoms else OldCGScoreModel
    elif cfg.all_atoms:
        raise ValueError("the benchmark's reference has no new-architecture all-atom model")
    else:
        from benchmark.reference.models.score_model import CGScoreModel

        cls = CGScoreModel
    return cls(cfg, reference_kernels=reference_kernels)
