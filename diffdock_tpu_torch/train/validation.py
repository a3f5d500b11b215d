"""In-training validation (port of ``diffdock_tpu/train/validation.py``):
reduce-on-plateau LR control and validation docking (reference
``inference_epoch_fix``, ``utils/training.py:265-340``): reverse diffusion
on a few validation complexes, reporting the fraction with RMSD under
2 / 5 A, the early-stopping metric the reference selects models by.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class PlateauScheduler:
    """Host-side reduce-on-plateau LR control (the reference uses torch's
    ReduceLROnPlateau). Call ``step(metric)`` each epoch and write the
    resulting ``scale`` into ``TrainState.lr_scale``: the train step
    multiplies the optimizer's update by it, which is exactly an LR
    multiplier."""

    def __init__(self, mode: str = "min", factor: float = 0.7, patience: int = 20,
                 min_lr: float = 1e-6):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        improved = (
            self.best is None
            or (self.mode == "min" and metric < self.best - 1e-8)
            or (self.mode == "max" and metric > self.best + 1e-8)
        )
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale


def inference_epoch(pipeline, datas: Dict[str, object], num_complexes: int = 20,
                    samples_per_complex: int = 4, seed: int = 0) -> Dict[str, float]:
    """Dock up to ``num_complexes`` validation complexes (numpy
    ComplexData, receptor-centred) with ``pipeline``
    (:class:`diffdock_tpu_torch.inference.pipeline.DockingPipeline`) and
    return rmsds_lt2/lt5 of the best-RMSD and of the top-ranked pose per
    complex (the reference's valinf metrics). A complex whose dock raises
    is skipped, as in the JAX package."""
    names = list(datas.keys())[:num_complexes]
    mins, top1s = [], []
    for i, name in enumerate(names):
        data = datas[name]
        try:
            res = pipeline.dock_complex(data, num_poses=samples_per_complex, seed=seed + i)
        except Exception:  # noqa: BLE001 — skip-and-continue
            continue
        ref = np.asarray(data.lig_pos) + np.asarray(data.original_center)
        rmsds = np.sqrt(np.mean(np.sum((res.poses - ref) ** 2, axis=-1), axis=-1))
        mins.append(rmsds.min())
        top1s.append(rmsds[res.order[0]])
    if not mins:
        return {}
    mins, top1s = np.asarray(mins), np.asarray(top1s)
    return {
        "valinf_min_rmsds_lt2": float((mins < 2).mean() * 100),
        "valinf_min_rmsds_lt5": float((mins < 5).mean() * 100),
        "valinf_rmsds_lt2": float((top1s < 2).mean() * 100),
        "valinf_rmsds_lt5": float((top1s < 5).mean() * 100),
        "valinf_median_min_rmsd": float(np.median(mins)),
    }
