"""Docking metric tables (port of ``diffdock_tpu/eval/metrics.py``; the
reference's ``evaluate.py:589-759``).

Given per-complex pose RMSDs in confidence order, the standard table:
top-1/top-5/top-10 x % RMSD < 2 and 5 A, median RMSD, centroid distances,
run times, gnina rescoring columns and the steric-clash proxy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DockingMetrics:
    rmsds: np.ndarray  # (C, P) confidence-ordered per complex
    centroid_distances: Optional[np.ndarray] = None  # (C, P)
    run_times: Optional[np.ndarray] = None  # (C,)

    def table(self) -> Dict[str, float]:
        return compute_metric_table(
            self.rmsds, self.centroid_distances, self.run_times
        )


def compute_metric_table(
    rmsds: np.ndarray,
    centroid_distances: Optional[np.ndarray] = None,
    run_times: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """rmsds: (C, P) with poses per complex already ordered best-confidence
    first (matching the reference's 'filtered' ordering)."""
    rmsds = np.asarray(rmsds)
    out: Dict[str, float] = {}
    top1 = rmsds[:, 0]
    out["rmsds_below_2"] = float((top1 < 2.0).mean() * 100)
    out["rmsds_below_5"] = float((top1 < 5.0).mean() * 100)
    out["rmsds_median"] = float(np.median(top1))
    for k in (5, 10):
        if rmsds.shape[1] >= k:
            mink = rmsds[:, :k].min(axis=1)
            out[f"top{k}_rmsds_below_2"] = float((mink < 2.0).mean() * 100)
            out[f"top{k}_rmsds_below_5"] = float((mink < 5.0).mean() * 100)
            out[f"top{k}_rmsds_median"] = float(np.median(mink))
    best = rmsds.min(axis=1)
    out["min_rmsds_below_2"] = float((best < 2.0).mean() * 100)
    out["min_rmsds_below_5"] = float((best < 5.0).mean() * 100)

    out["mean_rmsd"] = float(rmsds.mean())
    for q in (25, 50, 75):
        out[f"rmsds_percentile_{q}"] = float(np.percentile(top1, q))

    if centroid_distances is not None:
        cd = np.asarray(centroid_distances)[:, 0]
        out["centroid_below_2"] = float((cd < 2.0).mean() * 100)
        out["centroid_below_5"] = float((cd < 5.0).mean() * 100)
        out["centroid_median"] = float(np.median(cd))
    if run_times is not None:
        # failed complexes carry a NaN sentinel so per-complex arrays stay
        # index-aligned with names.npy; exclude them from runtime stats
        rt = np.asarray(run_times, dtype=np.float64)
        rt = rt[np.isfinite(rt)]
        out["run_times_mean"] = float(np.mean(rt)) if rt.size else float("nan")
        out["run_times_std"] = float(np.std(rt)) if rt.size else float("nan")
    return out


def gnina_metric_table(
    gnina_rmsds: np.ndarray, gnina_scores: np.ndarray
) -> Dict[str, float]:
    """gnina rescoring columns (reference ``evaluate.py:609-625``):
    pooled and min-over-optimized-poses hit rates, plus the hit rate of the
    single pose the CNNscore ranks best ('filtered')."""
    gnina_rmsds = np.asarray(gnina_rmsds)
    gnina_scores = np.asarray(gnina_scores)
    n, k = gnina_rmsds.shape
    order = np.argsort(-gnina_scores, axis=1)
    filtered = gnina_rmsds[np.arange(n)[:, None], order][:, 0]
    out = {
        "gnina_rmsds_below_2": float((gnina_rmsds < 2).sum() * 100 / (n * k)),
        "gnina_rmsds_below_5": float((gnina_rmsds < 5).sum() * 100 / (n * k)),
        "gnina_min_rmsds_below_2": float(
            (gnina_rmsds.min(axis=1) < 2).mean() * 100),
        "gnina_min_rmsds_below_5": float(
            (gnina_rmsds.min(axis=1) < 5).mean() * 100),
        "gnina_filtered_rmsds_below_2": float((filtered < 2).mean() * 100),
        "gnina_filtered_rmsds_below_5": float((filtered < 5).mean() * 100),
    }
    for q in (25, 50, 75):
        out[f"gnina_rmsds_percentile_{q}"] = float(
            np.percentile(gnina_rmsds, q))
    return out


def min_self_distances(pose: np.ndarray, bonds: Sequence) -> float:
    """Smallest non-bonded atom pair distance (steric-clash proxy,
    reference ``evaluate.py:486-505`` uses fraction < 0.4 A)."""
    n = pose.shape[0]
    d = np.linalg.norm(pose[:, None] - pose[None, :], axis=-1)
    bonded = np.zeros((n, n), bool)
    for i, j, *_ in bonds:
        bonded[i, j] = bonded[j, i] = True
    np.fill_diagonal(bonded, True)
    d[bonded] = np.inf
    return float(d.min())
