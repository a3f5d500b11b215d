"""Score-matching loss (port of ``diffdock_tpu/train/losses.py``).

Per-component weighted MSE normalized by score norms, per complex of a
batch:
  tr:  (pred - target)^2 * tr_sigma^2
  rot: ((pred - target) / so3.score_norm(rot_sigma))^2
  tor: (pred - target)^2 / torus.score_norm(tor_sigma), averaged over the
       valid rotatable bonds of the whole batch (the reference's flat mean).
With the sidechain head (``sidechain_pred``) and the data's ``rec_scv``
targets, the backbone-vector and sidechain-chi sums join the parts, and
``total_loss`` adds their weighted batch ratios.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from diffdock_tpu_torch.diffusion.schedules import SigmaConfig, t_to_sigma
from diffdock_tpu_torch.diffusion.so3 import SO3Tables
from diffdock_tpu_torch.diffusion.torus import TorusTables
from diffdock_tpu_torch.train.noise import NoisySample


class LossParts(NamedTuple):
    """Per-complex (B,) parts of the loss."""

    tr: torch.Tensor
    rot: torch.Tensor
    tor_sum: torch.Tensor  # sum over valid bonds
    tor_count: torch.Tensor  # valid-bond count
    tr_base: torch.Tensor
    rot_base: torch.Tensor
    tor_base_sum: torch.Tensor
    t: torch.Tensor  # diffusion time, for sigma-interval logging
    # the backbone and sidechain auxiliary sums (:func:`aux_sidechain_parts`);
    # zeros without the sidechain head or without targets
    bb_sq_sum: torch.Tensor = torch.zeros(())
    bb_base_sum: torch.Tensor = torch.zeros(())
    sc_sq_sum: torch.Tensor = torch.zeros(())
    sc_base_sum: torch.Tensor = torch.zeros(())
    rec_count: torch.Tensor = torch.zeros(())


def aux_sidechain_parts(sidechain_pred: torch.Tensor, rec_scv: torch.Tensor,
                        rec_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Sums over each complex's residues for the backbone-vector and
    sidechain-chi losses (reference ``utils/training.py:61-77`` backbone,
    ``:88-101`` chi: circular |diff| folded at 0.5, NaN chis zeroed).
    sidechain_pred, rec_scv (..., NR, 10); rec_mask (..., NR); the sums
    have the leading shape."""
    m = rec_mask.to(torch.float32)
    vecs = torch.nan_to_num(rec_scv[..., 4:], nan=0.0)
    bb_sq = torch.mean((sidechain_pred[..., 4:] - vecs) ** 2, dim=-1)
    bb_base = torch.mean(vecs ** 2, dim=-1) + 1e-4

    chi = rec_scv[..., :4]
    valid = ~torch.isnan(chi)
    chi0 = torch.where(valid, chi, torch.zeros_like(chi))
    cpred = torch.where(valid, sidechain_pred[..., :4], torch.zeros_like(chi))
    diff = torch.abs(cpred - chi0)
    diff = torch.minimum(diff, 1.0 - diff)  # angles are circular, 360 deg = 1
    sc_sq = torch.mean(diff ** 2, dim=-1)
    sc_base = torch.mean(chi0 ** 2, dim=-1) + 1e-4
    return dict(
        bb_sq_sum=torch.sum(bb_sq * m, dim=-1), bb_base_sum=torch.sum(bb_base * m, dim=-1),
        sc_sq_sum=torch.sum(sc_sq * m, dim=-1), sc_base_sum=torch.sum(sc_base * m, dim=-1),
        rec_count=torch.sum(m, dim=-1),
    )


def per_complex_losses(pred, sample: NoisySample, rot_mask: torch.Tensor, sigma_cfg: SigmaConfig,
                       so3_tables: SO3Tables, torus_tables: TorusTables, rec_scv=None,
                       rec_mask=None) -> LossParts:
    """``pred``: a ScoreOutput with tr, rot (B, 3), tor (B, nb) and, with
    the sidechain head, sidechain (B, NR, 10); ``rot_mask`` (B, nb);
    ``rec_scv`` (B, NR, 10) and ``rec_mask`` (B, NR): the auxiliary
    targets, or None."""
    t = sample.t
    tr_sigma, rot_sigma, tor_sigma = t_to_sigma(t, t, t, sigma_cfg)

    tr = torch.mean((pred.tr - sample.tr_score) ** 2, dim=-1) * tr_sigma ** 2
    tr_base = torch.mean(sample.tr_score ** 2, dim=-1) * tr_sigma ** 2

    rot_norm = so3_tables.score_norm(rot_sigma)[:, None]
    rot = torch.mean(((pred.rot - sample.rot_score) / rot_norm) ** 2, dim=-1)
    rot_base = torch.mean((sample.rot_score / rot_norm) ** 2, dim=-1)

    tor_norm = torus_tables.score_norm(tor_sigma[:, None].expand(pred.tor.shape))
    m = rot_mask.to(pred.tor.dtype)
    tor_sq = (pred.tor - sample.tor_score) ** 2 / tor_norm
    tor_base_sq = sample.tor_score ** 2 / tor_norm
    aux = {}
    if getattr(pred, "sidechain", None) is not None and rec_scv is not None:
        aux = aux_sidechain_parts(pred.sidechain, rec_scv, rec_mask)
    return LossParts(
        tr=tr, rot=rot, tor_sum=torch.sum(tor_sq * m, dim=-1), tor_count=torch.sum(m, dim=-1),
        tr_base=tr_base, rot_base=rot_base, tor_base_sum=torch.sum(tor_base_sq * m, dim=-1), t=t,
        **aux,
    )


def total_loss(parts: LossParts, tr_weight: float = 0.33, rot_weight: float = 0.33,
               tor_weight: float = 0.33, backbone_weight: float = 0.0,
               sidechain_weight: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The scalar training loss and its metrics from the batch's parts;
    torsion is the flat mean over all valid rotatable bonds of the batch.
    With a backbone or sidechain weight the auxiliary losses join, each the
    batch's sum of squared errors over the sum of its bases (the
    reference's mean loss over mean base, ``training.py:69,102``)."""
    tr = torch.mean(parts.tr)
    rot = torch.mean(parts.rot)
    n_tor = torch.clamp(torch.sum(parts.tor_count), min=1e-4)
    tor = torch.sum(parts.tor_sum) / n_tor
    loss = tr_weight * tr + rot_weight * rot + tor_weight * tor
    metrics = {
        "loss": loss, "tr_loss": tr, "rot_loss": rot, "tor_loss": tor,
        "tr_base_loss": torch.mean(parts.tr_base),
        "rot_base_loss": torch.mean(parts.rot_base),
        "tor_base_loss": torch.sum(parts.tor_base_sum) / n_tor,
    }
    if backbone_weight > 0.0 or sidechain_weight > 0.0:
        bb = torch.sum(parts.bb_sq_sum) / torch.clamp(torch.sum(parts.bb_base_sum), min=1e-8)
        sc = torch.sum(parts.sc_sq_sum) / torch.clamp(torch.sum(parts.sc_base_sum), min=1e-8)
        loss = loss + backbone_weight * bb + sidechain_weight * sc
        metrics.update(loss=loss, backbone_loss=bb, sidechain_loss=sc)
    return loss, metrics


def sigma_interval_metrics(parts: LossParts, n_buckets: int = 10) -> Dict[str, torch.Tensor]:
    """Per-sigma-interval component losses (reference 10-bucket logging,
    ``utils/training.py:216-238``): (n_buckets,) arrays over t in
    [i/n, (i+1)/n); empty buckets report NaN."""
    bucket = torch.clamp(torch.floor(parts.t * n_buckets).long(), 0, n_buckets - 1)
    onehot = torch.nn.functional.one_hot(bucket, n_buckets).to(parts.tr.dtype)  # (B, n)
    counts = onehot.sum(0)
    safe = torch.clamp(counts, min=1.0)
    out = {
        "tr_loss_by_sigma": (onehot * parts.tr[:, None]).sum(0) / safe,
        "rot_loss_by_sigma": (onehot * parts.rot[:, None]).sum(0) / safe,
        "tor_loss_by_sigma": (onehot * parts.tor_sum[:, None]).sum(0)
        / torch.clamp((onehot * parts.tor_count[:, None]).sum(0), min=1e-4),
    }
    out = {k: torch.where(counts > 0, v, torch.full_like(v, float("nan"))) for k, v in out.items()}
    out["sigma_bucket_counts"] = counts
    return out
