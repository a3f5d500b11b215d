"""The plain reference dock: one pose batch of one complex, ranked.

What the port's ``DockingPipeline.dock_complex`` computes for a complex that
needs no crop and fits one pose batch, in plain PyTorch, float32, TF32 off
(unless a control asks for it): pad the complex to its bucket on the fine
ladder, embed the receptor once (new architecture) or at every step (the
v1.0 family), place the start poses, run the reverse diffusion, then score
the final poses with the confidence model at t = 0 and rank them. It takes
the same inputs, weights and noise as the port and works out the bucket,
the padding, the graphs and the diffusion tables again with its own code
(this package, a frozen copy of the port's plain modules). It imports
nothing of the port.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.data.complexes import (
    AAComplexData,
    ComplexData,
    atom_bucket,
    bucket_sizes,
    pad_aa_to,
    pad_to,
    to_device,
)
from benchmark.reference.diffusion.so3 import get_so3_tables
from benchmark.reference.diffusion.torus import get_torus_tables
from benchmark.reference.inference.sampler import (
    InitNoise,
    SamplerConfig,
    StepNoise,
    randomize_position,
    reverse_diffusion,
    reverse_step,
    schedule,
)
from benchmark.reference.models.config import ScoreModelConfig
from benchmark.reference.models.factory import build_model


class Ranked(NamedTuple):
    poses: np.ndarray  # (P, n_lig, 3) in the input frame
    confidence: np.ndarray  # (P,) higher is better
    order: np.ndarray  # (P,) best first
    states: np.ndarray  # (S, P, n_lig, 3): the poses each step started from, centered frame
    scores: dict  # "tr", "rot" (S, P, 3), "tor" (S, P, n_bonds): each step's scores


def stack_scores(outs, n_bonds: int) -> dict:
    """Each step's score outputs (``tr``, ``rot``, ``tor`` of a pose batch)
    as numpy arrays (S, P, ...), the real bonds' torsion scores only."""
    return {"tr": torch.stack([o.tr for o in outs]).cpu().numpy(),
            "rot": torch.stack([o.rot for o in outs]).cpu().numpy(),
            "tor": torch.stack([o.tor[:, :n_bonds] for o in outs]).cpu().numpy()}


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in full float32 (the reference) or in TF32 (the
    control one precision below); the previous setting comes back after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def build(cfg: ScoreModelConfig) -> torch.nn.Module:
    """The reference model of ``cfg`` (weights to be loaded), in eval mode."""
    return build_model(cfg).eval()


class ReferenceDocker:
    """The score and confidence models and the diffusion tables of the
    reference, built once and reused for every dock it replays."""

    def __init__(self, model: torch.nn.Module, confidence_model: torch.nn.Module,
                 sampler_cfg: SamplerConfig, device):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.confidence_model = confidence_model.to(self.device).eval()
        self.score_cfg, self.confidence_cfg = model.cfg, confidence_model.cfg
        self.sampler_cfg = sampler_cfg
        self.so3 = get_so3_tables(device=self.device)
        self.torus = get_torus_tables(device=self.device)

    def bucket(self, data: ComplexData):
        return bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)

    def padded(self, data: ComplexData, aa_data: AAComplexData, sizes=None):
        """(score input, confidence input) on the device, padded to
        ``sizes`` = (nl, nr, nb, na): by default the fine ladder's bucket
        and the receptor-atom bucket."""
        nl, nr, nb, na = sizes or (*self.bucket(data), atom_bucket(aa_data.n_atoms))
        score_in = to_device(pad_to(data, nl, nr, nb), self.device)
        conf_in = to_device(pad_aa_to(aa_data, nl, nr, nb, na), self.device)
        return score_in, conf_in

    def start(self, padded: ComplexData, num_poses: int, init: InitNoise) -> torch.Tensor:
        """The start poses (P, NL, 3) of a pose batch, centered frame."""
        scfg, sampler = self.score_cfg, self.sampler_cfg
        return randomize_position(
            padded, num_poses,
            sampler.pocket_tr_max if sampler.pocket_tr_max is not None else scfg.sigma.tr_sigma_max,
            init, sampler.initial_noise_std_proportion,
            no_random=sampler.no_random or sampler.no_random_pocket,
            no_torsion=scfg.no_torsion, choose_residue=sampler.choose_residue,
        )

    def score_fn(self, padded: ComplexData):
        """``score_fn(poses, t)`` of the sampler: the receptor embedded once
        (new architecture) or in every forward (the v1.0 family)."""
        rec_cache = None if self.score_cfg.old_architecture else self.model.embed_receptor(padded)

        def score_fn(poses, t):
            if rec_cache is None:
                return self.model(padded, poses, t, self.so3, self.torus)
            step = self.model.step_cache(padded, t, rec_cache)
            return self.model(padded, poses, t, self.so3, self.torus, rec_cache=rec_cache, step_cache=step)

        return score_fn

    @torch.inference_mode()
    def trajectory(self, padded: ComplexData, num_poses: int, init: InitNoise,
                   steps: StepNoise) -> Tuple[torch.Tensor, list]:
        """The reverse diffusion of one pose batch: the start and the poses
        after every step (S+1, P, NL, 3), centered frame, and the scores
        every step's forward gave."""
        outs = []
        score_fn = self.score_fn(padded)

        def recorded(poses, t):
            outs.append(score_fn(poses, t))
            return outs[-1]

        frames = reverse_diffusion(recorded, padded, self.start(padded, num_poses, init),
                                   self.sampler_cfg, self.score_cfg.sigma, steps,
                                   no_torsion=self.score_cfg.no_torsion, return_trajectory=True)[1]
        return frames, outs

    @torch.inference_mode()
    def confidence(self, conf_in: AAComplexData, poses: torch.Tensor, chunk: int = 10) -> torch.Tensor:
        """The confidence of each padded pose (P, NL, 3) at t = 0, ``chunk``
        poses per forward (a pose's confidence does not depend on the
        others'); NaN reads -1000, as the port's ranking has it."""
        outs = [self.confidence_model(conf_in, poses[i : i + chunk], 0.0)
                for i in range(0, poses.shape[0], chunk)]
        return torch.nan_to_num(torch.cat(outs)[..., 0], nan=-1000.0)

    def dock(self, data: ComplexData, aa_data: AAComplexData, num_poses: int,
             init: InitNoise, steps: StepNoise, tf32: bool = False) -> Ranked:
        """One ranked dock of ``num_poses`` poses from the given draws
        (drawn at the padded bond count)."""
        with matmul_precision(tf32):
            score_in, conf_in = self.padded(data, aa_data)
            frames, outs = self.trajectory(score_in, num_poses, init, steps)
            conf = self.confidence(conf_in, frames[-1])
        center = np.asarray(data.original_center, np.float32)
        real = frames[:, :, : data.n_lig].cpu().numpy()
        c = conf.cpu().numpy()
        return Ranked(poses=real[-1] + center[None, None], confidence=c, order=np.argsort(-c),
                      states=real[:-1], scores=stack_scores(outs, data.n_bonds))

    def pad_poses(self, poses: np.ndarray, nl: int) -> torch.Tensor:
        """Poses (..., n_lig, 3) of the real atoms placed in the padded
        layout (..., nl, 3) on the device; padding atoms at the origin (the
        models mask them)."""
        out = np.zeros(poses.shape[:-2] + (nl, 3), np.float32)
        out[..., : poses.shape[-2], :] = poses
        return torch.as_tensor(out, device=self.device)

    def confidence_of(self, data: ComplexData, aa_data: AAComplexData, poses: np.ndarray) -> np.ndarray:
        """The reference confidence of given poses (P, n_lig, 3) in the input
        frame: the judge of a ranking that another dock produced."""
        _, conf_in = self.padded(data, aa_data)
        center = np.asarray(data.original_center, np.float32)
        padded = self.pad_poses(np.asarray(poses, np.float32) - center, conf_in.base.lig_pos.shape[0])
        return self.confidence(conf_in, padded).cpu().numpy()

    def step_gaps(self, data: ComplexData, aa_data: AAComplexData, states: np.ndarray, scores: dict,
                  final: np.ndarray, init: InitNoise, steps: StepNoise) -> Tuple[float, np.ndarray, np.ndarray]:
        """How far a dock's every step lies from the reference's, taken from
        the dock's own state. The dock's step ``s`` started from
        ``states[s]`` ((S, P, n_lig, 3), centered frame) with the scores
        ``scores`` (as :func:`stack_scores`) and the last ended at ``final``
        (input frame). Returns (start gap, score gap of each step, update
        gap of each step): the largest distance (Angstrom) between the
        reference's start poses and ``states[0]``; per step the largest
        difference between the dock's scores and the reference model's from
        the same state, as a share of the reference's largest score of that
        kind (at least 1), the worst of the three kinds; and the largest
        distance between the poses after the dock's step (the next state,
        ``final`` after the last) and the reference's update of the same
        state by the dock's own scores."""
        score_in, _ = self.padded(data, aa_data)
        nl, nb, n = score_in.lig_pos.shape[0], score_in.rot_u.shape[0], data.n_lig
        center = np.asarray(data.original_center, np.float32)
        targets = np.concatenate([states[1:], (np.asarray(final) - center)[None]], axis=0)
        sched = schedule(self.sampler_cfg, self.score_cfg.sigma, self.device)
        score_gaps, update_gaps = [], []
        with torch.inference_mode():
            start = self.start(score_in, states.shape[1], init)[:, :n].cpu().numpy()
            score_fn = self.score_fn(score_in)
            for s in range(states.shape[0]):
                x = self.pad_poses(states[s], nl)
                ref = score_fn(x, sched.t_curr[s])
                got = {k: torch.as_tensor(scores[k][s], device=self.device) for k in ("tr", "rot", "tor")}
                tor = torch.zeros_like(ref.tor)
                tor[:, : got["tor"].shape[1]] = got["tor"]
                got["tor"] = tor
                score_gaps.append(max(
                    float((got[k] - getattr(ref, k)).abs().max()) / max(1.0, float(getattr(ref, k).abs().max()))
                    if getattr(ref, k).numel() else 0.0 for k in ("tr", "rot", "tor")))
                theirs = ref._replace(**got)
                after = reverse_step(lambda _p, _t: theirs, score_in, x, s, sched, self.sampler_cfg,
                                     self.score_cfg.sigma, steps, self.score_cfg.no_torsion)
                update_gaps.append(float(np.abs(after[:, :n].cpu().numpy() - targets[s]).max()))
        return float(np.abs(start - states[0]).max()), np.asarray(score_gaps), np.asarray(update_gaps)


def as_reference_data(fields: dict, aa_fields: Optional[dict]):
    """The reference's own ComplexData (and AAComplexData) from plain dicts
    of numpy arrays, field by field."""
    data = ComplexData(**fields)
    aa = None if aa_fields is None else AAComplexData(base=data, **aa_fields)
    return data, aa
