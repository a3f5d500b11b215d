"""Docking of one complex with confidence ranking (port of ``diffdock_tpu/inference/pipeline.py``).

``DockingPipeline.dock_complex`` runs the body of the JAX package's
``_make_run``: pad the complex to its bucket, embed the receptor once,
place the start poses, run the reverse diffusion with the pose-independent
layer-0 receptor message computed once per step, then score the final
poses with the confidence model at t = 0, in pose chunks, and rank them.
The confidence models ported are the old family's (the shipped default is
the old all-atom architecture). Not ported yet: confidence models of the
new architectures, the confidence model's receptor crop, affinity
prediction, trajectories, the device mesh, the bucket ladders other than
the default, pocket crops and the anomaly guard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from diffdock_tpu_torch import DEFAULT_DEVICE
from diffdock_tpu_torch.data.complexes import (
    AAComplexData,
    ComplexData,
    atom_bucket,
    bucket_sizes,
    pad_aa_to,
    pad_to,
    to_device,
)
from diffdock_tpu_torch.diffusion.so3 import SO3Tables, get_so3_tables
from diffdock_tpu_torch.diffusion.torus import TorusTables, get_torus_tables
from diffdock_tpu_torch.geometry import use_full_fp32
from diffdock_tpu_torch.inference.sampler import (
    InitNoise,
    SamplerConfig,
    StepNoise,
    randomize_position,
    reverse_diffusion,
)
from diffdock_tpu_torch.models.config import ScoreModelConfig
from diffdock_tpu_torch.models.old_models import build_confidence_model
from diffdock_tpu_torch.models.score_model import CGScoreModel

# Device bytes one pose adds to the confidence forward's peak,
# CONF_BYTES_PER_EDGE * nl * n_nodes + CONF_BYTES_PER_NODE * n_nodes
# (n_nodes: receptor atoms for the all-atom model, residues otherwise). The
# dense ligand x node cross blocks dominate: per edge the edge features, the
# hidden activations, the gathered senders, the harmonics and the coupled
# tensor of the merged contraction, all float32. chip_smoke.py measures the
# peak of the shipped all-atom confidence model over 10 poses in one chunk
# at 2560 receptor atoms and two ligand buckets (32 and 64 atoms): on an
# H100, 321.4 and 632.4 MiB per pose, which solve to 3,980 bytes per
# ligand-atom edge and 4,268 bytes per receptor atom (PERF.md, PR 5). The
# coefficients round those up.
CONF_BYTES_PER_EDGE = 4_000
CONF_BYTES_PER_NODE = 4_300
# the share of an 80 GB H100 the confidence temporaries may take: a
# quarter, leaving the rest to the score model, the allocator's slack and
# other work on the card
CONF_BUDGET_BYTES = 20e9


def auto_confidence_chunk(nl: int, n_nodes: int, num_poses: int) -> int:
    """Poses per confidence forward: as many as fit CONF_BUDGET_BYTES of
    per-pose temporaries (the H100 form of the JAX package's
    ``_auto_confidence_chunk``, which budgets 1.5 GB of TPU memory)."""
    per_pose = CONF_BYTES_PER_EDGE * nl * n_nodes + CONF_BYTES_PER_NODE * n_nodes
    return max(1, min(num_poses, int(CONF_BUDGET_BYTES // max(per_pose, 1))))


@dataclasses.dataclass
class DockingResult:
    poses: np.ndarray  # (P, NL, 3) in the original input frame
    confidence: Optional[np.ndarray]  # (P,) higher is better, or None
    order: np.ndarray  # (P,) indices sorted by confidence (best first)


def _with_weights(model: torch.nn.Module, weights: Union[dict, int], device) -> torch.nn.Module:
    """A ``state_dict``, or an ``int`` seed for random weights."""
    if isinstance(weights, int):
        model.reset_parameters(torch.Generator().manual_seed(weights))
    else:
        model.load_state_dict(weights, strict=True)
    return model.to(device).eval()


class DockingPipeline:
    """Holds the score and confidence models, their weights and the
    diffusion tables.

    ``score_weights``: a ``state_dict`` for :class:`CGScoreModel` (for
    example from :func:`diffdock_tpu_torch.utils.convert.state_dict_from_flax`),
    or an ``int`` seed for random weights; ``confidence_weights`` likewise
    for the confidence model of ``confidence_cfg`` (None: no ranking).
    ``confidence_chunk``: poses per confidence forward, None for
    :func:`auto_confidence_chunk`. ``reference_kernels`` runs every
    kernel's plain version instead of the kernel.
    """

    def __init__(
        self,
        score_cfg: ScoreModelConfig,
        score_weights: Union[dict, int],
        sampler_cfg: SamplerConfig = SamplerConfig(),
        so3_tables: Optional[SO3Tables] = None,
        torus_tables: Optional[TorusTables] = None,
        device=DEFAULT_DEVICE,
        reference_kernels: bool = False,
        confidence_cfg: Optional[ScoreModelConfig] = None,
        confidence_weights: Union[dict, int, None] = None,
        confidence_chunk: Optional[int] = None,
    ):
        use_full_fp32()
        self.device = torch.device(device)
        self.score_cfg = score_cfg
        self.sampler_cfg = sampler_cfg
        self.model = _with_weights(CGScoreModel(score_cfg, reference_kernels=reference_kernels),
                                   score_weights, self.device)
        self.confidence_cfg = confidence_cfg
        self.confidence_model = None
        if confidence_cfg is not None:
            if confidence_weights is None:
                raise ValueError("a confidence model needs confidence_weights")
            self.confidence_model = _with_weights(
                build_confidence_model(confidence_cfg, reference_kernels=reference_kernels),
                confidence_weights, self.device)
        if confidence_chunk is not None and confidence_chunk < 1:
            raise ValueError(f"confidence_chunk must be >= 1 (got {confidence_chunk}); "
                             "use None for the automatic chunk")
        self.confidence_chunk = confidence_chunk
        self.so3 = so3_tables if so3_tables is not None else get_so3_tables(device=self.device)
        self.torus = torus_tables if torus_tables is not None else get_torus_tables(device=self.device)

    def draw_noise(self, num_poses: int, n_bonds: int, seed: int) -> Tuple[InitNoise, StepNoise]:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        init = InitNoise.draw(num_poses, n_bonds, gen, self.device)
        steps = StepNoise.draw(self.sampler_cfg.num_steps, num_poses, n_bonds, gen, self.device)
        return init, steps

    @torch.inference_mode()
    def dock_complex(
        self,
        data: ComplexData,
        num_poses: int = 10,
        seed: int = 0,
        noise: Optional[Tuple[InitNoise, StepNoise]] = None,
        aa_data: Optional[AAComplexData] = None,
    ) -> DockingResult:
        """Dock one numpy :class:`ComplexData` and, with a confidence model,
        rank the poses. ``noise``: optional (InitNoise, StepNoise) for the
        padded bond count; drawn from ``seed`` when None. ``aa_data``: the
        same complex with its receptor atoms, for an all-atom confidence
        model."""
        scfg, sampler = self.score_cfg, self.sampler_cfg
        nl, nr, nb = bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)
        padded = to_device(pad_to(data, nl, nr, nb), self.device)
        conf_data = self.confidence_input(data, aa_data, padded)
        init_noise, step_noise = noise if noise is not None else self.draw_noise(num_poses, nb, seed)

        rec_cache = self.model.embed_receptor(padded)
        init = randomize_position(
            padded, num_poses,
            sampler.pocket_tr_max if sampler.pocket_tr_max is not None else scfg.sigma.tr_sigma_max,
            init_noise,
            sampler.initial_noise_std_proportion,
            no_random=sampler.no_random or sampler.no_random_pocket,
            no_torsion=scfg.no_torsion,
            choose_residue=sampler.choose_residue,
        )

        def score_fn(poses, t):
            step = self.model.step_cache(padded, t, rec_cache)
            return self.model(padded, poses, t, self.so3, self.torus,
                              rec_cache=rec_cache, step_cache=step)

        final = reverse_diffusion(
            score_fn, padded, init, sampler, scfg.sigma, step_noise,
            no_torsion=scfg.no_torsion,
        )
        center = np.asarray(data.original_center)
        poses = final[:, : data.n_lig].cpu().numpy() + center[None, None]
        if conf_data is None:
            return DockingResult(poses=poses, confidence=None, order=np.arange(num_poses))
        conf = self.confidence(conf_data, final).cpu().numpy()
        return DockingResult(poses=poses, confidence=conf, order=np.argsort(-conf))

    def confidence_input(self, data: ComplexData, aa_data: Optional[AAComplexData] = None,
                         padded: Optional[ComplexData] = None):
        """The confidence model's padded input on the device (None without a
        confidence model): the all-atom tree padded to the complex's buckets
        and its atom bucket, or the padded coarse-grained complex."""
        if self.confidence_model is None:
            return None
        nl, nr, nb = bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)
        if not self.confidence_cfg.all_atoms:
            return padded if padded is not None else to_device(pad_to(data, nl, nr, nb), self.device)
        if aa_data is None:
            raise ValueError("an all-atom confidence model needs aa_data")
        return to_device(pad_aa_to(aa_data, nl, nr, nb, atom_bucket(aa_data.n_atoms)), self.device)

    def confidence_chunk_for(self, conf_data, num_poses: int) -> int:
        """Poses per confidence forward for this padded complex."""
        if self.confidence_chunk is not None:
            return min(self.confidence_chunk, num_poses)
        lig_pos = conf_data.base.lig_pos if isinstance(conf_data, AAComplexData) else conf_data.lig_pos
        n_nodes = (conf_data.atom_pos if isinstance(conf_data, AAComplexData)
                   else conf_data.rec_pos).shape[0]
        return auto_confidence_chunk(lig_pos.shape[0], n_nodes, num_poses)

    @torch.inference_mode()
    def confidence(self, conf_data, poses: torch.Tensor) -> torch.Tensor:
        """Confidence of each padded pose (P, NL, 3) at t = 0, chunk by chunk
        (each pose's confidence does not depend on its chunk); NaN -> -1000."""
        c = self.confidence_chunk_for(conf_data, poses.shape[0])
        out = torch.cat([self.confidence_model(conf_data, poses[i : i + c], 0.0)
                         for i in range(0, poses.shape[0], c)])
        return torch.nan_to_num(out[..., 0], nan=-1000.0)
