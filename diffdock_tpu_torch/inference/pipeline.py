"""Score-only docking of one complex (port of ``diffdock_tpu/inference/pipeline.py``).

``DockingPipeline.dock_complex`` runs the body of the JAX package's
``_make_run`` without confidence: pad the complex to its bucket, embed the
receptor once, place the start poses, and run the reverse diffusion with
the pose-independent layer-0 receptor message computed once per step.
Not ported yet: the confidence model and ranking, the device mesh, the
bucket ladders other than the default, pocket crops and the anomaly guard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from diffdock_tpu_torch import DEFAULT_DEVICE
from diffdock_tpu_torch.data.complexes import ComplexData, bucket_sizes, pad_to, to_device
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
from diffdock_tpu_torch.models.score_model import CGScoreModel


@dataclasses.dataclass
class DockingResult:
    poses: np.ndarray  # (P, NL, 3) in the original input frame
    confidence: Optional[np.ndarray]  # (P,) higher is better, or None
    order: np.ndarray  # (P,) indices sorted by confidence (best first)


class DockingPipeline:
    """Holds the score model, its weights and the diffusion tables.

    ``score_weights``: a ``state_dict`` for :class:`CGScoreModel` (for
    example from :func:`diffdock_tpu_torch.utils.convert.state_dict_from_flax`),
    or an ``int`` seed for random weights. ``reference_kernels`` runs every
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
    ):
        use_full_fp32()
        self.device = torch.device(device)
        self.score_cfg = score_cfg
        self.sampler_cfg = sampler_cfg
        model = CGScoreModel(score_cfg, reference_kernels=reference_kernels)
        if isinstance(score_weights, int):
            model.reset_parameters(torch.Generator().manual_seed(score_weights))
        else:
            model.load_state_dict(score_weights, strict=True)
        self.model = model.to(self.device).eval()
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
    ) -> DockingResult:
        """Dock one numpy :class:`ComplexData`. ``noise``: optional
        (InitNoise, StepNoise) for the padded bond count; drawn from
        ``seed`` when None."""
        scfg, sampler = self.score_cfg, self.sampler_cfg
        nl, nr, nb = bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)
        padded = to_device(pad_to(data, nl, nr, nb), self.device)
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
        return DockingResult(poses=poses, confidence=None, order=np.arange(num_poses))
