"""The system under test: the port's docking pipeline, driven as a user does.

This is the one module of the harness that imports the port
(``diffdock_tpu_torch``): its configuration types, its pipeline and its
sampler's noise types. Everything else the benchmark computes with its own
code.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from diffdock_tpu_torch.data.complexes import AAComplexData, ComplexData
from diffdock_tpu_torch.diffusion.schedules import SigmaConfig
from diffdock_tpu_torch.inference.pipeline import DockingPipeline, DockingResult
from diffdock_tpu_torch.inference.sampler import InitNoise, SamplerConfig, StepNoise
from diffdock_tpu_torch.models.config import ScoreModelConfig

from benchmark.harness.noise import Draws


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def model_config(fields: dict, config_cls=ScoreModelConfig, sigma_cls=SigmaConfig):
    """A ``ScoreModelConfig`` (the port's, or the reference's with its own
    classes) from a configuration file's model section."""
    fields = dict(fields)
    sigma = sigma_cls(**fields.pop("sigma", {}))
    return config_cls(**_tuples(fields), sigma=sigma)


def sampler_config(fields: dict, cls=SamplerConfig):
    return cls(**_tuples(fields))


class PortDocker:
    """The port's ``DockingPipeline`` for one configuration, on the fine
    bucket ladder with the anomaly guard off (its default there), holding
    the seed's weights."""

    def __init__(self, config: dict, score_weights: dict, confidence_weights: dict, device):
        self.device = torch.device(device)
        self.score_cfg = model_config(config["score_model"])
        self.confidence_cfg = model_config(config["confidence_model"])
        self.sampler_cfg = sampler_config(config["sampler"])
        self.pipe = DockingPipeline(
            self.score_cfg, score_weights, self.sampler_cfg, device=self.device,
            confidence_cfg=self.confidence_cfg, confidence_weights=confidence_weights,
            bucket_ladder="fine")

    @staticmethod
    def complex(fields: dict, aa_fields: dict) -> Tuple[ComplexData, AAComplexData]:
        data = ComplexData(**fields)
        return data, AAComplexData(base=data, **aa_fields)

    def bucket(self, data: ComplexData) -> Tuple[int, int, int]:
        """The padded (nl, nr, nb) the pipeline docks ``data`` in."""
        return tuple(self.pipe.dock_bucket(data)[0])

    def noise(self, seed: int, n_steps: Optional[int] = None) -> Callable:
        """The ``noise`` argument of ``dock_complex``: every pose batch's
        draws from ``seed`` (:class:`~benchmark.harness.noise.Draws`), for
        the pipeline's step count or ``n_steps``."""
        steps = n_steps if n_steps is not None else self.sampler_cfg.num_steps

        def draw(num_poses: int, n_bonds: int, _seed: int, fold=None):
            d = Draws.make(num_poses, n_bonds, steps, seed, self.device)
            return (InitNoise(tor=d.tor0, rot=d.rot0, tr=d.tr0, res=d.res0),
                    StepNoise(tr=d.tr, rot=d.rot, tor=d.tor))

        return draw

    def dock(self, data: ComplexData, aa: AAComplexData, num_poses: int, seed: int,
             n_steps: Optional[int] = None) -> DockingResult:
        """One ranked dock, as a user calls it; ``n_steps`` runs a shorter
        schedule of that many steps (the warm-up's)."""
        if n_steps is None:
            return self.pipe.dock_complex(data, num_poses=num_poses, noise=self.noise(seed), aa_data=aa)
        full = self.pipe.sampler_cfg
        self.pipe.sampler_cfg = dataclasses.replace(full, inference_steps=n_steps, actual_steps=n_steps)
        try:
            return self.pipe.dock_complex(data, num_poses=num_poses, noise=self.noise(seed, n_steps),
                                          aa_data=aa)
        finally:
            self.pipe.sampler_cfg = full

    @contextlib.contextmanager
    def recording_steps(self):
        """Within: a list that gains, at every score-model forward, a copy
        of the poses the forward takes (P, NL, 3), the state the step starts
        from, and of the scores it gives (``tr``, ``rot``, ``tor``), by a
        forward pre-hook and a forward hook (the program runs unchanged)."""
        steps: List[tuple] = []
        pending: List[torch.Tensor] = []
        pre = self.pipe.model.register_forward_pre_hook(
            lambda _m, args: pending.append(args[1].detach().clone()))
        post = self.pipe.model.register_forward_hook(
            lambda _m, _args, out: steps.append((pending.pop(), out.tr.detach().clone(),
                                                 out.rot.detach().clone(), out.tor.detach().clone())))
        try:
            yield steps
        finally:
            pre.remove()
            post.remove()

    def modules(self) -> Dict[str, torch.nn.Module]:
        """The two model modules the per-layer hooks attach to."""
        return {"score": self.pipe.model, "confidence": self.pipe.confidence_model}

