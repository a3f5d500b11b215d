"""The work a dock needs, counted from the configuration and the sizes.

The census runs the reference's own modules (``benchmark/reference``) once
per kind of forward a dock makes, at the sizes asked for, with the merged
tensor-product contraction replaced by a stand-in that records its shape
and returns zeros (the arithmetic is skipped: the shapes do not depend on
the values in the dense neighbour-block layout). It gives:

* every merged contraction of the dock as (F_tot, weights, weight columns,
  output width, rows, K, H) with how often it runs, for the frozen
  ``tp3_work``/``bound_ms`` (:mod:`benchmark.work.tp3`);
* the dock's model FLOPs: the products of every other matrix operation
  (edge MLPs, node and equivariant linears, heads), counted by
  ``torch.utils.flop_counter.FlopCounterMode``, plus each contraction's
  least products (``tp3_work``), so the block-diagonal form the plain
  contraction uses never inflates the count.

A dock of the new architecture is one receptor embedding, then per step
the step cache and one forward; a dock of the v1.0 family is one forward
per step; both end with one confidence forward over all poses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.models import tpconv
from benchmark.work.tp3 import bound_ms, class_sums, tp3_work

# (F_tot, weights, weight columns, output width, rows, K, H)
Call = Tuple[int, int, int, int, int, int, int]


@dataclasses.dataclass
class Work:
    calls: Dict[Call, int]  # contraction -> times per dock
    other_flops: float  # matrix products outside the contractions, per dock

    def contraction_flops(self) -> float:
        return sum(n * tp3_work(*c)[0] for c, n in self.calls.items())

    def flops(self) -> float:
        return self.other_flops + self.contraction_flops()

    def bound_ms(self) -> float:
        """The least time of the dock's contractions on the chip."""
        return sum(n * bound_ms(*tp3_work(*c))[0] for c, n in self.calls.items())

    def launches(self) -> int:
        return sum(self.calls.values())


class _Count:
    """Records each contraction (as a :data:`Call`) and returns zeros."""

    def __init__(self):
        self.calls: List[Call] = []

    def __call__(self, tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
        f_tot, weight, w_len = class_sums(tp)
        self.calls.append((f_tot, weight, w_len, tp.irreps_out.dim, x_nbr.shape[0], x_nbr.shape[1],
                           h.shape[-1]))
        return x_nbr.new_zeros(x_nbr.shape[0], tp.irreps_out.dim, dtype=torch.float32)


def _counted(fn) -> Tuple[List[Call], float]:
    count = _Count()
    tpconv.CONTRACTION.insert(0, count)
    try:
        with FlopCounterMode(display=False) as flops:
            fn()
    finally:
        tpconv.CONTRACTION.remove(count)
    return count.calls, float(flops.get_total_flops())


@torch.inference_mode()
def dock_work(docker, data, aa, num_poses: int, n_steps: int, sizes=None) -> Tuple[Work, Work]:
    """(score model's work, confidence model's work) of one dock of
    ``num_poses`` poses and ``n_steps`` steps, with the inputs padded to
    ``sizes`` = (nl, nr, nb, na) (the real sizes for the model's FLOPs,
    the buckets for the kernels' bound); ``docker`` is a
    :class:`benchmark.reference.dock.ReferenceDocker`."""
    score_in, conf_in = docker.padded(data, aa, sizes)
    nl = score_in.lig_pos.shape[0]
    poses = score_in.lig_pos.expand(num_poses, nl, 3).contiguous()
    t = torch.tensor(0.5, device=poses.device)
    model, so3, torus = docker.model, docker.so3, docker.torus
    calls: Dict[Call, int] = {}
    other = 0.0

    def add(fn, times: int):
        nonlocal other
        cs, fl = _counted(fn)
        for c in cs:
            calls[c] = calls.get(c, 0) + times
        other += times * fl

    if docker.score_cfg.old_architecture:
        add(lambda: model(score_in, poses, t, so3, torus), n_steps)
    else:
        cache = model.embed_receptor(score_in)
        add(lambda: model.embed_receptor(score_in), 1)
        add(lambda: model(score_in, poses, t, so3, torus, rec_cache=cache,
                          step_cache=model.step_cache(score_in, t, cache)), n_steps)
    score = Work(calls, other)
    conf_calls, conf_flops = _counted(lambda: docker.confidence_model(conf_in, poses, 0.0))
    conf = Work({}, conf_flops)
    for c in conf_calls:
        conf.calls[c] = conf.calls.get(c, 0) + 1
    return score, conf
