"""Whether what the timed path produced is right: the comparison that
decides ``correct``.

Before the window, the seed picks the docks the check will judge: the
first dock of the cycle's largest complex and more from the first cycle;
the window adds the last dock of that largest complex, a repeat after
every other complex has docked (a fault that shows only when a complex
comes again, such as state kept from an earlier request). While those
docks run, forward hooks on the program's score model record,
at every reverse-diffusion step, the poses the step starts from (the
program's own state) and the scores the forward gives. Once the window has
closed and the program's state is freed, the plain reference
(:mod:`benchmark.reference.dock`) judges each of those docks from the same
inputs, weights and noise, by five numbers, the worst over the docks:

* ``start_gap_A``: the largest distance (Angstrom) between an atom of the
  program's start poses and the reference's (the padding, the placement
  from the start draws);
* ``score_gap``: for every step, the largest difference between the
  program's scores and the reference model's from the same state, as a
  share of the reference's largest score of that kind (translation,
  rotation, torsion; at least 1) (every score-model forward with its
  merged contractions, the SO(3) and torus tables);
* ``update_gap_A``: for every step, the largest distance between an atom of
  the program's poses after the step (the final poses after the last) and
  the reference's update of the same state by the program's own scores
  (the sampler's rigid and torsion updates);
* ``conf_gap``: the largest difference between the program's confidence of
  a pose and the reference confidence model's on the program's own pose,
  as a share of the largest reference confidence (at least 1);
* ``ranked_gap``: the largest difference, rank by rank, between the
  program's confidences in its own ranked order and the reference's
  confidences of the same poses sorted best first, on the same scale (the
  ranking: an order that is not the confidences' reads as far off as the
  confidences it swaps).

The reference follows the program step by step, from the program's own
state, because under random weights a dock's trajectory is chaotic: a
nudge of 1e-6 A to the reference's own start moves its final poses by up
to 12 A in the v1.0 model, and the v1.0 model's rotation scores (up to
2e5) make one update turn a relative score difference of 1e-4 into a pose
difference of 25 A, so neither final poses docked twice nor poses after
one step can tell float32 from a lower precision there (PERF.md). A result of the wrong shape, with a non-finite number or
with an order that is not a permutation fails outright. Each number has a
limit of its own in ``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from benchmark.harness.inputs import sub_seed
from benchmark.harness.noise import Draws
from benchmark.reference.dock import matmul_precision
from benchmark.reference.inference.sampler import InitNoise, StepNoise

NUMBERS = ("start_gap_A", "score_gap", "update_gap_A", "conf_gap", "ranked_gap")
INF = float("inf")


def checked_docks(seed: int, cycle_len: int, n: int) -> List[int]:
    """The window's dock indices the check judges: dock 0 (the cycle's
    lead, its largest complex) and ``n - 1`` more of the first cycle,
    drawn from the seed."""
    rng = np.random.RandomState(sub_seed(seed, 3))
    rest = rng.choice(np.arange(1, cycle_len), size=min(n - 1, cycle_len - 1), replace=False)
    return [0] + sorted(int(i) for i in rest)


def draws(reference, data, num_poses: int, seed: int, device):
    """A dock's noise as the reference's sampler takes it, drawn at the
    reference's own padded bond count."""
    d = Draws.make(num_poses, reference.bucket(data)[2], reference.sampler_cfg.num_steps, seed, device)
    return (InitNoise(tor=d.tor0, rot=d.rot0, tr=d.tr0, res=d.res0),
            StepNoise(tr=d.tr, rot=d.rot, tor=d.tor))


def answer_ok(res, num_poses: int, n_lig: int) -> bool:
    """A ranked dock of the right shape, finite, its order a permutation."""
    p, c, o = np.asarray(res.poses), np.asarray(res.confidence), np.asarray(res.order)
    return (p.shape == (num_poses, n_lig, 3) and c.shape == (num_poses,) and o.shape == (num_poses,)
            and bool(np.isfinite(p).all()) and bool(np.isfinite(c).all())
            and sorted(o.tolist()) == list(range(num_poses)))


def well_formed(res, states, scores, num_poses: int, n_lig: int, n_bonds: int, n_steps: int) -> bool:
    """:func:`answer_ok`, and every step's state and scores recorded."""
    if states is None or scores is None:
        return False
    shapes = {"tr": (n_steps, num_poses, 3), "rot": (n_steps, num_poses, 3),
              "tor": (n_steps, num_poses, n_bonds)}
    return (answer_ok(res, num_poses, n_lig) and np.shape(states) == (n_steps, num_poses, n_lig, 3)
            and all(np.shape(scores.get(k)) == v for k, v in shapes.items())
            and bool(np.isfinite(states).all()))


def judge(reference, data, aa, res, states, scores, num_poses: int, seed: int, device) -> Dict[str, float]:
    """The numbers of one dock: ``res`` (``poses``, ``confidence``,
    ``order``), ``states`` (S, P, n_lig, 3), the poses each step started
    from, and ``scores``, each step's scores; inf where the result is
    malformed."""
    if not well_formed(res, states, scores, num_poses, data.n_lig, data.n_bonds,
                       reference.sampler_cfg.num_steps):
        return {k: INF for k in NUMBERS}
    init, steps = draws(reference, data, num_poses, seed, device)
    with matmul_precision(False):
        start_gap, score_gaps, update_gaps = reference.step_gaps(
            data, aa, np.asarray(states, np.float32), scores, np.asarray(res.poses, np.float32), init, steps)
        on_poses = reference.confidence_of(data, aa, np.asarray(res.poses))
    scale = max(1.0, float(np.abs(on_poses).max()))
    ranked = np.asarray(res.confidence)[np.asarray(res.order)]
    out = {
        "start_gap_A": start_gap,
        "score_gap": float(score_gaps.max()),
        "update_gap_A": float(update_gaps.max()),
        "conf_gap": float(np.abs(np.asarray(res.confidence) - on_poses).max()) / scale,
        "ranked_gap": float(np.abs(ranked - np.sort(on_poses)[::-1]).max()) / scale,
    }
    return {k: v if np.isfinite(v) else INF for k, v in out.items()}


@dataclasses.dataclass
class Verdict:
    correct: bool
    readings: Dict[str, float]
    limits: Dict[str, float]
    per_dock: List[dict]

    def lines(self) -> List[str]:
        return [f"check {k} {self.readings[k]!r} limit {self.limits[k]!r}" for k in NUMBERS]

    def as_json(self) -> Dict[str, dict]:
        return {k: {"value": self.readings[k], "limit": self.limits[k]} for k in NUMBERS}


def verdict(reference, inputs: Sequence, records: Sequence, indices: Sequence[int], num_poses: int,
            limits: Dict[str, float], device) -> Verdict:
    """Each judged dock (``records[i]``: ``complex``, ``seed``, ``result``,
    ``states``; ``inputs``: the reference's (data, aa_data) per complex)
    against the reference; ``correct`` when every number is within its
    limit on every dock."""
    per_dock = []
    for i in indices:
        r = records[i]
        data, aa = inputs[r.complex]
        per_dock.append(dict(index=i, **judge(reference, data, aa, r.result, r.states, r.scores,
                                              num_poses, r.seed, device)))
    readings = {k: max(d[k] for d in per_dock) for k in NUMBERS}
    ok = all(readings[k] <= limits[k] for k in NUMBERS)
    return Verdict(correct=bool(ok), readings=readings, limits=dict(limits), per_dock=per_dock)


def control(reference, data, aa, num_poses: int, seed: int, device):
    """The control: the reference itself in TF32 (one precision below the
    configuration's float32 with TF32 off) docking in the program's place;
    returns (result, states, scores) for :func:`judge`."""
    init, steps = draws(reference, data, num_poses, seed, device)
    ranked = reference.dock(data, aa, num_poses, init, steps, tf32=True)
    return ranked, ranked.states, ranked.scores
