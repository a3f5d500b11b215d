"""The cover ladder of evaluation sweeps (port of ``diffdock_tpu/inference/ladder.py``).

A sweep over many complexes pads each one to the first entry of
``COVER_LADDER`` that fits it, so the whole sweep runs a small set of
padded shapes. The entries' shapes and pose counts are the JAX package's:
they decide which poses are drawn in which chunk (chunk ``c`` from seed
``seed * 100003 + c``), so the two packages draw the same chunks. What was
a TPU number there is the card's here: a cover entry's pose count runs as
``min(P, auto_pose_chunk(nl, nr))``, the H100 cap on poses in flight
(``inference/pipeline.py``), and the cost model behind the anomaly guard
is fitted on an H100.
"""

from __future__ import annotations

from typing import Collection, Optional, Tuple

# (n_lig, n_rec, n_bonds, poses_in_flight), ordered as the JAX package
# orders them (ascending modeled per-complex time on the TPU it was chosen
# for); cover_bucket takes the first entry that fits
COVER_LADDER: Tuple[Tuple[int, int, int, int], ...] = (
    (32, 192, 16, 40),
    (16, 640, 16, 40),
    (48, 256, 16, 40),
    (32, 384, 16, 40),
    (40, 448, 16, 40),
    (28, 640, 16, 40),
    (56, 384, 16, 40),
    (24, 1024, 16, 40),
    (40, 704, 16, 40),
    (56, 576, 16, 40),
    (40, 832, 16, 40),
    (32, 1280, 16, 20),
    (48, 1024, 16, 20),
    (64, 1024, 16, 20),
    (40, 1792, 16, 20),
    (96, 2304, 32, 8),
)

# Wall seconds of one pose chunk (the score model's 19 steps and the shipped
# all-atom confidence model's ranking): COST_CHUNK_S per chunk, whatever its
# pose count (the eager dock is bound by the host's launches, the same for
# any pose count), plus per pose COST_BASE_S and COST_PER_AREA_S times the
# padded ligand x receptor area. Fitted by least squares in chip_smoke.py
# phase D on the sweep's docks (six e2e_synth complexes of 10 poses each,
# DiffDock-L at full width with ESM features, in six cover entries from
# (32, 192) to (40, 1792)) and on one-pose docks at three of those entries
# (1.41-1.43 s each, against 1.92-3.40 s for ten poses), on an NVIDIA H100
# 80GB HBM3 at 700.00 W (PERF.md section 6). The host's speed moves the
# per-chunk part (PERF.md section 5).
COST_CHUNK_S = 1.314
COST_PER_AREA_S = 2.035e-6
COST_BASE_S = 0.03858


def modeled_batch_seconds(nl: int, nr: int, poses: int) -> float:
    """Modeled warm wall time of one pose chunk of ``poses`` poses at the
    padded bucket (nl, nr)."""
    return COST_CHUNK_S + poses * (COST_PER_AREA_S * nl * nr + COST_BASE_S)


def pdbbind_like_sizes(n: int = 150, seed: int = 7):
    """A PDBBind-test-like draw of complex sizes (ligand heavy atoms,
    receptor residues): ligands of about 8-60 heavy atoms, receptors spread
    log-normally over about 100-3000 residues with the mass at 200-600 (the
    reference caps receptors at 3000)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    nl = np.clip(rng.normal(30, 12, n).astype(int), 8, 120)
    nr = np.clip(np.exp(rng.normal(5.9, 0.7, n)).astype(int), 90, 3000)
    return list(zip(nl.tolist(), nr.tolist()))


def fine_plan(sizes=None, dense=False, num_poses: int = 40):
    """The plan the pipeline runs for a sweep in ``bucket_ladder="fine"``
    (``"fine_dense"`` with ``dense``) at ``num_poses`` poses per complex:
    each complex in its bucket (``data/complexes.bucket_sizes``) with the
    poses in flight the pipeline runs there, ``min(num_poses,
    auto_pose_chunk(nl, nr))``. Returns {(nl, nr, nb, P): [(nl_c, nr_c),
    ...]}."""
    from diffdock_tpu_torch.data.complexes import bucket_sizes
    from diffdock_tpu_torch.inference.pipeline import auto_pose_chunk

    if sizes is None:
        sizes = pdbbind_like_sizes()
    plan = {}
    for nl_c, nr_c in sizes:
        nb_c = max(1, nl_c // 4)
        nl, nr, nb = bucket_sizes(nl_c, nr_c, nb_c, dense=dense)
        plan.setdefault((nl, nr, nb, min(num_poses, auto_pose_chunk(nl, nr))), []).append((nl_c, nr_c))
    return plan


def cover_bucket(
    n_lig: int,
    n_rec: int,
    n_bonds: int,
    exclude: Optional[Collection[Tuple[int, int, int, int]]] = None,
):
    """The first cover-ladder entry that fits the complex, skipping the
    entries in ``exclude`` (those the anomaly guard quarantined); None when
    none fits (the pipeline then falls back to the fine ladder)."""
    for entry in COVER_LADDER:
        if exclude and entry in exclude:
            continue
        nl, nr, nb, _poses = entry
        if n_lig <= nl and n_rec <= nr and n_bonds <= nb:
            return entry
    return None
