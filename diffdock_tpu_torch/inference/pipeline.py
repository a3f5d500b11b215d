"""Docking from files with confidence ranking (port of ``diffdock_tpu/inference/pipeline.py``).

``DockingPipeline.dock_mol_protein`` featurizes a parsed ligand and
receptor, docks them and writes the ranked poses as SDF files (and, on
request, each pose's reverse-diffusion trajectory as a PDB) under the JAX
package's names. ``DockingPipeline.dock_complex`` runs the body of the
JAX package's ``_make_run`` on one featurized complex: pad it to its
bucket, embed the receptor once, place the start poses (at the receptor
mean or a given pocket center), run the reverse diffusion with the
pose-independent layer-0 receptor message computed once per step, then
score the final poses with the confidence model at t = 0, in pose chunks,
and rank them. Poses run in chunks of at most the H100 cap
(:func:`auto_pose_chunk`) or the caller's ``batch_size``, each chunk from
its own seed, and are ranked jointly.

The bucket ladders are the JAX package's: ``"fine"`` (geometric rungs),
``"fine_dense"`` (~1.2x-spaced rungs) and ``"cover"`` (the first fitting
entry of ``inference/ladder.py:COVER_LADDER``, whose pose count is the
default chunk; oversize complexes fall back to the fine ladder). With the
cover ladder an anomaly guard times each pose chunk against the ladder's
H100 cost model and quarantines an entry that runs far slower than it;
each entry's first chunk, which pays the one-time costs (the kernels'
build, the allocator's growth to the entry's shapes), is not judged.
``dock_batch`` docks several complexes one after the other or, on a
mesh, one complex per rank.

On a device mesh (``mesh=``, a ``parallel/mesh.py:Mesh``: one process per
rank, each holding the same pipeline) ``dock_complex`` shards each pose
batch as the JAX pipeline's ``_sharded_program`` does: the pose count is
rounded up to a multiple of the mesh size (the surplus poses are sampled
and dropped), each rank docks its share with its rank folded into the
chunk's seed, the poses, confidences and step-major trajectory are
gathered in rank order on every rank, and the pose-set affinity is the
mean over the ranks. The per-card caps (:func:`auto_pose_chunk`, a cover
entry's pose count) scale with the mesh size. ``dock_batch`` shards
complexes instead (the JAX pipeline's ``_batch_program``): groups of one
complex per rank, by ascending bucket, the last group padded with its last
member, one bucket per group with the data-dependent widths normalized
across its members, complex ``i`` drawn from ``seed * 100003 + c`` folded
with ``i``, results in input order. A failure on any rank raises on every
rank (``Mesh.run``), and the anomaly guard judges each chunk by the
slowest rank, so every rank quarantines the same entries.

With ``crop_beyond`` in the score model's config, the receptor is cropped
as in the JAX pipeline: on the host before bucketing (``pre_crop_radius``,
a radius that covers every step's crop by default), then at each step to
the residues within 3 tr_sigma(t) + ``crop_beyond`` of some pose, by mask
or, with ``pocket_capacity``, by gathering the nearest residues into a
smaller receptor; the receptor embedding is then computed at every step.
A confidence model with ``crop_beyond`` keeps the residues within that
distance of the final poses.

Every dock keeps a record of its spans and counts
(``utils/profiling.py:DockTimings``, handed back as
``DockingResult.timings``): ``dock`` from the call to the ranked result;
``prep`` (pre-crop, bucket, padding and the copies to the device, the
confidence input, the noise draw and the start poses; each ``pre_crop``
call a child span); ``embed_receptor`` (the receptor cache);
``diffusion`` with one ``step`` per reverse-diffusion step, each with its
``score`` and ``update``; ``to_host`` (the poses' synchronising copy);
``confidence`` with a ``confidence_chunk`` per chunk; ``rank``;
``diffusion``, ``confidence`` and ``rank`` also on the device's stream;
a chunked dock's batches each
under a ``pose_batch``; and ``featurize`` and ``write`` in
:meth:`DockingPipeline.dock_mol_protein`. Its counts: ``score_forwards``,
``pose_batches``, ``confidence_chunks``, ``pair_real`` and ``pair_slots``
(ligand atoms x residues per pose, real and in the padded bucket, over
the poses of each batch) and ``quarantines`` (the anomaly guard's).

The score model is a coarse-grained one of either architecture: the new
one, or the DiffDock v1.0 model (``old_architecture``), which has no
receptor cache and embeds the receptor at every step, as in the JAX
pipeline. The confidence model is built by
``models/factory.py:build_model``: the old (v1.0) family, or a
new-architecture model (the coarse-grained model in confidence mode, or
``AAScoreModel``), whose receptor embedding runs once per pose batch and
serves every confidence chunk (per chunk under ``crop_beyond``, as in the
JAX pipeline). With ``affinity_prediction`` it also gives the pose set's
affinity: for the old family the mean of the outputs' last column, for a
new-architecture model ``predict_affinity`` of the outputs after the
confidences (a chunked dock averages its chunks' affinities, as the JAX
pipeline does). A confidence model with ``atom_confidence`` is refused,
because the JAX pipeline fails on it too.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Iterator, List, NamedTuple, Optional, Set, Tuple, Union

import numpy as np
import torch

from diffdock_tpu_torch import DEFAULT_DEVICE
from diffdock_tpu_torch.data.chem import read_molecule_file, read_pdb_file, write_sdf
from diffdock_tpu_torch.data.complexes import (
    AAComplexData,
    ComplexData,
    atom_bucket,
    bucket_sizes,
    compact_receptor,
    crop_aa_complex,
    crop_complex,
    pad_aa_to,
    pad_to,
    pocket_indices,
    rec_keep_mask,
    to_device,
)
from diffdock_tpu_torch.diffusion.schedules import t_to_sigma
from diffdock_tpu_torch.diffusion.so3 import SO3Tables, get_so3_tables
from diffdock_tpu_torch.diffusion.torus import TorusTables, get_torus_tables
from diffdock_tpu_torch.geometry import use_full_fp32
from diffdock_tpu_torch.inference import ladder
from diffdock_tpu_torch.inference.sampler import (
    InitNoise,
    SamplerConfig,
    StepNoise,
    randomize_position,
    reverse_diffusion,
)
from diffdock_tpu_torch.data.featurize import build_aa_complex_data, build_complex_data
from diffdock_tpu_torch.models.config import ConfigError, ScoreModelConfig
from diffdock_tpu_torch.models.factory import build_model
from diffdock_tpu_torch.models.old_models import build_confidence_model
from diffdock_tpu_torch.parallel.mesh import Mesh, fold_seed
from diffdock_tpu_torch.utils.profiling import DockTimings, Recorder, count, span

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


# Device bytes one pose adds to the score model's peak in one denoising
# step, SCORE_BYTES_PER_EDGE * nl * nr + SCORE_BYTES_PER_RESIDUE * nr +
# SCORE_BYTES_PER_LIG_PAIR * nl * nl (nl, nr: the padded ligand and
# receptor buckets): the dense lig<-rec and rec<-lig cross blocks, the
# receptor's per-pose node features and the ligand's radius block.
# chip_smoke.py phase C measures the DiffDock-L step's peak over 10 poses
# at (nl, nr) = (32, 320), (32, 1536) and (64, 320) on an NVIDIA H100 80GB
# HBM3 at 700 W: 63.7, 301.8 and 126.7 MiB per pose, which solve to 6,155
# bytes per ligand-residue pair, 8,390 per residue and 1,011 per ligand
# pair, rounded up below. 40 poses at (16, 2304), the bucket of a
# 1547-residue receptor with an 8-atom ligand, then took 233.1 MiB per
# pose against the 236.7 MiB the rounded coefficients give (PERF.md, PR 8).
SCORE_BYTES_PER_EDGE = 6_200
SCORE_BYTES_PER_RESIDUE = 8_400
SCORE_BYTES_PER_LIG_PAIR = 1_100
# the share of an 80 GB H100 the score model's per-pose temporaries may
# take; the confidence model runs after the score model, with its own
# CONF_BUDGET_BYTES
SCORE_BUDGET_BYTES = 40e9
# Both rules' coefficients were measured with float32 models. A bfloat16
# model (the CLIs' default) keeps its gathered senders, harmonics, hidden
# activations and coupled tensors at 2 bytes; the rules stay as they are
# for it, and chip_smoke.py phase H2 measures its bytes per pose at phase
# C's buckets for a later refit.


def score_bytes_per_pose(nl: int, nr: int) -> int:
    return (SCORE_BYTES_PER_EDGE * nl * nr + SCORE_BYTES_PER_RESIDUE * nr
            + SCORE_BYTES_PER_LIG_PAIR * nl * nl)


def auto_pose_chunk(nl: int, nr: int) -> int:
    """The most poses the score model may run at once for a padded
    (nl, nr) complex: as many as fit SCORE_BUDGET_BYTES of per-pose
    temporaries (the H100 form of the JAX package's ``fine_hbm_poses``,
    whose bounds are TPU numbers)."""
    return max(1, int(SCORE_BUDGET_BYTES // max(score_bytes_per_pose(nl, nr), 1)))


def resolve_anomaly_guard(anomaly_guard: Optional[float], bucket_ladder: str, device) -> float:
    """The anomaly guard's factor: ``anomaly_guard`` when given, else the
    ``DIFFDOCK_TPU_ANOMALY_FACTOR`` environment variable, else 5.0 with the
    cover ladder on a CUDA device and 0 (off) otherwise: the cost model is
    the card's."""
    if anomaly_guard is None:
        env_guard = os.environ.get("DIFFDOCK_TPU_ANOMALY_FACTOR")
        if env_guard is not None:
            anomaly_guard = float(env_guard)
        else:
            anomaly_guard = 5.0 if bucket_ladder == "cover" and torch.device(device).type == "cuda" else 0.0
    return float(anomaly_guard)


@dataclasses.dataclass
class DockingResult:
    poses: np.ndarray  # (P, NL, 3) in the original input frame
    confidence: Optional[np.ndarray]  # (P,) higher is better, or None
    order: np.ndarray  # (P,) indices sorted by confidence (best first)
    affinity: Optional[float] = None  # pose-set aggregated affinity (affinity_prediction)
    trajectory: Optional[np.ndarray] = None  # (steps+1, P, NL, 3) input frame
    # the dock's record: dock_id, spans and counts (utils/profiling.py:DockTimings)
    timings: Optional[DockTimings] = None


class BatchGroup(NamedTuple):
    """One group of :meth:`DockingPipeline.batch_groups`: the input indices
    of its complexes, the same padded to the group's size with the last
    one, the members ((data, aa_data) after the pre-crop), the padded
    (nl, nr, nb), the cover entry (or None), the poses per chunk and the
    padded widths (``kb``, ``kr`` and, all-atom, ``na``, ``ka``, ``ar``)."""

    idxs: List[int]
    pad_idxs: List[int]
    members: list
    bucket: Tuple[int, int, int]
    cover: Optional[Tuple[int, int, int, int]]
    pose_chunk: int
    widths: dict


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

    ``bucket_ladder``: ``"fine"``, ``"fine_dense"`` or ``"cover"``, as in
    the JAX pipeline (see the module docstring).

    ``anomaly_guard``: with the cover ladder, each pose chunk after an
    entry's first is timed between two device synchronizations; a chunk
    slower than ``anomaly_guard`` x ``ladder.modeled_batch_seconds``
    quarantines its cover entry, and later docks go to the next entry that
    fits (the slow chunk's poses are kept). The first chunk of each entry
    runs untimed: eager PyTorch has no compilation to split off, and that
    chunk pays the one-time costs. None resolves as in the JAX pipeline: the
    ``DIFFDOCK_TPU_ANOMALY_FACTOR`` environment variable, else 5.0 with the
    cover ladder on a CUDA device (where the JAX package says a TPU
    backend) and 0 (off) otherwise.

    ``pre_crop_radius``: the host crop before padding drops the residues
    farther than this from every atom of the input ligand; None derives,
    when the score config sets ``crop_beyond``, a radius that covers every
    step's crop, as the JAX pipeline does. ``pocket_capacity``: with
    ``crop_beyond``, each step gathers at most this many nearest residues
    into a smaller receptor instead of masking. ``mesh``: a
    ``parallel/mesh.py:Mesh`` to shard the poses (``dock_complex``) or the
    complexes (``dock_batch``) over; every rank builds the same pipeline
    and makes the same calls.
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
        pre_crop_radius: Optional[float] = None,
        pocket_capacity: Optional[int] = None,
        bucket_ladder: str = "fine",
        mesh=None,
        anomaly_guard: Optional[float] = None,
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not {type(mesh).__name__}")
        if bucket_ladder not in ("fine", "fine_dense", "cover"):
            raise ValueError(f"unknown bucket_ladder {bucket_ladder!r}")
        use_full_fp32()
        self.device = torch.device(device)
        self.mesh = mesh
        self.bucket_ladder = bucket_ladder
        self.anomaly_guard = resolve_anomaly_guard(anomaly_guard, bucket_ladder, self.device)
        self._quarantined: Set[Tuple[int, int, int, int]] = set()
        self._warm_entries: Set[Tuple[int, int, int, int]] = set()
        self.score_cfg = score_cfg
        self.sampler_cfg = sampler_cfg
        if pre_crop_radius is None and score_cfg.crop_beyond is not None:
            pre_crop_radius = (3.0 * score_cfg.sigma.tr_sigma_max
                               * max(sampler_cfg.initial_noise_std_proportion, 1.0)
                               + score_cfg.crop_beyond + 10.0)
        self.pre_crop_radius = pre_crop_radius
        self.pocket_capacity = pocket_capacity
        if score_cfg.all_atoms:
            # the JAX pipeline asserts it (diffdock_tpu/inference/pipeline.py:340)
            raise ConfigError("the pose generator is a coarse-grained score model, as in the JAX "
                              "pipeline (inference/pipeline.py:340)")
        if score_cfg.confidence_mode:
            # its forward gives confidences, no scores: the JAX sampler fails on them
            raise ConfigError("the pose generator is a score model: confidence_mode=True gives no scores")
        self.model = _with_weights(build_model(score_cfg, reference_kernels=reference_kernels),
                                   score_weights, self.device)
        self.confidence_cfg = confidence_cfg
        self.confidence_model = None
        if confidence_cfg is not None:
            if confidence_weights is None:
                raise ValueError("a confidence model needs confidence_weights")
            if confidence_cfg.atom_confidence:
                raise ConfigError(
                    "a confidence model with atom_confidence returns (confidences, atom "
                    "confidences), and the JAX pipeline's out[..., 0] fails on that tuple; "
                    "its ranking is not defined (ROADMAP, facts of the reference)")
            self.confidence_model = _with_weights(
                build_confidence_model(confidence_cfg, reference_kernels=reference_kernels),
                confidence_weights, self.device)
        if confidence_chunk is not None and confidence_chunk < 1:
            raise ValueError(f"confidence_chunk must be >= 1 (got {confidence_chunk}); "
                             "use None for the automatic chunk")
        self.confidence_chunk = confidence_chunk
        self.recorder = Recorder()
        self.so3 = so3_tables if so3_tables is not None else get_so3_tables(device=self.device)
        self.torus = torus_tables if torus_tables is not None else get_torus_tables(device=self.device)

    @property
    def mesh_size(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    def draw_noise(self, num_poses: int, n_bonds: int, seed: int,
                   fold: Optional[int] = None) -> Tuple[InitNoise, StepNoise]:
        """The draws of one pose batch from ``seed``, or from stream ``fold``
        of it (``parallel/mesh.py:fold_seed``, JAX's ``fold_in``): a shard
        of a pose mesh folds its rank, a complex of a complex mesh its
        input index."""
        if fold is not None:
            seed = fold_seed(seed, fold)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        init = InitNoise.draw(num_poses, n_bonds, gen, self.device)
        steps = StepNoise.draw(self.sampler_cfg.num_steps, num_poses, n_bonds, gen, self.device)
        return init, steps

    @staticmethod
    def _normalize_inference_data(data: ComplexData, aa_data: Optional[AAComplexData]):
        """Drop ``rec_scv``, a training target the dock never reads (the JAX
        pipeline drops it at the same boundary)."""
        if data.rec_scv is not None:
            data = data._replace(rec_scv=None)
            if aa_data is not None:
                aa_data = aa_data._replace(base=data)
        return data, aa_data

    def pre_crop(self, data: ComplexData, aa_data: Optional[AAComplexData] = None):
        """(data, aa_data) without ``rec_scv`` and, with ``pre_crop_radius``,
        without the residues (and their atoms) farther than it from every
        atom of the input ligand: the JAX pipeline's host crop before
        bucketing. A complex it keeps whole comes back as it was, so a
        second call changes nothing."""
        with span("pre_crop"):
            data, aa_data = self._normalize_inference_data(data, aa_data)
            if self.pre_crop_radius is None:
                return data, aa_data
            keep = rec_keep_mask(np.asarray(data.rec_pos), np.asarray(data.rec_mask),
                                 np.asarray(data.lig_pos)[None], np.asarray(data.lig_mask),
                                 self.pre_crop_radius)
            if keep.all():
                return data, aa_data
            data = crop_complex(data, keep)
            if aa_data is not None:
                aa_data = crop_aa_complex(aa_data, keep)._replace(base=data)
            return data, aa_data

    def dock_bucket(self, data: ComplexData):
        """((nl, nr, nb), cover entry or None): the padded bucket this
        pipeline docks the complex in. With the cover ladder, the first
        entry that fits and is not quarantined; otherwise, and for a complex
        no entry fits, the fine (or dense) ladder's bucket; of the complex
        after :meth:`pre_crop`."""
        data, _ = self.pre_crop(data)
        if self.bucket_ladder == "cover":
            cov = ladder.cover_bucket(data.n_lig, data.n_rec, data.n_bonds, exclude=self._quarantined)
            if cov is not None:
                return cov[:3], cov
        return bucket_sizes(data.n_lig, data.n_rec, data.n_bonds,
                            dense=self.bucket_ladder == "fine_dense"), None

    def effective_pose_chunk(self, data: ComplexData, num_poses: int,
                             batch_size: Optional[int] = None) -> int:
        """The poses in flight :meth:`dock_complex` runs for this complex.
        In a cover entry: its pose count, capped at :func:`auto_pose_chunk`
        of its bucket, and an explicit ``batch_size`` capped there.
        Otherwise ``batch_size`` (all poses when None), capped at
        :func:`auto_pose_chunk` of the bucket. The bucket is that of the
        complex after :meth:`pre_crop`. On a pose mesh the caps, which are
        per card, scale with its size, and the count is rounded up to a
        multiple of it (the program's pose count, as in the JAX pipeline)."""
        (nl, nr, _), cov = self.dock_bucket(data)
        nd = self.mesh_size
        chunk = batch_size
        cap = auto_pose_chunk(nl, nr) * nd
        if cov is not None:
            cap = min(cov[3] * nd, cap)
            chunk = min(chunk, cap) if chunk else cap
        elif (chunk or num_poses) > cap:
            chunk = min(chunk, cap) if chunk else cap
        chunk = min(chunk, num_poses) if chunk else num_poses
        return -(-chunk // nd) * nd

    @torch.inference_mode()
    def dock_complex(
        self,
        data: ComplexData,
        num_poses: int = 10,
        seed: int = 0,
        noise=None,
        aa_data: Optional[AAComplexData] = None,
        return_trajectory: bool = False,
        pocket_center: Optional[np.ndarray] = None,
        batch_size: Optional[int] = None,
        on_step=None,
    ) -> DockingResult:
        """Dock one numpy :class:`ComplexData` and, with a confidence model,
        rank the poses.

        ``noise``: optional function ``(num_poses, n_bonds, seed) ->
        (InitNoise, StepNoise)`` for the padded bond count, called once per
        pose batch; :meth:`draw_noise` when None. The poses run in one batch
        from ``seed`` or, in chunks (see :meth:`effective_pose_chunk`), chunk
        ``c`` from seed ``seed * 100003 + c`` as in the JAX pipeline. On a
        pose mesh each rank calls it with its share of the poses and
        ``fold=rank`` (so a caller can hand each shard its own draws).
        ``aa_data``: the same complex with its receptor atoms, for an
        all-atom confidence model.
        ``pocket_center``: (3,) start-pose center in the complex's centered
        frame (the frame of ``data.rec_pos``); None uses the receptor mean.
        ``return_trajectory``: also return the poses after every step,
        (steps+1, P, NL, 3) in the input frame.
        Each chunk resolves its bucket anew, as in the JAX pipeline, so a
        chunk after one that tripped the anomaly guard runs in the next
        cover entry.
        ``on_step(step, poses, scores)``: called on the host after each
        reverse-diffusion step of each pose batch is issued (see
        :func:`~diffdock_tpu_torch.inference.sampler.reverse_diffusion`;
        on a pose mesh, with this rank's share).
        The result's ``timings`` holds the dock's record (see the module
        docstring), or the record of an enclosing call on this thread
        (:meth:`dock_mol_protein`'s)."""
        noise = noise if noise is not None else self.draw_noise
        with self.recorder.record(self.device) as rec, span("dock"):
            result = self._dock(data, num_poses, seed, noise, aa_data, return_trajectory, pocket_center,
                                batch_size, on_step)
        result.timings = rec
        return result

    def _dock(self, data, num_poses, seed, noise, aa_data, return_trajectory, pocket_center,
              batch_size, on_step) -> DockingResult:
        """:meth:`dock_complex`'s body: the pose chunks, each a
        ``pose_batch`` span docked by this method again, or one batch."""
        with span("prep"):
            data, aa_data = self.pre_crop(data, aa_data)
            chunk = self.effective_pose_chunk(data, num_poses, batch_size)
            if chunk >= num_poses:
                bucket, cov = self.dock_bucket(data)
        if chunk < num_poses:
            results = []
            for c in range(-(-num_poses // chunk)):
                with span("pose_batch"):
                    results.append(self._dock(data, chunk, seed * 100003 + c, noise, aa_data,
                                              return_trajectory, pocket_center, None, on_step))
            # every chunk runs `chunk` poses: the mean of the chunks'
            # affinities weighs every sampled pose alike
            with span("rank", device=True):
                return _concat_results(results, num_poses, return_trajectory)
        guard = self.anomaly_guard if cov is not None else 0.0
        if guard and cov not in self._warm_entries:
            self._warm_entries.add(cov)
            guard = 0.0
        if not guard:
            return self._run_program(data, bucket, num_poses, seed, noise, aa_data,
                                     return_trajectory, pocket_center, on_step)
        self._sync()
        t0 = time.perf_counter()
        result = self._run_program(data, bucket, num_poses, seed, noise, aa_data,
                                   return_trajectory, pocket_center, on_step)
        self._sync()
        self._judge(cov, bucket, -(-num_poses // self.mesh_size), time.perf_counter() - t0)
        return result

    def _judge(self, cov, bucket, poses_per_device: int, dt: float) -> None:
        """The anomaly guard: quarantine ``cov`` when a chunk of
        ``poses_per_device`` poses per card took more than the guard's
        factor times the cost model. On a mesh the slowest rank's time
        decides, the same on every rank."""
        if self.mesh_size > 1:
            dt = max(self.mesh.gather(dt))
        model_s = ladder.modeled_batch_seconds(bucket[0], bucket[1], poses_per_device)
        if dt > self.anomaly_guard * model_s:
            self._quarantined.add(cov)
            count("quarantines")
            warnings.warn(
                f"cover bucket {cov[:3]} ran {dt:.1f}s/batch, {dt / model_s:.0f}x its cost model "
                f"({model_s:.2f}s) — quarantined; subsequent complexes re-route to the next covering "
                f"entry (results of this batch are kept: slow, not wrong)",
                RuntimeWarning,
            )

    def _run_program(self, data: ComplexData, bucket, num_poses: int, seed: int, noise, aa_data,
                     return_trajectory: bool, pocket_center, on_step=None) -> DockingResult:
        """One pose batch: :meth:`_dock_program` on this device or, on a pose
        mesh, ``num_poses`` rounded up to a multiple of the mesh size and
        sharded over its ranks (the JAX pipeline's ``_sharded_program``),
        each rank's share drawn with its rank folded in; the gathered poses,
        confidences and trajectory are cut back to ``num_poses``, and the
        affinity is the mean of the ranks'."""
        if self.mesh_size == 1:
            return self._dock_program(data, bucket, num_poses, seed, noise, aa_data,
                                      return_trajectory, pocket_center, on_step=on_step)
        mesh = self.mesh
        n_local = -(-num_poses // mesh.size)
        parts = mesh.run(lambda: self._dock_program(data, bucket, n_local, seed, noise, aa_data,
                                                     return_trajectory, pocket_center, fold=mesh.rank,
                                                     on_step=on_step))
        return _concat_results(parts, num_poses, return_trajectory)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def dock_batch(self, datas, num_poses: int = 10, seed: int = 0, aa_datas=None,
                   pocket_centers=None, batch_size: Optional[int] = None,
                   noise=None) -> List[DockingResult]:
        """Dock several complexes. Without a mesh (or on a mesh of one) a
        :meth:`dock_complex` loop with complex ``i`` from seed ``seed + i``,
        as the JAX pipeline does. On a mesh, one complex per rank (see the
        module docstring): each group's pose chunk ``c`` of complex ``i``
        from ``noise(pchunk, n_bonds, seed * 100003 + c, fold=i)``
        (:meth:`draw_noise` when None); results in input order on every
        rank."""
        n = len(datas)
        aa_list = aa_datas if aa_datas is not None else [None] * n
        pk_list = pocket_centers if pocket_centers is not None else [None] * n
        if len(aa_list) != n or len(pk_list) != n:
            raise ValueError(f"{n} complexes, {len(aa_list)} all-atom trees, {len(pk_list)} pocket centers")
        if self.mesh_size > 1:
            return self._dock_batch_sharded(datas, num_poses, seed, aa_list, pk_list, batch_size,
                                            noise if noise is not None else self.draw_noise)
        return [self.dock_complex(d, num_poses=num_poses, seed=seed + i, aa_data=aa,
                                  pocket_center=pk, batch_size=batch_size, noise=noise)
                for i, (d, aa, pk) in enumerate(zip(datas, aa_list, pk_list))]

    def batch_groups(self, datas, aa_datas=None, num_poses: int = 10, batch_size: Optional[int] = None,
                     size: Optional[int] = None) -> Iterator[BatchGroup]:
        """The groups that ``dock_batch`` docks on a mesh of ``size`` ranks
        (this pipeline's mesh by default), one at a time: the complexes
        after :meth:`pre_crop` by ascending fine bucket, ``size`` to a group
        (the last one padded with its last member), each group with the
        bucket that covers its largest member (the cover ladder's entry for
        it, skipping the entries quarantined so far), the pose chunk (the
        per-card caps of one complex) and the data-dependent widths
        normalized across its members."""
        size = size or self.mesh_size
        aa_list = aa_datas if aa_datas is not None else [None] * len(datas)
        dense = self.bucket_ladder == "fine_dense"

        def fine(d):
            return bucket_sizes(d.n_lig, d.n_rec, d.n_bonds, dense=dense)

        cropped = [self.pre_crop(d, a) for d, a in zip(datas, aa_list)]
        order = sorted(range(len(datas)), key=lambda i: fine(cropped[i][0]))
        for start in range(0, len(order), size):
            idxs = order[start : start + size]
            pad_idxs = idxs + [idxs[-1]] * (size - len(idxs))
            members = [cropped[i] for i in pad_idxs]
            nl, nr, nb = (max(fine(d)[k] for d, _ in members) for k in range(3))
            cov = (ladder.cover_bucket(nl, nr, nb, exclude=self._quarantined)
                   if self.bucket_ladder == "cover" else None)
            chunk, cap = batch_size, auto_pose_chunk(nl, nr)
            if cov is not None:
                nl, nr, nb = cov[:3]
                cap = min(cov[3], auto_pose_chunk(nl, nr))
                chunk = min(chunk, cap) if chunk else cap
            elif (chunk or num_poses) > cap:
                chunk = min(chunk, cap) if chunk else cap
            widths = dict(kb=max(4, *(d.lig_bond_nbr.shape[1] for d, _ in members)),
                          kr=max(d.rec_nbr.shape[1] for d, _ in members))
            if members[0][1] is not None:
                widths.update(na=max(atom_bucket(a.n_atoms) for _, a in members),
                              ka=max(np.asarray(a.atom_nbr).shape[1] for _, a in members),
                              ar=max(np.asarray(a.res_atom_idx).shape[1] for _, a in members))
            yield BatchGroup(idxs, pad_idxs, members, (nl, nr, nb), cov,
                             min(chunk, num_poses) if chunk else num_poses, widths)

    @torch.inference_mode()
    def _dock_batch_sharded(self, datas, num_poses: int, seed: int, aa_list, pk_list,
                            batch_size: Optional[int], noise) -> List[DockingResult]:
        """``dock_batch`` on a mesh: the JAX pipeline's complex-sharded path,
        group by group (:meth:`batch_groups`); rank ``r`` docks member ``r``
        of each group. Each rank's own member's result carries that rank's
        record of the group (a ``dock`` span over its chunks and the
        guard)."""
        mesh = self.mesh
        if self.confidence_cfg is not None and self.confidence_cfg.all_atoms and None in aa_list:
            raise ValueError("an all-atom confidence model needs aa_datas")
        results: List[Optional[DockingResult]] = [None] * len(datas)
        for g in self.batch_groups(datas, aa_list, num_poses, batch_size):
            i = g.pad_idxs[mesh.rank]
            data, aa = g.members[mesh.rank]

            def mine():
                parts, walls = [], []
                for c in range(-(-num_poses // g.pose_chunk)):
                    self._sync()
                    t0 = time.perf_counter()
                    parts.append(self._dock_program(data, g.bucket, g.pose_chunk, seed * 100003 + c, noise,
                                                    aa, False, pk_list[i], fold=i, widths=g.widths))
                    self._sync()
                    walls.append(time.perf_counter() - t0)
                return _concat_results(parts, num_poses, False), walls

            with self.recorder.record(self.device) as rec, span("dock"):
                gathered = mesh.run(mine)
                if g.cover is not None and self.anomaly_guard:
                    # each chunk judged by the slowest rank; an entry's first
                    # chunk pays its one-time costs and is not judged
                    for c in range(len(gathered[0][1])):
                        if g.cover not in self._warm_entries:
                            self._warm_entries.add(g.cover)
                            continue
                        self._judge(g.cover, g.bucket, g.pose_chunk, max(r[1][c] for r in gathered))
                        if g.cover in self._quarantined:
                            break
            for j, i in enumerate(g.idxs):
                results[i] = gathered[j][0]
                if j == mesh.rank:
                    results[i].timings = rec
        return results

    @torch.inference_mode()
    def dock_program(self, data: ComplexData, bucket: Tuple[int, int, int], num_poses: int,
                     seed: int = 0, aa_data: Optional[AAComplexData] = None, fold: Optional[int] = None,
                     widths: Optional[dict] = None) -> DockingResult:
        """One batch of ``num_poses`` poses of ``data`` padded to ``bucket``
        = (nl, nr, nb), from :meth:`draw_noise` (of stream ``fold`` of
        ``seed`` when given), on this device: the program that
        :meth:`dock_complex` runs per pose chunk, without its pre-crop,
        chunking or guard (``prewarm`` runs it once per job), and that a
        rank of :meth:`dock_batch`'s mesh runs for a member of a
        :meth:`batch_groups` group (``fold`` its input index, ``widths``
        the group's)."""
        return self._dock_program(data, bucket, num_poses, seed, self.draw_noise, aa_data, False, None,
                                  fold=fold, widths=widths)

    def _dock_program(self, data: ComplexData, bucket: Tuple[int, int, int], num_poses: int, seed: int,
                      noise, aa_data: Optional[AAComplexData], return_trajectory: bool,
                      pocket_center: Optional[np.ndarray], fold: Optional[int] = None,
                      widths: Optional[dict] = None, on_step=None) -> DockingResult:
        """One pose batch at the padded ``bucket``: the body of the JAX
        package's ``_make_run``. ``fold`` reaches the ``noise`` function
        when given; ``widths`` (``kb``, ``kr`` and, all-atom, ``na``, ``ka``,
        ``ar``) pads the data-dependent widths as a complex mesh's group
        shares them; ``on_step`` as for :meth:`dock_complex`."""
        scfg, sampler = self.score_cfg, self.sampler_cfg
        nl, nr, nb = bucket
        count("pose_batches")
        count("pair_real", data.n_lig * data.n_rec * num_poses)
        count("pair_slots", nl * nr * num_poses)
        with span("prep"):
            widths = widths or {}
            kw = {k: widths[k] for k in ("kb", "kr") if k in widths}
            padded = to_device(pad_to(data, nl, nr, nb, **kw), self.device)
            conf_data = self.confidence_input(data, aa_data, padded, bucket, widths)
            init_noise, step_noise = (noise(num_poses, nb, seed) if fold is None
                                      else noise(num_poses, nb, seed, fold=fold))
            pocket = (None if pocket_center is None else
                      torch.as_tensor(np.asarray(pocket_center, np.float32).reshape(3), device=self.device))
            init = randomize_position(
                padded, num_poses,
                sampler.pocket_tr_max if sampler.pocket_tr_max is not None else scfg.sigma.tr_sigma_max,
                init_noise,
                sampler.initial_noise_std_proportion,
                no_random=sampler.no_random or sampler.no_random_pocket,
                no_torsion=scfg.no_torsion,
                choose_residue=sampler.choose_residue,
                pocket_center=pocket,
            )

        crop = scfg.crop_beyond is not None
        # the v1.0 family embeds sigma through its node encoders and
        # crop_beyond re-embeds the cropped receptor: both embed the
        # receptor at every step, as in the JAX pipeline
        rec_cache = None
        if not (crop or scfg.old_architecture):
            with span("embed_receptor"):
                rec_cache = self.model.embed_receptor(padded)

        def score_fn(poses, t):
            if crop:
                return self._cropped_score(padded, poses, t)
            if rec_cache is None:
                return self.model(padded, poses, t, self.so3, self.torus)
            step = self.model.step_cache(padded, t, rec_cache)
            return self.model(padded, poses, t, self.so3, self.torus,
                              rec_cache=rec_cache, step_cache=step)

        final = reverse_diffusion(
            score_fn, padded, init, sampler, scfg.sigma, step_noise,
            no_torsion=scfg.no_torsion, return_trajectory=return_trajectory, on_step=on_step,
        )
        with span("to_host"):
            center = np.asarray(data.original_center)
            traj = None
            if return_trajectory:
                final, frames = final
                traj = frames[:, :, : data.n_lig].cpu().numpy() + center[None, None, None]
            poses = final[:, : data.n_lig].cpu().numpy() + center[None, None]
        if conf_data is None:
            return DockingResult(poses=poses, confidence=None, order=np.arange(num_poses),
                                 trajectory=traj)
        with span("confidence", device=True):
            keep = None
            if self.confidence_cfg.crop_beyond is not None:
                # plain crop_beyond, no sigma term, over the final pose batch
                keep = rec_keep_mask(padded.rec_pos, padded.rec_mask, final, padded.lig_mask,
                                     self.confidence_cfg.crop_beyond)
            out = self.confidence_outputs(conf_data, final, rec_keep=keep)
        with span("rank", device=True):
            conf = torch.nan_to_num(out[..., 0], nan=-1000.0).cpu().numpy()
            affinity = None
            if self.confidence_cfg.affinity_prediction and self.confidence_cfg.old_architecture:
                # the old layout: one affinity column per pose, the last
                affinity = float(out[:, -1].mean())
            elif self.confidence_cfg.affinity_prediction:
                n = self.confidence_cfg.num_confidence_outputs
                affinity = float(self.confidence_model.predict_affinity(out[:, n:]))
            order = np.argsort(-conf)
        return DockingResult(poses=poses, confidence=conf, order=order, trajectory=traj,
                             affinity=affinity)

    def _cropped_score(self, padded: ComplexData, poses: torch.Tensor, t: torch.Tensor):
        """The score forward under ``crop_beyond``: the residues within
        3 tr_sigma(t) + crop_beyond of some pose of the batch, by mask or,
        with ``pocket_capacity``, gathered into a receptor of at most that
        many residues; the receptor embedding is computed under the crop."""
        scfg = self.score_cfg
        tr_sigma, _, _ = t_to_sigma(t, t, t, scfg.sigma)
        cutoff = 3.0 * tr_sigma + scfg.crop_beyond
        if self.pocket_capacity is not None:
            cap = min(self.pocket_capacity, padded.rec_mask.shape[0])
            idx, valid = pocket_indices(padded.rec_pos, padded.rec_mask, poses, padded.lig_mask,
                                        cutoff, cap)
            return self.model(compact_receptor(padded, idx, valid), poses, t, self.so3, self.torus)
        keep = rec_keep_mask(padded.rec_pos, padded.rec_mask, poses, padded.lig_mask, cutoff)
        return self.model(padded, poses, t, self.so3, self.torus, rec_keep=keep)

    def confidence_input(self, data: ComplexData, aa_data: Optional[AAComplexData] = None,
                         padded: Optional[ComplexData] = None, bucket=None, widths=None):
        """The confidence model's padded input on the device (None without a
        confidence model): the all-atom tree padded to the complex's bucket
        (``bucket``, or :meth:`dock_bucket`'s) and its atom bucket, or the
        padded coarse-grained complex; of the complex after :meth:`pre_crop`.
        ``widths``: the atom bucket and padded widths of a complex mesh's
        group (see :meth:`_dock_program`)."""
        if self.confidence_model is None:
            return None
        data, aa_data = self.pre_crop(data, aa_data)
        nl, nr, nb = bucket if bucket is not None else self.dock_bucket(data)[0]
        if not self.confidence_cfg.all_atoms:
            return padded if padded is not None else to_device(pad_to(data, nl, nr, nb), self.device)
        if aa_data is None:
            raise ValueError("an all-atom confidence model needs aa_data")
        widths = dict(widths or {})
        na = widths.pop("na", atom_bucket(aa_data.n_atoms))
        return to_device(pad_aa_to(aa_data, nl, nr, nb, na, **widths), self.device)

    def confidence_chunk_for(self, conf_data, num_poses: int) -> int:
        """Poses per confidence forward for this padded complex."""
        if self.confidence_chunk is not None:
            return min(self.confidence_chunk, num_poses)
        lig_pos = conf_data.base.lig_pos if isinstance(conf_data, AAComplexData) else conf_data.lig_pos
        n_nodes = (conf_data.atom_pos if isinstance(conf_data, AAComplexData)
                   else conf_data.rec_pos).shape[0]
        return auto_confidence_chunk(lig_pos.shape[0], n_nodes, num_poses)

    @torch.inference_mode()
    def confidence(self, conf_data, poses: torch.Tensor,
                   rec_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Confidence of each padded pose (P, NL, 3) at t = 0, chunk by chunk
        (each pose's confidence does not depend on its chunk); NaN -> -1000.
        ``rec_keep``: the confidence model's receptor crop."""
        out = self.confidence_outputs(conf_data, poses, rec_keep)
        return torch.nan_to_num(out[..., 0], nan=-1000.0)

    @torch.inference_mode()
    def confidence_outputs(self, conf_data, poses: torch.Tensor,
                           rec_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The confidence model's outputs (P, outputs) for the padded poses,
        chunk by chunk. A new-architecture model embeds the receptor once
        for all chunks (:meth:`embed_receptor`), or inline in each chunk
        under ``rec_keep``."""
        model = self.confidence_model
        c = self.confidence_chunk_for(conf_data, poses.shape[0])
        if self.confidence_cfg.old_architecture:
            def forward(p):
                return model(conf_data, p, 0.0, rec_keep=rec_keep)
        else:
            cache = None if rec_keep is not None else model.embed_receptor(conf_data)

            def forward(p):
                return model(conf_data, p, 0.0, self.so3, self.torus, rec_cache=cache, rec_keep=rec_keep)
        outs = []
        for i in range(0, poses.shape[0], c):
            count("confidence_chunks")
            with span("confidence_chunk"):
                outs.append(forward(poses[i : i + c]))
        return torch.cat(outs)

    # ------------------------------------------------------------------
    def featurize(self, mol, protein, lm_embeddings: Optional[np.ndarray] = None):
        """(ComplexData, AAComplexData or None, H-stripped Molecule) of a
        parsed ligand and receptor; the all-atom tree only for an all-atom
        confidence model."""
        if self.confidence_cfg is not None and self.confidence_cfg.all_atoms:
            aa_data, heavy = build_aa_complex_data(mol, protein, lm_embeddings)
            return aa_data.base, aa_data, heavy
        data, heavy = build_complex_data(mol, protein, lm_embeddings)
        return data, None, heavy

    def dock_files(
        self,
        protein_path: str,
        ligand_path: str,
        out_dir: str,
        num_poses: int = 10,
        seed: int = 0,
        lm_embeddings: Optional[np.ndarray] = None,
    ) -> DockingResult:
        """Dock a ligand file into a protein and write ranked SDFs
        (naming scheme of reference ``inference.py:286-290``)."""
        mol = read_molecule_file(ligand_path)
        protein = read_pdb_file(protein_path)
        return self.dock_mol_protein(
            mol, protein, out_dir, num_poses=num_poses, seed=seed,
            lm_embeddings=lm_embeddings,
        )

    def dock_mol_protein(
        self,
        mol,
        protein,
        out_dir: str,
        num_poses: int = 10,
        seed: int = 0,
        lm_embeddings: Optional[np.ndarray] = None,
        save_trajectory: bool = False,
        batch_size: Optional[int] = None,
        noise=None,
    ) -> DockingResult:
        """Dock a parsed Molecule into a ProteinStructure and write
        ``rank1.sdf``, ``rank{r}_confidence{c:.2f}.sdf`` (with a
        ``confidence`` property) and, with ``save_trajectory``,
        ``rank{r}_reverseprocess.pdb`` into ``out_dir``. ``noise`` as for
        :meth:`dock_complex`. The result's record (``timings``) holds the
        dock's spans and, beside its ``dock`` span, a ``featurize`` span
        (the host's featurization) and a ``write`` span (the files). On a
        mesh every rank docks and returns the result, and rank 0 alone
        writes the files."""
        with self.recorder.record(self.device):
            with span("featurize"):
                data, aa_data, heavy_mol = self.featurize(mol, protein, lm_embeddings)
            result = self.dock_complex(
                data, num_poses=num_poses, seed=seed, noise=noise, aa_data=aa_data,
                return_trajectory=save_trajectory, batch_size=batch_size,
            )
            with span("write"):
                if self.mesh is None or self.mesh.is_main:  # on a mesh, rank 0 writes
                    write_ranked_poses(out_dir, heavy_mol, result)
        return result


def _concat_results(parts: List[DockingResult], num_poses: int, with_trajectory: bool) -> DockingResult:
    """Pose batches joined on the pose axis (the trajectory's axis 1) and
    cut to ``num_poses``, ranked jointly; the affinity is the mean of the
    parts' (each ran as many poses)."""
    poses = np.concatenate([r.poses for r in parts])[:num_poses]
    conf = (np.concatenate([r.confidence for r in parts])[:num_poses]
            if parts[0].confidence is not None else None)
    traj = (np.concatenate([r.trajectory for r in parts], axis=1)[:, :num_poses]
            if with_trajectory else None)
    order = np.argsort(-conf) if conf is not None else np.arange(num_poses)
    affs = [r.affinity for r in parts if r.affinity is not None]
    return DockingResult(poses=poses, confidence=conf, order=order, trajectory=traj,
                         affinity=float(np.mean(affs)) if affs else None)


def write_ranked_poses(out_dir: str, heavy_mol, result: DockingResult) -> List[str]:
    """The ranked SDFs (and trajectory PDBs, when ``result`` carries a
    trajectory) of one dock, under the JAX package's names; returns the
    files written."""
    from diffdock_tpu_torch.utils.visualise import LigandTrajectoryWriter

    os.makedirs(out_dir, exist_ok=True)
    written = []
    if result.trajectory is not None:
        for rank, idx in enumerate(result.order):
            w = LigandTrajectoryWriter(heavy_mol.elements)
            for frame in result.trajectory[:, idx]:
                w.add(frame)
            path = os.path.join(out_dir, f"rank{rank + 1}_reverseprocess.pdb")
            w.write(path)
            written.append(path)
    for rank, idx in enumerate(result.order):
        conf = float(result.confidence[idx]) if result.confidence is not None else None
        name = f"rank{rank + 1}.sdf" if rank == 0 or conf is None else (
            f"rank{rank + 1}_confidence{conf:.2f}.sdf"
        )
        props = {}
        if conf is not None:
            props["confidence"] = f"{conf:.4f}"
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write(write_sdf(heavy_mol, result.poses[idx], props))
        written.append(path)
    return written
