#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``diffdock_tpu_torch``) on one card.

    python3 chip_smoke.py [--poses 10] [--json PATH]

Phases, each timed on its own line:

1. device: the card's name and power limit;
2. build: every hand-written kernel compiled from ``diffdock_tpu_torch/csrc``
   with ``nvcc`` (plain C interface, loaded with ctypes), one ``nvcc`` per
   source, all started together;
3. kernel vs plain: each kernel's wrapper against its plain PyTorch version
   on the card, at the score model's three blocks and the confidence
   model's three (atom<-lig, atom<-atom, lig<-atom);
4. dock: one DiffDock-L dock (``diffdock_l`` preset at full width, random
   weights from seed 0) of a 32-atom / 320-residue / 2560-receptor-atom
   synthetic complex, 10 poses, the 20-step recipe with 19 steps, ranked by
   the shipped confidence model (the old all-atom architecture at its
   published width, random weights from seed 1). Launch counters are zeroed
   just before and read just after: the gen-3 kernel must have launched
   exactly as often as the two models' code says, and no plain version may
   have run. A 2-step dock before it pays the first-call set-up, so the dock
   is timed warm. Then 5 more warm docks with ranking (median and range of
   their walls), and the confidence forward's peak memory per pose at two
   ligand buckets, the measurement behind the pipeline's chunk rule;
5. the same dock through the plain versions with the same noise: poses,
   confidences and ranking must agree;
6. timings at the six blocks: each kernel (gen 3's float32 kernel as its
   whole call, ``fused_tp3.forward_f32``: it has no torch side), its plain
   version and its library route, with CUDA events, beside the least time
   the card could take: bytes over 3.35 TB/s, or FLOPs over the peak of
   the unit that does them (the two products of every kernel run on the
   tensor cores in 3xTF32, 495 / 3 = 165 TFLOP/s; the coupling that all
   three build inside on the CUDA cores in float32, 67 TFLOP/s), the
   all-float32 bound kept beside. The library route of gen 3 is the einsum pair on the
   coupled operands; that of gens 2 and 1 builds the coupling in PyTorch
   first (the plain version's ``merged_coupled`` and the ``h_aug`` concat),
   with the einsum pair alone beside it;
7. profile: ``torch.profiler`` over a warm 2-step dock with ranking — device
   time by kernel, the hand-written kernels' share and the device's busy
   share;
A. dock from files at full width: random-weight run directories of the
   DiffDock-L score model (seed 0) and the shipped confidence model (seed 1)
   written with the port's ``save_checkpoint`` and read back bit for bit,
   the pipeline built from them on the card through the CLI's
   ``load_pipeline``, ``syn000_l50r368`` (50 atoms, 368 residues) read from
   its SDF, PDB and ESM ``.npy`` and docked by ``dock_mol_protein`` (10
   poses, 19 steps, ``batch_size=5``: two chunks, trajectories saved).
   Gates: 10 ranked SDFs and 10 trajectory PDBs; every SDF parses back with
   finite coordinates in the input's atom order, its bond lengths within
   1e-3 A of the input's and its confidence in rank order; the gen-3 kernel
   launched exactly as often as the code says, no plain version. The plain
   versions follow the kernel dock step by step from its own state (same
   featurized complex, each chunk's same draws): the same start poses, and
   at every step the plain update of the kernel dock's poses within 1e-3 A
   of the kernel dock's next poses (the final poses after the last step);
   the plain confidence model on the kernel dock's own poses within phase
   5's confidence tolerance, and the kernel dock's ranking theirs wherever
   neighbouring confidences differ by more than twice it. The whole plain
   dock from the same draws, and the kernel dock with its start
   translations nudged by 1e-6, are logged beside it without a gate: the
   sampler amplifies float32 rounding on this complex, so that two whole
   docks part by up to 1e-2 A whatever the rounding's source. The wall time is split
   into host (parse, featurize, write) and the dock (its wall until the
   poses are on the host, the host's launch overhead included), with the
   peak memory;
B. the CLI: ``diffdock_tpu_torch.cli.dock.main`` on a CSV of three
   complexes (with the 1547-residue ``syn045_l8r1547``), run directories
   without LM features, 10 poses and the default steps: it must return 0,
   write every complex's ``rank1.sdf`` and launch the gen-3 kernel exactly
   as often as the code says for the three docks, no plain version; then
   the gen-3 kernel against its plain version at the six blocks of
   ``syn045_l8r1547``'s shapes; per-complex wall times;
C. the score model's peak bytes per pose in one denoising step at three
   buckets (two receptor buckets, a second ligand bucket), solved for the
   coefficients of ``inference/pipeline.py:auto_pose_chunk``, and one step
   of 40 poses at the 1547-residue complex's bucket beside the rule's
   prediction;
D. an evaluation sweep: ``diffdock_tpu_torch.cli.evaluate.main`` on a
   PDBBind-layout set of six e2e_synth complexes in six cover entries (the
   largest 1547 residues), with their ESM embeddings and phase A's run
   directories, 10 poses each, the 20-step recipe with 19 steps, the cover
   ladder and the anomaly guard's default (5.0 on a card). Gates: rc 0, no
   failure, the six names, (6, 10) finite RMSDs without a penalty value,
   ``metrics.json``'s keys, the gen-3 kernel launched exactly as often as
   the code says for the six docks and no plain version, no cover entry
   quarantined. On the sweep's own pipeline: one-pose docks at three of
   the entries (each entry's second chunk, so the guard judges them; no
   quarantine), and the ladder's cost model (``inference/ladder.py``: per
   chunk, per pose and per pose and padded area) fitted again from the
   sweep's ten-pose docks and those; the gen-3 kernel against its plain
   version at the six blocks of every complex's cover shapes; and one
   complex through the plain versions with the same draws, held to the
   sweep's own dock: poses within 5e-3 A or twice phase A's nudged spread,
   confidences and ranking as in phase 5, and its per-pose RMSDs within
   the same bound; the sweep's ranked RMSD row must be that dock's. The
   sweep's wall is split into the host's layers (dataset preprocess, RMSD,
   metric tables) and the docks.
E. training: E1 fused_tp3 as an autograd Function (the kernel forward,
   the plain version's VJP backward) against autograd of
   the plain version at the score model's three blocks of phase 3, forward
   and all six input gradients; E2 ``diffdock_tpu_torch.cli.train.main`` at
   DiffDock-L width with ESM features on twelve e2e_synth complexes (eight
   of the (48, 320) bucket, four of (48, 704), all of bond bucket 16) and
   two for validation, batch 4, 2 epochs, one validation-docking round:
   gates on rc, finite train and validation losses in ``metrics.jsonl``,
   every file of the JAX CLI's run directory, fused_tp3 launched in each
   step exactly as the code says with one VJP per forward launch and no
   plain version, and the run's total; then a score-only dock of a
   validation complex from ``last_ema_model`` read by the port's
   ``load_checkpoint``; E3 one step from the saved train state through the
   kernels and one through the plain versions, with the same batch and
   draws, at both buckets and two draws each: loss and metrics, all
   gradient leaves together and each leaf (in norm), the params and the
   batch stats within their stated tolerances, the pre-ReLU units that the
   kernel twin takes on one side only counted, held within rounding of
   zero and pinned to the plain twin's side, and a stand-in forward at
   1xTF32 must fail those limits; E4 the warm step's wall (median
   and range of 5 after 2 untimed) at both buckets, complexes per second,
   peak memory per step, and ``torch.profiler`` over one warm step (device
   time in fused_tp3's forward, in its VJP and elsewhere; the busy share).
F. reference run directories: the DiffDock-L score model (seed 0) and the
   shipped confidence model (seed 1) written as the reference releases them
   (``torch.save`` of a state dict under the reference's key names, made by
   this script's inverse of ``utils/torch_import.py``'s key maps, and a flat
   args dump as ``model_parameters.yml`` written with ``simple_yaml``, from
   which the importer must derive the same configs), converted by
   ``utils/download.py:prepare_model_dir`` (every converted leaf equal to
   the written weights bit for bit; the conversion's wall); the 1547-residue
   ``syn045_l8r1547`` with ESM features docked through the CLI's
   ``load_pipeline`` from those directories and from native ones holding
   the same weights, same seed: identical poses and confidences, exact
   launch counts. Then the same complex with ``--crop_beyond 20``, by mask
   and with ``--pocket_capacity 128``: exact launch counts (the receptor
   embedded at every step), each held to its plain-version twin from the
   same draws (poses within 5e-3 A or twice the spread of a nudged start,
   confidences and ranking as in phase 5), each dock's wall and device-busy
   share, and fused_tp3 against its plain version and timed beside its
   bound at the pocket's row count.
G. confidence training and new-architecture ranking: G1 fused_tp3's
   gradient against its plain version's (as E1) at the training blocks of
   the coarse-grained confidence model at DiffDock-L width (three) and of
   the all-atom one at the shipped model's width (its nine edge types),
   four complexes at the shared (48, 704) bucket with 3328 atom rows; G2
   ``diffdock_tpu_torch.cli.confidence_train.main`` on eight e2e_synth
   complexes (four of (48, 320), four of (48, 704), padded by the CLI to
   one bucket): the CG model (``--ns 48 --nv 10 --num_conv_layers 3
   --num_prot_emb_layers 3``) generating 4 poses per complex with random
   score weights at those widths (``--cache_id 0``), then the all-atom
   model (``--all_atoms --ns 24 --nv 6 --num_conv_layers 5``) on the same
   caches (``--cache_ids_to_combine 0``), batch 4, 2 epochs each. Gates:
   the 8 caches (poses (4, 48, 3), finite RMSDs), exact fused_tp3 counts
   for every generation dock and every step (one VJP per forward launch),
   no plain version, no generation in the second run, finite losses,
   ``last_model.msgpack`` read back bit for bit; G3 one step from each
   saved state through the kernels and through the plain versions for BCE,
   CE (cutoffs 2 and 5, the head's last layer drawn at that width) and
   MSE, under phase E3's limits, the leaves whose exact gradient is zero
   held apart; G4 the warm step's wall (median and range of 5 after 2),
   peak memory and ``torch.profiler`` over one step, per model; G5
   ``syn016_l36r224`` docked through the dock CLI's ``load_pipeline``
   (``diffdock_l`` preset) and ranked by each run directory: exact counts
   (the receptor embedded once), and the plain models' confidences on the
   same poses within CONF_RTOL of scale, the same ranking.
H. bfloat16, the JAX package's default compute dtype (phases 4-G above run
   the CLIs with ``--compute_dtype float32``, so their gates stay
   float32's): H1 fused_tp3's bfloat16 kernel (``csrc/fused_tp3_bf16.cu``)
   against its bfloat16 plain version at phase 3's six blocks and the score
   model's ligand-embedding lig<-lig block (within BF16_KERNEL_RTOL of
   scale, and the same bits from two launches), timed beside the float32
   mode, the plain version, the library pair in bfloat16 (cuBLAS) and its
   bound (2-byte operands over 3.35 TB/s, or both products at the bfloat16
   rate, 989 TFLOP/s), with the share of the bound and the TFLOP/s reached
   and the kernel's plan (receivers per block, slices per block, neighbour
   halves); H2 phase 4's dock with both
   models in bfloat16 from phase 4's draws: launch counts by mode
   (``fused_tp3_bf16`` for the bfloat16 layers, ``fused_tp3`` for
   ``final_conv`` and ``tor_bond_conv``, which stay float32 as in the JAX
   model), no plain version, bond lengths within 1e-3 A, its plain twin
   (first step within BF16_FIRST_STEP_ATOL, final poses within twice the
   spread of a BF16_NUDGE nudge, confidences and ranking as in phase 5), the
   per-pose RMSD to phase 4's float32 dock (reported, no gate), the warm
   wall (median and range of 5) beside phase 4's, peak memory and phase C's
   bytes per pose, and one warm dock under torch.profiler: device time in
   ``fused_tp3_bf16``, in the float32 ``fused_tp3`` and in all; H3 the web server (``diffdock_tpu_torch/app/server.py``)
   in this process on a free port over phase B's run directories with its
   defaults (bfloat16, cuda): three requests from files, each polled to
   ``done``, its ``rank1.sdf`` parsed with bond lengths within 1e-3 A and
   exact launch counts, the walls from submit to done; a bad submit gets
   400; ``python -m diffdock_tpu_torch.cli.main --help`` returns 0.
I. the bfloat16 modes of gens 2 and 1, and training from the other data
   sources: I1 ``factored_tp2`` and ``factored_tp1`` in bfloat16 at
   phase H1's seven blocks against their bfloat16 plain version on the card
   (within BF16_KERNEL_RTOL of scale; gen 1 also with float32 edge_sh, h and
   mw), the same bits from a repeat launch, exact launch counts, the median
   of I1_LAUNCHES launches (``csrc/factored_tp_bf16.cu``) and of as many
   whole calls (the wrapper: prepare and launch) beside the bound (2-byte
   operands over 3.35 TB/s or the products and the CG weights at 989
   TFLOP/s plus the chains at 67, the larger), the plain version and the cuBLAS bfloat16 einsum
   pair, with the kernel's plan (column slices, receivers per block, all
   slices or one class per block, neighbour halves, stages and ring slots,
   the hidden product's width); I2 ``cli/train.py
   --triple_training`` at DiffDock-L's widths (without the LM input, which
   PDBSidechain items lack) on phase E's twelve PDBBind complexes, a MOAD
   layout of three e2e_synth receptors (two poses each) and six receptors
   given full sidechains (``sidechain_pdb``), batch 4, 2 epochs: gates on
   rc, finite losses, every epoch's items from all three sources, each
   step's fused_tp3 launches and VJP calls exact, no plain version; the
   step walls (median and range after 2) and peak memory; I3 one step with
   ``crop_beyond`` 20 A from I2's saved state on a batch of the combined
   stream's first items (two of PDBBind, one of MOAD, one of PDBSidechain,
   padded to one bucket), through the kernels and through the plain
   versions with the same draws: the same receptor crop, within phase E3's
   limits; the share of receptor rows kept.
J. the DiffDock v1.0 score model (``V1_SCORE``: the ICLR'23 paper's score
   model at its published width, ns 48, nv 10, 6 conv layers, ESM 1280;
   random weights from seed 0) on phase 4's complex, ranked by the shipped
   confidence model: J1 fused_tp3 in both modes against its plain version
   at the model's blocks (lig bonded and radius, rec<-rec, lig<-rec,
   rec<-lig; final_conv and tor_bond_conv in float32 only, as the model
   runs them), timed beside the plain version; J2 one warm dock in
   bfloat16 (the JAX dock's default) with ranking: launch counts by mode
   exactly as ``expected_tp3_launches`` gives them for the old family (the
   receptor embedded at every step), no plain version, bond lengths, then
   its plain twin from the same draws (the first step's scores of the two
   models from the same start poses within BF16_MODEL_RTOL of scale, final
   poses within twice a BF16_NUDGE nudge's spread, confidences and ranking
   as in phase 5); J3 the warm wall (median
   and range of V1_TIMED_DOCKS bf16 docks, one float32 dock beside them with
   its own exact counts), launches per dock and peak memory; J4
   ``cli/dock.py`` with ``--old_score_model`` on reference-format
   directories (``.pt`` state dicts under the reference's names from
   ``reference_state_dict``, args dumps from ``reference_args``; no LM
   input) for V1_CLI_STEPS steps: rc 0, a finite ``rank1.sdf``, exact
   counts; J5 one forward each of DiffDock-L with ``factored_tp=False``,
   ``depthwise_convolution`` and ``sidechain_pred`` at one pose on the card,
   each within KERNEL_RTOL of scale of the same forward on the CPU.
K. protein inputs: K1 ESM2-650M (``models/esm2.py`` at its published size:
   33 layers, width 1280, 20 heads, FFN 5120; random weights drawn once on
   the host from seed 0 and copied, so the CPU twin holds the same ones)
   embeds ``syn000_l50r368`` (368 residues, 384 tokens) and
   ``syn045_l8r1547`` (1547, 1664 tokens) on the card in float32 with TF32
   off (the forward's own setting: the same bits with the process's TF32
   on), each within ESM_RTOL of scale of the CPU twin's embed; the median
   of ESM_TIMED walls, the device launches and time of one embed under
   torch.profiler, the peak memory and the FLOP rate beside the float32
   bound; K2 ``make_embedder`` from an npz written by ``save_params`` (a
   two-layer model at the published width) embeds like the module it came
   from, then the slice's path on ``syn000_l50r368``: the 650M embedder
   through ``InferenceDatasetBuilder(esm_embedder=...)``, DiffDock-L (LM
   1280, seed 0) and the shipped confidence model (seed 1), both in
   bfloat16, through ``dock_mol_protein`` with 10 poses and 19 of 20 steps:
   launch counts by mode exactly as ``mode_launches`` gives them, no plain
   version, bond lengths within BOND_ATOL, a finite ranking and
   ``rank1.sdf``; the same dock from a ``LazyNpyTable`` of those
   embeddings gives the same poses and confidences bit for bit, and one
   with zeroed embeddings other poses and, on the same poses, other
   confidences; K3 ``diffdock-tpu-torch esm-prep fasta`` and ``convert`` on
   the two receptors and ``.pt`` files of K1's embeddings: rc 0 and one
   ``.npy`` per complex equal to them; K4 ``diffdock-tpu-torch prewarm``
   over the cover ladder (2 steps, 1 run, a diffdock_s confidence model) in
   a process of its own, one line per job, then again on one bucket: it
   compiles nothing.
L. the device mesh (``diffdock_tpu_torch/parallel/mesh.py``): MESH_RANKS
   ranks started by ``mesh.launch`` share cuda:0 over gloo (NCCL refuses
   two ranks on one device; the arrangement is printed first), each with
   its own process, models and kernel launches, rank 0 building the
   kernels before the others load them. L1 phase 4's dock pose-sharded (5
   poses a rank), each shard from this process's draws for its rank: in
   float32 the gathered poses, confidences and ranking as phase 5 holds
   them to the single-process dock of the joined draws, each rank's
   launches exactly ``mode_launches`` of 5 poses, no plain version; then in
   bfloat16 gated as H2 (counts by mode, bond lengths, ranking; the RMSD to
   the single-process bf16 dock reported). L2 ``dock_batch`` of three of
   phase D's complexes, one per rank, each held to the single-process
   program of its group (``DockingPipeline.dock_program`` at the group's
   bucket and widths, its draws) within 5e-3 A or twice a nudged start's
   spread. L3 data-parallel steps from phase E's train state (DiffDock-L,
   four (48, 320) complexes whose halves hold as many rotatable bonds) and
   from phase G's CG confidence weights, two each, against the
   single-process step of the whole batch from the same start and draws,
   ReLU ties pinned: within phase E3's limits, params bit-identical across
   the ranks, the time in collectives per step. L4 ``python -m
   torch.distributed.run --standalone --nproc_per_node 2 -m
   diffdock_tpu_torch.cli.dock ... --pose_devices 2``: rc 0, the ranked
   SDFs written once. Each sub-phase's wall, each rank's launches and peak
   memory are logged; they are two processes sharing one card, not a
   multi-GPU scaling figure.

It then prints the card line (``nvidia-smi --query-gpu=name,power.limit``),
one JSON line with the kernels' numbers (fused_tp3's bfloat16 mode as
``fused_tp3_bf16``, with phase H's numbers; those of gens 2 and 1 as
``factored_tp2_bf16`` and ``factored_tp1_bf16``, with phase I1's), and,
last, the result line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
the result line; without a CUDA device, or without the package beside
this script, it exits non-zero at once. Nothing runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

F32_PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# H100 SXM dense TF32 on the tensor cores; 3xTF32 takes three products
TF32X3_PEAK_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bfloat16 on the tensor cores

# |kernel - plain| <= KERNEL_RTOL * max(max|plain|, 1): both sum in float32,
# in different orders, over up to K*(H+1) = 46,400 terms per output
KERNEL_RTOL = 1e-4
# max |pose difference| in Angstrom after 19 steps of the kernel path vs
# the plain path from the same noise: float32 reordering only
POSE_ATOL = 5e-3
# max |confidence difference| of the two docks <= CONF_RTOL * max(max|conf|,
# 1): float32 reordering through the 5-layer confidence model, on poses
# that differ by up to POSE_ATOL
CONF_RTOL = 1e-3

# the shipped confidence model (reference inference.py:84, old all-atom
# architecture) at the width bench.py:660-665 gives it, as a change of the
# diffdock_s preset
SHIPPED_CONFIDENCE = dict(ns=24, nv=6, num_conv_layers=5, confidence_mode=True,
                          old_architecture=True, all_atoms=True, lm_embedding_dim=1280)


class PhaseError(RuntimeError):
    pass


def _log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise PhaseError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tp_inputs(tp, rows: int, K: int, H: int, seed: int, device):
    """Random operands of a factored TP contraction at one block's shape:
    (x_nbr, edge_sh, h, mw, out_kernel, out_bias)."""
    import torch

    from diffdock_tpu_torch.ops.spherical import spherical_harmonics

    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device)
    mw = (torch.rand(rows, K, **kw) < 0.7).float()
    x_nbr = torch.randn(rows, K, tp.irreps_in1.dim, **kw)
    sh_dim = tp.irreps_in2.dim
    if sh_dim <= 9:
        edge_sh = spherical_harmonics(torch.randn(rows, K, 3, **kw), 2)[..., :sh_dim]
    else:
        # the torsion head's products of two harmonics
        edge_sh = torch.randn(rows, K, sh_dim, **kw)
    h = torch.relu(torch.randn(rows, K, H, **kw)) * mw[..., None]
    out_kernel = torch.randn(H, tp.weight_numel, **kw) / math.sqrt(H)
    out_bias = torch.randn(tp.weight_numel, **kw) * 0.1
    return x_nbr, edge_sh, h, mw, out_kernel, out_bias


def _class_sums(tp):
    classes = tp.live_classes()
    f_tot = sum(fan * d3 for _k, _o, fan, d3, _m in classes)
    weight = sum(fan * mul * d3 for _k, _o, fan, d3, mul in classes)
    w_len = sum(fan * mul for _k, _o, fan, _d, mul in classes)
    return f_tot, weight, w_len


def tp3_work(tp, rows: int, K: int, H: int):
    """(product FLOPs, coupling FLOPs, bytes) the float32 gen-3 contraction
    must do at least. Its kernel builds the coupling from the inputs as they
    are, as gen 1's does, so its work is :func:`tp1_work`'s: both products,
    each path's CG dot and the coupled columns, each input (x_nbr, edge_sh,
    h, mw, the CG matrix, the weights and bias) read once and the output
    written once. (The benchmark's frozen copy, ``benchmark/work/tp3.py``,
    keeps the earlier count: the coupled tensor read as input, no coupling
    operations.)"""
    return tp1_work(tp, rows, K, H)


def _coupling_flops(tp) -> float:
    """FMAs per edge of the coupled columns: d1 terms for each (u, d)."""
    return float(sum(tp.irreps_in1[p.i].ir.dim * tp.irreps_in1[p.i].mul * ek.ir.dim
                     for pk, ek in zip(tp.paths, tp.irreps_out) for p in pk))


def _cg_weight_terms(tp, gen: int) -> float:
    """FMAs per edge of the CG weights: gen 2, each column's dot over its
    nonzero rows of ``CG_full`` (the terms a dense ``sh @ CG`` has that are
    not zero); gen 1, each path's dot over its own d2 harmonics."""
    import numpy as np

    if gen == 2:
        from diffdock_tpu_torch.ops.factored_tp2 import build_specs2

        cg_full = build_specs2(tp)[1]
        rows_nz = [np.flatnonzero(col) for col in (cg_full != 0).T]
        return float(sum(int(r[-1] - r[0]) + 1 for r in rows_nz if r.size))
    from diffdock_tpu_torch.ops.factored_tp1 import build_specs

    return float(sum(p.d2 * p.d1 * s.d3 for s in build_specs(tp)[0] for p in s.paths))


def tp2_work(tp, rows: int, K: int, H: int):
    """(product FLOPs, coupling FLOPs, bytes) of the gen-2 contraction: P
    over the H+1 live hidden rows and the weight contraction; the CG
    weights (each column's dot over its nonzero rows of ``CG_full``, the
    terms a dense ``sh @ CG`` has that are not zero) and the coupled
    columns; it reads the neighbour features (x_nbr, whose per-path packed
    copy is a layout of the kernel's own), the harmonics, the H+1 live rows
    of ``h_aug``, the CG matrix and the (H+1, fan, mul) weights once and
    writes the output."""
    import numpy as np

    from diffdock_tpu_torch.ops.factored_tp2 import build_specs2

    _specs, cg_full, _xp_dim, out_dim = build_specs2(tp)
    f_tot, weight, w_len = _class_sums(tp)
    J, Ha, xp_dim = tp.irreps_in2.dim, H + 1, tp.irreps_in1.dim
    products = 2.0 * rows * Ha * K * f_tot + 2.0 * rows * Ha * weight
    coupling = 2.0 * rows * K * (_cg_weight_terms(tp, 2) + _coupling_flops(tp))
    nbytes = 4.0 * (rows * K * (xp_dim + J + Ha) + cg_full.size + Ha * w_len + rows * out_dim)
    return products, coupling, nbytes


def tp1_work(tp, rows: int, K: int, H: int):
    """(product FLOPs, coupling FLOPs, bytes) of the gen-1 contraction: p_h
    and p_b, the weight and bias contractions; each path's CG dot over its
    own d2 harmonics and the coupled columns; it reads the neighbour
    features (x_nbr), the harmonics, h, mw, the CG matrix, the weights and
    the bias once and writes the output."""
    from diffdock_tpu_torch.ops.factored_tp1 import build_specs

    specs, cg_all, _xp_dim, out_dim = build_specs(tp)
    xp_dim = tp.irreps_in1.dim
    f_tot, weight, w_len = _class_sums(tp)
    products = 2.0 * rows * (H + 1) * K * f_tot + 2.0 * rows * (H + 1) * weight
    coupling = 2.0 * rows * K * (_cg_weight_terms(tp, 1) + _coupling_flops(tp))
    nbytes = 4.0 * (rows * K * (xp_dim + tp.irreps_in2.dim + H + 1) + cg_all.size
                    + (H + 1) * w_len + rows * out_dim)
    return products, coupling, nbytes


def bound_ms(products: float, coupling: float, nbytes: float, all_f32: bool = False):
    """(ms, "operations" or "bytes"): the larger of the bytes over the HBM
    rate and the operations over their units' peaks, the products at the
    3xTF32 rate and the coupling at the float32 rate (both at the float32
    rate with ``all_f32``), their times added."""
    t_ops = (products / (F32_PEAK_FLOPS if all_f32 else TF32X3_PEAK_FLOPS)
             + coupling / F32_PEAK_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def expected_tp3_launches(cfg, n_steps: int, n_bonds: int) -> int:
    """Merged TP contractions of the score model in one dock: receptor
    embedding once; per step the layer-0 rec<-rec precompute, the ligand
    embedding (bonded + radius blocks), the joint layers (3 ligand blocks
    each; the receptor's cross block, plus its rec<-rec block after layer
    0; none in the last layer), the center head and the torsion head.
    Under ``crop_beyond`` the receptor embedding runs at every step and
    the layer-0 rec<-rec block inside the forward, not once and in the
    step cache. The v1.0 family (``old_architecture``) has no receptor
    cache: per step its whole conv stack (as many contractions as its
    confidence forward) and the two heads."""
    if cfg.old_architecture:
        from diffdock_tpu_torch.models.old_models import confidence_launches

        return n_steps * (confidence_launches(cfg) + 1 + (1 if not cfg.no_torsion and n_bonds > 0 else 0))
    npe, nj = cfg.num_prot_emb_layers, cfg.num_conv_layers
    per_step = 1 if nj > 1 else 0
    per_step += 2 * npe if cfg.embed_also_ligand else 0
    for i in range(nj):
        per_step += 3
        if i < nj - 1:
            per_step += 1 if (i == 0 and nj > 1) else 2
    per_step += 1  # final_conv
    if not cfg.no_torsion and n_bonds > 0:
        per_step += 1  # tor_bond_conv
    if cfg.crop_beyond is not None:
        return n_steps * (npe + per_step)
    return npe + n_steps * per_step


def _check(label, got, ref, checks):
    import torch

    err = (got - ref).abs().max().item()
    scale = max(ref.abs().max().item(), 1.0)
    ok = bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale
    checks[label] = {"max_abs_err": err, "max_abs_ref": scale, "ok": ok}
    return err, scale, ok


def tp_blocks(model, cmodel, cfg, ccfg, data, aa, poses: int, conf_poses: int, bucket=None) -> dict:
    """The merged contractions at a complex's padded shapes (``bucket``'s
    (nl, nr), else the fine ladder's): the score model's three blocks for
    ``poses`` poses in flight and three of the confidence model's (layer
    L-2, the last with atom receivers; its TP is the ladder's widest) for
    ``conf_poses``: label -> (tp, rows, K, H)."""
    from diffdock_tpu_torch.data.complexes import atom_bucket, bucket_sizes

    nl, nr, _ = bucket if bucket is not None else bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)
    na = atom_bucket(aa.n_atoms)
    H, Hc, L = 3 * cfg.ns, 3 * ccfg.ns, ccfg.num_conv_layers
    conv_tp = model.conv_layers[0].tp
    return {
        "rec<-lig cross (conv)": (conv_tp, poses * nr, nl, H),
        "lig<-rec cross (conv)": (conv_tp, poses * nl, nr, H),
        "rec<-rec (rec_emb_2)": (model.rec_emb_layers[-1].tp, nr, data.rec_nbr.shape[1], H),
        "atom<-lig cross (confidence)": (cmodel.conv_layers[9 * (L - 2) + 4].tp, conf_poses * na, nl, Hc),
        "atom<-atom (confidence)": (cmodel.conv_layers[9 * (L - 2) + 3].tp, conf_poses * na,
                                    aa.atom_nbr.shape[1], Hc),
        "lig<-atom cross (confidence)": (cmodel.conv_layers[9 * (L - 2) + 2].tp, conf_poses * nl, na, Hc),
    }


def kernel_routes():
    """(wrapper, plain version) of each kernel, by name."""
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2
    from diffdock_tpu_torch.ops import fused_tp3 as ft

    wrappers = {"fused_tp3": ft.fused_tp3, "factored_tp2": f2.factored_tp2,
                "factored_tp1": f1.factored_tp1}
    plain = {"fused_tp3": ft.fused_tp3_reference, "factored_tp2": f2.factored_tp_reference,
             "factored_tp1": f2.factored_tp_reference}
    return wrappers, plain


def check_blocks(kernels, blocks: dict, dev, tag: str = "") -> dict:
    """Each kernel's wrapper against its plain version at every block, on
    the same random operands; raises at the first disagreement."""
    import torch

    wrappers, plain = kernel_routes()
    checks = {k: {} for k in kernels}
    with torch.inference_mode():
        for kname in kernels:
            for i, (label, (tp, rows, K, Hb)) in enumerate(blocks.items()):
                inp = tp_inputs(tp, rows, K, Hb, seed=i, device=dev)
                got = wrappers[kname](tp, *inp)
                ref = plain[kname](tp, *inp)
                torch.cuda.synchronize()
                err, scale, ok = _check(label, got, ref, checks[kname])
                f_tot = sum(fan * d3 for _k, _o, fan, d3, _m in tp.live_classes())
                checks[kname][label].update(rows=rows, K=K, H=Hb, F_tot=f_tot,
                                            W_tot=tp.irreps_out.dim)
                _log(f"  {kname} {label}{tag}: R={rows} K={K} H+1={Hb + 1} F_tot={f_tot} "
                     f"W_tot={tp.irreps_out.dim} max_abs_err={err:.3e} "
                     f"(tol {KERNEL_RTOL:.0e} x {scale:.3g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseError(f"{kname} disagrees with its plain version at {label}{tag}")
                del inp, got, ref
    return checks


def docks_agree(res, ref_res, pose_tol: float = POSE_ATOL, conf_tol=None) -> dict:
    """The dock through the kernels against the same dock through the plain
    versions: poses within ``pose_tol``, confidences within ``conf_tol``
    (default CONF_RTOL of their scale), and the same ranking wherever
    neighbouring confidences (the plain dock's order) differ by more than
    twice that; raises otherwise."""
    import numpy as np

    pose_err = float(np.abs(res.poses - ref_res.poses).max())
    conf_err = float(np.abs(res.confidence - ref_res.confidence).max())
    if conf_tol is None:
        conf_tol = CONF_RTOL * max(float(np.abs(ref_res.confidence).max()), 1.0)
    rank_ok = all(res.confidence[a] > res.confidence[b]
                  for a, b in zip(ref_res.order[:-1], ref_res.order[1:])
                  if ref_res.confidence[a] - ref_res.confidence[b] > 2 * conf_tol)
    _log(f"  max |poses(kernel) - poses(plain)| = {pose_err:.3e} A (tol {pose_tol:.3e}); "
         f"max |conf(kernel) - conf(plain)| = {conf_err:.3e} (tol {conf_tol:.3e}); "
         f"order {res.order.tolist()} vs {ref_res.order.tolist()}")
    if not pose_err <= pose_tol:
        raise PhaseError("kernel-path and plain-path poses disagree")
    if not conf_err <= conf_tol:
        raise PhaseError("kernel-path and plain-path confidences disagree")
    if not rank_ok:
        raise PhaseError("kernel-path and plain-path rankings disagree")
    return {"max_abs_pose_diff": pose_err, "pose_tol": pose_tol, "max_abs_conf_diff": conf_err,
            "conf_tol": conf_tol, "order": ref_res.order.tolist(), "ranking_agrees": rank_ok}


def mode_launches(pipe, data, aa, poses: int, batch_size=None) -> dict:
    """fused_tp3 launches of one ``dock_complex`` of ``poses`` poses by mode:
    per pose chunk one score dock, a new-architecture confidence model's
    receptor embedding and its confidence forwards, in the bucket the
    pipeline's ladder gives the complex. The bfloat16 conv layers of a
    bfloat16 model count as ``fused_tp3_bf16``; ``final_conv`` and
    ``tor_bond_conv`` (float32 in any model, as in the JAX package) and
    every layer of a float32 model as ``fused_tp3``."""
    from diffdock_tpu_torch.models.old_models import confidence_launches

    cfg, ccfg = pipe.score_cfg, pipe.confidence_cfg
    chunk = pipe.effective_pose_chunk(data, poses, batch_size)
    conf_chunk = pipe.confidence_chunk_for(pipe.confidence_input(data, aa), chunk)
    nb = pipe.dock_bucket(data)[0][2]
    steps = pipe.sampler_cfg.num_steps
    score = expected_tp3_launches(cfg, steps, nb)
    heads = steps * (1 + (1 if not cfg.no_torsion and nb > 0 else 0))
    conf = confidence_launches(ccfg, embed=True) + -(-chunk // conf_chunk) * confidence_launches(ccfg)
    out = {"fused_tp3": 0, "fused_tp3_bf16": 0}
    out["fused_tp3_bf16" if cfg.compute_dtype == "bfloat16" else "fused_tp3"] += score - heads
    out["fused_tp3"] += heads
    out["fused_tp3_bf16" if ccfg.compute_dtype == "bfloat16" else "fused_tp3"] += conf
    n_chunks = -(-poses // chunk)
    return {k: n_chunks * v for k, v in out.items()}


def dock_launches(pipe, data, aa, poses: int, batch_size=None) -> int:
    """fused_tp3 launches of one ``dock_complex``, both modes together."""
    return sum(mode_launches(pipe, data, aa, poses, batch_size).values())


def run(args) -> dict:
    import numpy as np
    import torch

    from diffdock_tpu_torch.data.complexes import atom_bucket, bucket_sizes, synthetic_aa_complex
    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables
    from diffdock_tpu_torch.geometry import use_full_fp32
    from diffdock_tpu_torch.inference.pipeline import (
        CONF_BUDGET_BYTES,
        DockingPipeline,
        auto_confidence_chunk,
    )
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.models.old_models import confidence_launches
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2
    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.utils import build

    report: dict = {"phases": {}}
    dev = torch.device("cuda")
    use_full_fp32()
    kernels = {"fused_tp3": ft, "factored_tp2": f2, "factored_tp1": f1}

    # 1. device
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    report["device"] = {"name": name, "card": card, "count": torch.cuda.device_count(),
                        "torch": torch.__version__, "cuda": torch.version.cuda}
    _log(f"[1 device] {name} | {card} | torch {torch.__version__} cuda {torch.version.cuda} "
         f"| {time.perf_counter() - t0:.1f} s")

    # 2. build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    build.build_all({k: m._SOURCES for k, m in kernels.items()})
    for m in kernels.values():
        m._get_kernel()
    report["phases"]["build_s"] = time.perf_counter() - t0
    for lib, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  ptxas {lib}: {line.strip()}")
    _log(f"[2 build] {', '.join(kernels)} | {report['phases']['build_s']:.1f} s")

    # the complex and the models of the main path
    cfg = PRESETS["diffdock_l"]
    ccfg = dataclasses.replace(PRESETS["diffdock_s"], **SHIPPED_CONFIDENCE)
    sampler = SamplerConfig()  # 20-step schedule, 19 steps
    rng = np.random.RandomState(0)
    aa = synthetic_aa_complex(rng, n_lig=32, n_rec=320, n_bonds=6, atoms_per_res=8,
                              lm_dim=cfg.lm_embedding_dim)
    data = aa.base
    nl, nr, nb = bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)
    na = atom_bucket(aa.n_atoms)
    P = args.poses
    t0 = time.perf_counter()
    so3 = get_so3_tables(device=dev)
    torus = get_torus_tables(device=dev)
    report["phases"]["tables_s"] = time.perf_counter() - t0
    _log(f"[tables] SO(3) {tuple(so3.score_norms.shape)} + torus {tuple(torus.score_table.shape)} "
         f"| {report['phases']['tables_s']:.1f} s")
    models = dict(confidence_cfg=ccfg, confidence_weights=1)
    pipe = DockingPipeline(cfg, 0, sampler, so3, torus, device=dev, **models)
    model, cmodel = pipe.model, pipe.confidence_model

    # 3. kernel vs plain at the main path's shapes, for every kernel
    t0 = time.perf_counter()
    blocks_all = tp_blocks(model, cmodel, cfg, ccfg, data, aa, P, P)
    checks = check_blocks(kernels, blocks_all, dev)
    report["kernel_checks"] = checks
    _log(f"[3 kernel vs plain] {', '.join(kernels)} | {time.perf_counter() - t0:.1f} s")

    # warm-up: a 2-step dock with ranking pays the first-call set-up
    # (cuBLAS/cuSOLVER handles, lazy module loading) outside the timed dock
    t0 = time.perf_counter()
    warm = DockingPipeline(cfg, 0, SamplerConfig(inference_steps=2, actual_steps=2), so3, torus,
                           device=dev, **models)
    warm.dock_complex(data, num_poses=P, seed=1, aa_data=aa)
    torch.cuda.synchronize()
    report["phases"]["warmup_s"] = time.perf_counter() - t0
    _log(f"[warm-up] 2-step dock with ranking | {report['phases']['warmup_s']:.2f} s")

    # 4. dock one complex through the kernels and rank it (the main path)
    drawn = pipe.draw_noise(P, nb, seed=0)

    def noise(num_poses, n_bonds, seed):
        return drawn
    conf_input = pipe.confidence_input(data, aa)
    chunk = pipe.confidence_chunk_for(conf_input, P)
    n_chunks = -(-P // chunk)
    expected = (expected_tp3_launches(cfg, sampler.num_steps, nb)
                + n_chunks * confidence_launches(ccfg))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for m in kernels.values():
        m.counts.reset()
    t0 = time.perf_counter()
    res = pipe.dock_complex(data, num_poses=P, seed=0, noise=noise, aa_data=aa)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for m in kernels.values() for k, v in m.counts.as_dict().items()}
    peak = torch.cuda.max_memory_allocated()
    report["dock"] = {"wall_s": wall, "poses_per_s": P / wall, "max_memory_allocated": peak,
                      "launches": launches, "expected_fused_tp3": expected,
                      "confidence_chunk": chunk,
                      "complex": {"n_lig": data.n_lig, "n_rec": data.n_rec, "n_bonds": data.n_bonds,
                                  "n_atoms": aa.n_atoms, "bucket": [nl, nr, nb, na]},
                      "poses": P, "steps": sampler.num_steps,
                      "confidence": res.confidence.tolist(), "order": res.order.tolist()}
    _log(f"  launches {launches} (expected fused_tp3 = {expected}: score "
         f"{expected_tp3_launches(cfg, sampler.num_steps, nb)} + {n_chunks} confidence chunk(s) "
         f"of {chunk} poses x {confidence_launches(ccfg)})")
    if res.poses.shape != (P, data.n_lig, 3) or not np.isfinite(res.poses).all():
        raise PhaseError(f"dock gave poses {res.poses.shape}, finite={np.isfinite(res.poses).all()}")
    if res.confidence.shape != (P,) or not np.isfinite(res.confidence).all():
        raise PhaseError(f"dock gave confidences {res.confidence}")
    if sorted(res.order.tolist()) != list(range(P)) or \
            np.any(np.diff(res.confidence[res.order]) > 0):
        raise PhaseError(f"order {res.order} does not rank confidences {res.confidence}")
    plain_runs = {k: v for k, v in launches.items() if "reference" in k and v}
    if launches["fused_tp3"] != expected or plain_runs:
        raise PhaseError(f"launch counts {launches} != expected {expected} fused_tp3 / 0 plain")
    _log(f"[4 dock] diffdock_l + shipped confidence, {P} poses, {sampler.num_steps} steps | "
         f"{wall:.2f} s | {P / wall:.3f} poses/s | peak {peak / 2**30:.2f} GiB | {card}")
    _log(f"  confidences {np.round(res.confidence, 4).tolist()} order {res.order.tolist()}")

    # 5 more warm docks with ranking: the spread of the dock's wall
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.dock_complex(data, num_poses=P, seed=0, noise=noise, aa_data=aa)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    report["dock"]["repeat_wall_s"] = walls
    med = float(np.median(walls))
    _log(f"  5 warm docks with ranking: median {med:.4f} s ({P / med:.3f} poses/s), "
         f"min {min(walls):.4f} s, max {max(walls):.4f} s | {card}")

    # the confidence forward's peak memory per pose, all poses in one chunk,
    # at two ligand buckets: the measurement behind auto_confidence_chunk
    t0 = time.perf_counter()
    final = torch.as_tensor(res.poses - np.asarray(data.original_center)[None, None],
                            dtype=torch.float32, device=dev)
    mem = {}
    for nl_m in (nl, 2 * nl):
        base = conf_input.base
        grow = {f: _pad_rows(getattr(base, f), nl_m - nl)
                for f in ("lig_cat", "lig_mask", "lig_pos", "lig_bond_nbr", "lig_bond_mask",
                          "lig_bond_attr")}
        cin = conf_input._replace(base=base._replace(**grow))
        poses_m = _pad_rows(final.transpose(0, 1), nl_m - data.n_lig).transpose(0, 1)
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            cmodel(cin, poses_m, 0.0)
        torch.cuda.synchronize()
        mem[nl_m] = (torch.cuda.max_memory_allocated() - base_bytes) / P
    per_edge = (mem[2 * nl] - mem[nl]) / (nl * na)
    per_node = (mem[nl] - per_edge * nl * na) / na
    report["confidence_memory"] = {
        "bytes_per_pose": {str(k): v for k, v in mem.items()}, "n_nodes": na,
        "bytes_per_edge": per_edge, "bytes_per_node": per_node,
        "chunk_rule": {"budget_bytes": CONF_BUDGET_BYTES,
                       "chunk_at_main_shape": auto_confidence_chunk(nl, na, 10 ** 6)},
    }
    _log(f"  confidence peak per pose: {', '.join(f'nl={k}: {v / 2**20:.1f} MiB' for k, v in mem.items())}"
         f" at {na} atoms -> {per_edge:.0f} B per ligand-atom edge + {per_node:.0f} B per atom "
         f"| chunk rule gives {auto_confidence_chunk(nl, na, 10 ** 6)} poses at this shape "
         f"| {time.perf_counter() - t0:.1f} s")

    # 5. the same dock through the plain versions, same noise
    t0 = time.perf_counter()
    ref_pipe = DockingPipeline(cfg, 0, sampler, so3, torus, device=dev, reference_kernels=True,
                               **models)
    ref_res = ref_pipe.dock_complex(data, num_poses=P, seed=0, noise=noise, aa_data=aa)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    report["dock_plain"] = dict(docks_agree(res, ref_res), wall_s=ref_wall)
    _log(f"[5 dock plain] {ref_wall:.2f} s")
    del ref_pipe

    # 6. timings at the six blocks for every kernel
    t0 = time.perf_counter()
    wrappers, plain = kernel_routes()
    work = {"fused_tp3": tp3_work, "factored_tp2": tp2_work, "factored_tp1": tp1_work}
    timings = {k: {} for k in kernels}
    with torch.inference_mode():
        for i, (label, (tp, rows, K, Hb)) in enumerate(blocks_all.items()):
            inp = tp_inputs(tp, rows, K, Hb, seed=i, device=dev)
            # the einsum pair's operands: the coupled tensor and h_aug, built
            # in PyTorch (gen 3 reads the inputs as they are)
            classes, coupled = ft.merged_coupled(tp, inp[0], inp[1])
            h_aug = torch.cat([inp[2], inp[3][..., None]], dim=-1)
            t3 = _block_diag_t3(tp, classes, inp[4], inp[5])

            def einsum_pair(h_aug, coupled):
                return torch.einsum("rhF,hFW->rW", torch.einsum("rkh,rkF->rhF", h_aug, coupled), t3)

            def coupled_route():
                # the library route from the raw inputs: the coupling in
                # PyTorch, then the einsum pair
                coupled_t = ft.merged_coupled(tp, inp[0], inp[1])[1]
                return einsum_pair(torch.cat([inp[2], inp[3][..., None]], dim=-1), coupled_t)

            pair_ms = cuda_ms(lambda: einsum_pair(h_aug, coupled), args.iters)
            route_ms = cuda_ms(coupled_route, args.iters)
            op2, op1 = f2.prepare(tp, *inp), f1.prepare(tp, *inp)
            launchers = {"fused_tp3": lambda: ft.forward_f32(tp, *inp),
                         "factored_tp2": lambda: f2.launch(*op2, tp.irreps_out.dim),
                         "factored_tp1": lambda: f1.launch(*op1, tp.irreps_out.dim)}
            for kname, launch in launchers.items():
                kernel_ms = cuda_ms(launch, args.iters)
                wrapper_ms = cuda_ms(lambda: wrappers[kname](tp, *inp), args.iters)
                plain_ms = cuda_ms(lambda: plain[kname](tp, *inp), args.iters)
                library_ms = pair_ms if kname == "fused_tp3" else route_ms
                products, coupling, nbytes = work[kname](tp, rows, K, Hb)
                b_ms, b_by = bound_ms(products, coupling, nbytes)
                f32_ms, f32_by = bound_ms(products, coupling, nbytes, all_f32=True)
                timings[kname][label] = {
                    "ms": kernel_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "einsum_pair_ms": pair_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "bound_f32_ms": f32_ms, "bound_f32_by": f32_by,
                    "product_flops": products, "coupling_flops": coupling, "bytes": nbytes}
                flops = products + coupling
                route = ("" if kname == "fused_tp3" else
                         f"library route (coupling + einsum pair) {route_ms:.4f} ms | ")
                _log(f"  {kname} {label}: kernel {kernel_ms:.4f} ms | wrapper {wrapper_ms:.4f} ms | "
                     f"plain {plain_ms:.4f} ms | {route}library einsum pair {pair_ms:.4f} ms | bound "
                     f"{b_ms:.4f} ms ({b_by}; {products / 1e9:.2f} + {coupling / 1e9:.2f} GFLOP, "
                     f"{nbytes / 1e6:.1f} MB; float32 bound {f32_ms:.4f} ms) | "
                     f"{flops / kernel_ms / 1e9:.2f} TFLOP/s")
            del inp, h_aug, coupled, t3, launchers, op2, op1
    report["timings"] = timings
    _log(f"[6 timings] {time.perf_counter() - t0:.1f} s")

    # 7. where a dock's device time goes
    t0 = time.perf_counter()
    report["profile"] = profile_dock(warm, data, aa, P)
    _log(f"[7 profile] 2-step dock with ranking | {time.perf_counter() - t0:.1f} s")
    del warm

    with tempfile.TemporaryDirectory() as tmp:
        report["file_dock"], file_pipe = file_dock(args, Path(tmp), cfg, ccfg, kernels, card)
        report["cli"] = cli_dock(args, Path(tmp), cfg, ccfg, kernels, file_pipe, card)
        del file_pipe
        report["score_memory"] = score_memory(pipe, cfg, card)
        del pipe
        nudge = report["file_dock"]["plain"]["nudge_gap"][-1]
        report["eval_sweep"] = eval_sweep(args, Path(tmp), cfg, ccfg, kernels, nudge, card)
        score_blocks = dict(list(blocks_all.items())[:3])
        report["train"] = train_phase(args, Path(tmp), cfg, kernels, score_blocks, card, dev)
        report["reference_dirs"] = reference_dirs(args, Path(tmp), cfg, ccfg, kernels, card)
        report["confidence"] = confidence_phase(args, Path(tmp), kernels, card, dev)
        # phase H1 adds the score model's ligand-embedding lig<-lig radius
        # block (poses x nl receivers, nl neighbours) to the six
        bf16_blocks = dict(blocks_all)
        bf16_blocks["lig<-lig (lig_emb_2)"] = (model.lig_emb_layers[-1].tp, P * nl, nl, 3 * cfg.ns)
        report["bf16"] = bf16_phase(args, Path(tmp), cfg, ccfg, bf16_blocks, report["dock"], res, noise,
                                    data, aa, so3, torus, card, dev)
        t0 = time.perf_counter()
        report["bf16_factored"] = factored_bf16_kernels(bf16_blocks, card, dev)
        _log(f"[I1 bf16 gens 2 and 1 vs plain] {len(bf16_blocks)} blocks | {card} | "
             f"{time.perf_counter() - t0:.1f} s")
        report["combined_train"] = combined_training_phase(Path(tmp), kernels, card, dev)
        report["v1"] = v1_phase(args, Path(tmp), ccfg, data, aa, noise, so3, torus, card, dev)
        report["esm"] = esm_phase(args, Path(tmp), ccfg, so3, torus, kernels, card, dev)
        report["mesh"] = mesh_phase(args, Path(tmp), cfg, ccfg, data, aa, so3, torus, card, dev)

    sources = {"fused_tp3": "diffdock_tpu/ops/pallas_tpconv3.py:57",
               "fused_tp3_bf16": "diffdock_tpu/ops/pallas_tpconv3.py:57",
               "factored_tp2": "diffdock_tpu/ops/pallas_tpconv2.py:125",
               "factored_tp1": "diffdock_tpu/ops/pallas_tpconv.py:118"}
    report["kernels"] = []
    for kname in kernels:
        main = timings[kname]["rec<-lig cross (conv)"]
        report["kernels"].append({
            "name": kname,
            "route": "cuda",
            "source": f"diffdock_tpu_torch/csrc/{kname}.cu",
            "replaces": sources[kname],
            "launches": launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in checks[kname].values()),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
        })
    # the bfloat16 modes of gens 2 and 1 (phase I1): like their float32
    # modes, no path of the system launches them (phase 4's dock counted 0)
    for kname in ("factored_tp2_bf16", "factored_tp1_bf16"):
        i1 = report["bf16_factored"][kname]
        main = i1["rec<-lig cross (conv)"]
        report["kernels"].append({
            "name": kname, "route": "cuda", "source": "diffdock_tpu_torch/csrc/factored_tp_bf16.cu",
            "replaces": sources[kname[:-5]], "launches": launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in i1.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        })
    # the bfloat16 mode: its launches are those of phase H2's dock, the
    # bfloat16 main path
    h1 = report["bf16"]["kernel"]
    main = h1["rec<-lig cross (conv)"]
    report["kernels"].append({
        "name": "fused_tp3_bf16", "route": "cuda", "source": "diffdock_tpu_torch/csrc/fused_tp3_bf16.cu",
        "replaces": sources["fused_tp3_bf16"],
        "launches": report["bf16"]["dock"]["launches"]["fused_tp3_bf16"],
        "max_abs_err": max(c["max_abs_err"] for c in h1.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
    })
    return report


# the complexes phases A and B read (.chiprunignore keeps these files, and
# only these ESM embeddings, in copies of the tree for a card)
E2E_SYNTH = Path(__file__).resolve().parent / "data" / "e2e_synth"
FILE_DOCK_COMPLEX = "syn000_l50r368"  # 50 ligand atoms, 368 residues
CLI_COMPLEXES = ("syn000_l50r368", "syn001_l24r104", "syn045_l8r1547")
BOND_ATOL = 1e-3  # Angstrom: rigid moves and torsions keep bond lengths
# max |pose difference| in Angstrom after one step from the same state,
# kernel path vs plain path with the same draws (the bound of the CPU
# file-dock tests on the first step): one step of float32 reordering,
# before the sampler amplifies it
STEP_ATOL = 1e-3
# relative nudge of the start translations that measures how far float32
# rounding moves this dock's final poses: on this real complex the sampler
# amplifies a difference of 1e-4 A to 1e-2 A in one pose, whatever its
# source (phase D's twin tolerance reads it)
NUDGE = 1e-6


def _write_run_dirs(root: Path, cfg, ccfg) -> dict:
    """Random-weight run directories (score model from seed 0, confidence
    model from seed 1) written with the port's save_checkpoint, read back
    with load_checkpoint and checked bit for bit."""
    import numpy as np
    import torch

    from diffdock_tpu_torch.models.old_models import build_confidence_model
    from diffdock_tpu_torch.models.score_model import CGScoreModel
    from diffdock_tpu_torch.train.checkpoints import load_checkpoint, save_checkpoint
    from diffdock_tpu_torch.utils.convert import flax_from_model

    dirs = {}
    for name, c, build, seed in (("score", cfg, CGScoreModel, 0),
                                 ("confidence", ccfg, build_confidence_model, 1)):
        model = build(c)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        tree = flax_from_model(model)
        save_checkpoint(str(root / name), tree, c)
        back, c_back, _ = load_checkpoint(str(root / name))
        if c_back != c:
            raise PhaseError(f"{name} run dir: config {c_back} != {c}")
        if not _same_tree(tree, back):
            raise PhaseError(f"{name} run dir: parameters read back differ")
        dirs[name] = str(root / name)
        n = sum(np.asarray(v).size for v in _leaves(tree))
        _log(f"  {name} run dir: {n} parameters written and read back bit for bit")
    return dirs


def _same_tree(a, b) -> bool:
    """Equal keys, and arrays equal bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_same_tree(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def follow_steps(pipe, ref_pipe, data, noise, kw: dict):
    """The plain pipeline ``ref_pipe`` held to ``pipe``'s dock step by step,
    from ``pipe``'s own state, as the benchmark's check holds a dock: ``pipe``
    docks ``data`` with ``noise`` (``kw`` as for ``dock_complex``) keeping
    the poses each score forward starts from; ``ref_pipe`` then docks from
    the same draws with its poses set to those before each forward, so that
    each of its steps starts where ``pipe``'s did. Returns the start gap
    (the largest distance, Angstrom, between the two docks' start poses)
    and, per step, the largest distance between ``pipe``'s poses after the
    step (the final poses after the last) and ``ref_pipe``'s update of the
    same state, the worst over the pose chunks (real ligand atoms)."""
    import numpy as np

    if pipe.score_cfg.crop_beyond is not None:
        raise PhaseError("follow_steps: a cropped score forward reads the poses before the model")
    n, states, gaps = data.n_lig, [], []

    def keep(_module, args):
        states.append(args[1].clone())

    hook = pipe.model.register_forward_pre_hook(keep)
    try:
        res = pipe.dock_complex(data, noise=noise, **kw)
    finally:
        hook.remove()

    def follow(_module, args):
        i, poses = len(gaps), args[1]
        if i >= len(states) or poses.shape != states[i].shape:
            raise PhaseError(f"follow_steps: the plain dock's forward {i} does not match the kernel dock's")
        gaps.append(float((poses[:, :n] - states[i][:, :n]).abs().max()))
        poses.copy_(states[i])

    hook = ref_pipe.model.register_forward_pre_hook(follow)
    try:
        ref_res = ref_pipe.dock_complex(data, noise=noise, **kw)
    finally:
        hook.remove()
    steps = pipe.sampler_cfg.num_steps
    if len(gaps) != len(states) or len(states) % steps:
        raise PhaseError(f"follow_steps: {len(states)} kernel forwards, {len(gaps)} plain, {steps} steps")
    per_chunk = np.asarray(gaps).reshape(-1, steps)
    held = per_chunk[:, 1:].max(axis=0).tolist() + [float(np.abs(res.poses - ref_res.poses).max())]
    return float(per_chunk[:, 0].max()), held


def file_dock(args, tmp: Path, cfg, ccfg, kernels, card: str):
    """Phase A: dock one e2e_synth complex from its files through run
    directories, at full width, check what is written, and hold the dock
    against the same dock through the plain versions. Returns the report
    and the pipeline."""
    import numpy as np
    import torch

    from diffdock_tpu_torch.cli import dock as cli
    from diffdock_tpu_torch.data import chem
    from diffdock_tpu_torch.data.complexes import bucket_sizes
    from diffdock_tpu_torch.data.esm import LazyNpyTable
    from diffdock_tpu_torch.data.inference_dataset import InferenceDatasetBuilder, InferenceSpec
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.native import have_native, load_error

    t_start = time.perf_counter()
    if not have_native():
        raise PhaseError(f"the native kNN library did not load: {load_error}")
    dirs = _write_run_dirs(tmp / "runs_lm", cfg, ccfg)
    args_cli = cli.get_parser().parse_args(["--model_dir", dirs["score"], "--confidence_model_dir",
                                            dirs["confidence"], "--compute_dtype", "float32",
                                            "--device", "cuda"])
    pipe = cli.load_pipeline(args_cli)
    name = FILE_DOCK_COMPLEX
    d = E2E_SYNTH / name
    spec = InferenceSpec(name, str(d / f"{name}_protein_processed.pdb"),
                         ligand_description=str(d / f"{name}_ligand.sdf"))
    builder = InferenceDatasetBuilder(esm_table=LazyNpyTable(str(E2E_SYNTH / "_esm")))
    t0 = time.perf_counter()
    mol, protein, lm = builder.load(spec)
    parse_s = time.perf_counter() - t0
    if lm is None or lm.shape[1] != cfg.lm_embedding_dim:
        raise PhaseError(f"no {cfg.lm_embedding_dim}-wide ESM embeddings for {name}")

    P, batch = args.poses, 5
    data, aa, heavy = pipe.featurize(mol, protein, lm)
    chunk = pipe.effective_pose_chunk(data, P, batch)
    n_chunks = -(-P // chunk)
    conf_chunk = pipe.confidence_chunk_for(pipe.confidence_input(data, aa), chunk)
    bucket = bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)
    expected = dock_launches(pipe, data, aa, P, batch)
    drawn = {}  # each chunk's draws, by seed, for the plain dock below

    def noise(num_poses, n_bonds, seed):
        drawn[seed] = pipe.draw_noise(num_poses, n_bonds, seed)
        return drawn[seed]

    out = tmp / "file_dock"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in kernels.values():
        m.counts.reset()
    t0 = time.perf_counter()
    res = pipe.dock_mol_protein(mol, protein, str(out), num_poses=P, seed=0, lm_embeddings=lm,
                                save_trajectory=True, batch_size=batch, noise=noise)
    wall = time.perf_counter() - t0
    launches = {k: v for m in kernels.values() for k, v in m.counts.as_dict().items()}
    peak = torch.cuda.max_memory_allocated()
    timings = dict(file_dock_seconds(res), parse_s=parse_s)
    host_s = parse_s + timings["featurize_s"] + timings["write_s"]

    files = sorted(os.listdir(out))
    sdfs = [f for f in files if f.endswith(".sdf")]
    pdbs = [f for f in files if f.endswith("_reverseprocess.pdb")]
    if len(sdfs) != P or len(pdbs) != P:
        raise PhaseError(f"file dock wrote {len(sdfs)} SDFs and {len(pdbs)} trajectory PDBs, not {P} each")
    bonds = np.array([b[:2] for b in heavy.bonds])

    def bond_lengths(xyz):
        return np.linalg.norm(xyz[bonds[:, 0]] - xyz[bonds[:, 1]], axis=1)

    ref_len = bond_lengths(np.asarray(heavy.coords, np.float64))
    confs, worst = [], 0.0
    for rank in range(1, P + 1):
        fname = "rank1.sdf" if rank == 1 else next(f for f in sdfs if f.startswith(f"rank{rank}_"))
        text = (out / fname).read_text()
        got = chem.parse_sdf(text)
        if len(got) != 1 or got[0].elements != heavy.elements or got[0].bonds != heavy.bonds:
            raise PhaseError(f"{fname} does not parse back to the input's atoms and bonds")
        if not np.isfinite(got[0].coords).all():
            raise PhaseError(f"{fname} has non-finite coordinates")
        worst = max(worst, float(np.abs(bond_lengths(got[0].coords.astype(np.float64)) - ref_len).max()))
        confs.append(float(text.split("> <confidence>\n", 1)[1].split("\n", 1)[0]))
    if worst > BOND_ATOL:
        raise PhaseError(f"bond lengths moved by {worst:.2e} A (tol {BOND_ATOL:.0e})")
    if any(a < b for a, b in zip(confs, confs[1:])):
        raise PhaseError(f"the ranked files' confidences are out of order: {confs}")
    plain_runs = {k: v for k, v in launches.items() if "reference" in k and v}
    if launches["fused_tp3"] != expected or plain_runs:
        raise PhaseError(f"file dock launch counts {launches} != expected {expected} fused_tp3 / 0 plain")
    _log(f"  launches {launches} (expected fused_tp3 = {expected}: {n_chunks} chunks of {chunk} poses x "
         f"(score {expected_tp3_launches(cfg, pipe.sampler_cfg.num_steps, bucket[2])} + "
         f"{-(-chunk // conf_chunk)} confidence chunk(s) of {conf_chunk} poses))")
    _log(f"  {len(sdfs)} SDFs + {len(pdbs)} trajectory PDBs; bond lengths within {worst:.2e} A; "
         f"confidences {[round(c, 4) for c in confs]}")

    # the same dock through the plain versions: the same weights, the same
    # featurized complex and each chunk's same draws
    t0 = time.perf_counter()
    ref_pipe = DockingPipeline(pipe.score_cfg, pipe.model.state_dict(), pipe.sampler_cfg, pipe.so3,
                               pipe.torus, device=pipe.device, reference_kernels=True,
                               confidence_cfg=pipe.confidence_cfg,
                               confidence_weights=pipe.confidence_model.state_dict())
    kw = dict(num_poses=P, seed=0, aa_data=aa, batch_size=batch, return_trajectory=True)
    ref_res = ref_pipe.dock_complex(data, noise=lambda num_poses, n_bonds, seed: drawn[seed], **kw)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    # how far float32 rounding alone moves this dock: the kernel dock again
    # with every start translation scaled by (1 + NUDGE * e), e standard normal
    def nudged(num_poses, n_bonds, seed):
        init, steps = drawn[seed]
        g = torch.Generator(device=pipe.device).manual_seed(seed + 1)
        e = torch.randn(init.tr.shape, generator=g, device=pipe.device)
        return init._replace(tr=init.tr * (1 + NUDGE * e)), steps

    nudge_res = pipe.dock_complex(data, noise=nudged, **kw)
    step_gap = [float(np.abs(res.trajectory[k] - ref_res.trajectory[k]).max())
                for k in range(res.trajectory.shape[0])]
    nudge_gap = [float(np.abs(res.trajectory[k] - nudge_res.trajectory[k]).max())
                 for k in range(res.trajectory.shape[0])]
    _log(f"  max |poses(kernel) - poses(plain)| by step, whole docks (no gate): "
         f"{' '.join(f'{g:.1e}' for g in step_gap)}")
    _log(f"  max |poses(kernel) - poses(kernel, start nudged by {NUDGE:.0e})| by step (no gate): "
         f"{' '.join(f'{g:.1e}' for g in nudge_gap)}")

    # the gate: the plain versions step by step from the kernel dock's state
    start_gap, held = follow_steps(pipe, ref_pipe, data, lambda num_poses, n_bonds, seed: drawn[seed],
                                   dict(kw, return_trajectory=False))
    _log(f"  max |poses(kernel) - plain step from the kernel dock's state| by step: "
         f"{' '.join(f'{g:.1e}' for g in held)} (tol {STEP_ATOL:.0e}; start {start_gap:.1e})")
    if not (start_gap == 0.0 and max(held) <= STEP_ATOL):
        raise PhaseError(f"a plain step from the kernel dock's state parts from the kernel's by "
                         f"{max(held):.3e} A (tol {STEP_ATOL:.0e}; start {start_gap:.1e})")
    # the confidence model's plain version on the kernel dock's own poses
    final = torch.as_tensor(res.poses - np.asarray(data.original_center)[None, None],
                            dtype=torch.float32, device=pipe.device)
    final = _pad_rows(final.transpose(0, 1), bucket[0] - data.n_lig).transpose(0, 1)
    conf_same = ref_pipe.confidence(ref_pipe.confidence_input(data, aa), final).cpu().numpy()
    conf_same_err = float(np.abs(conf_same - res.confidence).max())
    conf_tol = CONF_RTOL * max(float(np.abs(conf_same).max()), 1.0)
    order_same = np.argsort(-conf_same)
    rank_ok = all(res.confidence[a] > res.confidence[b] for a, b in zip(order_same[:-1], order_same[1:])
                  if conf_same[a] - conf_same[b] > 2 * conf_tol)
    _log(f"  confidence plain vs kernel on the kernel dock's poses: max diff {conf_same_err:.3e} "
         f"(tol {conf_tol:.3e}); order {res.order.tolist()} vs {order_same.tolist()}; whole plain dock "
         f"(no gate): max |poses| diff {float(np.abs(res.poses - ref_res.poses).max()):.3e} A, order "
         f"{ref_res.order.tolist()}")
    if not conf_same_err <= conf_tol:
        raise PhaseError("the confidence model's plain version disagrees on the kernel dock's poses")
    if not rank_ok:
        raise PhaseError("the kernel dock's ranking is not the plain confidences' on its poses")
    plain = {"wall_s": plain_wall, "step_gap": step_gap, "nudge_gap": nudge_gap, "start_gap": start_gap,
             "held_step_gap": held, "step_tol": STEP_ATOL, "conf_same_poses_diff": conf_same_err,
             "conf_tol": conf_tol, "order": order_same.tolist(), "ranking_agrees": rank_ok,
             "whole_dock_pose_diff": float(np.abs(res.poses - ref_res.poses).max())}
    del ref_pipe

    report = {"complex": name, "n_lig": data.n_lig, "n_rec": data.n_rec, "n_atoms": aa.n_atoms,
              "bucket": list(bucket), "poses": P, "batch_size": batch, "chunks": n_chunks,
              "confidence_chunk": conf_chunk, "launches": launches, "expected_fused_tp3": expected,
              "wall_s": wall, "host_s": host_s, "dock_s": timings["dock_s"], "timings": timings,
              "max_memory_allocated": peak, "max_bond_length_error": worst, "confidences": confs,
              "files": files, "plain": plain}
    _log(f"[A file dock] {name} ({data.n_lig} atoms, {data.n_rec} residues, {aa.n_atoms} receptor atoms), "
         f"{P} poses in {n_chunks} chunks, {pipe.sampler_cfg.num_steps} steps | wall {wall:.3f} s = host "
         f"{host_s:.3f} s (parse {parse_s:.3f}, featurize {timings['featurize_s']:.3f}, write "
         f"{timings['write_s']:.3f}) + dock {timings['dock_s']:.3f} s (wall until the poses are on the "
         f"host, launch overhead included) | peak {peak / 2**30:.2f} GiB | plain-version dock "
         f"{plain['wall_s']:.2f} s | {card} | phase {time.perf_counter() - t_start:.1f} s")
    return report, pipe


def cli_dock(args, tmp: Path, cfg, ccfg, kernels, pipe, card: str) -> dict:
    """Phase B: the port's CLI on a CSV of e2e_synth complexes, with its
    launches counted, and the gen-3 kernel against its plain version at the
    largest complex's blocks. ``pipe``: phase A's pipeline, whose models
    have the contractions of the CLI's (the LM width changes no TP)."""
    import contextlib
    import io

    from diffdock_tpu_torch.cli import dock as cli
    from diffdock_tpu_torch.data.inference_dataset import InferenceDatasetBuilder, InferenceSpec

    t_start = time.perf_counter()
    cfg0 = dataclasses.replace(cfg, lm_embedding_dim=0)
    dirs = _write_run_dirs(tmp / "runs_no_lm", cfg0, dataclasses.replace(ccfg, lm_embedding_dim=0))
    csv = tmp / "pairs.csv"
    rows = ["complex_name,protein_path,ligand_description"]
    featurized, expected = {}, 0
    builder = InferenceDatasetBuilder()
    for name in CLI_COMPLEXES:
        d = E2E_SYNTH / name
        pdb, sdf = d / f"{name}_protein_processed.pdb", d / f"{name}_ligand.sdf"
        rows.append(f"{name},{pdb},{sdf}")
        mol, protein, _ = builder.load(InferenceSpec(name, str(pdb), ligand_description=str(sdf)))
        featurized[name] = pipe.featurize(mol, protein)[:2]
        expected += dock_launches(pipe, *featurized[name], args.poses)
    csv.write_text("\n".join(rows) + "\n")
    out = tmp / "cli"
    buf = io.StringIO()
    for m in kernels.values():
        m.counts.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--protein_ligand_csv", str(csv), "--model_dir", dirs["score"],
                       "--confidence_model_dir", dirs["confidence"], "--out_dir", str(out),
                       "--samples_per_complex", str(args.poses), "--compute_dtype", "float32",
                       "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {k: v for m in kernels.values() for k, v in m.counts.as_dict().items()}
    for line in buf.getvalue().splitlines():
        _log(f"  cli: {line}")
    per_complex = {}
    for line in buf.getvalue().splitlines():
        if line.startswith("[") and " poses in " in line:
            per_complex[line[1:line.index("]")]] = float(line.split(" poses in ")[1].split("s")[0])
    missing = [n for n in CLI_COMPLEXES if not (out / n / "rank1.sdf").exists()]
    if rc != 0 or missing:
        raise PhaseError(f"the CLI returned {rc}; complexes without rank1.sdf: {missing}")
    plain_runs = {k: v for k, v in launches.items() if "reference" in k and v}
    _log(f"  launches {launches} (expected fused_tp3 = {expected} over {len(CLI_COMPLEXES)} complexes)")
    if launches["fused_tp3"] != expected or plain_runs:
        raise PhaseError(f"CLI launch counts {launches} != expected {expected} fused_tp3 / 0 plain")

    # the gen-3 kernel at the blocks of the largest receptor
    big = CLI_COMPLEXES[-1]
    data, aa = featurized[big]
    chunk = pipe.effective_pose_chunk(data, args.poses)
    conf_chunk = pipe.confidence_chunk_for(pipe.confidence_input(data, aa), chunk)
    checks = check_blocks(["fused_tp3"], tp_blocks(pipe.model, pipe.confidence_model, cfg, ccfg,
                                                   data, aa, chunk, conf_chunk),
                          pipe.device, tag=f" [{big}]")
    _log(f"[B cli] {len(CLI_COMPLEXES)} complexes, {args.poses} poses each | wall {wall:.2f} s | "
         f"per complex {per_complex} | {card} | phase {time.perf_counter() - t_start:.1f} s")
    return {"rc": rc, "wall_s": wall, "per_complex_s": per_complex, "launches": launches,
            "expected_fused_tp3": expected, "kernel_checks": checks}


def score_memory(pipe, cfg, card: str) -> dict:
    """Phase C: the score model's peak bytes per pose in one denoising step
    (the step cache already built) at three buckets, solved for
    bytes = a * nl * nr + b * nr + c * nl * nl per pose; then one step of 40
    poses at the bucket of the 1547-residue complex (16, 2304) beside the
    rule's prediction."""
    import numpy as np
    import torch

    from diffdock_tpu_torch.data.complexes import pad_to, synthetic_complex, to_device
    from diffdock_tpu_torch.inference import pipeline as pl

    t_start = time.perf_counter()
    model, dev = pipe.model, pipe.device

    def peak_per_pose(nl, nr, n_poses):
        d = synthetic_complex(np.random.RandomState(0), n_lig=nl - 4, n_rec=nr - 16, n_bonds=4,
                              lm_dim=cfg.lm_embedding_dim)
        padded = to_device(pad_to(d, nl, nr, 8), dev)
        poses = padded.lig_pos.expand(n_poses, nl, 3).contiguous()
        t = torch.tensor(0.5, device=dev)
        with torch.inference_mode():
            cache = model.embed_receptor(padded)
            step = model.step_cache(padded, t, cache)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            model(padded, poses, t, pipe.so3, pipe.torus, rec_cache=cache, step_cache=step)
            torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / n_poses

    points = [(32, 320), (32, 1536), (64, 320)]
    per_pose = {p: peak_per_pose(*p, 10) for p in points}
    A = np.array([[nl * nr, nr, nl * nl] for nl, nr in points], np.float64)
    coef = np.linalg.solve(A, np.array([per_pose[p] for p in points]))
    check = (16, 2304)  # syn045_l8r1547's bucket: 8 ligand atoms, 1547 residues
    measured40 = peak_per_pose(*check, 40)
    predicted = pl.score_bytes_per_pose(*check)
    out = {"bytes_per_pose": {f"{nl}x{nr}": v for (nl, nr), v in per_pose.items()},
           "coefficients": {"per_edge": coef[0], "per_residue": coef[1], "per_lig_pair": coef[2]},
           "in_use": {"per_edge": pl.SCORE_BYTES_PER_EDGE, "per_residue": pl.SCORE_BYTES_PER_RESIDUE,
                      "per_lig_pair": pl.SCORE_BYTES_PER_LIG_PAIR, "budget": pl.SCORE_BUDGET_BYTES},
           "check_16x2304": {"measured_40_poses_per_pose": measured40, "rule_per_pose": predicted,
                             "rule_chunk": pl.auto_pose_chunk(*check)}}
    _log(f"  score step peak per pose: {', '.join(f'{k}: {v / 2**20:.1f} MiB' for k, v in out['bytes_per_pose'].items())}"
         f" -> {coef[0]:.0f} B per lig-rec pair + {coef[1]:.0f} B per residue + {coef[2]:.0f} B per lig pair")
    _log(f"  40 poses at (16, 2304): {measured40 / 2**20:.1f} MiB per pose measured, rule "
         f"{predicted / 2**20:.1f} MiB; the rule runs {pl.auto_pose_chunk(*check)} poses at once there")
    _log(f"[C score memory] {card} | {time.perf_counter() - t_start:.1f} s")
    return out


# phase D: six e2e_synth complexes in six cover entries, from (32, 192) to
# (40, 1792) (.chiprunignore keeps their ESM embeddings in copies of the
# tree for a card), and the one evaluated again through the plain versions
# (phase A's complex, whose nudged spread sets the tolerance)
EVAL_COMPLEXES = ("syn044_l9r90", "syn030_l21r261", "syn000_l50r368", "syn136_l31r507",
                  "syn023_l54r711", "syn045_l8r1547")
EVAL_TWIN = "syn000_l50r368"
# the entries whose one-pose docks, with the sweep's ten-pose docks, fit the
# cost model's per-chunk and per-pose parts: the smallest, a middle one and
# the largest
EVAL_ONE_POSE = ("syn044_l9r90", "syn000_l50r368", "syn045_l8r1547")
# the keys of metrics.json that the JAX package's evaluate CLI writes for
# 10 poses per complex, without gnina and without a no-overlap split
# (tests/test_torch_port_evaluate.py holds this list to the JAX CLI's)
EVAL_METRIC_KEYS = (
    "rmsds_below_2", "rmsds_below_5", "rmsds_median",
    "top5_rmsds_below_2", "top5_rmsds_below_5", "top5_rmsds_median",
    "top10_rmsds_below_2", "top10_rmsds_below_5", "top10_rmsds_median",
    "min_rmsds_below_2", "min_rmsds_below_5", "mean_rmsd",
    "rmsds_percentile_25", "rmsds_percentile_50", "rmsds_percentile_75",
    "centroid_below_2", "centroid_below_5", "centroid_median",
    "run_times_mean", "run_times_std", "steric_clash_fraction", "failures",
)
PENALTY_RMSD = 10000.0  # the evaluate CLI's row for a failed complex


def eval_sweep(args, tmp: Path, cfg, ccfg, kernels, nudge: float, card: str) -> dict:
    """Phase D: the port's evaluate CLI over EVAL_COMPLEXES with phase A's
    run directories, its launches counted and its pipeline and docks kept;
    on that pipeline, one-pose docks at EVAL_ONE_POSE for the ladder's cost
    model, fitted anew with the sweep's docks; the gen-3 kernel at every
    complex's cover shapes; EVAL_TWIN through the plain versions with the
    same draws, held to the sweep's own dock."""
    import contextlib
    import io
    import warnings

    import numpy as np
    import torch

    from diffdock_tpu_torch.cli import evaluate
    from diffdock_tpu_torch.data.chem import read_molecule_file
    from diffdock_tpu_torch.eval.rmsd import molecular_automorphisms, symmetry_rmsd
    from diffdock_tpu_torch.inference import ladder
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline

    t_start = time.perf_counter()
    split = tmp / "eval_split.txt"
    split.write_text("\n".join(EVAL_COMPLEXES) + "\n")
    score_dir, conf_dir = tmp / "runs_lm" / "score", tmp / "runs_lm" / "confidence"
    out, cache = tmp / "eval", tmp / "eval_cache"
    argv = ["--data_dir", str(E2E_SYNTH), "--split", str(split), "--esm_embeddings_path",
            str(E2E_SYNTH / "_esm"), "--model_dir", str(score_dir), "--confidence_model_dir",
            str(conf_dir), "--out_dir", str(out), "--cache_path", str(cache), "--samples_per_complex",
            str(args.poses), "--compute_dtype", "float32", "--device", "cuda"]
    eargs = evaluate.get_parser().parse_args(argv)
    if eargs.bucket_ladder != "cover" or eargs.inference_steps != 20 or eargs.actual_steps != 19:
        raise PhaseError(f"the evaluate CLI's defaults moved: {eargs}")

    # the sweep's pipeline and each complex's (data, all-atom tree, result),
    # kept as the CLI runs
    pipes, docked = [], []
    real_build, real_dock = evaluate.build_pipeline, evaluate.dock_with_retry

    def build_pipeline(a):
        pipes.append(real_build(a))
        return pipes[-1]

    def dock_with_retry(pipeline, data, *a, **kw):
        res = real_dock(pipeline, data, *a, **kw)
        docked.append((data, kw.get("aa_data"), res))
        return res

    buf = io.StringIO()
    for m in kernels.values():
        m.counts.reset()
    t0 = time.perf_counter()
    evaluate.build_pipeline, evaluate.dock_with_retry = build_pipeline, dock_with_retry
    try:
        with warnings.catch_warnings(record=True) as caught, contextlib.redirect_stdout(buf):
            warnings.simplefilter("always")
            rc = evaluate.main(argv)
    finally:
        evaluate.build_pipeline, evaluate.dock_with_retry = real_build, real_dock
    wall = time.perf_counter() - t0
    launches = {k: v for m in kernels.values() for k, v in m.counts.as_dict().items()}
    lines = buf.getvalue().splitlines()
    for line in lines:
        if line.startswith("[") or "failures" in line or line.startswith("timings:"):
            _log(f"  evaluate: {line}")
    quarantined = [str(w.message) for w in caught if "quarantined" in str(w.message)]
    timings = json.loads(next(ln for ln in lines if ln.startswith("timings:")).split(":", 1)[1])
    metrics = json.loads((out / "metrics.json").read_text())
    names = np.load(out / "names.npy").tolist()
    rmsds = np.load(out / "rmsds.npy")
    run_times = np.load(out / "run_times.npy")
    if rc != 0 or metrics["failures"] != 0:
        raise PhaseError(f"evaluate returned {rc} with {metrics['failures']} failures")
    if names != list(EVAL_COMPLEXES) or len(docked) != len(names) or len(pipes) != 1:
        raise PhaseError(f"names.npy {names} != {list(EVAL_COMPLEXES)} ({len(docked)} docks kept)")
    if rmsds.shape != (len(EVAL_COMPLEXES), args.poses) or not np.isfinite(rmsds).all() \
            or (rmsds >= PENALTY_RMSD).any():
        raise PhaseError(f"rmsds.npy {rmsds.shape}: finite {np.isfinite(rmsds).all()}, "
                         f"max {rmsds.max():.4g}")
    if sorted(metrics) != sorted(EVAL_METRIC_KEYS):
        raise PhaseError(f"metrics.json keys {sorted(metrics)} != {sorted(EVAL_METRIC_KEYS)}")
    if quarantined:
        raise PhaseError(f"the anomaly guard quarantined: {quarantined}")

    pipe = pipes[0]
    if pipe.bucket_ladder != "cover" or pipe.anomaly_guard != 5.0:
        raise PhaseError(f"ladder {pipe.bucket_ladder}, guard {pipe.anomaly_guard} (expected cover, 5.0)")
    swept = {n: d for n, d in zip(names, docked)}
    expected = sum(dock_launches(pipe, data, aa, args.poses) for data, aa, _ in docked)
    plain_runs = {k: v for k, v in launches.items() if "reference" in k and v}
    _log(f"  launches {launches} (expected fused_tp3 = {expected} over {len(EVAL_COMPLEXES)} docks)")
    if launches["fused_tp3"] != expected or plain_runs:
        raise PhaseError(f"evaluate launch counts {launches} != expected {expected} fused_tp3 / 0 plain")
    entries = {n: pipe.dock_bucket(data)[1] for n, (data, _, _) in swept.items()}
    if None in entries.values() or len(set(entries.values())) != len(EVAL_COMPLEXES):
        raise PhaseError(f"the six complexes do not land in six cover entries: {entries}")

    # one-pose docks on the sweep's pipeline: each entry's second chunk, which
    # the guard judges against the committed cost model
    one_pose = {}
    with warnings.catch_warnings(record=True) as caught, contextlib.redirect_stdout(io.StringIO()):
        warnings.simplefilter("always")
        for n in EVAL_ONE_POSE:
            data, aa, _ = swept[n]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pipe.dock_complex(data, num_poses=1, seed=eargs.seed, aa_data=aa)
            torch.cuda.synchronize()
            one_pose[n] = time.perf_counter() - t1
    if pipe._quarantined or any("quarantined" in str(w.message) for w in caught):
        raise PhaseError(f"the one-pose docks quarantined {pipe._quarantined}")

    # the cost model: chunk time = a + P (b + c nl nr), fitted on the sweep's
    # ten-pose docks (each its entry's first chunk) and the one-pose docks
    per_complex, rows, times = {}, [], []
    for n, (data, aa, _) in swept.items():
        entry, chunk = entries[n], pipe.effective_pose_chunk(data, args.poses)
        sizes = [min(chunk, args.poses - c) for c in range(0, args.poses, chunk)]
        area = entry[0] * entry[1]
        model_s = sum(ladder.modeled_batch_seconds(entry[0], entry[1], p) for p in sizes)
        rows.append([len(sizes), args.poses, args.poses * area])
        times.append(float(run_times[names.index(n)]))
        per_complex[n] = {"entry": list(entry), "P": chunk, "n_lig": data.n_lig, "n_rec": data.n_rec,
                          "n_atoms": aa.n_atoms, "sweep_s": times[-1], "modeled_s": model_s,
                          "ratio": times[-1] / model_s}
        if n in one_pose:
            m1 = ladder.modeled_batch_seconds(entry[0], entry[1], 1)
            rows.append([1, 1, area])
            times.append(one_pose[n])
            per_complex[n].update(one_pose_s=one_pose[n], one_pose_modeled_s=m1)
        _log(f"  {n}: cover entry {entry[:3]} P={entry[3]} -> {chunk} in flight | dock in the sweep "
             f"{per_complex[n]['sweep_s']:.4f} s | modeled {model_s:.4f} s | ratio "
             f"{per_complex[n]['ratio']:.3f}" + (f" | one pose {one_pose[n]:.4f} s, modeled {m1:.4f} s, "
                                                 f"ratio {one_pose[n] / m1:.3f}" if n in one_pose else ""))
    (fit_chunk, fit_base, fit_area), *_ = np.linalg.lstsq(np.array(rows, np.float64), np.array(times), rcond=None)
    _log(f"  cost model fitted here: {fit_chunk:.4g} s per chunk + {fit_base:.4g} s per pose + {fit_area:.4g} s "
         f"per pose per lig-rec pair (committed: {ladder.COST_CHUNK_S:.4g} + {ladder.COST_BASE_S:.4g} + "
         f"{ladder.COST_PER_AREA_S:.4g}) | {card}")

    # the gen-3 kernel at each complex's cover shapes: the score blocks at the
    # poses in flight, the confidence blocks at the confidence chunk
    t1 = time.perf_counter()
    block_checks = {}
    for n, (data, aa, _) in swept.items():
        chunk = pipe.effective_pose_chunk(data, args.poses)
        conf_chunk = pipe.confidence_chunk_for(pipe.confidence_input(data, aa), chunk)
        blocks = tp_blocks(pipe.model, pipe.confidence_model, cfg, ccfg, data, aa, chunk, conf_chunk,
                           bucket=entries[n][:3])
        block_checks[n] = check_blocks(["fused_tp3"], blocks, pipe.device, tag=f" [{n} {entries[n][:3]}]")
    blocks_s = time.perf_counter() - t1

    # the twin through the plain versions, the same weights and draws, held
    # to the sweep's own dock
    t1 = time.perf_counter()
    ref_pipe = DockingPipeline(pipe.score_cfg, pipe.model.state_dict(), pipe.sampler_cfg, pipe.so3, pipe.torus,
                               device=pipe.device, reference_kernels=True, confidence_cfg=pipe.confidence_cfg,
                               confidence_weights=pipe.confidence_model.state_dict(), bucket_ladder="cover",
                               anomaly_guard=0.0)
    data, aa, res = swept[EVAL_TWIN]
    ref_res = ref_pipe.dock_complex(data, num_poses=args.poses, seed=eargs.seed, aa_data=aa)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t1
    twin_tol = max(POSE_ATOL, 2 * nudge)
    agree = docks_agree(res, ref_res, pose_tol=twin_tol)
    mol = read_molecule_file(str(E2E_SYNTH / EVAL_TWIN / f"{EVAL_TWIN}_ligand.sdf")).remove_hs()
    bonds = [(i, j) for i, j, _ in mol.bonds]
    perms = molecular_automorphisms(mol.elements, bonds)
    crystal = np.asarray(data.lig_pos) + np.asarray(data.original_center)
    row = symmetry_rmsd(crystal, res.poses, mol.elements, bonds, perms=perms)
    row_plain = symmetry_rmsd(crystal, ref_res.poses, mol.elements, bonds, perms=perms)
    twin_gap = float(np.abs(row - row_plain).max())
    sweep_row = rmsds[names.index(EVAL_TWIN)]
    row_gap = float(np.abs(sweep_row - row[res.order]).max())
    _log(f"  {EVAL_TWIN} plain twin: per-pose RMSD of the sweep's dock {np.round(row, 4).tolist()} vs plain "
         f"{np.round(row_plain, 4).tolist()} | max gap {twin_gap:.3e} A (tol {twin_tol:.3e}) | the sweep's "
         f"ranked row vs its dock's RMSDs in rank order: max gap {row_gap:.3e} A | plain dock {plain_wall:.2f} s")
    if not twin_gap <= twin_tol:
        raise PhaseError(f"the plain twin's RMSDs part from the sweep's by {twin_gap:.3e} A")
    if not row_gap <= 1e-6:
        raise PhaseError(f"the sweep's ranked RMSD row is not its dock's ({row_gap:.3e} A apart)")
    del ref_pipe, pipe, pipes, docked, swept

    host_s = timings["preprocess_s"] + timings["rmsd_s"] + timings["tables_s"]
    _log(f"[D eval sweep] {len(EVAL_COMPLEXES)} complexes x {args.poses} poses, cover ladder, guard 5.0 | "
         f"wall {wall:.3f} s: docks {timings['dock_s']:.3f} s + host {host_s:.3f} s (preprocess "
         f"{timings['preprocess_s']:.3f}, rmsd {timings['rmsd_s']:.3f}, tables {timings['tables_s']:.3f}); host "
         f"share {100 * host_s / wall:.1f} % | top-1 RMSD < 2 A {metrics['rmsds_below_2']:.1f} % (random "
         f"weights) | block checks {blocks_s:.2f} s | {card} | phase {time.perf_counter() - t_start:.1f} s")
    return {"rc": rc, "wall_s": wall, "timings": timings, "host_s": host_s, "launches": launches,
            "expected_fused_tp3": expected, "per_complex": per_complex, "metrics": metrics,
            "rmsds": rmsds.tolist(), "block_checks": block_checks, "blocks_s": blocks_s,
            "cost_fit": {"chunk_s": fit_chunk, "base_s": fit_base, "per_area_s": fit_area},
            "cost_committed": {"chunk_s": ladder.COST_CHUNK_S, "base_s": ladder.COST_BASE_S,
                               "per_area_s": ladder.COST_PER_AREA_S},
            "twin": {"name": EVAL_TWIN, "rmsd_kernel": row.tolist(), "rmsd_plain": row_plain.tolist(),
                     "max_gap": twin_gap, "tol": twin_tol, "plain_wall_s": plain_wall, **agree,
                     "sweep_row_gap": row_gap}}


# phase E: training on the card. Eight e2e_synth complexes of the (48, 320)
# ligand/receptor bucket and four of (48, 704), all of bond bucket 16, so
# that every batch of TRAIN_BATCH stacks four complexes; two others for
# validation (.chiprunignore keeps their ESM embeddings)
TRAIN_COMPLEXES = ("syn016_l36r224", "syn073_l47r311", "syn077_l38r217", "syn081_l40r253",
                   "syn087_l45r286", "syn088_l48r252", "syn097_l40r241", "syn106_l47r263",
                   "syn031_l42r478", "syn037_l47r608", "syn057_l36r643", "syn113_l36r475")
VAL_COMPLEXES = ("syn122_l37r517", "syn125_l39r702")
TRAIN_BATCH = 4
TRAIN_EPOCHS = 2
# the run directory the JAX CLI writes with validation docking and a
# secondary metric (diffdock_tpu/cli/train.py:419-473)
RUN_FILES = ("model_parameters.yml", "train_state.msgpack", "metrics.jsonl", "history.json",
             "last_model.msgpack", "last_ema_model.msgpack", "best_ema_model.msgpack",
             "best_model.msgpack", "best_ema_inference_epoch_model.msgpack",
             "best_inference_epoch_model.msgpack", "best_ema_secondary_epoch_model.msgpack")
# E1: fused_tp3's gradients against autograd of its plain version, each
# within VJP_RTOL of its largest element: both run the plain version's VJP
# on the same saved inputs and cotangent, so they differ only where cuBLAS
# orders its sums differently
VJP_RTOL = 1e-5
# E3, the twin steps (kernels vs plain versions from the same state, batch
# and draws; each bucket, each of TWIN_SEEDS). A pre-ReLU unit whose input
# lies within rounding of zero may be on in one twin only; unpinned, its row
# then moves its column's gradient, and every leaf behind it, by that row's
# whole contribution (a solid weight up to 1.26e-2 lr away, a leaf up to
# 4.4e-3 in norm). So the kernel and stand-in twins take the plain twin's
# side at every such unit (:func:`record_pre_relu`), and what is left is
# float32 reordering. Each limit lies between what the kernel and what a
# 1xTF32 stand-in read, pinned, on an NVIDIA H100 80GB HBM3 at 700 W
# (kernel's worst / stand-in's best of twelve cases, six draws per bucket):
# - the loss and metrics within TWIN_LOSS_RTOL (4.7e-6 / 5.6e-5);
# - all gradient leaves together within TWIN_GRAD_ALL_RTOL in norm,
#   ||g_kernel - g_plain|| / ||g_plain|| (8.3e-5 / 2.2e-3);
# - each leaf within TWIN_GRAD_RTOL in norm (1.1e-4 / 3.9e-3; the worst
#   element is reported);
# - the batch stats within TWIN_STAT_RTOL of their scale (9.7e-6 / 1.9e-4);
# - every pinned unit within TWIN_TIE_RTOL of its layer's largest
#   |pre-activation| on both twins (1.3e-6 / 2.8e-4): a tie that float32
#   reordering settles either way, never a difference in kind;
# - the params within 1e-6 + TWIN_PARAM_SOLID lr where the plain |g| is over
#   TWIN_SOLID_SHARE of its leaf's largest (1.7e-4 lr / 6.6e-3 lr, at lr
#   1e-3), within 2 lr elsewhere (one Adam step moves a weight by about lr,
#   in the direction of a gradient that may be near zero).
# The stand-in (fused_tp3's plain version with cuBLAS's TF32 products, the
# f32 VJP kept) takes the same steps and must fail these limits each time.
TWIN_LOSS_RTOL = 2e-5
TWIN_GRAD_ALL_RTOL = 5e-4
TWIN_GRAD_RTOL = 1e-3
TWIN_STAT_RTOL = 5e-5
TWIN_PARAM_SOLID = 1e-3
TWIN_SOLID_SHARE = 0.1
TWIN_TIE_RTOL = 1e-5
TWIN_SEEDS = (7, 8)
TIMED_STEPS = 5


def train_forward_launches(cfg, n_bonds: int) -> int:
    """Merged contractions of one training forward: the receptor embedding,
    the layer-0 rec<-rec message inline and one step's worth of the rest —
    the count of one dock step with its step cache, plus the embedding."""
    return expected_tp3_launches(cfg, 1, n_bonds)


def tp3_gradients(blocks: dict, dev) -> dict:
    """E1: fused_tp3 as an autograd Function (kernel forward, the plain
    version's VJP backward) against autograd of the plain version, forward
    and all six input gradients, at ``blocks``."""
    import torch

    from diffdock_tpu_torch.ops import fused_tp3 as ft

    out = {}
    names = ("x_nbr", "edge_sh", "h", "mw", "out_kernel", "out_bias")
    for i, (label, (tp, rows, K, Hb)) in enumerate(blocks.items()):
        inp = tp_inputs(tp, rows, K, Hb, seed=100 + i, device=dev)
        leaves = [t.clone().requires_grad_(True) for t in inp]
        ref_leaves = [t.clone().requires_grad_(True) for t in inp]
        ft.counts.reset()
        got = ft.fused_tp3(tp, *leaves)
        g = torch.randn(got.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(i))
        grads = torch.autograd.grad(got, leaves, g)
        counts = ft.counts.as_dict()
        ref = ft.fused_tp3_reference(tp, *ref_leaves)
        ref_grads = torch.autograd.grad(ref, ref_leaves, g)
        torch.cuda.synchronize()
        checks = {}
        err, scale, ok = _check("forward", got.detach(), ref.detach(), checks)
        worst = 0.0
        for name, a, b in zip(names, grads, ref_grads):
            gerr = (a - b).abs().max().item()
            gscale = max(b.abs().max().item(), 1.0)
            worst = max(worst, gerr / gscale)
            checks[name] = {"max_abs_err": gerr, "max_abs_ref": gscale,
                            "ok": bool(torch.isfinite(a).all()) and gerr <= VJP_RTOL * gscale}
        out[label] = {"rows": rows, "K": K, "H": Hb, "counts": counts, **checks}
        _log(f"  E1 fused_tp3 gradient {label}: R={rows} K={K} H+1={Hb + 1} forward err {err:.3e} "
             f"(tol {KERNEL_RTOL:.0e} x {scale:.3g}) | worst input gradient {worst:.3e} of its "
             f"scale (tol {VJP_RTOL:.0e}) | launches {counts}")
        if not all(c["ok"] for c in checks.values()):
            raise PhaseError(f"fused_tp3's gradient disagrees with the plain version's at {label}: "
                             f"{ {k: v for k, v in checks.items() if not v['ok']} }")
        if counts != {"fused_tp3": 1, "fused_tp3_bf16": 0, "fused_tp3_reference": 0, "fused_tp3_vjp": 1}:
            raise PhaseError(f"fused_tp3 under autograd counted {counts}, not one launch and one VJP")
        del inp, leaves, ref_leaves, got, grads, ref, ref_grads
    return out


def _flat_leaves(model, named) -> dict:
    """Tensors by parameter name -> {flax path: numpy array}."""
    from diffdock_tpu_torch.utils.convert import flax_from_model

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    return dict(walk(flax_from_model(model, params=named)["params"]))


def pre_relu_linears(model) -> dict:
    """{module name: Linear} of every Linear whose output a ReLU takes: the
    hidden layers of each FCBlock, the first layer of each MLP2 and
    FinalNormLayer."""
    from diffdock_tpu_torch.models.encoders import FCBlock, FinalNormLayer, MLP2

    out = {}
    for name, m in model.named_modules():
        if isinstance(m, FCBlock):
            out.update({f"{name}.layers.{i}": layer for i, layer in enumerate(m.layers)})
        elif isinstance(m, (MLP2, FinalNormLayer)):
            out[f"{name}.layers.0"] = m.layers[0]
    return out


def record_pre_relu(model, acts: dict, pin: dict | None = None) -> list:
    """Forward hooks on every pre-ReLU Linear of ``model``; returns them.
    Each call's output is appended to ``acts`` under the Linear's name as
    computed. With ``pin`` (the plain twin's ``acts``), an element whose
    sign differs from the plain twin's at the same call takes the plain
    twin's value, with the gradient of its own: both twins' ReLUs then take
    the same units. Phase E3's TWIN_TIE_RTOL bounds what this may touch."""
    import torch

    def hook(_m, _i, out, n):
        calls = acts.setdefault(n, [])
        calls.append(out.detach())
        if pin is None:
            return None
        ref = pin[n][len(calls) - 1]
        return torch.where((out > 0) != (ref > 0), ref + (out - out.detach()), out)

    return [m.register_forward_hook(lambda m_, i_, out, n=n: hook(m_, i_, out, n))
            for n, m in pre_relu_linears(model).items()]


def twin_step(model, route: str, tc, log_dir: Path, batch, seed: int, so3, torus, dev,
              pin: dict | None = None) -> dict:
    """One train step of ``model`` from the train state saved in
    ``log_dir``, with the draws of ``seed``. ``route`` 'kernel' or 'plain'
    names the model's own route; 'tf32' runs the kernel model with
    fused_tp3's forward replaced by its plain version in 1xTF32 (cuBLAS TF32
    products), a stand-in for a lower-precision kernel. ``pin``: the plain
    twin's pre-ReLU outputs (:func:`record_pre_relu`). Returns the metrics,
    the gradients, params and batch stats by flax path (numpy), the launch
    counts and the output of every pre-ReLU Linear on each call, before
    pinning."""
    import torch

    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.train import checkpoints as ckpt
    from diffdock_tpu_torch.train import trainer
    from diffdock_tpu_torch.train.noise import draw_noise

    state = trainer.create_train_state(model, tc)
    ckpt.load_train_state(str(log_dir), model, state)
    draws = draw_noise(torch.Generator(device=dev).manual_seed(seed), batch.rot_u.shape[0],
                       batch.rot_u.shape[1], device=dev)
    acts: dict = {}
    hooks = record_pre_relu(model, acts, pin)
    kernel_forward = ft._forward_kernel

    def tf32_forward(tp, *inputs):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return ft._plain(tp, *inputs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    if route == "tf32":
        ft._forward_kernel = tf32_forward
    ft.counts.reset()
    try:
        state, metrics = trainer.make_train_step(model, tc, so3, torus)(state, batch, draws)
        torch.cuda.synchronize()
    finally:
        ft._forward_kernel = kernel_forward
        for h in hooks:
            h.remove()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _flat_leaves(model, state.grads), "params": _flat_leaves(model, state.params),
            "stats": {k: v.detach().cpu().numpy() for k, v in state.batch_stats.items()},
            "counts": ft.counts.as_dict(), "acts": acts}


def relu_switches(model, leaf: str, unit: int, a: dict, b: dict) -> dict:
    """ReLU units on one side only: pre-activations whose sign differs
    between the outputs ``a`` and ``b`` of every pre-ReLU Linear, in all,
    and in the Linear owning the flax leaf ``leaf`` at output ``unit``
    (None when that leaf feeds no ReLU), with the largest |pre-activation|
    among them on either side as a share of its Linear's largest in ``b``."""
    import torch

    from diffdock_tpu_torch.utils.convert import flax_path

    owner = None
    for name, _p in model.named_parameters():
        if "/".join(flax_path(name)[:-1]) == leaf.rsplit("/", 1)[0]:
            owner = name.rsplit(".", 1)[0]
    total, near, in_unit = 0, 0.0, None
    for name in a:
        x = torch.cat([t.reshape(-1, t.shape[-1]) for t in a[name]])
        y = torch.cat([t.reshape(-1, t.shape[-1]) for t in b[name]])
        switched = (x > 0) != (y > 0)
        total += int(switched.sum())
        if switched.any():
            tie = torch.maximum(x[switched].abs(), y[switched].abs()).max()
            near = max(near, float(tie / y.abs().max().clamp(min=1e-30)))
        if name == owner:
            in_unit = int(switched[:, unit].sum())
    return {"owner": owner, "in_unit": in_unit, "total": total, "largest_share": near}


def compare_twins(model, plain: dict, other: dict, lr: float) -> dict:
    """``other``'s step against the plain one: the worst metric (relative),
    the worst gradient leaf in norm and over all leaves, the worst element
    of any leaf as a share of its leaf's largest, the params (where the
    plain |g| is over TWIN_SOLID_SHARE of its leaf's largest, and anywhere,
    in units of lr), the batch stats and the ReLU ties that ``other``'s
    step pinned; ``ok`` under the E3 limits."""
    import numpy as np

    km, pm = other["metrics"], plain["metrics"]
    metric_err = max(abs(km[k] - pm[k]) / max(abs(pm[k]), 1e-12) for k in pm)
    kg, pg = other["grads"], plain["grads"]
    norm = {k: float(np.linalg.norm(kg[k] - pg[k])) / max(float(np.linalg.norm(pg[k])), 1e-30) for k in pg}
    elem = {k: float(np.abs(kg[k] - pg[k]).max(initial=0.0)) / max(float(np.abs(pg[k]).max(initial=0.0)), 1e-30)
            for k in pg}
    worst_leaf = max(norm, key=norm.get)
    elem_leaf = max(elem, key=elem.get)
    total = math.sqrt(sum(float(np.sum((kg[k] - pg[k]) ** 2)) for k in pg)) / \
        max(math.sqrt(sum(float(np.sum(pg[k] ** 2)) for k in pg)), 1e-30)
    solid_err = param_err = 0.0
    for k in pg:
        g = np.abs(pg[k])
        solid = g > TWIN_SOLID_SHARE * max(g.max(initial=0.0), 1e-30)
        err = np.abs(other["params"][k] - plain["params"][k])
        param_err = max(param_err, float(err.max(initial=0.0)))
        solid_err = max(solid_err, float(err[solid].max(initial=0.0)))
    ks, ps = other["stats"], plain["stats"]
    stat_err = max(float(np.abs(ks[k] - ps[k]).max(initial=0.0)) / max(float(np.abs(ps[k]).max(initial=0.0)), 1.0)
                   for k in ps)
    unit = int(np.unravel_index(np.argmax(np.abs(kg[elem_leaf] - pg[elem_leaf])), pg[elem_leaf].shape)[-1])
    out = {"loss": km["loss"], "metric_rel_err": metric_err, "grad_norm_rel_err": norm[worst_leaf],
           "grad_worst_leaf": worst_leaf, "grad_all_rel_err": total, "grad_elem_rel_err": elem[elem_leaf],
           "grad_elem_leaf": elem_leaf, "grad_elem_unit": unit,
           "param_solid_err_lr": solid_err / lr, "param_err_lr": param_err / lr, "batch_stat_rel_err": stat_err,
           "relu_switched": relu_switches(model, elem_leaf, unit, other["acts"], plain["acts"])}
    within = {"metric": metric_err <= TWIN_LOSS_RTOL, "grad_all": total <= TWIN_GRAD_ALL_RTOL,
              "grad_leaf": norm[worst_leaf] <= TWIN_GRAD_RTOL, "batch_stat": stat_err <= TWIN_STAT_RTOL,
              "param_solid": solid_err <= 1e-6 + TWIN_PARAM_SOLID * lr, "param": param_err <= 2 * lr + 1e-6,
              "relu_tie": out["relu_switched"]["largest_share"] <= TWIN_TIE_RTOL}
    out["outside"] = [k for k, v in within.items() if not v]
    out["ok"] = not out["outside"]
    return out


def train_phase(args, tmp: Path, cfg, kernels, score_blocks: dict, card: str, dev) -> dict:
    """Phase E: E1 fused_tp3's gradient at full width; E2 the port's train
    CLI at DiffDock-L width with ESM features (2 epochs of 3 steps of 4
    complexes, the validation loss, one validation-docking round), its
    launches counted per step, then a score-only dock from its
    ``last_ema_model``; E3 one step from the saved train state through the
    kernels, through the plain versions and through a 1xTF32 stand-in, at
    both buckets and two draws each; E4 the warm step's wall at both
    buckets, its peak memory and a profile of one step."""
    import numpy as np
    import torch

    from diffdock_tpu_torch.cli import train as train_cli
    from diffdock_tpu_torch.data.complexes import to_device
    from diffdock_tpu_torch.data.datasets import ComplexDataset, DatasetConfig, pdbbind_specs
    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.models.score_model import CGScoreModel
    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.train import checkpoints as ckpt
    from diffdock_tpu_torch.train import trainer, validation
    from diffdock_tpu_torch.train.noise import draw_noise
    from diffdock_tpu_torch.utils.convert import state_dict_from_flax

    t_start = time.perf_counter()
    report: dict = {}

    # E1
    t0 = time.perf_counter()
    report["gradients"] = tp3_gradients(score_blocks, dev)
    _log(f"[E1 fused_tp3 gradient] {len(score_blocks)} blocks | {time.perf_counter() - t0:.1f} s")

    # E2: the train CLI, each step's launches counted
    t0 = time.perf_counter()
    root = tmp / "train"
    root.mkdir(parents=True, exist_ok=True)
    (root / "train.txt").write_text("\n".join(TRAIN_COMPLEXES) + "\n")
    (root / "val.txt").write_text("\n".join(VAL_COMPLEXES) + "\n")
    log_dir, cache = root / "run", root / "cache"
    steps, docks = [], []
    make_step, dock_epoch = trainer.make_train_step, validation.inference_epoch

    def counted_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def counted(state, batch, draws):
            before = ft.counts.as_dict()
            out = step(state, batch, draws)
            after = ft.counts.as_dict()
            steps.append({"shape": list(batch.lig_cat.shape[:2]) + [batch.rec_cat.shape[1],
                                                                      batch.rot_u.shape[1]],
                          **{k: after[k] - before[k] for k in after}})
            return out
        return counted

    def counted_inference_epoch(pipeline, datas, num_complexes, samples, seed=0):
        before = ft.counts["fused_tp3"]
        out = dock_epoch(pipeline, datas, num_complexes, samples, seed=seed)
        want = sum(expected_tp3_launches(cfg, pipeline.sampler_cfg.num_steps,
                                         pipeline.dock_bucket(d)[0][2])
                   * -(-samples // pipeline.effective_pose_chunk(d, samples))
                   for d in list(datas.values())[:num_complexes])
        docks.append({"launches": ft.counts["fused_tp3"] - before, "expected": want})
        return out

    argv = ["--model_preset", "diffdock_l", "--ns", str(cfg.ns), "--nv", str(cfg.nv),
            "--num_conv_layers", str(cfg.num_conv_layers),
            "--num_prot_emb_layers", str(cfg.num_prot_emb_layers), "--data_dir", str(E2E_SYNTH),
            "--split_train", str(root / "train.txt"), "--split_val", str(root / "val.txt"),
            "--esm_embeddings_dir", str(E2E_SYNTH / "_esm"), "--cache_path", str(cache),
            "--log_dir", str(log_dir), "--batch_size", str(TRAIN_BATCH),
            "--n_epochs", str(TRAIN_EPOCHS), "--seed", "0", "--num_workers", "0",
            "--val_inference_freq", str(TRAIN_EPOCHS), "--num_inference_complexes", "2",
            "--inference_samples", "2", "--inference_steps", "4",
            "--inference_secondary_metric", "valinf_rmsds_lt5", "--device", str(dev)]
    for m in kernels.values():
        m.counts.reset()
    trainer.make_train_step, validation.inference_epoch = counted_make_step, counted_inference_epoch
    try:
        rc = train_cli.main(argv)
    finally:
        trainer.make_train_step, validation.inference_epoch = make_step, dock_epoch
    torch.cuda.synchronize()
    cli_wall = time.perf_counter() - t0
    launches = {k: v for m in kernels.values() for k, v in m.counts.as_dict().items()}
    if rc != 0:
        raise PhaseError(f"the train CLI returned {rc}")
    records = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    by_phase = {ph: [r for r in records if r["phase"] == ph] for ph in ("train", "val", "val_inference")}
    missing = [f for f in RUN_FILES if not (log_dir / f).is_file()]
    bad_loss = [r for r in by_phase["train"] + by_phase["val"] if not np.isfinite(r["loss"])]
    _log(f"  metrics: {[{k: v for k, v in r.items()} for r in records]}")
    if missing or bad_loss or len(by_phase["train"]) != TRAIN_EPOCHS or \
            len(by_phase["val"]) != TRAIN_EPOCHS or len(by_phase["val_inference"]) != 1:
        raise PhaseError(f"train run: missing files {missing}, non-finite losses {bad_loss}, "
                         f"records {[r['phase'] for r in records]}")
    n_steps = TRAIN_EPOCHS * (len(TRAIN_COMPLEXES) // TRAIN_BATCH)
    step_bad = [s for s in steps
                if not (s["fused_tp3"] == s["fused_tp3_vjp"] == train_forward_launches(cfg, s["shape"][3])
                        and s["fused_tp3_reference"] == 0 and s["shape"][0] == TRAIN_BATCH)]
    val_ds = ComplexDataset(pdbbind_specs(str(E2E_SYNTH), str(root / "val.txt"),
                                          esm_embeddings_dir=str(E2E_SYNTH / "_esm")),
                            DatasetConfig(cache_dir=str(cache)))
    val_ds.preprocess(verbose=False)  # served from the CLI's cache
    val_forwards = [b.rot_u.shape[1] for _, b in val_ds.bucketed_batches(TRAIN_BATCH)] * TRAIN_EPOCHS
    expected = (sum(s["fused_tp3"] for s in steps)
                + sum(train_forward_launches(cfg, nb) for nb in val_forwards)
                + sum(d["expected"] for d in docks))
    _log(f"  {len(steps)} steps {[s['shape'] for s in steps]}: per step fused_tp3 "
         f"{[s['fused_tp3'] for s in steps]}, VJP {[s['fused_tp3_vjp'] for s in steps]} "
         f"(expected {train_forward_launches(cfg, 16)} each); validation forwards {len(val_forwards)}; "
         f"validation docks {docks}; run total {launches}, expected fused_tp3 {expected}")
    if len(steps) != n_steps or step_bad or launches["fused_tp3"] != expected or \
            launches["fused_tp3_vjp"] != sum(s["fused_tp3"] for s in steps) or \
            launches["fused_tp3_reference"] or any(d["launches"] != d["expected"] for d in docks):
        raise PhaseError(f"train launch counts: steps {steps}, docks {docks}, run {launches}, "
                         f"expected {expected}")
    report["cli"] = {"rc": rc, "wall_s": cli_wall, "metrics": records, "steps": steps,
                     "validation_docks": docks, "launches": launches, "expected_fused_tp3": expected}
    _log(f"[E2 train CLI] diffdock_l, {len(TRAIN_COMPLEXES)} complexes x {TRAIN_EPOCHS} epochs, "
         f"{len(steps)} steps | wall {cli_wall:.2f} s | {card}")

    # the port's load_checkpoint and one score-only dock of a validation complex
    t0 = time.perf_counter()
    so3, torus = get_so3_tables(device=dev), get_torus_tables(device=dev)
    params, run_cfg, _ = ckpt.load_checkpoint(str(log_dir), "last_ema_model.msgpack")
    pipe = DockingPipeline(run_cfg, state_dict_from_flax(params, run_cfg), SamplerConfig(), so3,
                           torus, device=dev)
    val = val_ds.get(VAL_COMPLEXES[0])
    ft.counts.reset()
    res = pipe.dock_complex(val, num_poses=args.poses, seed=0)
    torch.cuda.synchronize()
    dock_want = expected_tp3_launches(run_cfg, pipe.sampler_cfg.num_steps, pipe.dock_bucket(val)[0][2]) \
        * -(-args.poses // pipe.effective_pose_chunk(val, args.poses))
    if res.poses.shape != (args.poses, val.n_lig, 3) or not np.isfinite(res.poses).all() or \
            ft.counts["fused_tp3"] != dock_want or ft.counts["fused_tp3_reference"]:
        raise PhaseError(f"the dock from last_ema_model gave poses {res.poses.shape}, "
                         f"launches {ft.counts.as_dict()} (expected {dock_want})")
    report["dock_from_run"] = {"name": VAL_COMPLEXES[0], "wall_s": time.perf_counter() - t0,
                               "launches": ft.counts.as_dict(), "expected_fused_tp3": dock_want}
    _log(f"  dock of {VAL_COMPLEXES[0]} from last_ema_model: {args.poses} poses, "
         f"{ft.counts['fused_tp3']} launches (expected {dock_want}) | {time.perf_counter() - t0:.2f} s")
    del pipe

    # E3: twin steps from the saved train state, at both buckets, TWIN_SEEDS draws each
    t0 = time.perf_counter()
    tc = trainer.TrainConfig()  # the CLI's defaults
    train_ds = ComplexDataset(pdbbind_specs(str(E2E_SYNTH), str(root / "train.txt"),
                                            esm_embeddings_dir=str(E2E_SYNTH / "_esm")),
                              DatasetConfig(cache_dir=str(cache)))
    train_ds.preprocess(verbose=False)
    batches = {}
    for names, b in train_ds.bucketed_batches(TRAIN_BATCH, shuffle_seed=0):
        batches.setdefault(tuple(b.lig_cat.shape[1:2]) + (b.rec_cat.shape[1],), (names, b))
    km = CGScoreModel(run_cfg).to(dev)
    pm = CGScoreModel(run_cfg, reference_kernels=True).to(dev)
    cases = []
    for shape, (names, b) in batches.items():
        tb = to_device(b, dev)
        n_fwd = train_forward_launches(run_cfg, tb.rot_u.shape[1])
        for seed in TWIN_SEEDS:
            plain = twin_step(pm, "plain", tc, log_dir, tb, seed, so3, torus, dev)
            kern = twin_step(km, "kernel", tc, log_dir, tb, seed, so3, torus, dev, pin=plain["acts"])
            kcounts, pcounts = kern["counts"], plain["counts"]
            if kcounts != {"fused_tp3": n_fwd, "fused_tp3_bf16": 0, "fused_tp3_reference": 0,
                           "fused_tp3_vjp": n_fwd} or \
                    pcounts != {"fused_tp3": 0, "fused_tp3_bf16": 0, "fused_tp3_reference": n_fwd,
                                "fused_tp3_vjp": 0}:
                raise PhaseError(f"twin step counts: kernel {kcounts}, plain {pcounts}")
            case = {"names": names, "shape": [TRAIN_BATCH, shape[0], shape[1]], "seed": seed,
                    "loss_plain": plain["metrics"]["loss"],
                    "kernel": compare_twins(km, plain, kern, tc.lr)}
            del kern
            case["tf32"] = compare_twins(km, plain, twin_step(km, "tf32", tc, log_dir, tb, seed, so3,
                                                              torus, dev, pin=plain["acts"]), tc.lr)
            del plain
            cases.append(case)
            for route in ("kernel", "tf32"):
                c = case[route]
                sw = c["relu_switched"]
                _log(f"  E3 {route} twin at {case['shape']} seed {seed}: loss {c['loss']:.6f} vs "
                     f"{case['loss_plain']:.6f} (worst metric {c['metric_rel_err']:.3e}, tol "
                     f"{TWIN_LOSS_RTOL:.0e}) | worst gradient leaf {c['grad_worst_leaf']} "
                     f"{c['grad_norm_rel_err']:.3e} in norm (tol {TWIN_GRAD_RTOL:.0e}), all leaves "
                     f"{c['grad_all_rel_err']:.3e} (tol {TWIN_GRAD_ALL_RTOL:.0e}), worst element {c['grad_elem_rel_err']:.3e} of "
                     f"{c['grad_elem_leaf']}'s largest at unit {c['grad_elem_unit']} (ReLU units "
                     f"switched: {sw['in_unit']} there, {sw['total']} in all and pinned, the largest "
                     f"{sw['largest_share']:.2e} of its layer's, tol {TWIN_TIE_RTOL:.0e}) | params {c['param_solid_err_lr']:.3e} lr "
                     f"where |g| is solid (tol {1e-6 / tc.lr + TWIN_PARAM_SOLID:.1e} lr), {c['param_err_lr']:.3e} lr "
                     f"anywhere (tol 2 lr) | batch stats {c['batch_stat_rel_err']:.3e} (tol "
                     f"{TWIN_STAT_RTOL:.0e}) | outside the limits of: {', '.join(c['outside']) or 'none'}")
    report["twin"] = {"cases": cases, "limits": {
        "metric": TWIN_LOSS_RTOL, "grad_all": TWIN_GRAD_ALL_RTOL, "grad_leaf": TWIN_GRAD_RTOL,
        "batch_stat": TWIN_STAT_RTOL, "relu_tie": TWIN_TIE_RTOL,
        "param_solid_lr": TWIN_PARAM_SOLID, "param_lr": 2.0}}
    bad = [(c["shape"], c["seed"]) for c in cases if not c["kernel"]["ok"]]
    if bad:
        raise PhaseError(f"the kernel train step disagrees with the plain one at {bad}")
    loose = [(c["shape"], c["seed"]) for c in cases if c["tf32"]["ok"]]
    if loose:
        raise PhaseError(f"the 1xTF32 stand-in passes the twin limits at {loose}: they cannot "
                         "tell a lower-precision forward")
    del pm
    _log(f"[E3 twin step] {time.perf_counter() - t0:.1f} s")

    # E4: warm step walls at both buckets, peak memory, one profiled step
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(11)
    ks = ckpt.load_train_state(str(log_dir), km, trainer.create_train_state(km, tc))
    step = trainer.make_train_step(km, tc, so3, torus)
    timing = {}
    for shape, (names, b) in batches.items():
        tb = to_device(b, dev)

        def one():
            nonlocal ks
            d = draw_noise(gen, TRAIN_BATCH, tb.rot_u.shape[1], device=dev)
            ks, _m = step(ks, tb, d)

        for _ in range(2):
            one()
        walls = []
        for _ in range(TIMED_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            s0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - s0)
        peak = torch.cuda.max_memory_allocated()
        med = float(np.median(walls))
        timing[f"{shape[0]}x{shape[1]}"] = {"names": names, "walls_s": walls, "median_s": med,
                                             "complexes_per_s": TRAIN_BATCH / med, "peak_bytes": peak}
        _log(f"  E4 warm step at ({shape[0]}, {shape[1]}) x {TRAIN_BATCH}: median {med:.4f} s "
             f"(min {min(walls):.4f}, max {max(walls):.4f}) | {TRAIN_BATCH / med:.2f} complexes/s | "
             f"peak {peak / 2**30:.2f} GiB | {card}")
    report["step_timing"] = timing
    report["step_profile"] = dict(profile_step(one, med), shape=[shape[0], shape[1], TRAIN_BATCH])
    _log(f"[E4 train numbers] {time.perf_counter() - t0:.1f} s")
    _log(f"[E train] {card} | phase {time.perf_counter() - t_start:.1f} s")
    return report


def profile_step(one_step, wall_s: float) -> dict:
    """torch.profiler over one warm train step: device time in fused_tp3's
    forward kernel, in its VJP (the ``fused_tp3_vjp`` ranges of the
    backward) and elsewhere, and the busy share against ``wall_s``, the
    step's unprofiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_step()
        torch.cuda.synchronize()

    def dev_us(e, total=False):
        for name in (("device_time_total", "cuda_time_total") if total
                     else ("self_device_time_total", "self_cuda_time_total")):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    # the device timeline also carries the VJP's range as a span of its own
    # (idle gaps included): kernels only here
    kernels = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0
               and e.key != "fused_tp3_vjp"]
    total = sum(k[1] for k in kernels)
    if total <= 0:
        raise PhaseError("the profiler saw no device time in a train step")
    fwd = sum(k[1] for k in kernels if "fused_tp3" in k[0])
    # the VJP: the kernels launched under its host-side ranges
    vjp = sum(dev_us(e, total=True) for e in prof.events()
              if e.name == "fused_tp3_vjp" and getattr(e, "device_type", None) == DeviceType.CPU)
    out = {"device_ms": total / 1e3, "busy_share": total / (wall_s * 1e6),
           "fused_tp3_forward_ms": fwd / 1e3, "fused_tp3_vjp_ms": vjp / 1e3 if vjp > 0 else None,
           "elsewhere_ms": (total - fwd - vjp) / 1e3, "kernel_launches": sum(k[2] for k in kernels),
           "top": [{"name": k[0][:90], "ms": k[1] / 1e3, "count": k[2]}
                   for k in sorted(kernels, key=lambda k: -k[1])[:8]]}
    vjp_txt = f"{vjp / 1e3:.1f} ms" if vjp > 0 else "not measured (no device time under its range)"
    _log(f"  E4 profiled step: device {total / 1e3:.1f} ms of {wall_s * 1e3:.1f} ms wall "
         f"(busy {100 * out['busy_share']:.1f} %) | fused_tp3 forward {fwd / 1e3:.1f} ms | VJP "
         f"{vjp_txt} | elsewhere {(total - fwd - vjp) / 1e3:.1f} ms | {out['kernel_launches']} launches")
    for k in out["top"]:
        _log(f"    {k['ms']:9.2f} ms  x{k['count']:<5d} {k['name']}")
    return out


def _device_us(e) -> float:
    """A profiler event's own device microseconds (the field's name differs
    between PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


def profile_dock(pipe, data, aa, n_poses: int, names=()) -> dict:
    """torch.profiler over one warm dock of ``pipe``: device time by
    kernel and the share of the hand-written kernels (and the device time
    and launches of the kernels whose names hold each of ``names``); the
    device's busy share is taken against the same dock timed without the
    profiler (whose own overhead inflates the traced wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.dock_complex(data, num_poses=n_poses, seed=2, aa_data=aa)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    # device activity only: host-op tracing would add its own cost to
    # every eager op and to the event processing afterwards
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pipe.dock_complex(data, num_poses=n_poses, seed=2, aa_data=aa)
        torch.cuda.synchronize()

    kernels = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA and _device_us(e) > 0]
    kernels.sort(key=lambda k: -k[1])
    total = sum(k[1] for k in kernels)
    if total <= 0:
        raise PhaseError("the profiler saw no device time in a dock")
    ours = sum(k[1] for k in kernels if "fused_tp3" in k[0])
    launches = sum(k[2] for k in kernels)
    out = {"wall_ms_unprofiled": wall_us / 1e3, "device_ms": total / 1e3,
           "device_busy_share": total / wall_us, "fused_tp3_ms": ours / 1e3,
           "fused_tp3_share_of_device": ours / total,
           "kernel_launches": launches,
           "ms_by_name": {n: sum(k[1] for k in kernels if n in k[0]) / 1e3 for n in names},
           "launches_by_name": {n: sum(k[2] for k in kernels if n in k[0]) for n in names},
           "top": [{"name": k[0][:90], "ms": k[1] / 1e3, "count": k[2]} for k in kernels[:10]]}
    _log(f"  wall {wall_us / 1e3:.1f} ms (unprofiled) | device busy {total / 1e3:.1f} ms "
         f"({100 * out['device_busy_share']:.1f} %) | fused_tp3 {ours / 1e3:.1f} ms "
         f"({100 * ours / total:.1f} % of device) | {launches} kernel launches")
    for k in out["top"]:
        _log(f"    {k['ms']:9.2f} ms  x{k['count']:<5d} {k['name']}")
    return out


def _pad_rows(t, n: int):
    """``t`` with ``n`` zero (False) rows appended along its first axis."""
    import torch

    return torch.cat([t, t.new_zeros((n,) + tuple(t.shape[1:]))])


def _block_diag_t3(tp, classes, out_kernel, out_bias, dtype=None):
    """The (H+1, F_tot, W_tot) block-diagonal weight tensor of the TPU
    kernel, in ``dtype`` (default float32), for the library yardstick."""
    import torch

    from diffdock_tpu_torch.ops import fused_tp3 as ft

    dtype = dtype or torch.float32
    blocks = ft.class_weights(tp, classes, out_kernel, out_bias, dtype)
    H1 = blocks[0].shape[0]
    f_tot = sum(fan * d3 for _k, _o, fan, d3, _m in classes)
    w_tot = sum(mul * d3 for _k, _o, _f, d3, mul in classes)
    t3 = out_kernel.new_zeros(H1, f_tot, w_tot, dtype=dtype)
    f_off = w_off = 0
    for (_k, _o, fan, d3, mul), blk in zip(classes, blocks):
        t3[:, f_off:f_off + fan * d3, w_off:w_off + mul * d3] = (
            tp.expand_weight_identity(blk, d3).reshape(H1, fan * d3, mul * d3)
        )
        f_off += fan * d3
        w_off += mul * d3
    return t3


REFERENCE_COMPLEX = "syn045_l8r1547"  # 8 ligand atoms, 1547 residues: phase B's largest
CROP_BEYOND = 20.0
# residues the pocket dock keeps per step. The host pre-crop (3 x 19 x
# 1.46 + 20 + 10 = 113 A around the input ligand) leaves 370 of the 1547
# residues of this sparse synthetic receptor (bucket 448); around the input
# pose 10 lie within 20 A and 78 within 40 A (3 tr_sigma + 20 A at
# tr_sigma = 6.7 A). 128 keeps every residue of the late steps' crop there
# and the 128 nearest in the early steps, whose pose cloud is wide: the
# receptor blocks shrink from 448 rows to 128
POCKET_CAPACITY = 128
# training-run arguments a reference args dump carries beside the model's
# (reference utils/parsing.py); the importer reads none of them
REFERENCE_RUN_ARGS = dict(lr=0.001, w_decay=0.0, batch_size=16, n_epochs=850, scheduler="plateau",
                          scheduler_patience=30, ema_rate=0.999, restart_lr=None, cudnn_benchmark=True,
                          num_dataloader_workers=1, pdbbind_dir="data/PDBBind_processed/",
                          split_train="data/splits/timesplit_no_lig_overlap_train",
                          cache_path="data/cache", log_dir="workdir/run", limit_complexes=0,
                          receptor_radius=15.0, c_alpha_max_neighbors=24, remove_hs=True,
                          test_sigma_intervals=True, val_inference_freq=5, inference_steps=20,
                          tr_weight=0.33, rot_weight=0.33, tor_weight=0.33, sampling_alpha=1,
                          sampling_beta=1, num_workers=1, max_lig_size=1.0e9)


def reference_args(c) -> dict:
    """A flat reference-args dump (``model_parameters.yml``) from which
    ``utils/torch_import.py:config_from_reference_args`` derives ``c``."""
    s = c.sigma
    return dict(
        REFERENCE_RUN_ARGS,
        ns=c.ns, nv=c.nv, num_conv_layers=c.num_conv_layers, num_prot_emb_layers=c.num_prot_emb_layers,
        sh_lmax=c.sh_lmax, use_second_order_repr=c.use_second_order_repr,
        reduce_pseudoscalars=c.reduce_pseudoscalars, embed_also_ligand=c.embed_also_ligand,
        max_radius=c.lig_max_radius, cross_max_distance=c.cross_max_distance, crop_beyond=c.crop_beyond,
        dynamic_max_cross=c.dynamic_max_cross, sigma_embed_dim=c.sigma_embed_dim,
        distance_embed_dim=c.distance_embed_dim, cross_distance_embed_dim=c.cross_distance_embed_dim,
        embedding_type=c.embedding_type, embedding_scale=c.embedding_scale,
        esm_embeddings_path="data/esm2_3billion_embeddings.pt" if c.lm_embedding_dim else None,
        no_batch_norm=not c.batch_norm, dropout=c.dropout, tp_weights_layers=c.tp_weights_layers,
        smooth_edges=c.smooth_edges, odd_parity=c.odd_parity, no_torsion=c.no_torsion,
        scale_by_sigma=c.scale_by_sigma, not_fixed_center_conv=not c.fixed_center_conv,
        confidence_dropout=c.confidence_dropout, confidence_no_batchnorm=c.confidence_no_batchnorm,
        rmsd_classification_cutoff=2.0, affinity_prediction=c.affinity_prediction,
        atom_confidence_loss_weight=0.0, sidechain_loss_weight=0.0, backbone_loss_weight=0.0,
        no_differentiate_convolutions=not c.differentiate_convolutions,
        use_old_atom_encoder=c.use_old_atom_encoder, all_atoms=c.all_atoms,
        tr_sigma_min=s.tr_sigma_min, tr_sigma_max=s.tr_sigma_max, rot_sigma_min=s.rot_sigma_min,
        rot_sigma_max=s.rot_sigma_max, tor_sigma_min=s.tor_sigma_min, tor_sigma_max=s.tor_sigma_max,
    )


_SEQUENTIALS = ("edge_embedding", "sigma_embedding", "tr_final_layer", "rot_final_layer")
_CONV_LISTS = ("rec_emb", "lig_emb", "conv", "lig_conv", "rec_conv", "lig_to_rec_conv", "rec_to_lig_conv")


def reference_state_dict(model) -> dict:
    """The reference's state dict (torch key names and layouts) of a port
    model: the inverse of ``utils/torch_import.py``'s key maps. Linears
    transpose back, each TP's weight-generating MLP takes the reference's
    flat weight order (the inverse of ``tp_weight_permutation``), batch
    norms take ``running_*`` names, and the old family's last-layer convs
    that the reference builds but never calls (six in the all-atom model,
    the receptor receivers' two in the coarse-grained one) are written as
    copies of a called sibling of the same irreps, as a released checkpoint
    carries them."""
    import re

    import numpy as np
    import torch

    from diffdock_tpu_torch.utils.convert import flax_from_model, flax_path
    from diffdock_tpu_torch.utils.torch_import import tp_weight_permutation

    cfg = model.cfg
    if cfg.sh_lmax == 1 and not cfg.use_second_order_repr:
        raise PhaseError("the faster-TP layout is not written here")
    tree = flax_from_model(model)
    params, stats = tree["params"], tree.get("batch_stats", {})
    tps = {}  # each conv layer's TP, by its flax name
    for n, m in model.named_modules():
        path = flax_path(n + ".x")[:-1] if n else []
        if len(path) == 1 and hasattr(m, "tp"):
            tps[path[0]] = m.tp
    sd = {}

    def linear(ref, p, bias=True):
        sd[f"{ref}.weight"] = p["kernel"].T
        if bias:
            sd[f"{ref}.bias"] = p["bias"]

    def conv(ref, name, p):
        inv = np.argsort(tp_weight_permutation(tps[name]))
        for fc_name, fc in p.items():
            if not fc_name.startswith("fc"):
                continue
            prefix = f"{ref}.fc" if fc_name in ("fc", "fc_shared") else f"{ref}.fc.{fc_name[3:]}"
            n_dense = sum(k.startswith("Dense_") for k in fc)
            for i in range(n_dense):
                linear(f"{prefix}.{3 * i}", fc[f"Dense_{i}"])
            sd[f"{prefix}.{3 * n_dense}.weight"] = fc["out_kernel"][:, inv].T
            sd[f"{prefix}.{3 * n_dense}.bias"] = fc["out_bias"][inv]
        if "bn" in p:
            sd[f"{ref}.batch_norm.weight"], sd[f"{ref}.batch_norm.bias"] = p["bn"]["weight"], p["bn"]["bias"]
            sd[f"{ref}.batch_norm.running_mean"] = stats[name]["bn"]["mean"]
            sd[f"{ref}.batch_norm.running_var"] = stats[name]["bn"]["var"]

    for name, p in params.items():
        m = re.fullmatch(r"(\w+?)_(\d+)", name)
        if name.endswith("_node_embedding"):
            for key, sub in p.items():
                if key.startswith("cat_"):
                    sd[f"{name}.atom_embedding_list.{key[4:]}.weight"] = sub["embedding"]
                else:
                    linear(f"{name}.{'additional_features_embedder' if key == 'fuse' else key}", sub)
        elif name.endswith(_SEQUENTIALS):
            for i in range(2):
                linear(f"{name}.{3 * i}", p[f"Dense_{i}"])
        elif name in ("tor_final_dense1", "tor_final_dense2"):
            linear(f"tor_final_layer.{0 if name.endswith('1') else 3}", p, bias=False)
        elif name == "confidence_predictor":
            for i in range(3):
                linear(f"{name}.{4 * i}", p[f"Dense_{i}"])
                if f"BatchNorm_{i}" in p:
                    bn, st = p[f"BatchNorm_{i}"], stats[name][f"BatchNorm_{i}"]
                    sd[f"{name}.{4 * i + 1}.weight"], sd[f"{name}.{4 * i + 1}.bias"] = bn["scale"], bn["bias"]
                    sd[f"{name}.{4 * i + 1}.running_mean"] = st["mean"]
                    sd[f"{name}.{4 * i + 1}.running_var"] = st["var"]
        elif m and m.group(1) in _CONV_LISTS:
            conv(f"{m.group(1)}_layers.{m.group(2)}", name, p)
        elif name in ("final_conv", "tor_bond_conv"):
            conv(name, name, p)
        else:
            raise PhaseError(f"no reference name for {name}")
    if cfg.old_architecture and cfg.all_atoms:
        last = 9 * (cfg.num_conv_layers - 1)
        called = {k: v for k, v in sd.items() if k.startswith(f"conv_layers.{last}.")}
        for k in range(3, 9):
            for key, v in called.items():
                sd[key.replace(f"conv_layers.{last}.", f"conv_layers.{last + k}.", 1)] = v
    elif cfg.old_architecture:
        last = f"lig_conv_layers.{cfg.num_conv_layers - 1}."
        called = {k: v for k, v in sd.items() if k.startswith(last)}
        for stack in ("rec_conv_layers", "lig_to_rec_conv_layers"):
            for key, v in called.items():
                sd[key.replace("lig_conv_layers", stack, 1)] = v
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def time_tp3_blocks(blocks: dict, dev, iters: int) -> dict:
    """fused_tp3's whole float32 call, ``fused_tp3(tp, ...)`` as a dock
    makes it, its plain version and the einsum pair (on the coupled tensor
    and h_aug built beforehand) at each block, with CUDA events, beside the
    block's bound. Block i's inputs are ``tp_inputs``'s from seed i."""
    import torch

    from diffdock_tpu_torch.ops import fused_tp3 as ft

    out = {}
    with torch.inference_mode():
        for i, (label, (tp, rows, K, Hb)) in enumerate(blocks.items()):
            inp = tp_inputs(tp, rows, K, Hb, seed=i, device=dev)
            classes, coupled = ft.merged_coupled(tp, inp[0], inp[1])
            h_aug = torch.cat([inp[2], inp[3][..., None]], dim=-1)
            t3 = _block_diag_t3(tp, classes, inp[4], inp[5])
            kernel_ms = cuda_ms(lambda: ft.fused_tp3(tp, *inp), iters)
            plain_ms = cuda_ms(lambda: ft.fused_tp3_reference(tp, *inp), iters)
            pair_ms = cuda_ms(lambda: torch.einsum(
                "rhF,hFW->rW", torch.einsum("rkh,rkF->rhF", h_aug, coupled), t3), iters)
            products, coupling, nbytes = tp3_work(tp, rows, K, Hb)
            b_ms, b_by = bound_ms(products, coupling, nbytes)
            out[label] = {"rows": rows, "K": K, "ms": kernel_ms, "plain_ms": plain_ms,
                          "library_ms": pair_ms, "bound_ms": b_ms, "bound_by": b_by}
            _log(f"  fused_tp3 {label} at R={rows} K={K}: whole call {kernel_ms:.4f} ms | plain "
                 f"{plain_ms:.4f} ms | einsum pair {pair_ms:.4f} ms | bound {b_ms:.4f} ms ({b_by})")
            del inp, h_aug, coupled, t3
    return out


def reference_dirs(args, tmp: Path, cfg, ccfg, kernels, card: str) -> dict:
    """Phase F: reference run directories (``.pt`` weights and a flat args
    dump) of the DiffDock-L score model and the shipped confidence model,
    converted by ``prepare_model_dir`` and held to the weights they were
    made from; a dock from them against the same dock from native run
    directories; and the receptor crop of ``crop_beyond`` by mask and by
    pocket compaction, each held to its plain-version twin."""
    import numpy as np
    import torch

    from diffdock_tpu_torch.cli import dock as cli
    from diffdock_tpu_torch.data.esm import LazyNpyTable
    from diffdock_tpu_torch.data.inference_dataset import InferenceDatasetBuilder, InferenceSpec
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.models.old_models import build_confidence_model
    from diffdock_tpu_torch.models.score_model import CGScoreModel
    from diffdock_tpu_torch.train.checkpoints import load_checkpoint
    from diffdock_tpu_torch.utils import simple_yaml
    from diffdock_tpu_torch.utils.convert import state_dict_from_flax
    from diffdock_tpu_torch.utils.download import DEFAULT_CKPT, prepare_model_dir
    from diffdock_tpu_torch.utils.torch_import import config_from_reference_args

    t_start = time.perf_counter()
    report: dict = {}
    # F1: the reference directories, from the port's random weights
    ref_dirs, made = {}, {}
    for name, c, build, seed, kw in (("score", cfg, CGScoreModel, 0, {}),
                                     ("confidence", ccfg, build_confidence_model, 1,
                                      dict(confidence_mode=True, old=True))):
        model = build(c)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        made[name] = model.state_dict()
        d = tmp / "reference" / name
        d.mkdir(parents=True)
        torch.save(reference_state_dict(model), d / DEFAULT_CKPT)
        args_dump = reference_args(c)
        (d / "model_parameters.yml").write_text(simple_yaml.dump(args_dump))
        derived = config_from_reference_args(simple_yaml.load((d / "model_parameters.yml").read_text()), **kw)
        # the old family reads no embed_also_ligand; its derived value is False
        differ = [f.name for f in dataclasses.fields(c)
                  if getattr(derived, f.name) != getattr(c, f.name) and f.name != "embed_also_ligand"]
        if differ:
            raise PhaseError(f"{name}: the args dump derives another config ({differ})")
        ref_dirs[name] = (str(d), kw)
        _log(f"  {name}: {len(made[name])} tensors -> {(d / DEFAULT_CKPT).stat().st_size / 2**20:.1f} MiB "
             f"reference checkpoint + {len(args_dump)} args")
    # F2: converted once by prepare_model_dir, every leaf bit for bit
    t0 = time.perf_counter()
    converted = {name: prepare_model_dir(d, **kw) for name, (d, kw) in ref_dirs.items()}
    report["conversion_s"] = time.perf_counter() - t0
    for name, out in converted.items():
        tree, c, _ = load_checkpoint(out)
        got = state_dict_from_flax(tree, c)
        bad = [k for k, v in made[name].items()
               if k not in got or got[k].dtype != v.dtype or not torch.equal(got[k], v)]
        if bad or set(got) != set(made[name]):
            raise PhaseError(f"{name}: converted weights differ from the ones written: {bad[:5]}")
    _log(f"  converted by prepare_model_dir in {report['conversion_s']:.2f} s; every leaf equal bit for bit")

    # F3: the dock from the reference directories against the dock from
    # native directories with the same weights
    native = _write_run_dirs(tmp / "runs_native_f", cfg, ccfg)
    name = REFERENCE_COMPLEX
    d = E2E_SYNTH / name
    builder = InferenceDatasetBuilder(esm_table=LazyNpyTable(str(E2E_SYNTH / "_esm")))
    mol, protein, lm = builder.load(InferenceSpec(name, str(d / f"{name}_protein_processed.pdb"),
                                                  ligand_description=str(d / f"{name}_ligand.sdf")))
    P = args.poses

    def pipeline(dirs, *extra):
        return cli.load_pipeline(cli.get_parser().parse_args(
            ["--model_dir", dirs["score"], "--confidence_model_dir", dirs["confidence"], "--device", "cuda",
             "--compute_dtype", "float32", *extra]))

    docks = {}
    for label, dirs in (("reference", {k: v[0] for k, v in ref_dirs.items()}), ("native", native)):
        pipe = pipeline(dirs)
        data, aa, _ = pipe.featurize(mol, protein, lm)
        expected = dock_launches(pipe, data, aa, P)
        for m in kernels.values():
            m.counts.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.dock_complex(data, num_poses=P, seed=0, aa_data=aa)
        wall = time.perf_counter() - t0
        launches = {k: v for m in kernels.values() for k, v in m.counts.as_dict().items()}
        if launches["fused_tp3"] != expected or any(v for k, v in launches.items() if "reference" in k):
            raise PhaseError(f"{label} dock launch counts {launches} != expected {expected} fused_tp3 / 0 plain")
        docks[label] = res
        report[f"{label}_dock"] = {"wall_s": wall, "launches": launches}
        _log(f"  dock from {label} run dirs: {P} poses in {wall:.2f} s, {launches['fused_tp3']} fused_tp3 "
             f"launches (expected {expected})")
        del pipe
    pose_diff = float(np.abs(docks["reference"].poses - docks["native"].poses).max())
    conf_diff = float(np.abs(docks["reference"].confidence - docks["native"].confidence).max())
    _log(f"  reference vs native dock: max |poses| diff {pose_diff:.1e} A, max |confidence| diff {conf_diff:.1e}")
    if pose_diff != 0.0 or conf_diff != 0.0 or not np.array_equal(docks["reference"].order, docks["native"].order):
        raise PhaseError("the docks from reference and native run directories differ")
    report["reference_vs_native"] = {"max_abs_pose_diff": pose_diff, "max_abs_conf_diff": conf_diff}

    # F4: the receptor crop, by mask and by pocket compaction, each against
    # its plain-version twin from the same draws
    ref_args = {k: v[0] for k, v in ref_dirs.items()}
    for label, extra in (("mask", []), ("pocket", ["--pocket_capacity", str(POCKET_CAPACITY)])):
        pipe = pipeline(ref_args, "--crop_beyond", str(CROP_BEYOND), *extra)
        ccrop = pipe.score_cfg
        data, aa, _ = pipe.featurize(mol, protein, lm)
        bucket = pipe.dock_bucket(data)[0]
        expected = dock_launches(pipe, data, aa, P)
        drawn = {}

        def noise(num_poses, n_bonds, seed):
            drawn[seed] = pipe.draw_noise(num_poses, n_bonds, seed)
            return drawn[seed]

        for m in kernels.values():
            m.counts.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.dock_complex(data, num_poses=P, seed=0, aa_data=aa, noise=noise)
        wall = time.perf_counter() - t0
        launches = {k: v for m in kernels.values() for k, v in m.counts.as_dict().items()}
        if launches["fused_tp3"] != expected or any(v for k, v in launches.items() if "reference" in k):
            raise PhaseError(f"crop dock ({label}) launch counts {launches} != expected {expected} "
                             "fused_tp3 / 0 plain")
        if not (np.isfinite(res.poses).all() and np.isfinite(res.confidence).all()):
            raise PhaseError(f"crop dock ({label}) gave non-finite poses or confidences")
        ref_pipe = DockingPipeline(ccrop, pipe.model.state_dict(), pipe.sampler_cfg, pipe.so3, pipe.torus,
                                   device=pipe.device, reference_kernels=True,
                                   confidence_cfg=pipe.confidence_cfg,
                                   confidence_weights=pipe.confidence_model.state_dict(),
                                   pocket_capacity=pipe.pocket_capacity)
        ref_res = ref_pipe.dock_complex(data, num_poses=P, seed=0, aa_data=aa,
                                        noise=lambda num_poses, n_bonds, seed: drawn[seed])
        del ref_pipe

        def nudged(num_poses, n_bonds, seed):
            init, steps = drawn[seed]
            g = torch.Generator(device=pipe.device).manual_seed(seed + 1)
            e = torch.randn(init.tr.shape, generator=g, device=pipe.device)
            return init._replace(tr=init.tr * (1 + NUDGE * e)), steps

        nudge_gap = float(np.abs(pipe.dock_complex(data, num_poses=P, seed=0, aa_data=aa,
                                                   noise=nudged).poses - res.poses).max())
        agree = docks_agree(res, ref_res, pose_tol=max(POSE_ATOL, 2 * nudge_gap))
        prof = profile_dock(pipe, data, aa, P)
        entry = {"bucket": list(bucket), "pre_crop_radius": pipe.pre_crop_radius,
                 "pocket_capacity": pipe.pocket_capacity, "wall_s": wall, "launches": launches,
                 "expected_fused_tp3": expected, "nudge_gap": nudge_gap, "plain": agree,
                 "device_busy_share": prof["device_busy_share"], "profile": prof}
        if label == "pocket":
            # the score model's three blocks with the receptor at the
            # pocket's rows: the shapes fused_tp3 runs at under compaction
            blocks = dict(list(tp_blocks(pipe.model, pipe.confidence_model, ccrop, ccfg, data, aa, P, P,
                                         bucket=(bucket[0], POCKET_CAPACITY, 0)).items())[:3])
            entry["kernel_checks"] = check_blocks(["fused_tp3"], blocks, pipe.device,
                                                  tag=f" [pocket {POCKET_CAPACITY}]")["fused_tp3"]
            entry["timings"] = time_tp3_blocks(blocks, pipe.device, args.iters)
        report[f"crop_{label}"] = entry
        _log(f"  crop dock ({label}{', capacity ' + str(POCKET_CAPACITY) if extra else ''}): bucket "
             f"{tuple(bucket)}, {P} poses in {wall:.2f} s, {launches['fused_tp3']} fused_tp3 launches "
             f"(expected {expected}), device busy {100 * prof['device_busy_share']:.1f} % | {card}")
        del pipe
    _log(f"[F reference run dirs] {name} | conversion {report['conversion_s']:.2f} s | "
         f"crop docks {report['crop_mask']['wall_s']:.2f} / {report['crop_pocket']['wall_s']:.2f} s | "
         f"{card} | phase {time.perf_counter() - t_start:.1f} s")
    return report


# phase G: confidence training and new-architecture ranking on the card.
# Eight of phase E's complexes, the first four of the (48, 320) bucket and
# the last four of (48, 704), padded by the CLI to one bucket, (48, 704),
# with 3328 receptor-atom rows for the all-atom model
CONF_COMPLEXES = TRAIN_COMPLEXES[:4] + TRAIN_COMPLEXES[-4:]
# the coarse-grained confidence model at DiffDock-L's width and depth (the
# JAX CLI has no ESM or reduce_pseudoscalars flag, so it has neither), and
# the all-atom model at the width of the shipped confidence model
CONF_CG_ARGS = ["--ns", "48", "--nv", "10", "--num_conv_layers", "3", "--num_prot_emb_layers", "3"]
CONF_AA_ARGS = ["--all_atoms", "--ns", "24", "--nv", "6", "--num_conv_layers", "5", "--num_prot_emb_layers", "0"]
CONF_SAMPLES, CONF_STEPS, CONF_BATCH, CONF_EPOCHS = 4, 8, 4, 2
# the losses of G3's twin steps: BCE at one cutoff, CE over the bins of two,
# MSE on the RMSD
CONF_LOSSES = {"bce": {}, "ce": {"rmsd_classification_cutoff": (2.0, 5.0)}, "mse": {"rmsd_prediction": True}}
# the leaves whose exact gradient is zero (see conf_zero_gradient_leaves):
# both routes' rounding noise there is held within this share of the
# model's largest gradient, and their weights within 2 lr
ZERO_GRAD_RTOL = 1e-4
# G5: the dock ranked by each run directory
CONF_DOCK_COMPLEX = TRAIN_COMPLEXES[0]


def conf_train_launches(cfg) -> int:
    """Merged contractions of one training forward of a new-architecture
    confidence model: its receptor embedding inline, then the forward."""
    from diffdock_tpu_torch.models.old_models import confidence_launches

    return confidence_launches(cfg) + confidence_launches(cfg, embed=True)


def conf_zero_gradient_leaves(model) -> set:
    """Flax paths of the leaves whose exact gradient is zero when the
    confidence head starts with a training-mode batch norm: the biases of
    the Linears such a norm follows (it subtracts the batch mean), and the
    last conv layer's batch-norm bias, which shifts every pooled row by the
    same vector before that norm. Both routes give rounding noise there."""
    from diffdock_tpu_torch.models.score_model import ConfidenceMLP
    from diffdock_tpu_torch.utils.convert import flax_path

    out = {"/".join(flax_path(f"{name}.layers.{i}.bias"))
           for name, m in model.named_modules() if isinstance(m, ConfidenceMLP) and m.norms is not None
           for i in range(2)}
    if model.confidence_predictor.norms is not None:
        out.add(f"conv_{len(model.conv_layers) - 1}/bn/bias")
    return out


def conf_blocks(cg_model, aa_model, nl: int, nr: int, na: int, kr: int, ka: int, ar: int) -> dict:
    """The merged contractions of a training forward of CONF_BATCH
    complexes at the shared bucket: the coarse-grained confidence model's
    three blocks (the joint layer 0's cross blocks, the last protein
    embedding layer), and the all-atom model's nine edge types at its
    layer L-2 (the last with atom receivers; its TP is the ladder's
    widest): label -> (tp, rows, K, H)."""
    B = CONF_BATCH
    Hc, Ha = 3 * cg_model.cfg.ns, 3 * aa_model.cfg.ns
    tp_cg = cg_model.conv_layers[0].tp
    tp_aa = aa_model.conv_layers[aa_model.cfg.num_conv_layers - 2].tp
    blocks = {
        "lig<-rec cross (CG confidence conv_0)": (tp_cg, B * nl, nr, Hc),
        "rec<-lig cross (CG confidence conv_0)": (tp_cg, B * nr, nl, Hc),
        "rec<-rec (CG confidence rec_emb_2)": (cg_model.rec_emb_layers[-1].tp, B * nr, kr, Hc),
    }
    for label, rows, K in (("lig<-lig radius", nl, nl), ("lig<-rec", nl, nr), ("lig<-atom", nl, na),
                           ("rec<-rec", nr, kr), ("rec<-lig", nr, nl), ("rec<-atom", nr, ar),
                           ("atom<-atom", na, ka), ("atom<-lig", na, nl), ("atom<-rec", na, 1)):
        blocks[f"{label} (AA confidence)"] = (tp_aa, B * rows, K, Ha)
    return blocks


def conf_twin_step(model, tc, sd, batch, poses, labels, seed: int, dev, pin: dict | None = None) -> dict:
    """One confidence train step of ``model`` from the weights ``sd`` with
    the batch, poses, labels and dropout generator of ``seed``, ReLU ties
    pinned to ``pin`` as in :func:`twin_step`: the metrics, the gradients,
    params and batch stats by flax path (numpy), the launch counts and the
    output of every pre-ReLU Linear."""
    import torch

    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.train import confidence as tconf

    model.load_state_dict(sd, strict=True)
    state = tconf.create_confidence_train_state(model, tc)
    acts: dict = {}
    hooks = record_pre_relu(model, acts, pin)
    ft.counts.reset()
    try:
        state, metrics = tconf.make_confidence_train_step(model, tc)(
            state, batch, poses, labels, torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _flat_leaves(model, state.grads), "params": _flat_leaves(model, state.params),
            "stats": {k: v.detach().cpu().numpy() for k, v in state.batch_stats.items()},
            "counts": ft.counts.as_dict(), "acts": acts}


def compare_conf_twins(model, plain: dict, kern: dict, lr: float) -> dict:
    """The kernel step against the plain one under phase E3's limits
    (:func:`compare_twins`), the zero-gradient leaves held apart: their
    gradients within ZERO_GRAD_RTOL of the model's largest on both routes,
    their weights within 2 lr."""
    import numpy as np

    zero = conf_zero_gradient_leaves(model)
    largest = max(float(np.abs(g).max(initial=0.0)) for g in plain["grads"].values())
    noise = max(max(float(np.abs(r["grads"][k]).max(initial=0.0)) for r in (plain, kern)) for k in zero)
    moved = max(float(np.abs(kern["params"][k] - plain["params"][k]).max(initial=0.0)) for k in zero)

    def rest(r):
        return dict(r, grads={k: v for k, v in r["grads"].items() if k not in zero},
                    params={k: v for k, v in r["params"].items() if k not in zero})

    out = compare_twins(model, rest(plain), rest(kern), lr)
    out.update(zero_leaves=sorted(zero), zero_grad_share=noise / max(largest, 1e-30),
               zero_param_err_lr=moved / lr)
    if noise > ZERO_GRAD_RTOL * largest:
        out["outside"].append("zero_grad")
    if moved > 2 * lr + 1e-6:
        out["outside"].append("zero_param")
    out["ok"] = not out["outside"]
    return out


def confidence_phase(args, tmp: Path, kernels, card: str, dev) -> dict:
    """Phase G: G1 fused_tp3's gradient at the confidence models' training
    blocks at full width; G2 the port's confidence-train CLI, a
    coarse-grained model at DiffDock-L width generating the pose caches,
    then the all-atom model trained on them, every generation dock and
    every step's launches counted; G3 one step from each saved state
    through the kernels and through the plain versions for BCE, CE and
    MSE; G4 the warm step's wall, peak memory and a profile of one step per
    model; G5 a dock through the dock CLI's ``load_pipeline`` ranked by each
    run directory, against the plain versions' confidences on its poses."""
    import numpy as np
    import torch

    from diffdock_tpu_torch.cli import confidence_train as conf_cli
    from diffdock_tpu_torch.cli import dock as dock_cli
    from diffdock_tpu_torch.data import chem
    from diffdock_tpu_torch.data.complexes import AAComplexData, to_device
    from diffdock_tpu_torch.data.loaders import stack_padded
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.models.factory import build_model
    from diffdock_tpu_torch.models.old_models import confidence_launches
    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.train import checkpoints as ckpt
    from diffdock_tpu_torch.train import confidence as tconf
    from diffdock_tpu_torch.utils import flax_msgpack
    from diffdock_tpu_torch.utils.convert import flax_from_model, state_dict_from_flax

    t_start = time.perf_counter()
    report: dict = {}
    root = tmp / "confidence"
    root.mkdir(parents=True, exist_ok=True)
    (root / "train.txt").write_text("\n".join(CONF_COMPLEXES) + "\n")
    common = ["--data_dir", str(E2E_SYNTH), "--split_train", str(root / "train.txt"),
              "--cache_path", str(root / "cache"), "--pose_cache", str(root / "poses"),
              "--samples_per_complex", str(CONF_SAMPLES), "--inference_steps", str(CONF_STEPS),
              "--batch_size", str(CONF_BATCH), "--n_epochs", str(CONF_EPOCHS), "--seed", "0",
              "--device", str(dev)]
    runs = {"cg": common + ["--log_dir", str(root / "cg"), "--cache_id", "0"] + CONF_CG_ARGS,
            "aa": common + ["--log_dir", str(root / "aa"), "--cache_ids_to_combine", "0"] + CONF_AA_ARGS}
    parsed = {k: conf_cli.get_parser().parse_args(v) for k, v in runs.items()}
    cfgs = {k: conf_cli.confidence_config(a, 1) for k, a in parsed.items()}
    datas, _ = conf_cli.load_complexes(parsed["aa"])  # the all-atom trees at the shared bucket
    d0 = next(iter(datas.values()))
    nl, nr = d0.base.lig_pos.shape[0], d0.base.rec_pos.shape[0]
    na, ka, ar = d0.atom_pos.shape[0], d0.atom_nbr.shape[1], d0.res_atom_idx.shape[1]
    kr = d0.base.rec_nbr.shape[1]

    # G1: the gradient at the confidence models' blocks
    t0 = time.perf_counter()
    models = {k: build_model(c).to(dev) for k, c in cfgs.items()}
    blocks = conf_blocks(models["cg"], models["aa"], nl, nr, na, kr, ka, ar)
    report["gradients"] = tp3_gradients(blocks, dev)
    del models
    _log(f"[G1 fused_tp3 gradient] {len(blocks)} blocks at (nl, nr, na) = ({nl}, {nr}, {na}) x "
         f"{CONF_BATCH} | {time.perf_counter() - t0:.1f} s")

    # G2: the CLI, each generation dock and each step counted
    gen_calls, steps = [], []
    generate, make_step = tconf.generate_poses_for_complex, tconf.make_confidence_train_step

    def counted_generate(pipeline, data, samples, seed, **kw):
        before = ft.counts.as_dict()
        out = generate(pipeline, data, samples, seed, **kw)
        after = ft.counts.as_dict()
        want = (expected_tp3_launches(pipeline.score_cfg, pipeline.sampler_cfg.num_steps,
                                      pipeline.dock_bucket(data)[0][2])
                * -(-samples // pipeline.effective_pose_chunk(data, samples)))
        gen_calls.append({**{k: after[k] - before[k] for k in after}, "expected": want})
        return out

    def counted_make_step(model, cfg, **kw):
        step = make_step(model, cfg, **kw)

        def counted(state, batch, poses, labels, generator=None):
            before = ft.counts.as_dict()
            out = step(state, batch, poses, labels, generator)
            after = ft.counts.as_dict()
            steps.append({"batch": int(poses.shape[0]), "loss": float(out[1]["loss"]),
                          "expected": conf_train_launches(model.cfg),
                          **{k: after[k] - before[k] for k in after}})
            return out
        return counted

    cli_report = {}
    for key in ("cg", "aa"):
        t0 = time.perf_counter()
        gen_calls.clear()
        steps.clear()
        for m in kernels.values():
            m.counts.reset()
        tconf.generate_poses_for_complex, tconf.make_confidence_train_step = counted_generate, counted_make_step
        try:
            rc = conf_cli.main(runs[key])
        finally:
            tconf.generate_poses_for_complex, tconf.make_confidence_train_step = generate, make_step
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for m in kernels.values() for k, v in m.counts.as_dict().items()}
        log_dir = Path(parsed[key].log_dir)
        if rc != 0:
            raise PhaseError(f"the confidence-train CLI ({key}) returned {rc}")
        records = [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]
        caches = {n: tconf.load_pose_cache(root / "poses", n, [0]) for n in CONF_COMPLEXES}
        bad_cache = [n for n, c in caches.items()
                     if c is None or c[0].shape != (CONF_SAMPLES, nl, 3) or not np.isfinite(c[1]).all()]
        n_steps = CONF_EPOCHS * -(-len(CONF_COMPLEXES) // CONF_BATCH)
        step_bad = [s for s in steps if not (s["fused_tp3"] == s["fused_tp3_vjp"] == s["expected"]
                                             and s["fused_tp3_reference"] == 0 and s["batch"] == CONF_BATCH)]
        gen_bad = [g for g in gen_calls if g["fused_tp3"] != g["expected"] or g["fused_tp3_reference"]]
        want_gens = len(CONF_COMPLEXES) if key == "cg" else 0
        total = sum(g["fused_tp3"] for g in gen_calls) + sum(s["fused_tp3"] for s in steps)
        # the weights file read back and written again: the same bytes
        params, run_cfg, meta = ckpt.load_checkpoint(str(log_dir), "last_model.msgpack")
        back = build_model(run_cfg)
        back.load_state_dict(state_dict_from_flax(params, run_cfg), strict=True)
        same_bytes = flax_msgpack.to_bytes(flax_from_model(back)) == (log_dir / "last_model.msgpack").read_bytes()
        losses = [r["loss"] for r in records]
        _log(f"  G2 {key}: {len(gen_calls)} generation docks, fused_tp3 {[g['fused_tp3'] for g in gen_calls]} "
             f"(expected {[g['expected'] for g in gen_calls]}); {len(steps)} steps, fused_tp3 "
             f"{[s['fused_tp3'] for s in steps]}, VJP {[s['fused_tp3_vjp'] for s in steps]} (expected "
             f"{conf_train_launches(run_cfg)} each); run {launches}; losses {losses}; last_model read "
             f"back bit for bit: {same_bytes}")
        if bad_cache or step_bad or gen_bad or len(gen_calls) != want_gens or len(steps) != n_steps or \
                launches["fused_tp3"] != total or launches["fused_tp3_reference"] or \
                launches["fused_tp3_vjp"] != sum(s["fused_tp3"] for s in steps) or \
                len(records) != CONF_EPOCHS or not np.isfinite(losses).all() or not same_bytes or \
                meta.get("epoch") != CONF_EPOCHS - 1 or run_cfg != cfgs[key]:
            raise PhaseError(f"confidence-train CLI ({key}): caches {bad_cache}, generation {gen_calls}, "
                             f"steps {steps}, run {launches}, records {records}, bytes {same_bytes}")
        cli_report[key] = {"rc": rc, "wall_s": wall, "generation": list(gen_calls), "steps": list(steps),
                           "launches": launches, "metrics": records,
                           "rmsds": {n: c[1].tolist() for n, c in caches.items()}}
        _log(f"[G2 confidence-train CLI {key}] {' '.join(runs[key][-8:])}: {len(CONF_COMPLEXES)} complexes "
             f"at ({nl}, {nr}{', ' + str(na) if key == 'aa' else ''}) x {CONF_EPOCHS} epochs, "
             f"{len(steps)} steps | wall {wall:.2f} s | {card}")
    report["cli"] = cli_report

    # G3: twin steps from each saved state, the same batch and generator
    t0 = time.perf_counter()
    names = list(datas)[:CONF_BATCH]
    cached = [tconf.load_pose_cache(root / "poses", n, [0]) for n in names]
    poses = torch.as_tensor(np.stack([c[0][0] - np.asarray(datas[n].base.original_center)
                                      for n, c in zip(names, cached)]), dtype=torch.float32, device=dev)
    rmsds = [float(c[1][0]) for c in cached]
    batches = {"aa": to_device(stack_padded([datas[n] for n in names]), dev)}
    batches["cg"] = batches["aa"].base
    cases = []
    for key in ("cg", "aa"):
        params, run_cfg, _ = ckpt.load_checkpoint(str(parsed[key].log_dir), "last_model.msgpack")
        saved = state_dict_from_flax(params, run_cfg)
        for loss, loss_kw in CONF_LOSSES.items():
            tc = tconf.ConfidenceTrainConfig(**loss_kw)
            cfg_l = dataclasses.replace(run_cfg, num_confidence_outputs=tc.num_outputs)
            sd = dict(saved)
            if tc.num_outputs != run_cfg.num_confidence_outputs:
                # the head's last layer at the loss's width, drawn from a seed
                g = torch.Generator().manual_seed(0)
                w = saved["confidence_predictor.layers.2.weight"]
                sd["confidence_predictor.layers.2.weight"] = torch.randn(
                    (tc.num_outputs, w.shape[1]), generator=g) / math.sqrt(w.shape[1])
                sd["confidence_predictor.layers.2.bias"] = torch.zeros(tc.num_outputs)
            labels = torch.as_tensor(tc.labels_from_rmsds(rmsds), device=dev)
            km = build_model(cfg_l).to(dev)
            pm = build_model(cfg_l, reference_kernels=True).to(dev)
            plain = conf_twin_step(pm, tc, sd, batches[key], poses, labels, 7, dev)
            kern = conf_twin_step(km, tc, sd, batches[key], poses, labels, 7, dev, pin=plain["acts"])
            n_fwd = conf_train_launches(cfg_l)
            if kern["counts"] != {"fused_tp3": n_fwd, "fused_tp3_bf16": 0, "fused_tp3_reference": 0,
                                  "fused_tp3_vjp": n_fwd} or \
                    plain["counts"] != {"fused_tp3": 0, "fused_tp3_bf16": 0, "fused_tp3_reference": n_fwd,
                                        "fused_tp3_vjp": 0}:
                raise PhaseError(f"G3 twin counts: kernel {kern['counts']}, plain {plain['counts']}")
            c = compare_conf_twins(km, plain, kern, tc.lr)
            cases.append({"model": key, "loss": loss, "loss_plain": plain["metrics"]["loss"], "kernel": c})
            sw = c["relu_switched"]
            _log(f"  G3 {key} {loss} twin: loss {c['loss']:.6f} vs {plain['metrics']['loss']:.6f} (worst metric "
                 f"{c['metric_rel_err']:.3e}, tol {TWIN_LOSS_RTOL:.0e}) | worst gradient leaf "
                 f"{c['grad_worst_leaf']} {c['grad_norm_rel_err']:.3e} in norm (tol {TWIN_GRAD_RTOL:.0e}), all "
                 f"leaves {c['grad_all_rel_err']:.3e} (tol {TWIN_GRAD_ALL_RTOL:.0e}) | params "
                 f"{c['param_solid_err_lr']:.3e} lr where |g| is solid, {c['param_err_lr']:.3e} lr anywhere | "
                 f"batch stats {c['batch_stat_rel_err']:.3e} | zero-gradient leaves: noise "
                 f"{c['zero_grad_share']:.2e} of the largest gradient (tol {ZERO_GRAD_RTOL:.0e}), weights "
                 f"{c['zero_param_err_lr']:.2f} lr | ReLU units switched and pinned {sw['total']}, the "
                 f"largest {sw['largest_share']:.2e} of its layer's | outside: "
                 f"{', '.join(c['outside']) or 'none'}")
            del km, pm, plain, kern
    report["twin"] = {"cases": cases, "limits": {
        "metric": TWIN_LOSS_RTOL, "grad_all": TWIN_GRAD_ALL_RTOL, "grad_leaf": TWIN_GRAD_RTOL,
        "batch_stat": TWIN_STAT_RTOL, "param_solid_lr": TWIN_PARAM_SOLID, "param_lr": 2.0,
        "relu_tie": TWIN_TIE_RTOL, "zero_grad": ZERO_GRAD_RTOL}}
    bad = [(c["model"], c["loss"], c["kernel"]["outside"]) for c in cases if not c["kernel"]["ok"]]
    if bad:
        raise PhaseError(f"the kernel confidence step disagrees with the plain one: {bad}")
    _log(f"[G3 twin steps] {len(cases)} cases | {time.perf_counter() - t0:.1f} s")

    # G4: warm step walls, peak memory, one profiled step per model
    t0 = time.perf_counter()
    timing = {}
    labels = torch.as_tensor(tconf.ConfidenceTrainConfig().labels_from_rmsds(rmsds), device=dev)
    for key in ("cg", "aa"):
        params, run_cfg, _ = ckpt.load_checkpoint(str(parsed[key].log_dir), "last_model.msgpack")
        model = build_model(run_cfg).to(dev)
        model.load_state_dict(state_dict_from_flax(params, run_cfg))
        tc = tconf.ConfidenceTrainConfig()
        state = tconf.create_confidence_train_state(model, tc)
        step = tconf.make_confidence_train_step(model, tc)
        gen = torch.Generator(device=dev).manual_seed(11)

        def one():
            nonlocal state
            state, _m = step(state, batches[key], poses, labels, gen)

        for _ in range(2):
            one()
        walls = []
        for _ in range(TIMED_STEPS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            s0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - s0)
        peak = torch.cuda.max_memory_allocated()
        med = float(np.median(walls))
        timing[key] = {"walls_s": walls, "median_s": med, "complexes_per_s": CONF_BATCH / med,
                       "peak_bytes": peak, "launches_per_step": conf_train_launches(run_cfg)}
        _log(f"  G4 {key} warm step at ({nl}, {nr}{', ' + str(na) if key == 'aa' else ''}) x {CONF_BATCH}: "
             f"median {med:.4f} s (min {min(walls):.4f}, max {max(walls):.4f}) | {CONF_BATCH / med:.2f} "
             f"complexes/s | peak {peak / 2**30:.2f} GiB | {card}")
        timing[key]["profile"] = profile_step(one, med)
        del model, state, step
    report["step_timing"] = timing
    _log(f"[G4 confidence step numbers] {time.perf_counter() - t0:.1f} s")

    # G5: a dock through the dock CLI's load_pipeline, ranked by each run directory
    t0 = time.perf_counter()
    lig = E2E_SYNTH / CONF_DOCK_COMPLEX / f"{CONF_DOCK_COMPLEX}_ligand.sdf"
    pdb = E2E_SYNTH / CONF_DOCK_COMPLEX / f"{CONF_DOCK_COMPLEX}_protein_processed.pdb"
    ranking = {}
    for key in ("cg", "aa"):
        dargs = dock_cli.get_parser().parse_args(
            ["--protein_path", str(pdb), "--ligand", str(lig), "--model_preset", "diffdock_l",
             "--confidence_model_dir", str(parsed[key].log_dir), "--samples_per_complex", str(args.poses),
             "--compute_dtype", "float32", "--device", str(dev)])
        pipe = dock_cli.load_pipeline(dargs)
        ccfg = pipe.confidence_cfg
        data, aa, _heavy = pipe.featurize(chem.read_molecule_file(str(lig)), chem.read_pdb_file(str(pdb)))
        want = dock_launches(pipe, data, aa, args.poses)
        for m in kernels.values():
            m.counts.reset()
        s0 = time.perf_counter()
        res = pipe.dock_complex(data, num_poses=args.poses, seed=0, aa_data=aa)
        torch.cuda.synchronize()
        wall = time.perf_counter() - s0
        launches = {k: v for m in kernels.values() for k, v in m.counts.as_dict().items()}
        ref_pipe = DockingPipeline(pipe.score_cfg, pipe.model.state_dict(), pipe.sampler_cfg, pipe.so3,
                                   pipe.torus, device=dev, reference_kernels=True, confidence_cfg=ccfg,
                                   confidence_weights=pipe.confidence_model.state_dict())
        bucket = pipe.dock_bucket(data)[0]
        final = torch.as_tensor(res.poses - np.asarray(data.original_center)[None, None],
                                dtype=torch.float32, device=dev)
        final = _pad_rows(final.transpose(0, 1), bucket[0] - data.n_lig).transpose(0, 1)
        ft.counts.reset()
        conf_plain = ref_pipe.confidence(ref_pipe.confidence_input(data, aa), final).cpu().numpy()
        plain_counts = ft.counts.as_dict()
        tol = CONF_RTOL * max(float(np.abs(conf_plain).max()), 1.0)
        err = float(np.abs(conf_plain - res.confidence).max())
        order_plain = np.argsort(-conf_plain)
        rank_ok = all(res.confidence[a] > res.confidence[b] for a, b in zip(order_plain[:-1], order_plain[1:])
                      if conf_plain[a] - conf_plain[b] > 2 * tol)
        embed = confidence_launches(ccfg, embed=True)
        _log(f"  G5 {key}: {type(pipe.confidence_model).__name__} from {parsed[key].log_dir}: {args.poses} "
             f"poses in {wall:.2f} s | launches {launches} (expected fused_tp3 {want}: the receptor embedded "
             f"once, {embed} launches) | plain confidences on the same poses: max diff {err:.3e} (tol "
             f"{tol:.3e}), {plain_counts['fused_tp3_reference']} plain launches | order "
             f"{res.order.tolist()} vs {order_plain.tolist()} | {card}")
        if not isinstance(res.confidence, np.ndarray) or not np.isfinite(res.confidence).all() or \
                launches["fused_tp3"] != want or launches["fused_tp3_reference"] or not err <= tol or \
                not rank_ok or plain_counts["fused_tp3"]:
            raise PhaseError(f"G5 {key}: launches {launches} (expected {want}), confidence gap {err:.3e} "
                             f"(tol {tol:.3e}), ranking {rank_ok}")
        ranking[key] = {"model": type(pipe.confidence_model).__name__, "wall_s": wall, "launches": launches,
                        "expected_fused_tp3": want, "embed_launches": embed, "conf_diff": err, "conf_tol": tol,
                        "order": res.order.tolist(), "order_plain": order_plain.tolist()}
        del pipe, ref_pipe
    report["ranking"] = ranking
    _log(f"[G5 ranking] {CONF_DOCK_COMPLEX} | {time.perf_counter() - t0:.1f} s")
    _log(f"[G confidence] {card} | phase {time.perf_counter() - t_start:.1f} s")
    return report


# phase H: bfloat16. The kernel's bfloat16 mode against its plain version:
# both round P to bfloat16 after float32 sums taken in different orders, so
# an element at a rounding tie lands one bfloat16 ulp (2^-8 relative) apart
BF16_KERNEL_RTOL = 1e-3
# relative nudge of the start translations that measures how far bfloat16
# rounding moves the bf16 dock: the kernel and its plain version differ by
# a few P elements one bfloat16 ulp apart, 1-3e-4 of the output's scale
# (H1), so the nudge is 1e-4; the final poses of the kernel dock and its
# plain twin are held to twice the nudged dock's spread
BF16_NUDGE = 1e-4
# the first step of the bf16 dock and its plain twin from the same draws:
# a few P elements one ulp apart move the scores by ~1e-4 of their size
BF16_FIRST_STEP_ATOL = 2e-2
# a bfloat16 score model's scores through the kernel against through its
# plain version, from the same poses, as a share of their scale: the CPU
# tests' bound for a whole bf16 model against JAX's (one-ulp flips of P,
# ~2e-4 of scale at each block, carried through its layers;
# tests/test_torch_port_bf16.py:MODEL_RTOL)
BF16_MODEL_RTOL = 5e-3
# the bf16 confidence model's kernels against its plain versions on the
# same poses, as a share of the confidences' scale: one-ulp differences of
# P compound through the 45 convs of the shipped model (7.9e-3 of scale
# measured by phase H2 on an NVIDIA H100 80GB HBM3 at 700 W)
BF16_CONF_RTOL = 2e-2
# the requests phase H3 sends to the server (phase B's complexes, with
# syn016_l36r224 in the place of syn001_l24r104)
SERVER_COMPLEXES = ("syn000_l50r368", "syn016_l36r224", "syn045_l8r1547")


def tp3_bf16_work(tp, rows: int, K: int, H: int):
    """(FLOPs, bytes) of the gen-3 contraction in bfloat16: both products,
    h_aug, the coupled tensor and the weights read once at 2 bytes, the
    float32 output written once."""
    products, _, _ = tp3_work(tp, rows, K, H)
    f_tot, _weight, w_len = _class_sums(tp)
    Ha = H + 1
    nbytes = 2.0 * (rows * K * Ha + rows * K * f_tot + Ha * w_len) + 4.0 * rows * tp.irreps_out.dim
    return products, nbytes


def file_dock_seconds(res) -> dict:
    """Host seconds of a file dock's featurization, dock (until the poses
    are on the host) and file writing, from its record."""
    return {f"{k}_s": res.timings.host_seconds(k) for k in ("featurize", "dock", "write")}


def _bond_error(bonds, ref_xyz, poses) -> float:
    """The largest change of a bond length over ``poses`` (P, N, 3)."""
    import numpy as np

    i, j = bonds
    ref = np.linalg.norm(ref_xyz[i] - ref_xyz[j], axis=-1)
    return float(max(np.abs(np.linalg.norm(p[i] - p[j], axis=-1) - ref).max() for p in poses))


def bf16_phase(args, tmp: Path, cfg, ccfg, blocks: dict, f32_dock: dict, f32_res, noise, data, aa,
               so3, torus, card: str, dev) -> dict:
    """Phase H: H1 the bfloat16 mode against its plain version and timed at
    the six blocks; H2 phase 4's dock in bfloat16 (launch counts by mode,
    its plain twin, walls, memory); H3 the web server on the card."""
    import numpy as np
    import torch

    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.ops import fused_tp3 as ft

    t_start = time.perf_counter()
    bf16 = torch.bfloat16
    report: dict = {}

    # H1: kernel vs plain (and against itself), then times, at the seven blocks
    h1 = {}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.inference_mode():
        for i, (label, (tp, rows, K, Hb)) in enumerate(blocks.items()):
            inp = tp_inputs(tp, rows, K, Hb, seed=i, device=dev)
            binp = [a.to(bf16) for a in inp[:4]] + list(inp[4:])
            got = ft.fused_tp3(tp, *binp)
            again = ft.fused_tp3(tp, *binp)
            ref = ft.fused_tp3_reference(tp, *binp)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = max(ref.abs().max().item(), 1.0)
            ok = bool(torch.isfinite(got).all()) and err <= BF16_KERNEL_RTOL * scale
            if not ok:
                raise PhaseError(f"fused_tp3_bf16 disagrees with its plain version at {label}: "
                                 f"{err:.3e} > {BF16_KERNEL_RTOL:.0e} x {scale:.3g}")
            if not torch.equal(got, again):
                raise PhaseError(f"fused_tp3_bf16 gave other bits on a second launch at {label}")
            ops = ft.prepare(tp, *binp)
            classes, table = ops[0], ops[4]
            plan = ft.bf16_plan(table, rows, K, Hb, n_sm)
            # the library pair's operands: h_aug and the coupled columns
            # without the kernel's padding
            h_aug = torch.cat([binp[2], binp[3][..., None]], dim=-1)
            coupled = ft.merged_coupled(tp, binp[0], binp[1])[1]
            t3 = _block_diag_t3(tp, classes, inp[4], inp[5], bf16)
            ms = cuda_ms(lambda: ft.launch(*ops[1:]), args.iters)
            f32_ms = cuda_ms(lambda: ft.forward_f32(tp, *inp), args.iters)
            plain_ms = cuda_ms(lambda: ft.fused_tp3_reference(tp, *binp), args.iters)
            # the library pair in the same types: cuBLAS bfloat16 products
            library_ms = cuda_ms(lambda: torch.einsum(
                "rhF,hFW->rW", torch.einsum("rkh,rkF->rhF", h_aug, coupled), t3), args.iters)
            flops, nbytes = tp3_bf16_work(tp, rows, K, Hb)
            t_ops, t_bytes = flops / BF16_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
            h1[label] = {"rows": rows, "K": K, "H": Hb, "max_abs_err": err, "max_abs_ref": scale,
                         "repeat_identical": True, "ms": ms, "f32_ms": f32_ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "bound_share": b_ms / ms, "tflops": flops / ms / 1e9, "flops": flops,
                         "bytes": nbytes, "plan": {"R": plan.R, "whole": plan.whole,
                                                   "k_parts": plan.k_parts, "blocks": plan.n_blocks}}
            _log(f"  fused_tp3_bf16 {label}: R={rows} K={K} H+1={Hb + 1} max_abs_err={err:.3e} (tol "
                 f"{BF16_KERNEL_RTOL:.0e} x {scale:.3g}), repeat identical | kernel {ms:.4f} ms | float32 "
                 f"kernel {f32_ms:.4f} ms | plain {plain_ms:.4f} ms | library bf16 pair {library_ms:.4f} ms | "
                 f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) | "
                 f"{100 * b_ms / ms:.1f} % of bound | {flops / ms / 1e9:.2f} TFLOP/s | plan R={plan.R} "
                 f"{'all slices' if plan.whole else 'one slice'} per block, {plan.k_parts} neighbour "
                 f"part(s), {plan.n_blocks} blocks")
            del inp, binp, got, again, ref, ops, coupled, h_aug, t3
    report["kernel"] = h1
    _log(f"[H1 bf16 kernel vs plain] worst {max(v['max_abs_err'] / v['max_abs_ref'] for v in h1.values()):.2e} "
         f"of scale | {card} | {time.perf_counter() - t_start:.1f} s")

    # H2: phase 4's dock with both models in bfloat16, from phase 4's draws
    t0 = time.perf_counter()
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    bccfg = dataclasses.replace(ccfg, compute_dtype="bfloat16")
    models = dict(confidence_cfg=bccfg, confidence_weights=1)
    sampler = SamplerConfig()  # 20-step schedule, 19 steps, as phase 4
    pipe = DockingPipeline(bcfg, 0, sampler, so3, torus, device=dev, **models)
    P = args.poses
    pipe.dock_complex(data, num_poses=P, seed=1, aa_data=aa)  # pays the first-call costs
    expected = mode_launches(pipe, data, aa, P)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft.counts.reset()
    t1 = time.perf_counter()
    res = pipe.dock_complex(data, num_poses=P, seed=0, noise=noise, aa_data=aa, return_trajectory=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = ft.counts.as_dict()
    peak = torch.cuda.max_memory_allocated()
    _log(f"  launches {launches} (expected {expected}: the score model's conv layers and the confidence "
         f"model in bf16, final_conv and tor_bond_conv in float32)")
    if launches["fused_tp3_bf16"] != expected["fused_tp3_bf16"] or \
            launches["fused_tp3"] != expected["fused_tp3"] or launches["fused_tp3_reference"]:
        raise PhaseError(f"bf16 dock launch counts {launches} != expected {expected}, 0 plain")
    if res.poses.shape != (P, data.n_lig, 3) or not np.isfinite(res.poses).all() or \
            not np.isfinite(res.confidence).all():
        raise PhaseError("the bf16 dock gave non-finite poses or confidences")
    nbr, mask = np.asarray(data.lig_bond_nbr), np.asarray(data.lig_bond_mask)
    bi, bk = np.nonzero(mask)
    bonds = (bi, nbr[bi, bk])
    start = np.asarray(data.lig_pos, np.float64)[: data.n_lig]
    bond_err = _bond_error(bonds, start, res.poses.astype(np.float64))
    if bond_err > BOND_ATOL:
        raise PhaseError(f"bf16 dock: bond lengths moved by {bond_err:.2e} A (tol {BOND_ATOL:.0e})")

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pipe.dock_complex(data, num_poses=P, seed=0, noise=noise, aa_data=aa)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    med, f32_med = float(np.median(walls)), float(np.median(f32_dock["repeat_wall_s"]))
    rmsd_f32 = np.sqrt(((res.poses - f32_res.poses) ** 2).sum(-1).mean(-1))
    _log(f"[H2 bf16 dock] diffdock_l + shipped confidence in bf16, {P} poses, {sampler.num_steps} steps | "
         f"{wall:.2f} s | 5 warm: median {med:.4f} s ({P / med:.3f} poses/s), min {min(walls):.4f}, "
         f"max {max(walls):.4f} | float32 dock (phase 4): median {f32_med:.4f} s ({P / f32_med:.3f} "
         f"poses/s) | peak {peak / 2**30:.2f} GiB (float32 {f32_dock['max_memory_allocated'] / 2**30:.2f}) "
         f"| bond lengths within {bond_err:.2e} A | {card}")
    _log(f"  per-pose RMSD to the float32 dock from the same draws (no gate): "
         f"{' '.join(f'{r:.3f}' for r in rmsd_f32)} A")
    prof = profile_dock(pipe, data, aa, P, names=("fused_tp3_bf16", "fused_tp3_kernel", "fused_tp3_reduce"))
    _log(f"  H2 device time per bf16 dock: fused_tp3_bf16 {prof['ms_by_name']['fused_tp3_bf16']:.1f} ms "
         f"({prof['launches_by_name']['fused_tp3_bf16']} kernel launches) | float32 fused_tp3 "
         f"{prof['ms_by_name']['fused_tp3_kernel'] + prof['ms_by_name']['fused_tp3_reduce']:.1f} ms | all "
         f"{prof['device_ms']:.1f} ms | {card}")

    # the same dock through the bfloat16 plain versions, and nudged
    ref_pipe = DockingPipeline(bcfg, 0, sampler, so3, torus, device=dev, reference_kernels=True, **models)
    ref_res = ref_pipe.dock_complex(data, num_poses=P, seed=0, noise=noise, aa_data=aa, return_trajectory=True)
    init, steps = noise(P, 0, 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    e = torch.randn(init.tr.shape, generator=gen, device=dev)
    nudged = (init._replace(tr=init.tr * (1 + BF16_NUDGE * e)), steps)
    nudge_res = pipe.dock_complex(data, num_poses=P, seed=0, noise=lambda *a: nudged, aa_data=aa,
                                  return_trajectory=True)
    torch.cuda.synchronize()
    step_gap = [float(np.abs(res.trajectory[k] - ref_res.trajectory[k]).max())
                for k in range(res.trajectory.shape[0])]
    nudge_gap = [float(np.abs(res.trajectory[k] - nudge_res.trajectory[k]).max())
                 for k in range(res.trajectory.shape[0])]
    _log(f"  max |poses(kernel) - poses(plain)| by step: {' '.join(f'{g:.1e}' for g in step_gap)}")
    _log(f"  max |poses(kernel) - poses(kernel, start nudged by {BF16_NUDGE:.1e})| by step: "
         f"{' '.join(f'{g:.1e}' for g in nudge_gap)}")
    if not (step_gap[0] == 0.0 and step_gap[1] <= BF16_FIRST_STEP_ATOL):
        raise PhaseError(f"bf16 kernel and plain docks part by {step_gap[1]:.3e} A after the first step "
                         f"(tol {BF16_FIRST_STEP_ATOL:.0e})")
    # the twins' final poses and confidences: within twice what the nudge
    # moves them (the poses as in phase A; the confidences the same way,
    # since the random-weight confidence model moves a lot with its poses)
    conf_scale = max(float(np.abs(ref_res.confidence).max()), 1.0)
    conf_nudge = float(np.abs(res.confidence - nudge_res.confidence).max())
    plain = docks_agree(res, ref_res, pose_tol=max(POSE_ATOL, 2 * nudge_gap[-1]),
                        conf_tol=max(CONF_RTOL * conf_scale, 2 * conf_nudge))
    # the bf16 confidence model's plain version on the kernel dock's own poses
    nl = pipe.dock_bucket(data)[0][0]
    final = torch.as_tensor(res.poses - np.asarray(data.original_center)[None, None],
                            dtype=torch.float32, device=dev)
    final = _pad_rows(final.transpose(0, 1), nl - data.n_lig).transpose(0, 1)
    conf_same = ref_pipe.confidence(ref_pipe.confidence_input(data, aa), final).cpu().numpy()
    conf_same_err = float(np.abs(conf_same - res.confidence).max())
    _log(f"  confidences nudged: max diff {conf_nudge:.3e}; plain bf16 confidence model on the kernel dock's "
         f"poses: max diff {conf_same_err:.3e} (tol {BF16_CONF_RTOL:.0e} x {conf_scale:.3g})")
    if not conf_same_err <= BF16_CONF_RTOL * conf_scale:
        raise PhaseError("the bf16 confidence model's plain version disagrees on the kernel dock's poses")
    plain.update(conf_nudge=conf_nudge, conf_same_poses_diff=conf_same_err)
    del ref_pipe
    mem = score_memory(pipe, bcfg, card)
    report["dock"] = {"wall_s": wall, "repeat_wall_s": walls, "poses_per_s": P / med,
                      "f32_poses_per_s": P / f32_med, "max_memory_allocated": peak,
                      "f32_max_memory_allocated": f32_dock["max_memory_allocated"], "launches": launches,
                      "expected": expected, "bond_error": bond_err, "rmsd_to_f32": rmsd_f32.tolist(),
                      "plain": dict(plain, step_gap=step_gap, nudge_gap=nudge_gap),
                      "score_memory": mem, "profile": prof, "s": time.perf_counter() - t0}
    del pipe

    report["server"] = server_phase(args, tmp, cfg, card)
    _log(f"[H bf16] {card} | phase {time.perf_counter() - t_start:.1f} s")
    return report


def server_phase(args, tmp: Path, cfg, card: str) -> dict:
    """H3: the web server in this process on a free port, over phase B's
    run directories (the server, like the dock CLI, has no ESM input) with
    its defaults (bf16 score model, cuda): three requests from files, each
    to ``done``, its rank1.sdf parsed and its bond lengths held to the
    input's, exact launch counts; a bad submit gets 400; the console entry
    point's help returns 0."""
    import threading
    import urllib.error
    import urllib.request
    import uuid

    import numpy as np

    from diffdock_tpu_torch.app import server as server_mod
    from diffdock_tpu_torch.data import chem
    from diffdock_tpu_torch.ops import fused_tp3 as ft

    t_start = time.perf_counter()
    runs = tmp / "runs_no_lm"
    sargs = server_mod.get_parser().parse_args([
        "--port", "0", "--out_dir", str(tmp / "web"), "--model_dir", str(runs / "score"),
        "--confidence_model_dir", str(runs / "confidence")])
    if sargs.compute_dtype != "bfloat16" or sargs.device != "cuda":
        raise PhaseError(f"the server's defaults moved: {sargs}")
    server = server_mod.make_server(sargs)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address[:2]
    url = f"http://{host}:{port}"
    service = server.service

    def post(fields):
        boundary = uuid.uuid4().hex
        body = b"".join(f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
                        for k, v in fields.items()) + f"--{boundary}--\r\n".encode()
        req = urllib.request.Request(url + "/submit", data=body, headers={
            "Content-Type": f"multipart/form-data; boundary={boundary}"})

        class NoRedirect(urllib.request.HTTPRedirectHandler):
            def redirect_request(self, *a, **k):
                return None
        try:
            with urllib.request.build_opener(NoRedirect).open(req, timeout=60) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.read()

    out = {}
    try:
        if b"diffdock-tpu-torch" not in get("/"):
            raise PhaseError("the server's index did not render")
        if post({"protein_path": str(E2E_SYNTH / SERVER_COMPLEXES[0])}) != 400:
            raise PhaseError("a submit without a ligand did not get 400")
        for name in SERVER_COMPLEXES:
            d = E2E_SYNTH / name
            pdb, sdf = d / f"{name}_protein_processed.pdb", d / f"{name}_ligand.sdf"
            known = set(service.jobs)
            ft.counts.reset()
            t0 = time.perf_counter()
            if post({"protein_path": str(pdb), "ligand": str(sdf), "samples": args.poses}) != 303:
                raise PhaseError(f"the submit of {name} was not accepted")
            (job_id,) = set(service.jobs) - known
            while True:
                info = json.loads(get(f"/status/{job_id}"))
                if info["status"] in ("done", "failed") or time.perf_counter() - t0 > 300:
                    break
                time.sleep(0.02)
            wall = time.perf_counter() - t0
            if info["status"] != "done":
                raise PhaseError(f"the server's job for {name} ended {info}")
            launches = ft.counts.as_dict()
            pipe = service.pipeline
            mol, protein = chem.read_molecule_file(str(sdf)), chem.read_pdb_file(str(pdb))
            data, aa, heavy = pipe.featurize(mol, protein)
            expected = mode_launches(pipe, data, aa, args.poses)
            if launches["fused_tp3_bf16"] != expected["fused_tp3_bf16"] or \
                    launches["fused_tp3"] != expected["fused_tp3"] or launches["fused_tp3_reference"]:
                raise PhaseError(f"server dock of {name}: launch counts {launches} != expected {expected}")
            text = get(f"/results/{job_id}/rank1.sdf").decode()
            got = chem.parse_sdf(text)
            if len(got) != 1 or got[0].bonds != heavy.bonds or not np.isfinite(got[0].coords).all():
                raise PhaseError(f"{name}: rank1.sdf does not parse back to the input's bonds")
            bonds = np.array([b[:2] for b in heavy.bonds]).T
            bond_err = _bond_error(bonds, np.asarray(heavy.coords, np.float64),
                                   got[0].coords.astype(np.float64)[None])
            if bond_err > BOND_ATOL:
                raise PhaseError(f"{name}: rank1.sdf bond lengths moved by {bond_err:.2e} A")
            out[name] = {"wall_s": wall, "launches": launches, "expected": expected, "bond_error": bond_err,
                         "confidences": info["confidences"], "score_dtype": pipe.score_cfg.compute_dtype}
            _log(f"  server {name}: submit to done {wall:.3f} s | launches {launches} | bond lengths within "
                 f"{bond_err:.2e} A")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    rc = subprocess.run([sys.executable, "-m", "diffdock_tpu_torch.cli.main", "--help"],
                        capture_output=True, text=True, timeout=120).returncode
    if rc != 0:
        raise PhaseError(f"diffdock-tpu-torch --help returned {rc}")
    walls = [v["wall_s"] for v in out.values()]
    _log(f"[H3 server] {len(out)} requests of {args.poses} poses: first {walls[0]:.2f} s (the pipeline is "
         f"built then), warm {', '.join(f'{w:.2f}' for w in walls[1:])} s | --help rc 0 | {card} | "
         f"{time.perf_counter() - t_start:.1f} s")
    return {"requests": out, "help_rc": rc}


# phase I1: the bfloat16 modes of gens 2 and 1 against their plain
# versions, within BF16_KERNEL_RTOL (both round the CG weights, each step of
# the coupling's chain and P to bfloat16 after float32 sums taken in other
# orders: an element at a tie lands one bfloat16 ulp apart); times are the
# median of I1_LAUNCHES launches timed one by one
I1_LAUNCHES = 11


def cuda_ms_median(fn, n: int, warmup: int = 3) -> float:
    """The median of ``n`` launches of ``fn``, each timed alone with CUDA
    events, after ``warmup`` untimed ones."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def factored_bf16_work(tp, rows: int, K: int, H: int, gen: int):
    """(product FLOPs, CG-weight FLOPs, chain FLOPs, bytes) of a
    bfloat16-mode call of gen 2 or 1: the float32 mode's work (``tp2_work``,
    ``tp1_work``) with its coupling split into the CG weights (bfloat16
    products summed in float32: the tensor cores' type) and the chains
    (rounded after every step: the CUDA cores), every operand read once at
    2 bytes and the float32 output written once."""
    products, coupling, f32_bytes = (tp2_work if gen == 2 else tp1_work)(tp, rows, K, H)
    cg = 2.0 * rows * K * _cg_weight_terms(tp, gen)
    out_bytes = 4.0 * rows * tp.irreps_out.dim
    return products, cg, coupling - cg, (f32_bytes - out_bytes) / 2 + out_bytes


def factored_bf16_kernels(blocks: dict, card: str, dev) -> dict:
    """Phase I1: ``factored_tp2`` and ``factored_tp1`` in bfloat16 at phase
    H1's blocks: each against its own bfloat16 plain version on the card
    (all-bfloat16 operands; gen 1 also with float32 edge_sh, h and mw, the
    mixed case the TPU kernel leaves in float32), a repeat launch with the
    same bits, exact launch counts, and the median time of I1_LAUNCHES
    launches beside the bound (2-byte operands over 3.35 TB/s, or the
    products and the CG weights at the bfloat16 tensor rate plus the
    chains at the float32 rate, the larger), the plain version and the
    cuBLAS bfloat16 einsum
    pair on the coupled operands."""
    import torch

    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2
    from diffdock_tpu_torch.ops import fused_tp3 as ft

    bf16 = torch.bfloat16
    mods = {2: f2, 1: f1}
    out: dict = {"factored_tp2_bf16": {}, "factored_tp1_bf16": {}}
    with torch.inference_mode():
        for i, (label, (tp, rows, K, Hb)) in enumerate(blocks.items()):
            inp = tp_inputs(tp, rows, K, Hb, seed=200 + i, device=dev)
            binp = [a.to(bf16) for a in inp[:4]] + list(inp[4:])
            mixed = [binp[0]] + list(inp[1:])
            # the library pair in bfloat16: h_aug and the coupled columns
            # (built as the model path builds them), the block-diagonal weights
            classes = tp.live_classes()
            h_aug = torch.cat([binp[2], binp[3][..., None]], dim=-1)
            coupled = ft.merged_coupled(tp, binp[0], binp[1])[1]
            t3 = _block_diag_t3(tp, classes, inp[4], inp[5], bf16)
            library_ms = cuda_ms_median(lambda: torch.einsum(
                "rhF,hFW->rW", torch.einsum("rkh,rkF->rhF", h_aug, coupled), t3), I1_LAUNCHES)
            del h_aug, coupled, t3
            for gen, m in mods.items():
                name = f"factored_tp{gen}_bf16"
                wrapper = f2.factored_tp2 if gen == 2 else f1.factored_tp1
                cases = {"bf16": binp} if gen == 2 else {"bf16": binp, "mixed": mixed}
                errs = {}
                for case, a in cases.items():
                    m.counts.reset()
                    f2.counts.reset()
                    got = wrapper(tp, *a)
                    again = wrapper(tp, *a)
                    ref = f2.factored_tp_bf16_reference(tp, *a, gen=gen)
                    torch.cuda.synchronize()
                    counts = {k: v for k, v in m.counts.as_dict().items() if "reference" not in k}
                    want = dict({k: 0 for k in counts}, **{name: 2, "plain": 1})
                    counts["plain"] = f2.counts["factored_tp_reference"]
                    err = (got - ref).abs().max().item()
                    scale = max(ref.abs().max().item(), 1.0)
                    if not (bool(torch.isfinite(got).all()) and err <= BF16_KERNEL_RTOL * scale):
                        raise PhaseError(f"{name} ({case}) disagrees with its plain version at {label}: "
                                         f"{err:.3e} > {BF16_KERNEL_RTOL:.0e} x {scale:.3g}")
                    if not torch.equal(got, again):
                        raise PhaseError(f"{name} ({case}) gave other bits on a second launch at {label}")
                    if counts != want:
                        raise PhaseError(f"{name} ({case}) at {label}: launch counts {counts} != {want}")
                    errs[case] = (err, scale)
                    del got, again, ref
                ops = m.prepare(tp, *binp)
                call = ops[-1]
                plan = f2.bf16_plan(call.slices, rows, K, Hb, call.F, call.J, call.sh_f32,
                                    call.parts,
                                    torch.cuda.get_device_properties(dev).multi_processor_count)
                ms = cuda_ms_median(lambda: m.launch(*ops, tp.irreps_out.dim), I1_LAUNCHES)
                # the whole call: prepare (the [sh | x] rows, the packed
                # weights) and the launch
                wrapper_ms = cuda_ms_median(lambda: wrapper(tp, *binp), I1_LAUNCHES)
                plain_ms = cuda_ms_median(lambda: f2.factored_tp_bf16_reference(tp, *binp, gen=gen),
                                          I1_LAUNCHES)
                products, cg, chains, nbytes = factored_bf16_work(tp, rows, K, Hb, gen)
                t_ops = ((products + cg) / BF16_PEAK_FLOPS + chains / F32_PEAK_FLOPS) * 1e3
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
                err, scale = errs["bf16"]
                out[name][label] = {
                    "rows": rows, "K": K, "H": Hb, "max_abs_err": err, "max_abs_ref": scale,
                    "mixed_max_abs_err": errs.get("mixed", (None,))[0], "repeat_identical": True,
                    "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "bound_share": b_ms / ms, "product_flops": products,
                    "cg_weight_flops": cg, "chain_flops": chains, "bytes": nbytes,
                    "plan": {"slices": len(call.slices), "R": plan.R, "whole": plan.whole,
                             "k_parts": plan.k_parts, "KC": plan.KC, "S": plan.S,
                             "NW": plan.NW, "blocks": plan.n_blocks}}
                mixed_note = (f" | mixed (float32 sh, h, mw) {errs['mixed'][0]:.3e} (tol "
                              f"{BF16_KERNEL_RTOL:.0e} x {errs['mixed'][1]:.3g})" if "mixed" in errs else "")
                _log(f"  {name} {label}: R={rows} K={K} H+1={Hb + 1} max_abs_err={err:.3e} (tol "
                     f"{BF16_KERNEL_RTOL:.0e} x {scale:.3g}){mixed_note}, repeat identical, launches "
                     f"exact | kernel {ms:.4f} ms | whole call {wrapper_ms:.4f} ms | plain "
                     f"{plain_ms:.4f} ms | cuBLAS bf16 pair {library_ms:.4f} ms | bound {b_ms:.4f} ms "
                     f"({b_by}; {products / 1e9:.2f} + {cg / 1e9:.2f} GFLOP at the bf16 rate, "
                     f"{chains / 1e9:.2f} at the f32 rate, "
                     f"{nbytes / 1e6:.1f} MB) | {100 * b_ms / ms:.1f} % of bound | plan "
                     f"{len(call.slices)} slices, R={plan.R} "
                     f"{'all slices' if plan.whole else 'one class'} per block, {plan.k_parts} "
                     f"neighbour part(s), stages of {plan.KC} in {plan.S} slots, N={plan.NW}, "
                     f"{plan.n_blocks} blocks | {card}")
                del ops
            del inp, binp, mixed
    return out


# the heavy sidechain atoms past CB of the amino acids that have them (PDB
# atom names), from which sidechain_pdb draws each residue's
SIDECHAIN_ATOMS = {
    "SER": ("OG",), "CYS": ("SG",), "THR": ("OG1", "CG2"), "VAL": ("CG1", "CG2"),
    "ASP": ("CG", "OD1", "OD2"), "ASN": ("CG", "OD1", "ND2"), "ILE": ("CG1", "CG2", "CD1"),
    "LEU": ("CG", "CD1", "CD2"), "PRO": ("CG", "CD"), "MET": ("CG", "SD", "CE"),
    "GLU": ("CG", "CD", "OE1", "OE2"), "GLN": ("CG", "CD", "OE1", "NE2"),
    "LYS": ("CG", "CD", "CE", "NZ"), "HIS": ("CG", "ND1", "CD2", "CE1", "NE2"),
    "PHE": ("CG", "CD1", "CD2", "CE1", "CE2", "CZ"),
    "TYR": ("CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"),
    "ARG": ("CG", "CD", "NE", "CZ", "NH1", "NH2"),
    "TRP": ("CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"),
}


def sidechain_pdb(text: str, rng) -> str:
    """A receptor PDB with full sidechains, for the PDBSidechain source:
    every residue of ``text`` that has a CB takes a residue name drawn by
    ``rng`` (a numpy RandomState) from SIDECHAIN_ATOMS and that name's heavy
    atoms, a chain grown from CB in 1.5 A steps, each turned toward the mean
    CA of the residue's non-local neighbours (more than 7 apart in sequence)
    within 12 A, with some random spread, so that sidechains reach other
    residues and some reach the 10 contacts a protein needs. The backbone
    and CB stay as they were; residues without a CB keep their name."""
    import numpy as np

    from diffdock_tpu_torch.data.chem import parse_pdb

    protein = parse_pdb(text)
    with_ca = protein.residues_with_ca()
    ca = np.asarray([r.ca for r in with_ca], np.float64)
    idx = np.arange(len(with_ca))
    near = (np.linalg.norm(ca[:, None] - ca[None], axis=-1) < 12.0) & \
        (np.abs(idx[:, None] - idx[None]) > 7)
    order = {id(r): i for i, r in enumerate(with_ca)}
    names = sorted(SIDECHAIN_ATOMS)
    unit = lambda v: v / max(np.linalg.norm(v), 1e-9)  # noqa: E731
    lines, serial = [], 1
    for r in protein.residues:
        atoms = {k: np.asarray(v, np.float64) for k, v in r.atoms.items()}
        elements = dict(r.elements)
        resname = r.name
        if "CB" in atoms and "CA" in atoms:
            resname = names[rng.randint(len(names))]
            i = order[id(r)]
            target = ca[near[i]].mean(0) if near[i].any() else None
            prev, cur = atoms["CA"], atoms["CB"]
            for name in SIDECHAIN_ATOMS[resname]:
                pull = unit(target - cur) if target is not None else 0.0
                nxt = cur + 1.5 * unit(0.5 * unit(cur - prev) + pull + 0.4 * unit(rng.randn(3)))
                atoms[name], elements[name] = nxt, name[0]
                prev, cur = cur, nxt
        for name, xyz in atoms.items():
            el = elements.get(name) or name[0]
            padded = f" {name:<3s}" if len(name) < 4 else name
            lines.append(f"ATOM  {serial:5d} {padded} {resname:>3s} {r.chain}{r.resseq:4d}{r.icode}   "
                         f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}{1.0:6.2f}{0.0:6.2f}          {el:>2s}")
            serial += 1
    return "\n".join(lines) + "\nEND\n"


# phase I2: the train CLI on PDBBind, MOAD and PDBSidechain together. MOAD
# is a layout of three e2e_synth receptors of the (48, 320) bucket, each
# with its ligand and a second pose of it (one cluster each); PDBSidechain
# six e2e_synth receptors given full sidechains by sidechain_pdb
MOAD_COMPLEXES = ("syn101_l34r310", "syn102_l34r320", "syn126_l35r245")
SIDECHAIN_PROTEINS = ("syn002_l30r318", "syn000_l50r368", "syn011_l27r486", "syn014_l27r509",
                      "syn003_l34r594", "syn007_l8r620")
# PDBSidechain's pseudo-complexes carry no ESM features in either package
# (data/pdb_sidechain.py featurizes the receptor with lm=None: width 0), and
# a batch cannot stack them with 1280-wide ones, so phase I trains
# DiffDock-L's widths without the LM input, registered as this preset
COMBINED_PRESET = "diffdock_l_without_lm"
# phase I3: the crop of phase F, on a batch of the stream's first items:
# two of PDBBind, one each of MOAD and PDBSidechain
TRAIN_CROP_BEYOND = 20.0
I3_PER_SOURCE = {"pdbbind": 2, "moad": 1, "pdbsidechain": 1}


def combined_layout(root: Path) -> dict:
    """The MOAD layout and the PDBSidechain directory under ``root``, and
    the PDBBind split of phase E's twelve complexes: the train CLI's data
    flags."""
    import numpy as np

    from diffdock_tpu_torch.data.chem import read_molecule_file, write_pdb_ligand

    moad, pdbs = root / "moad", root / "pdb_sidechain"
    for sub in (moad / "pdb_protein", moad / "pdb_ligand", pdbs):
        sub.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    for name in MOAD_COMPLEXES:
        rec = f"m{name[3:6]}_1"
        (moad / "pdb_protein" / f"{rec}_protein.pdb").write_text(
            (E2E_SYNTH / name / f"{name}_protein_processed.pdb").read_text())
        mol = read_molecule_file(str(E2E_SYNTH / name / f"{name}_ligand.sdf")).remove_hs()
        for i, xyz in enumerate((mol.coords, mol.coords + rng.randn(3))):
            (moad / "pdb_ligand" / f"{rec}_A_{i}.pdb").write_text(
                write_pdb_ligand(mol, np.asarray(xyz, np.float32)))
    for name in SIDECHAIN_PROTEINS:
        text = (E2E_SYNTH / name / f"{name}_protein_processed.pdb").read_text()
        (pdbs / f"sc{name[3:6]}.pdb").write_text(sidechain_pdb(text, rng))
    (root / "train.txt").write_text("\n".join(TRAIN_COMPLEXES) + "\n")
    return {"data_dir": E2E_SYNTH, "split_train": root / "train.txt", "moad_dir": moad,
            "pdbsidechain_dir": pdbs}


def source_of(name: str) -> str:
    """Which source an item of the combined epoch came from, by its name."""
    if name.startswith("syn"):
        return "pdbbind"
    return "pdbsidechain" if "_sc" in name else "moad"


def combined_training_phase(tmp: Path, kernels, card: str, dev) -> dict:
    """Phase I2: ``cli/train.py --triple_training`` at DiffDock-L's widths
    on PDBBind, MOAD and PDBSidechain, batch 4, 2 epochs, each epoch's item
    names, each step's launches and wall recorded; I3: one step from the
    run's saved state with ``crop_beyond`` through the kernels and one
    through the plain versions, on a batch of the combined stream."""
    import numpy as np
    import torch

    from diffdock_tpu_torch.cli import train as train_cli
    from diffdock_tpu_torch.data import loaders
    from diffdock_tpu_torch.data.complexes import bucket_sizes, to_device
    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.models.score_model import CGScoreModel
    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.train import trainer

    t_start = time.perf_counter()
    report: dict = {}
    root = tmp / "combined"
    flags = combined_layout(root)
    log_dir = root / "run"
    tcfg = dataclasses.replace(PRESETS["diffdock_l"], lm_embedding_dim=0)
    epochs, steps, firsts = [], [], {}
    make_step, real_batches = trainer.make_train_step, loaders.iter_bucketed_batches

    def tapped(items):
        # the first items of each source in the run's stream: I3's batch
        for name, data in items:
            taken = firsts.setdefault(source_of(name), [])
            if data is not None and len(taken) < I3_PER_SOURCE[source_of(name)]:
                taken.append((name, data))
            yield name, data

    def recorded_batches(items, batch_size, flush_partial=True):
        epochs.append([])
        for names, batch in real_batches(tapped(items), batch_size, flush_partial):
            epochs[-1].extend(names)
            yield names, batch

    def timed_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def timed(state, batch, draws):
            before = ft.counts.as_dict()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch, draws)
            torch.cuda.synchronize()
            after = ft.counts.as_dict()
            steps.append({"shape": [batch.lig_cat.shape[0], batch.lig_cat.shape[1], batch.rec_cat.shape[1],
                                    batch.rot_u.shape[1]], "wall_s": time.perf_counter() - t0,
                          **{k: after[k] - before[k] for k in after}})
            return out
        return timed

    argv = ["--model_preset", COMBINED_PRESET, "--triple_training",
            "--data_dir", str(flags["data_dir"]), "--split_train", str(flags["split_train"]),
            "--moad_dir", str(flags["moad_dir"]), "--pdbsidechain_dir", str(flags["pdbsidechain_dir"]),
            "--cache_path", str(root / "cache"), "--log_dir", str(log_dir),
            "--batch_size", str(TRAIN_BATCH), "--n_epochs", str(TRAIN_EPOCHS), "--seed", "0",
            "--num_workers", "0", "--device", str(dev)]
    for m in kernels.values():
        m.counts.reset()
    PRESETS[COMBINED_PRESET] = tcfg
    trainer.make_train_step, loaders.iter_bucketed_batches = timed_make_step, recorded_batches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = train_cli.main(argv)
    finally:
        trainer.make_train_step, loaders.iter_bucketed_batches = make_step, real_batches
        del PRESETS[COMBINED_PRESET]
    torch.cuda.synchronize()
    cli_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for m in kernels.values() for k, v in m.counts.as_dict().items()}
    if rc != 0:
        raise PhaseError(f"the train CLI returned {rc} with --triple_training")
    records = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    sources = [sorted({source_of(n) for n in e}) for e in epochs]
    _log(f"  I2 epochs: {[len(e) for e in epochs]} items, sources {sources}; names {epochs}")
    _log(f"  I2 metrics: {records}")
    if len(epochs) != TRAIN_EPOCHS or any(s != ["moad", "pdbbind", "pdbsidechain"] for s in sources):
        raise PhaseError(f"combined epochs drew from {sources}, not all three sources each")
    if [r["phase"] for r in records] != ["train"] * TRAIN_EPOCHS or \
            not all(np.isfinite(r["loss"]) for r in records):
        raise PhaseError(f"combined training records {records}")
    step_bad = [s for s in steps
                if not (s["fused_tp3"] == s["fused_tp3_vjp"] == train_forward_launches(tcfg, s["shape"][3])
                        and s["fused_tp3_reference"] == 0 and s["fused_tp3_bf16"] == 0)]
    if not steps or step_bad or launches["fused_tp3"] != sum(s["fused_tp3"] for s in steps) or \
            launches["fused_tp3_vjp"] != launches["fused_tp3"] or \
            any(v for k, v in launches.items() if k not in ("fused_tp3", "fused_tp3_vjp")):
        raise PhaseError(f"combined training launch counts: steps {steps}, run {launches}")
    walls = [s["wall_s"] for s in steps[2:]]
    if len(walls) < 5:
        raise PhaseError(f"combined training took {len(steps)} steps, fewer than 2 + 5")
    med = float(np.median(walls))
    report["cli"] = {"rc": rc, "wall_s": cli_wall, "epochs": epochs, "metrics": records, "steps": steps,
                     "launches": launches, "step_median_s": med, "step_min_s": min(walls),
                     "step_max_s": max(walls), "peak_bytes": peak}
    _log(f"  I2 {len(steps)} steps {[s['shape'] for s in steps]}: per step fused_tp3 "
         f"{[s['fused_tp3'] for s in steps]} = VJP, 0 plain | walls after 2: median {med:.4f} s, min "
         f"{min(walls):.4f}, max {max(walls):.4f} (by shape, batches of 1-{TRAIN_BATCH})")
    _log(f"[I2 combined training] diffdock_l widths without LM, --triple_training, "
         f"{sum(len(e) for e in epochs)} items in {TRAIN_EPOCHS} epochs | wall {cli_wall:.2f} s | peak "
         f"{peak / 2**30:.2f} GiB | {card}")

    # I3: the crop under training, kernels vs plain versions from I2's
    # state, on the stream's first items of each source stacked at the
    # bucket that holds them all (the sources' own buckets differ)
    t0 = time.perf_counter()
    members = [it for src in ("pdbbind", "moad", "pdbsidechain") for it in firsts.get(src, [])]
    buckets = [bucket_sizes(d.n_lig, d.n_rec, d.n_bonds) for _, d in members]
    names, batch = loaders.stack_batch(members, tuple(max(b[i] for b in buckets) for i in range(3)))
    ccfg = dataclasses.replace(trainer.training_model_config(tcfg), crop_beyond=TRAIN_CROP_BEYOND)
    so3, torus = get_so3_tables(device=dev), get_torus_tables(device=dev)
    tc = trainer.TrainConfig()
    tb = to_device(batch, dev)
    keeps: dict = {}
    real_keep = trainer.train_rec_keep

    def recorded_keep(cfg_, batch_, sample):
        keep = real_keep(cfg_, batch_, sample)
        keeps[route] = keep.clone()
        return keep

    trainer.train_rec_keep = recorded_keep
    try:
        runs = {}
        for route, model in (("plain", CGScoreModel(ccfg, reference_kernels=True)), ("kernel", CGScoreModel(ccfg))):
            runs[route] = twin_step(model.to(dev), route, tc, log_dir, tb, TWIN_SEEDS[0], so3, torus, dev,
                                    pin=runs["plain"]["acts"] if runs else None)
            km = model
    finally:
        trainer.train_rec_keep = real_keep
    n_fwd = train_forward_launches(ccfg, tb.rot_u.shape[1])
    kcounts, pcounts = runs["kernel"]["counts"], runs["plain"]["counts"]
    if kcounts != {"fused_tp3": n_fwd, "fused_tp3_bf16": 0, "fused_tp3_reference": 0, "fused_tp3_vjp": n_fwd} or \
            pcounts != {"fused_tp3": 0, "fused_tp3_bf16": 0, "fused_tp3_reference": n_fwd, "fused_tp3_vjp": 0}:
        raise PhaseError(f"cropped twin step counts: kernel {kcounts}, plain {pcounts}")
    if not torch.equal(keeps["kernel"], keeps["plain"]):
        raise PhaseError("the cropped twin steps took different receptor crops")
    real = tb.rec_mask.sum(dim=1).float()
    share = (keeps["kernel"].sum(dim=1).float() / real).tolist()
    twin = compare_twins(km, runs["plain"], runs["kernel"], tc.lr)
    sw = twin["relu_switched"]
    report["crop_twin"] = {"names": names, "shape": list(batch.lig_cat.shape[:2]) + [batch.rec_cat.shape[1]],
                           "crop_beyond": TRAIN_CROP_BEYOND, "kept_share": share, "twin": twin,
                           "loss_plain": runs["plain"]["metrics"]["loss"], "s": time.perf_counter() - t0}
    _log(f"  I3 crop {TRAIN_CROP_BEYOND} A on {names} ({[source_of(n) for n in names]}): receptor rows kept "
         f"{', '.join(f'{100 * v:.1f} %' for v in share)}; the routes' masks equal | loss {twin['loss']:.6f} vs "
         f"{runs['plain']['metrics']['loss']:.6f} (worst metric {twin['metric_rel_err']:.3e}) | worst gradient "
         f"leaf {twin['grad_worst_leaf']} {twin['grad_norm_rel_err']:.3e}, all leaves {twin['grad_all_rel_err']:.3e} "
         f"| params {twin['param_solid_err_lr']:.3e} lr where solid, {twin['param_err_lr']:.3e} lr anywhere | "
         f"batch stats {twin['batch_stat_rel_err']:.3e} | ReLU units switched and pinned {sw['total']}, the "
         f"largest {sw['largest_share']:.2e} of its layer's | outside E3's "
         f"limits: {', '.join(twin['outside']) or 'none'}")
    if not twin["ok"]:
        raise PhaseError(f"the cropped kernel step disagrees with the plain one: {twin['outside']}")
    _log(f"[I3 crop twin step] {time.perf_counter() - t0:.1f} s")
    _log(f"[I2-I3 combined] {card} | {time.perf_counter() - t_start:.1f} s")
    return report


# phase J: the DiffDock v1.0 score model (the ICLR'23 paper's, the v1.0
# release's workdir/paper_score_model: its training command sets ns 48, nv
# 10, 6 conv layers, 64-wide sigma, distance and cross-distance embeddings,
# ESM2 input, the dynamic cross cutoff, tr_sigma_max 19, rot_sigma_min 0.03
# and rot_sigma_max 1.55; spherical harmonics to l = 2 and no second-order
# irreps are the v1.0 code's; sinusoidal embedding at scale 1000 is its
# parser's default). fixed_center_conv is False: the JAX package's importer
# gives that to a v1.0 args dump, which has no not_fixed_center_conv
V1_SCORE = dict(ns=48, nv=10, num_conv_layers=6, num_prot_emb_layers=0, sh_lmax=2,
                use_second_order_repr=False, reduce_pseudoscalars=False, embed_also_ligand=False,
                sigma_embed_dim=64, distance_embed_dim=64, cross_distance_embed_dim=64,
                lm_embedding_dim=1280, dynamic_max_cross=True, cross_max_distance=80.0,
                embedding_type="sinusoidal", embedding_scale=1000.0, fixed_center_conv=False,
                old_architecture=True)
V1_SIGMA = dict(tr_sigma_max=19.0, rot_sigma_min=0.03, rot_sigma_max=1.55)
V1_TIMED_DOCKS = 3
V1_CLI_STEPS = 2
# phase J5's variants of DiffDock-L: each forward on the card against the
# same forward on the CPU (float32, TF32 off) within KERNEL_RTOL of scale
V1_VARIANTS = {"factored_tp=False": dict(factored_tp=False),
               "depthwise_convolution": dict(depthwise_convolution=True),
               "sidechain_pred": dict(sidechain_pred=True)}


def v1_config():
    """The DiffDock v1.0 score model's config (V1_SCORE)."""
    from diffdock_tpu_torch.diffusion.schedules import SigmaConfig
    from diffdock_tpu_torch.models.config import ScoreModelConfig

    return ScoreModelConfig(**V1_SCORE, sigma=SigmaConfig(**V1_SIGMA))


def model_tps():
    """Every merged TP contraction of the benchmark's models, once per
    irreps and hidden width: [(where it is built, (irreps_in1, irreps_in2,
    irreps_out, H))], DiffDock-L's and v1.0's score models and the all-atom
    confidence model (SHIPPED_CONFIDENCE), built on the CPU."""
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.models.factory import build_model
    from diffdock_tpu_torch.models.old_models import build_confidence_model
    from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct

    cfgs = {"diffdock_l": (build_model, PRESETS["diffdock_l"]),
            "diffdock_v1": (build_model, v1_config()),
            "confidence": (build_confidence_model,
                           dataclasses.replace(PRESETS["diffdock_s"], **SHIPPED_CONFIDENCE))}
    seen = {}
    for name, (builder, cfg) in cfgs.items():
        for mod_name, mod in builder(cfg).named_modules():
            tp = getattr(mod, "tp", None)
            if isinstance(tp, FullyConnectedTensorProduct) and getattr(mod, "merged", False):
                key = (str(tp.irreps_in1), str(tp.irreps_in2), str(tp.irreps_out),
                       mod._fc_args["hidden_dim"])
                seen.setdefault(key, f"{name}.{mod_name}")
    return sorted((where, key) for key, where in seen.items())


def v1_blocks(model, cfg, data, P: int, bucket) -> dict:
    """The v1.0 score model's merged contractions at a padded bucket for P
    poses in flight: label -> (tp, rows, K, H). The convs are the widest
    layers' (the receptor receivers' last is layer L-2); from layer 1 on the
    receptor carries a pose axis."""
    nl, nr, nb = bucket
    H, L = 3 * cfg.ns, cfg.num_conv_layers
    return {
        f"lig bonded (lig_conv_{L - 1})": (model.lig_conv_layers[-1].tp, P * nl, data.lig_bond_nbr.shape[1], H),
        f"lig radius (lig_conv_{L - 1})": (model.lig_conv_layers[-1].tp, P * nl, nl, H),
        f"rec<-rec (rec_conv_{L - 2})": (model.rec_conv_layers[-1].tp, P * nr, data.rec_nbr.shape[1], H),
        f"lig<-rec (rec_to_lig_conv_{L - 1})": (model.rec_to_lig_conv_layers[-1].tp, P * nl, nr, H),
        f"rec<-lig (lig_to_rec_conv_{L - 2})": (model.lig_to_rec_conv_layers[-1].tp, P * nr, nl, H),
        "final_conv": (model.final_conv.tp, P, nl, 2 * cfg.ns),
        "tor_bond_conv": (model.tor_bond_conv.tp, P * nb, nl, H),
    }


def v1_phase(args, tmp: Path, ccfg, data, aa, noise, so3, torus, card: str, dev) -> dict:
    """Phase J: the DiffDock v1.0 score model at its published width on
    phase 4's complex, ranked by the shipped confidence model. J1 fused_tp3
    in both modes against its plain version at the model's blocks; J2 a
    bfloat16 dock (the JAX dock's default) with exact launch counts and its
    plain twin; J3 warm walls (bfloat16 and float32) and memory; J4 the dock
    CLI with --old_score_model on a reference-format directory; J5 one
    forward each of DiffDock-L's per-edge, depthwise and sidechain variants
    on the card against the CPU."""
    import contextlib
    import copy
    import io

    import numpy as np
    import torch

    from diffdock_tpu_torch.cli import dock as cli
    from diffdock_tpu_torch.data import chem
    from diffdock_tpu_torch.data.complexes import pad_to, to_device
    from diffdock_tpu_torch.data.inference_dataset import InferenceDatasetBuilder, InferenceSpec
    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.models.factory import build_model
    from diffdock_tpu_torch.models.old_models import build_confidence_model
    from diffdock_tpu_torch.models.score_model import CGScoreModel
    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.utils import simple_yaml
    from diffdock_tpu_torch.utils.download import DEFAULT_CKPT

    t_start = time.perf_counter()
    bf16 = torch.bfloat16
    report: dict = {}
    cfg = v1_config()
    bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    P = args.poses
    sampler = SamplerConfig()  # 20-step schedule, 19 steps, as phase 4
    models = dict(confidence_cfg=ccfg, confidence_weights=1)
    pipe = DockingPipeline(bcfg, 0, sampler, so3, torus, device=dev, **models)
    bucket = pipe.dock_bucket(data)[0]

    # J1: both modes against the plain version at the v1.0 blocks
    t0 = time.perf_counter()
    blocks = v1_blocks(pipe.model, cfg, data, P, bucket)
    checks = check_blocks(["fused_tp3"], blocks, dev, tag=" [v1.0]")["fused_tp3"]
    j1 = {}
    with torch.inference_mode():
        for i, (label, (tp, rows, K, Hb)) in enumerate(blocks.items()):
            inp = tp_inputs(tp, rows, K, Hb, seed=i, device=dev)
            row = dict(checks[label], ms=cuda_ms(lambda: ft.forward_f32(tp, *inp), args.iters),
                       plain_ms=cuda_ms(lambda: ft.fused_tp3_reference(tp, *inp), args.iters))
            if label not in ("final_conv", "tor_bond_conv"):  # float32 in the model, as in JAX
                binp = [a.to(bf16) for a in inp[:4]] + list(inp[4:])
                got = ft.fused_tp3(tp, *binp)
                ref = ft.fused_tp3_reference(tp, *binp)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                scale = max(ref.abs().max().item(), 1.0)
                if not (bool(torch.isfinite(got).all()) and err <= BF16_KERNEL_RTOL * scale):
                    raise PhaseError(f"fused_tp3_bf16 disagrees with its plain version at {label} [v1.0]: "
                                     f"{err:.3e} > {BF16_KERNEL_RTOL:.0e} x {scale:.3g}")
                ops = ft.prepare(tp, *binp)
                row.update(bf16_max_abs_err=err, bf16_max_abs_ref=scale,
                           bf16_ms=cuda_ms(lambda: ft.launch(*ops[1:]), args.iters),
                           bf16_plain_ms=cuda_ms(lambda: ft.fused_tp3_reference(tp, *binp), args.iters))
                del binp, got, ref, ops
            j1[label] = row
            _log(f"  v1.0 {label}: R={rows} K={K} H+1={Hb + 1} | float32 kernel {row['ms']:.4f} ms, plain "
                 f"{row['plain_ms']:.4f} ms" + (f" | bf16 err {row['bf16_max_abs_err']:.3e} (tol "
                                                 f"{BF16_KERNEL_RTOL:.0e} x {row['bf16_max_abs_ref']:.3g}), kernel "
                                                 f"{row['bf16_ms']:.4f} ms, plain {row['bf16_plain_ms']:.4f} ms"
                                                 if "bf16_ms" in row else ""))
            del inp
    report["kernel"] = j1
    _log(f"[J1 v1.0 blocks] fused_tp3 float32 at {len(blocks)} blocks, bf16 at "
         f"{sum('bf16_ms' in r for r in j1.values())} | {card} | {time.perf_counter() - t0:.1f} s")

    # J2: the bfloat16 dock with ranking, from phase 4's draws
    t0 = time.perf_counter()
    pipe.dock_complex(data, num_poses=P, seed=1, aa_data=aa)  # pays the first-call costs
    expected = mode_launches(pipe, data, aa, P)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft.counts.reset()
    t1 = time.perf_counter()
    res = pipe.dock_complex(data, num_poses=P, seed=0, noise=noise, aa_data=aa, return_trajectory=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = ft.counts.as_dict()
    peak = torch.cuda.max_memory_allocated()
    _log(f"  launches {launches} (expected {expected}: the v1.0 convs in bf16, the receptor embedded at "
         f"every step; final_conv, tor_bond_conv and the confidence model in float32)")
    if launches["fused_tp3_bf16"] != expected["fused_tp3_bf16"] or \
            launches["fused_tp3"] != expected["fused_tp3"] or launches["fused_tp3_reference"]:
        raise PhaseError(f"v1.0 dock launch counts {launches} != expected {expected}, 0 plain")
    if res.poses.shape != (P, data.n_lig, 3) or not np.isfinite(res.poses).all() or \
            not np.isfinite(res.confidence).all():
        raise PhaseError("the v1.0 dock gave non-finite poses or confidences")
    nbr, mask = np.asarray(data.lig_bond_nbr), np.asarray(data.lig_bond_mask)
    bi, bk = np.nonzero(mask)
    start = np.asarray(data.lig_pos, np.float64)[: data.n_lig]
    bond_err = _bond_error((bi, nbr[bi, bk]), start, res.poses.astype(np.float64))
    if bond_err > BOND_ATOL:
        raise PhaseError(f"v1.0 dock: bond lengths moved by {bond_err:.2e} A (tol {BOND_ATOL:.0e})")
    _log(f"[J2 v1.0 dock] bf16, {P} poses, {sampler.num_steps} steps, ranked | {wall:.2f} s | peak "
         f"{peak / 2**30:.2f} GiB | bond lengths within {bond_err:.2e} A | {card}")

    # the same dock through the plain versions, and nudged
    ref_pipe = DockingPipeline(bcfg, 0, sampler, so3, torus, device=dev, reference_kernels=True, **models)
    ref_res = ref_pipe.dock_complex(data, num_poses=P, seed=0, noise=noise, aa_data=aa, return_trajectory=True)
    init, steps = noise(P, 0, 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    e = torch.randn(init.tr.shape, generator=gen, device=dev)
    nudged = (init._replace(tr=init.tr * (1 + BF16_NUDGE * e)), steps)
    nudge_res = pipe.dock_complex(data, num_poses=P, seed=0, noise=lambda *a: nudged, aa_data=aa,
                                  return_trajectory=True)
    torch.cuda.synchronize()
    step_gap = [float(np.abs(res.trajectory[k] - ref_res.trajectory[k]).max())
                for k in range(res.trajectory.shape[0])]
    nudge_gap = [float(np.abs(res.trajectory[k] - nudge_res.trajectory[k]).max())
                 for k in range(res.trajectory.shape[0])]
    _log(f"  max |poses(kernel) - poses(plain)| by step: {' '.join(f'{g:.1e}' for g in step_gap)}")
    _log(f"  max |poses(kernel) - poses(kernel, start nudged by {BF16_NUDGE:.1e})| by step: "
         f"{' '.join(f'{g:.1e}' for g in nudge_gap)}")
    # the first step's scores from the same start poses, kernel model against
    # plain model: the step moves the poses by tens of A at t = 1, so a 1e-3
    # relative score gap already parts the twins by 0.1 A there
    nl = bucket[0]
    start_poses = torch.as_tensor(res.trajectory[0] - np.asarray(data.original_center)[None, None],
                                  dtype=torch.float32, device=dev)
    start_poses = _pad_rows(start_poses.transpose(0, 1), nl - data.n_lig).transpose(0, 1)
    padded = to_device(pad_to(data, *bucket), dev)
    t1 = torch.tensor(float(sampler.schedule()[0]), device=dev)
    with torch.inference_mode():
        s_kernel = pipe.model(padded, start_poses, t1, so3, torus)
        s_plain = ref_pipe.model(padded, start_poses, t1, so3, torus)
    first_scores = {}
    for field in ("tr", "rot", "tor"):
        a, b = getattr(s_kernel, field), getattr(s_plain, field)
        scale = max(b.abs().max().item(), 1.0)
        first_scores[field] = (a - b).abs().max().item() / scale
    _log(f"  first-step scores, kernel model vs plain model from the same poses: largest error over scale "
         f"{' '.join(f'{k} {v:.2e}' for k, v in first_scores.items())} (tol {BF16_MODEL_RTOL:.0e})")
    if step_gap[0] != 0.0 or not all(v <= BF16_MODEL_RTOL for v in first_scores.values()):
        raise PhaseError(f"v1.0 kernel and plain score models disagree at the first step: {first_scores}")
    conf_scale = max(float(np.abs(ref_res.confidence).max()), 1.0)
    conf_nudge = float(np.abs(res.confidence - nudge_res.confidence).max())
    plain = docks_agree(res, ref_res, pose_tol=max(POSE_ATOL, 2 * nudge_gap[-1]),
                        conf_tol=max(CONF_RTOL * conf_scale, 2 * conf_nudge))
    report["dock"] = {"wall_s": wall, "max_memory_allocated": peak, "launches": launches, "expected": expected,
                      "bond_error": bond_err, "confidence": res.confidence.tolist(), "order": res.order.tolist(),
                      "plain": dict(plain, step_gap=step_gap, nudge_gap=nudge_gap, conf_nudge=conf_nudge,
                                    first_step_scores=first_scores),
                      "s": time.perf_counter() - t0}
    del ref_pipe

    # J3: warm walls, bfloat16 and float32
    t0 = time.perf_counter()
    walls = []
    for _ in range(V1_TIMED_DOCKS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pipe.dock_complex(data, num_poses=P, seed=0, noise=noise, aa_data=aa)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    fpipe = DockingPipeline(cfg, 0, sampler, so3, torus, device=dev, **models)
    f_expected = mode_launches(fpipe, data, aa, P)
    fpipe.dock_complex(data, num_poses=P, seed=1, aa_data=aa)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft.counts.reset()
    t1 = time.perf_counter()
    fres = fpipe.dock_complex(data, num_poses=P, seed=0, noise=noise, aa_data=aa)
    torch.cuda.synchronize()
    f_wall = time.perf_counter() - t1
    f_launches, f_peak = ft.counts.as_dict(), torch.cuda.max_memory_allocated()
    if f_launches["fused_tp3"] != f_expected["fused_tp3"] or f_launches["fused_tp3_bf16"] or \
            f_launches["fused_tp3_reference"] or not np.isfinite(fres.poses).all():
        raise PhaseError(f"v1.0 float32 dock: launches {f_launches} != expected {f_expected}, or poses not finite")
    med = float(np.median(walls))
    rmsd_f32 = np.sqrt(((res.poses - fres.poses) ** 2).sum(-1).mean(-1))
    report["walls"] = {"bf16_wall_s": walls, "bf16_median_s": med, "bf16_poses_per_s": P / med,
                       "f32_wall_s": f_wall, "f32_poses_per_s": P / f_wall, "f32_launches": f_launches,
                       "f32_max_memory_allocated": f_peak, "rmsd_bf16_to_f32": rmsd_f32.tolist()}
    _log(f"[J3 v1.0 walls] bf16: median {med:.4f} s of {V1_TIMED_DOCKS} (min {min(walls):.4f}, max "
         f"{max(walls):.4f}; {P / med:.3f} poses/s), {sum(launches.values())} launches per dock, peak "
         f"{peak / 2**30:.2f} GiB | float32: {f_wall:.4f} s ({P / f_wall:.3f} poses/s), {f_launches['fused_tp3']} "
         f"launches, peak {f_peak / 2**30:.2f} GiB | per-pose RMSD bf16 to float32 (no gate) "
         f"{' '.join(f'{r:.2f}' for r in rmsd_f32)} A | {card} | {time.perf_counter() - t0:.1f} s")
    del pipe, fpipe

    # J4: the dock CLI with --old_score_model on reference-format directories
    # (no LM input: the CLI featurizes without ESM embeddings)
    t0 = time.perf_counter()
    root = tmp / "v1_reference"
    dirs = {}
    for name, c, build, seed in (("score", dataclasses.replace(cfg, lm_embedding_dim=0), build_model, 0),
                                 ("confidence", dataclasses.replace(ccfg, lm_embedding_dim=0),
                                  build_confidence_model, 1)):
        model = build(c)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        d = root / name
        d.mkdir(parents=True)
        torch.save(reference_state_dict(model), d / DEFAULT_CKPT)
        (d / "model_parameters.yml").write_text(simple_yaml.dump(reference_args(c)))
        dirs[name] = str(d)
        del model
    name = CLI_COMPLEXES[0]
    cd = E2E_SYNTH / name
    pdb, sdf = cd / f"{name}_protein_processed.pdb", cd / f"{name}_ligand.sdf"
    argv = ["--model_dir", dirs["score"], "--confidence_model_dir", dirs["confidence"], "--old_score_model",
            "--inference_steps", str(V1_CLI_STEPS), "--actual_steps", str(V1_CLI_STEPS), "--device", "cuda"]
    epipe = cli.load_pipeline(cli.get_parser().parse_args(argv))
    if not (epipe.score_cfg.old_architecture and epipe.score_cfg.compute_dtype == "bfloat16"):
        raise PhaseError(f"the CLI's score config is {epipe.score_cfg}")
    mol, protein, _ = InferenceDatasetBuilder().load(InferenceSpec(name, str(pdb), ligand_description=str(sdf)))
    cli_expected = mode_launches(epipe, *epipe.featurize(mol, protein)[:2], P)
    del epipe
    out = tmp / "v1_cli"
    buf = io.StringIO()
    ft.counts.reset()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv + ["--protein_path", str(pdb), "--ligand", str(sdf), "--complex_name", name,
                              "--out_dir", str(out), "--samples_per_complex", str(P)])
    cli_wall = time.perf_counter() - t1
    cli_launches = ft.counts.as_dict()
    for line in buf.getvalue().splitlines():
        _log(f"  cli: {line}")
    rank1 = out / name / "rank1.sdf"
    coords = np.asarray(chem.parse_sdf(rank1.read_text())[0].coords) if rank1.exists() else None
    if rc != 0 or coords is None or not np.isfinite(coords).all():
        raise PhaseError(f"the v1.0 CLI dock returned {rc}; rank1.sdf {'finite' if coords is not None else 'missing'}")
    if cli_launches["fused_tp3_bf16"] != cli_expected["fused_tp3_bf16"] or \
            cli_launches["fused_tp3"] != cli_expected["fused_tp3"] or cli_launches["fused_tp3_reference"]:
        raise PhaseError(f"v1.0 CLI launch counts {cli_launches} != expected {cli_expected}, 0 plain")
    report["cli"] = {"rc": rc, "wall_s": cli_wall, "launches": cli_launches, "expected": cli_expected,
                     "complex": name}
    _log(f"[J4 v1.0 CLI] --old_score_model on reference directories, {name}, {V1_CLI_STEPS} steps, bf16 | rc {rc} "
         f"| launches {cli_launches} (expected {cli_expected}) | {cli_wall:.2f} s | {card} | "
         f"{time.perf_counter() - t0:.1f} s")

    # J5: DiffDock-L's variants, one pose, on the card and on the CPU
    t0 = time.perf_counter()
    nl, nr, nb = bucket
    padded = pad_to(data, nl, nr, nb)
    pose = torch.as_tensor(np.asarray(padded.lig_pos)[None], dtype=torch.float32)
    cpu_tables = (get_so3_tables(device="cpu"), get_torus_tables(device="cpu"))
    j5 = {}
    for label, kw in V1_VARIANTS.items():
        c = dataclasses.replace(PRESETS["diffdock_l"], **kw)
        model = CGScoreModel(c)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.eval()
        cpu_model = copy.deepcopy(model)
        model.to(dev)
        ft.counts.reset()
        with torch.inference_mode():
            got = model(to_device(padded, dev), pose.to(dev), torch.tensor(0.5, device=dev), so3, torus)
            torch.cuda.synchronize()
            counts = ft.counts.as_dict()
            ref = cpu_model(to_device(padded, "cpu"), pose, torch.tensor(0.5), *cpu_tables)
        errs = {}
        for field in ("tr", "rot", "tor", "sidechain"):
            a, b = getattr(got, field), getattr(ref, field)
            if a is None or b is None:
                if (a is None) != (b is None):
                    raise PhaseError(f"DiffDock-L {label}: {field} on one device only")
                continue
            a = a.cpu()
            scale = max(b.abs().max().item(), 1.0)
            err = (a - b).abs().max().item()
            errs[field] = err / scale
            if not (bool(torch.isfinite(a).all()) and err <= KERNEL_RTOL * scale):
                raise PhaseError(f"DiffDock-L {label}: {field} on the card differs from the CPU by {err:.3e} "
                                 f"(tol {KERNEL_RTOL:.0e} x {scale:.3g})")
        if ("sidechain" in errs) != (label == "sidechain_pred"):
            raise PhaseError(f"DiffDock-L {label}: sidechain output {'missing' if label == 'sidechain_pred' else 'present'}")
        j5[label] = {"err_over_scale": errs, "launches": counts}
        _log(f"  DiffDock-L {label}: card vs CPU, largest error over scale "
             f"{' '.join(f'{k} {v:.2e}' for k, v in errs.items())} (tol {KERNEL_RTOL:.0e}) | launches {counts}")
        del model, cpu_model, got, ref
    report["variants"] = j5
    _log(f"[J5 variants] {len(j5)} forwards on the card vs the CPU | {time.perf_counter() - t0:.1f} s")
    report["s"] = time.perf_counter() - t_start
    _log(f"[J v1.0] {card} | phase {report['s']:.1f} s")
    return report


# phase K: protein inputs. K1 ESM2-650M (models/esm2.py at ESM2Config()'s
# published size: 33 layers, width 1280, 20 heads, FFN 5120, 650 M
# parameters) with random weights drawn once on the host from a seeded
# generator and copied to the card, so that the CPU twin holds the same
# weights; it embeds ESM_COMPLEXES (368 residues, a 384-token bucket; 1547
# residues, 1664 tokens) on the card in float32 with TF32 off (the forward
# turns it off for itself, whatever the process's setting), each within
# ESM_RTOL of scale of the same embed on the CPU: both sum in float32 in
# different orders through 33 layers
ESM_COMPLEXES = ("syn000_l50r368", "syn045_l8r1547")
ESM_RTOL = 1e-4
ESM_TIMED = 3
# K2's npz for make_embedder: a two-layer model at the published width
ESM_NPZ_LAYERS = 2
# K4: the first prewarm over the cover ladder, the second on one bucket
PREWARM_ARGS = ["--inference_steps", "2", "--actual_steps", "1", "--confidence_preset", "diffdock_s"]
PREWARM_AGAIN = ["--no_cover_ladder", "--bucket", "32,320,8,10"]


def esm2_flops(cfg, tokens: int) -> float:
    """FLOPs of one ESM2 forward over ``tokens`` (padded) tokens: the six
    projections and the two attention products of every layer."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    return cfg.num_layers * (2.0 * tokens * (4 * h * h + 2 * h * f) + 4.0 * tokens * tokens * h)


def device_launches(fn) -> tuple:
    """(kernel launches, device ms) of one call of ``fn`` on the card,
    from torch.profiler's device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if getattr(e, "device_type", None) == DeviceType.CUDA]
    return sum(e.count for e in events), sum(_device_us(e) for e in events) / 1e3


def esm_phase(args, tmp: Path, ccfg, so3, torus, kernels, card: str, dev) -> dict:
    """Phase K: the ESM2 language model on the card feeding the dock. K1
    ESM2-650M against its CPU twin on two receptors, timed; K2 make_embedder
    from an npz, then DiffDock-L in bfloat16 on a receptor embedded live by
    the 650M model through InferenceDatasetBuilder(esm_embedder=...) and
    dock_mol_protein, ranked by the shipped confidence model, with exact
    counts, held to the same dock from a LazyNpyTable and to one with zeroed
    embeddings; K3 esm-prep fasta and convert; K4 prewarm twice."""
    import contextlib
    import io

    import numpy as np
    import torch

    from diffdock_tpu_torch.cli import main as cli_main
    from diffdock_tpu_torch.data import chem
    from diffdock_tpu_torch.data.esm import ESM_LAYER, LazyNpyTable, make_embedder
    from diffdock_tpu_torch.data.inference_dataset import InferenceDatasetBuilder, InferenceSpec
    from diffdock_tpu_torch.inference.ladder import COVER_LADDER
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.models.esm2 import ESM2, ESM2Config, TorchESM2Embedder, module_params, save_params

    t_start = time.perf_counter()
    report: dict = {}

    # K1: ESM2-650M on the card and on the CPU
    t0 = time.perf_counter()
    cfg = ESM2Config()
    with torch.device("meta"):  # no default init: reset_parameters draws every weight
        cpu_model, card_model = ESM2(cfg), ESM2(cfg)
    cpu_model = cpu_model.to_empty(device="cpu")
    cpu_model.reset_parameters(torch.Generator().manual_seed(0))
    cpu_model.eval()
    n_params = sum(p.numel() for p in cpu_model.parameters())
    card_model = card_model.to_empty(device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    embedder, cpu_embedder = TorchESM2Embedder(card_model), TorchESM2Embedder(cpu_model)
    torch.cuda.synchronize()
    weights_s = time.perf_counter() - t0
    tf32_before = torch.backends.cuda.matmul.allow_tf32
    proteins, embeddings, k1 = {}, {}, {}
    for name in ESM_COMPLEXES:
        proteins[name] = chem.read_pdb_file(str(E2E_SYNTH / name / f"{name}_protein_processed.pdb"))
        n_res = len(proteins[name].residues_with_ca())
        tokens = -(-(n_res + 2) // embedder.quantum) * embedder.quantum
        embedder.embed_protein(proteins[name])  # the first call at this shape
        walls = []
        for _ in range(ESM_TIMED):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = embedder.embed_protein(proteins[name])  # ends on the host
            walls.append(time.perf_counter() - t1)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        embedder.embed_protein(proteins[name])
        peak = torch.cuda.max_memory_allocated()
        launches, device_ms = device_launches(lambda: embedder.embed_protein(proteins[name]))
        t1 = time.perf_counter()
        ref = cpu_embedder.embed_protein(proteins[name])
        cpu_s = time.perf_counter() - t1
        err = float(np.abs(out - ref).max())
        scale = max(float(np.abs(ref).max()), 1.0)
        if out.shape != (n_res, cfg.hidden_size) or not np.isfinite(out).all() or err > ESM_RTOL * scale:
            raise PhaseError(f"ESM2-650M on {name}: shape {out.shape}, card vs CPU {err:.3e} (tol {ESM_RTOL:.0e} x "
                             f"{scale:.3g})")
        med = float(np.median(walls))
        flops = esm2_flops(cfg, tokens)
        bound = flops / F32_PEAK_FLOPS * 1e3
        k1[name] = {"residues": n_res, "tokens": tokens, "wall_s": walls, "median_s": med,
                    "kernel_launches": launches, "device_ms": device_ms, "device_busy_share": device_ms / 1e3 / med,
                    "max_memory_allocated": peak, "peak_above_weights": peak - base, "max_abs_err": err,
                    "max_abs_ref": scale, "cpu_s": cpu_s, "flops": flops, "tflops_per_s": flops / med / 1e12,
                    "bound_f32_ms": bound}
        embeddings[name] = out
        _log(f"  ESM2-650M {name}: {n_res} residues ({tokens} tokens) | card vs CPU {err:.3e} (tol {ESM_RTOL:.0e} x "
             f"{scale:.3g}) | median {med * 1e3:.1f} ms of {ESM_TIMED} (min {min(walls) * 1e3:.1f}, max "
             f"{max(walls) * 1e3:.1f}) | {launches} kernel launches, device {device_ms:.1f} ms "
             f"({100 * device_ms / 1e3 / med:.1f} % busy) | peak {peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} "
             f"above the weights) | {flops / 1e12:.2f} TFLOP, {flops / med / 1e12:.1f} TFLOP/s (float32 bound "
             f"{bound:.1f} ms) | CPU {cpu_s:.1f} s")
    # the same bits with the process's TF32 turned on: the forward sets its own
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_out = embedder.embed_protein(proteins[ESM_COMPLEXES[0]])
        tf32_kept = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_before
    if not (tf32_kept and np.array_equal(tf32_out, embeddings[ESM_COMPLEXES[0]])):
        raise PhaseError("ESM2's output depends on the process's TF32 setting, or the forward did not restore it")
    report["esm2"] = {"params": n_params, "weights_s": weights_s, "process_tf32": tf32_before,
                      "forward_tf32": False, "complexes": k1}
    _log(f"[K1 ESM2-650M] {n_params / 1e6:.1f} M parameters (drawn and copied in {weights_s:.1f} s), float32 with TF32 "
         f"off (process setting {tf32_before}; the same bits with it on) | {card} | {time.perf_counter() - t0:.1f} s")
    del cpu_embedder, cpu_model

    # K2: make_embedder from an npz, then the slice's path on one complex
    t0 = time.perf_counter()
    small = ESM2(ESM2Config(num_layers=ESM_NPZ_LAYERS))
    small.reset_parameters(torch.Generator().manual_seed(2))
    npz = tmp / "esm2_small.npz"
    save_params(module_params(small), str(npz), num_heads=small.cfg.num_heads)
    saved = os.environ.get("DIFFDOCK_TPU_ESM2_NPZ")
    os.environ["DIFFDOCK_TPU_ESM2_NPZ"] = str(npz)
    try:
        from_npz = make_embedder()
    finally:
        if saved is None:
            del os.environ["DIFFDOCK_TPU_ESM2_NPZ"]
        else:
            os.environ["DIFFDOCK_TPU_ESM2_NPZ"] = saved
    name = ESM_COMPLEXES[0]
    got = from_npz.embed_protein(proteins[name])
    direct = TorchESM2Embedder(small.to(dev).eval()).embed_protein(proteins[name])
    if not (isinstance(from_npz, TorchESM2Embedder) and from_npz.device.type == dev.type
            and from_npz.cfg == small.cfg and np.array_equal(got, direct)):
        raise PhaseError(f"make_embedder from the npz: {type(from_npz).__name__} on {from_npz.device}, config "
                         f"{from_npz.cfg}, equal to the module's embed: {np.array_equal(got, direct)}")
    del from_npz, small
    _log(f"  make_embedder: {npz.name} ({npz.stat().st_size / 2**20:.0f} MiB, {ESM_NPZ_LAYERS} layers at width 1280) "
         f"on {dev}, {got.shape} equal to the module's own embed")

    cd = E2E_SYNTH / name
    spec = InferenceSpec(name, str(cd / f"{name}_protein_processed.pdb"),
                         ligand_description=str(cd / f"{name}_ligand.sdf"))
    t1 = time.perf_counter()
    mol, protein, lm = InferenceDatasetBuilder(esm_embedder=embedder).load(spec)
    load_s = time.perf_counter() - t1
    if not np.array_equal(lm, embeddings[name]):
        raise PhaseError("InferenceDatasetBuilder's live embedding differs from K1's")
    P = args.poses
    sampler = SamplerConfig()  # 20-step schedule, 19 steps
    bcfg = dataclasses.replace(PRESETS["diffdock_l"], compute_dtype="bfloat16")
    bccfg = dataclasses.replace(ccfg, compute_dtype="bfloat16")
    if bcfg.lm_embedding_dim != cfg.hidden_size or bccfg.lm_embedding_dim != cfg.hidden_size:
        raise PhaseError(f"the models take {bcfg.lm_embedding_dim} / {bccfg.lm_embedding_dim} LM features")
    pipe = DockingPipeline(bcfg, 0, sampler, so3, torus, device=dev, confidence_cfg=bccfg, confidence_weights=1)
    data, aa, _ = pipe.featurize(mol, protein, lm)
    expected = mode_launches(pipe, data, aa, P)
    pipe.dock_mol_protein(mol, protein, str(tmp / "esm_warm"), num_poses=P, seed=1, lm_embeddings=lm)
    torch.cuda.synchronize()
    for m in kernels.values():
        m.counts.reset()
    t1 = time.perf_counter()
    res = pipe.dock_mol_protein(mol, protein, str(tmp / "esm_dock"), num_poses=P, seed=0, lm_embeddings=lm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    timings = file_dock_seconds(res)
    launches = {k: v for m in kernels.values() for k, v in m.counts.as_dict().items()}
    plain_runs = {k: v for k, v in launches.items() if "reference" in k and v}
    _log(f"  launches {launches} (expected {expected}: DiffDock-L's convs and the shipped confidence model in bf16, "
         f"final_conv and tor_bond_conv in float32)")
    if launches["fused_tp3_bf16"] != expected["fused_tp3_bf16"] or launches["fused_tp3"] != expected["fused_tp3"] \
            or plain_runs:
        raise PhaseError(f"live-ESM dock launch counts {launches} != expected {expected}, 0 plain")
    nbr, mask = np.asarray(data.lig_bond_nbr), np.asarray(data.lig_bond_mask)
    bi, bk = np.nonzero(mask)
    bond_err = _bond_error((bi, nbr[bi, bk]), np.asarray(data.lig_pos, np.float64)[: data.n_lig],
                           res.poses.astype(np.float64))
    if res.poses.shape != (P, data.n_lig, 3) or not np.isfinite(res.poses).all() or bond_err > BOND_ATOL:
        raise PhaseError(f"live-ESM dock: poses {res.poses.shape}, bond lengths moved by {bond_err:.2e} A")
    if not np.isfinite(res.confidence).all() or sorted(res.order.tolist()) != list(range(P)) or \
            np.any(np.diff(res.confidence[res.order]) > 0) or not (tmp / "esm_dock" / "rank1.sdf").exists():
        raise PhaseError(f"live-ESM dock: confidences {res.confidence}, order {res.order}")
    # the same dock from a table of the embeddings just computed
    table_dir = tmp / "esm_table"
    table_dir.mkdir()
    np.save(table_dir / f"{name}.npy", lm)
    tmol, tprot, tlm = InferenceDatasetBuilder(esm_table=LazyNpyTable(str(table_dir))).load(spec)
    tres = pipe.dock_mol_protein(tmol, tprot, str(tmp / "esm_table_dock"), num_poses=P, seed=0, lm_embeddings=tlm)
    if not (np.array_equal(tlm, lm) and np.array_equal(tres.poses, res.poses)
            and np.array_equal(tres.confidence, res.confidence)):
        raise PhaseError("the dock from the LazyNpyTable differs from the live-embedded dock")
    # zeroed embeddings: the score model docks elsewhere, and the confidence
    # model scores the live dock's poses otherwise (the dock is
    # deterministic, as the table dock shows, so any difference comes from
    # the features)
    zeros = np.zeros_like(lm)
    zres = pipe.dock_mol_protein(mol, protein, str(tmp / "esm_zero_dock"), num_poses=P, seed=0, lm_embeddings=zeros)
    zdata, zaa, _ = pipe.featurize(mol, protein, zeros)
    nl = pipe.dock_bucket(data)[0][0]
    final = torch.as_tensor(res.poses - np.asarray(data.original_center)[None, None], dtype=torch.float32, device=dev)
    final = _pad_rows(final.transpose(0, 1), nl - data.n_lig).transpose(0, 1)
    c_live = pipe.confidence(pipe.confidence_input(data, aa), final).cpu().numpy()
    c_zero = pipe.confidence(pipe.confidence_input(zdata, zaa), final).cpu().numpy()
    pose_gap = float(np.abs(zres.poses - res.poses).max())
    conf_gap = float(np.abs(c_zero - c_live).max())
    if not (pose_gap > 0 and conf_gap > 0):
        raise PhaseError(f"zeroed LM features: poses moved {pose_gap:.3e} A, confidences {conf_gap:.3e}")
    report["dock"] = {"complex": name, "embed_in_load_s": load_s, "wall_s": wall, "timings": timings,
                      "launches": launches, "expected": expected, "bond_error": bond_err,
                      "confidence": res.confidence.tolist(), "order": res.order.tolist(),
                      "zeroed_lm": {"max_pose_diff": pose_gap, "max_conf_diff_same_poses": conf_gap},
                      "s": time.perf_counter() - t0}
    _log(f"[K2 live-ESM dock] {name}: embedded in InferenceDatasetBuilder.load in {load_s:.3f} s; diffdock_l (LM 1280) + shipped "
         f"confidence in bf16, {P} poses, {sampler.num_steps} steps | dock_mol_protein {wall:.2f} s (featurize "
         f"{timings['featurize_s']:.3f}, dock {timings['dock_s']:.3f}, write {timings['write_s']:.3f}) | bond lengths "
         f"within {bond_err:.2e} A | table dock identical | zeroed LM: poses {pose_gap:.2f} A away, confidences "
         f"{conf_gap:.3f} apart on the same poses | {card} | {time.perf_counter() - t0:.1f} s")
    del pipe, embedder, card_model
    torch.cuda.empty_cache()

    # K3: esm-prep fasta, then convert on .pt files of K1's embeddings
    t0 = time.perf_counter()
    prep = tmp / "esm_prep"
    for n in ESM_COMPLEXES:
        (prep / "data" / n).mkdir(parents=True)
        pdb = f"{n}_protein_processed.pdb"
        os.symlink(E2E_SYNTH / n / pdb, prep / "data" / n / pdb)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_fasta = cli_main.main(["esm-prep", "fasta", "--data_dir", str(prep / "data"), "--out",
                                  str(prep / "prepared.fasta")])
    labels = [ln[1:] for ln in (prep / "prepared.fasta").read_text().splitlines() if ln.startswith(">")]
    (prep / "extract").mkdir()
    for label in labels:
        n = label.rsplit("_chain_", 1)[0]
        torch.save({"representations": {ESM_LAYER: torch.from_numpy(embeddings[n])}},
                   prep / "extract" / f"{label}.pt")
    with contextlib.redirect_stdout(buf):
        rc_convert = cli_main.main(["esm-prep", "convert", "--extract_dir", str(prep / "extract"), "--out_dir",
                                    str(prep / "npy")])
    for line in buf.getvalue().splitlines():
        _log(f"  esm-prep: {line}")
    written = sorted(os.listdir(prep / "npy")) if (prep / "npy").is_dir() else []
    if rc_fasta or rc_convert or labels != [f"{n}_chain_0" for n in ESM_COMPLEXES] or \
            written != [f"{n}.npy" for n in ESM_COMPLEXES] or \
            not all(np.array_equal(np.load(prep / "npy" / f"{n}.npy"), embeddings[n]) for n in ESM_COMPLEXES):
        raise PhaseError(f"esm-prep: rc {rc_fasta} / {rc_convert}, records {labels}, files {written}")
    report["esm_prep"] = {"rc": [rc_fasta, rc_convert], "records": labels, "files": written}
    _log(f"[K3 esm-prep] fasta + convert: rc {rc_fasta} / {rc_convert}, {len(written)} .npy equal to K1's embeddings "
         f"| {time.perf_counter() - t0:.1f} s")

    # K4: prewarm over the cover ladder, then again on one bucket
    runs = []
    for argv in (PREWARM_ARGS, PREWARM_ARGS + PREWARM_AGAIN):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "diffdock_tpu_torch.cli.main", "prewarm", *argv],
                              cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        for line in lines + proc.stderr.splitlines()[-20:] * (proc.returncode != 0):
            _log(f"  prewarm: {line}")
        jobs = [ln for ln in lines if ln.startswith("bucket ")]
        build_line = next((ln for ln in lines if ln.startswith("kernels: ")), "")
        runs.append({"argv": argv, "rc": proc.returncode, "wall_s": wall, "jobs": jobs, "kernels": build_line})
    n_jobs = [len(r["jobs"]) for r in runs]
    if [r["rc"] for r in runs] != [0, 0] or n_jobs != [len(COVER_LADDER), 1] or \
            not runs[1]["kernels"].startswith("kernels: 0 of ") or "[build]" in "".join(runs[1]["jobs"]):
        raise PhaseError(f"prewarm: rc {[r['rc'] for r in runs]}, jobs {n_jobs}, second run: {runs[1]['kernels']!r}")
    report["prewarm"] = runs
    _log(f"[K4 prewarm] cover ladder: rc 0, {n_jobs[0]} jobs in {runs[0]['wall_s']:.1f} s; again on one bucket: "
         f"{runs[1]['kernels']} | {card}")
    report["s"] = time.perf_counter() - t_start
    _log(f"[K protein inputs] {card} | phase {report['s']:.1f} s")
    return report


# phase L: the device mesh (diffdock_tpu_torch/parallel/mesh.py) on this one
# card. MESH_RANKS ranks share cuda:0 over gloo (NCCL refuses two ranks on
# one device; one rank per card, over NCCL, needs a machine with more cards):
# every time and size below is two processes sharing one card, not a
# multi-GPU scaling figure. L1 docks phase 4's complex pose-sharded, L2
# three of phase D's complexes one per rank, L3 takes data-parallel train
# steps, L4 runs the dock CLI under torchrun.
MESH_RANKS = 2
MESH_DOCK_COMPLEXES = EVAL_COMPLEXES[:3]
MESH_TWIN_SEEDS = (7, 8)
# L3's batch: four of phase E's (48, 320) complexes, each rank's two holding
# as many rotatable bonds (20): the torsion loss is a mean over a batch's
# bonds, so the ranks' mean of their losses is the whole batch's only then
# (in the JAX package's sharded step too)
MESH_TRAIN_COMPLEXES = ("syn016_l36r224", "syn073_l47r311", "syn077_l38r217", "syn087_l45r286")
MESH_CLI_COMPLEX = "syn001_l24r104"


def _np_noise(draws) -> tuple:
    """(InitNoise, StepNoise) as numpy fields, to send to a rank."""
    return tuple(tuple(t.detach().cpu().numpy() for t in part) for part in draws)


def _torch_noise(fields, dev):
    import torch

    from diffdock_tpu_torch.inference.sampler import InitNoise, StepNoise

    return (InitNoise(*[torch.as_tensor(a, device=dev) for a in fields[0]]),
            StepNoise(*[torch.as_tensor(a, device=dev) for a in fields[1]]))


def _cat_noise(parts):
    """The draws of several shards joined on the pose axis (axis 1 of the
    per-step draws), as one pose batch's."""
    import numpy as np

    init = tuple(np.concatenate([p[0][k] for p in parts]) for k in range(len(parts[0][0])))
    steps = tuple(np.concatenate([p[1][k] for p in parts], axis=1) for k in range(len(parts[0][1])))
    return init, steps


def _params_digest(named) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(named):
        h.update(k.encode())
        h.update(named[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _snapshot(model, state) -> dict:
    """A train state and its model's tensors, cloned."""
    from diffdock_tpu_torch.train.trainer import AdamState

    o = state.opt_state
    return {"model": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "opt": AdamState(o.count.clone(), {k: v.clone() for k, v in o.mu.items()},
                             {k: v.clone() for k, v in o.nu.items()}),
            "ema": {k: v.detach().clone() for k, v in state.ema_params.items()}, "step": state.step}


def _restore(model, tc, snap):
    from diffdock_tpu_torch.train import trainer

    model.load_state_dict(snap["model"], strict=True)
    state = trainer.create_train_state(model, tc)
    o = snap["opt"]
    state.opt_state = type(o)(o.count.clone(), {k: v.clone() for k, v in o.mu.items()},
                              {k: v.clone() for k, v in o.nu.items()})
    state.ema_params = {k: v.clone() for k, v in snap["ema"].items()}
    state.step = snap["step"]
    return state


def _shard_acts(acts: dict, mesh) -> dict:
    """A whole batch's pre-ReLU outputs (:func:`record_pre_relu`), each
    call's leading (complex-major) axis cut to this rank's shard."""
    return {n: [t.chunk(mesh.size)[mesh.rank] for t in calls] for n, calls in acts.items()}


def _twin_record(model, state, metrics, acts, counts) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _flat_leaves(model, state.grads), "params": _flat_leaves(model, state.params),
            "stats": {k: v.detach().cpu().numpy() for k, v in state.batch_stats.items()},
            "counts": counts, "acts": acts}


def _mesh_pose_docks(mesh, p: dict, so3, torus) -> dict:
    """L1 on one rank: the pose-sharded dock of phase 4's complex in float32
    and in bfloat16, each shard from the parent's draws for its rank; each
    dock run twice (the second, warm, is counted and timed) and its poses
    equal to the first's."""
    import numpy as np
    import torch

    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.ops import fused_tp3 as ft

    dev, out = mesh.device, {}
    draws = {r: _torch_noise(f, dev) for r, f in p["l1_draws"].items()}

    def noise(num_poses, n_bonds, seed, fold=None):
        return draws[fold]

    for mode, (cfg, ccfg) in p["l1_models"].items():
        pipe = DockingPipeline(cfg, 0, SamplerConfig(), so3, torus, device=dev, confidence_cfg=ccfg,
                               confidence_weights=1, mesh=mesh)
        first = pipe.dock_complex(p["data"], num_poses=p["poses"], seed=0, noise=noise, aa_data=p["aa"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ft.counts.reset()
        mesh.barrier()
        t0 = time.perf_counter()
        res = pipe.dock_complex(p["data"], num_poses=p["poses"], seed=0, noise=noise, aa_data=p["aa"])
        torch.cuda.synchronize()
        out[mode] = {"result": res, "wall_s": time.perf_counter() - t0, "launches": ft.counts.as_dict(),
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "repeat_identical": bool(np.array_equal(first.poses, res.poses))}
        del pipe
    return out


def _mesh_dock_batch(mesh, p: dict, so3, torus) -> dict:
    """L2 on one rank: ``dock_batch`` of three complexes, one per rank."""
    import torch

    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.ops import fused_tp3 as ft

    cfg, ccfg = p["l1_models"]["float32"]
    pipe = DockingPipeline(cfg, 0, SamplerConfig(), so3, torus, device=mesh.device, confidence_cfg=ccfg,
                           confidence_weights=1, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft.counts.reset()
    mesh.barrier()
    t0 = time.perf_counter()
    res = pipe.dock_batch(p["l2_datas"], num_poses=p["poses"], seed=0, aa_datas=p["l2_aas"])
    torch.cuda.synchronize()
    return {"results": res, "wall_s": time.perf_counter() - t0, "launches": ft.counts.as_dict(),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def _mesh_train_twins(mesh, p: dict, so3, torus) -> dict:
    """L3 on one rank: for each of MESH_TWIN_SEEDS, the single-process step
    of the whole batch (4 complexes) and the data-parallel step of this
    rank's half from the same start and draws, its ReLU ties pinned to the
    single step's (its shard of them). The data-parallel steps run on as one
    chain and each case starts from its state, the same bits on every rank
    (a single-process step's atomic backward differs from rank to rank).
    First the DiffDock-L score model from phase E's saved train state at
    (48, 320), then the coarse-grained confidence model at phase G's width
    from G's weights."""
    import torch

    from diffdock_tpu_torch.data.complexes import to_device
    from diffdock_tpu_torch.models.factory import build_model
    from diffdock_tpu_torch.models.score_model import CGScoreModel
    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.parallel import mesh as mesh_mod
    from diffdock_tpu_torch.train import checkpoints as ckpt
    from diffdock_tpu_torch.train import confidence as tconf
    from diffdock_tpu_torch.train import trainer
    from diffdock_tpu_torch.train.noise import draw_noise

    dev, out = mesh.device, {"score": [], "confidence": []}
    # the score model
    cfg = p["l3_cfg"]
    tc = trainer.TrainConfig()
    single = CGScoreModel(cfg).to(dev)
    dp = CGScoreModel(trainer.training_model_config(cfg, data_parallel=True)).to(dev)
    batch = to_device(p["l3_batch"], dev)
    state = trainer.create_train_state(single, tc)
    ckpt.load_train_state(p["l3_log_dir"], single, state)
    dstate = _restore(dp, tc, _snapshot(single, state))
    dp_step = mesh_mod.shard_train_step(trainer.make_train_step(dp, tc, so3, torus, mesh=mesh), mesh)
    single_step = trainer.make_train_step(single, tc, so3, torus)
    for seed in MESH_TWIN_SEEDS:
        snap = _snapshot(dp, dstate)
        draws = draw_noise(torch.Generator(device=dev).manual_seed(seed), batch.rot_u.shape[0],
                           batch.rot_u.shape[1], device=dev)
        acts: dict = {}
        hooks = record_pre_relu(single, acts)
        ft.counts.reset()
        state, metrics = single_step(_restore(single, tc, snap), batch, draws)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        ref = _twin_record(single, state, metrics, _shard_acts(acts, mesh), ft.counts.as_dict())
        dacts: dict = {}
        hooks = record_pre_relu(dp, dacts, ref["acts"])
        own = draws._replace(**{f: getattr(draws, f)[mesh.shard(batch.rot_u.shape[0])] for f in draws._fields})
        ft.counts.reset()
        mesh.collective_s = 0.0
        mesh.barrier()
        t0 = time.perf_counter()
        dstate, dmetrics = dp_step(dstate, batch, own)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for h in hooks:
            h.remove()
        rec = _twin_record(dp, dstate, dmetrics, dacts, ft.counts.as_dict())
        out["score"].append({"seed": seed, "compare": compare_twins(dp, ref, rec, tc.lr),
                             "counts": rec["counts"], "single_counts": ref["counts"], "wall_s": wall,
                             "collective_s": mesh.collective_s, "digest": _params_digest(dstate.params)})
    del single, dp, state, dstate

    # the confidence model
    ccfg, ctc = p["l3_conf_cfg"], tconf.ConfidenceTrainConfig()
    single = build_model(ccfg).to(dev)
    dp = build_model(trainer.training_model_config(ccfg, data_parallel=True)).to(dev)
    dp.load_state_dict(p["l3_conf_sd"], strict=True)
    batch = to_device(p["l3_conf_batch"], dev)
    poses = torch.as_tensor(p["l3_conf_poses"], device=dev)
    labels = torch.as_tensor(ctc.labels_from_rmsds(p["l3_conf_rmsds"]), device=dev)
    dstate = tconf.create_confidence_train_state(dp, ctc)
    single_step = tconf.make_confidence_train_step(single, ctc)
    dp_step = mesh_mod.shard_confidence_train_step(tconf.make_confidence_train_step(dp, ctc, mesh=mesh), mesh)
    for seed in MESH_TWIN_SEEDS:
        opt = dstate.opt_state
        single.load_state_dict(dp.state_dict(), strict=True)
        state = tconf.create_confidence_train_state(single, ctc)
        state.opt_state = type(opt)(opt.count.clone(), {k: v.clone() for k, v in opt.mu.items()},
                                    {k: v.clone() for k, v in opt.nu.items()})
        acts = {}
        hooks = record_pre_relu(single, acts)
        ft.counts.reset()
        state, metrics = single_step(state, batch, poses, labels, torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        ref = _twin_record(single, state, metrics, _shard_acts(acts, mesh), ft.counts.as_dict())
        dacts = {}
        hooks = record_pre_relu(dp, dacts, ref["acts"])
        ft.counts.reset()
        mesh.collective_s = 0.0
        mesh.barrier()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(mesh_mod.fold_seed(seed, mesh.rank))
        dstate, dmetrics = dp_step(dstate, batch, poses, labels, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for h in hooks:
            h.remove()
        rec = _twin_record(dp, dstate, dmetrics, dacts, ft.counts.as_dict())
        out["confidence"].append({"seed": seed, "compare": compare_conf_twins(dp, ref, rec, ctc.lr),
                                  "counts": rec["counts"], "single_counts": ref["counts"], "wall_s": wall,
                                  "collective_s": mesh.collective_s,
                                  "digest": _params_digest(dstate.params)})
    return out


def mesh_rank_jobs(out_dir: str, p: dict) -> int:
    """Phase L's work on one rank of the mesh (started by
    ``parallel/mesh.py:launch``): L1, L2 and L3, each sub-phase's result,
    launches, wall and peak memory pickled to ``out_dir/rank<r>.pkl``."""
    import pickle

    import torch

    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables
    from diffdock_tpu_torch.geometry import use_full_fp32
    from diffdock_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(device="cuda")
    use_full_fp32()
    so3, torus = get_so3_tables(device=mesh.device), get_torus_tables(device=mesh.device)
    report = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend, "walls": {}}
    for key, job in (("L1", _mesh_pose_docks), ("L2", _mesh_dock_batch), ("L3", _mesh_train_twins)):
        mesh.barrier()
        t0 = time.perf_counter()
        report[key] = job(mesh, p, so3, torus)
        report["walls"][key] = time.perf_counter() - t0
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    with open(Path(out_dir) / f"rank{mesh.rank}.pkl", "wb") as f:
        pickle.dump(report, f)
    return 0


def mesh_phase(args, tmp: Path, cfg, ccfg, data, aa, so3, torus, card: str, dev) -> dict:
    """Phase L: the device mesh on this card (see the module docstring). The
    references run in this process; the ranks are MESH_RANKS processes that
    ``parallel/mesh.py:launch`` starts on cuda:0."""
    import pickle

    import numpy as np
    import torch

    from diffdock_tpu_torch.cli import confidence_train as conf_cli
    from diffdock_tpu_torch.data.complexes import bucket_sizes
    from diffdock_tpu_torch.data.datasets import ComplexDataset, DatasetConfig, pdbbind_specs
    from diffdock_tpu_torch.data.inference_dataset import InferenceDatasetBuilder, InferenceSpec
    from diffdock_tpu_torch.data.esm import LazyNpyTable
    from diffdock_tpu_torch.data.loaders import stack_batch, stack_padded
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.parallel import mesh as mesh_mod
    from diffdock_tpu_torch.train import checkpoints as ckpt
    from diffdock_tpu_torch.train import confidence as tconf
    from diffdock_tpu_torch.utils.convert import state_dict_from_flax

    t_start = time.perf_counter()
    report: dict = {"ranks": MESH_RANKS, "backend": mesh_mod.backend_for(MESH_RANKS, "cuda"),
                    "arrangement": f"{MESH_RANKS} ranks sharing cuda:0 ({card})"}
    if report["backend"] != "gloo":
        raise PhaseError(f"{MESH_RANKS} ranks on {torch.cuda.device_count()} card(s) would take "
                         f"{report['backend']}; this phase is written for ranks sharing one card")
    _log(f"  L arrangement: {MESH_RANKS} ranks on cuda:0, backend gloo, rank r on cuda:r mod "
         f"{torch.cuda.device_count()} (two processes sharing one card, not a scaling figure)")
    P = args.poses
    nb = bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)[2]
    models = {"float32": (cfg, ccfg),
              "bfloat16": (dataclasses.replace(cfg, compute_dtype="bfloat16"),
                           dataclasses.replace(ccfg, compute_dtype="bfloat16"))}

    # L1 references: the single-process docks of the concatenated shard draws
    t0 = time.perf_counter()
    singles = {m: DockingPipeline(c, 0, SamplerConfig(), so3, torus, device=dev, confidence_cfg=cc,
                                  confidence_weights=1) for m, (c, cc) in models.items()}
    per_rank = -(-P // MESH_RANKS)
    shard_draws = {r: _np_noise(singles["float32"].draw_noise(per_rank, nb, 0, fold=r)) for r in range(MESH_RANKS)}
    joined = _torch_noise(_cat_noise([shard_draws[r] for r in range(MESH_RANKS)]), dev)
    refs = {m: s.dock_complex(data, num_poses=P, seed=0, aa_data=aa, noise=lambda n, b, s_: joined)
            for m, s in singles.items()}
    expected = {m: mode_launches(s, data, aa, per_rank) for m, s in singles.items()}

    # L2: three of phase D's complexes, featurized here; the references run
    # each rank's program for its complex in this process
    builder = InferenceDatasetBuilder(esm_table=LazyNpyTable(str(E2E_SYNTH / "_esm")))
    l2_datas, l2_aas = [], []
    for name in MESH_DOCK_COMPLEXES:
        d = E2E_SYNTH / name
        mol, protein, lm = builder.load(InferenceSpec(name, str(d / f"{name}_protein_processed.pdb"),
                                                      ligand_description=str(d / f"{name}_ligand.sdf")))
        c_data, c_aa, _ = singles["float32"].featurize(mol, protein, lm)
        l2_datas.append(c_data)
        l2_aas.append(c_aa)
    l2_refs, l2_nudged = {}, {}
    single = singles["float32"]
    for g in single.batch_groups(l2_datas, l2_aas, P, size=MESH_RANKS):
        if g.pose_chunk != P:
            raise PhaseError(f"L2 group {g.idxs} runs {g.pose_chunk}-pose chunks; this phase docks {P} at once")
        for j, i in enumerate(g.idxs):
            c_data, c_aa = g.members[j]
            l2_refs[i] = single.dock_program(c_data, g.bucket, P, 0, aa_data=c_aa, fold=i, widths=g.widths)
            # how far float32 rounding moves this dock: its start translations nudged
            init, steps = single.draw_noise(P, g.bucket[2], 0, fold=i)
            e = torch.randn(init.tr.shape, generator=torch.Generator(device=dev).manual_seed(i + 1), device=dev)
            with torch.inference_mode():
                l2_nudged[i] = single._dock_program(
                    c_data, g.bucket, P, 0, lambda *a, **k: (init._replace(tr=init.tr * (1 + NUDGE * e)), steps),
                    c_aa, False, None, widths=g.widths)
    ref_s = time.perf_counter() - t0

    # L3: phase E's (48, 320) batch and train state, phase G's confidence
    # model and pose caches
    root = tmp / "train"
    train_ds = ComplexDataset(pdbbind_specs(str(E2E_SYNTH), str(root / "train.txt"),
                                            esm_embeddings_dir=str(E2E_SYNTH / "_esm")),
                              DatasetConfig(cache_dir=str(root / "cache")))
    train_ds.preprocess(verbose=False)
    members = [(n, train_ds.get(n)) for n in MESH_TRAIN_COMPLEXES]
    bonds = [int(np.asarray(m.rot_mask).sum()) for _, m in members]
    half = len(members) // MESH_RANKS
    if len({sum(bonds[r * half:(r + 1) * half]) for r in range(MESH_RANKS)}) != 1:
        raise PhaseError(f"L3: the ranks' halves of {MESH_TRAIN_COMPLEXES} hold {bonds} rotatable bonds")
    l3_batch = stack_batch(members, bucket_sizes(48, 320, max(m.n_bonds for _, m in members)))[1]
    _, run_cfg, _ = ckpt.load_checkpoint(str(root / "run"), "last_model.msgpack")
    croot = tmp / "confidence"
    cargs = conf_cli.get_parser().parse_args(
        ["--data_dir", str(E2E_SYNTH), "--split_train", str(croot / "train.txt"), "--cache_path",
         str(croot / "cache"), "--log_dir", str(croot / "cg"), "--device", str(dev)] + CONF_CG_ARGS)
    cdatas, _ = conf_cli.load_complexes(cargs)
    cnames = list(cdatas)[:TRAIN_BATCH]
    cached = [tconf.load_pose_cache(croot / "poses", n, [0]) for n in cnames]
    cparams, conf_cfg, _ = ckpt.load_checkpoint(str(croot / "cg"), "last_model.msgpack")
    payload = {"poses": P, "data": data, "aa": aa, "l1_models": models, "l1_draws": shard_draws,
               "l2_datas": l2_datas, "l2_aas": l2_aas,
               "l3_cfg": run_cfg, "l3_batch": l3_batch, "l3_log_dir": str(root / "run"),
               "l3_conf_cfg": conf_cfg, "l3_conf_sd": state_dict_from_flax(cparams, conf_cfg),
               "l3_conf_batch": stack_padded([cdatas[n] for n in cnames]),
               "l3_conf_poses": np.stack([c[0][0] - np.asarray(cdatas[n].original_center)
                                          for n, c in zip(cnames, cached)]).astype(np.float32),
               "l3_conf_rmsds": [float(c[1][0]) for c in cached]}

    # the ranks
    out = tmp / "mesh"
    out.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh_mod.launch(mesh_rank_jobs, (str(out), payload), MESH_RANKS, "cuda")
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(MESH_RANKS):
        with open(out / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    report.update(references_s=ref_s, ranks_s=spawn_s,
                  rank_walls={r["rank"]: r["walls"] for r in ranks},
                  rank_peak_bytes={r["rank"]: r["peak_bytes"] for r in ranks})

    # L1 gates
    report["L1"] = {}
    for mode in models:
        got = [r["L1"][mode] for r in ranks]
        res = got[0]["result"]
        for r, g in enumerate(got):
            if not np.array_equal(g["result"].poses, res.poses) or not g["repeat_identical"]:
                raise PhaseError(f"L1 {mode}: rank {r}'s gathered poses differ from rank 0's or from its "
                                 "first dock")
            want = expected[mode]
            if g["launches"]["fused_tp3"] != want["fused_tp3"] or \
                    g["launches"]["fused_tp3_bf16"] != want["fused_tp3_bf16"] or \
                    g["launches"]["fused_tp3_reference"]:
                raise PhaseError(f"L1 {mode}: rank {r} launched {g['launches']}, expected {want} for "
                                 f"{per_rank} poses and no plain version")
        if res.poses.shape != (P, data.n_lig, 3) or not np.isfinite(res.poses).all() or \
                not np.isfinite(res.confidence).all():
            raise PhaseError(f"L1 {mode}: non-finite or misshapen poses {res.poses.shape}")
        entry = {"launches_per_rank": [g["launches"] for g in got], "expected_per_rank": expected[mode],
                 "wall_s_per_rank": [g["wall_s"] for g in got], "peak_bytes_per_rank": [g["peak_bytes"] for g in got]}
        if mode == "float32":
            entry["agree"] = docks_agree(res, refs[mode])
        else:
            # as phase H2: bond lengths and the ranking, no pose-for-pose gate
            nbr, mask = np.asarray(data.lig_bond_nbr), np.asarray(data.lig_bond_mask)
            bi, bk = np.nonzero(mask)
            start = np.asarray(data.lig_pos, np.float64)[: data.n_lig]
            entry["bond_err"] = _bond_error((bi, nbr[bi, bk]), start, res.poses.astype(np.float64))
            if entry["bond_err"] > BOND_ATOL or np.any(np.diff(res.confidence[res.order]) > 0):
                raise PhaseError(f"L1 bf16: bond lengths moved by {entry['bond_err']:.2e} A or the order "
                                 "does not rank the confidences")
            entry["rmsd_to_single"] = np.sqrt(((res.poses - refs[mode].poses) ** 2).sum(-1).mean(-1)).tolist()
        report["L1"][mode] = entry
        _log(f"[L1 pose-sharded dock, {mode}] {P} poses over {MESH_RANKS} ranks, {per_rank} each | rank walls "
             f"{' '.join(f'{w:.3f}' for w in entry['wall_s_per_rank'])} s | per-rank launches "
             f"{[{k: v for k, v in g.items() if v} for g in entry['launches_per_rank']]} (expected "
             f"{ {k: v for k, v in expected[mode].items() if v} }) | peak "
             f"{' '.join(f'{b / 2**30:.2f}' for b in entry['peak_bytes_per_rank'])} GiB | "
             + (f"max |poses - single process| {entry['agree']['max_abs_pose_diff']:.3e} A"
                if mode == "float32" else f"bond lengths within {entry['bond_err']:.2e} A, RMSD to the "
                f"single-process bf16 dock {max(entry['rmsd_to_single']):.3f} A at most (no gate)")
             + f" | {card}")

    # L2 gates
    got = [r["L2"] for r in ranks]
    report["L2"] = {"wall_s_per_rank": [g["wall_s"] for g in got], "launches_per_rank": [g["launches"] for g in got],
                    "peak_bytes_per_rank": [g["peak_bytes"] for g in got], "complexes": {}}
    for i, name in enumerate(MESH_DOCK_COMPLEXES):
        res = got[0]["results"][i]
        if any(not np.array_equal(g["results"][i].poses, res.poses) for g in got):
            raise PhaseError(f"L2 {name}: the ranks returned other poses")
        gap = float(np.abs(l2_nudged[i].poses - l2_refs[i].poses).max())
        agree = docks_agree(res, l2_refs[i], pose_tol=max(POSE_ATOL, 2 * gap))
        report["L2"]["complexes"][name] = dict(agree, nudge_gap=gap)
    if any(g["launches"]["fused_tp3_reference"] for g in got):
        raise PhaseError(f"L2: a plain version ran: {[g['launches'] for g in got]}")
    _log(f"[L2 complex-sharded dock_batch] {len(MESH_DOCK_COMPLEXES)} complexes, {P} poses, one per rank | "
         f"rank walls {' '.join(f'{w:.3f}' for w in report['L2']['wall_s_per_rank'])} s | launches "
         f"{[g['launches']['fused_tp3'] for g in got]} | peak "
         f"{' '.join(f'{b / 2**30:.2f}' for b in report['L2']['peak_bytes_per_rank'])} GiB | max |poses - "
         f"single process| {max(c['max_abs_pose_diff'] for c in report['L2']['complexes'].values()):.3e} A | {card}")

    # L3 gates
    report["L3"] = {}
    for model_key in ("score", "confidence"):
        cases = [r["L3"][model_key] for r in ranks]
        for k, case in enumerate(cases[0]):
            digests = {c[k]["digest"] for c in cases}
            c = case["compare"]
            _log(f"  L3 {model_key} seed {case['seed']}: loss {c['loss']:.6f} (worst metric "
                 f"{c['metric_rel_err']:.3e}) | worst leaf {c['grad_worst_leaf']} {c['grad_norm_rel_err']:.3e} in "
                 f"norm, all {c['grad_all_rel_err']:.3e} | params {c['param_solid_err_lr']:.3e} lr solid, "
                 f"{c['param_err_lr']:.3e} lr anywhere | stats {c['batch_stat_rel_err']:.3e} | pinned ReLU units "
                 f"{c['relu_switched']['total']} | step {max(x[k]['wall_s'] for x in cases):.3f} s of which "
                 f"collectives {' '.join(format(x[k]['collective_s'], '.3f') for x in cases)} s by rank | "
                 f"{'ok' if c['ok'] else 'OUTSIDE ' + str(c['outside'])}")
            if len(digests) != 1:
                raise PhaseError(f"L3 {model_key} seed {case['seed']}: parameters differ across ranks")
            if not all(x[k]["compare"]["ok"] for x in cases):
                raise PhaseError(f"L3 {model_key} seed {case['seed']}: the data-parallel step is outside phase "
                                 f"E3's limits: {[x[k]['compare']['outside'] for x in cases]}")
            if case["counts"]["fused_tp3_reference"] or case["counts"]["fused_tp3"] != case["counts"]["fused_tp3_vjp"]:
                raise PhaseError(f"L3 {model_key}: step counts {case['counts']}")
        report["L3"][model_key] = [[{k: v for k, v in x.items()} for x in c] for c in cases]
    _log(f"[L3 data-parallel steps] DiffDock-L at (48, 320) and the CG confidence model, batch "
         f"{TRAIN_BATCH} ({TRAIN_BATCH // MESH_RANKS} per rank), {len(MESH_TWIN_SEEDS)} steps each: within "
         f"phase E3's limits, params bit-identical across ranks | {card}")

    # L4: the dock CLI under torchrun, both ranks on this card
    t0 = time.perf_counter()
    cli_out = tmp / "mesh_cli"
    d = E2E_SYNTH / MESH_CLI_COMPLEX
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(MESH_RANKS),
         "-m", "diffdock_tpu_torch.cli.dock", "--protein_path", str(d / f"{MESH_CLI_COMPLEX}_protein_processed.pdb"),
         "--ligand", str(d / f"{MESH_CLI_COMPLEX}_ligand.sdf"), "--complex_name", MESH_CLI_COMPLEX,
         "--model_dir", str(tmp / "runs_no_lm" / "score"), "--confidence_model_dir",
         str(tmp / "runs_no_lm" / "confidence"), "--samples_per_complex", str(P), "--out_dir", str(cli_out),
         "--pose_devices", str(MESH_RANKS), "--device", "cuda"],
        cwd=str(Path(__file__).resolve().parent), env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    for line in (proc.stdout + proc.stderr).splitlines()[-12:]:
        _log(f"  L4 torchrun: {line}")
    files = sorted(p_.name for p_ in (cli_out / MESH_CLI_COMPLEX).glob("*")) if (cli_out / MESH_CLI_COMPLEX).is_dir() else []
    if proc.returncode != 0 or len(files) != P or "rank1.sdf" not in files or \
            proc.stdout.count("mesh: 2 ranks over gloo") != 1:
        raise PhaseError(f"L4: torchrun returned {proc.returncode} and wrote {files}")
    from diffdock_tpu_torch.data.chem import parse_sdf

    with open(cli_out / MESH_CLI_COMPLEX / "rank1.sdf") as f:
        coords = parse_sdf(f.read())[0].coords
    if not np.isfinite(coords).all():
        raise PhaseError("L4: rank1.sdf holds non-finite coordinates")
    report["L4"] = {"rc": proc.returncode, "files": len(files), "wall_s": cli_s}
    report["total_s"] = time.perf_counter() - t_start
    _log(f"[L4 dock CLI under torchrun] {MESH_RANKS} ranks on cuda:0, {P} poses of {MESH_CLI_COMPLEX}: rc 0, "
         f"{len(files)} ranked SDFs written once | {cli_s:.1f} s | {card}")
    _log(f"[L mesh] references {ref_s:.1f} s | ranks {spawn_s:.1f} s (per rank: "
         f"{'; '.join('L1 %.1f L2 %.1f L3 %.1f' % (w['L1'], w['L2'], w['L3']) for w in report['rank_walls'].values())}) "
         f"| L4 {cli_s:.1f} s | phase {report['total_s']:.1f} s | {card}")
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--poses", type=int, default=10)
    parser.add_argument("--iters", type=int, default=20, help="launches per timing")
    parser.add_argument("--json", type=Path, default=None, help="also write the full report here")
    args = parser.parse_args(argv)

    t_start = time.perf_counter()
    repo = Path(__file__).resolve().parent
    if not (repo / "diffdock_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the diffdock_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke run needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))

    try:
        report = run(args)
    except Exception as exc:  # a failed phase ends the run without a result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    report["total_s"] = time.perf_counter() - t_start
    _log(f"[total] {report['total_s']:.1f} s")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(report, indent=1))
    print(card_line(), flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
