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
6. timings at the six blocks: each kernel, its plain version and its
   library route, with CUDA events, beside the least time the card could
   take: bytes over 3.35 TB/s, or FLOPs over the peak of the unit that does
   them (the two products of every kernel run on the tensor cores in
   3xTF32, 495 / 3 = 165 TFLOP/s; the coupling that gens 2 and 1 build
   inside on the CUDA cores in float32, 67 TFLOP/s), the all-float32 bound
   kept beside. The library route of gen 3 is the einsum pair on the
   coupled operands; that of gens 2 and 1 builds the coupling in PyTorch
   first (the gen-3 wrapper's ``merged_coupled`` and the ``h_aug`` concat),
   with the einsum pair alone beside it;
7. profile: ``torch.profiler`` over a warm 2-step dock with ranking — device
   time by kernel, the hand-written kernels' share and the device's busy
   share.

It then prints the card line (``nvidia-smi --query-gpu=name,power.limit``),
one JSON line with the kernels' numbers, and, last, the result line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
the result line; without a CUDA device, or without the package beside
this script, it exits non-zero at once. Nothing runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

F32_PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# H100 SXM dense TF32 on the tensor cores; 3xTF32 takes three products
TF32X3_PEAK_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

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
    edge_sh = spherical_harmonics(torch.randn(rows, K, 3, **kw), 2)[..., :sh_dim]
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
    """(product FLOPs, 0, bytes) the gen-3 contraction must do at least: the
    neighbour reduction P = h_aug^T coupled over every live class, the
    weight contraction over the compact (H+1, fan, mul) blocks, each input
    (h_aug, the coupled tensor built outside the kernel, the weights) read
    once and the output written once (float32)."""
    f_tot, weight, w_len = _class_sums(tp)
    Ha = H + 1
    products = 2.0 * rows * Ha * K * f_tot + 2.0 * rows * Ha * weight
    nbytes = 4.0 * (rows * K * Ha + rows * K * f_tot + Ha * w_len + rows * tp.irreps_out.dim)
    return products, 0.0, nbytes


def _coupling_flops(tp) -> float:
    """FMAs per edge of the coupled columns: d1 terms for each (u, d)."""
    return float(sum(tp.irreps_in1[p.i].ir.dim * tp.irreps_in1[p.i].mul * ek.ir.dim
                     for pk, ek in zip(tp.paths, tp.irreps_out) for p in pk))


def tp2_work(tp, rows: int, K: int, H: int):
    """(product FLOPs, coupling FLOPs, bytes) of the gen-2 contraction: P
    over the H+1 live hidden rows and the weight contraction; the CG
    weights (each column's dot over its nonzero rows of ``CG_full``, the
    terms a dense ``sh @ CG`` has that are not zero) and the coupled
    columns; it reads the packed neighbour features, the harmonics, the H+1
    live rows of ``h_aug``, the CG matrix and the (H+1, fan, mul) weights once
    and writes the output."""
    import numpy as np

    from diffdock_tpu_torch.ops.factored_tp2 import build_specs2

    _specs, cg_full, xp_dim, out_dim = build_specs2(tp)
    f_tot, weight, w_len = _class_sums(tp)
    J, Ha = tp.irreps_in2.dim, H + 1
    rows_nz = [np.flatnonzero(col) for col in (cg_full != 0).T]
    cg_terms = sum(int(r[-1] - r[0]) + 1 for r in rows_nz if r.size)
    products = 2.0 * rows * Ha * K * f_tot + 2.0 * rows * Ha * weight
    coupling = 2.0 * rows * K * (cg_terms + _coupling_flops(tp))
    nbytes = 4.0 * (rows * K * (xp_dim + J + Ha) + cg_full.size + Ha * w_len + rows * out_dim)
    return products, coupling, nbytes


def tp1_work(tp, rows: int, K: int, H: int):
    """(product FLOPs, coupling FLOPs, bytes) of the gen-1 contraction: p_h
    and p_b, the weight and bias contractions; each path's CG dot over its
    own d2 harmonics and the coupled columns; it reads the packed neighbour
    features, the harmonics, h, mw, the CG matrix, the weights and the bias
    once and writes the output."""
    from diffdock_tpu_torch.ops.factored_tp1 import build_specs

    specs, cg_all, xp_dim, out_dim = build_specs(tp)
    f_tot, weight, w_len = _class_sums(tp)
    cg_flops = sum(p.d2 * p.d1 * s.d3 for s in specs for p in s.paths)
    products = 2.0 * rows * (H + 1) * K * f_tot + 2.0 * rows * (H + 1) * weight
    coupling = 2.0 * rows * K * (cg_flops + _coupling_flops(tp))
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
    0; none in the last layer), the center head and the torsion head."""
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
    return npe + n_steps * per_step


def _check(label, got, ref, checks):
    import torch

    err = (got - ref).abs().max().item()
    scale = max(ref.abs().max().item(), 1.0)
    ok = bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale
    checks[label] = {"max_abs_err": err, "max_abs_ref": scale, "ok": ok}
    return err, scale, ok


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
    H, Hc = 3 * cfg.ns, 3 * ccfg.ns
    k_rec, k_atom = data.rec_nbr.shape[1], aa.atom_nbr.shape[1]
    L = ccfg.num_conv_layers

    # 3. kernel vs plain at the main path's shapes: the score model's three
    # blocks and three of the confidence model's (layer L-2, the last with
    # atom receivers; its TP is the ladder's widest), for every kernel
    t0 = time.perf_counter()
    conv_tp = model.conv_layers[0].tp
    score_blocks = {
        "rec<-lig cross (conv)": (conv_tp, P * nr, nl, H),
        "lig<-rec cross (conv)": (conv_tp, P * nl, nr, H),
        "rec<-rec (rec_emb_2)": (model.rec_emb_layers[-1].tp, nr, k_rec, H),
    }
    conf_blocks = {
        "atom<-lig cross (confidence)": (cmodel.conv_layers[9 * (L - 2) + 4].tp, P * na, nl, Hc),
        "atom<-atom (confidence)": (cmodel.conv_layers[9 * (L - 2) + 3].tp, P * na, k_atom, Hc),
        "lig<-atom cross (confidence)": (cmodel.conv_layers[9 * (L - 2) + 2].tp, P * nl, na, Hc),
    }
    plain = {"fused_tp3": ft.fused_tp3_reference, "factored_tp2": f2.factored_tp_reference,
             "factored_tp1": f2.factored_tp_reference}
    wrappers = {"fused_tp3": ft.fused_tp3, "factored_tp2": f2.factored_tp2,
                "factored_tp1": f1.factored_tp1}
    checks = {k: {} for k in kernels}
    blocks_all = dict(score_blocks, **conf_blocks)
    with torch.inference_mode():
        for kname in kernels:
            for i, (label, (tp, rows, K, Hb)) in enumerate(blocks_all.items()):
                inp = tp_inputs(tp, rows, K, Hb, seed=i, device=dev)
                got = wrappers[kname](tp, *inp)
                ref = plain[kname](tp, *inp)
                torch.cuda.synchronize()
                err, scale, ok = _check(label, got, ref, checks[kname])
                f_tot = sum(fan * d3 for _k, _o, fan, d3, _m in tp.live_classes())
                checks[kname][label].update(rows=rows, K=K, H=Hb, F_tot=f_tot,
                                            W_tot=tp.irreps_out.dim)
                _log(f"  {kname} {label}: R={rows} K={K} H+1={Hb + 1} F_tot={f_tot} "
                     f"W_tot={tp.irreps_out.dim} max_abs_err={err:.3e} "
                     f"(tol {KERNEL_RTOL:.0e} x {scale:.3g}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise PhaseError(f"{kname} disagrees with its plain version at {label}")
                del inp, got, ref
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
    noise = pipe.draw_noise(P, nb, seed=0)
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
    pose_err = float(np.abs(res.poses - ref_res.poses).max())
    conf_err = float(np.abs(res.confidence - ref_res.confidence).max())
    conf_tol = CONF_RTOL * max(float(np.abs(ref_res.confidence).max()), 1.0)
    # the ranking must agree wherever neighbouring confidences (plain path's
    # order) differ by more than twice the tolerance
    rank_ok = all(res.confidence[a] > res.confidence[b]
                  for a, b in zip(ref_res.order[:-1], ref_res.order[1:])
                  if ref_res.confidence[a] - ref_res.confidence[b] > 2 * conf_tol)
    report["dock_plain"] = {"wall_s": ref_wall, "max_abs_pose_diff": pose_err, "pose_tol": POSE_ATOL,
                            "max_abs_conf_diff": conf_err, "conf_tol": conf_tol,
                            "order": ref_res.order.tolist(), "ranking_agrees": rank_ok}
    _log(f"  max |poses(kernel) - poses(plain)| = {pose_err:.3e} A (tol {POSE_ATOL:.0e}); "
         f"max |conf(kernel) - conf(plain)| = {conf_err:.3e} (tol {conf_tol:.3e}); "
         f"order {res.order.tolist()} vs {ref_res.order.tolist()}")
    if not pose_err <= POSE_ATOL:
        raise PhaseError("kernel-path and plain-path poses disagree")
    if not conf_err <= conf_tol:
        raise PhaseError("kernel-path and plain-path confidences disagree")
    if not rank_ok:
        raise PhaseError("kernel-path and plain-path rankings disagree")
    _log(f"[5 dock plain] {ref_wall:.2f} s")
    del ref_pipe

    # 6. timings at the six blocks for every kernel
    t0 = time.perf_counter()
    work = {"fused_tp3": tp3_work, "factored_tp2": tp2_work, "factored_tp1": tp1_work}
    timings = {k: {} for k in kernels}
    with torch.inference_mode():
        for i, (label, (tp, rows, K, Hb)) in enumerate(blocks_all.items()):
            inp = tp_inputs(tp, rows, K, Hb, seed=i, device=dev)
            classes, h_aug, coupled, weights, table = ft.prepare(tp, *inp)
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
            launchers = {"fused_tp3": lambda: ft.launch(h_aug, coupled, weights, table),
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
            del inp, h_aug, coupled, weights, t3, launchers, op2, op1
    report["timings"] = timings
    _log(f"[6 timings] {time.perf_counter() - t0:.1f} s")

    # 7. where a dock's device time goes
    t0 = time.perf_counter()
    report["profile"] = profile_dock(warm, data, aa, P)
    _log(f"[7 profile] 2-step dock with ranking | {time.perf_counter() - t0:.1f} s")

    sources = {"fused_tp3": "diffdock_tpu/ops/pallas_tpconv3.py:57",
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
    return report


def profile_dock(pipe, data, aa, n_poses: int) -> dict:
    """torch.profiler over one warm dock of ``pipe``: device time by
    kernel and the share of the hand-written kernels; the device's busy
    share is taken against the same dock timed without the profiler (whose
    own overhead inflates the traced wall time)."""
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

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    kernels = [(e.key, dev_us(e), e.count) for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA and dev_us(e) > 0]
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


def _block_diag_t3(tp, classes, out_kernel, out_bias):
    """The (H+1, F_tot, W_tot) block-diagonal weight tensor of the TPU
    kernel, for the library yardstick."""
    from diffdock_tpu_torch.ops import fused_tp3 as ft

    blocks = ft.class_weights(tp, classes, out_kernel, out_bias)
    H1 = blocks[0].shape[0]
    f_tot = sum(fan * d3 for _k, _o, fan, d3, _m in classes)
    w_tot = sum(mul * d3 for _k, _o, _f, d3, mul in classes)
    t3 = out_kernel.new_zeros(H1, f_tot, w_tot)
    f_off = w_off = 0
    for (_k, _o, fan, d3, mul), blk in zip(classes, blocks):
        t3[:, f_off:f_off + fan * d3, w_off:w_off + mul * d3] = (
            tp.expand_weight_identity(blk, d3).reshape(H1, fan * d3, mul * d3)
        )
        f_off += fan * d3
        w_off += mul * d3
    return t3


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
