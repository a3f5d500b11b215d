#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``diffdock_tpu_torch``) on one card.

    python3 chip_smoke.py [--poses 10] [--json PATH]

Phases, each timed on its own line:

1. device: the card's name and power limit;
2. build: every hand-written kernel compiled from ``diffdock_tpu_torch/csrc``
   with ``nvcc`` (plain C interface, loaded with ctypes);
3. kernel vs plain: each kernel's wrapper against its plain PyTorch version
   on the card, at the shapes the main path gives it;
4. dock: one score-only DiffDock-L dock (``diffdock_l`` preset at full
   width, random weights from seed 0) of a 32-atom / 320-residue synthetic
   complex, 10 poses, the 20-step recipe with 19 steps. Launch counters are
   zeroed just before and read just after: every kernel of the path must
   have launched, and no plain version may have run. A 2-step dock before
   it pays the first-call set-up, so the dock is timed warm;
5. the same dock through the plain versions with the same noise: the final
   poses must agree;
6. timings: each kernel, its plain version and one PyTorch library call of
   the same function, with CUDA events, beside the least time the card
   could take (bytes over 3.35 TB/s or FLOPs over 67 TFLOP/s float32);
7. profile: ``torch.profiler`` over a warm 2-step dock — device time by
   kernel, the hand-written kernels' share and the device's busy share
   (information only).

It then prints the card line (``nvidia-smi --query-gpu=name,power.limit``),
one JSON line with the kernels' numbers, and, last, the result line
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
the result line; without a CUDA device, or without the package beside
this script, it exits non-zero at once. Nothing runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

F32_PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

# |kernel - plain| <= KERNEL_RTOL * max|plain|: both sum in float32, in
# different orders, over up to K*(H+1) = 46,400 terms per output
KERNEL_RTOL = 1e-4
# max |pose difference| in Angstrom after 19 steps of the kernel path vs
# the plain path from the same noise: float32 reordering only
POSE_ATOL = 5e-3


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


def tp3_inputs(tp, rows: int, K: int, H: int, seed: int, device):
    """Random operands of the fused TP contraction at one block's shape:
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


def tp3_work(tp, rows: int, K: int, H: int):
    """(FLOPs, bytes) the fused contraction must do at least: the
    neighbour reduction P = h_aug^T coupled over every live class, the
    weight contraction over the compact (H+1, fan, mul) blocks, each input
    read once and the output written once (float32)."""
    classes = tp.live_classes()
    Ha = H + 1
    f_tot = sum(fan * d3 for _k, _o, fan, d3, _m in classes)
    w_tot = sum(mul * d3 for _k, _o, _f, d3, mul in classes)
    w_len = sum(Ha * fan * mul for _k, _o, fan, _d, mul in classes)
    flops = 2.0 * rows * Ha * K * f_tot + 2.0 * rows * Ha * sum(
        fan * mul * d3 for _k, _o, fan, d3, mul in classes
    )
    nbytes = 4.0 * (rows * K * Ha + rows * K * f_tot + w_len + rows * w_tot)
    return flops, nbytes


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def expected_tp3_launches(cfg, n_steps: int, n_bonds: int) -> int:
    """Merged TP contractions of one score-only dock: receptor embedding
    once; per step the layer-0 rec<-rec precompute, the ligand embedding
    (bonded + radius blocks), the joint layers (3 ligand blocks each; the
    receptor's cross block, plus its rec<-rec block after layer 0; none in
    the last layer), the center head and the torsion head."""
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


def run(args) -> dict:
    import numpy as np
    import torch

    from diffdock_tpu_torch.data.complexes import bucket_sizes, synthetic_complex
    from diffdock_tpu_torch.diffusion.so3 import get_so3_tables
    from diffdock_tpu_torch.diffusion.torus import get_torus_tables
    from diffdock_tpu_torch.geometry import use_full_fp32
    from diffdock_tpu_torch.inference.pipeline import DockingPipeline
    from diffdock_tpu_torch.inference.sampler import SamplerConfig
    from diffdock_tpu_torch.models.config import PRESETS
    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.utils import build

    report: dict = {"phases": {}}
    dev = torch.device("cuda")
    use_full_fp32()

    # 1. device
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    card = card_line()
    report["device"] = {"name": name, "card": card, "count": torch.cuda.device_count(),
                        "torch": torch.__version__, "cuda": torch.version.cuda}
    _log(f"[1 device] {name} | {card} | torch {torch.__version__} cuda {torch.version.cuda} "
         f"| {time.perf_counter() - t0:.1f} s")

    # 2. build every kernel of the path
    t0 = time.perf_counter()
    ft._get_kernel()
    report["phases"]["build_s"] = time.perf_counter() - t0
    for lib, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  ptxas {lib}: {line.strip()}")
    _log(f"[2 build] fused_tp3 | {report['phases']['build_s']:.1f} s")

    # the complex and the model of the main path
    cfg = PRESETS["diffdock_l"]
    sampler = SamplerConfig()  # 20-step schedule, 19 steps
    rng = np.random.RandomState(0)
    data = synthetic_complex(rng, n_lig=32, n_rec=320, n_bonds=6, lm_dim=cfg.lm_embedding_dim)
    nl, nr, nb = bucket_sizes(data.n_lig, data.n_rec, data.n_bonds)
    P = args.poses
    t0 = time.perf_counter()
    so3 = get_so3_tables(device=dev)
    torus = get_torus_tables(device=dev)
    report["phases"]["tables_s"] = time.perf_counter() - t0
    _log(f"[tables] SO(3) {tuple(so3.score_norms.shape)} + torus {tuple(torus.score_table.shape)} "
         f"| {report['phases']['tables_s']:.1f} s")
    pipe = DockingPipeline(cfg, 0, sampler, so3, torus, device=dev)
    model = pipe.model
    H = 3 * cfg.ns
    k_rec = data.rec_nbr.shape[1]

    # 3. kernel vs plain at the main path's shapes
    t0 = time.perf_counter()
    conv_tp = model.conv_layers[0].tp
    shapes = {
        "rec<-lig cross (conv)": (conv_tp, P * nr, nl),
        "lig<-rec cross (conv)": (conv_tp, P * nl, nr),
        "rec<-rec (rec_emb_2)": (model.rec_emb_layers[-1].tp, nr, k_rec),
    }
    checks = {}
    worst = 0.0
    with torch.inference_mode():
        for i, (label, (tp, rows, K)) in enumerate(shapes.items()):
            inp = tp3_inputs(tp, rows, K, H, seed=i, device=dev)
            got = ft.fused_tp3(tp, *inp)
            ref = ft.fused_tp3_reference(tp, *inp)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            scale = max(ref.abs().max().item(), 1.0)
            ok = bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale
            f_tot = sum(fan * d3 for _k, _o, fan, d3, _m in tp.live_classes())
            checks[label] = {"rows": rows, "K": K, "H": H, "F_tot": f_tot,
                             "W_tot": tp.irreps_out.dim, "max_abs_err": err,
                             "max_abs_ref": scale, "ok": ok}
            worst = max(worst, err)
            _log(f"  {label}: R={rows} K={K} H+1={H + 1} F_tot={f_tot} W_tot={tp.irreps_out.dim} "
                 f"max_abs_err={err:.3e} (tol {KERNEL_RTOL:.0e} x {scale:.3g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise PhaseError(f"fused_tp3 disagrees with its plain version at {label}")
    report["kernel_checks"] = checks
    _log(f"[3 kernel vs plain] fused_tp3 | {time.perf_counter() - t0:.1f} s")

    # warm-up: a 2-step dock pays the first-call set-up (cuBLAS/cuSOLVER
    # handles, lazy module loading) outside the timed dock
    t0 = time.perf_counter()
    warm = DockingPipeline(cfg, 0, SamplerConfig(inference_steps=2, actual_steps=2), so3, torus,
                           device=dev)
    warm.dock_complex(data, num_poses=P, seed=1)
    torch.cuda.synchronize()
    report["phases"]["warmup_s"] = time.perf_counter() - t0
    _log(f"[warm-up] 2-step dock | {report['phases']['warmup_s']:.2f} s")

    # 4. dock one complex through the kernels (the main path)
    noise = pipe.draw_noise(P, nb, seed=0)
    expected = expected_tp3_launches(cfg, sampler.num_steps, nb)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ft.counts.reset()
    t0 = time.perf_counter()
    res = pipe.dock_complex(data, num_poses=P, seed=0, noise=noise)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ft.counts.as_dict()
    peak = torch.cuda.max_memory_allocated()
    report["dock"] = {"wall_s": wall, "poses_per_s": P / wall, "max_memory_allocated": peak,
                      "launches": launches, "expected_fused_tp3": expected,
                      "complex": {"n_lig": data.n_lig, "n_rec": data.n_rec, "n_bonds": data.n_bonds,
                                  "bucket": [nl, nr, nb]},
                      "poses": P, "steps": sampler.num_steps}
    _log(f"  launches {launches} (expected fused_tp3 = {expected}: "
         f"{cfg.num_prot_emb_layers} + {sampler.num_steps} steps x per-step blocks)")
    if res.poses.shape != (P, data.n_lig, 3) or not np.isfinite(res.poses).all():
        raise PhaseError(f"dock gave poses {res.poses.shape}, finite={np.isfinite(res.poses).all()}")
    if launches["fused_tp3"] != expected or launches["fused_tp3_reference"] != 0:
        raise PhaseError(f"launch counts {launches} != expected {expected} kernel / 0 plain")
    _log(f"[4 dock] diffdock_l, {P} poses, {sampler.num_steps} steps | {wall:.2f} s | "
         f"{P / wall:.3f} poses/s | peak {peak / 2**30:.2f} GiB | {card}")

    # 5. the same dock through the plain versions, same noise
    t0 = time.perf_counter()
    ref_pipe = DockingPipeline(cfg, 0, sampler, so3, torus, device=dev, reference_kernels=True)
    ref_res = ref_pipe.dock_complex(data, num_poses=P, seed=0, noise=noise)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    pose_err = float(np.abs(res.poses - ref_res.poses).max())
    report["dock_plain"] = {"wall_s": ref_wall, "max_abs_pose_diff": pose_err, "tol": POSE_ATOL}
    _log(f"  max |poses(kernel) - poses(plain)| = {pose_err:.3e} A (tol {POSE_ATOL:.0e})")
    if not pose_err <= POSE_ATOL:
        raise PhaseError("kernel-path and plain-path poses disagree")
    _log(f"[5 dock plain] {ref_wall:.2f} s")

    # 6. timings at the main path's largest block (receptor receivers of
    # the cross graph), plus the other shapes
    t0 = time.perf_counter()
    timings = {}
    with torch.inference_mode():
        for i, (label, (tp, rows, K)) in enumerate(shapes.items()):
            inp = tp3_inputs(tp, rows, K, H, seed=i, device=dev)
            classes, h_aug, coupled, weights, table = ft.prepare(tp, *inp)
            t3 = _block_diag_t3(tp, classes, inp[4], inp[5])
            kernel_ms = cuda_ms(lambda: ft.launch(h_aug, coupled, weights, table), args.iters)
            wrapper_ms = cuda_ms(lambda: ft.fused_tp3(tp, *inp), args.iters)
            plain_ms = cuda_ms(lambda: ft.fused_tp3_reference(tp, *inp), args.iters)
            library_ms = cuda_ms(
                lambda: torch.einsum("rhF,hFW->rW", torch.einsum("rkh,rkF->rhF", h_aug, coupled), t3),
                args.iters,
            )
            flops, nbytes = tp3_work(tp, rows, K, H)
            b_ms, b_by = bound_ms(flops, nbytes)
            timings[label] = {"ms": kernel_ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                              "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "flops": flops, "bytes": nbytes}
            _log(f"  {label}: kernel {kernel_ms:.4f} ms | wrapper {wrapper_ms:.4f} ms | plain "
                 f"{plain_ms:.4f} ms | library einsum pair {library_ms:.4f} ms | bound {b_ms:.4f} ms "
                 f"({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB) | "
                 f"{flops / kernel_ms / 1e9:.2f} TFLOP/s")
    report["timings"] = timings
    _log(f"[6 timings] {time.perf_counter() - t0:.1f} s")

    # 7. where a dock's device time goes (information only: a missing
    # profiler does not fail the run)
    t0 = time.perf_counter()
    try:
        report["profile"] = profile_dock(warm, data, P)
    except Exception as exc:  # noqa: BLE001 - the run goes on without it
        report["profile"] = {"error": repr(exc)}
        _log(f"  profiler unavailable: {exc!r}")
    _log(f"[7 profile] 2-step dock | {time.perf_counter() - t0:.1f} s")

    main = timings["rec<-lig cross (conv)"]
    report["kernels"] = [{
        "name": "fused_tp3",
        "route": "cuda",
        "source": "diffdock_tpu_torch/csrc/fused_tp3.cu",
        "replaces": "diffdock_tpu/ops/pallas_tpconv3.py:57",
        "launches": launches["fused_tp3"],
        "max_abs_err": worst,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    }]
    return report


def profile_dock(pipe, data, n_poses: int) -> dict:
    """torch.profiler over one warm dock of ``pipe``: device time by
    kernel and the share of the hand-written kernels; the device's busy
    share is taken against the same dock timed without the profiler (whose
    own overhead inflates the traced wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.dock_complex(data, num_poses=n_poses, seed=2)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.dock_complex(data, num_poses=n_poses, seed=2)
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
    ours = sum(k[1] for k in kernels if "fused_tp3" in k[0])
    launches = sum(k[2] for k in kernels)
    out = {"wall_ms_unprofiled": wall_us / 1e3, "device_ms": total / 1e3,
           "device_busy_share": total / wall_us, "fused_tp3_ms": ours / 1e3,
           "fused_tp3_share_of_device": ours / total if total else None,
           "kernel_launches": launches,
           "top": [{"name": k[0][:90], "ms": k[1] / 1e3, "count": k[2]} for k in kernels[:8]]}
    _log(f"  wall {wall_us / 1e3:.1f} ms (unprofiled) | device busy {total / 1e3:.1f} ms "
         f"({100 * out['device_busy_share']:.1f} %) | fused_tp3 {ours / 1e3:.1f} ms "
         f"({100 * (out['fused_tp3_share_of_device'] or 0):.1f} % of device) | {launches} kernel launches")
    for k in out["top"]:
        _log(f"    {k['ms']:9.2f} ms  x{k['count']:<5d} {k['name']}")
    return out


def _block_diag_t3(tp, classes, out_kernel, out_bias):
    """The (H+1, F_tot, W_tot) block-diagonal weight tensor of the TPU
    kernel, for the library yardstick."""
    import torch

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
