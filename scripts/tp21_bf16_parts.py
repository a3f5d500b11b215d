"""Where the time of the bfloat16 kernel of gens 2 and 1 goes, on one CUDA card.

    python scripts/tp21_bf16_parts.py [--iters N] [--json PATH]

Builds ``csrc/factored_tp_bf16.cu`` as it is and in four edited copies,
each with one part taken out (its results are then wrong, and only timed):

* ``no_chain``: the coupled columns' chains (the tile keeps stale values);
* ``no_build``: the whole coupling, CG weights and chains;
* ``no_weights``: the weight product and its weight stream;
* ``no_refetch``: the stages of every slice after a block's first (its
  ``[sh | x]`` rows, ``h`` and ``mw``, which each slice fetches again); the
  consumers read what the slot holds. The whole kernel's time less this
  copy's is what a design that fetches each receiver's stage once for all
  its slices could save at most,

and times gen 2 with each at the seven blocks of ``chip_smoke.py`` phase I1
(inputs as ``scripts/tp21_blocks.py``; CUDA events, mean of ``--iters``
launches after 3 warm-up calls), with the plan of each block. The whole
kernel's time less a copy's is that part's share. Exits non-zero without
a card, or when the unedited kernel disagrees with its plain version (1e-3
of scale).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "diffdock_tpu_torch" / "csrc" / "factored_tp_bf16.cu"
# (text in the kernel, its replacement) per copy
PARTS = {
    "no_chain": [("      if (c_k0 < c_step) {\n", "      if (c_k0 < c_step && KC < 0) {\n")],
    "no_build": [("      build(stp + p.x_off);", "      fence_async_smem();")],
    "no_weights": [
        ("    const int n_passes = (n_tiles + 2 * kTB - 1) / (2 * kTB);", "    const int n_passes = 0;"),
        ("      const int n_passes = (n_m * n_n + 2 * kTB - 1) / (2 * kTB);",
         "      const int n_passes = 0;"),
    ],
    "no_refetch": [("        mbar_arrive_expect_tx(&full[slot], stage_tx);\n",
                    "        if (sj > 0) {\n          mbar_arrive(&full[slot]);\n          continue;\n"
                    "        }\n        mbar_arrive_expect_tx(&full[slot], stage_tx);\n")],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from diffdock_tpu_torch.ops import factored_tp2 as f2
    from diffdock_tpu_torch.ops.irreps import get_irrep_seq
    from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct
    from diffdock_tpu_torch.utils import build
    from scripts.tp21_blocks import BLOCKS, SH

    text = SOURCE.read_text()
    work = Path(tempfile.mkdtemp(prefix="tp21_parts_"))

    def compile_copy(name):
        s = text
        for old, new in PARTS[name]:
            if s.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel no longer holds {old!r}")
            s = s.replace(old, new)
        src = SOURCE.parent / f"_parts_{name}.cu"  # beside its headers
        src.write_text(s)
        try:
            lib = work / f"lib{name}.so"
            subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                           check=True, capture_output=True, text=True)
        finally:
            src.unlink()
        return name, lib

    with ThreadPoolExecutor(len(PARTS)) as pool:
        copies = dict(pool.map(compile_copy, PARTS))
    kern = f2._get_kernel()
    libs = {"whole": kern.bf16, **{n: f2.Bf16Library(ctypes.CDLL(str(p))) for n, p in copies.items()}}
    dev = torch.device("cuda")
    card = cs.card_line()
    rows_out, bad = {}, []
    with torch.inference_mode():
        for i, (label, (ns, nv, rp, ladder, rows, K)) in enumerate(BLOCKS.items()):
            seq = get_irrep_seq(ns, nv, False, rp)
            tp = FullyConnectedTensorProduct(seq[ladder[0]], SH, seq[ladder[1]])
            H = 3 * ns
            inp = cs.tp_inputs(tp, rows, K, H, seed=i, device=dev)
            binp = [a.to(torch.bfloat16) for a in inp[:4]] + list(inp[4:])
            ops = f2.prepare(tp, *binp)
            call = ops[-1]
            plan = f2.bf16_plan(call.slices, rows, K, H, call.F, call.J, call.sh_f32, call.parts,
                                torch.cuda.get_device_properties(dev).multi_processor_count)
            out = {}
            for name, lib in libs.items():
                kern.bf16 = lib
                if name == "whole":
                    ref = f2.factored_tp_bf16_reference(tp, *binp, gen=2)
                    got = f2.launch(*ops, tp.irreps_out.dim)
                    err = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1.0)
                    if not err <= 1e-3:
                        bad.append((label, err))
                out[name] = cs.cuda_ms(lambda: f2.launch(*ops, tp.irreps_out.dim), args.iters)
            kern.bf16 = libs["whole"]
            rows_out[label] = {"rows": rows, "K": K, "H": H, "ms": out,
                               "plan": {"R": plan.R, "whole": plan.whole, "k_parts": plan.k_parts,
                                        "KC": plan.KC, "S": plan.S, "blocks": plan.n_blocks}}
            print(f"{label:30s} " + " | ".join(f"{k} {v:.4f} ms" for k, v in out.items())
                  + f" | R={plan.R} KC={plan.KC} S={plan.S} k_parts={plan.k_parts} "
                  f"{'all slices' if plan.whole else 'one class'} per block", flush=True)
            del inp, binp, ops
    print(f"card: {card}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "blocks": rows_out}, indent=1))
    if bad:
        print(f"the kernel disagrees with its plain version: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
