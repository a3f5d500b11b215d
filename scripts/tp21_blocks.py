"""Time the gen-2 and gen-1 kernels (``factored_tp2``, ``factored_tp1``) at
the seven blocks of ``chip_smoke.py`` phase H1, in float32 and, where the
tree has it, in bfloat16, on one CUDA card.

    python scripts/tp21_blocks.py [--tree DIR] [--iters N] [--modes M,...] [--json PATH]

``--tree`` names a checkout whose ``diffdock_tpu_torch`` is timed (default:
this one), so that two commits can be timed in one run on one card
(run them in turns: old, new, new, old). The blocks and inputs are those of
``scripts/tp3_bf16_blocks.py`` (block i from seed i). Each row gives the
kernel's largest error against its plain version (as a share of its
scale) and the kernel's time (CUDA events, mean of ``--iters`` launches of
``launch`` on prepared operands after 3 warm-up calls), per mode
(``--modes``: float32, bfloat16 or both, the default), and in
bfloat16 also the whole call's (the wrapper: ``prepare`` and ``launch``).
Exits
non-zero without a card or when a kernel disagrees with its plain version
(1e-4 of scale in float32, 1e-3 in bfloat16).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

SH = "1x0e + 1x1o + 1x2e"
# label -> (ns, nv, reduce_pseudoscalars, ladder, rows, K), as tp3_bf16_blocks.py
BLOCKS = {
    "rec<-lig cross (conv)": (48, 10, True, (3, 3), 3200, 32),
    "lig<-rec cross (conv)": (48, 10, True, (3, 3), 320, 320),
    "rec<-rec (rec_emb_2)": (48, 10, True, (2, 3), 320, 10),
    "atom<-lig cross (confidence)": (24, 6, False, (3, 3), 25600, 32),
    "atom<-atom (confidence)": (24, 6, False, (3, 3), 25600, 6),
    "lig<-atom cross (confidence)": (24, 6, False, (3, 3), 320, 2560),
    "lig<-lig (lig_emb_2)": (48, 10, True, (2, 3), 320, 32),
}
RTOL = {"float32": 1e-4, "bfloat16": 1e-3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--modes", default="float32,bfloat16")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2
    from diffdock_tpu_torch.ops.irreps import get_irrep_seq
    from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    has_bf16 = hasattr(f2, "factored_tp_bf16_reference")
    card = cs.card_line()
    rows_out = {}
    bad = []
    with torch.inference_mode():
        for i, (label, (ns, nv, rp, ladder, rows, K)) in enumerate(BLOCKS.items()):
            seq = get_irrep_seq(ns, nv, False, rp)
            tp = FullyConnectedTensorProduct(seq[ladder[0]], SH, seq[ladder[1]])
            H = 3 * ns
            inp = cs.tp_inputs(tp, rows, K, H, seed=i, device=dev)
            modes = {"float32": inp}
            if has_bf16:
                modes["bfloat16"] = [a.to(torch.bfloat16) for a in inp[:4]] + list(inp[4:])
            modes = {k: v for k, v in modes.items() if k in args.modes.split(",")}
            out = {}
            for mode, a in modes.items():
                for gen, m in ((2, f2), (1, f1)):
                    ops = m.prepare(tp, *a)
                    got = m.launch(*ops, tp.irreps_out.dim)
                    ref = (f2.factored_tp_bf16_reference(tp, *a, gen=gen) if mode == "bfloat16"
                           else f2.factored_tp_reference(tp, *a))
                    torch.cuda.synchronize()
                    err = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1.0)
                    ms = cs.cuda_ms(lambda: m.launch(*ops, tp.irreps_out.dim), args.iters)
                    out[f"gen{gen}_{mode}"] = {"err_of_scale": err, "ms": ms}
                    if mode == "bfloat16":
                        fn = f2.factored_tp2 if gen == 2 else f1.factored_tp1
                        out[f"gen{gen}_{mode}"]["wrapper_ms"] = cs.cuda_ms(lambda: fn(tp, *a),
                                                                           args.iters)
                    if not err <= RTOL[mode]:
                        bad.append((label, gen, mode, err))
                    del ops, got, ref
            rows_out[label] = {"rows": rows, "K": K, "H": H, **out}
            print(f"{label:30s} R={rows:5d} K={K:4d} H+1={H + 1}: " + " | ".join(
                f"{k} {v['ms']:.4f} ms" + (f" (call {v['wrapper_ms']:.4f})" if "wrapper_ms" in v else "")
                + f" (err {v['err_of_scale']:.1e})" for k, v in out.items()),
                flush=True)
            del inp, modes
    report = {"tree": os.path.abspath(args.tree), "card": card, "blocks": rows_out}
    print(f"card: {card}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    if bad:
        print(f"kernels disagree with their plain versions: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
