"""Time fused_tp3's bfloat16 mode at the seven blocks of ``chip_smoke.py``
phase H1, beside its plain version, the library pair in bfloat16 (cuBLAS)
and its bound, on one CUDA card.

    python scripts/tp3_bf16_blocks.py [--tree DIR] [--iters N] [--only TEXT] [--json PATH]

``--tree`` names a checkout whose ``diffdock_tpu_torch`` is timed (default:
this one), so that two commits can be timed in one session on one card
(run them in turns: old, new, new, old). The blocks are the DiffDock-L score
model's joint-layer TP (rec<-lig 3200 x 32, lig<-rec 320 x 320), its
receptor- and ligand-embedding TP (rec<-rec 320 x 10, lig<-lig 320 x 32) and
the shipped confidence model's widest TP (atom<-lig 25600 x 32, atom<-atom
25600 x 6, lig<-atom 320 x 2560), H = 144 and 72, and the ligand
embedding's first TP (48x0e -> 48x0e + 10x1o) at 640 x 64 and 768 x 96, the
shapes where the plan's ring changed from 3 slots of 64 neighbours to 4 of
32; ``--only`` keeps the blocks whose label holds the text. On the random inputs of
``chip_smoke.tp_inputs`` (block i from seed i). Each row gives the kernel's
largest error against the plain version (as a share of its scale), the
kernel, plain and library times (CUDA events, mean of ``--iters`` after 3
warm-up calls), the bound (bytes over 3.35 TB/s, or both products at 989
TFLOP/s) and the share of it reached. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

SH = "1x0e + 1x1o + 1x2e"
# label -> (ns, nv, reduce_pseudoscalars, ladder, rows, K)
BLOCKS = {
    "rec<-lig cross (conv)": (48, 10, True, (3, 3), 3200, 32),
    "lig<-rec cross (conv)": (48, 10, True, (3, 3), 320, 320),
    "rec<-rec (rec_emb_2)": (48, 10, True, (2, 3), 320, 10),
    "atom<-lig cross (confidence)": (24, 6, False, (3, 3), 25600, 32),
    "atom<-atom (confidence)": (24, 6, False, (3, 3), 25600, 6),
    "lig<-atom cross (confidence)": (24, 6, False, (3, 3), 320, 2560),
    "lig<-lig (lig_emb_2)": (48, 10, True, (2, 3), 320, 32),
    "lig<-lig (lig_emb_0) 640x64": (48, 10, True, (0, 1), 640, 64),
    "lig<-lig (lig_emb_0) 768x96": (48, 10, True, (0, 1), 768, 96),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default="")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from diffdock_tpu_torch.ops import fused_tp3 as ft
    from diffdock_tpu_torch.ops.irreps import get_irrep_seq
    from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16 = torch.bfloat16
    card = cs.card_line()
    rows_out = {}
    with torch.inference_mode():
        for i, (label, (ns, nv, rp, ladder, rows, K)) in enumerate(BLOCKS.items()):
            if args.only not in label:
                continue
            seq = get_irrep_seq(ns, nv, False, rp)
            tp = FullyConnectedTensorProduct(seq[ladder[0]], SH, seq[ladder[1]])
            H = 3 * ns
            inp = cs.tp_inputs(tp, rows, K, H, seed=i, device=dev)
            binp = [a.to(bf16) for a in inp[:4]] + list(inp[4:])
            got = ft.fused_tp3(tp, *binp)
            ref = ft.fused_tp3_reference(tp, *binp)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1.0)
            ops = ft.prepare(tp, *binp)
            classes = ops[0]
            h_aug = torch.cat([binp[2], binp[3][..., None]], dim=-1)
            coupled = ft.merged_coupled(tp, binp[0], binp[1])[1]
            t3 = cs._block_diag_t3(tp, classes, inp[4], inp[5], bf16)
            ms = cs.cuda_ms(lambda: ft.launch(*ops[1:]), args.iters)
            plain_ms = cs.cuda_ms(lambda: ft.fused_tp3_reference(tp, *binp), args.iters)
            library_ms = cs.cuda_ms(lambda: torch.einsum(
                "rhF,hFW->rW", torch.einsum("rkh,rkF->rhF", h_aug, coupled), t3), args.iters)
            flops, nbytes = cs.tp3_bf16_work(tp, rows, K, H)
            t_ops, t_bytes = flops / cs.BF16_PEAK_FLOPS * 1e3, nbytes / cs.HBM_BYTES_PER_S * 1e3
            b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
            plan = ft.bf16_plan(ops[4], rows, K, H)
            rows_out[label] = {"rows": rows, "K": K, "H": H, "KC": plan.KC, "S": plan.S,
                               "whole": bool(plan.whole), "err_of_scale": err, "ms": ms,
                               "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "bound_share": b_ms / ms,
                               "tflops": flops / ms / 1e9}
            print(f"{label:30s} R={rows:5d} K={K:4d} H+1={H + 1} (plan {plan.KC} x {plan.S} slots): "
                  f"err {err:.2e} of scale | kernel "
                  f"{ms:.4f} ms | plain {plain_ms:.4f} | cuBLAS pair {library_ms:.4f} | bound "
                  f"{b_ms:.4f} ({b_by}) | {100 * b_ms / ms:.1f} % of bound | "
                  f"{flops / ms / 1e9:.2f} TFLOP/s", flush=True)
            del inp, binp, got, ref, ops, h_aug, coupled, t3
    report = {"tree": os.path.abspath(args.tree), "card": card, "blocks": rows_out}
    print(f"card: {card}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
