"""The port's hand-written CUDA kernels on the card (marker ``cuda``).

A CUDA kernel has no CPU mode: these tests build ``diffdock_tpu_torch/csrc``
with nvcc and compare each kernel with its plain PyTorch version on the
card. They decide inside the test whether a card is present and skip
otherwise. On a machine with one:

    python -m pytest tests/ -m cuda -k test_torch_port
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
from diffdock_tpu_torch.models.config import PRESETS
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.ops.irreps import get_irrep_seq
from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct

pytestmark = pytest.mark.cuda

SH = "1x0e + 1x1o + 1x2e"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(tp, rows, K, H, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    mw = (torch.rand(rows, K, generator=g, device=dev) < 0.7).float()
    x = torch.randn(rows, K, tp.irreps_in1.dim, generator=g, device=dev)
    sh = torch.randn(rows, K, tp.irreps_in2.dim, generator=g, device=dev)
    h = torch.relu(torch.randn(rows, K, H, generator=g, device=dev)) * mw[..., None]
    wk = torch.randn(H, tp.weight_numel, generator=g, device=dev) / math.sqrt(H)
    wb = torch.randn(tp.weight_numel, generator=g, device=dev) * 0.1
    return x, sh, h, mw, wk, wb


# the main path's blocks (3200 rows of the joint layers; K = 320 and
# K = 2560 at 320 rows, the lig<-rec and confidence lig<-atom blocks) and
# ragged rows, neighbours and hidden rows (H+1 = 145, 73 and others)
@pytest.mark.parametrize("ladder,rows,K,H1", [
    ((3, 3), 3200, 32, 145), ((3, 3), 67, 32, 145), ((3, 3), 13, 320, 145),
    ((2, 3), 40, 10, 145), ((0, 1), 5, 1, 145), ((3, 3), 2, 35, 145),
    ((3, 3), 320, 2560, 73), ((3, 3), 37, 33, 73), ((2, 3), 9, 7, 17),
    ((3, 3), 1, 1, 33), ((1, 2), 1001, 6, 16), ((3, 3), 61, 129, 100),
])
def test_fused_tp3_kernel_matches_plain_version(ladder, rows, K, H1):
    dev = _card()
    cfg = PRESETS["diffdock_l"]
    seq = get_irrep_seq(cfg.ns, cfg.nv, False, cfg.reduce_pseudoscalars)
    tp = FullyConnectedTensorProduct(seq[ladder[0]], SH, seq[ladder[1]])
    args = _inputs(tp, rows, K, H1 - 1, dev)
    before = ft.counts["fused_tp3"]
    out = ft.fused_tp3(tp, *args)
    ref = ft.fused_tp3_reference(tp, *args)
    torch.cuda.synchronize()
    assert ft.counts["fused_tp3"] == before + 1
    scale = max(ref.abs().max().item(), 1.0)
    assert (out - ref).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("irreps_out", ["256x0e", "85x1o + 3x0e", "51x2e + 4x0e"])
def test_fused_tp3_takes_a_class_of_256_outputs(irreps_out):
    """mul*d3 = 256 (and 255 at d3 = 3 and 5), the widest class a block
    takes; at d3 = 5 the weight product takes its path for many tiles."""
    dev = _card()
    tp = FullyConnectedTensorProduct("4x0e + 2x1o", "1x0e + 1x1o", irreps_out)
    args = _inputs(tp, 19, 9, 40, dev, seed=3)
    out = ft.fused_tp3(tp, *args)
    ref = ft.fused_tp3_reference(tp, *args)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4 * max(ref.abs().max().item(), 1.0)


def test_fused_tp3_two_launches_are_bit_identical():
    """No sum depends on scheduling: the same inputs give the same bits."""
    dev = _card()
    cfg = PRESETS["diffdock_l"]
    seq = get_irrep_seq(cfg.ns, cfg.nv, False, cfg.reduce_pseudoscalars)
    tp = FullyConnectedTensorProduct(seq[3], SH, seq[3])
    args = _inputs(tp, 320, 320, 3 * cfg.ns, dev, seed=4)
    first = ft.fused_tp3(tp, *args)
    second = ft.fused_tp3(tp, *args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fused_tp3_zero_fills_empty_classes_on_the_card():
    dev = _card()
    tp = FullyConnectedTensorProduct("4x0e + 2x1o", "1x0e + 1x1o", "4x0e + 3x2o + 2x1o")
    args = _inputs(tp, 9, 5, 6, dev, seed=1)
    out = ft.fused_tp3(tp, *args)
    ref = ft.fused_tp3_reference(tp, *args)
    torch.cuda.synchronize()
    assert torch.all(out[:, 4:19] == 0)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5, atol=1e-5)


# the cells' largest blocks (bucket (32, 1536) at 10 poses: 320 ligand and
# 15,360 receptor rows; the confidence model's 8,704 receptor atoms): the
# score models' rec<-lig (15360 x 32), lig<-rec (320 x 1536) and rec<-rec
# (15360 x 24); the confidence model's lig<-atom (320 x 8704) and
# atom<-atom (87040 x 8)
MODEL_TPS = chip_smoke.model_tps()
CELL_BLOCKS = {"score": [(15360, 32), (320, 1536), (15360, 24)],
               "confidence": [(320, 8704), (87040, 8)]}


@pytest.mark.parametrize("where,key,rows,K", [
    (where, key, rows, K) for where, key in MODEL_TPS
    for rows, K in CELL_BLOCKS["confidence" if where.startswith("confidence") else "score"]
], ids=lambda v: v if isinstance(v, str) else None)
def test_fused_tp3_matches_plain_version_at_every_model_tp(where, key, rows, K):
    """The float32 kernel, which builds the coupling itself, against the
    plain version at every TP the cells run (H+1 = 145, 97 and 73) and the
    cells' largest blocks; one launch counted per call."""
    dev = _card()
    ins, shs, outs, H = key
    tp = FullyConnectedTensorProduct(ins, shs, outs)
    args = _inputs(tp, rows, K, H, dev, seed=rows + K)
    before = ft.counts["fused_tp3"]
    out = ft.fused_tp3(tp, *args)
    assert ft.counts["fused_tp3"] == before + 1
    ref = ft.fused_tp3_reference(tp, *args)
    torch.cuda.synchronize()
    scale = max(ref.abs().max().item(), 1.0)
    assert (out - ref).abs().max().item() <= 1e-4 * scale


def test_fused_tp3_zero_fills_an_empty_class_through_the_reduce():
    """An empty class beside classes of several slices and two hidden
    groups: the fixed-order reduce writes its zeros."""
    dev = _card()
    tp = FullyConnectedTensorProduct("48x0e + 10x1o", "1x0e + 1x1o", "48x0e + 3x2o + 10x1o")
    plan = ft.tile_plan(ft.tp_geometry(tp), 144)
    assert plan.n_groups * plan.s_max > 1 and plan.n_slices[1] == 0
    args = _inputs(tp, 75, 19, 144, dev, seed=7)
    out = ft.fused_tp3(tp, *args)
    ref = ft.fused_tp3_reference(tp, *args)
    torch.cuda.synchronize()
    assert torch.all(out[:, 48:63] == 0)
    assert (out - ref).abs().max().item() <= 1e-4 * max(ref.abs().max().item(), 1.0)


def test_fused_tp3_reads_strided_operands_in_place():
    """Views whose rows are not packed (a wider buffer's columns, a
    transposed receiver axis) give the result of their contiguous copies."""
    dev = _card()
    tp = _joint_tp()
    x, sh, h, mw, wk, wb = _inputs(tp, 70, 13, 144, dev, seed=8)
    wide = lambda t: torch.cat([t, torch.ones_like(t[..., :3])], dim=-1)[..., :t.shape[-1]]
    views = (wide(x), wide(sh), h.transpose(0, 1).contiguous().transpose(0, 1),
             mw.t().contiguous().t(), wk, wb)
    assert not any(v.is_contiguous() for v in views[:4])
    got = ft.fused_tp3(tp, *views)
    want = ft.fused_tp3(tp, x, sh, h, mw, wk, wb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_fused_tp3_contraction_is_its_kernel_alone():
    """Under the profiler, one merged contraction's ``tp_contract`` range
    holds no torch op but the output's and scratch's allocation, and at most
    2 device kernels (the kernel and its reduce), both fused_tp3's."""
    from diffdock_tpu_torch.models.encoders import FCBlock
    from diffdock_tpu_torch.models.tpconv import NeighborBlock, _tp_message_reduced

    dev = _card()
    tp = _joint_tp()
    B, R, K, S, E = 10, 32, 24, 150, 32
    g = torch.Generator(device=dev).manual_seed(9)
    fc = FCBlock(E, 3 * 48, tp.weight_numel).to(dev)
    blk = NeighborBlock(torch.randn(1, S, tp.irreps_in1.dim, device=dev, generator=g),
                        torch.randint(0, S, (B, R, K), device=dev, generator=g),
                        torch.rand(B, R, K, device=dev, generator=g) < 0.8,
                        torch.randn(B, R, K, E, device=dev, generator=g),
                        torch.randn(B, R, K, tp.irreps_in2.dim, device=dev, generator=g))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        _tp_message_reduced(tp, fc, blk)  # the plan, the tables and the CG matrix, once
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            _tp_message_reduced(tp, fc, blk)
            torch.cuda.synchronize()
    # the profiler's raw events: the range on the host (it is mirrored on
    # the device timeline), what the host did inside it, the device kernels
    raw = list(prof.profiler.kineto_results.events())
    host = [e for e in raw if e.device_type() != torch.autograd.DeviceType.CUDA]
    contract = [e for e in host if e.name() == "tp_contract"]
    assert len(contract) == 1
    lo = contract[0].start_ns()
    hi = lo + contract[0].duration_ns()
    inside = [e.name() for e in host if lo < e.start_ns() < hi]
    assert {n for n in inside if n.startswith("aten::")} <= {"aten::empty"}, inside
    assert len([n for n in inside if n.startswith(("cudaLaunch", "cuLaunch"))]) <= 2, inside
    # the kernel and its reduce, launched from the kernel library (which the
    # profiler may not tie to the range), are the profile's only fused_tp3
    # kernels
    kernels = [e.name() for e in raw if e.device_type() == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation() and "fused_tp3" in e.name()]
    assert 1 <= len(kernels) <= 2, kernels


# the six timed blocks (chip_smoke.py phase 6): the score model's rec<-lig
# cross (3200, 32) and lig<-rec cross (320, 320) of the joint conv layers
# and rec<-rec of rec_emb_2 (320, 10), at H+1 = 145; the confidence
# model's (its widest TP, H+1 = 73) atom<-lig (25600, 32), atom<-atom
# (25600, 6) and lig<-atom (320, 2560); plus ragged rows, neighbours and
# hidden rows
GEN21_BLOCKS = [
    ("diffdock_l", (3, 3), 3200, 32, 145), ("diffdock_l", (3, 3), 320, 320, 145),
    ("diffdock_l", (2, 3), 320, 10, 145), ("diffdock_l", (3, 3), 37, 33, 145),
    ("diffdock_l", (2, 3), 1, 7, 145),
    ("confidence", (3, 3), 25600, 32, 73), ("confidence", (3, 3), 25600, 6, 73),
    ("confidence", (3, 3), 320, 2560, 73), ("confidence", (3, 3), 45, 129, 73),
    ("diffdock_l", (3, 3), 19, 1, 17), ("confidence", (1, 2), 1001, 6, 16),
    ("diffdock_l", (3, 3), 61, 35, 100),
]


def _gen21_tp(model, ladder):
    if model == "diffdock_l":
        cfg = PRESETS["diffdock_l"]
        seq = get_irrep_seq(cfg.ns, cfg.nv, False, cfg.reduce_pseudoscalars)
    else:  # the shipped confidence model's width (chip_smoke.SHIPPED_CONFIDENCE)
        seq = get_irrep_seq(24, 6, False, False)
    return FullyConnectedTensorProduct(seq[ladder[0]], SH, seq[ladder[1]])


@pytest.mark.parametrize("model,ladder,rows,K,H1", GEN21_BLOCKS)
def test_factored_tp2_kernel_matches_plain_version(model, ladder, rows, K, H1):
    from diffdock_tpu_torch.ops import factored_tp2 as f2

    dev = _card()
    tp = _gen21_tp(model, ladder)
    args = _inputs(tp, rows, K, H1 - 1, dev)
    before = f2.counts["factored_tp2"]
    out = f2.factored_tp2(tp, *args)
    ref = f2.factored_tp_reference(tp, *args)
    torch.cuda.synchronize()
    assert f2.counts["factored_tp2"] == before + 1
    scale = max(ref.abs().max().item(), 1.0)
    assert (out - ref).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("model,ladder,rows,K,H1", GEN21_BLOCKS)
def test_factored_tp1_kernel_matches_plain_version(model, ladder, rows, K, H1):
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops.factored_tp2 import factored_tp_reference

    dev = _card()
    tp = _gen21_tp(model, ladder)
    args = _inputs(tp, rows, K, H1 - 1, dev, seed=1)
    before = f1.counts["factored_tp1"]
    out = f1.factored_tp1(tp, *args)
    ref = factored_tp_reference(tp, *args)
    torch.cuda.synchronize()
    assert f1.counts["factored_tp1"] == before + 1
    scale = max(ref.abs().max().item(), 1.0)
    assert (out - ref).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("gen", [2, 1])
def test_factored_kernels_two_launches_are_bit_identical(gen):
    """No sum depends on scheduling: the same inputs give the same bits
    (lig<-rec: several slices and hidden groups, summed through scratch)."""
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2

    dev = _card()
    tp = _gen21_tp("diffdock_l", (3, 3))
    args = _inputs(tp, 320, 320, 144, dev, seed=4)
    fn = f2.factored_tp2 if gen == 2 else f1.factored_tp1
    first = fn(tp, *args)
    second = fn(tp, *args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("gen", [2, 1])
@pytest.mark.parametrize("irreps_out", ["256x0e", "85x1o + 3x0e", "51x2e + 4x0e"])
def test_factored_kernels_take_a_class_of_256_outputs(gen, irreps_out):
    """mul*d3 = 256 (and 255 at d3 = 3 and 5), the widest class a block
    takes; at d3 = 5 the weight product takes its path for many tiles."""
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2

    dev = _card()
    tp = FullyConnectedTensorProduct("4x0e + 2x1o", "1x0e + 1x1o", irreps_out)
    args = _inputs(tp, 19, 9, 40, dev, seed=3)
    out = (f2.factored_tp2 if gen == 2 else f1.factored_tp1)(tp, *args)
    ref = f2.factored_tp_reference(tp, *args)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4 * max(ref.abs().max().item(), 1.0)


@pytest.mark.parametrize("gen", [2, 1])
@pytest.mark.parametrize("model,ladder,rows,K,H1", GEN21_BLOCKS)
def test_factored_kernels_bf16_match_their_plain_version(gen, model, ladder, rows, K, H1):
    """The bfloat16 modes against ``factored_tp_bf16_reference`` on the
    card, within 1e-3 of scale (one bfloat16 ulp of P at a tie); gen 1
    also with float32 edge_sh, h and mw (its mixed case: two TF32 passes
    for the hidden operand); the same bits from a second launch."""
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2

    dev = _card()
    tp = _gen21_tp(model, ladder)
    x, sh, h, mw, wk, wb = _inputs(tp, rows, K, H1 - 1, dev, seed=5)
    m, fn = (f2, f2.factored_tp2) if gen == 2 else (f1, f1.factored_tp1)
    cases = [(x.bfloat16(), sh.bfloat16(), h.bfloat16(), mw.bfloat16(), wk, wb)]
    if gen == 1:
        cases.append((x.bfloat16(), sh, h, mw, wk, wb))
    for args in cases:
        before = m.counts[f"factored_tp{gen}_bf16"]
        out = fn(tp, *args)
        again = fn(tp, *args)
        ref = f2.factored_tp_bf16_reference(tp, *args, gen=gen)
        torch.cuda.synchronize()
        assert m.counts[f"factored_tp{gen}_bf16"] == before + 2
        assert out.dtype == torch.float32 and torch.equal(out, again)
        assert (out - ref).abs().max().item() <= 1e-3 * max(ref.abs().max().item(), 1.0)


@pytest.mark.parametrize("ins,outs,H", [("48x0e", "48x0e + 10x1o", 144),
                                        ("8x0e + 2x1o + 2x1e", "8x0e + 2x1o + 2x1e + 2x0o", 24),
                                        ("8x0e + 2x1o + 2x1e", "8x0e + 2x1o + 2x1e + 2x0o", 23)])
def test_factored_tp1_bf16_chain_f32_and_widened_hidden_rows(ins, outs, H):
    """Gen 1's bfloat16 mode where a class has one path and d3 = 1 (the
    chain's last step in float32: the coupled columns take their split),
    with bfloat16 h and mw, a bfloat16 h beside a float32 mw, and an odd H
    (both widened to float32 by prepare), against its plain version."""
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2

    dev = _card()
    tp = FullyConnectedTensorProduct(ins, SH, outs)
    x, sh, h, mw, wk, wb = _inputs(tp, 301, 19, H, dev, seed=6)
    for args in ((x.bfloat16(), sh.bfloat16(), h.bfloat16(), mw.bfloat16(), wk, wb),
                 (x.bfloat16(), sh, h.bfloat16(), mw, wk, wb)):
        before = f1.counts["factored_tp1_bf16"]
        out = f1.factored_tp1(tp, *args)
        ref = f2.factored_tp_bf16_reference(tp, *args, gen=1)
        torch.cuda.synchronize()
        assert f1.counts["factored_tp1_bf16"] == before + 1
        assert (out - ref).abs().max().item() <= 1e-3 * max(ref.abs().max().item(), 1.0)


def test_factored_tp2_gradient_on_the_card():
    """The backward differentiates the plain version, on the card as on the CPU."""
    from diffdock_tpu_torch.ops import factored_tp2 as f2

    dev = _card()
    tp = FullyConnectedTensorProduct("8x0e + 4x1o + 4x1e + 4x0o", SH, "8x0e + 4x1o + 4x1e + 4x0o")
    args = list(_inputs(tp, 19, 6, 16, dev, seed=2))
    for i in (2, 4):
        args[i].requires_grad_(True)
    g = torch.autograd.grad((f2.factored_tp2(tp, *args) ** 2).sum(), [args[2], args[4]])
    g_ref = torch.autograd.grad((f2.factored_tp_reference(tp, *args) ** 2).sum(), [args[2], args[4]])
    for a, b in zip(g, g_ref):
        assert (a - b).abs().max().item() <= 1e-4 * max(b.abs().max().item(), 1.0)


def test_factored_kernels_refuse_an_empty_class_on_the_card():
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2

    dev = _card()
    tp = FullyConnectedTensorProduct("4x0e", "1x0e + 1x1o + 1x2e", "4x0e + 2x1o + 2x1e")
    args = _inputs(tp, 5, 3, 6, dev)
    for fn in (f2.factored_tp2, f1.factored_tp1):
        with pytest.raises(ValueError, match="output class 2 "):
            fn(tp, *args)


def test_fused_tp3_refuses_a_class_wider_than_a_block():
    """A class with more outputs (mul*d3) than a block has threads is
    refused with a clear error, not launched."""
    dev = _card()
    tp = FullyConnectedTensorProduct("4x0e", "1x0e", "300x0e")
    args = _inputs(tp, 3, 2, 5, dev)
    with pytest.raises(ValueError, match="mul\\*d3 = 300 outputs"):
        ft.fused_tp3(tp, *args)


# the bfloat16 mode at the joint layers' TP: the main path's rec<-lig
# block, ragged rows, long and short neighbour lists, H+1 = 145, 73, 17
@pytest.mark.parametrize("rows,K,H1", [(3200, 32, 145), (67, 33, 73), (13, 320, 145), (9, 7, 17),
                                       (320, 2560, 73)])
def test_fused_tp3_bf16_kernel_matches_plain_version(rows, K, H1):
    """The kernel's bfloat16 mode against the bfloat16 plain version: within
    1e-3 of scale, since both round P to bfloat16 after float32 sums taken
    in different orders (an element at a rounding tie lands one bfloat16
    ulp apart)."""
    dev = _card()
    cfg = PRESETS["diffdock_l"]
    seq = get_irrep_seq(cfg.ns, cfg.nv, False, cfg.reduce_pseudoscalars)
    tp = FullyConnectedTensorProduct(seq[3], SH, seq[3])
    x, sh, h, mw, wk, wb = _inputs(tp, rows, K, H1 - 1, dev, seed=1)
    args = [a.to(torch.bfloat16) for a in (x, sh, h, mw)] + [wk, wb]
    before = ft.counts.as_dict()
    out = ft.fused_tp3(tp, *args)
    ref = ft.fused_tp3_reference(tp, *args)
    torch.cuda.synchronize()
    after = ft.counts.as_dict()
    assert after["fused_tp3_bf16"] == before["fused_tp3_bf16"] + 1
    assert after["fused_tp3"] == before["fused_tp3"]
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-3 * max(ref.abs().max().item(), 1.0)


def _bf16_args(tp, rows, K, H1, dev, seed=2):
    x, sh, h, mw, wk, wb = _inputs(tp, rows, K, H1 - 1, dev, seed=seed)
    return [a.to(torch.bfloat16) for a in (x, sh, h, mw)] + [wk, wb]


def _joint_tp(ladder=(3, 3)):
    cfg = PRESETS["diffdock_l"]
    seq = get_irrep_seq(cfg.ns, cfg.nv, False, cfg.reduce_pseudoscalars)
    return FullyConnectedTensorProduct(seq[ladder[0]], SH, seq[ladder[1]])


# one case per edge of the kernel's TMA loads: h rows of 99 (not a multiple
# of 8: prepare pads them), the rec_emb_1 TP's 292 coupled columns (padded
# likewise), and the joint layers' TP, whose fourth slice starts on column
# 175 (its box starts on column 168)
@pytest.mark.parametrize("edge,ladder,rows,K,H1", [
    ("h", (3, 3), 61, 35, 100), ("coupled", (1, 2), 37, 19, 145), ("odd column", (3, 3), 29, 21, 145),
])
def test_fused_tp3_bf16_at_the_tma_edges(edge, ladder, rows, K, H1):
    dev = _card()
    tp = _joint_tp(ladder)
    table = ft.bf16_class_table(tp.live_classes(), H1)
    f_tot = int(table[-1, 0] + table[-1, 1] * table[-1, 2])
    plan = ft.bf16_plan(table, rows, K, H1 - 1)
    present = {"h": (H1 - 1) % 8 != 0, "coupled": f_tot % 8 != 0,
               "odd column": any(sl.f_col % 2 for sl in plan.slices)}
    assert present[edge]
    args = _bf16_args(tp, rows, K, H1, dev)
    before = ft.counts["fused_tp3_bf16"]
    out = ft.fused_tp3(tp, *args)
    ref = ft.fused_tp3_reference(tp, *args)
    torch.cuda.synchronize()
    assert ft.counts["fused_tp3_bf16"] == before + 1
    assert (out - ref).abs().max().item() <= 1e-3 * max(ref.abs().max().item(), 1.0)


def test_fused_tp3_bf16_at_the_v1_score_models_first_tp():
    """The v1.0 score model's first TP (48x0e -> 48x0e + 10x1o) at its
    rec<-lig block of a (64, 448) bucket, 10 poses: with every slice in one
    block, a ring of 3 slots failed there (cudaError 719); the plan now
    takes an even ring."""
    dev = _card()
    tp = FullyConnectedTensorProduct("48x0e", SH, "48x0e + 10x1o")
    plan = ft.bf16_plan(ft.bf16_class_table(tp.live_classes(), 145), 4480, 64, 144)
    assert plan.whole and plan.S % 2 == 0
    args = _bf16_args(tp, 4480, 64, 145, dev)
    out = ft.fused_tp3(tp, *args)
    ref = ft.fused_tp3_reference(tp, *args)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-3 * max(ref.abs().max().item(), 1.0)


def test_fused_tp3_bf16_at_the_ligand_embeddings_first_tp_with_one_slice_per_block():
    """DiffDock-L's first ligand-embedding TP (48x0e -> 48x0e + 10x1o) at 8
    poses of the cover ladder's (96, 2304) bucket: 768 rows of 96
    neighbours, one slice per block. A ring of 3 slots hung here now and
    then inside a dock (cudaError 719), rarely enough that launches of this
    TP alone did not show it; so this test checks the plan (an even ring)
    and that 50 launches give the same bits, not the hang itself (the CPU
    search of the ring protocol in test_torch_port_tp3_bf16_tiles.py shows
    why an odd ring hangs)."""
    dev = _card()
    tp = FullyConnectedTensorProduct("48x0e", SH, "48x0e + 10x1o")
    plan = ft.bf16_plan(ft.bf16_class_table(tp.live_classes(), 145), 768, 96, 144)
    assert not plan.whole and plan.S % 2 == 0
    args = _bf16_args(tp, 768, 96, 145, dev)
    ref = ft.fused_tp3_reference(tp, *args)
    first = ft.fused_tp3(tp, *args)
    for _ in range(49):
        assert torch.equal(ft.fused_tp3(tp, *args), first)
    torch.cuda.synchronize()
    assert (first - ref).abs().max().item() <= 1e-3 * max(ref.abs().max().item(), 1.0)


@pytest.mark.parametrize("rows,K,H1", [(3200, 32, 145), (320, 320, 145), (320, 2560, 73)])
def test_fused_tp3_bf16_two_launches_are_bit_identical(rows, K, H1):
    """Every sum runs in a fixed order: all slices in one block (3200 x
    32), and the neighbour halves of the two warpgroups added first half +
    second half (320 x 320, 320 x 2560)."""
    dev = _card()
    tp = _joint_tp()
    args = _bf16_args(tp, rows, K, H1, dev, seed=5)
    first = ft.fused_tp3(tp, *args)
    second = ft.fused_tp3(tp, *args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# the bfloat16 kernel of gens 2 and 1 (csrc/factored_tp_bf16.cu) at the
# edges of its plan: one neighbour; K not a multiple of 16 (stages of 16,
# 32, 64 with zeros past K); K >= 256, where the two consumer warpgroups
# split each receiver's neighbours (and an odd stage count); receiver counts
# that are not a multiple of the block's receivers, in the mode where a
# block takes every slice and where it takes one class; slices whose first
# coupled column is not 8-aligned (DiffDock-L's (78, 3) class starts at
# column 58, its slices at 60-column steps; "5x0e + 3x1o" classes of odd
# widths); gen 1's chain_f32 classes, and its mixed case (float32 sh, h,
# mw); H with a partial hidden box and an odd H
FACTORED_BF16_EDGES = [
    ("diffdock_l", 50, 1, 145), ("diffdock_l", 37, 23, 145), ("diffdock_l", 41, 33, 145),
    ("diffdock_l", 3203, 32, 145), ("diffdock_l", 7, 257, 145), ("confidence", 10, 300, 73),
    ("confidence", 5, 449, 73), ("confidence", 2001, 6, 73), ("odd", 29, 17, 24),
    ("chain_f32", 61, 19, 24), ("chain_f32", 17, 70, 23), ("chain_f32", 5, 260, 100),
]


def _edge_tp(model):
    if model == "odd":
        return FullyConnectedTensorProduct("5x0e + 3x1o + 1x2e", SH, "5x0e + 3x1o + 3x1e + 1x2e")
    if model == "chain_f32":  # a one-path d3 = 1 class of three-term chains (2x0o)
        return FullyConnectedTensorProduct("8x0e + 2x1o + 2x1e", SH, "8x0e + 2x1o + 2x1e + 2x0o")
    return _gen21_tp(model, (3, 3))


@pytest.mark.parametrize("gen", [2, 1])
@pytest.mark.parametrize("model,rows,K,H1", FACTORED_BF16_EDGES)
def test_factored_bf16_kernel_at_its_plan_edges(gen, model, rows, K, H1):
    """The bfloat16 kernel against ``factored_tp_bf16_reference``, within
    1e-3 of scale, the same bits from a second launch, one launch counted
    per call; gen 1 also in its mixed case."""
    from diffdock_tpu_torch.ops import factored_tp1 as f1
    from diffdock_tpu_torch.ops import factored_tp2 as f2

    dev = _card()
    tp = _edge_tp(model)
    x, sh, h, mw, wk, wb = _inputs(tp, rows, K, H1 - 1, dev, seed=7)
    m, fn = (f2, f2.factored_tp2) if gen == 2 else (f1, f1.factored_tp1)
    cases = [(x.bfloat16(), sh.bfloat16(), h.bfloat16(), mw.bfloat16(), wk, wb)]
    if gen == 1:
        cases.append((x.bfloat16(), sh, h, mw, wk, wb))
    for args in cases:
        before = m.counts[f"factored_tp{gen}_bf16"]
        out = fn(tp, *args)
        again = fn(tp, *args)
        ref = f2.factored_tp_bf16_reference(tp, *args, gen=gen)
        torch.cuda.synchronize()
        assert m.counts[f"factored_tp{gen}_bf16"] == before + 2
        assert out.dtype == torch.float32 and torch.equal(out, again)
        assert (out - ref).abs().max().item() <= 1e-3 * max(ref.abs().max().item(), 1.0)


# ESM2 at its published width (1280 wide, 20 heads, FFN 5120) cut to two
# layers: the card against the CPU on the same random weights, every row
# within 1e-4 of the output's scale (float32 with TF32 off on both), and the
# same bits whatever the process's TF32 setting (the forward turns it off
# for itself and restores it)
def test_esm2_forward_on_the_card_matches_the_cpu():
    import copy

    from diffdock_tpu_torch.models.esm2 import ESM2, ESM2Config, MASK_ID, PAD_ID

    dev = _card()
    cfg = ESM2Config(num_layers=2)
    cpu = ESM2(cfg)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev).eval()
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(4, 24, (2, 384), generator=g)
    tokens[:, 0] = 0
    tokens[0, 370], tokens[1, 383] = 2, 2
    tokens[0, 371:] = PAD_ID
    tokens[1, 17] = MASK_ID
    mask = (tokens != PAD_ID).long()
    with torch.inference_mode():
        ref = cpu(tokens, mask)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got_tf32 = card(tokens.to(dev), mask.to(dev))
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        got = card(tokens.to(dev), mask.to(dev))
    assert torch.equal(got, got_tf32)
    scale = max(ref.abs().max().item(), 1.0)
    err = (got.cpu() - ref).abs().max().item()
    assert torch.isfinite(got).all() and err <= 1e-4 * scale, (err, scale)
