"""A CPU walk of the gen-3 tensor-core kernel's blocking (``csrc/fused_tp3.cu``).

The kernel itself runs only on the card. This walk repeats its index math
on the CPU: the operands as ``prepare`` hands them over, blocks of 16
receivers, column slices of whole u groups, hidden-row groups padded to
16-row tiles, the P tiles laid out as the weight product's depth rows,
the scratch parts of each (slice, group) summed in the kernel's order,
and every product in 3xTF32 (each float32 operand split into a TF32 head
rounded to nearest, ties away, and a TF32 remainder). It must rebuild
``fused_tp3_reference``, so an indexing fault shows before the card.
"""

import math

import numpy as np
import pytest
import torch

from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.ops.irreps import get_irrep_seq
from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct

SH = "1x0e + 1x1o + 1x2e"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, round to nearest, ties
    away from zero (on the bit pattern of finite float32 values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched) as the kernel's mma does it: rem*head + head*rem +
    head*head, float32 accumulation."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def walk(h_aug, coupled, weights, table):
    """The kernel's result, block by block, from prepared operands."""
    N, K, H1 = h_aug.shape
    plan = ft.tile_plan(table, H1)
    hr, G, tr = plan.hidden_rows, plan.n_groups, ft.TILE_ROWS
    w_tot = int((table[:, 3] * table[:, 2]).sum())
    n_tiles = -(-N // tr)
    Np = n_tiles * tr
    # receiver rows padded to whole blocks, hidden rows to whole groups (zeros)
    h_pad = torch.zeros(Np, K, G * hr)
    h_pad[:N, :, :H1] = h_aug
    c_pad = torch.zeros(Np, K, coupled.shape[2])
    c_pad[:N] = coupled
    parts = torch.zeros(G * plan.s_max, Np, w_tot)
    for c, (f_off, fan, d3, mul, out_off, w_off) in enumerate(table.tolist()):
        w_c = weights[w_off:w_off + H1 * fan * mul].reshape(H1, fan, mul)
        w_pad = torch.zeros(G * hr, fan, mul)
        w_pad[:H1] = w_c
        for s in range(plan.n_slices[c]):
            u0 = s * plan.us[c]
            nu = min(plan.us[c], fan - u0)
            cols = c_pad[:, :, f_off + u0 * d3:f_off + (u0 + nu) * d3]  # (Np, K, nu*d3)
            assert cols.shape[2] <= ft.SLICE_COLS
            for g in range(G):
                a = h_pad[:, :, g * hr:(g + 1) * hr].transpose(1, 2)  # (Np, hr, K)
                p = mm_3xtf32(a, cols)  # (Np, hr, nu*d3): one warp's registers
                # shared memory: ps[tile][(uu*hr + hh), t*d3 + d]
                ps = (p.reshape(n_tiles, tr, hr, nu, d3).permute(0, 3, 2, 1, 4)
                      .reshape(n_tiles, nu * hr, tr * d3))
                # A of the weight product: W_c[h0+hh, u0+uu, w] as (w, (uu, hh))
                wm = w_pad[g * hr:(g + 1) * hr, u0:u0 + nu].permute(2, 1, 0).reshape(mul, nu * hr)
                o = mm_3xtf32(wm, ps)  # (n_tiles, mul, tr*d3)
                o = o.reshape(n_tiles, mul, tr, d3).permute(0, 2, 1, 3).reshape(Np, mul * d3)
                parts[s * G + g, :, out_off:out_off + mul * d3] = o
    # fused_tp3_reduce: the class's parts (s*G + g) in order
    out = torch.zeros(Np, w_tot)
    for c, (_f, _fan, d3, mul, out_off, _w) in enumerate(table.tolist()):
        for q in range(plan.n_slices[c] * G):
            out[:, out_off:out_off + mul * d3] += parts[q, :, out_off:out_off + mul * d3]
    return out[:N]


def _inputs(tp, rows, K, H, seed):
    rng = np.random.RandomState(seed)
    T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))
    mw = T(rng.rand(rows, K) < 0.7)
    x = T(rng.randn(rows, K, tp.irreps_in1.dim))
    sh = T(rng.randn(rows, K, tp.irreps_in2.dim))
    h = torch.relu(T(rng.randn(rows, K, H))) * mw[..., None]
    wk = T(rng.randn(H, tp.weight_numel) / math.sqrt(H))
    wb = T(rng.randn(tp.weight_numel) * 0.1)
    return x, sh, h, mw, wk, wb


# narrowed class tables: the score model's joint-layer TP (4 classes) and
# the confidence model's widest (4 classes, two of d3 = 3) at small widths;
# the score one is wide enough that its d3 = 3 class takes two slices
SCORE = (get_irrep_seq(24, 8, False, True)[3], get_irrep_seq(24, 8, False, True)[3])
CONFIDENCE = ("6x0e + 4x1o + 4x1e + 6x0o", "6x0e + 4x1o + 4x1e + 6x0o")
# l = 2 outputs (d3 = 5: 12 u per slice) beside a narrow scalar class
HIGH_ORDER = ("8x0e + 6x1o + 4x2e", "5x2e + 3x0e")


@pytest.mark.parametrize("irreps,rows,K,H1", [
    (SCORE, 13, 7, 145), (SCORE, 9, 33, 17), (SCORE, 8, 1, 73),
    (CONFIDENCE, 21, 33, 73), (CONFIDENCE, 5, 7, 17), (CONFIDENCE, 3, 1, 145),
    (HIGH_ORDER, 17, 7, 33),
])
def test_walk_rebuilds_the_plain_version(irreps, rows, K, H1):
    tp = FullyConnectedTensorProduct(irreps[0], SH, irreps[1])
    args = _inputs(tp, rows, K, H1 - 1, seed=rows + K)
    classes, h_aug, coupled, weights, table = ft.prepare(tp, *args)
    ref = ft.fused_tp3_reference(tp, *args)
    got = ft._scatter_classes(tp, classes, walk(h_aug, coupled, weights, table))
    scale = max(ref.abs().max().item(), 1.0)
    assert (got - ref).abs().max().item() <= 1e-4 * scale


def test_walk_covers_several_slices_and_groups():
    tp = FullyConnectedTensorProduct(SCORE[0], SH, SCORE[1])
    table = ft.class_table(tp.live_classes(), 145)
    plan = ft.tile_plan(table, 145)
    assert plan.hidden_rows == 32 and plan.n_groups == 5 and plan.s_max >= 2
    assert ft.tile_plan(table, 17).n_groups == 1 and ft.tile_plan(table, 16).hidden_rows == 16


def test_tile_plan_at_the_main_path_shapes():
    """DiffDock-L's joint-layer TP: classes (fan, d3, mul) = (58, 1, 48),
    (78, 3, 10), (40, 3, 10), (20, 1, 10) -> 1 + 4 + 2 + 1 column slices,
    5 hidden groups of 32 rows for H+1 = 145, 3 for 73."""
    seq = get_irrep_seq(48, 10, False, True)
    tp = FullyConnectedTensorProduct(seq[3], SH, seq[3])
    table = ft.class_table(tp.live_classes(), 145)
    assert [tuple(r[1:4]) for r in table.tolist()] == [(58, 1, 48), (78, 3, 10), (40, 3, 10),
                                                     (20, 1, 10)]
    plan = ft.tile_plan(table, 145)
    assert plan.n_slices == (1, 4, 2, 1) and plan.us == (58, 20, 20, 20) and plan.n_groups == 5
    assert plan.scratch_floats(320, 118) == 5 * 4 * 320 * 118
    assert ft.tile_plan(table, 73).n_groups == 3


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + ulp / 2, one + ulp / 4, -(one + ulp / 2), one + 3 * ulp / 4],
                     dtype=torch.float32)
    assert tf32(x).tolist() == [one + ulp, one, -(one + ulp), one + ulp]
    y = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi = tf32(y)
    lo = tf32(y - hi)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert ((hi + lo) - y).abs().max().item() <= 2.0 ** -21 * y.abs().max().item()
