"""A CPU walk of the float32 gen-3 tensor-core kernel (``csrc/fused_tp3.cu``).

The kernel itself runs only on the card. This walk repeats its index math
on the CPU from what the kernel reads: the tensor product's geometry
(``ops/fused_tp3.py:tp_geometry``: the class and path tables and the CG
blocks), blocks of 16 receivers, column slices of whole u groups (each
slice's staged inputs, harmonics window and CG-weight columns from
``slice_tables``), hidden-row groups padded to 16-row tiles with
mask*edge_weight as row H, the coupling built per slice, the P tiles laid
out as the weight product's depth rows, the weights read from
``out_kernel`` and ``out_bias`` at each class's columns and scaled by
1/sqrt(fan) in float32, the scratch parts of each (slice, group) summed in
the kernel's order, zeros for classes without a path, and every product in
3xTF32 (each float32 operand split into a TF32 head rounded to nearest,
ties away, and a TF32 remainder). It must rebuild ``fused_tp3_reference``,
so an indexing fault shows before the card.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke
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


def couple(geo, sl, col0, d3, x, sh):
    """One slice's coupled columns (..., nu*d3) from the block's tables, as a
    warp builds its B tile: the staged inputs and harmonics window, the CG
    weights of the slice's columns, then each column's d1 products."""
    xs = x[..., list(sl.xmap)]
    shw = sh[..., sl.sh0:sl.sh0 + sl.nsh]
    cg = torch.from_numpy(geo.cg)
    g0 = col0 + sl.cw0  # the slice's first CG column
    ws = torch.stack([sum(shw[..., t0 + t] * cg[t, g0 + cc] for t in range(n))
                      for cc, (t0, n) in enumerate(sl.wcol)], dim=-1)
    return torch.stack([sum(xs[..., xo + i] * ws[..., wo + i * d3] for i in range(d1))
                        for xo, wo, d1 in sl.colinfo], dim=-1)


def slices(geo, plan, c):
    """(u0, nu, tables) of each column slice of class ``c``."""
    fan, us = int(geo.class_rows[c, 0]), plan.us[c]
    for s in range(plan.n_slices[c]):
        u0 = s * us
        nu = min(us, fan - u0)
        yield u0, nu, ft.slice_tables(geo, c, u0, nu)


def walk(tp, x, sh, h, mw, wk, wb):
    """The kernel's result, block by block, from the call's inputs."""
    geo = ft.tp_geometry(tp)
    N, K, H = h.shape
    plan = ft.tile_plan(geo, H)
    hr, G, tr = plan.hidden_rows, plan.n_groups, ft.TILE_ROWS
    cap = ft.xp_cap(hr, min(geo.J, 32))
    n_tiles = -(-N // tr)
    Np = n_tiles * tr
    # receiver rows padded to whole blocks; A = [h | mw], its rows padded to
    # whole groups (zeros)
    a_pad = torch.zeros(Np, K, G * hr)
    a_pad[:N, :, :H] = h
    a_pad[:N, :, H] = mw
    x_pad = torch.zeros(Np, K, geo.X)
    x_pad[:N] = x
    sh_pad = torch.zeros(Np, K, geo.J)
    sh_pad[:N] = sh
    parts = torch.zeros(G * plan.s_max, Np, geo.D)
    for c, (fan, d3, mul, out_off, w_off, col0, _p0, _np) in enumerate(geo.class_rows.tolist()):
        if fan == 0:
            continue
        # the weight rows as the kernel reads them: out_kernel's hidden rows,
        # out_bias as row H, each value times the float32 1/sqrt(fan)
        t = torch.cat([wk[:, w_off:w_off + fan * mul], wb[None, w_off:w_off + fan * mul]])
        t = t.reshape(H + 1, fan, mul) * np.float32(1.0 / math.sqrt(fan))
        t_pad = torch.zeros(G * hr, fan, mul)
        t_pad[:H + 1] = t
        for s, (u0, nu, sl) in enumerate(slices(geo, plan, c)):
            assert nu * d3 <= ft.SLICE_COLS and sl.xs <= cap and sl.nc <= 64 and sl.nsh <= 32
            cols = couple(geo, sl, col0, d3, x_pad, sh_pad)  # (Np, K, nu*d3)
            for g in range(G):
                a = a_pad[:, :, g * hr:(g + 1) * hr].transpose(1, 2)  # (Np, hr, K)
                p = mm_3xtf32(a, cols)  # (Np, hr, nu*d3): one warp's registers
                # shared memory: ps[tile][(uu*hr + hh), t*d3 + d]
                ps = (p.reshape(n_tiles, tr, hr, nu, d3).permute(0, 3, 2, 1, 4)
                      .reshape(n_tiles, nu * hr, tr * d3))
                # A of the weight product: T_c[h0+hh, u0+uu, w] as (w, (uu, hh))
                wm = t_pad[g * hr:(g + 1) * hr, u0:u0 + nu].permute(2, 1, 0).reshape(mul, nu * hr)
                o = mm_3xtf32(wm, ps)  # (n_tiles, mul, tr*d3)
                o = o.reshape(n_tiles, mul, tr, d3).permute(0, 2, 1, 3).reshape(Np, mul * d3)
                parts[s * G + g, :, out_off:out_off + mul * d3] = o
    # fused_tp3_reduce: the class's parts (s*G + g) in order; zeros where a
    # class has no path
    out = torch.zeros(Np, geo.D)
    for c, (fan, d3, mul, out_off, *_rest) in enumerate(geo.class_rows.tolist()):
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
# the score one is wide enough that its d3 = 3 class takes several slices
SCORE = (get_irrep_seq(24, 8, False, True)[3], get_irrep_seq(24, 8, False, True)[3])
CONFIDENCE = ("6x0e + 4x1o + 4x1e + 6x0o", "6x0e + 4x1o + 4x1e + 6x0o")
# l = 2 outputs (d3 = 5: 4 u per slice) beside a narrow scalar class
HIGH_ORDER = ("8x0e + 6x1o + 4x2e", "5x2e + 3x0e")


@pytest.mark.parametrize("irreps,rows,K,H1", [
    (SCORE, 13, 7, 145), (SCORE, 9, 33, 17), (SCORE, 8, 1, 73),
    (CONFIDENCE, 21, 33, 73), (CONFIDENCE, 5, 7, 17), (CONFIDENCE, 3, 1, 145),
    (HIGH_ORDER, 17, 7, 33),
])
def test_walk_rebuilds_the_plain_version(irreps, rows, K, H1):
    tp = FullyConnectedTensorProduct(irreps[0], SH, irreps[1])
    args = _inputs(tp, rows, K, H1 - 1, seed=rows + K)
    ref = ft.fused_tp3_reference(tp, *args)
    got = walk(tp, *args)
    scale = max(ref.abs().max().item(), 1.0)
    assert (got - ref).abs().max().item() <= 1e-4 * scale


def test_walk_covers_several_slices_and_groups():
    tp = FullyConnectedTensorProduct(SCORE[0], SH, SCORE[1])
    geo = ft.tp_geometry(tp)
    plan = ft.tile_plan(geo, 144)
    assert plan.hidden_rows == 80 and plan.n_groups == 2 and plan.s_max >= 2
    assert ft.tile_plan(geo, 16).n_groups == 1 and ft.tile_plan(geo, 16).hidden_rows == 32
    assert ft.tile_plan(geo, 96).hidden_rows == 64 and ft.tile_plan(geo, 72).n_groups == 1


def test_tile_plan_at_the_main_path_shapes():
    """DiffDock-L's joint-layer TP: classes (fan, d3, mul) = (58, 1, 48),
    (78, 3, 10), (40, 3, 10), (20, 1, 10) -> 3 + 10 + 5 + 1 column slices of
    at most 24 columns, 2 hidden groups of 80 rows for H+1 = 145, one for
    73; the scratch holds 2 x 10 parts of the 118 outputs."""
    seq = get_irrep_seq(48, 10, False, True)
    tp = FullyConnectedTensorProduct(seq[3], SH, seq[3])
    geo = ft.tp_geometry(tp)
    assert [tuple(r[:3]) for r in geo.class_rows.tolist()] == [(58, 1, 48), (78, 3, 10),
                                                               (40, 3, 10), (20, 1, 10)]
    plan = ft.tile_plan(geo, 144)
    assert plan.n_slices == (3, 10, 5, 1) and plan.us == (20, 8, 8, 20) and plan.n_groups == 2
    assert plan.hidden_rows == 80 and plan.smem_floats * 4 <= 232448
    assert plan.scratch_floats(320, 118) == 2 * 10 * 320 * 118
    plan73 = ft.tile_plan(geo, 72)
    assert plan73.n_groups == 1 and plan73.hidden_rows == 80


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


# every merged TP of the benchmark's models: DiffDock-L's and v1.0's score
# models and the all-atom confidence model that ranks for both
MODEL_TPS = chip_smoke.model_tps()


@pytest.mark.parametrize("where,key", MODEL_TPS, ids=[w for w, _ in MODEL_TPS])
def test_slice_tables_rebuild_the_coupling_of_every_model_tp(where, key):
    """The kernel's column tables, slice by slice at the plan of the TP's
    hidden width, rebuild ``tp.coupled_class_merged`` of every class."""
    ins, shs, outs, H = key
    tp = FullyConnectedTensorProduct(ins, shs, outs)
    geo = ft.tp_geometry(tp)
    plan = ft.tile_plan(geo, H)
    x, sh = _inputs(tp, 3, 5, H, seed=len(where))[:2]
    for c, (fan, d3, *_r, col0, _p0, _np) in enumerate(geo.class_rows.tolist()):
        if fan == 0:
            continue
        ref = tp.coupled_class_merged(c, x, sh)
        got = torch.cat([couple(geo, sl, col0, d3, x, sh) for _u0, _nu, sl in slices(geo, plan, c)],
                        dim=-1)
        assert got.shape == ref.shape
        assert (got - ref).abs().max().item() <= 1e-5 * max(ref.abs().max().item(), 1.0)


def test_model_tps_cover_the_cells_hidden_widths():
    """The TPs above run at H+1 = 145 (conv layers), 97 (heads) and 73 (the
    confidence model), and include the torsion head's harmonics to l = 4."""
    widths = {key[3] for _w, key in MODEL_TPS}
    assert widths == {144, 96, 72}
    assert any(ft.tp_geometry(FullyConnectedTensorProduct(*key[:3])).J == 45 for _w, key in MODEL_TPS)


def test_geometry_reads_the_weights_at_each_class_and_keeps_empty_classes():
    """Class rows follow the e3nn output and the flat weight layout, those
    without a path too; the walk leaves them zero."""
    tp = FullyConnectedTensorProduct("4x0e + 2x1o", "1x0e + 1x1o", "4x0e + 3x2o + 2x1o")
    geo = ft.tp_geometry(tp)
    assert [(r[0], r[3], r[4]) for r in geo.class_rows.tolist()] == [
        (fan, out, off) for (off, fan, _m), out in zip(tp.weight_slices(), (0, 4, 19))]
    assert geo.class_rows[1, 0] == 0 and geo.class_rows[1, 7] == 0
    args = _inputs(tp, 9, 5, 6, seed=3)
    got = walk(tp, *args)
    assert torch.all(got[:, 4:19] == 0)
    ref = ft.fused_tp3_reference(tp, *args)
    assert (got - ref).abs().max().item() <= 1e-4 * max(ref.abs().max().item(), 1.0)
