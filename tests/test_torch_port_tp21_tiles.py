"""A CPU walk of the gen-2 and gen-1 tensor-core kernels' blocking
(``csrc/factored_tp.cuh``, shared by ``factored_tp2.cu`` and ``factored_tp1.cu``).

The kernels run only on the card. This walk repeats their index math on the
CPU, from the operands as each wrapper's ``prepare`` hands them over:
blocks of 16 receivers, column slices of whole u groups as
``factored_tp2.tile_plan`` cuts them (slices may cross path boundaries),
each slice's packed input floats gathered in the kernel's order, its
CG-weight columns summed over their nonzero CG rows (gen 2) or their
path's own harmonics (gen 1), the coupled columns from those, hidden-row
groups of up to 80 rows (whole 16-row tiles) with the bias as row H, the
P tiles laid out as the weight product's depth rows, the scratch parts of
each (slice, group) summed in the kernel's order, and every product in
3xTF32. It must rebuild ``factored_tp_reference``, so an indexing fault
shows before the card. The bfloat16 modes are a kernel of their own,
walked in ``tests/test_torch_port_tp21_bf16_tiles.py``.
"""

import math

import numpy as np
import pytest
import torch

# the kernels' 3xTF32 product, as the gen-3 walk has it
from test_torch_port_tp3_tiles import mm_3xtf32

from diffdock_tpu_torch.ops import factored_tp1 as f1
from diffdock_tpu_torch.ops import factored_tp2 as f2
from diffdock_tpu_torch.ops.irreps import get_irrep_seq
from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct

SH = "1x0e + 1x1o + 1x2e"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def slice_tables(paths, d3, u0, nu, cg, col0, gen):
    """The block's shared tables for one slice: the packed input offsets of
    a neighbour row (xmap), per coupled column (xoff, xstr, woff, d1), per
    CG-weight column (so, ro, n), and the slice itself."""
    sl = f2.slice_of(paths, d3, u0, nu)
    xmap, runs = [], {}
    for p in range(sl.pa, sl.pb + 1):
        ua, n = f2.path_span(paths[p], u0, nu)
        runs[p] = (len(xmap), ua, n)
        u_off, pm, d1, xs0 = (int(v) for v in paths[p][:4])
        for i in range(d1):
            xmap.extend(xs0 + i * pm + ua - u_off + t for t in range(n))
    assert len(xmap) == sl.xs
    colinfo = []
    for j in range(nu * d3):
        u, d = u0 + j // d3, j % d3
        p = next(q for q in range(sl.pa, sl.pb + 1) if paths[q][0] <= u < paths[q][0] + paths[q][1])
        base, ua, n = runs[p]
        colinfo.append((base + u - ua, n, int(paths[p][4]) - sl.cw0 + d, int(paths[p][2])))
    wcol = []
    for cc in range(sl.nc):
        p = max(q for q in range(sl.pa, sl.pb + 1) if paths[q][4] <= sl.cw0 + cc)
        if gen == 1:
            wcol.append((int(paths[p][5]), 0, int(paths[p][6])))
        else:
            nz = np.flatnonzero(cg[:, col0 + sl.cw0 + cc])
            wcol.append((int(nz[0]), int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0, 0))
    return sl, xmap, colinfo, wcol


def walk(gen, ops):
    """The kernel's result, block by block, from the wrapper's prepared
    operands."""
    if gen == 2:
        xp, sh, hid, Ha, cg, weights, cls_rows, path_rows = ops  # hid: h_aug (N, K, He)
        N, K, _ = xp.shape
        He = hid.shape[2]
    else:
        xp, sh, h, mw, cg, t_all, b_all, cls_rows, path_rows = ops
        N, K, _ = xp.shape
        H = h.shape[-1]
        Ha = H + 1
        hid = torch.cat([h, mw[..., None]], dim=-1)  # mw is row H
    mm = mm_3xtf32  # a tensor-core product
    J = sh.shape[-1]
    plan = f2.tile_plan(cls_rows, path_rows, Ha, J)
    hr, G, tr = plan.hidden_rows, plan.n_groups, f2.TILE_ROWS
    out_dim = int((cls_rows[:, 2] * cls_rows[:, 1]).sum())
    n_tiles = -(-N // tr)
    Np = n_tiles * tr
    pad = lambda t: torch.cat([t, t.new_zeros((Np - N,) + tuple(t.shape[1:]))])  # noqa: E731
    xp, sh = pad(xp), pad(sh)
    a_all = torch.zeros(Np, K, G * hr)  # hidden rows past H+1 are zero
    a_all[:N, :, :Ha] = hid[..., :Ha]
    cg_np = cg.numpy()
    parts = torch.zeros(G * plan.s_max, Np, out_dim)
    for c, row in enumerate(cls_rows.tolist()):
        fan, d3, mul, out_off, col0, _nc, p0, n_paths = row[:8]
        paths = path_rows[p0:p0 + n_paths]
        # the weight rows of the walk's hidden rows: row H is the bias
        w_rows = torch.zeros(G * hr, fan, mul)
        if gen == 2:
            w_rows[:Ha] = weights[row[8]:row[8] + He * fan * mul].reshape(He, fan, mul)[:Ha]
        else:
            w_rows[:H] = t_all[row[8]:row[8] + H * fan * mul].reshape(H, fan, mul)
            w_rows[H] = b_all[row[9]:row[9] + fan * mul].reshape(fan, mul)
        for s in range(plan.n_slices[c]):
            u0 = s * plan.us[c]
            nu = min(plan.us[c], fan - u0)
            assert 0 < nu * d3 <= f2.SLICE_COLS
            sl, xmap, colinfo, wcol = slice_tables(paths, d3, u0, nu, cg_np, col0, gen)
            assert sl.xs <= f2.xp_cap(hr, J) and sl.nc <= f2.MAX_W
            x_s = xp[:, :, xmap]  # (Np, K, xs): the stages' packed input floats
            # CG weights (Np, K, nc), float32 sums in the kernel's order
            w_s = torch.zeros(Np, K, sl.nc)
            for cc, (so, ro, n) in enumerate(wcol):
                for t in range(n):
                    w_s[:, :, cc] += sh[:, :, so + t] * cg[ro + t, col0 + sl.cw0 + cc]
            # the coupled B columns (Np, K, nu*d3)
            b_s = torch.zeros(Np, K, nu * d3)
            for j, (xoff, xstr, woff, d1) in enumerate(colinfo):
                for i in range(d1):
                    b_s[:, :, j] += x_s[:, :, xoff + i * xstr] * w_s[:, :, woff + i * d3]
            for g in range(G):
                a = a_all[:, :, g * hr:(g + 1) * hr].transpose(1, 2)  # (Np, hr, K)
                p = mm(a, b_s)  # (Np, hr, nu*d3): one warp's registers
                # shared memory: ps[tile][(uu*hr + hh), t*d3 + d]
                ps = (p.reshape(n_tiles, tr, hr, nu, d3).permute(0, 3, 2, 1, 4)
                      .reshape(n_tiles, nu * hr, tr * d3))
                # A of the weight product: T_c[h0+hh, u0+uu, w] as (w, (uu, hh))
                wm = (w_rows[g * hr:(g + 1) * hr, u0:u0 + nu].permute(2, 1, 0)
                      .reshape(mul, nu * hr))
                o = mm(wm, ps)  # (n_tiles, mul, tr*d3)
                o = o.reshape(n_tiles, mul, tr, d3).permute(0, 2, 1, 3).reshape(Np, mul * d3)
                parts[s * G + g, :, out_off:out_off + mul * d3] = o / math.sqrt(fan)
    # factored_tp_reduce: the class's parts (s*G + g) in order
    out = torch.zeros(Np, out_dim)
    for c, row in enumerate(cls_rows.tolist()):
        d3, mul, out_off = row[1], row[2], row[3]
        for q in range(plan.n_slices[c] * G):
            out[:, out_off:out_off + mul * d3] += parts[q, :, out_off:out_off + mul * d3]
    return out[:N]


def _inputs(tp, rows, K, H, seed):
    rng = np.random.RandomState(seed)
    T = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    mw = T(rng.rand(rows, K) < 0.7)
    x = T(rng.randn(rows, K, tp.irreps_in1.dim))
    sh = T(rng.randn(rows, K, tp.irreps_in2.dim))
    h = torch.relu(T(rng.randn(rows, K, H))) * mw[..., None]
    wk = T(rng.randn(H, tp.weight_numel) / math.sqrt(H))
    wb = T(rng.randn(tp.weight_numel) * 0.1)
    return x, sh, h, mw, wk, wb


# narrowed class tables: the score model's joint-layer TP (its d3 = 3 class
# of fan 48 takes three slices of 16 u, the middle one crossing from the
# 24x0e path into the 8x1o ones) and the confidence model's widest; l = 2
# outputs (d3 = 5) beside a scalar class; a class whose 24 u need 112
# packed input floats per neighbour, more than a slice may take, so it
# takes more slices than its 24 columns would
SCORE = (get_irrep_seq(24, 8, False, True)[3], get_irrep_seq(24, 8, False, True)[3])
CONFIDENCE = ("6x0e + 4x1o + 4x1e + 6x0o", "6x0e + 4x1o + 4x1e + 6x0o")
HIGH_ORDER = ("8x0e + 6x1o + 4x2e", "5x2e + 3x0e")
WIDE_INPUTS = ("20x2e + 4x1o", "24x0e + 2x1e")


@pytest.mark.parametrize("gen", [2, 1])
@pytest.mark.parametrize("irreps,rows,K,H1", [
    (SCORE, 13, 7, 145), (SCORE, 9, 33, 17), (SCORE, 8, 1, 73),
    (CONFIDENCE, 21, 33, 73), (CONFIDENCE, 5, 7, 17), (CONFIDENCE, 3, 1, 145),
    (HIGH_ORDER, 17, 7, 33), (HIGH_ORDER, 18, 9, 100), (WIDE_INPUTS, 6, 7, 16),
    (WIDE_INPUTS, 4, 9, 145),
])
def test_walk_rebuilds_the_plain_version(gen, irreps, rows, K, H1):
    tp = FullyConnectedTensorProduct(irreps[0], SH, irreps[1])
    args = _inputs(tp, rows, K, H1 - 1, seed=rows + K)
    ops = (f2 if gen == 2 else f1).prepare(tp, *args)
    ref = f2.factored_tp_reference(tp, *args)
    got = walk(gen, ops)
    scale = max(ref.abs().max().item(), 1.0)
    assert (got - ref).abs().max().item() <= 1e-4 * scale


def test_slices_cross_path_boundaries():
    """The narrowed score TP's slices include ones that touch two paths,
    whose coupled columns read two runs of packed inputs and CG weights."""
    tp = FullyConnectedTensorProduct(SCORE[0], SH, SCORE[1])
    specs, _cg, _xp, _out = f2.build_specs2(tp)
    cls_rows, path_rows = f2.class_table(specs, 32)
    plan = f2.tile_plan(cls_rows, path_rows, 17, 9)
    crossing = []
    for c, row in enumerate(cls_rows.tolist()):
        paths = path_rows[row[6]:row[6] + row[7]]
        for s in range(plan.n_slices[c]):
            u0 = s * plan.us[c]
            sl = f2.slice_of(paths, row[1], u0, min(plan.us[c], row[0] - u0))
            crossing.append(sl.pb > sl.pa)
    assert sum(crossing) >= 2 and not all(crossing)


def test_input_floats_cap_splits_a_class():
    """24 scalar u of which 20 take 5 packed floats and 4 take 3: one slice
    of 24 columns would need 112 floats a neighbour, over the cap (96 with
    32 hidden rows, 72 with 80), so the class takes two of 12 u."""
    tp = FullyConnectedTensorProduct(WIDE_INPUTS[0], SH, WIDE_INPUTS[1])
    specs, _cg, _xp, _out = f2.build_specs2(tp)
    cls_rows, path_rows = f2.class_table(specs, 32)
    assert (f2.xp_cap(32, 9), f2.xp_cap(80, 9), f2.xp_cap(80, 16)) == (96, 72, 65)
    for Ha in (20, 145):
        plan = f2.tile_plan(cls_rows, path_rows, Ha, 9)
        assert cls_rows[0, 0] == 24 and plan.n_slices[0] == 2 and plan.us[0] == 12
        assert plan.xs_max <= f2.xp_cap(plan.hidden_rows, 9)


def test_tile_plan_at_the_main_path_shapes():
    """DiffDock-L's joint-layer TP: classes (fan, d3, mul) = (58, 1, 48),
    (78, 3, 10), (40, 3, 10), (20, 1, 10) -> 3 + 10 + 5 + 1 column slices,
    at most 40 packed input floats and 18 CG-weight columns per neighbour
    of a slice, 2 hidden groups of 80 rows for H+1 = 145, 1 for 73; the
    shipped confidence model's widest TP (24x0e + 6x1o + 6x1e + 24x0o)
    -> 2 + 6 + 6 + 2 slices. Gen 1's tables cut the same way."""
    seq = get_irrep_seq(48, 10, False, True)
    tp = FullyConnectedTensorProduct(seq[3], SH, seq[3])
    specs, _cg, _xp, out_dim = f2.build_specs2(tp)
    cls_rows, path_rows = f2.class_table(specs, 160)
    assert [tuple(r[:3]) for r in cls_rows.tolist()] == [(58, 1, 48), (78, 3, 10), (40, 3, 10),
                                                        (20, 1, 10)]
    plan = f2.tile_plan(cls_rows, path_rows, 145, 9)
    assert plan.n_slices == (3, 10, 5, 1) and plan.us == (20, 8, 8, 20)
    assert (plan.hidden_rows, plan.n_groups, plan.xs_max, plan.nc_max) == (80, 2, 40, 18)
    assert plan.scratch_floats(3200, out_dim) == 2 * 10 * 3200 * 118
    assert f2.tile_plan(cls_rows, path_rows, 73, 9).n_groups == 1
    specs1, _cg1, _xp1, _ = f1.build_specs(tp)
    cls1, paths1 = f1.class_table(specs1, 144)
    assert f2.tile_plan(cls1, paths1, 145, 9) == plan
    conf = get_irrep_seq(24, 6, False, False)[3]
    tpc = FullyConnectedTensorProduct(conf, SH, conf)
    plan_c = f2.tile_plan(*f2.class_table(f2.build_specs2(tpc)[0], 80), 73, 9)
    assert plan_c.n_slices == (2, 6, 6, 2) and plan_c.n_groups == 1
    assert plan_c.as_ints()[:6] == [1, 6, 16, 27, 18, 80]
