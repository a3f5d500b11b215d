"""A CPU walk of the bfloat16 kernel of gens 2 and 1 (``csrc/factored_tp_bf16.cu``).

The kernel runs only on the card. This walk repeats its index math on the
CPU, from the operands as ``prepare_bf16`` hands them over: the [sh | x]
rows (the harmonics in 16 columns, gen 1's float32 ones as three bfloat16
parts in 48, then x_nbr), ``h`` and ``mw`` with rows padded to a multiple of 8
elements (gen 1's float32 ones as three bfloat16 parts, exactly), the
geometry table of each column slice, the CG matrix and the weights packed
per slice in swizzled 64-deep chunks. Per slice: the CG weights of each of
its CG-weight columns (the harmonics against the slice's CG matrix made
dense over them, float32 sums, rounded), each coupled column's chain
in bfloat16 (each product and partial sum rounded; gen 1's chain_f32
classes end in float32, split into hi and lo tiles), the neighbour stages
of ``KC`` (zeros past K) in one sum or two halves added in the kernel's
order, the hidden product over every hidden row with the bias row from
``mw``, P rounded to bfloat16 and laid out at depth ``u*HP + h``, the
weight product on the unpacked chunks, 1/sqrt(fan) on the float32 result,
and the blocks' receivers and slices each covered once. Products of
bfloat16 values are exact and summed in float32 (in the walk's own order,
which moves float32 roundings only). It must rebuild
``factored_tp_bf16_reference``, so an indexing fault shows before the card.
"""

import math

import numpy as np
import pytest
import torch

from diffdock_tpu_torch.models.config import PRESETS
from diffdock_tpu_torch.ops import factored_tp1 as f1
from diffdock_tpu_torch.ops import factored_tp2 as f2
from diffdock_tpu_torch.ops.irreps import get_irrep_seq
from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct
from tests.test_torch_port_tp21_tiles import CONFIDENCE, HIGH_ORDER, SCORE, SH
from tests.test_torch_port_tp21_tiles import _inputs as _walk_inputs

BF16 = torch.bfloat16
RTOL = 1e-3  # one bfloat16 ulp of P at a rounding tie, as the card tests
# classes of one path and d3 = 1, whose chain gen 1 ends in float32: the
# 16x0e class of a DiffDock ladder's first layer (one-term chains) and a
# 2x0o class of three-term chains
CHAIN_F32 = [("16x0e", "16x0e + 4x1o"), ("8x0e + 2x1o + 2x1e", "8x0e + 2x1o + 2x1e + 2x0o")]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rnd(t: torch.Tensor) -> torch.Tensor:
    return t.to(BF16).float()


def unpack_slice(weights: torch.Tensor, w_off: int, mul: int, depth: int) -> torch.Tensor:
    """A slice's packed chunks back to (mul, depth): chunk j holds [mul][64
    depth] with the 8-element group q of row w at q ^ (w & 7)."""
    chunks = weights[w_off: w_off + mul * depth].float().reshape(depth // 64, mul, 8, 8)
    w = torch.arange(mul)[:, None]
    q = torch.arange(8)[None, :]
    out = chunks[:, w, q ^ (w & 7)]  # (n_sub, mul, 8 groups, 8)
    return out.permute(1, 0, 2, 3).reshape(mul, depth)


def block_cover(plan, slices, n_rows: int) -> np.ndarray:
    """How often each (receiver, slice) is taken by the launch's blocks: a
    block takes R receivers and every slice, or every slice of one class."""
    n_classes = slices[-1].cls + 1
    cover = np.zeros((n_rows, len(slices)), np.int64)
    for b in range(plan.n_blocks):
        grp = b if plan.whole else b // n_classes
        mine = [i for i, sl in enumerate(slices) if plan.whole or sl.cls == b % n_classes]
        cover[grp * plan.R: (grp + 1) * plan.R, mine] += 1
    return cover


def walk(ops, n_sm: int = f2.SM_COUNT) -> torch.Tensor:
    """The kernel's result from ``prepare_bf16``'s operands (either gen)."""
    xs, h, mw, cg, weights, geo, call = ops
    N, K, W = xs.shape
    H, parts, slices = call.H, call.parts, call.slices
    plan = f2.bf16_plan(slices, N, K, H, call.F, call.J, call.sh_f32, parts, n_sm)
    assert plan.W == W and plan.smem_bytes <= f2.BF16_SMEM_BUDGET
    assert plan.k_parts == 2 or plan.R % 2 == 0
    assert (block_cover(plan, slices, N) == 1).all()
    D = slices[-1].out_off + slices[-1].mul * slices[-1].d3
    # the stages of KC neighbours: zeros past K
    Kp = plan.n_kc * plan.KC
    grow = lambda t: torch.cat([t, t.new_zeros((N, Kp - K) + tuple(t.shape[2:]))], dim=1)  # noqa: E731
    rows_f = grow(xs.float())
    x = rows_f[..., plan.x_col:]
    sh = rows_f[..., :f2.BF16_MAX_J]
    if call.sh_f32:  # the three parts, each multiplied, summed in float32
        sh = sh + rows_f[..., f2.BF16_MAX_J: 2 * f2.BF16_MAX_J] + rows_f[..., 32:48]
    assert not sh[..., call.J:].any()
    # the parts of h (part q from column q*hp) and mw, each multiplied
    hp = f2._round_up(H + 1, 8) if parts > 1 else H
    hid = [grow(h[..., q * hp: q * hp + H].float()) for q in range(parts)]
    mws = [grow(mw[:, q].float()) for q in range(parts)]
    geo_np, cgf = geo.numpy(), cg.float()
    # the neighbour ranges summed apart, in order: one, or two halves
    half = plan.h0 * plan.KC if plan.k_parts == 2 else Kp
    ranges = [(0, min(half, Kp))] + ([(half, Kp)] if plan.k_parts == 2 else [])
    out = torch.zeros(N, D)
    for si, sl in enumerate(slices):
        g = geo_np[si]
        d3, ncols = sl.d3, sl.nu * sl.d3
        # the stage's CG weights: the harmonics against the slice's CG matrix
        # made dense over them (zero off each column's own harmonics),
        # float32 sums rounded to bfloat16
        G = torch.zeros(f2.BF16_MAX_J, sl.nw)
        for cc in range(sl.nw):
            s0, d2, col = (int(v) for v in g[f2.BF16_COLS + cc, :3])
            G[s0: s0 + d2, cc] = cgf[:d2, col]
        wts = _rnd(torch.einsum("nkj,jc->nkc", sh, G))
        # the coupled tile's columns: bfloat16 chains in the order i = 0, 1, ...
        C = torch.zeros(N, Kp, f2.BF16_COLS)
        for j in range(ncols):
            xo, d1, w0 = (int(v) for v in g[j, :3])
            v = None
            for i in range(d1):
                a, w = x[..., xo + i], wts[..., w0 + i * d3]
                pr = _rnd(a * w)
                if sl.chain_f32 and i == d1 - 1:
                    v = a * w if i == 0 else v + pr
                else:
                    v = pr if i == 0 else _rnd(v + pr)
            C[..., j] = v
        hi = _rnd(C)
        tiles = [hi] + ([_rnd(C - hi)] if sl.chain_f32 else [])
        # P: every A tile against every hidden part, float32 sums per range
        p_h = torch.zeros(N, H, f2.BF16_COLS)
        p_b = torch.zeros(N, f2.BF16_COLS)
        for k0, k1 in ranges:
            ph = sum(torch.einsum("nkh,nkj->nhj", hp[:, k0:k1], a[:, k0:k1])
                     for a in tiles for hp in hid)
            pb = sum(torch.einsum("nk,nkj->nj", mp[:, k0:k1], a[:, k0:k1]) for a in tiles for mp in mws)
            p_h, p_b = p_h + ph, p_b + pb
        p_h, p_b = _rnd(p_h), _rnd(p_b)
        # P rows (receiver, d) at depth uu*HP + h, the bias at He
        depth = plan.depth[si]
        rows = torch.zeros(N, d3, depth)
        for uu in range(sl.nu):
            for d in range(d3):
                j = uu * d3 + d
                rows[:, d, uu * plan.HP: uu * plan.HP + H] = p_h[:, :, j]
                rows[:, d, uu * plan.HP + plan.He] = p_b[:, j]
        wt = unpack_slice(weights, plan.w_off[si], sl.mul, depth)
        o = torch.einsum("ndk,wk->nwd", rows, wt) * (1.0 / math.sqrt(sl.fan))
        out[:, sl.out_off: sl.out_off + sl.mul * d3] += o.reshape(N, sl.mul * d3)
    return out


def _case(irreps, rows, K, H1, mixed, seed):
    tp = FullyConnectedTensorProduct(irreps[0], SH, irreps[1])
    x, sh, h, mw, wk, wb = _walk_inputs(tp, rows, K, H1 - 1, seed=seed)
    x = x.to(BF16)
    if not mixed:
        sh, h, mw = sh.to(BF16), h.to(BF16), mw.to(BF16)
    return tp, (x, sh, h, mw, wk, wb)


# the cases of the kernel it replaces (PR 15's bfloat16 walk), then K >= 256
# (the neighbours in two halves) and one SM (every slice in one block)
WALKS = [
    (SCORE, 13, 7, 145, False, None), (SCORE, 9, 33, 17, True, None),
    (CONFIDENCE, 21, 33, 73, False, None), (CONFIDENCE, 3, 1, 145, True, None),
    (HIGH_ORDER, 17, 7, 33, False, None), (CHAIN_F32[0], 11, 9, 49, False, None),
    (CHAIN_F32[1], 7, 12, 25, True, None),
    (CONFIDENCE, 3, 300, 73, False, None), (CHAIN_F32[1], 2, 257, 24, True, None),
    (SCORE, 19, 35, 100, False, 1),
]


@pytest.mark.parametrize("gen", [2, 1])
@pytest.mark.parametrize("irreps,rows,K,H1,mixed,n_sm", WALKS)
def test_walk_rebuilds_the_plain_version(gen, irreps, rows, K, H1, mixed, n_sm):
    """The kernel's blocking walked on the CPU rebuilds
    ``factored_tp_bf16_reference``; ``mixed``: gen 1 with a float32 sh, h
    and mw (the coupling reads sh as float32, h and mw arrive split), gen 2
    with float32 inputs it casts."""
    tp, args = _case(irreps, rows, K, H1, mixed, seed=rows + K)
    ops = (f2 if gen == 2 else f1).prepare(tp, *args)
    assert ops[0].dtype == BF16 and ops[-1].parts == (3 if mixed and gen == 1 else 1)
    ref = f2.factored_tp_bf16_reference(tp, *args, gen=gen)
    got = walk(ops, n_sm or f2.SM_COUNT)
    scale = max(ref.abs().max().item(), 1.0)
    assert (got - ref).abs().max().item() <= RTOL * scale


def _joint_tp(model="diffdock_l"):
    if model == "diffdock_l":
        cfg = PRESETS["diffdock_l"]
        seq = get_irrep_seq(cfg.ns, cfg.nv, False, cfg.reduce_pseudoscalars)
    else:  # the shipped confidence model's width
        seq = get_irrep_seq(24, 6, False, False)
    return FullyConnectedTensorProduct(seq[3], SH, seq[3])


def test_bf16_plan_at_the_main_path_shapes():
    """DiffDock-L's joint-layer TP takes 8 slices (classes (58, 1, 48),
    (78, 3, 10), (40, 3, 10), (20, 1, 10): 1 + 4 + 2 + 1; PR 15's kernel
    took 19), the confidence model's widest 6; one hidden product of width
    144 at H+1 = 145 and 72 at 73; no block shares a class with another,
    so there is no scratch; K >= 256 splits the neighbours."""
    slices, geo, _cg = f2.bf16_geometry(_joint_tp(), 2)
    assert [(sl.fan, sl.d3, sl.mul) for sl in slices if sl.u0 == 0] == [
        (58, 1, 48), (78, 3, 10), (40, 3, 10), (20, 1, 10)]
    assert [sum(1 for sl in slices if sl.cls == c) for c in range(4)] == [1, 4, 2, 1]
    assert all(sl.nu * sl.d3 <= 64 and sl.nw <= 64 and not sl.chain_f32 for sl in slices)
    assert geo.shape == (8, f2.GEO_ROWS, 4)
    cslices = f2.bf16_geometry(_joint_tp("confidence"), 1)[0]
    assert [sum(1 for sl in cslices if sl.cls == c) for c in range(4)] == [1, 2, 2, 1]
    blocks = {"rec<-lig": (3200, 32), "lig<-rec": (320, 320), "rec<-rec": (320, 10),
              "lig<-lig": (320, 32)}
    for label, (rows, K) in blocks.items():
        plan = f2.bf16_plan(slices, rows, K, 144, 118, 9, False, False)
        assert plan.NW == 144 and plan.smem_bytes <= f2.BF16_SMEM_BUDGET, label
        assert plan.k_parts == (2 if K >= 256 else 1), label
        assert plan.n_blocks == plan.n_groups * (1 if plan.whole else 4), label
        assert (block_cover(plan, slices, rows) == 1).all(), label
        assert plan.W == 136 and plan.x_col == 16, label  # 16 harmonic columns + 118
    for rows, K in ((25600, 32), (25600, 6), (320, 2560)):
        plan = f2.bf16_plan(cslices, rows, K, 72, 84, 9, False, False)
        assert plan.NW == 72 and plan.W == 104 and plan.k_parts == (2 if K >= 256 else 1)
        assert plan.w_len == sum(d * sl.mul for d, sl in zip(plan.depth, cslices))


def test_tile_offsets_are_the_tma_swizzle():
    """The coupled tile's byte offsets: a permutation of the tile's 2-byte
    cells, each 8-column group 16 bytes whole, row kk's groups permuted by
    kk % 8 (the 128-byte swizzle of a TMA box of 64 columns, which the gen-3
    kernel's A descriptor reads)."""
    for KC in (16, 32, 64):
        kk, j = np.meshgrid(np.arange(KC), np.arange(64), indexing="ij")
        off = f2.bf16_tile_offset(kk, j)
        assert sorted(off.reshape(-1).tolist()) == list(range(0, KC * 128, 2))
        assert ((off // 128) == kk).all() and (((off % 128) // 16) == ((j // 8) ^ (kk % 8))).all()
        assert ((off % 16) == (j % 8) * 2).all()


def test_prepare_bf16_packs_rows_and_pads_to_multiples_of_8():
    """[sh | x] rows of a multiple of 8 elements (the harmonics in columns
    0-15, a float32 sh as three bfloat16 parts in 0-47 whose sum is exact,
    then x_nbr; zeros between and after); h and mw with rows a
    multiple of 8 apart; gen 1's float32 h and mw as three bfloat16 parts
    whose sum is exact; gen 2 casts."""
    tp = FullyConnectedTensorProduct("8x0e + 2x1o + 1x1e", SH, "8x0e + 2x1o + 2x1e + 2x0o")
    x, sh, h, mw, wk, wb = _walk_inputs(tp, 5, 11, 23, seed=3)  # F = 17, J = 9, H = 23, K = 11
    xb = x.to(BF16)
    xs, hh, mm, cg, w, geo, call = f2.prepare_bf16(tp, xb, sh, h, mw, wk, wb, gen=2)
    assert xs.shape == (5, 11, 40) and call.F == 17 and not call.sh_f32 and call.parts == 1
    assert torch.equal(xs[..., 16:33], xb) and torch.equal(xs[..., :9], sh.to(BF16))
    assert not xs[..., 9:16].any() and not xs[..., 33:].any()
    assert hh.stride(1) == 24 and torch.equal(hh, h.to(BF16))
    assert mm.shape == (5, 1, 11) and mm.stride(0) == 16 and torch.equal(mm[:, 0], mw.to(BF16))
    assert cg.dtype == w.dtype == BF16 and geo.dtype == torch.int32
    xs1, hh1, mm1, *_, call1 = f1.prepare(tp, xb, sh, h, mw, wk, wb)
    assert call1.sh_f32 and xs1.shape[-1] == 72 and torch.equal(xs1[..., 48:65], xb)
    assert torch.equal(xs1[..., :9].float() + xs1[..., 16:25].float() + xs1[..., 32:41].float(), sh)
    assert call1.parts == 3 and hh1.shape == (5, 11, 72) and mm1.shape == (5, 3, 11)
    assert torch.equal(sum(hh1[..., 24 * q: 24 * q + 23].float() for q in range(3)), h)
    assert not hh1[..., 23:24].any() and torch.equal(mm1.float().sum(1), mw)
    # a bfloat16 h of odd H stays bfloat16, rows padded
    ops2 = f1.prepare(tp, xb, sh.to(BF16), h.to(BF16), mw.to(BF16), wk, wb)
    assert ops2[-1].parts == 1 and ops2[1].shape == (5, 11, 23) and not ops2[-1].sh_f32


def test_geometry_reads_each_coupled_column_from_its_path():
    """Each slice's geometry: coupled column (u, d) of path p reads x_nbr's
    entry of p at u*d1 + i and CG-weight column first(p) + i*d3 + d, whose
    row gives p's harmonics and its CG column; the slices of a class cover
    its u once, in order."""
    tp = FullyConnectedTensorProduct(HIGH_ORDER[0], SH, HIGH_ORDER[1])
    specs = f1.build_specs(tp)[0]
    slices, geo, _cg = f2.bf16_geometry(tp, 1)
    for c, s in enumerate(specs):
        mine = [(i, sl) for i, sl in enumerate(slices) if sl.cls == c]
        assert [sl.u0 for _i, sl in mine] == list(np.cumsum([0] + [sl.nu for _i, sl in mine])[:-1])
        assert sum(sl.nu for _i, sl in mine) == s.fan
        for i, sl in mine:
            for j in range(sl.nu * s.d3):
                u, d = sl.u0 + j // s.d3, j % s.d3
                u_off = 0
                for p in s.paths:
                    if u < u_off + p.mul:
                        break
                    u_off += p.mul
                xo, d1, w0 = geo[i, j, :3]
                assert (xo, d1) == (p.x_start + (u - u_off) * p.d1, p.d1)
                for t in range(d1):
                    sh0, d2, col = geo[i, f2.BF16_COLS + w0 + t * s.d3, :3]
                    assert (sh0, d2, col) == (p.sh_start, p.d2, p.cg_col + t * s.d3 + d)


@pytest.mark.parametrize("H", [145, 200, 256])
def test_bf16_plan_refuses_more_hidden_channels_than_its_widest_product(H):
    """The hidden product is one wgmma of width 32, 72 or 144 (DiffDock-L's
    H = 144 the widest of any preset): H past 144 is refused with a
    ValueError, which a bfloat16 CUDA call raises; 144 is taken."""
    slices = f2.bf16_geometry(_joint_tp(), 2)[0]
    assert f2.bf16_plan(slices, 37, 33, 144, 118, 9, False, 1).NW == 144
    with pytest.raises(ValueError, match="1..144 hidden channels"):
        f2.bf16_plan(slices, 37, 33, H, 118, 9, False, 1)
