"""A CPU walk of the bfloat16 kernel's blocking (``csrc/fused_tp3_bf16.cu``).

The kernel runs only on the card. This walk repeats its index math on the
CPU, from the operands as ``prepare`` hands them over in bfloat16 (``h``
and ``mw`` apart, ``coupled`` and ``h`` with rows padded to a multiple of 8
elements, the weights packed per column slice in swizzled 64-deep chunks):
receiver groups of ``R``, the column slices with their start columns (64-
column boxes from the 16-byte aligned column at or below, the slice at its
offset in the box, zeros past the tensor's edge), the hidden product of width
``NW`` plus the bias row formed from ``mw``, the neighbour stages of ``KC``
(zeros past ``K``) split in two halves whose partial sums are added in the
kernel's order, P rounded to bfloat16 after the whole sum and laid out at
depth ``u*HP + h``, the weight product's four depth phases added in order,
and the slices of a class added in a block or through scratch parts.
Products of bfloat16 values are exact and summed in float32 (within a
product, and over a class's slices, in the walk's own order: each of the
kernel's blocks takes its slices and weight chunks in an order of its own,
which moves float32 roundings only). It must rebuild the bfloat16
``fused_tp3_reference``, and in one case JAX's
``_tp_message_reduced(dtype="bfloat16")``, so an indexing fault shows
before the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffdock_tpu.models.tpconv import NeighborBlock as JBlock
from diffdock_tpu.models.tpconv import _tp_message_reduced as j_reduced
from diffdock_tpu.ops import tensor_product as j_tp
from diffdock_tpu_torch.models.tpconv import NeighborBlock, _tp_message_reduced
from diffdock_tpu_torch.ops import fused_tp3 as ft
from diffdock_tpu_torch.ops.irreps import get_irrep_seq
from diffdock_tpu_torch.ops.tensor_product import FullyConnectedTensorProduct
from tests.test_torch_port_bf16 import IN_IR, MESSAGE_RTOL, OUT_IR, SH_IR, _fc_pair, _message_inputs

SH = "1x0e + 1x1o + 1x2e"
BF16 = torch.bfloat16
RTOL = 1e-3  # one bfloat16 ulp of P at a rounding tie, as the card tests


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rnd(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF16).float()


def unpack_slice(weights: torch.Tensor, sl, mul: int) -> torch.Tensor:
    """Slice ``sl``'s packed chunks back to Wt (mul, depth): chunk j holds
    [mul][64 depth] with the 8-element group q of row w at q ^ (w & 7)."""
    n_sub = sl.depth // 64
    chunks = weights[sl.w_off: sl.w_off + n_sub * mul * 64].float().reshape(n_sub, mul, 8, 8)
    w = torch.arange(mul)[:, None]
    stored = torch.arange(8)[None, :] ^ (w & 7)  # where logical group q lies
    logical = chunks[:, w, stored]  # (n_sub, mul, 8 groups, 8)
    return logical.permute(1, 0, 2, 3).reshape(mul, sl.depth)


def walk(h, coupled, weights, table, mw, n_sm=ft.SM_COUNT):
    """The kernel's result (N, W_tot) from prepared bfloat16 operands."""
    N, K, H = h.shape
    F = coupled.shape[2]
    plan = ft.bf16_plan(table, N, K, H, n_sm)
    w_tot = int((table[:, 3] * table[:, 2]).sum())
    R, G, KC = plan.R, plan.n_groups, plan.KC
    n_st = plan.n_kc if plan.k_parts == 1 else 2 * plan.h0  # stages read, the last ones past K
    Np, Kp = G * R, n_st * KC
    # what TMA and the mw loads deliver: zeros past N, K, H and F
    hp = torch.zeros(Np, Kp, plan.NW)
    hp[:N, :K, :H] = h.float()
    mwp = torch.zeros(Np, Kp)
    mwp[:N, :K] = mw.float()
    cp = torch.zeros(Np, Kp, F + 64)
    cp[:N, :K, :F] = coupled.float()
    # the neighbour stages of each part, in the order the parts are added
    if plan.k_parts == 1:
        halves = [slice(0, Kp)]
    else:
        halves = [slice(0, plan.h0 * KC), slice(plan.h0 * KC, 2 * plan.h0 * KC)]
    obuf = torch.zeros(Np, w_tot)  # the blocks' sums over their slices, in slice order
    parts = torch.zeros(plan.s_max, Np, w_tot)  # one slice per block: the scratch parts
    for sl in plan.slices:
        d3, mul, nu = sl.d3, sl.mul, sl.nu
        # 64 columns from the 8-aligned column at or below the slice's first
        box = cp[:, :, sl.f_col - sl.off: sl.f_col - sl.off + 64]
        acc = accb = 0.0
        for ks in halves:  # float32 partial sums, added first half + second half
            acc = acc + torch.bmm(box[:, ks].transpose(1, 2), hp[:, ks])  # (Np, 64, NW)
            accb = accb + torch.bmm(box[:, ks].transpose(1, 2), mwp[:, ks, None])[..., 0]
        # P rounded after the whole sum, rows (r, d), depth uu*HP + h
        p = torch.zeros(Np, d3, sl.depth)
        for j in range(nu * d3):
            uu, d = divmod(j, d3)
            m = sl.off + j  # the slice's column j is row off + j of the box
            p[:, d, uu * plan.HP: uu * plan.HP + plan.He] = _rnd(acc[:, m, : plan.He])
            p[:, d, uu * plan.HP + plan.He] = _rnd(accb[:, m])
        wt = unpack_slice(weights, sl, mul)  # (mul, depth)
        # the four depth phases (k16 step kk of every 64-deep chunk), in order
        ph = [sum(wt[:, c * 64 + kk * 16: c * 64 + kk * 16 + 16]
                  @ p.reshape(Np * d3, sl.depth)[:, c * 64 + kk * 16: c * 64 + kk * 16 + 16].T
                  for c in range(sl.depth // 64)) for kk in range(4)]
        o = (((0.0 + ph[0]) + ph[1]) + ph[2]) + ph[3]  # (mul, Np*d3)
        o = o.T.reshape(Np, d3, mul).transpose(1, 2).reshape(Np, mul * d3)
        cols = slice(sl.out_off, sl.out_off + mul * d3)
        if plan.whole:
            obuf[:, cols] += o
        else:
            parts[sl.part, :, cols] = o
    if plan.whole:
        return obuf[:N]
    out = torch.zeros(Np, w_tot)
    for sl in plan.slices:
        if sl.part == 0:
            cols = slice(sl.out_off, sl.out_off + sl.mul * sl.d3)
            for q in range(sl.n_parts):
                out[:, cols] += parts[q, :, cols]
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
    return [a.to(BF16) for a in (x, sh, h, mw)] + [wk, wb]


def _tp(ns, nv, ladder, rp):
    seq = get_irrep_seq(ns, nv, False, rp)
    return FullyConnectedTensorProduct(seq[ladder[0]], SH, seq[ladder[1]])


SCORE = (48, 10, (3, 3), True)  # DiffDock-L's joint layers: F_tot 432
CONFIDENCE = (24, 6, (3, 3), False)  # the shipped confidence model's widest TP: 312
SCORE_EMB1 = (48, 10, (1, 2), True)  # rec_emb_1: F_tot 292, slices starting on odd columns
NARROW = (8, 4, (3, 3), True)


# the card tests' bfloat16 shapes (rows 1, K 1, H+1 = 100 among them) and the
# main path's: rec<-lig (3200, 32, 145), lig<-rec (320, 320, 145), the
# confidence lig<-atom (320, 2560, 73)
@pytest.mark.parametrize("model,rows,K,H1", [
    (SCORE, 3200, 32, 145), (SCORE, 320, 320, 145), (CONFIDENCE, 320, 2560, 73),
    (SCORE, 67, 33, 73), (SCORE, 13, 320, 145), (SCORE, 9, 7, 17), (SCORE, 61, 35, 100),
    (SCORE, 1, 1, 145), (SCORE_EMB1, 37, 19, 145), (NARROW, 5, 257, 33), (CONFIDENCE, 40, 6, 73),
])
def test_walk_rebuilds_the_plain_version(model, rows, K, H1):
    tp = _tp(*model)
    args = _inputs(tp, rows, K, H1 - 1, seed=rows + K)
    classes, h, coupled, weights, table, mw = ft.prepare(tp, *args)
    ref = ft.fused_tp3_reference(tp, *args)
    got = ft._scatter_classes(tp, classes, walk(h, coupled, weights, table, mw))
    scale = max(ref.abs().max().item(), 1.0)
    assert (got - ref).abs().max().item() <= RTOL * scale


def test_prepare_pads_rows_to_multiples_of_8():
    """H = 99 and F_tot = 292: both land in row-padded buffers, seen through
    views of the true widths; the padding is zero."""
    tp = _tp(*SCORE_EMB1)
    args = _inputs(tp, 6, 5, 99, seed=1)
    _classes, h, coupled, _w, _t, mw = ft.prepare(tp, *args)
    assert h.shape == (6, 5, 99) and h.stride() == (5 * 104, 104, 1)
    assert coupled.shape == (6, 5, 292) and coupled.stride() == (5 * 296, 296, 1)
    assert torch.equal(h, args[2]) and torch.equal(mw, args[3])
    assert mw.shape == (6, 5) and mw.stride() == (8, 1)
    full = torch.as_strided(coupled, (6, 5, 296), coupled.stride())
    assert torch.all(full[..., 292:] == 0)


def test_packed_weights_round_like_the_model_path():
    """The packed chunks hold bf16(f32(bf16(T)) / sqrt(fan)) at depth
    u*HP + h, the bias at h = He, zeros elsewhere."""
    tp = _tp(*NARROW)
    args = _inputs(tp, 3, 4, 7, seed=2)
    classes, _h, _c, weights, table, _mw = ft.prepare(tp, *args)
    plan = ft.bf16_plan(table, 3, 4, 7)
    assert (plan.He, plan.HP) == (8, 10)
    blocks = ft.class_weights(tp, classes, args[4], args[5], BF16)
    for sl in plan.slices:
        wt = unpack_slice(weights, sl, sl.mul).reshape(sl.mul, -1)
        blk = blocks[sl.cls].float()[:, sl.u0: sl.u0 + sl.nu]  # (8, nu, mul)
        want = torch.zeros(sl.mul, sl.nu, plan.HP)
        want[:, :, :7] = blk[:7].permute(2, 1, 0)
        want[:, :, 8] = blk[7].T
        assert torch.equal(wt[:, : sl.nu * plan.HP], want.reshape(sl.mul, -1))
        assert torch.all(wt[:, sl.nu * plan.HP:] == 0)


def test_walk_matches_jax_message_in_bf16():
    """The walk inside the port's message function against JAX's
    ``_tp_message_reduced(dtype="bfloat16")``, the FC's last layer on the
    bfloat16 grid, at the message tolerance of test_torch_port_bf16.py."""
    tp, jtp = FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR), j_tp.FullyConnectedTensorProduct(IN_IR, SH_IR, OUT_IR)
    a = _message_inputs(tp, seed=8, R=40, K=20)
    jfc, params, fc = _fc_pair(a["eattr"].shape[-1], 48, tp.weight_numel, "bfloat16", seed=9)
    on_grid = lambda v: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    params = jax.tree.map(np.asarray, params)
    for name in ("out_kernel", "out_bias"):
        params["params"][name] = on_grid(params["params"][name])
    with torch.no_grad():
        fc.out_kernel.copy_(torch.from_numpy(params["params"]["out_kernel"]))
        fc.out_bias.copy_(torch.from_numpy(params["params"]["out_bias"]))
    jblk = JBlock(*[jnp.asarray(a[k]) for k in ("sender", "idx", "mask", "eattr", "esh", "ew")])
    ref = np.asarray(jax.jit(lambda p: jfc.apply(p, method=lambda m: j_reduced(
        jtp, m, jblk, False, "bfloat16", merged=True)))(params)[0])
    blk = NeighborBlock(torch.from_numpy(a["sender"])[None], torch.from_numpy(a["idx"]).long()[None],
                        torch.from_numpy(a["mask"])[None], torch.from_numpy(a["eattr"])[None],
                        torch.from_numpy(a["esh"])[None], torch.from_numpy(a["ew"])[None])

    def walked(tp_, *inputs):
        classes, *ops = ft.prepare(tp_, *inputs)
        return ft._scatter_classes(tp_, classes, walk(*ops))

    with torch.no_grad():
        ours = _tp_message_reduced(tp, fc, blk, dtype="bfloat16", contraction=walked)[0][0].numpy()
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(ours - ref).max() <= MESSAGE_RTOL * scale


def test_plan_covers_every_receiver_column_and_hidden_row_once():
    """DiffDock-L's joint-layer TP: classes (58, 1, 48), (78, 3, 10), (40, 3,
    10), (20, 1, 10) -> 1 + 4 + 2 + 1 slices; each (receiver, column) lies
    in exactly one block's slice, whose hidden product spans all 144 rows
    and the bias; neighbour stages cover K once. The lig<-rec block (320,
    320) and the confidence lig<-atom block (320, 2560, 73) split each
    receiver's neighbours in 2 parts (3 and 20 stages of 64)."""
    tp = _tp(*SCORE)
    table = ft.bf16_class_table(tp.live_classes(), 145)
    assert [tuple(r[:4]) for r in table.tolist()] == [(0, 58, 1, 48), (58, 78, 3, 10),
                                                     (292, 40, 3, 10), (412, 20, 1, 10)]
    for rows, K in ((3200, 32), (320, 320), (320, 10), (7, 1)):
        plan = ft.bf16_plan(table, rows, K, 144)
        # slices start anywhere, the boxes on multiples of 8 columns
        assert [sl.f_col for sl in plan.slices] == [0, 58, 118, 175, 232, 292, 352, 412]
        assert all(sl.off == sl.f_col % 8 and sl.off + sl.nu * sl.d3 <= 64 for sl in plan.slices)
        assert plan.NW >= 144 and plan.He == 144 and plan.HP == 146
        seen = np.zeros((rows, 432), np.int64)
        for b in range(plan.n_blocks):
            g = b if plan.whole else b // len(plan.slices)
            sls = plan.slices if plan.whole else [plan.slices[b % len(plan.slices)]]
            r = np.arange(g * plan.R, min((g + 1) * plan.R, rows))
            for sl in sls:
                seen[r[:, None], np.arange(sl.f_col, sl.f_col + sl.nu * sl.d3)[None]] += 1
        assert np.all(seen == 1)
        # K in n_kc stages; split in halves, the second may have one stage past K
        assert (plan.n_kc - 1) * plan.KC < K <= plan.n_kc * plan.KC
        assert plan.k_parts == 1 or 2 * plan.h0 - plan.n_kc in (0, 1)
    main = ft.bf16_plan(table, 3200, 32, 144)
    assert main.whole and main.R == 8 and main.k_parts == 1 and main.n_blocks == 400
    lig_rec = ft.bf16_plan(table, 320, 320, 144)
    assert lig_rec.k_parts == 2 and lig_rec.KC == 64 and lig_rec.h0 == 3
    # the confidence model's (42, 3) classes start 1 column past an 8-aligned
    # one (3 and 2 zero columns before them), and take 2 boxes each, not 3
    conf = _tp(*CONFIDENCE)
    ctable = ft.bf16_class_table(conf.live_classes(), 73)
    assert ctable[:, 0].tolist() == [0, 33, 161, 287]
    lig_atom = ft.bf16_plan(ctable, 320, 2560, 72)
    assert len(lig_atom.slices) == 6 and [sl.nu for sl in lig_atom.slices] == [30, 21, 21, 21, 21, 30]
    assert lig_atom.k_parts == 2 and lig_atom.KC == 64 and lig_atom.h0 == 20 and not lig_atom.whole
    assert lig_atom.n_blocks == -(-320 // lig_atom.R) * 6 >= 2 * ft.SM_COUNT


def test_plan_takes_no_odd_ring_when_each_block_runs_every_slice():
    """Three ring slots failed on the card with every slice in one block
    (the v1.0 score model's first TP, 48x0e -> 48x0e + 10x1o, at its
    rec<-lig block of 4480 rows and 64 neighbours), and with one slice per
    block too (the same TP as DiffDock-L's ligand embedding, 768 rows of
    96 neighbours: 8 poses of the cover ladder's (96, 2304) bucket). Such
    plans take the next stage width with an even ring, in either mode
    (DiffDock-L's ligand embedding at 640 and 768 rows)."""
    tp = FullyConnectedTensorProduct("48x0e", "1x0e + 1x1o + 1x2e", "48x0e + 10x1o")
    table = ft.bf16_class_table(tp.live_classes(), 145)
    for rows in (4480, 20480):
        plan = ft.bf16_plan(table, rows, 64, 144)
        assert plan.whole and plan.S % 2 == 0 and (plan.KC, plan.S) == (32, 4)
    for rows, K in ((640, 64), (768, 96)):
        few = ft.bf16_plan(table, rows, K, 144)
        assert not few.whole and (few.KC, few.S) == (32, 4)


def ring_hazard(S: int, k_parts: int, n_q: int, h0: int, n_w: int, n_slices: int):
    """Search every interleaving of the bf16 kernel's ring protocol for a
    wait that passes before its stage has landed; return the first such
    (slot, use, fills landed) or None.

    The model is the kernel's: ``S`` producers, one per slot, each issuing
    the items of its slot in ring order after ``mbar_wait(empty, phase ^ 1)``;
    a stage lands (completes a ``full`` phase) at any later moment; per
    slice, ``2 n_q`` P items that alternate between the two consumer
    warpgroups (with ``k_parts`` 2, both meet at a named barrier after every
    ``h0`` of their items), a named barrier, then ``n_w`` weight items that
    both wait on, and a barrier. A consumer waits ``mbar_wait(full, phase)``,
    which passes whenever the barrier's completed phases differ in parity
    from ``phase``, and releases the slot (a P item's warpgroup gives all
    eight arrivals, each warpgroup four of a weight item's)."""
    items, progs = [], ([], [])
    for _ in range(n_slices):
        for w in range(2 * n_q):
            g = w & 1
            progs[g].append(("wait", len(items)))
            items.append((g,))
            if k_parts == 2 and (w >> 1) % h0 == h0 - 1:
                progs[g].append(("bar",))
        for prog in progs:
            prog.append(("bar",))
        for _ in range(n_w):
            for prog in progs:
                prog.append(("wait", len(items)))
            items.append((0, 1))
        for prog in progs:
            prog.append(("bar",))
    bars = [[sum(op == ("bar",) for op in prog[:pc]) for pc in range(len(prog) + 1)] for prog in progs]

    def arrived(g, pc):  # barriers consumer g has reached
        return bars[g][pc] + (pc < len(progs[g]) and progs[g][pc] == ("bar",))

    start = (tuple(range(S)), (0,) * S, (0,) * S, (0,) * S, ((),) * S, 0, 0)
    seen, todo = {start}, [start]
    while todo:
        nxt, full, empty, arr, flight, *pcs = todo.pop()
        moves = []
        for s in range(S):
            i = nxt[s]
            if i < len(items) and (empty[s] & 1) == (i // S & 1):
                if empty[s] != i // S:
                    return ("producer", s, i // S, empty[s])
                moves.append(((s,), nxt[:s] + (i + S,) + nxt[s + 1:], full, empty, arr,
                              flight[:s] + (flight[s] + (i,),) + flight[s + 1:], *pcs))
            if flight[s]:
                moves.append(((), nxt, full[:s] + (full[s] + 1,) + full[s + 1:], empty, arr,
                              flight[:s] + (flight[s][1:],) + flight[s + 1:], *pcs))
        for g in (0, 1):
            pc = pcs[g]
            if pc == len(progs[g]):
                continue
            new_pcs = list(pcs)
            new_pcs[g] = pc + 1
            if progs[g][pc] == ("bar",):
                if arrived(1 - g, pcs[1 - g]) > bars[g][pc]:
                    moves.append(((), nxt, full, empty, arr, flight, *new_pcs))
                continue
            i = progs[g][pc][1]
            s, use = i % S, i // S
            if (full[s] & 1) == (use & 1):
                continue
            if full[s] != use + 1:
                return ("consumer", s, use, full[s])
            a = arr[s] + (2 if len(items[i]) == 1 else 1)
            e, a = (empty[s] + 1, 0) if a == 2 else (empty[s], a)
            moves.append(((), nxt, full, empty[:s] + (e,) + empty[s + 1:], arr[:s] + (a,) + arr[s + 1:],
                          flight, *new_pcs))
        for _, *state in moves:
            state = tuple(state)
            if state not in seen:
                seen.add(state)
                todo.append(state)
    return None


@pytest.mark.parametrize("k_parts,h0", [(1, 1), (2, 3)])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_ring_protocol_holds_only_with_an_even_slot_count(S, k_parts, h0):
    """Why an odd ring hung on the card (cudaError 719, the wait's trap):
    with S odd, consecutive uses of one slot go to different warpgroups, so
    a warpgroup one lap ahead of the other waits on its slot while the
    other's stage is still in flight; ``mbar_wait`` tells phases apart by
    parity only, sees the phase before that one complete and passes, reads
    the stage early and releases the slot a phase early, and the ring's
    counts never meet again. With S even, every slot's P items go to one
    warpgroup, which waits on each of its stages in order, and weight items
    follow a barrier that every earlier item has passed: no wait can pass
    early. The search covers every interleaving of two slices."""
    found = ring_hazard(S, k_parts, n_q=S + 1, h0=h0, n_w=2, n_slices=2)
    if S % 2:
        assert found is not None and found[0] == "consumer"
        _, slot, use, landed = found
        assert landed == use - 1  # the stage before is still in flight
    else:
        assert found is None


@pytest.mark.parametrize("model", ["diffdock_l", "diffdock_s"])
def test_plans_take_an_even_ring_at_every_block(model):
    """The plan never takes an odd ring (see the protocol test above): at
    every layer's TP of the model, over row counts from 8 to 40000 and
    neighbour counts from 1 to 2560."""
    from diffdock_tpu_torch.models.config import PRESETS

    cfg = PRESETS[model]
    seq = get_irrep_seq(cfg.ns, cfg.nv, False, cfg.reduce_pseudoscalars)
    for a, b in [(0, 1), (1, 2), (2, 3), (3, 3)]:
        tp = FullyConnectedTensorProduct(seq[a], SH, seq[b])
        table = ft.bf16_class_table(tp.live_classes(), 3 * cfg.ns + 1)
        for rows in (8, 320, 768, 4480, 40000):
            for K in (1, 16, 32, 48, 64, 96, 128, 320, 2560):
                plan = ft.bf16_plan(table, rows, K, 3 * cfg.ns)
                assert plan.S in (2, 4), (a, b, rows, K, plan.S)
