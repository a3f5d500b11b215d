"""Gen-3 fused factored TP contraction: the Hopper kernel and its plain version.

Port of ``diffdock_tpu/ops/pallas_tpconv3.py``. Both functions take the
arguments of the TPU kernel's ``_forward_pallas``:

    f(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias) -> (N, dim_out) f32

``x_nbr`` (N, K, dim_in1) gathered senders, ``edge_sh`` (N, K, dim_in2),
``h`` (N, K, H) hidden activations already scaled by ``mw``, ``mw`` (N, K)
mask*edge_weight, ``out_kernel`` (H, weight_numel) and ``out_bias``
(weight_numel,) the weight-generating FC's last layer. The result is the
neighbour SUM of the tensor-product messages (``_tp_message_reduced``
semantics), in e3nn layout, with empty output classes zero.

* :func:`fused_tp3` builds the merged coupled tensor and the per-class
  weight blocks in torch, then launches ``csrc/fused_tp3.cu`` (which
  replaces the TPU kernel ``pallas_tpconv3.py:_kernel``; tensor-core
  products in 3xTF32, float32 accuracy), or for bfloat16 operands
  ``csrc/fused_tp3_bf16.cu`` (TMA-fed ``wgmma``). On a CPU tensor
  it runs :func:`fused_tp3_reference` instead; on a CUDA tensor it
  launches the kernel or raises. When a gradient is wanted it runs as a
  ``torch.autograd.Function`` (:class:`PlainVJP`) whose backward is the VJP of
  the plain version, as the TPU kernel's ``custom_vjp`` backward is the VJP
  of its einsum path (``pallas_tpconv3.py:make_fused_tp_messages``).
* :func:`fused_tp3_reference` is the plain version: the two einsums of the
  JAX package's merged branch (``models/tpconv.py:_tp_message_reduced``,
  ``merged=True``) against the block-diagonal (H+1, F_tot, W_tot) weight
  tensor. The CPU tests and the card check use it.

Both take float32 or bfloat16 ``x_nbr``, ``edge_sh``, ``h`` and ``mw`` (the
conv layer's compute dtype; ``out_kernel`` and ``out_bias`` are float32
parameters). In bfloat16 they compute what ``_tp_message_reduced(dtype=
"bfloat16")`` computes: the coupling in bfloat16 arithmetic, ``P`` summed in
float32 from exact products and rounded to bfloat16, the weight blocks
rounded as JAX rounds its ``t3`` (``bf16(f32(bf16(T)) / sqrt(fan))``), the
weight product summed in float32 into a float32 output. The plain version
upcasts bfloat16 operands to float32 before each product (a bfloat16 matmul
in torch would round its output). The bfloat16 kernel takes ``h`` and
``mw`` apart (no ``h_aug``: it forms the bias row itself), ``coupled`` with
its rows padded to a multiple of 8 elements, and the weights packed per
column slice in the chunks its weight product reads (:func:`bf16_plan`,
:func:`pack_bf16_weights`). bfloat16 inputs that need a gradient raise: no
JAX entry point trains in bfloat16.

Each keeps a count of its launches in :data:`counts` (the kernel's two
modes apart: ``fused_tp3`` and ``fused_tp3_bf16``); the backward counts its
calls as ``fused_tp3_vjp``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from diffdock_tpu_torch.utils import build

_SOURCES = ("fused_tp3.cu", "fused_tp3_bf16.cu")


class LaunchCounts:
    """Integer launch counters, one per function name."""

    def __init__(self, *names: str):
        self._n: Dict[str, int] = {n: 0 for n in names}

    def add(self, name: str) -> None:
        self._n[name] += 1

    def __getitem__(self, name: str) -> int:
        return self._n[name]

    def reset(self) -> None:
        for n in self._n:
            self._n[n] = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(self._n)


counts = LaunchCounts("fused_tp3", "fused_tp3_bf16", "fused_tp3_reference", "fused_tp3_vjp")

# the operand dtypes the kernel takes, with the launch count of each mode
_MODES = {torch.float32: "fused_tp3", torch.bfloat16: "fused_tp3_bf16"}


def merged_coupled(tp, x_nbr: torch.Tensor, edge_sh: torch.Tensor):
    """(classes, coupled (N, K, F_tot)) over the live output classes;
    ``classes`` is ``tp.live_classes()``."""
    classes = tp.live_classes()
    parts = [tp.coupled_class_merged(k, x_nbr, edge_sh) for k, *_ in classes]
    return classes, torch.cat(parts, dim=-1)


def class_weights(tp, classes, out_kernel: torch.Tensor, out_bias: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """Per live class the (H+1, fan, mul) block: last-layer weights, then the
    bias as row H, with 1/sqrt(fan) folded in. In bfloat16 as the JAX model
    path rounds them: the weights to bfloat16, the product with the float32
    scale in float32, that to bfloat16 again."""
    H = out_kernel.shape[0]
    blocks = []
    for _k, offset, fan, _d3, mul in classes:
        t_k = out_kernel[:, offset : offset + fan * mul].reshape(H, fan, mul)
        b_k = out_bias[offset : offset + fan * mul].reshape(1, fan, mul)
        blk = torch.cat([t_k, b_k], dim=0).to(dtype).float() * (1.0 / math.sqrt(fan))
        blocks.append(blk.to(dtype))
    return blocks


def _scatter_classes(tp, classes, merged: torch.Tensor) -> torch.Tensor:
    """Re-insert zero blocks for empty classes (kernel/merged output is the
    live classes, contiguous, in e3nn order)."""
    if len(classes) == len(tp.irreps_out):
        return merged
    live = {k for k, *_ in classes}
    parts, w_off = [], 0
    for k, ek in enumerate(tp.irreps_out):
        if k in live:
            parts.append(merged[:, w_off : w_off + ek.dim])
            w_off += ek.dim
        else:
            parts.append(merged.new_zeros(merged.shape[0], ek.dim))
    return torch.cat(parts, dim=-1)


def fused_tp3_reference(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """Plain PyTorch version: ``P = h_aug @ coupled``, then
    ``out = sum_h P[:, h] @ T3[h]`` with T3 block-diagonal (H+1, F_tot, W_tot)."""
    counts.add("fused_tp3_reference")
    return _plain(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)


def _plain(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    N = x_nbr.shape[0]
    if not tp.live_classes():
        return x_nbr.new_zeros(N, tp.irreps_out.dim, dtype=torch.float32)
    classes, coupled = merged_coupled(tp, x_nbr, edge_sh)
    f_tot = coupled.shape[-1]
    w_tot = sum(mul * d3 for *_r, d3, mul in classes)
    h_aug = torch.cat([h, mw[..., None].to(h.dtype)], dim=-1)
    # float32 products of the operands' values (bfloat16 ones are exact),
    # float32 sums; in bfloat16 P is rounded to bfloat16, as in the JAX path
    p = torch.einsum("rkh,rkF->rhF", h_aug.float(), coupled.float())  # (N, H+1, F_tot)
    p = p.to(h.dtype).float()

    H1 = h_aug.shape[-1]
    t3 = coupled.new_zeros(H1, f_tot, w_tot, dtype=torch.float32)
    f_off = w_off = 0
    for (_k, _o, fan, d3, mul), blk in zip(
        classes, class_weights(tp, classes, out_kernel, out_bias, h.dtype)
    ):
        tt = tp.expand_weight_identity(blk.float(), d3).reshape(H1, fan * d3, mul * d3)
        t3[:, f_off : f_off + fan * d3, w_off : w_off + mul * d3] = tt
        f_off += fan * d3
        w_off += mul * d3
    merged = torch.einsum("rhF,hFW->rW", p, t3)
    return _scatter_classes(tp, classes, merged)


class _Kernel:
    """The loaded library with its ``argtypes`` set."""

    def __init__(self):
        lib = build.load("fused_tp3", _SOURCES)
        fn = lib.fused_tp3_forward
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        self.forward = fn
        fb = lib.fused_tp3_bf16_forward
        fb.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fb.restype = ctypes.c_int
        self.forward_bf16 = fb
        plan = lib.fused_tp3_bf16_plan
        plan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        plan.restype = ctypes.c_int
        self.plan_bf16 = plan
        scratch = lib.fused_tp3_scratch_floats
        scratch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int]
        scratch.restype = ctypes.c_longlong
        for name in ("fused_tp3_max_classes", "fused_tp3_max_outputs", "fused_tp3_max_columns"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        self.scratch_floats = scratch
        self.max_classes = lib.fused_tp3_max_classes()
        self.max_outputs = lib.fused_tp3_max_outputs()
        self.max_columns = lib.fused_tp3_max_columns()


_kernel = None


def _get_kernel() -> _Kernel:
    global _kernel
    if _kernel is None:
        _kernel = _Kernel()
    return _kernel


def class_table(classes, H1: int) -> np.ndarray:
    """(n_classes, 6) int64 rows (f_off, fan, d3, mul, out_off, w_off) for
    the live classes; w_off indexes the packed (H1, fan, mul) blocks."""
    rows = []
    f_off = out_off = w_off = 0
    for _k, _o, fan, d3, mul in classes:
        rows.append((f_off, fan, d3, mul, out_off, w_off))
        f_off += fan * d3
        out_off += mul * d3
        w_off += H1 * fan * mul
    return np.asarray(rows, dtype=np.int64).reshape(-1, 6)


# the kernel's blocking (csrc/fused_tp3.cu): 16 receivers per block, P
# column slices of at most 64 columns (whole u groups of d3, balanced, an
# even number of them where that fits), hidden rows in groups of 32 (16
# when H+1 <= 16)
TILE_ROWS = 16
SLICE_COLS = 64


class TilePlan(NamedTuple):
    """How the kernel cuts one call: ``hidden_rows`` per group, ``n_groups``
    groups, per class ``us`` u per column slice and ``n_slices`` slices,
    ``s_max`` the most slices of a class; partial outputs go to
    ``n_groups * s_max`` scratch parts unless that is 1."""

    hidden_rows: int
    n_groups: int
    us: Tuple[int, ...]
    n_slices: Tuple[int, ...]
    s_max: int

    def scratch_floats(self, n_rows: int, w_tot: int) -> int:
        parts = self.n_groups * self.s_max
        return 0 if parts == 1 else parts * n_rows * w_tot


def tile_plan(table: np.ndarray, H1: int) -> TilePlan:
    """The kernel's :class:`TilePlan` for a class table (mirrors its
    ``make_plan``)."""
    hr = 16 if H1 <= 16 else 32
    us, n_slices = [], []
    for fan, d3 in table[:, 1:3].tolist():
        # the fewest slices of at most 64 columns, balanced; an even number
        # of u per slice where that fits
        us_max = SLICE_COLS // d3
        n = -(-fan // us_max)
        u = -(-fan // n)
        us.append(u + 1 if u % 2 and u < us_max else u)
        n_slices.append(n)
    return TilePlan(hr, -(-H1 // hr), tuple(us), tuple(n_slices), max(n_slices))


# the bfloat16 kernel's blocking (csrc/fused_tp3_bf16.cu, make_plan): hidden
# products of these widths, column slices of whole u groups in 64-column
# boxes, 227 KB of shared memory a block
BF16_WIDTHS = (32, 72, 144, 256)
BF16_SMEM_BUDGET = 232448
BF16_MAX_SLICES = 48
BF16_TILES = 4  # weight-product tiles per warp per pass
SM_COUNT = 132  # an H100 SXM's SMs


class Slice(NamedTuple):
    """One column slice of a class: ``nu`` whole u groups from ``u0``
    (columns ``f_col`` .. ``f_col + nu*d3`` of ``coupled``, at offset
    ``off = f_col % 8`` in the 64-column box that starts on the 8-aligned
    column below: TMA boxes start on 16-byte aligned columns), the weight
    product's depth (``nu*HP`` rounded up to 64), the slice's ``part`` of
    its class's ``n_parts`` and the element offset of its packed weights."""

    cls: int
    f_col: int
    off: int
    u0: int
    nu: int
    fan: int
    d3: int
    mul: int
    out_off: int
    depth: int
    part: int
    n_parts: int
    w_off: int


class Bf16Plan(NamedTuple):
    """How the bfloat16 kernel cuts one call (mirrors its ``make_plan``):
    the slices; P's rows per u (``HP``: the hidden rows rounded up to even,
    ``He``, then the bias row and a zero row); the hidden product's width
    ``NW``; ``R`` receivers per block; ``whole`` (every slice in each block)
    or one slice per block; ``k_parts`` (2: the two consumer warpgroups
    split each receiver's neighbours in halves of ``h0`` stages of ``KC``);
    ``S`` ring slots; shared memory, blocks, packed weight elements."""

    slices: Tuple[Slice, ...]
    H: int
    He: int
    HP: int
    NW: int
    R: int
    whole: bool
    k_parts: int
    KC: int
    n_kc: int
    h0: int
    S: int
    smem_bytes: int
    n_groups: int
    n_blocks: int
    s_max: int
    w_len: int

    def scratch_floats(self, n_rows: int, w_tot: int) -> int:
        return 0 if self.whole or self.s_max == 1 else self.s_max * n_rows * w_tot

    def as_ints(self, n_rows: int, w_tot: int) -> List[int]:
        """The numbers ``fused_tp3_bf16_plan`` reports."""
        return [self.R, int(self.whole), self.k_parts, self.KC, self.S, self.NW, self.smem_bytes,
                self.n_blocks, self.scratch_floats(n_rows, w_tot)]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _cut(f_off: int, fan: int, d3: int, us: int) -> List[int]:
    """The u counts of a class's slices at most ``us`` u wide: each slice's
    columns, plus its offset from the 8-aligned column at or below its
    first, fit a 64-column box."""
    nus, u = [], 0
    while u < fan:
        nus.append(min(us, (64 - (f_off + u * d3) % 8) // d3, fan - u))
        u += nus[-1]
    return nus


def bf16_class_table(classes, H1: int) -> np.ndarray:
    """:func:`class_table` for the bfloat16 kernel: each class starts up to
    7 columns right of the previous one's end (zero columns between), the
    fewest that give it its fewest 64-column boxes. TMA boxes start on
    8-aligned columns, so the start decides how many slices a class takes:
    the confidence model's (42, 3) classes take 2 from a start at 1 mod 8,
    3 from 0 mod 8."""
    table = class_table(classes, H1)
    end = 0
    for row in table:
        fan, d3 = int(row[1]), int(row[2])
        row[0] = end + min(range(8), key=lambda pad: (len(_cut(end + pad, fan, d3, 64)), pad))
        end = int(row[0]) + fan * d3
    return table


_plans: Dict[tuple, Bf16Plan] = {}


def bf16_plan(table: np.ndarray, n_rows: int, K: int, H: int, n_sm: int = SM_COUNT) -> Bf16Plan:
    """The bfloat16 kernel's :class:`Bf16Plan` for a class table, ``n_rows``
    receivers of ``K`` neighbours and ``H`` hidden channels (kept per
    table and shapes); ValueError where the kernel refuses the shapes."""
    key = (np.ascontiguousarray(table, dtype=np.int64).tobytes(), n_rows, K, H, n_sm)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = _bf16_plan(table, n_rows, K, H, n_sm)
    return plan


def _bf16_plan(table, n_rows, K, H, n_sm):
    if not 1 <= H <= BF16_WIDTHS[-1] or K < 1:
        raise ValueError(f"fused_tp3: the bfloat16 kernel takes 1..{BF16_WIDTHS[-1]} hidden "
                         f"channels and K >= 1, got H = {H}, K = {K}")
    He = H + (H & 1)
    HP = He + 2
    NW = next(w for w in BF16_WIDTHS if w >= H)
    w_tot = int((table[:, 3] * table[:, 2]).sum())
    slices, w_off = [], 0
    for c, (f_off, fan, d3, mul, out_off, _w) in enumerate(table.tolist()):
        # the fewest slices (as greedy slicing gives them), balanced where
        # the offsets allow
        n_greedy = len(_cut(f_off, fan, d3, 64))
        balanced = _cut(f_off, fan, d3, -(-fan // n_greedy))
        nus = balanced if len(balanced) == n_greedy else _cut(f_off, fan, d3, 64)
        u0 = 0
        for s, nu in enumerate(nus):
            f_col = f_off + u0 * d3
            depth = _round_up(nu * HP, 64)
            slices.append(Slice(c, f_col, f_col % 8, u0, nu, fan, d3, mul, out_off, depth, s,
                                len(nus), w_off))
            w_off += depth * mul
            u0 += nu
    if len(slices) > BF16_MAX_SLICES:
        raise ValueError(f"fused_tp3: {len(slices)} column slices, the bfloat16 kernel takes "
                         f"at most {BF16_MAX_SLICES}")
    k_parts = 2 if K >= 256 else 1
    h_boxes = -(-NW // 64)
    max_mul = max(sl.mul for sl in slices)

    def smem(KC, R, S):
        slot = _round_up(max(KC * 128 * (1 + h_boxes), max_mul * 128 + 2048), 1024)
        m_bytes = _round_up(2 * KC + 128, 128)  # mw, and the rows the bias product reads past it
        t_max = max(1, max(min(-(-sl.mul // 16) * -(-(R * sl.d3) // 8), 2 * BF16_TILES)
                           for sl in slices))
        p = _round_up(max(R * sl.d3 * (sl.depth + 8) * 2 for sl in slices), 1024)
        x = (NW // 2 + 4) * 128 * 4 if k_parts == 2 else 0
        return (S * (slot + m_bytes) + p + x + 4 * t_max * 128 * 4 + _round_up(R * w_tot * 4, 16)
                + 2 * S * 8 + 1024)

    def most(KC, S):
        return next((r for r in range(16, 0, -2) if smem(KC, r, S) <= BF16_SMEM_BUDGET), 0)

    # a TMA copy holds its issuing thread long whatever its size: the
    # widest stage (up to 64 neighbours, no wider than K needs; stages of
    # 128 fault on the card) that leaves 4 slots and room for at least 8
    # receivers (2 when the warpgroups split long neighbour lists); else 16
    # or 32 neighbours and 2 slots. The ring is even: with an odd one, a
    # consumer warpgroup a lap ahead passes its wait on a stage still in
    # flight, and the kernel hangs (the kernel source's RingPos says why)
    r_min = 2 if k_parts == 2 else 8
    top = 16 if K <= 16 else 32 if K <= 32 else 64
    KC = next((KC for KC in (64, 32, 16) if KC <= top and most(KC, 4) >= r_min), None)
    KC, S = (KC, 4) if KC is not None else (16 if K <= 16 else 32, 2)
    R = most(KC, S)
    if R == 0:
        raise ValueError(f"fused_tp3: the class table {table.tolist()} does not fit the "
                         f"bfloat16 kernel's shared memory")
    n_kc = -(-K // KC)
    whole = -(-n_rows // R) >= n_sm
    if not whole and k_parts == 2:
        while R > 1 and -(-n_rows // R) * len(slices) < 2 * n_sm:
            R //= 2
    n_groups = -(-n_rows // R)
    return Bf16Plan(tuple(slices), H, He, HP, NW, R, whole, k_parts, KC, n_kc, -(-n_kc // 2), S,
                    smem(KC, R, S), n_groups, n_groups if whole else n_groups * len(slices),
                    max(sl.n_parts for sl in slices), w_off)


_pack_index: Dict[tuple, torch.Tensor] = {}


def swizzled_weight_index(slices, class_sizes: Sequence[int], H: int, HP: int,
                          He: int) -> np.ndarray:
    """For each element of weights packed per column slice, its index in the
    class blocks (H+1, fan, mul) flattened one after the other (of
    ``class_sizes`` elements), or the index one past their end (a zero).
    ``slices``: (class, u0, nu, fan, mul, depth) each. Per slice, chunks of
    [mul][64 depth], depth k = u*HP + h (h < H the hidden rows, h = He the
    bias), the 8-element groups of row w stored at group q ^ (w & 7)."""
    base = np.concatenate([[0], np.cumsum(class_sizes)])
    zero = int(base[-1])
    parts = []
    for cls, u0, nu, fan, mul, depth in slices:
        j, w, pos = np.meshgrid(np.arange(depth // 64), np.arange(mul), np.arange(64), indexing="ij")
        k = j * 64 + ((pos // 8) ^ (w & 7)) * 8 + pos % 8
        uu, h = k // HP, k % HP
        live = (uu < nu) & ((h < H) | (h == He))
        hsrc = np.where(h < H, h, H)
        idx = base[cls] + (hsrc * fan + u0 + uu) * mul + w
        parts.append(np.where(live, idx, zero).reshape(-1))
    return np.concatenate(parts)


def _bf16_weight_index(table: np.ndarray, H: int, plan: Bf16Plan) -> np.ndarray:
    """:func:`swizzled_weight_index` of the plan's slices."""
    return swizzled_weight_index(
        [(sl.cls, sl.u0, sl.nu, sl.fan, sl.mul, sl.depth) for sl in plan.slices],
        (H + 1) * table[:, 1] * table[:, 3], H, plan.HP, plan.He)


def pack_bf16_weights(blocks: List[torch.Tensor], table: np.ndarray, H: int,
                      plan: Bf16Plan) -> torch.Tensor:
    """The class blocks (H+1, fan, mul) in the bfloat16 kernel's layout
    (:func:`_bf16_weight_index`), one gather."""
    flat = torch.cat([b.reshape(-1) for b in blocks] + [blocks[0].new_zeros(1)])
    key = (table.tobytes(), H, plan.HP, str(flat.device))
    idx = _pack_index.get(key)
    if idx is None:
        idx = torch.from_numpy(_bf16_weight_index(table, H, plan)).to(flat.device)
        _pack_index[key] = idx
    return flat[idx]


_checked_bf16: Dict[tuple, int] = {}


def _bf16_scratch(kern, table: np.ndarray, plan: Bf16Plan, N: int, K: int, H: int, w_tot: int,
                  n_sm: int) -> int:
    """The kernel library's plan against :func:`bf16_plan` (once per table
    and shapes); returns the scratch floats."""
    key = (table.tobytes(), N, K, H, n_sm)
    if key not in _checked_bf16:
        got = np.zeros(9, np.int64)
        if kern.plan_bf16(table.ctypes.data, table.shape[0], N, K, H, w_tot, n_sm,
                          got.ctypes.data) != 0:
            raise ValueError(f"fused_tp3: the bfloat16 kernel refuses the class table "
                             f"{table.tolist()} at H = {H}")
        if got.tolist() != plan.as_ints(N, w_tot):
            raise RuntimeError(f"fused_tp3: the bfloat16 kernel plans {got.tolist()}, bf16_plan "
                               f"{plan.as_ints(N, w_tot)}")
        _checked_bf16[key] = int(got[8])
    return _checked_bf16[key]


def _rows_of_8(t: torch.Tensor) -> bool:
    """(N, K, W) or (N, W) with unit last stride, rows a multiple of 8
    elements apart (K rows per receiver), 16-byte aligned: the layout TMA
    reads."""
    *lead, W = t.shape
    rs = t.stride(-2)
    packed = len(lead) == 1 or lead[0] <= 1 or t.stride(0) == lead[1] * rs
    return t.stride(-1) == 1 and rs % 8 == 0 and rs >= W and packed and t.data_ptr() % 16 == 0


def _pad_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a buffer whose rows are a multiple of 8 elements apart
    (zeros appended), seen through a view of its own width."""
    W = t.shape[-1]
    padded = t.new_zeros(*t.shape[:-1], _round_up(W, 8))
    padded[..., :W] = t
    return padded[..., :W]


def launch(h: torch.Tensor, coupled: torch.Tensor, weights: torch.Tensor,
           table: np.ndarray, mw: torch.Tensor = None) -> torch.Tensor:
    """Launch the kernel on prepared operands (:func:`prepare`), ``table``
    from :func:`class_table`. Float32: ``h`` is h_aug (N, K, H+1),
    ``coupled`` (N, K, F_tot), ``weights`` the packed (H+1, fan, mul)
    blocks. bfloat16: ``h`` (N, K, H) and ``coupled`` with rows a multiple
    of 8 elements apart, ``weights`` packed by :func:`pack_bf16_weights`,
    ``mw`` (N, K). Returns (N, W_tot) f32."""
    mode = _MODES.get(h.dtype)
    if mode is None or not h.dtype == coupled.dtype == weights.dtype:
        raise TypeError(f"fused_tp3: h, coupled and weights must be all float32 or all "
                        f"bfloat16, got {h.dtype}, {coupled.dtype}, {weights.dtype}")
    if mode == "fused_tp3_bf16":
        return _launch_bf16(h, coupled, weights, table, mw)
    h_aug = h
    for name, t in (("h_aug", h_aug), ("coupled", coupled), ("weights", weights)):
        if not t.is_cuda:
            raise ValueError(f"fused_tp3: {name} must be a CUDA tensor")
        if not t.is_contiguous():
            raise ValueError(f"fused_tp3: {name} must be contiguous")
        if t.device != h_aug.device:
            raise ValueError(f"fused_tp3: {name} is on {t.device}, h_aug on {h_aug.device}")
    N, K, H1 = h_aug.shape
    if coupled.shape[:2] != (N, K):
        raise ValueError(f"fused_tp3: coupled {tuple(coupled.shape)} vs h_aug {tuple(h_aug.shape)}")
    n_classes = table.shape[0]
    kern = _get_kernel()
    _check_classes(kern, table)
    f_tot = int((table[:, 1] * table[:, 2]).sum())
    w_tot = int((table[:, 3] * table[:, 2]).sum())
    w_len = int((H1 * table[:, 1] * table[:, 3]).sum())
    if coupled.shape[2] != f_tot or weights.numel() != w_len:
        raise ValueError("fused_tp3: operand widths do not match the class table")
    table = np.ascontiguousarray(table, dtype=np.int64)
    n_scratch = kern.scratch_floats(table.ctypes.data, n_classes, N, H1, w_tot)
    if n_scratch < 0:
        raise ValueError(f"fused_tp3: the kernel refuses the class table {table.tolist()}")
    planned = tile_plan(table, H1).scratch_floats(N, w_tot)
    if n_scratch != planned:
        raise RuntimeError(f"fused_tp3: the kernel asks for {n_scratch} scratch floats, "
                           f"tile_plan for {planned}")
    out = torch.empty(N, w_tot, device=h_aug.device, dtype=torch.float32)
    scratch = torch.empty(max(n_scratch, 1), device=h_aug.device, dtype=torch.float32)
    err = kern.forward(
        h_aug.data_ptr(), coupled.data_ptr(), weights.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), table.ctypes.data, n_classes, N, K, H1, f_tot, w_tot,
        torch.cuda.current_stream(h_aug.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{mode} kernel launch failed: cudaError {err}")
    counts.add(mode)
    return out


def _check_classes(kern, table: np.ndarray) -> None:
    n_classes = table.shape[0]
    if not 1 <= n_classes <= kern.max_classes:
        raise ValueError(f"fused_tp3: {n_classes} classes, kernel takes 1..{kern.max_classes}")
    fd, wd = table[:, 1] * table[:, 2], table[:, 3] * table[:, 2]
    if wd.max() > kern.max_outputs:
        raise ValueError(f"fused_tp3: a class has mul*d3 = {wd.max()} outputs, "
                         f"the kernel takes at most {kern.max_outputs}")
    if fd.max() > kern.max_columns:
        raise ValueError(f"fused_tp3: a class has fan*d3 = {fd.max()} coupled columns, "
                         f"the kernel takes at most {kern.max_columns}")


def _launch_bf16(h, coupled, weights, table, mw):
    if mw is None or mw.dtype != torch.bfloat16:
        raise TypeError("fused_tp3: the bfloat16 kernel takes mw as a bfloat16 (N, K) tensor")
    for name, t in (("h", h), ("coupled", coupled), ("weights", weights), ("mw", mw)):
        if not t.is_cuda:
            raise ValueError(f"fused_tp3: {name} must be a CUDA tensor")
        if t.device != h.device:
            raise ValueError(f"fused_tp3: {name} is on {t.device}, h on {h.device}")
    N, K, H = h.shape
    if coupled.shape[:2] != (N, K) or tuple(mw.shape) != (N, K):
        raise ValueError(f"fused_tp3: coupled {tuple(coupled.shape)} and mw {tuple(mw.shape)} "
                         f"vs h {tuple(h.shape)}")
    for name, t in (("h", h), ("coupled", coupled), ("mw", mw)):
        if not _rows_of_8(t):
            raise ValueError(f"fused_tp3: {name} needs rows a multiple of 8 elements apart on a "
                             f"16-byte aligned base (prepare pads them)")
    if not (weights.is_contiguous() and weights.data_ptr() % 16 == 0):
        raise ValueError("fused_tp3: weights must be contiguous and 16-byte aligned")
    kern = _get_kernel()
    _check_classes(kern, table)
    f_tot = int(table[-1, 0] + table[-1, 1] * table[-1, 2])  # the last class's end
    w_tot = int((table[:, 3] * table[:, 2]).sum())
    if coupled.shape[2] != f_tot:
        raise ValueError("fused_tp3: coupled's width does not match the class table")
    table = np.ascontiguousarray(table, dtype=np.int64)
    n_sm = torch.cuda.get_device_properties(h.device).multi_processor_count
    plan = bf16_plan(table, N, K, H, n_sm)
    if weights.numel() != plan.w_len:
        raise ValueError(f"fused_tp3: {weights.numel()} packed weights, the plan has {plan.w_len}")
    n_scratch = _bf16_scratch(kern, table, plan, N, K, H, w_tot, n_sm)
    out = torch.empty(N, w_tot, device=h.device, dtype=torch.float32)
    scratch = torch.empty(max(n_scratch, 1), device=h.device, dtype=torch.float32)
    err = kern.forward_bf16(
        h.data_ptr(), mw.data_ptr(), coupled.data_ptr(), weights.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), table.ctypes.data, table.shape[0], N, K, H, h.stride(1), f_tot,
        coupled.stride(1), mw.stride(0), w_tot, torch.cuda.current_stream(h.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_tp3_bf16 kernel launch failed: cudaError {err}")
    counts.add("fused_tp3_bf16")
    return out


def prepare(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """The torch side of the kernel call, the operands in ``h``'s dtype.
    Float32: (classes, h_aug, coupled, packed weights, class table).
    bfloat16: (classes, h, coupled, packed weights, class table, mw), with
    ``h``, ``coupled`` and ``mw`` views whose rows are a multiple of 8
    elements apart (zero columns appended where the width is not), the
    classes of ``coupled`` at the columns of :func:`bf16_class_table`, and the weights in
    the bfloat16 kernel's layout. ``launch(*prepare(...)[1:])`` runs either."""
    if h.dtype == torch.bfloat16:
        return _prepare_bf16(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)
    classes, coupled = merged_coupled(tp, x_nbr, edge_sh)
    h_aug = torch.cat([h, mw[..., None].to(h.dtype)], dim=-1).contiguous()
    H1 = h_aug.shape[-1]
    weights = torch.cat(
        [b.reshape(-1) for b in class_weights(tp, classes, out_kernel, out_bias, h.dtype)]
    )
    table = class_table(classes, H1)
    return classes, h_aug, coupled.contiguous(), weights.contiguous(), table


def _prepare_bf16(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    classes = tp.live_classes()
    N, K, H = h.shape
    table = bf16_class_table(classes, H + 1)
    # the classes at the table's columns, the rows padded to a multiple of 8
    # elements, zeros between, in one cat
    parts, end = [], 0
    for (k, *_), (f_off, fan, d3) in zip(classes, table[:, :3].tolist()):
        if f_off > end:
            parts.append(x_nbr.new_zeros(N, K, f_off - end, dtype=h.dtype))
        parts.append(tp.coupled_class_merged(k, x_nbr, edge_sh))
        end = f_off + fan * d3
    if end % 8:
        parts.append(parts[0].new_zeros(N, K, 8 - end % 8))
    coupled = torch.cat(parts, dim=-1)[..., :end]
    if not _rows_of_8(h):
        h = _pad_rows(h)
    mw = mw.to(h.dtype)
    if not _rows_of_8(mw):
        mw = _pad_rows(mw)
    plan = bf16_plan(table, N, K, H, SM_COUNT)
    weights = pack_bf16_weights(class_weights(tp, classes, out_kernel, out_bias, h.dtype), table,
                                H, plan)
    return classes, h, coupled, weights, table, mw


def _forward_kernel(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    if not tp.live_classes():
        return x_nbr.new_zeros(x_nbr.shape[0], tp.irreps_out.dim)
    classes, *ops = prepare(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)
    return _scatter_classes(tp, classes, launch(*ops))


class PlainVJP(torch.autograd.Function):
    """A TP kernel under autograd. ``forward``: the given forward (the
    kernel, or on the CPU the plain version) on the six inputs, which it
    saves; ``backward``: the VJP of ``plain`` at them (the transposed
    einsums of the plain version, by autograd), inside a profiler range
    named ``vjp_name``. Gens 2 and 3 share it."""

    @staticmethod
    def forward(ctx, tp, forward, plain, vjp_name, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
        ctx.tp, ctx.plain, ctx.vjp_name = tp, plain, vjp_name
        ctx.save_for_backward(x_nbr, edge_sh, h, mw, out_kernel, out_bias)
        return forward(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[4:]
        # the range lets a profiler attribute the VJP's device time
        with torch.profiler.record_function(ctx.vjp_name), torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(ctx.tp, *leaves)
            wanted = [t for t, n in zip(leaves, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None,) * 4 + tuple(next(grads) if n else None for n in needs)


def _vjp_plain(tp, *inputs):
    """The plain version as gen 3's backward runs it, counted as ``fused_tp3_vjp``."""
    counts.add("fused_tp3_vjp")
    return _plain(tp, *inputs)


def fused_tp3(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """Summed TP messages (N, dim_out) f32 through the Hopper kernel (the mode
    of the inputs' dtype); on a CPU tensor through
    :func:`fused_tp3_reference`. Differentiable: when
    autograd records and an input requires a gradient, the call goes
    through :class:`PlainVJP`, which saves the six inputs; otherwise nothing
    is saved."""
    inputs = (x_nbr, edge_sh, h, mw, out_kernel, out_bias)
    forward = _forward_kernel if x_nbr.is_cuda else fused_tp3_reference
    if tp.live_classes() and torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        if h.dtype != torch.float32:
            raise TypeError(f"fused_tp3: no gradient through {h.dtype} inputs; training "
                            "computes in float32, as the JAX package's trainers do")
        return PlainVJP.apply(tp, forward, _vjp_plain, "fused_tp3_vjp", *inputs)
    return forward(tp, *inputs)
