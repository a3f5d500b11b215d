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

* :func:`fused_tp3` runs ``csrc/fused_tp3.cu`` (which replaces the TPU
  kernel ``pallas_tpconv3.py:_kernel`` and the coupled tensor its wrapper
  builds; tensor-core products in 3xTF32, float32 accuracy) through
  :func:`forward_f32` for float32 operands: the kernel builds the
  Clebsch-Gordan coupling itself from the inputs as they are (the senders
  in e3nn layout, the harmonics, ``h`` and ``mw`` apart, the weights and
  bias as the parameters hold them), so the host only checks shapes and
  allocates the output; the tables it reads (:func:`tp_geometry`) are
  built once per tensor product and its plan (:func:`tile_plan`) is
  checked against the library's once per shape. bfloat16 operands go to
  ``csrc/fused_tp3_bf16.cu`` (TMA-fed ``wgmma``) through :func:`prepare`
  and :func:`launch`, which build its coupled tensor and packed weights in
  torch. On a CPU tensor it runs :func:`fused_tp3_reference` instead; on a
  CUDA tensor it launches the kernel or raises. When a gradient is wanted
  it runs as a ``torch.autograd.Function`` (:class:`PlainVJP`) whose
  backward is the VJP of the plain version, as the TPU kernel's
  ``custom_vjp`` backward is the VJP of its einsum path
  (``pallas_tpconv3.py:make_fused_tp_messages``).
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
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 8
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_longlong] + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        self.forward = fn
        plan = lib.fused_tp3_plan
        plan.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        plan.restype = ctypes.c_longlong
        self.plan = plan
        fb = lib.fused_tp3_bf16_forward
        fb.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fb.restype = ctypes.c_int
        self.forward_bf16 = fb
        plan_bf16 = lib.fused_tp3_bf16_plan
        plan_bf16.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        plan_bf16.restype = ctypes.c_int
        self.plan_bf16 = plan_bf16
        for name in ("fused_tp3_max_classes", "fused_tp3_max_paths", "fused_tp3_max_outputs",
                     "fused_tp3_max_columns"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        self.max_classes = lib.fused_tp3_max_classes()
        self.max_paths = lib.fused_tp3_max_paths()
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


# ---- the float32 kernel (csrc/fused_tp3.cu): its tables and blocking ----

# 16 receivers per block; hidden rows in the fewest groups of at most 80
# (whole m16 tiles, balanced); per class the fewest column slices of whole
# u groups, at most 24 columns, balanced, whose staged inputs, CG-weight
# columns and harmonics fit the block's shared memory
TILE_ROWS = 16
SLICE_COLS = 24
MAX_HIDDEN_ROWS = 80
MAX_CLASSES = 16
_KC, _STAGES, _B_STRIDE = 8, 2, 40  # neighbours per stage, ring stages, B tile row stride
_MAX_XP, _MAX_W, _MAX_SH = 96, 64, 32  # per slice: input floats, CG-weight columns, harmonics
_MAX_CG_ROWS = 16  # rows of the CG matrix (the largest d2)
_MAX_WN = 6  # weight-product n8 tiles per warp
_SMEM_BYTES = 232448
_TABLE_FLOATS = 4 * SLICE_COLS + 2 * _MAX_W + _MAX_XP + _MAX_CG_ROWS * _MAX_W


class Geometry(NamedTuple):
    """What the float32 kernel reads of a tensor product, built once per
    tensor product (:func:`tp_geometry`).

    ``class_rows`` (n_classes, 8) int32, one row per output class, those
    without a path too: (fan, d3, mul, out_off, w_off, col0, path0,
    n_paths), ``out_off`` the class's first output column, ``w_off`` its
    first column of ``out_kernel`` and ``out_bias``. ``path_rows``
    (n_paths, 7) int32: (u_off, mul, d1, x_start, col, sh_start, d2), the
    path's first u in its class, its input entry (``mul`` x ``d1`` floats
    from ``x_start`` of a neighbour's row, e3nn layout), its CG columns from
    ``col0 + col`` and its harmonic entry (``d2`` floats from
    ``sh_start``). ``cg`` (max d2, columns) float32: each path's (d2,
    d1*d3) block ``CG[t, i*d3 + d]``, rows from 0. ``X``, ``J``, ``D``,
    ``WN``: the widths of x_nbr, edge_sh, the output and the weights."""

    class_rows: np.ndarray
    path_rows: np.ndarray
    cg: np.ndarray
    X: int
    J: int
    D: int
    WN: int


def _build_geometry(tp) -> Geometry:
    if any(e.mul != 1 for e in tp.irreps_in2):
        raise ValueError(f"fused_tp3: the harmonics' irreps {tp.irreps_in2} must have multiplicity 1")
    cls_rows, path_rows, blocks = [], [], []
    col = out_off = 0
    for (w_off, fan, mul), pk, ek in zip(tp.weight_slices(), tp.paths, tp.irreps_out):
        d3 = ek.ir.dim
        col0, path0, u = col, len(path_rows), 0
        for p in pk:
            e1 = tp.irreps_in1[p.i]
            cgm = p.cg.transpose(1, 0, 2).reshape(p.cg.shape[1], -1)  # (d2, d1*d3)
            path_rows.append((u, e1.mul, e1.ir.dim, tp._sl1[p.i].start, col - col0,
                              tp._sl2[p.j].start, cgm.shape[0]))
            blocks.append(cgm)
            col += cgm.shape[1]
            u += e1.mul
        cls_rows.append((fan, d3, mul, out_off, w_off, col0, path0, len(pk)))
        out_off += mul * d3
    cg = np.zeros((max([b.shape[0] for b in blocks], default=1), max(col, 1)), np.float32)
    c = 0
    for b in blocks:
        cg[: b.shape[0], c : c + b.shape[1]] = b
        c += b.shape[1]
    return Geometry(np.asarray(cls_rows, np.int32).reshape(-1, 8),
                    np.asarray(path_rows, np.int32).reshape(-1, 7), cg, tp.irreps_in1.dim,
                    tp.irreps_in2.dim, tp.irreps_out.dim, tp.weight_numel)


def tp_geometry(tp) -> Geometry:
    """The float32 kernel's :class:`Geometry` of ``tp``, built at the first
    call and kept on ``tp``, beside its constants."""
    geo = getattr(tp, "_fused_tp3_geometry", None)
    if geo is None:
        geo = tp._fused_tp3_geometry = _build_geometry(tp)
    return geo


class SliceTables(NamedTuple):
    """One column slice of a class as a block of the kernel sees it: the
    paths ``pa``..``pb`` it touches; ``xs`` input floats staged per
    neighbour (each path's run of a neighbour's row, path after path;
    ``xmap[e]`` is staged float e's offset in the row); ``nc`` CG-weight
    columns from column ``cw0`` of the class; the window of ``nsh``
    harmonics from ``sh0``; per coupled column ``colinfo[j]`` = (staged
    offset of its first input, its first CG-weight column, d1), and per
    CG-weight column ``wcol[cc]`` = (its first harmonic in the window, d2)."""

    pa: int
    pb: int
    xs: int
    cw0: int
    nc: int
    sh0: int
    nsh: int
    xmap: Tuple[int, ...]
    colinfo: Tuple[Tuple[int, int, int], ...]
    wcol: Tuple[Tuple[int, int], ...]


def slice_tables(geo: Geometry, c: int, u0: int, nu: int) -> SliceTables:
    """The kernel's ``slice_of`` and its block tables for the slice [u0,
    u0 + nu) of class ``c``."""
    d3 = int(geo.class_rows[c, 1])
    path0, n_paths = (int(v) for v in geo.class_rows[c, 6:8])
    paths = geo.path_rows.tolist()
    p = path0
    while paths[p][0] + paths[p][1] <= u0:
        p += 1
    pa, runs = p, []  # (path, first u, u count)
    while p < path0 + n_paths and paths[p][0] < u0 + nu:
        ua = max(u0, paths[p][0])
        runs.append((p, ua, min(u0 + nu, paths[p][0] + paths[p][1]) - ua))
        p += 1
    pb = p - 1
    cw0 = paths[pa][4]
    nc = paths[pb][4] + paths[pb][2] * d3 - cw0
    sh0 = min(paths[q][5] for q, _, _ in runs)
    nsh = max(paths[q][5] + paths[q][6] for q, _, _ in runs) - sh0
    xmap, colinfo, base = [], {}, 0
    for q, ua, n in runs:
        u_off, _mul, d1, x_start, col, _s, _d2 = paths[q]
        xmap += [x_start + (ua - u_off) * d1 + e for e in range(d1 * n)]
        for u in range(ua, ua + n):
            for d in range(d3):
                colinfo[(u - u0) * d3 + d] = (base + (u - ua) * d1, col - cw0 + d, d1)
        base += d1 * n
    wcol = []
    for cc in range(nc):
        q = pa
        while q < pb and paths[q + 1][4] <= cw0 + cc:
            q += 1
        wcol.append((paths[q][5] - sh0, paths[q][6]))
    return SliceTables(pa, pb, len(xmap), cw0, nc, sh0, nsh, tuple(xmap),
                       tuple(colinfo[j] for j in range(nu * d3)), tuple(wcol))


def xp_cap(hidden_rows: int, sh: int) -> int:
    """The most input floats per neighbour a slice may stage with these
    hidden rows and harmonics (the kernel's ``xp_cap``)."""
    per_warp = (_SMEM_BYTES // 4 - _TABLE_FLOATS) // TILE_ROWS
    room = (per_warp - _KC * _B_STRIDE - _KC * _MAX_W
            - _STAGES * _KC * (hidden_rows + 8 + sh))
    return min(room // (_STAGES * _KC), _MAX_XP)


class TilePlan(NamedTuple):
    """How the float32 kernel cuts a call (its ``make_plan``):
    ``hidden_rows`` per group, ``n_groups`` groups; per class ``us`` u per
    column slice and ``n_slices`` slices (0 for a class without a path);
    ``s_max`` the most slices of a class, ``n_sl`` all of them; the most
    staged input floats, CG-weight columns and harmonics of a slice; the
    shared memory of a block in floats. Partial outputs go to ``n_groups *
    s_max`` scratch parts unless that is 1."""

    hidden_rows: int
    n_groups: int
    us: Tuple[int, ...]
    n_slices: Tuple[int, ...]
    s_max: int
    n_sl: int
    xs_max: int
    nc_max: int
    sh_max: int
    smem_floats: int

    def scratch_floats(self, n_rows: int, out_dim: int) -> int:
        parts = self.n_groups * self.s_max
        return 0 if parts == 1 else parts * n_rows * out_dim

    def as_ints(self) -> List[int]:
        """The numbers ``fused_tp3_plan`` reports."""
        pad = [0] * (MAX_CLASSES - len(self.us))
        return ([self.n_groups, self.s_max, self.n_sl, self.xs_max, self.nc_max, self.sh_max,
                 self.hidden_rows, self.smem_floats] + list(self.us) + pad + list(self.n_slices) + pad)


def tile_plan(geo: Geometry, H: int) -> TilePlan:
    """The float32 kernel's :class:`TilePlan` for ``H`` hidden channels;
    ValueError where it refuses the tensor product."""
    Ha = H + 1
    n_groups = -(-Ha // MAX_HIDDEN_ROWS)
    hr = 16 * -(-Ha // (16 * n_groups))
    cap = xp_cap(hr, min(geo.J, _MAX_SH))
    us_all, ns_all, slices, wp_need = [], [], [], 0
    for c, (fan, d3, mul, *_rest) in enumerate(geo.class_rows.tolist()):
        if fan == 0:
            us_all.append(0)
            ns_all.append(0)
            continue
        n = -(-fan // (SLICE_COLS // d3))
        while True:
            us = -(-fan // n)
            ns = -(-fan // us)
            cut = [slice_tables(geo, c, s * us, min(us, fan - s * us)) for s in range(ns)]
            if all(sl.xs <= cap and sl.nc <= _MAX_W and sl.nsh <= _MAX_SH for sl in cut):
                break
            if us == 1:
                raise ValueError(f"fused_tp3: one u of class {c} does not fit a block")
            n += 1
        us_all.append(us)
        ns_all.append(ns)
        slices += cut
        # as the kernel's weight product splits its depth
        n_m, n_n = -(-mul // 16), TILE_ROWS * d3 // 8
        parts = TILE_ROWS // n_m if n_n <= _MAX_WN and n_m <= TILE_ROWS else 1
        nstride = TILE_ROWS * d3 + 8
        wp_need = max(wp_need, hr * us * nstride + parts * n_m * 16 * nstride)
    if not slices:
        raise ValueError("fused_tp3: no output class has a path")
    xs_max, nc_max, sh_max = (max(getattr(sl, f) for sl in slices) for f in ("xs", "nc", "nsh"))
    warp = _STAGES * _KC * (hr + 8 + sh_max + xs_max) + _KC * _B_STRIDE + _KC * nc_max
    ring = TILE_ROWS * warp + 4 * SLICE_COLS + 2 * nc_max + _MAX_XP + geo.cg.shape[0] * nc_max
    smem = max(ring, wp_need)
    if smem * 4 > _SMEM_BYTES:
        raise ValueError(f"fused_tp3: a block needs {smem * 4} bytes of shared memory, the card "
                         f"has {_SMEM_BYTES}")
    return TilePlan(hr, n_groups, tuple(us_all), tuple(ns_all), max(ns_all), len(slices), xs_max,
                    nc_max, sh_max, smem)


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
    """Launch the bfloat16 kernel on prepared operands (:func:`prepare`):
    ``h`` (N, K, H) and ``coupled`` with rows a multiple of 8 elements
    apart, ``weights`` packed by :func:`pack_bf16_weights`, ``table`` from
    :func:`bf16_class_table`, ``mw`` (N, K). Returns (N, W_tot) f32 over the
    live classes. The float32 kernel's call is :func:`forward_f32`."""
    if not h.dtype == coupled.dtype == weights.dtype == torch.bfloat16:
        raise TypeError(f"fused_tp3: launch takes the bfloat16 kernel's operands, got {h.dtype}, "
                        f"{coupled.dtype}, {weights.dtype} (float32: forward_f32)")
    return _launch_bf16(h, coupled, weights, table, mw)


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
    """The torch side of the bfloat16 kernel's call: (classes, h, coupled,
    packed weights, class table, mw), with ``h``, ``coupled`` and ``mw``
    views whose rows are a multiple of 8 elements apart (zero columns
    appended where the width is not), the classes of ``coupled`` at the
    columns of :func:`bf16_class_table`, and the weights in the bfloat16
    kernel's layout; ``launch(*prepare(...)[1:])`` runs it. The float32
    kernel has no torch side (:func:`forward_f32`)."""
    if h.dtype != torch.bfloat16:
        raise TypeError(f"fused_tp3: prepare builds the bfloat16 kernel's operands, got {h.dtype} "
                        "(float32: forward_f32)")
    return _prepare_bf16(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)


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


_F32_NAMES = ("x_nbr", "edge_sh", "h", "mw", "out_kernel", "out_bias")


class _TpState:
    """The float32 kernel's state of one tensor product, kept on it: the
    geometry's tables as the library reads them, their limits checked once,
    and the scratch floats of each (N, K, H) the library's plan was checked
    at."""

    def __init__(self, tp, kern: _Kernel):
        geo = tp_geometry(tp)
        rows = geo.class_rows
        wd, fd = rows[:, 2] * rows[:, 1], rows[:, 0] * rows[:, 1]
        if not 1 <= rows.shape[0] <= kern.max_classes or geo.path_rows.shape[0] > kern.max_paths:
            raise ValueError(f"fused_tp3: {rows.shape[0]} classes and {geo.path_rows.shape[0]} "
                             f"paths, the kernel takes 1..{kern.max_classes} and at most "
                             f"{kern.max_paths}")
        if wd.max() > kern.max_outputs:
            raise ValueError(f"fused_tp3: a class has mul*d3 = {wd.max()} outputs, "
                             f"the kernel takes at most {kern.max_outputs}")
        if fd.max() > kern.max_columns:
            raise ValueError(f"fused_tp3: a class has fan*d3 = {fd.max()} coupled columns, "
                             f"the kernel takes at most {kern.max_columns}")
        self.geo = geo
        self.consts = tp._consts
        self.cls = np.ascontiguousarray(rows, np.int32)
        self.paths = np.ascontiguousarray(geo.path_rows, np.int32)
        self.scratch: Dict[Tuple[int, int, int], int] = {}

    def scratch_floats(self, kern: _Kernel, N: int, K: int, H: int) -> int:
        """The library's plan against :func:`tile_plan` (once per shape);
        the scratch floats of the call."""
        key = (N, K, H)
        n = self.scratch.get(key)
        if n is None:
            geo = self.geo
            plan = tile_plan(geo, H)
            got = np.zeros(8 + 2 * MAX_CLASSES, np.int32)
            n = kern.plan(self.cls.ctypes.data, self.cls.shape[0], self.paths.ctypes.data,
                          self.paths.shape[0], N, geo.X, geo.J, H, geo.cg.shape[0],
                          geo.cg.shape[1], geo.D, geo.WN, got.ctypes.data)
            if n < 0:
                raise ValueError(f"fused_tp3: the kernel refuses the class table "
                                 f"{self.cls.tolist()} at H = {H}")
            if got.tolist() != plan.as_ints() or n != plan.scratch_floats(N, geo.D):
                raise RuntimeError(f"fused_tp3: the kernel plans {got.tolist()} ({n} scratch "
                                   f"floats), tile_plan {plan.as_ints()}")
            self.scratch[key] = n
        return n


def forward_f32(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias) -> torch.Tensor:
    """The float32 kernel's whole call: (N, dim_out) f32 in e3nn layout,
    from the inputs as they are (CUDA tensors, float32, each with a
    contiguous last axis; rows at any stride). On the host only checks and
    the output's and scratch's allocation run; the tables and the plan of
    each shape are built and checked once. One launch, and the fixed-order
    reduce where the plan has several parts. Raises on anything else; never
    falls back to the plain version."""
    for name, t in zip(_F32_NAMES, (x_nbr, edge_sh, h, mw, out_kernel, out_bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_tp3: the float32 kernel takes float32 operands, {name} is "
                            f"{t.dtype}")
        if not t.is_cuda:
            raise ValueError(f"fused_tp3: {name} must be a CUDA tensor")
        if t.device != x_nbr.device:
            raise ValueError(f"fused_tp3: {name} is on {t.device}, x_nbr on {x_nbr.device}")
    kern = _get_kernel()
    st = getattr(tp, "_fused_tp3_state", None)
    if st is None:
        st = tp._fused_tp3_state = _TpState(tp, kern)
    geo = st.geo
    N, K, H = h.shape
    if (x_nbr.shape != (N, K, geo.X) or edge_sh.shape != (N, K, geo.J) or mw.shape != (N, K)
            or out_kernel.shape != (H, geo.WN) or out_bias.shape != (geo.WN,)):
        raise ValueError(f"fused_tp3: x_nbr {tuple(x_nbr.shape)}, edge_sh {tuple(edge_sh.shape)}, "
                         f"h {tuple(h.shape)}, mw {tuple(mw.shape)}, out_kernel "
                         f"{tuple(out_kernel.shape)}, out_bias {tuple(out_bias.shape)} do not fit "
                         f"{tp.irreps_in1} x {tp.irreps_in2} -> {tp.irreps_out}")
    if x_nbr.stride(2) != 1:
        x_nbr = x_nbr.contiguous()
    if edge_sh.stride(2) != 1:
        edge_sh = edge_sh.contiguous()
    if h.stride(2) != 1:
        h = h.contiguous()
    if not out_kernel.is_contiguous():
        out_kernel = out_kernel.contiguous()
    if not out_bias.is_contiguous():
        out_bias = out_bias.contiguous()
    n_scratch = st.scratch_floats(kern, N, K, H)
    cg = st.consts.get("fused_tp3_cg", geo.cg, x_nbr)
    dev = x_nbr.device
    out = torch.empty((N, geo.D), device=dev, dtype=torch.float32)
    scratch = torch.empty(max(n_scratch, 1), device=dev, dtype=torch.float32)
    err = kern.forward(
        x_nbr.data_ptr(), edge_sh.data_ptr(), h.data_ptr(), mw.data_ptr(), cg.data_ptr(),
        out_kernel.data_ptr(), out_bias.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        x_nbr.stride(0), x_nbr.stride(1), edge_sh.stride(0), edge_sh.stride(1), h.stride(0),
        h.stride(1), mw.stride(0), mw.stride(1), st.cls.ctypes.data, st.cls.shape[0],
        st.paths.ctypes.data, st.paths.shape[0], N, K, geo.X, geo.J, H, geo.cg.shape[0],
        geo.cg.shape[1], geo.D, geo.WN, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_tp3 kernel launch failed: cudaError {err}")
    counts.add("fused_tp3")
    return out


def _forward_kernel(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    if h.dtype == torch.bfloat16:
        if not tp.live_classes():
            return x_nbr.new_zeros(x_nbr.shape[0], tp.irreps_out.dim, dtype=torch.float32)
        classes, *ops = _prepare_bf16(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)
        return _scatter_classes(tp, classes, _launch_bf16(*ops))
    if not tp_geometry(tp).path_rows.shape[0]:
        return x_nbr.new_zeros(x_nbr.shape[0], tp.irreps_out.dim, dtype=torch.float32)
    return forward_f32(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)


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
    of the inputs' dtype: float32 through :func:`forward_f32`); on a CPU
    tensor through :func:`fused_tp3_reference`. Differentiable: when
    autograd records and an input requires a gradient, the call goes
    through :class:`PlainVJP`, which saves the six inputs; otherwise nothing
    is saved."""
    inputs = (x_nbr, edge_sh, h, mw, out_kernel, out_bias)
    forward = _forward_kernel if x_nbr.is_cuda else fused_tp3_reference
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs) and tp.live_classes():
        if h.dtype != torch.float32:
            raise TypeError(f"fused_tp3: no gradient through {h.dtype} inputs; training "
                            "computes in float32, as the JAX package's trainers do")
        return PlainVJP.apply(tp, forward, _vjp_plain, "fused_tp3_vjp", *inputs)
    return forward(tp, *inputs)
