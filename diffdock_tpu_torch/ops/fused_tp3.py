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
  products in 3xTF32, float32 accuracy). On a CPU tensor
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
in torch would round its output); the kernel's bfloat16 mode reads 2 bytes
per element and runs bfloat16 ``mma.sync``. bfloat16 inputs that need a
gradient raise: no JAX entry point trains in bfloat16.

Each keeps a count of its launches in :data:`counts` (the kernel's two
modes apart: ``fused_tp3`` and ``fused_tp3_bf16``); the backward counts its
calls as ``fused_tp3_vjp``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from diffdock_tpu_torch.utils import build

_SOURCES = ("fused_tp3.cu",)


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
        self.forward = {}
        for dtype, name in ((torch.float32, "fused_tp3_forward"),
                            (torch.bfloat16, "fused_tp3_forward_bf16")):
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self.forward[dtype] = fn
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


def launch(h_aug: torch.Tensor, coupled: torch.Tensor, weights: torch.Tensor,
           table: np.ndarray) -> torch.Tensor:
    """Launch the kernel on prepared operands: ``h_aug`` (N, K, H+1),
    ``coupled`` (N, K, F_tot), ``weights`` the packed (H+1, fan, mul) blocks,
    ``table`` from :func:`class_table`; all three float32 (the float32 mode)
    or all three bfloat16 (the bfloat16 mode). Returns (N, W_tot) f32."""
    mode = _MODES.get(h_aug.dtype)
    if mode is None or not h_aug.dtype == coupled.dtype == weights.dtype:
        raise TypeError(f"fused_tp3: h_aug, coupled and weights must be all float32 or all "
                        f"bfloat16, got {h_aug.dtype}, {coupled.dtype}, {weights.dtype}")
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
    if not 1 <= n_classes <= kern.max_classes:
        raise ValueError(f"fused_tp3: {n_classes} classes, kernel takes 1..{kern.max_classes}")
    fd, wd = table[:, 1] * table[:, 2], table[:, 3] * table[:, 2]
    if wd.max() > kern.max_outputs:
        raise ValueError(f"fused_tp3: a class has mul*d3 = {wd.max()} outputs, "
                         f"the kernel takes at most {kern.max_outputs}")
    if fd.max() > kern.max_columns:
        raise ValueError(f"fused_tp3: a class has fan*d3 = {fd.max()} coupled columns, "
                         f"the kernel takes at most {kern.max_columns}")
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
    err = kern.forward[h_aug.dtype](
        h_aug.data_ptr(), coupled.data_ptr(), weights.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), table.ctypes.data, n_classes, N, K, H1, f_tot, w_tot,
        torch.cuda.current_stream(h_aug.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{mode} kernel launch failed: cudaError {err}")
    counts.add(mode)
    return out


def prepare(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """The torch side of the kernel call: (classes, h_aug, coupled, packed
    weights, class table), the operands in ``h``'s dtype."""
    classes, coupled = merged_coupled(tp, x_nbr, edge_sh)
    h_aug = torch.cat([h, mw[..., None].to(h.dtype)], dim=-1).contiguous()
    H1 = h_aug.shape[-1]
    weights = torch.cat(
        [b.reshape(-1) for b in class_weights(tp, classes, out_kernel, out_bias, h.dtype)]
    )
    table = class_table(classes, H1)
    return classes, h_aug, coupled.contiguous(), weights.contiguous(), table


def _forward_kernel(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    if not tp.live_classes():
        return x_nbr.new_zeros(x_nbr.shape[0], tp.irreps_out.dim)
    classes, h_aug, coupled, weights, table = prepare(
        tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias
    )
    out = launch(h_aug, coupled, weights, table)
    return _scatter_classes(tp, classes, out)


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
