"""Gen-2 factored TP contraction: the Hopper kernel, its plain version and its gradient.

Port of ``diffdock_tpu/ops/pallas_tpconv2.py``. The wrapper takes the JAX
signature

    f(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias) -> (N, dim_out) f32

(see :mod:`diffdock_tpu_torch.ops.fused_tp3` for the arguments) and
returns the neighbour SUM of the tensor-product messages in e3nn layout.
Unlike gen 3, the kernel builds the Clebsch-Gordan coupling itself, from
the raw neighbour features and edge harmonics:

* the host side packs the inputs as the TPU kernel's ``_forward_pallas``
  does: neighbour features in ``[path][i][u]`` order
  (:func:`pack_neighbors`), the hidden activations plus the
  mask*edge_weight bias row transposed to ``ht`` (N, He, K) with
  He = roundup(H+1, 16), one (J, cols) CG matrix for every path
  (:func:`build_specs2`) and per class the (He, fan, mul) weights with the
  bias as row H;
* ``csrc/factored_tp2.cu`` (which replaces the TPU kernel
  ``pallas_tpconv2.py:_kernel``) computes the CG weights ``sh @ CG``, the
  coupled segments, ``P = ht @ coupled`` and ``sum_h P[h] @ T[h] / sqrt(fan)``
  per receiver and class, and writes the e3nn layout directly.

:func:`factored_tp_reference` is the plain version of gen 2 AND gen 1: the
per-class einsum path of ``pallas_tpconv2.py:_forward_xla``. On a CPU tensor
the wrappers run it; on a CUDA tensor they launch their kernel or raise.
The gradient of :func:`factored_tp2` (a ``torch.autograd.Function``)
differentiates the plain version, as the TPU kernel's custom VJP
differentiates ``_forward_xla``.

An output class with no path (``fan == 0``) makes the JAX functions fail
(``_forward_xla`` finds nothing to concatenate, the kernels divide by
sqrt(0)); the port refuses such a TP with a ``ValueError`` naming the class.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

from diffdock_tpu_torch.ops.fused_tp3 import LaunchCounts
from diffdock_tpu_torch.utils import build

_SOURCES = ("factored_tp2.cu",)

counts = LaunchCounts("factored_tp2", "factored_tp_reference")


def check_no_empty_class(tp, name: str) -> None:
    """Raise ``ValueError`` if an output class of ``tp`` has no path."""
    for k, (fan, ek) in enumerate(zip(tp.fan_in, tp.irreps_out)):
        if fan == 0:
            raise ValueError(
                f"{name}: output class {k} ({ek}) of {tp.irreps_in1} x {tp.irreps_in2} -> "
                f"{tp.irreps_out} has no path (fan 0); the factored kernels take only "
                "TPs whose every output class has a path"
            )


def factored_tp_reference(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """Plain PyTorch version (``pallas_tpconv2.py:_forward_xla``): per class
    ``p_h = h^T coupled``, ``p_b = mw^T coupled``, then the d3-identity
    expanded weights and bias, divided by sqrt(fan)."""
    check_no_empty_class(tp, "factored_tp_reference")
    counts.add("factored_tp_reference")
    H = h.shape[-1]
    outs = []
    for k, ((offset, fan, mul), ek) in enumerate(zip(tp.weight_slices(), tp.irreps_out)):
        d3 = ek.ir.dim
        coupled = tp.coupled_class_merged(k, x_nbr, edge_sh)  # (N, K, fan*d3)
        p_h = torch.einsum("rkh,rkF->rhF", h, coupled)
        p_b = torch.einsum("rk,rkF->rF", mw.to(h.dtype), coupled)
        t_k = out_kernel[:, offset : offset + fan * mul].reshape(H, fan, mul)
        b_k = out_bias[offset : offset + fan * mul].reshape(fan, mul)
        tt = tp.expand_weight_identity(t_k, d3)
        bb = tp.expand_bias_identity(b_k, d3)
        out_k = (p_h.reshape(p_h.shape[0], H * fan * d3) @ tt + p_b @ bb) / math.sqrt(fan)
        outs.append(out_k)
    return torch.cat(outs, dim=-1)


# ----------------------------------------------------------------------
# host-side packing (``build_specs2``, ``pack_neighbors2``)
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PathSpec2:
    xp_start: int  # slice start into the packed [path][i][u] input
    mul: int  # u
    d1: int  # i
    cg_col: int  # column offset into the (J, cols) CG matrix


@dataclasses.dataclass(frozen=True)
class ClassSpec2:
    fan: int
    d3: int
    mul_out: int
    out_off: int  # offset of the class in the e3nn output
    paths: Tuple[PathSpec2, ...]


def build_specs2(tp):
    """(specs, cg_full (J, cols), packed input width, output width): one CG
    matrix whose row j is the absolute spherical-harmonic index, so one
    ``sh @ cg_full`` gives every path's coupling weights."""
    J = tp.irreps_in2.dim
    specs: List[ClassSpec2] = []
    blocks = []
    col = xp_off = out_off = 0
    for pk, fan, ek in zip(tp.paths, tp.fan_in, tp.irreps_out):
        d3 = ek.ir.dim
        paths = []
        for p in pk:
            e1 = tp.irreps_in1[p.i]
            cgm = p.cg.transpose(1, 0, 2).reshape(p.cg.shape[1], -1)  # (d2, d1*d3)
            paths.append(PathSpec2(xp_start=xp_off, mul=e1.mul, d1=e1.ir.dim, cg_col=col))
            blocks.append((tp._sl2[p.j].start, cgm))
            col += cgm.shape[1]
            xp_off += e1.ir.dim * e1.mul
        specs.append(ClassSpec2(fan=fan, d3=d3, mul_out=ek.mul, out_off=out_off,
                                paths=tuple(paths)))
        out_off += ek.mul * d3
    cg_full = np.zeros((J, max(col, 1)), np.float32)
    c = 0
    for row, b in blocks:
        cg_full[row : row + b.shape[0], c : c + b.shape[1]] = b
        c += b.shape[1]
    return tuple(specs), cg_full, xp_off, out_off


def pack_neighbors(tp, x_nbr: torch.Tensor) -> torch.Tensor:
    """(N, K, F_in) -> (N, K, sum_p d1*u): each path's features in [i][u]
    order (i outer), as ``pack_neighbors2`` (and gen 1's ``pack_neighbors``)."""
    parts = []
    for pk in tp.paths:
        for p in pk:
            e1 = tp.irreps_in1[p.i]
            a = x_nbr[..., tp._sl1[p.i]]
            a = a.reshape(a.shape[:-1] + (e1.mul, e1.ir.dim))
            parts.append(a.transpose(-1, -2).reshape(a.shape[:-2] + (e1.ir.dim * e1.mul,)))
    return torch.cat(parts, dim=-1)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def class_table(specs, He: int) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's tables: per class (fan, d3, mul, out_off, col0, ncols,
    path0, n_paths, w_off) and per path (u_off, mul, d1, xp_start, col),
    ``col`` relative to the class's first CG column, int32."""
    cls_rows, path_rows = [], []
    w_off = 0
    for s in specs:
        col0 = s.paths[0].cg_col
        ncols = sum(p.d1 * s.d3 for p in s.paths)
        cls_rows.append((s.fan, s.d3, s.mul_out, s.out_off, col0, ncols, len(path_rows),
                         len(s.paths), w_off))
        u_off = 0
        for p in s.paths:
            path_rows.append((u_off, p.mul, p.d1, p.xp_start, p.cg_col - col0))
            u_off += p.mul
        w_off += He * s.fan * s.mul_out
    return (np.asarray(cls_rows, np.int32).reshape(-1, 9),
            np.asarray(path_rows, np.int32).reshape(-1, 5))


def prepare(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """The torch side of the kernel call, as ``_forward_pallas`` packs it:
    (xp, edge_sh, ht (N, He, K), H+1, cg_full, packed (He, fan, mul)
    weights, class rows, path rows). Rows of ``ht`` past H+1 are zero
    padding, which the kernel does not walk."""
    check_no_empty_class(tp, "factored_tp2")
    specs, cg_full, _xp_dim, _out_dim = build_specs2(tp)
    N, K, _ = x_nbr.shape
    H = h.shape[-1]
    He = _round_up(H + 1, 16)
    xp = pack_neighbors(tp, x_nbr).contiguous()
    h_aug = torch.cat([h, mw[..., None].to(h.dtype)], dim=-1)
    h_aug = torch.nn.functional.pad(h_aug, (0, He - H - 1))
    ht = h_aug.transpose(-1, -2).contiguous()  # (N, He, K)
    blocks = []
    off = 0
    for s in specs:
        t_k = out_kernel[:, off : off + s.fan * s.mul_out].reshape(H, s.fan, s.mul_out)
        b_k = out_bias[off : off + s.fan * s.mul_out].reshape(1, s.fan, s.mul_out)
        pad = t_k.new_zeros(He - H - 1, s.fan, s.mul_out)
        blocks.append(torch.cat([t_k, b_k, pad], dim=0).reshape(-1))
        off += s.fan * s.mul_out
    weights = torch.cat(blocks).contiguous()
    cg = tp._consts.get("gen2_cg_full", cg_full, x_nbr)
    cls_rows, path_rows = class_table(specs, He)
    return xp, edge_sh.contiguous(), ht, H + 1, cg, weights, cls_rows, path_rows


# ----------------------------------------------------------------------
# the kernel
# ----------------------------------------------------------------------


class _Kernel:
    """The loaded library with its ``argtypes`` set."""

    def __init__(self):
        lib = build.load("factored_tp2", _SOURCES)
        fn = lib.factored_tp2_forward
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        for name in ("factored_tp2_max_classes", "factored_tp2_max_paths",
                     "factored_tp2_max_columns", "factored_tp2_max_outputs"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        self.forward = fn
        self.max_classes = lib.factored_tp2_max_classes()
        self.max_paths = lib.factored_tp2_max_paths()
        self.max_columns = lib.factored_tp2_max_columns()
        self.max_outputs = lib.factored_tp2_max_outputs()


_kernel = None


def _get_kernel() -> _Kernel:
    global _kernel
    if _kernel is None:
        _kernel = _Kernel()
    return _kernel


def check_operands(name: str, tensors) -> None:
    """CUDA, float32, contiguous, all on one device."""
    dev = tensors[0][1].device
    for label, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: {label} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, {tensors[0][0]} on {dev}")


def check_tables(name: str, kern, cls_rows: np.ndarray, path_rows: np.ndarray) -> None:
    """The limits the kernel's tables and blocks impose, as clear errors."""
    n_classes, n_paths = cls_rows.shape[0], path_rows.shape[0]
    if not 1 <= n_classes <= kern.max_classes:
        raise ValueError(f"{name}: {n_classes} output classes, the kernel takes 1..{kern.max_classes}")
    if n_paths > kern.max_paths:
        raise ValueError(f"{name}: {n_paths} paths, the kernel takes at most {kern.max_paths}")
    fd = cls_rows[:, 0] * cls_rows[:, 1]
    wd = cls_rows[:, 2] * cls_rows[:, 1]
    if fd.max() > kern.max_columns:
        raise ValueError(f"{name}: a class has fan*d3 = {fd.max()} coupled columns, "
                         f"the kernel takes at most {kern.max_columns}")
    if wd.max() > kern.max_outputs:
        raise ValueError(f"{name}: a class has mul*d3 = {wd.max()} outputs, "
                         f"the kernel takes at most {kern.max_outputs}")


def launch(xp, sh, ht, Ha: int, cg, weights, cls_rows, path_rows, out_dim: int
           ) -> torch.Tensor:
    """Launch the kernel on prepared operands (see :func:`prepare`).
    Returns (N, out_dim) f32 in e3nn layout."""
    check_operands("factored_tp2", (("xp", xp), ("edge_sh", sh), ("ht", ht), ("cg", cg),
                                    ("weights", weights)))
    N, K, XP = xp.shape
    J = sh.shape[-1]
    He = ht.shape[1]
    if sh.shape[:2] != (N, K) or ht.shape != (N, He, K) or cg.shape[0] != J or not 1 <= Ha <= He:
        raise ValueError(f"factored_tp2: operand shapes xp {tuple(xp.shape)}, edge_sh "
                         f"{tuple(sh.shape)}, ht {tuple(ht.shape)}, cg {tuple(cg.shape)} disagree")
    kern = _get_kernel()
    check_tables("factored_tp2", kern, cls_rows, path_rows)
    if weights.numel() != int((He * cls_rows[:, 0] * cls_rows[:, 2]).sum()):
        raise ValueError("factored_tp2: weights do not match the class table")
    out = torch.empty(N, out_dim, device=xp.device, dtype=torch.float32)
    cls_rows = np.ascontiguousarray(cls_rows, np.int32)
    path_rows = np.ascontiguousarray(path_rows, np.int32)
    err = kern.forward(
        xp.data_ptr(), sh.data_ptr(), ht.data_ptr(), cg.data_ptr(), weights.data_ptr(),
        out.data_ptr(), cls_rows.ctypes.data, cls_rows.shape[0], path_rows.ctypes.data,
        path_rows.shape[0], N, K, XP, J, He, Ha, cg.shape[1], out_dim,
        torch.cuda.current_stream(xp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"factored_tp2 kernel launch failed: cudaError {err}")
    counts.add("factored_tp2")
    return out


def _forward_kernel(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    return launch(*prepare(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias), tp.irreps_out.dim)


class _Gen2(torch.autograd.Function):
    """Forward through the kernel (or, on the CPU, the plain version);
    backward differentiates the plain version."""

    @staticmethod
    def forward(ctx, tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
        ctx.tp = tp
        ctx.save_for_backward(x_nbr, edge_sh, h, mw, out_kernel, out_bias)
        fwd = _forward_kernel if x_nbr.is_cuda else factored_tp_reference
        return fwd(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
            out = factored_tp_reference(ctx.tp, *leaves)
            wanted = [t for t, n in zip(leaves, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, grad)) if wanted else iter(())
        return (None,) + tuple(next(grads) if n else None for n in needs)


def factored_tp2(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias):
    """Summed TP messages (N, dim_out) f32 through the gen-2 Hopper kernel,
    differentiable; on CPU tensors through :func:`factored_tp_reference`."""
    check_no_empty_class(tp, "factored_tp2")
    return _Gen2.apply(tp, x_nbr, edge_sh, h, mw, out_kernel, out_bias)
