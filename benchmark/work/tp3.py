"""The least work of the merged factored tensor-product contraction.

Frozen copies of ``chip_smoke.py``'s ``_class_sums``, ``tp3_work`` and
``bound_ms`` (the work model the port's kernel table uses): the operations
and bytes one contraction of ``rows`` receivers over ``K`` neighbours with
``H`` hidden features must at least do, and the least time the chip could
take for them. ``tp`` is a tensor product of the reference
(``benchmark/reference/ops/tensor_product.py``); only its class structure
is read.
"""

from __future__ import annotations

from typing import Tuple

from benchmark.work.peaks import F32_PEAK_FLOPS, HBM_BYTES_PER_S, TF32X3_PEAK_FLOPS


def class_sums(tp) -> Tuple[int, int, int]:
    """(F_tot, weights, weight columns) over the live output classes."""
    classes = tp.live_classes()
    f_tot = sum(fan * d3 for _k, _o, fan, d3, _m in classes)
    weight = sum(fan * mul * d3 for _k, _o, fan, d3, mul in classes)
    w_len = sum(fan * mul for _k, _o, fan, _d, mul in classes)
    return f_tot, weight, w_len


def tp3_work(f_tot: int, weight: int, w_len: int, out_dim: int, rows: int, K: int, H: int):
    """(product FLOPs, 0, bytes): the neighbour reduction P = h_aug^T
    coupled over every live class, the weight contraction over the compact
    (H+1, fan, mul) blocks, each input (h_aug, the coupled tensor, the
    weights) read once and the output written once, in float32."""
    Ha = H + 1
    products = 2.0 * rows * Ha * K * f_tot + 2.0 * rows * Ha * weight
    nbytes = 4.0 * (rows * K * Ha + rows * K * f_tot + Ha * w_len + rows * out_dim)
    return products, 0.0, nbytes


def bound_ms(products: float, coupling: float, nbytes: float, all_f32: bool = False):
    """(ms, "operations" or "bytes"): the larger of the bytes over the HBM
    rate and the operations over their units' peaks, the products at the
    3xTF32 rate and the coupling at the float32 rate (both at the float32
    rate with ``all_f32``), their times added."""
    t_ops = (products / (F32_PEAK_FLOPS if all_f32 else TF32X3_PEAK_FLOPS)
             + coupling / F32_PEAK_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
