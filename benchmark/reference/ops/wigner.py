"""Real-basis Wigner 3j symbols, computed from scratch on the host.

The reference gets its Clebsch-Gordan machinery from e3nn; here we derive it:

1. complex-basis Wigner 3j via the Racah formula (exact with log-factorials
   for the small l <= 4 this model needs), converted to Clebsch-Gordan,
2. change of basis to real spherical harmonics with e3nn's exact phase
   convention (the (-i)^l factor of ``change_basis_real_to_complex`` makes
   the transformed tensor purely real AND fixes every per-path sign to
   e3nn's) — m ordered -l..l, so l=1 maps to (y, z, x), matching our
   closed-form SH in ``ops/spherical.py``.

The result is normalized like e3nn's ``o3.wigner_3j``: the invariant tensor
has unit Frobenius norm per (l1, l2, l3). Tensor-product layers multiply by
``sqrt(2*l3 + 1)`` for 'component' irrep normalization, reproducing e.g. the
1/sqrt(3) dot and 1/sqrt(2) cross couplings spelled out in the reference's
closed-form lmax=1 product (``models/tensor_layers.py:44-122``).
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=None)
def _logfact(n: int) -> float:
    return math.lgamma(n + 1)


def _wigner_3j_m(l1: int, l2: int, l3: int, m1: int, m2: int, m3: int) -> float:
    """Complex-basis Wigner 3j symbol via the Racah formula."""
    if m1 + m2 + m3 != 0:
        return 0.0
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return 0.0
    if abs(m1) > l1 or abs(m2) > l2 or abs(m3) > l3:
        return 0.0

    t1 = l2 - m1 - l3
    t2 = l1 + m2 - l3
    t3 = l1 + l2 - l3
    t4 = l1 - m1
    t5 = l2 + m2
    tmin = max(0, t1, t2)
    tmax = min(t3, t4, t5)

    s = 0.0
    for t in range(tmin, tmax + 1):
        logden = (
            _logfact(t)
            + _logfact(t - t1)
            + _logfact(t - t2)
            + _logfact(t3 - t)
            + _logfact(t4 - t)
            + _logfact(t5 - t)
        )
        s += (-1.0) ** t * math.exp(-logden)

    lognum = 0.5 * (
        _logfact(l1 + l2 - l3)
        + _logfact(l1 - l2 + l3)
        + _logfact(-l1 + l2 + l3)
        - _logfact(l1 + l2 + l3 + 1)
        + _logfact(l1 + m1)
        + _logfact(l1 - m1)
        + _logfact(l2 + m2)
        + _logfact(l2 - m2)
        + _logfact(l3 + m3)
        + _logfact(l3 - m3)
    )
    return (-1.0) ** (l1 - l2 - m3) * math.exp(lognum) * s


@functools.lru_cache(maxsize=None)
def _complex_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Clebsch-Gordan <l1 m1 l2 m2 | l3 m3> (Condon-Shortley) from the 3j
    symbols: CG = (-1)^(l1-l2+m3) * sqrt(2*l3+1) * w3j(m1, m2, -m3)."""
    out = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                out[m1 + l1, m2 + l2, m3 + l3] = (
                    (-1.0) ** (l1 - l2 + m3)
                    * math.sqrt(2 * l3 + 1)
                    * _wigner_3j_m(l1, l2, l3, m1, m2, -m3)
                )
    return out


@functools.lru_cache(maxsize=None)
def _q_real_to_complex(l: int) -> np.ndarray:
    """e3nn's change-of-basis: columns real m (-l..l), rows complex m, with
    the (-i)^l phase that makes the transformed CG purely real. Mirrors
    e3nn ``o3._wigner.change_basis_real_to_complex`` so the SIGN of every
    real 3j tensor matches e3nn's exactly — a per-path sign mismatch would
    silently corrupt imported e3nn-trained weights.
    """
    q = np.zeros((2 * l + 1, 2 * l + 1), dtype=complex)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = 1 / math.sqrt(2)
        q[l + m, l - abs(m)] = -1j / math.sqrt(2)
    q[l, l] = 1.0
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = (-1) ** m / math.sqrt(2)
        q[l + m, l - abs(m)] = 1j * (-1) ** m / math.sqrt(2)
    return (-1j) ** l * q


@functools.lru_cache(maxsize=None)
def real_wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis invariant 3-tensor, unit Frobenius norm, float64,
    sign-matched to e3nn's ``o3.wigner_3j`` (validated against sympy
    Clebsch-Gordan + Gaunt integrals of the e3nn real spherical harmonics
    in ``tests/test_e3nn_parity.py``).

    Zero tensor if the coupling is forbidden by the triangle rule.
    """
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    cg = _complex_cg(l1, l2, l3).astype(complex)
    q1 = _q_real_to_complex(l1)
    q2 = _q_real_to_complex(l2)
    q3 = _q_real_to_complex(l3)
    t = np.einsum("ia,jb,kc,ijk->abc", q1.conj(), q2.conj(), q3, cg)
    assert np.abs(t.imag).max() < 1e-10, (l1, l2, l3, np.abs(t.imag).max())
    out = t.real
    norm = np.linalg.norm(out)
    if norm > 0:
        out = out / norm
    return out
