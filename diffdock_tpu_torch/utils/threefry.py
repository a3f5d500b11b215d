"""``jax.random.normal(jax.random.PRNGKey(seed), (n,))`` in numpy.

The Fourier time embedding of the JAX package draws its frequencies from
JAX's random number generator (``diffusion/time_embed.py``); the port
reproduces that draw bit for bit without JAX:

* the counter-based Threefry-2x32 hash (20 rounds, Salmon et al., SC'11)
  as JAX applies it with ``jax_threefry_partitionable`` on (the default
  since JAX 0.5): the key ``(seed >> 32, seed & 0xffffffff)`` hashes the
  flat 64-bit index of every element, split into high and low words, and
  the two output words are XORed into 32 random bits;
* ``jax.random.uniform`` on (nextafter(-1, 0), 1): the top 23 bits as the
  mantissa of a float in [1, 2), minus 1, scaled and shifted in float32;
* ``jax.random.normal``: sqrt(2) * erfinv(u) with XLA's float32 ``ErfInv``
  (M. Giles' single-precision polynomials) as the CPU code of XLA evaluates
  it: its ``log1p`` (Cephes' rational function, or its own ``log``
  polynomial) and fused multiply-adds, each step rounded to float32.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The two output words of Threefry-2x32 for the counter words
    ``(x0, x1)`` (uint32 arrays) under ``key`` (two uint32 words)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(seed: int, n: int) -> np.ndarray:
    """``jax.random.bits(PRNGKey(seed), (n,), uint32)`` for a seed in
    [0, 2**31)."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    key = (np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF))
    idx = np.arange(n, dtype=np.uint64)
    hi, lo = (idx >> np.uint64(32)).astype(np.uint32), (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def uniform(seed: int, n: int, minval: float, maxval: float) -> np.ndarray:
    """``jax.random.uniform(PRNGKey(seed), (n,), float32, minval, maxval)``."""
    f32 = np.float32
    bits = (random_bits(seed, n) >> np.uint32(32 - 23)) | np.array(1.0, f32).view(np.uint32)
    floats = bits.view(f32) - f32(1.0)
    lo, hi = f32(minval), f32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once: the float64 product of two float32
    values is exact, and the float64 sum rounds to float32 as a fused
    multiply-add does (XLA's CPU code fuses these)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, np.float32(c))
    return p


# Cephes' logf polynomial, as XLA's CPU code evaluates it
_LOG_P = tuple(np.float32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))


def log_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log`` on the CPU (positive normal inputs)."""
    f32 = np.float32
    x = np.maximum(np.asarray(x, f32), f32(1.17549435e-38))
    bits = x.view(np.uint32)
    e = (f32(1.0) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(f32)).astype(f32)
    m = ((bits & np.uint32(0x807FFFFF)) | np.array(0.5, f32).view(np.uint32)).view(f32)
    below = m < f32(0.707106781186547524)
    t = (m - f32(1.0)).astype(f32)
    e = (e - np.where(below, f32(1.0), f32(0.0))).astype(f32)
    t = (t + np.where(below, m, f32(0.0))).astype(f32)
    x2 = (t * t).astype(f32)
    x3 = (x2 * t).astype(f32)
    y = _fma(_fma(t, _LOG_P[0], _LOG_P[1]), t, _LOG_P[2])
    y1 = _fma(_fma(t, _LOG_P[3], _LOG_P[4]), t, _LOG_P[5])
    y2 = _fma(_fma(t, _LOG_P[6], _LOG_P[7]), t, _LOG_P[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, (f32(-2.12194440e-4) * e).astype(f32))
    t = _fma(f32(-0.5), x2, t)
    t = (t + y).astype(f32)
    return _fma(f32(0.693359375), e, t)


# Cephes' log1p rational function, highest degree first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192198491e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)


def log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` on the CPU: ``log(1 + x)`` for |x| from
    sqrt(2) - 1 on, Cephes' rational function below it."""
    f32 = np.float32
    x = np.asarray(x, f32)
    x2 = (x * x).astype(f32)
    r = (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)).astype(f32)
    small = (x + _fma(f32(-0.5), x2, ((x * x2).astype(f32) * r).astype(f32))).astype(f32)
    with np.errstate(invalid="ignore", divide="ignore"):
        large = log_f32((x + f32(1.0)).astype(f32))
    return np.where(np.abs(x) < f32(0.41421356237309504880), small, large)


# XLA's float32 ErfInv coefficients (M. Giles), highest degree first
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
           -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
           -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``ErfInv`` on the CPU, each step rounded to float32."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -log1p_f32(-(x * x).astype(f32))
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(_W_LT_5[0]), f32(_W_GE_5[0])).astype(f32)
    for a, b in zip(_W_LT_5[1:], _W_GE_5[1:]):
        p = _fma(p, w, np.where(lt, f32(a), f32(b)))
    with np.errstate(over="ignore"):
        return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max, p * x).astype(f32)


def normal(seed: int, n: int) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), (n,))``, float32."""
    f32 = np.float32
    lo = np.nextafter(f32(-1.0), f32(0.0), dtype=f32)
    u = uniform(seed, n, lo, 1.0)
    return (f32(np.sqrt(2)) * erfinv_f32(u)).astype(f32)
