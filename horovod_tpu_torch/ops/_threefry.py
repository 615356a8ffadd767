"""JAX's default random draw, reproduced in numpy integer arithmetic.

``normal(seed, shape)`` equals ``jax.random.normal(jax.random.PRNGKey(seed),
shape, jnp.float32)`` as JAX computes it on the CPU with
``jax_threefry_partitionable`` on (JAX 0.9.0's default), so a port that
seeds a draw the way the JAX package does starts from the same numbers
on a host that has no JAX.  The steps, each as JAX takes it:

1. ``PRNGKey(s)`` is the uint32 pair ``[0, s]`` (``s`` below 2**32);
2. ``random_bits``: element ``i`` of the flat shape is the 64-bit counter
   ``i`` split into ``(hi, lo)``; threefry-2x32 (20 rounds) encrypts it
   under the key, and the bits are the two output words xor'ed;
3. ``uniform(lo=nextafter(-1, 0), hi=1)``: ``(bits >> 9) | 0x3F800000``
   read as f32, minus 1, times ``hi - lo``, plus ``lo``, clamped below
   at ``lo``;
4. ``normal = sqrt(2) * erfinv(u)``, with XLA's f32 ``ErfInv`` (Giles'
   single-precision polynomial) over XLA's f32 ``log1p`` and ``log``
   (Cephes' forms), each multiply-add fused as XLA's compiled CPU code
   fuses it.  ``torch.erfinv`` or numpy's ``log1p`` would be off by up to
   tens of ulps near ``|u| = 1``, where erfinv is steep.

``tests/test_torch_compression.py`` holds it against ``jax.random.normal``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# XLA's ErfInv32 coefficients, highest power first (w < 5, else).
_ERFINV_SMALL = np.array([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941], np.float32)
_ERFINV_LARGE = np.array([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682], np.float32)

# Cephes' logf and log1p, as XLA's CPU code evaluates them.
_LOG_P = np.array([
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1], np.float32)
_LOG_Q1 = np.float32(-2.12194440e-4)
_LOG_Q2 = np.float32(0.693359375)
_LOG1P_NUM = np.array([
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1], np.float32)
_LOG1P_DEN = np.array([
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1], np.float32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: Sequence[int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def random_bits(seed: int, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(PRNGKey(seed), shape, uint32)``."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is not a uint32")
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32((0, seed), hi, lo)
    return (b0 ^ b1).reshape(tuple(shape))


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` rounded once to f32, as the CPU's fused multiply-add
    that XLA's compiled code contracts these steps into (the f32 product
    is exact in f64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _log(v: np.ndarray) -> np.ndarray:
    """XLA's CPU f32 ``log`` of a positive normal ``v``: Cephes' logf
    (Eigen's ``plog``) with the same fused steps."""
    m, e = np.frexp(v)
    m, e = m.astype(np.float32), e.astype(np.float32)
    low = m < np.float32(0.707106781186547524)
    one = np.float32(1.0)
    x = ((m - one) + np.where(low, m, np.float32(0.0))).astype(np.float32)
    e = (e - np.where(low, one, np.float32(0.0))).astype(np.float32)
    x2 = (x * x).astype(np.float32)
    x3 = (x2 * x).astype(np.float32)
    c = _LOG_P
    y = _fma(_fma(x, c[0], c[1]), x, c[2])
    y1 = _fma(_fma(x, c[3], c[4]), x, c[5])
    y2 = _fma(_fma(x, c[6], c[7]), x, c[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, (_LOG_Q1 * e).astype(np.float32))
    t = (_fma(np.float32(-0.5), x2, x) + y).astype(np.float32)
    return _fma(_LOG_Q2, e, t)


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``log1p``: Cephes' rational form below sqrt(2) - 1 in
    magnitude, ``log(1 + x)`` above."""
    xs = (x * x).astype(np.float32)
    num = np.zeros_like(x)
    for c in _LOG1P_NUM:
        num = _fma(num, x, c)
    den = np.zeros_like(x)
    for c in _LOG1P_DEN:
        den = _fma(den, x, c)
    r = (((x * xs).astype(np.float32) * (num / den).astype(np.float32))
         .astype(np.float32))
    small = (x + _fma(np.float32(-0.5), xs, r)).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        large = _log((x + np.float32(1.0)).astype(np.float32))
    return np.where(np.abs(x) < np.float32(0.41421356237309504880), small,
                    large)


def _erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``ErfInv``, step by step in f32."""
    x = x.astype(np.float32)
    w = -_log1p(x * -x)
    small = w < np.float32(5.0)
    with np.errstate(invalid="ignore"):
        w = np.where(small, w - np.float32(2.5),
                     np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for c_small, c_large in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, np.where(small, c_small, c_large))
    out = (p * x).astype(np.float32)
    edge = np.abs(x) == np.float32(1.0)
    return np.where(edge, x * np.finfo(np.float32).max, out)


def normal(seed: int, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(PRNGKey(seed), shape, float32)``."""
    bits = random_bits(seed, shape)
    one = np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - one
    u = np.maximum(lo, floats * (one - lo) + lo).astype(np.float32)
    return (np.float32(np.sqrt(2)) * _erfinv(u)).astype(np.float32)
