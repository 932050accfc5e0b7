"""JAX's threefry random numbers in torch, for the weights JAX's random init
gives: ``key``, ``split``, ``fold_in``, 32-bit ``random_bits``, ``uniform``,
``erf_inv`` and ``truncated_normal``, bit for bit as the JAX package draws
them on the CPU.

The mode is fixed in code: ``jax_threefry_partitionable`` on (JAX's default
since 0.5) and 64-bit types off, so a key is the pair of 32-bit words
(0, seed mod 2**32); ``split(k, n)[i]`` is ``fold_in(k, i)`` and the i-th of
``random_bits(k, shape)`` is the xor of the two words of
threefry2x32(k, (i >> 32, i mod 2**32)).

Keys are Python int pairs and are derived on the host. Bits and floats are
computed on the device of the call, in int64 tensors masked to 32 bits and
in float32 with every rounding written out: where XLA's CPU code fuses a
multiply into an add, the product and sum are taken in float64 and rounded
once to float32 (``_fma``), and the logarithm inside ``erf_inv`` is XLA's
own single-precision one. No library transcendental is called, so the CPU
and the card give the same bits. ``tests/test_torch_jax_random.py`` holds
every function to the installed JAX, ``erf_inv`` over every input that
``truncated_normal(-2, 2)`` can produce.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Key = tuple[int, int]
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k: Key, x0, x1):
    """Threefry-2x32, 20 rounds, on counter words x0, x1 (Python ints or
    int64 tensors holding 32-bit values) -> the two output words."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ (((x1 << r) & _M32) | (x1 >> (32 - r)))
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` with 64-bit types off: the seed as int32."""
    return (0, int(seed) & _M32)


def fold_in(k: Key, data: int) -> Key:
    return threefry2x32(k, 0, int(data) & _M32)


def split(k: Key, num: int) -> list[Key]:
    return [fold_in(k, i) for i in range(num)]


def random_bits(k: Key, shape, device="cpu") -> torch.Tensor:
    """32 random bits for each element of `shape`, as int64 in [0, 2**32)."""
    count = math.prod(shape)
    if count >= 2**32:
        raise ValueError(f"random_bits of {count} elements: counters past 2**32 are not written")
    lo = torch.arange(count, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k, torch.zeros_like(lo), lo)
    return (b0 ^ b1).reshape(shape)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as XLA's CPU code fuses it (the
    float32 product is exact in float64)."""
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else x for x in (a, b, c))
    return (a * b + c).float()


def uniform(k: Key, shape, minval: float = 0.0, maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform``, float32: 23 random mantissa bits give f in
    [1, 2); the result is max(minval, (f - 1) * (maxval - minval) + minval)."""
    lo, hi = _f32(minval), _f32(maxval)
    bits = ((random_bits(k, shape, device) >> 9) | 0x3F800000).to(torch.int32)
    floats = bits.view(torch.float32) - 1.0
    return torch.clamp(_fma(floats, _f32(hi - lo), lo), min=lo)


# XLA's single-precision log (the Cephes polynomial of its CPU code).
_SQRT_HALF = _f32(0.707106781186547524)
_LOG_P = tuple(_f32(c) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
                                 1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
                                 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
# XLA's log1p for |x| < sqrt(2) - 1: Cephes' rational, numerator and
# denominator highest degree first.
_LOG1P_NUM = tuple(_f32(c) for c in (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
                                     6.5787325942061044846969e0, 2.9911919328553073277375e1,
                                     6.0949667980987787057556e1, 5.7112963590585538103336e1,
                                     2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32(c) for c in (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
                                     2.2176239823732856465394e2, 3.0909872225312059774938e2,
                                     2.1642788614495947685003e2, 6.0118660497603843919306e1))
# Giles' single-precision erf_inv, for w < 5 and w >= 5.
_ERFINV_LT5 = tuple(_f32(c) for c in (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                                      0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                                      1.50140941))
_ERFINV_GE5 = tuple(_f32(c) for c in (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                                      0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                                      2.83297682))


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log for positive normal x."""
    m, e = torch.frexp(x)  # m in [0.5, 1)
    e = e.float()
    small = m < _SQRT_HALF
    e = e - small.float()
    m = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma(_fma(p[0], m, p[1]), m, p[2])
    y1 = _fma(_fma(p[3], m, p[4]), m, p[5])
    y2 = _fma(_fma(p[6], m, p[7]), m, p[8])
    y = _fma(_fma(y, m3, y1), m3, y2)
    y = _fma(y, m3, e * _LOG_Q1)
    return ((m - m2 * 0.5) + y) + e * _LOG_Q2


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: Cephes' rational near 0, log(1 + x) elsewhere."""
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for c in _LOG1P_NUM:
        num = _fma(num, x, c)
    for c in _LOG1P_DEN:
        den = _fma(den, x, c)
    x2 = x * x
    near = x + _fma(-0.5, x2, (x * x2) * (num / den))
    far = _log(torch.where(x > -1.0, x + 1.0, torch.ones_like(x)))
    return torch.where(x.abs() < _f32(0.41421356237309504880), near, far)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` in float32 for |x| < 1 (Giles' polynomial in
    w = -log1p(-x**2), Horner's steps fused as XLA fuses them)."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, a, b))
    return p * x


# erf(+-2 / sqrt(2)) as XLA's float32 erf gives them (the tests take them
# from jax.lax.erf): the ends of truncated_normal(-2, 2)'s uniform draw.
ERF_OF = {-2.0: float.fromhex("-0x1.e8b43p-1"), 2.0: float.fromhex("0x1.e8b43p-1")}


def truncated_normal(k: Key, lower: float, upper: float, shape, device="cpu") -> torch.Tensor:
    """``jax.random.truncated_normal`` in float32, for the bounds in ERF_OF."""
    if lower not in ERF_OF or upper not in ERF_OF:
        raise ValueError(f"truncated_normal({lower}, {upper}): only the bounds {sorted(ERF_OF)} are written")
    u = uniform(k, shape, ERF_OF[lower], ERF_OF[upper], device)
    out = _f32(math.sqrt(2.0)) * erf_inv(u)
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    return torch.clamp(out, lo, hi)
