"""The reference's random streams in numpy: threefry keys, bits and
distributions as ``jax.random`` computes them, the initializers of
``jax.nn.initializers`` and flax's folding of a module path into a key.

Written against JAX 0.9.0 with ``jax_threefry_partitionable`` on (its
default) and 64-bit types off, and flax 0.12.3 (``flax_fix_rng_separator``
off), the versions the JAX package runs with:

* a key is two uint32 words; ``PRNGKey(seed)`` is ``[0, seed mod 2**32]``
  for any seed of int64's range (JAX converts the seed to int64 and then,
  with 64-bit types off, to int32);
* ``threefry2x32`` is Threefry-2x32 with 20 rounds, JAX's rotations
  (13, 15, 26, 6 / 17, 29, 16, 24) and key schedule;
* ``fold_in(key, d)`` hashes the counter pair (0, d); ``split`` hashes
  (hi(i), lo(i)) for i < num;
* ``random_bits(key, shape)`` gives element i (flat, row-major) the
  32-bit word ``y0 ^ y1`` of ``threefry2x32(key, hi(i), lo(i))``: the
  stream is partitionable, so any slice of it is drawn alone by giving
  its first flat index as ``offset``;
* ``uniform`` puts 23 random bits under the exponent of 1.0, subtracts
  1 and scales, ``bernoulli(p)`` is ``uniform < p``;
* ``truncated_normal`` is ``sqrt(2) * erf_inv(u)`` for u uniform between
  the erf of the bounds, clipped to just inside them. ``erf``, ``erf_inv``
  and the ``log1p`` inside it are the polynomials that XLA's CPU backend
  evaluates, written out here;
* ``fold_in_static`` is flax's ``_fold_in_static``: the SHA-1 of the
  path's strings (UTF-8) and ints (big-endian, minimal length), its first
  four bytes big-endian, folded in.

Every float value is computed with operations whose result does not
depend on the host: + - * / and sqrt, rounded once, in f32 or f64;
integer and bit operations; and fused multiply-adds done exactly (the
product is exact in f64, and the sum is rounded once to f32 by
:func:`_fma32`). Numpy's f32 ``log1p`` and ``exp`` are not used: they
take another code path on another CPU. So a draw is the same on every
host, and the CPU tests hold it against JAX's.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Sequence, Tuple, Union

import numpy as np

U32 = np.uint32
_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


# -- threefry -----------------------------------------------------------------

def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << U32(d)) | (x >> U32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counter pairs (x0, x1) (uint32 arrays of one
    shape) under ``key`` (two uint32), 20 rounds, as JAX's
    ``_threefry2x32_lowering``."""
    k0, k1 = U32(key[0]), U32(key[1])
    ks = (k0, k1, U32(k0 ^ k1 ^ U32(0x1BD11BDA)))
    x0 = np.asarray(x0, U32) + ks[0]
    x1 = np.asarray(x1, U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: ``[0, seed mod
    2**32]``. Raises OverflowError outside int64's range, as JAX does."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError(f"seed {seed} is out of int64's range")
    return np.array([0, seed & _MASK32], U32)


def _threefry_pair(k0: int, k1: int, x0: int, x1: int) -> Tuple[int, int]:
    """``threefry2x32`` of one counter pair on Python ints: a key is
    derived once a step and layer, on the host, where numpy's per-call
    cost on one-element arrays would dominate."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + k0) & _MASK32, (x1 + k1) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: data (taken mod 2**32) hashed as
    the counter pair (0, data)."""
    return np.array(_threefry_pair(int(key[0]), int(key[1]), 0,
                                   int(data) & _MASK32), U32)


def _counters(offset: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
    """(hi, lo) words of the flat indices offset .. offset + count - 1."""
    idx = np.arange(count, dtype=np.uint64) + np.uint64(offset)
    return (idx >> np.uint64(32)).astype(U32), (idx & np.uint64(_MASK32)
                                                ).astype(U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` (partitionable): (num, 2) uint32,
    key i being the hash of (hi(i), lo(i))."""
    y0, y1 = threefry2x32(key, *_counters(0, num))
    return np.stack([y0, y1], axis=1)


def random_bits(key: np.ndarray, shape: Sequence[int], offset: int = 0
                ) -> np.ndarray:
    """32 random bits per element of ``shape`` (uint32): element i of the
    flat stream is ``y0 ^ y1`` of ``threefry2x32(key, hi(i + offset),
    lo(i + offset))``. ``offset`` 0 is ``jax.random.bits(key, shape)``;
    an offset draws the elements from that flat index on."""
    count = math.prod(shape)
    y0, y1 = threefry2x32(key, *_counters(offset, count))
    return (y0 ^ y1).reshape(tuple(shape))


def _unit_floats(bits: np.ndarray) -> np.ndarray:
    """The f32 in [0, 1) whose mantissa is the top 23 of ``bits``."""
    return ((bits >> U32(9)) | U32(0x3F800000)).view(np.float32) \
        - np.float32(1.0)


def uniform(key: np.ndarray, shape: Sequence[int], minval=0.0, maxval=1.0,
            offset: int = 0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``:
    ``max(minval, f * (maxval - minval) + minval)`` for f in [0, 1), in
    f32, the product and the sum fused as XLA's CPU backend fuses them
    (exact for the default bounds)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = _unit_floats(random_bits(key, shape, offset))
    return np.maximum(lo, _fma32(f, hi - lo, lo))


def bernoulli(key: np.ndarray, p: float, shape: Sequence[int],
              offset: int = 0) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` for an f32 ``p``: the
    uniform in [0, 1) below p. Bool."""
    return _unit_floats(random_bits(key, shape, offset)) < np.float32(p)


# -- exact f32 arithmetic -----------------------------------------------------

_BELOW_F32 = np.uint64((1 << 29) - 1)     # f64 mantissa bits below f32's
_HALF_F32 = np.uint64(1 << 28)


def _fma32(a, b, c) -> np.ndarray:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add, for
    results in f32's normal range. The product is exact in f64; the sum
    rounded to f64 and then to f32 is the once-rounded value unless the
    f64 sum lies exactly halfway between two f32 values while the exact
    sum does not. There (rarely) the sum's rounding error (Knuth's
    two-sum) says which way to go."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    s = p + np.float64(c) if np.ndim(c) == 0 else p + c.astype(np.float64)
    r = s.astype(np.float32)
    tie = (s.view(np.uint64) & _BELOW_F32) == _HALF_F32
    if not tie.any():
        return r
    c = np.asarray(c, np.float64)
    p, c, s = (np.broadcast_to(v, tie.shape)[tie] for v in (p, c, s))
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    # One f64 step toward the exact sum leaves the tie on its side.
    r[tie] = np.where(err == 0, s, np.nextafter(s, s + err)).astype(
        np.float32)
    return r


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


# -- erf, log1p, erf_inv (XLA's CPU polynomials) ------------------------------

_ERF_CLAMP = np.float32(3.7439211627767994)
_ERF_ALPHA = tuple(map(np.float32, (
    0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
    0.18520832239976145, 1.128379143519084)))
_ERF_BETA = tuple(map(np.float32, (
    -1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
    0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0)))


def erf(x) -> np.ndarray:
    """XLA's f32 ``erf``: x clamped to +-3.7439212, then an odd over an
    even polynomial in x^2 by fused multiply-adds."""
    x = _f32(x)
    xc = np.clip(x, -_ERF_CLAMP, _ERF_CLAMP)
    x2 = xc * xc
    p = _fma32(x2, _ERF_ALPHA[0], _ERF_ALPHA[1])
    for a in _ERF_ALPHA[2:]:
        p = _fma32(p, x2, a)
    q = _fma32(x2, _ERF_BETA[0], _ERF_BETA[1])
    for b in _ERF_BETA[2:]:
        q = _fma32(q, x2, b)
    return (xc * p) / q


_LOG_P = tuple(map(np.float32, (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)))
_LOG_Q1 = np.float32(-2.12194440e-4)
_LOG_Q2 = np.float32(0.693359375)


def _log32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU f32 ``log`` for positive normal x (Cephes): x = 2^e m
    with m in [sqrt(1/2), sqrt(2)), a degree-9 polynomial in m - 1, and
    e log(2) added in two parts."""
    x = _f32(x)
    bits = x.view(U32)
    e = ((bits >> U32(23)).astype(np.int32) - 126).astype(np.float32)
    m = ((bits & U32(0x807FFFFF)) | U32(0x3F000000)).view(np.float32)
    small = m < np.float32(0.70710678118654752)
    e = np.where(small, e - np.float32(1.0), e)
    m = np.where(small, (m - np.float32(1.0)) + m, m - np.float32(1.0))
    x2 = m * m
    x3 = x2 * m
    y = _fma32(m, _LOG_P[0], _LOG_P[1])
    y1 = _fma32(m, _LOG_P[3], _LOG_P[4])
    y2 = _fma32(m, _LOG_P[6], _LOG_P[7])
    y = _fma32(y, m, _LOG_P[2])
    y1 = _fma32(y1, m, _LOG_P[5])
    y2 = _fma32(y2, m, _LOG_P[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, e * _LOG_Q1)
    m = _fma32(x2, np.float32(-0.5), m)
    m = m + y
    return _fma32(e, _LOG_Q2, m)


# The rational approximation of log1p on |x| < sqrt(2) - 1 (Cephes).
_LOG1P_NUM = tuple(map(np.float32, (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553540281255e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)))
_LOG1P_DEN = tuple(map(np.float32, (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)))


def _horner(coeffs, x: np.ndarray) -> np.ndarray:
    """The f32 polynomial by fused multiply-adds, highest power first."""
    x64 = x.astype(np.float64)
    p = np.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma32(p, x64, c)
    return p


def log1p(x) -> np.ndarray:
    """XLA's CPU f32 ``log1p`` on (-1, inf): for |x| < sqrt(2) - 1,
    ``x - x^2 / 2 + x^3 P(x) / Q(x)``; above, ``log(1 + x)``."""
    x = _f32(x)
    small = np.abs(x) < np.float32(0.41421356237309504880)
    out = np.empty_like(x)
    xs = x[small]
    x2 = xs * xs
    ratio = _horner(_LOG1P_NUM, xs) / _horner(_LOG1P_DEN, xs)
    out[small] = xs + _fma32(np.float32(-0.5), x2, (xs * x2) * ratio)
    out[~small] = _log32(x[~small] + np.float32(1.0))
    return out


_ERFINV_LT5 = tuple(map(np.float32, (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941)))
_ERFINV_GE5 = tuple(map(np.float32, (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682)))


def erf_inv(x) -> np.ndarray:
    """XLA's f32 ``erf_inv`` (Giles): w = -log1p(-x^2), a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at
    |x| = 1."""
    x = _f32(x)
    w = -log1p(x * -x)
    lt = w < np.float32(5.0)
    p = np.empty_like(x)
    for sel, coeffs, t in (
            (lt, _ERFINV_LT5, lambda w: w - np.float32(2.5)),
            (~lt, _ERFINV_GE5, lambda w: np.sqrt(w) - np.float32(3.0))):
        if sel.any():
            p[sel] = _horner(coeffs, t(w[sel]))
    return np.where(np.abs(x) == np.float32(1.0),
                    np.copysign(np.float32(np.inf), x), p * x)


def truncated_normal(key: np.ndarray, lower: float, upper: float,
                     shape: Sequence[int]) -> np.ndarray:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``."""
    sqrt2 = np.float32(np.sqrt(2.0))
    lo, hi = np.float32(lower), np.float32(upper)
    a = erf(lo / sqrt2)
    b = erf(hi / sqrt2)
    u = uniform(key, shape, a, b)
    out = sqrt2 * erf_inv(u)
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf)))


# -- initializers (jax.nn.initializers) ---------------------------------------

Initializer = Callable[[np.ndarray, Tuple[int, ...]], np.ndarray]


def variance_scaling(scale: float, mode: str, distribution: str
                     ) -> Initializer:
    """``jax.nn.initializers.variance_scaling(scale, "fan_in",
    "truncated_normal")`` in f32, the one form the JAX package's models
    use: a truncated normal on [-2, 2] times ``sqrt(f32(scale / fan_in))
    / f32(0.87962566103423978)``, fan_in the product of every axis but
    the last."""
    if (mode, distribution) != ("fan_in", "truncated_normal"):
        raise NotImplementedError(
            f"variance_scaling({mode!r}, {distribution!r}): the JAX "
            "package's models draw only fan_in truncated normals")

    def init(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
        variance = np.float32(scale / math.prod(shape[:-1]))
        stddev = np.sqrt(variance) / np.float32(0.87962566103423978)
        return truncated_normal(key, -2.0, 2.0, shape) * stddev
    return init


def lecun_normal() -> Initializer:
    """``jax.nn.initializers.lecun_normal()``: variance 1 / fan_in."""
    return variance_scaling(1.0, "fan_in", "truncated_normal")


def zeros(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    return np.zeros(shape, np.float32)


def ones(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    return np.ones(shape, np.float32)


def constant(value: float) -> Initializer:
    def init(key: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
        return np.full(shape, value, np.float32)
    return init


# -- flax ---------------------------------------------------------------------

def fold_in_static(key: np.ndarray, data: Sequence[Union[str, int]]
                   ) -> np.ndarray:
    """flax's ``_fold_in_static(key, data)``: the SHA-1 of the strings
    (UTF-8) and non-negative ints (big-endian, fewest bytes) of ``data``,
    its first four bytes as a big-endian uint32, folded into ``key``;
    ``key`` itself for empty data."""
    if not data:
        return np.asarray(key, U32)
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
        else:
            raise ValueError(f"expected an int or a str, got {x!r}")
    return fold_in(key, int.from_bytes(m.digest()[:4], "big"))
