"""JAX's default PRNG (threefry2x32, partitionable mode) in numpy.

The reference's data pipeline draws its tokens with ``jax.random``; the
port has no JAX, so it reproduces the same bits here. Keys are
``(2,) uint32`` arrays, as ``jax.random.PRNGKey`` makes them:

* ``prng_key(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``fold_in(key, data)``: the threefry hash of the count pair
  ``(0, data)``, the two halves of ``threefry_seed(data)``;
* ``split(key, n)`` and ``random_bits``: the hash of a 64-bit iota split
  into high and low words (``iota_2x32_shape``), key i being the pair of
  the two outputs and a 32-bit draw their XOR;
* ``uniform``: the top 23 bits under the exponent of 1.0, minus 1, scaled
  into [minval, maxval) and floored at minval, all in float32;
* ``randint``: two 32-bit draws from the two halves of a split, combined
  with ``multiplier = (2**16 % span)**2 % span``;
* ``normal``: ``sqrt(2) * erfinv(u)`` for u uniform in (-1, 1), with XLA's
  float32 ``ErfInv`` (Giles' two-branch polynomial in
  ``w = -log1p(-u*u)``). numpy's ``log1p`` is not XLA's, so this one lands
  within a few ulp of ``jax.random.normal``, not bit for bit.

Every integer step is uint32 arithmetic with wraparound; the float steps
are float32, in the reference's order.
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of count pairs (x1, x2) under the
    key (k1, k2); all uint32, x1 and x2 of one shape."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a non-negative seed."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    a, b = threefry2x32(key[0], key[1], np.array([0], _U32),
                        np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([a[0], b[0]], _U32)


def _iota_hash(key: np.ndarray, shape: tuple[int, ...]):
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32).reshape(shape)
    lo = idx.astype(_U32).reshape(shape)
    return threefry2x32(key[0], key[1], hi, lo)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32."""
    b1, b2 = _iota_hash(key, (num,))
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits a position, uint32 of ``shape``."""
    b1, b2 = _iota_hash(key, tuple(shape))
    return b1 ^ b2


def uniform(key: np.ndarray, shape: tuple[int, ...], minval=0.0,
            maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    f32 = np.float32
    bits = (random_bits(key, shape) >> _U32(32 - 23)) | _U32(0x3F800000)
    floats = bits.view(f32) - f32(1.0)
    lo, hi = f32(minval), f32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def randint(key: np.ndarray, shape: tuple[int, ...], minval: int,
            maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` with int32 output,
    for 0 <= minval < maxval < 2**31."""
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(maxval - minval)
    with np.errstate(over="ignore"):
        multiplier = _U32(2 ** 16) % span
        multiplier = (multiplier * multiplier) % span
        offset = ((higher % span) * multiplier + lower % span) % span
    return (np.int32(minval) + offset.astype(np.int32)).astype(np.int32)


# XLA's float32 ErfInv (Giles 2010): coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """Inverse error function of float32 x in (-1, 1), in float32."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -np.log1p(-x * x)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = np.where(lt, f32(a), f32(b)) + p * w
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max,
                    p * x).astype(f32)


def normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in float32, within a few ulp."""
    f32 = np.float32
    lo = np.nextafter(f32(-1.0), f32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (f32(np.sqrt(2)) * erfinv_f32(u)).astype(f32)
