"""Counter-based random bits, bit-exact with ``jax.random``.

The JAX package draws every random bit from ``jax.random`` under jax's
defaults: the ``threefry2x32`` implementation with
``jax_threefry_partitionable=True``. This module computes the same bits
with torch integer ops, so a row's sampled token is the same function of
(logits, policy, seed, step) in both packages:

- ``threefry2x32(k1, k2, x1, x2)``: the 20-round Threefry-2x32 hash;
- ``prng_key(seed)``: ``jax.random.PRNGKey(seed)`` for a uint32 seed,
  the key (0, seed);
- ``fold_in(key, data)``: ``threefry2x32(key, (0, data))``;
- ``random_bits(key, n)``: 32-bit bits of a length-n draw, the hash of the
  counters (0, i) with the two output words xor-ed (the partitionable
  layout);
- ``uniform`` and ``gumbel`` (``mode="low"``, jax's default): the bits'
  top 23 as a float in [1, 2) minus 1, then ``-log(-log(u))``.

Keys are pairs of tensors; every op is elementwise over them, so a batch
of rows draws with one key per row, on any device, with no host sync
(the paged engine replays its decode step as a CUDA graph). uint32 words
are carried in int64 tensors and masked to 32 bits after each add and
shift.

``gumbel``'s logarithm is the one XLA's CPU backend emits for f32 (the
Cephes polynomial with fused multiply-adds, ``_xla_log``), with each
fused multiply-add taken in f64 and rounded once to f32, so gumbel
values equal ``jax.random.gumbel``'s on the CPU bit for bit; ``torch.log``
differs from it in the last place for ~1 in 7 inputs.
"""
from __future__ import annotations

import struct

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the counter words (x1, x2) under the
    key (k1, k2): int64 tensors (or ints) holding uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def _u32(x, device=None):
    return torch.as_tensor(x, device=device).to(torch.int64) & _M32


def prng_key(seed, device=None):
    """``jax.random.PRNGKey(seed)`` for uint32 seeds: (0, seed)."""
    seed = _u32(seed, device)
    return torch.zeros_like(seed), seed


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``: a new key per element of
    ``data`` (uint32)."""
    k1, k2 = key
    data = _u32(data, k1.device)
    return threefry2x32(k1, k2, torch.zeros_like(data), data)


def random_bits(key, n):
    """uint32 bits (in int64) of a length-``n`` draw per key: [..., n] for
    keys of shape [...]."""
    k1, k2 = key
    k1, k2 = k1[..., None], k2[..., None]
    counts = torch.arange(n, dtype=torch.int64, device=k1.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return b1 ^ b2


def _f32(x):
    """The f32 nearest the float x, as a Python float."""
    return struct.unpack("f", struct.pack("f", x))[0]


def uniform(key, n, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` f32 of a length-``n`` draw per key."""
    bits = random_bits(key, n)
    one = (bits >> 9) | 0x3F800000  # 23 random mantissa bits in [1, 2)
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = _f32(minval)
    return torch.clamp(floats * _f32(_f32(maxval) - lo) + lo, min=lo)


def _fma(a, b, c):
    """a * b + c rounded once to f32 (the product is exact in f64)."""
    return (a.double() * b + c).float()


# the Cephes log polynomial's coefficients and log(2) in two parts, as f32
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG2_LO, _LOG2_HI = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRT_HALF = _f32(0.707106781186547524)
_TINY = _f32(1.1754943508222875e-38)  # the smallest normal f32


def _xla_log(x):
    """f32 natural log as XLA's CPU backend computes it: x = m * 2^e with
    m in [sqrt(1/2), sqrt(2)), log(m) from the Cephes polynomial (fused
    multiply-adds), plus e * log(2) in two parts."""
    p = _LOG_P
    t = torch.clamp(x, min=_TINY)
    bits = t.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    t = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = t < _SQRT_HALF
    t = (t - 1.0) + torch.where(small, t, torch.zeros_like(t))
    e = e - small.float()
    x2 = t * t
    x3 = x2 * t
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG2_LO * e)
    t = (t - 0.5 * x2) + y
    t = t + _LOG2_HI * e
    t = torch.where(x == 0, torch.full_like(t, -torch.inf), t)
    t = torch.where(x == torch.inf, x, t)
    return torch.where((x < 0) | torch.isnan(x), torch.full_like(t, torch.nan),
                       t)


def gumbel(key, n):
    """``jax.random.gumbel(key, (n,), float32)`` per key (mode "low"):
    ``-log(-log(u))`` with u uniform on [tiny, 1)."""
    u = uniform(key, n, minval=_TINY)
    return -_xla_log(-_xla_log(u))
