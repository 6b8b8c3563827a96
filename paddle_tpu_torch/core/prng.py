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
- ``split(key, num)``: ``jax.random.split`` in the partitionable mode,
  key i = ``threefry2x32(key, (0, i))`` (so ``split(key)[i]`` equals
  ``fold_in(key, i)``);
- ``uniform`` and ``gumbel`` (``mode="low"``, jax's default): the bits'
  top 23 as a float in [1, 2) minus 1, then ``-log(-log(u))``;
- ``normal``: ``sqrt(2) * erf_inv(u)`` for u uniform on
  [nextafter(-1, 0), 1); ``truncated_normal`` the same over
  [erf(lower / sqrt 2), erf(upper / sqrt 2)), clipped inside the bounds;
  ``bernoulli``: ``uniform < p``.

Keys are pairs of tensors; every op is elementwise over them, so a batch
of rows draws with one key per row, on any device, with no host sync
(the paged engine replays its decode step as a CUDA graph). uint32 words
are carried in int64 tensors and masked to 32 bits after each add and
shift.

``gumbel``'s logarithm is the one XLA's CPU backend emits for f32 (the
Cephes polynomial with fused multiply-adds, ``_xla_log``), with each
fused multiply-add taken in f64 and rounded once to f32, so gumbel
values equal ``jax.random.gumbel``'s on the CPU bit for bit; ``torch.log``
differs from it in the last place for ~1 in 7 inputs. ``erf_inv``,
``erf`` and ``log1p`` are XLA's f32 polynomials the same way (Giles'
erf_inv over a Cephes log1p; a rational erf), and the affine steps of
``uniform`` are one fused multiply-add, as XLA contracts them. ``erf`` and
``log1p`` match XLA bit for bit; ``erf_inv`` in the tail (|u| > 0.9966,
where it takes a square root) differs by one ulp for ~1 in 300 such
inputs, so ``normal`` draws are bit-exact except ~2 in 10^5, which are
at most 2 ulp off (``tests/test_torch_rng_plane.py``).
"""
from __future__ import annotations

import math
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


def split(key, num=2):
    """``jax.random.split(key, num)`` (partitionable threefry): a list of
    ``num`` keys, key i = ``threefry2x32(key, (0, i))`` = ``fold_in(key,
    i)``."""
    return [fold_in(key, i) for i in range(num)]


def random_bits(key, n):
    """uint32 bits (in int64) of a draw per key: [..., n] for keys of
    shape [...] and an int ``n``; [..., *n] for a shape tuple ``n`` (the
    counters run over the flattened shape, as jax's)."""
    k1, k2 = key
    shape = (n,) if isinstance(n, int) else tuple(n)
    k1, k2 = k1[..., None], k2[..., None]
    counts = torch.arange(math.prod(shape), dtype=torch.int64,
                          device=k1.device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    bits = b1 ^ b2
    return bits.reshape(bits.shape[:-1] + shape)


def _f32(x):
    """The f32 nearest the float x, as a Python float."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _fma(a, b, c):
    """a * b + c rounded once to f32 (the product is exact in f64)."""
    if isinstance(a, torch.Tensor):
        return (a.double() * b + c).float()
    return (b.double() * a + c).float()


def _bf16(x):
    """x rounded to bf16 (nearest even), carried as f32: one bf16 op's
    rounding of its f32-exact result."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).float()
    return float(torch.tensor(x, dtype=torch.float32, device="cpu")
                 .to(torch.bfloat16))


def uniform(key, n, minval=0.0, maxval=1.0, dtype=torch.float32):
    """``jax.random.uniform`` of a draw per key (``n`` an int or a shape,
    as ``random_bits``) in f32 or bf16.

    f32: the bits' top 23 as a float in [1, 2) minus 1, then floats *
    (max - min) + min as one fused multiply-add, then at least min.

    bf16 (7 mantissa bits, fewer than 8): jax draws 8-bit words, the low
    byte of each 32-bit word, and keeps their top 7 as the mantissa; every
    step after is a bf16 op, each rounded to bf16 (min and max too), as
    XLA's CPU backend computes them."""
    bits = random_bits(key, n)
    if dtype == torch.bfloat16:
        one = ((bits & 0xFF) >> 1) | 0x3F80  # 7 mantissa bits in [1, 2)
        floats = one.to(torch.int16).view(torch.bfloat16).float() - 1.0
        lo, hi = _bf16(minval), _bf16(maxval)
        out = _bf16(_bf16(floats * _bf16(hi - lo)) + lo)
        return torch.clamp(out, min=lo).to(torch.bfloat16)
    if dtype != torch.float32:
        raise TypeError(f"uniform draws float32 or bfloat16, not {dtype}")
    one = (bits >> 9) | 0x3F800000  # 23 random mantissa bits in [1, 2)
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = _f32(minval)
    return torch.clamp(_fma(floats, _f32(_f32(maxval) - lo), lo), min=lo)


def bernoulli(key, p, shape):
    """``jax.random.bernoulli(key, p, shape)`` (mode "low"): a bool mask,
    uniform < p in f32."""
    return uniform(key, shape) < _f32(p)


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


# XLA's f32 log1p: a Cephes rational for |x| < sqrt(2) - 1, else log(1 + x)
_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_f32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))


def _horner(x, coeffs):
    """sum c_i x^(n-i) by Horner's rule, one fused multiply-add a step."""
    r = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        r = _fma(r, x, c)
    return r


def _xla_log1p(x):
    """f32 log(1 + x) as XLA's CPU backend computes it."""
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(x2, -0.5, (x * x2) * small)
    return torch.where(x.abs() < _f32(0.41421356237309504880), small,
                       _xla_log(x + 1.0))


# Giles' erf_inv: one polynomial in w - 2.5 below w = 5, one in
# sqrt(w) - 3 above, w = -log1p(-x^2)
_ERFINV_LT5 = tuple(_f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(_f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def erf_inv(x):
    """f32 inverse error function as XLA's CPU backend computes it."""
    w = -_xla_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.full_like(x, _ERFINV_LT5[0]),
                    torch.full_like(x, _ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, torch.full_like(x, a),
                                   torch.full_like(x, b)))
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


_ERF_ALPHA = tuple(_f32(c) for c in (
    0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
    0.18520832239976145, 1.128379143519084))
_ERF_BETA = tuple(_f32(c) for c in (
    -1.1791602954361697e-7, 0.000023547966471313185, 0.0010179625278914885,
    0.014070470171167667, 0.11098505178285362, 0.49746925110067538, 1.0))
_ERF_CLAMP = _f32(3.7439211627767994)  # erf_inv(1 - 2^-23)


def erf(x):
    """f32 error function as XLA's CPU backend computes it: x P(x^2) /
    Q(x^2) over x clamped to +-erf_inv(1 - 2^-23)."""
    x = torch.clamp(x, -_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    return (x * _horner(x2, _ERF_ALPHA)) / _horner(x2, _ERF_BETA)


_SQRT2 = _f32(2.0 ** 0.5)


def normal(key, shape, dtype=torch.float32):
    """``jax.random.normal(key, shape, dtype)``: sqrt(2) erf_inv(u), u
    uniform on [nextafter(-1, 0), 1) in the dtype. In bf16, XLA takes
    erf_inv in f32 and rounds it, then multiplies by sqrt(2) rounded to
    bf16 and rounds again."""
    if dtype == torch.bfloat16:
        u = uniform(key, shape, minval=-0.99609375, maxval=1.0,
                    dtype=dtype).float()  # nextafter(-1, 0) in bf16
        return _bf16(_bf16(2.0 ** 0.5) * _bf16(erf_inv(u))).to(dtype)
    lo = _f32(-0.99999994)  # nextafter(-1, 0) in f32
    return _SQRT2 * erf_inv(uniform(key, shape, minval=lo, maxval=1.0))


def _nextafter(x, toward):
    f = torch.tensor([x, toward], dtype=torch.float32, device="cpu")
    return float(torch.nextafter(f[0], f[1]))


def truncated_normal(key, lower, upper, shape, dtype=torch.float32):
    """``jax.random.truncated_normal(key, lower, upper, shape, dtype)`` for
    scalar bounds: sqrt(2) erf_inv(u) for u uniform on
    [erf(lower / sqrt 2), erf(upper / sqrt 2)), clipped to the open
    interval (lower, upper). In bf16 every step is a bf16 op, rounded
    (the bounds, sqrt(2), the quotients, erf and erf_inv taken in f32 and
    rounded)."""
    if dtype == torch.bfloat16:
        lower, upper, sq2 = _bf16(lower), _bf16(upper), _bf16(2.0 ** 0.5)
        b = torch.tensor([lower, upper], dtype=dtype, device="cpu")
        ab = _bf16(erf(_bf16(b.float() / sq2)))
        u = uniform(key, shape, minval=float(ab[0]), maxval=float(ab[1]),
                    dtype=dtype).float()
        out = _bf16(sq2 * _bf16(erf_inv(u)))
        inf = torch.tensor([math.inf, -math.inf], dtype=dtype, device="cpu")
        lo, hi = torch.nextafter(b, inf).tolist()
        return torch.clamp(out, lo, hi).to(dtype)
    lower, upper = _f32(lower), _f32(upper)
    ab = erf(torch.tensor([lower, upper], dtype=torch.float32, device="cpu")
             / _SQRT2)
    a, b = float(ab[0]), float(ab[1])
    out = _SQRT2 * erf_inv(uniform(key, shape, minval=a, maxval=b))
    return torch.clamp(out, _nextafter(lower, float("inf")),
                       _nextafter(upper, float("-inf")))
