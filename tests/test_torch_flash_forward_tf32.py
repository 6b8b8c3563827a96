"""The arithmetic of the port's flash-attention forward CUDA kernel,
emulated on the CPU.

The forward kernel runs both products on the tensor cores as 3xTF32 (S =
Q K^T on wgmma, P V on mma.sync): Q, K, P and V split into a tf32 hi (x rounded to nearest, ties away, as
cvt.rna.tf32.f32 does) and lo = x - hi (read truncated to tf32), and each
product sums lo.hi + hi.lo + hi.hi in f32. It walks K/V in tiles of 32
keys with an online softmax, and sums each tile's P V in fresh registers
before adding it to O * alpha. Emulated
here through the int32 view, that forward lies within chip_smoke.py's
5e-5 of the plain f32 version (``flash_attention_reference``, which
tests/test_torch_flash_attention.py holds against the Pallas kernel) and
about as close to f64 as f32 is, while 1xTF32 errs at least 10x more.
Inputs come from a numpy seed.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
from test_torch_flash_backward_tf32 import CHIP_TOL, _split, _tf32_rna

torch.set_num_threads(1)

BK = 32  # K/V rows per tile of the kernel (csrc/flash_attention_fwd.cu)


def _mm_3xtf32(a, b):
    """a @ b as the kernel does it: lo.hi + hi.lo + hi.hi, small terms
    first, each product of tf32 values exact in f32, summed in f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32_rna(a) @ _tf32_rna(b)


def _forward_with(mm, q, k, v, lengths, causal, sm_scale, bk):
    """(o, lse) of the kernel's loop: K/V tiles of ``bk`` keys, the online
    softmax over each, every product taken by ``mm``, each tile's P V a
    fresh sum added to O * alpha."""
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    mask = tfa._mask(Tq, Tk, lengths, causal, q.device)
    neg = torch.tensor(-math.inf, dtype=q.dtype)
    m = torch.full((B, H, Tq, 1), -math.inf, dtype=q.dtype)
    l = torch.zeros((B, H, Tq, 1), dtype=q.dtype)
    acc = torch.zeros((B, H, Tq, D), dtype=q.dtype)
    for k0 in range(0, Tk, bk):
        kt, vt = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        s = mm(q, kt.transpose(-1, -2)) * sm_scale
        s = torch.where(mask[..., k0:k0 + bk], s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.where(m_new == -math.inf, torch.zeros(()), m_new)
        alpha = torch.where(m == -math.inf, torch.zeros(()),
                            torch.exp(m - m_safe))
        p = torch.exp(s - m_safe)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm(p, vt)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, math.inf))
    return o, lse[..., 0]


def _inputs(B, H, T, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(B, H, T, D).astype(np.float32))
                 for _ in range(3))


def _finite_err(got, want):
    """Max abs difference over finite entries; +inf entries must agree."""
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = ~torch.isinf(want)
    return float((got[fin] - want[fin]).abs().max())


# (B, H, T, causal, lengths): T = 100 leaves a ragged last tile; a length
# of 0 is a fully masked row
CASES = {
    "causal": (2, 2, 100, True, None),
    "causal_ragged_fully_masked_row": (3, 2, 100, True, [100, 61, 0]),
    "full_ragged_fully_masked_row": (3, 1, 100, False, [37, 0, 100]),
}


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", sorted(CASES))
def test_3xtf32_forward_keeps_f32_accuracy_where_1xtf32_does_not(case, D):
    """Against the plain f32 version: o and lse within chip_smoke.py's
    5e-5, and 1xTF32 errs at least 10x more. Against f64: about as far as
    f32 is (1.5x allowed: the two sum in different orders)."""
    B, H, T, causal, lengths = CASES[case]
    q, k, v = _inputs(B, H, T, D, seed=D + len(case))
    lens = None if lengths is None else torch.tensor(lengths)
    sm = 1.0 / math.sqrt(D)
    want = tfa.flash_attention_reference(q, k, v, lens, causal, sm)
    exact = _forward_with(torch.matmul, *(t.double() for t in (q, k, v)),
                          lens, causal, sm, T)
    err, err64 = {}, {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("1xtf32", _mm_1xtf32)):
        got = _forward_with(mm, q, k, v, lens, causal, sm, BK)
        err[name] = max(_finite_err(a, b) for a, b in zip(got, want))
        err64[name] = max(_finite_err(a.double(), b)
                          for a, b in zip(got, exact))
        if name == "3xtf32":
            for what, a, b in zip(("o", "lse"), got, want):
                fin = ~torch.isinf(b)
                torch.testing.assert_close(a[fin], b[fin], msg=what,
                                           **CHIP_TOL)
    assert err["1xtf32"] >= 10 * err["3xtf32"], err
    f32_err64 = max(_finite_err(a.double(), b) for a, b in zip(want, exact))
    assert err64["3xtf32"] <= 1.5 * f32_err64, (err64, f32_err64)


def test_fully_masked_row_gives_zero_output_and_infinite_lse():
    """A row with length 0 loads no tile: l stays 0, so o = 0 / 1e-30 = 0
    and lse = +inf, exactly as the plain version."""
    q, k, v = _inputs(2, 2, 40, 64, seed=7)
    lens = torch.tensor([40, 0])
    o, lse = _forward_with(_mm_3xtf32, q, k, v, lens, True,
                           1.0 / math.sqrt(64), BK)
    ro, rlse = tfa.flash_attention_reference(q, k, v, lens, True)
    assert not o[1].any() and not ro[1].any()
    assert torch.isinf(lse[1]).all() and torch.isinf(rlse[1]).all()
    assert torch.isfinite(lse[0]).all()


@pytest.mark.parametrize("D", [64, 128])
def test_tile_width_does_not_move_the_result_beyond_rounding(D):
    """The online softmax over the kernel's tiles gives the one-pass
    softmax's o and lse to f32 rounding: in f64 the two agree to 1e-12."""
    q, k, v = (t.double() for t in _inputs(2, 2, 100, D, seed=D))
    lens = torch.tensor([100, 53])
    sm = 1.0 / math.sqrt(D)
    tiled = _forward_with(torch.matmul, q, k, v, lens, True, sm, BK)
    whole = _forward_with(torch.matmul, q, k, v, lens, True, sm, 100)
    for a, b in zip(tiled, whole):
        assert _finite_err(a, b) <= 1e-12
