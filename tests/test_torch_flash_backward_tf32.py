"""The arithmetic of the port's flash-attention backward CUDA kernels,
emulated on the CPU.

The dq and dkv kernels run every product on the tensor cores as 3xTF32:
each f32 operand splits into a tf32 hi (x rounded to nearest, ties away,
as cvt.rna.tf32.f32 does) and lo = x - hi (read truncated to tf32), and
each product sums lo.hi + hi.lo + hi.hi in f32. Emulated here through the
int32 view, the 3xTF32 backward lies within chip_smoke.py's 5e-5 of the
plain f32 version (``flash_dq_reference``/``flash_dkv_reference``, which
tests/test_torch_flash_backward.py holds against the Pallas kernels) and
about as close to f64 as f32 is, while 1xTF32 errs at least 10x more:
why the split is needed, and what error the kernels should show. Inputs
come from a numpy seed.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)


def _inputs(B, H, Tq, Tk, D, seed):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 for shape in ((B, H, Tq, D), (B, H, Tk, D), (B, H, Tk, D),
                               (B, H, Tq, D)))


CHIP_TOL = dict(atol=5e-5, rtol=5e-5)  # chip_smoke.py's ATOL = RTOL


def _tf32_rna(x):
    """cvt.rna.tf32.f32: x rounded to the nearest tf32 (10 mantissa bits),
    ties away from zero, through the int32 view (finite x)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor cores read of an f32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    """The kernels' split: hi = rna(x), lo = x - hi, read truncated."""
    hi = _tf32_rna(x)
    return hi, _tf32_trunc(x - hi)


def _mm_3xtf32(a, b):
    """a @ b as the kernels do it: lo.hi + hi.lo + hi.hi, each product of
    tf32 values exact in f32, summed in f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32_rna(a) @ _tf32_rna(b)


def _backward_with(mm, q, k, v, lse, di, do, lengths, causal, sm_scale):
    """(dq, dk, dv) of flash_dq_reference/flash_dkv_reference with every
    product taken by ``mm``."""
    mask = tfa._mask(q.shape[2], k.shape[2], lengths, causal, q.device)
    s = mm(q, k.transpose(-1, -2)) * sm_scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros(()))
    ds = p * (mm(do, v.transpose(-1, -2)) - di[..., None])
    return (mm(ds, k) * sm_scale, mm(ds.transpose(-1, -2), q) * sm_scale,
            mm(p.transpose(-1, -2), do))


def test_tf32_rounding_emulation():
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -12, 1 + 2 ** -10 + 2 ** -11])
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10,
                         1 + 2 ** -9])  # ties go away from zero
    assert torch.equal(_tf32_rna(x), want)
    r = np.random.RandomState(3).randn(4096).astype(np.float32) * 100
    x = torch.from_numpy(r)
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi + (x - hi), x)  # x - hi is exact in f32
    # hi + lo recovers x to 2^-21 of |x|
    assert ((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all()


@pytest.mark.parametrize("D", [64, 128])
def test_3xtf32_backward_keeps_f32_accuracy_where_1xtf32_does_not(D):
    """Against the plain f32 version: within chip_smoke.py's 5e-5, and
    1xTF32 errs at least 10x more. Against f64: about as far as f32 is
    (1.5x allowed: the two sum in different orders)."""
    B, H, T, causal, lengths = 2, 2, 100, True, [100, 61]
    q, k, v, g = _inputs(B, H, T, T, D, seed=D)
    lens = torch.tensor(lengths)
    sm = 1.0 / math.sqrt(D)
    o, lse = tfa.flash_attention_reference(q, k, v, lens, causal)
    di = (g * o).sum(-1)
    want = (tfa.flash_dq_reference(q, k, v, lse, di, g, lens, causal),
            *tfa.flash_dkv_reference(q, k, v, lse, di, g, lens, causal))
    exact = _backward_with(torch.matmul, *(t.double() for t in (
        q, k, v, lse, di, g)), lens, causal, sm)
    err, err64 = {}, {}
    for name, mm in (("3xtf32", _mm_3xtf32), ("1xtf32", _mm_1xtf32)):
        got = _backward_with(mm, q, k, v, lse, di, g, lens, causal, sm)
        err[name] = max(float((a - b).abs().max()) for a, b in zip(got, want))
        err64[name] = max(float((a - b).abs().max())
                          for a, b in zip(got, exact))
        if name == "3xtf32":
            for grad, a, b in zip(("dq", "dk", "dv"), got, want):
                torch.testing.assert_close(a, b, msg=grad, **CHIP_TOL)
    assert err["1xtf32"] >= 10 * err["3xtf32"], err
    f32_err64 = max(float((a - b).abs().max()) for a, b in zip(want, exact))
    assert err64["3xtf32"] <= 1.5 * f32_err64, (err64, f32_err64)
