"""paddle_tpu_torch.kernels.flash_attention against the JAX package.

The port's plain version of the flash kernel (``flash_attention_reference``)
is held against the Pallas kernel itself, run in interpret mode on the
CPU (``_flash_forward(..., interpret=True)``), in both outputs (o and the
logsumexp the backward needs), and against ``reference_attention``;
``reference_attention`` and ``rotary`` are held against their JAX twins.
Inputs come from a numpy seed; f32 throughout, atol = rtol = 1e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(B, H, Tq, Tk, D, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, Tq, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32),
            rng.randn(B, H, Tk, D).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# (B, H, Tq, Tk, D, causal, lengths, block_q, block_k)
CASES = {
    "causal_square": (2, 2, 32, 32, 8, True, None, 16, 8),
    "full_square": (2, 2, 32, 32, 8, False, None, 8, 16),
    "causal_lengths_fully_masked_row": (3, 2, 32, 32, 8, True, [25, 0, 32],
                                        16, 8),
    "full_lengths": (2, 3, 16, 16, 16, False, [16, 7], 8, 8),
    "causal_tq_ne_tk": (2, 2, 16, 48, 8, True, [40, 48], 8, 16),
    "full_tq_ne_tk": (1, 2, 24, 40, 8, False, None, 8, 8),
    "ragged_t100": (1, 2, 100, 100, 16, True, [100], 512, 512),
    "ragged_t100_lengths": (2, 1, 100, 100, 8, False, [63, 100], 512, 512),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_kernel_interpret(case):
    B, H, Tq, Tk, D, causal, lengths, bq, bk = CASES[case]
    q, k, v = _qkv(B, H, Tq, Tk, D, seed=len(case))
    sm = 1.0 / math.sqrt(D)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    jo, jlse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if lens is None else jnp.asarray(lens), causal, sm,
        block_q=bq, block_k=bk, interpret=True)
    to, tlse = tfa.flash_attention_reference(
        *_t(q, k, v), None if lens is None else torch.from_numpy(lens),
        causal=causal, sm_scale=sm)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    jlse = np.asarray(jlse).reshape(B, H, Tq)
    # fully masked rows: lse = +inf in both; finite elsewhere and equal
    np.testing.assert_array_equal(np.isinf(tlse.numpy()), np.isinf(jlse))
    np.testing.assert_allclose(tlse.numpy(), jlse, **TOL)
    if lens is not None and (lens == 0).any():
        assert np.all(to.numpy()[lens == 0] == 0.0)


@pytest.mark.parametrize("case", ["causal_square", "full_lengths",
                                  "causal_tq_ne_tk", "ragged_t100_lengths"])
def test_reference_matches_reference_attention(case):
    B, H, Tq, Tk, D, causal, lengths, _, _ = CASES[case]
    q, k, v = _t(*_qkv(B, H, Tq, Tk, D, seed=3))
    lens = None if lengths is None else torch.tensor(lengths)
    o, _ = tfa.flash_attention_reference(q, k, v, lens, causal=causal)
    ref = tfa.reference_attention(q, k, v, lens, causal=causal)
    np.testing.assert_allclose(o.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("hkv,q_pos0", [(4, 0), (2, 0), (1, 5),
                                        (2, "per_row")])
def test_reference_attention_matches_jax(hkv, q_pos0):
    """GQA groups, scalar and per-row query offsets, K lengths."""
    rng = np.random.RandomState(11)
    B, H, Tq, Tk, D = 3, 4, 6, 20, 8
    q = rng.randn(B, H, Tq, D).astype(np.float32)
    k = rng.randn(B, hkv, Tk, D).astype(np.float32)
    v = rng.randn(B, hkv, Tk, D).astype(np.float32)
    lengths = np.array([20, 9, 14], np.int32)
    if q_pos0 == "per_row":
        q_pos0 = np.array([0, 3, 14], np.int32)
        tp0, jp0 = torch.from_numpy(q_pos0), jnp.asarray(q_pos0)
    else:
        tp0 = jp0 = q_pos0
    want = jfa.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lengths),
                                   causal=True, q_pos0=jp0)
    got = tfa.reference_attention(*_t(q, k, v), torch.from_numpy(lengths),
                                  causal=True, q_pos0=tp0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos0", [0, 7, "per_row"])
def test_rotary_matches_jax(pos0):
    x = np.random.RandomState(5).randn(3, 2, 5, 8).astype(np.float32)
    if pos0 == "per_row":
        pos0 = np.array([0, 4, 11], np.int32)
        tp, jp = torch.from_numpy(pos0), jnp.asarray(pos0)
    else:
        tp = jp = pos0
    want = jfa.rotary(jnp.asarray(x), jp)
    got = tfa.rotary(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _bad_launch_inputs(case):
    q, k, v = _t(*_qkv(1, 2, 8, 8, 64, seed=9))
    if case == "head_dim":
        return (q[..., :32], k[..., :32], v[..., :32]), ValueError
    if case == "dtype":
        return (q.double(), k.double(), v.double()), TypeError
    return (q, k[:, :1], v[:, :1]), ValueError  # "gqa_not_expanded"


@pytest.mark.parametrize("case", ["head_dim", "dtype", "gqa_not_expanded"])
def test_kernel_launch_refuses_what_the_kernel_does_not_take(case):
    """The CUDA launch path validates before it builds or binds anything,
    so these checks run on the CPU too."""
    (q, k, v), exc = _bad_launch_inputs(case)
    with pytest.raises(exc):
        tfa._launch(q, k, v, None, True, 0.125)
    assert tfa.flash_attention.launches == 0


def test_wrapper_on_cpu_runs_the_plain_version_without_launching():
    q, k, v = _t(*_qkv(2, 2, 32, 32, 64, seed=8))
    lens = torch.tensor([32, 17])
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, lens, causal=True)
    o, _ = tfa.flash_attention_reference(q, k, v, lens, causal=True)
    assert torch.equal(got, o)
    assert tfa.flash_attention.launches == before == 0
