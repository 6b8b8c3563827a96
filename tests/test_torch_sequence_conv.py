"""The port's ``sequence_conv`` and ``context_project`` against the JAX
package's.

The same numpy inputs ([b 4, T 6, d 3], ragged lengths 6, 3, 0 and 1:
a full row, a short one, an empty one and a one-step one) go through
``paddle_tpu.ops.sequence_ops`` (gradients by ``jax.vjp``) and
``paddle_tpu_torch.ops.sequence_ops`` (torch autograd), at context
starts -2, -1 and 0 with context length 3 and 5, with and without
``Length``; ``sequence_conv`` also with a ``PaddingData`` input, which
both ignore. The forward and the X and Filter gradients under a random
cotangent agree at rtol 1e-5 / atol 1e-6 (the [b*T, k*d] x [k*d, out]
product summed in another order); ``context_project`` has no product
and is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sequence_ops as jseq
from paddle_tpu_torch.ops import sequence_ops as tseq

torch.set_num_threads(1)
B, T, D, OUT = 4, 6, 3, 4
LENGTHS = np.array([6, 3, 0, 1], np.int32)
TOL = dict(rtol=1e-5, atol=1e-6)
CASES = [(3, -1), (3, 0), (3, -2), (5, -2), (5, 0)]


def _inputs(k, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, D).astype(np.float32)
    f = rng.randn(k * D, OUT).astype(np.float32)
    return x, f


@pytest.mark.parametrize("with_length", [True, False])
@pytest.mark.parametrize("k,start", CASES)
def test_sequence_conv_forward_and_grads(k, start, with_length):
    x, f = _inputs(k)
    attrs = {"contextLength": k, "contextStart": start, "contextStride": 1}
    g = np.random.RandomState(1).randn(B, T, OUT).astype(np.float32)
    lens = {"Length": [LENGTHS]} if with_length else {}

    def jf(xv, fv):
        ins = {"X": [xv], "Filter": [fv],
               **{s: [jnp.asarray(v[0])] for s, v in lens.items()}}
        return jseq.sequence_conv(attrs, ins)["Out"][0]

    jy, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(f))
    jdx, jdf = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_(True)
    tf = torch.from_numpy(f).requires_grad_(True)
    ty = tseq.sequence_conv(attrs, {
        "X": [tx], "Filter": [tf],
        **{s: [torch.from_numpy(v[0])] for s, v in lens.items()}})["Out"][0]
    tdx, tdf = torch.autograd.grad(ty, (tx, tf), torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tdf.numpy(), np.asarray(jdf), **TOL)
    if with_length:
        assert not ty[2].any() and not ty[3, 1:].any()


def test_padding_data_is_ignored():
    x, f = _inputs(3, seed=2)
    pad = np.full((2, D), 7.0, np.float32)
    attrs = {"contextLength": 3, "contextStart": -1}
    want = np.asarray(jseq.sequence_conv(attrs, {
        "X": [jnp.asarray(x)], "Filter": [jnp.asarray(f)],
        "Length": [jnp.asarray(LENGTHS)],
        "PaddingData": [jnp.asarray(pad)]})["Out"][0])
    got = tseq.sequence_conv(attrs, {
        "X": [torch.from_numpy(x)], "Filter": [torch.from_numpy(f)],
        "Length": [torch.from_numpy(LENGTHS)],
        "PaddingData": [torch.from_numpy(pad)]})["Out"][0]
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = tseq.sequence_conv(attrs, {
        "X": [torch.from_numpy(x)], "Filter": [torch.from_numpy(f)],
        "Length": [torch.from_numpy(LENGTHS)]})["Out"][0]
    assert torch.equal(got, plain)


@pytest.mark.parametrize("with_length", [True, False])
@pytest.mark.parametrize("k,start", CASES)
def test_context_project(k, start, with_length):
    x, _ = _inputs(k, seed=3)
    attrs = {"context_length": k, "context_start": start}
    g = np.random.RandomState(4).randn(B, T, k * D).astype(np.float32)
    lens = {"Length": [LENGTHS]} if with_length else {}

    def jf(xv):
        ins = {"X": [xv], **{s: [jnp.asarray(v[0])] for s, v in lens.items()}}
        return jseq.context_project(attrs, ins)["Out"][0]

    jy, vjp = jax.vjp(jf, jnp.asarray(x))
    jdx, = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tseq.context_project(attrs, {
        "X": [tx], **{s: [torch.from_numpy(v[0])]
                      for s, v in lens.items()}})["Out"][0]
    tdx, = torch.autograd.grad(ty, tx, torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tdx.numpy(), np.asarray(jdx))
