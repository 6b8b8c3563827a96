"""The port's ``sequence_pool`` against the JAX package's.

The same numpy inputs go through ``paddle_tpu.ops.sequence_ops`` (its
gradient from ``jax.vjp``) and ``paddle_tpu_torch.ops.sequence_ops`` (from
torch autograd), for each of the six pool types: over ragged lengths with
a zero length (a row that is all padding, which pools to 0, or to its
position 0 under ``first`` and ``last``, as in JAX), without a
``Length`` input, and over trailing feature dims. ``max`` has planted
ties, where the gradient splits evenly among the tied maxima as XLA's
``reduce_max`` splits it (``amax``, not ``max(dim)``, which hands it all
to one index), in f32 and in bf16, where ties are common.

Tolerance: f32 rtol 1e-6 / atol 1e-7 (sums of a few values in another
order); bf16 ``max`` and its gradient are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sequence_ops as jseq
from paddle_tpu_torch.ops import sequence_ops as tseq

torch.set_num_threads(1)
POOLS = ("sum", "average", "sqrt", "max", "last", "first")
TOL = dict(rtol=1e-6, atol=1e-7)
LENGTHS = np.array([6, 3, 0, 1, 4], np.int32)


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(shape[0], *shape[2:]).astype(np.float32)
    return x, g


def _jax(pool, x, lengths, g):
    ins = {"X": [jnp.asarray(x)]}
    if lengths is not None:
        ins["Length"] = [jnp.asarray(lengths)]

    def f(xv):
        return jseq.sequence_pool({"pool_type": pool},
                                  dict(ins, X=[xv]))["Out"][0]

    y, vjp = jax.vjp(f, ins["X"][0])
    dx, = vjp(jnp.asarray(g).astype(y.dtype))
    return y, dx


def _torch(pool, x, lengths, g, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    ins = {"X": [xt]}
    if lengths is not None:
        ins["Length"] = [torch.from_numpy(lengths)]
    y = tseq.sequence_pool({"pool_type": pool}, ins)["Out"][0]
    dx, = torch.autograd.grad(y, xt, torch.from_numpy(g).to(y.dtype))
    return y, dx


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("case", ["ragged", "no_length", "feature_dims"])
def test_sequence_pool_matches_jax(pool, case):
    shape = (5, 6, 2, 3) if case == "feature_dims" else (5, 6, 4)
    x, g = _inputs(shape, seed=POOLS.index(pool))
    lengths = None if case == "no_length" else LENGTHS
    if pool == "max":  # a planted tie in row 0, feature 1
        x[0, 1, 1] = x[0, 4, 1] = 5.0
    jy, jdx = _jax(pool, x, lengths, g)
    ty, tdx = _torch(pool, x, lengths, g)
    assert ty.dtype == torch.float32 and ty.shape == jy.shape
    np.testing.assert_allclose(ty.detach().numpy(), _f32(jy), **TOL)
    np.testing.assert_allclose(tdx.numpy(), _f32(jdx), **TOL)
    if lengths is not None and pool not in ("first", "last"):
        # the all-padding row pools to 0 and takes no gradient ("first"
        # and "last" read position 0 there, in both packages)
        assert not ty[2].any() and not tdx[2].any()
    if pool == "max":
        split = tdx[0, [1, 4], 1].numpy() if case != "feature_dims" else None
        if split is not None:
            np.testing.assert_allclose(split, [g[0, 1] / 2] * 2, rtol=1e-6)


def test_bf16_max_splits_the_gradient_among_ties_as_jax():
    """Values on a coarse grid in bf16: every row of every feature has
    ties, as an AMP LSTM's bf16 hidden states pooled over 100-200 steps
    do. Forward and gradient bitwise equal to JAX's."""
    rng = np.random.RandomState(3)
    x = (rng.randint(-3, 4, size=(5, 9, 6)) / 4).astype(np.float32)
    g = rng.randn(5, 6).astype(np.float32)
    lengths = np.array([9, 4, 0, 1, 7], np.int32)
    jy, jdx = _jax("max", jnp.asarray(x).astype(jnp.bfloat16), lengths, g)
    ty, tdx = _torch("max", x, lengths, g, dtype=torch.bfloat16)
    assert ty.dtype == tdx.dtype == torch.bfloat16
    np.testing.assert_array_equal(ty.detach().float().numpy(), _f32(jy))
    np.testing.assert_array_equal(tdx.float().numpy(), _f32(jdx))
    ties = (tdx != 0).sum(dim=1)
    assert (ties[[0, 1, 4]] > 1).any()  # the planted grid did tie


def test_max_fills_padding_with_the_dtypes_lowest_value():
    """A row whose valid values are all below -1e30 pools to them, not
    to a padding value: the fill is finfo.min, as in JAX."""
    x = np.full((2, 3, 1), -3e38, np.float32)
    x[0, 2, 0] = 0.0  # padding of row 0, larger than every valid value
    lengths = np.array([2, 3], np.int32)
    ty, _ = _torch("max", x, lengths, np.ones((2, 1), np.float32))
    jy, _ = _jax("max", x, lengths, np.ones((2, 1), np.float32))
    np.testing.assert_array_equal(ty.detach().numpy(), _f32(jy))
    assert float(ty.detach()[0, 0]) == np.float32(-3e38)


def test_unknown_pool_type_raises():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="pool_type"):
        tseq.sequence_pool({"pool_type": "median"}, {"X": [x]})
