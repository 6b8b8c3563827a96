"""The port's 32 activation ops against the JAX package's, forward and
gradient, in f32 and bf16.

Each case runs the reference's registered ``fn`` jitted (as its executor
runs it) under ``jax.vjp``, and the port's ``fn`` under
``torch.autograd``, on the same seeded numpy inputs with the op's tie
points mixed in: 0 for every op, each bound of the clipping ops
(``brelu``'s t_min and t_max, ``relu6``'s 0 and threshold,
``hard_sigmoid``'s -2.5 and 2.5), +-lambda and +-threshold of the
shrinks and ``thresholded_relu``, ties inside a ``maxout`` group and
``prelu``'s 0. The cotangent is seeded too.

Tolerance (``ulps`` below): the largest gap over the tensor in units in
the last place of the dtype, each element's ulp taken at its reference
magnitude but at no less than 1/256 of the tensor's largest |value|.
- Exact (0) for the piecewise-linear ops (``abs``, ``ceil``, ``floor``,
  ``round``, ``brelu``, ``relu6``, ``leaky_relu``, ``hard_shrink``,
  ``softshrink``, ``thresholded_relu``, ``hard_sigmoid``, ``maxout``,
  ``prelu``), forward and gradient, in both dtypes: they compare, select
  and take one rounded product, which both packages round alike.
  ``prelu``'s gradient of Alpha is a sum over X, which the two packages
  add in other orders: it is held as the transcendental ops are.
- The transcendental ops: XLA's CPU ``tanh``, ``exp``, ``log``,
  ``log1p``, ``expm1``, ``sin``, ``cos`` and ``rsqrt`` are polynomial
  approximations that differ from torch's by up to 4-5 f32 ulps (``tanh``
  4, ``expm1`` 5, measured on 2 x 10^5 inputs), and XLA contracts f32
  products and sums into fused multiply-adds, which torch does not: at
  most ``F32_ULPS`` f32 ulps, forward and gradient (measured at most 5,
  ``sigmoid``'s and ``swish``'s gradients). In bf16 each op rounds every
  step in bf16 in both packages, and the forwards and gradients agree
  bit for bit here but for the sums: at most ``BF16_ULPS`` bf16 ulps.
- ``sqrt`` and ``rsqrt`` are torch's own roots, whose f32 forwards are
  held tighter (``ROOT_ULPS``): torch's CPU ``sqrt`` is within 1 ulp of
  XLA's correctly rounded one, and its ``rsqrt`` (1 / sqrt, rounded
  twice) within 2 (measured on 2 x 10^5 inputs).
- The ops whose result is a difference of near-equal terms (``MAX``
  below) are held in ulps of the tensor's largest |value| instead, at
  the same limits: the gradient 1 - tanh(x)^2 of ``tanh`` and ``stanh``
  loses all but a few bits of tanh(x) near +-1, so a 2-ulp gap of the
  forward at |x| = 4 is ~1000 ulps of the gradient there; ``elu``'s
  gradient is expm1(x) + 1; ``tanh_shrink`` is x - tanh(x); and
  ``log_softmax``'s gradient g - softmax * sum(g). Autograd also adds a
  gradient's contributions in another association than JAX's transpose
  (JAX adds x's own cotangent to tanh's first term before its second),
  which in bf16 moves such a difference by an ulp of its terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX ops)
import paddle_tpu_torch  # noqa: F401
from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core.registry import get_op as torch_op

torch.set_num_threads(1)
F32_ULPS = 8
BF16_ULPS = 2
SHAPE = (6, 40)
MAX = {"tanh", "stanh", "tanh_shrink", "elu", "log_softmax"}
ROOT_ULPS = {"sqrt": 1, "rsqrt": 2}

# op -> (attrs, domain, exact); domain: "any" or "pos" (x > 0)
CASES = {
    "sigmoid": ({}, "any", False),
    "logsigmoid": ({}, "any", False),
    "tanh": ({}, "any", False),
    "exp": ({}, "any", False),
    "log": ({}, "pos", False),
    "sqrt": ({}, "pos", False),
    "rsqrt": ({}, "pos", False),
    "abs": ({}, "any", True),
    "ceil": ({}, "any", True),
    "floor": ({}, "any", True),
    "round": ({}, "any", True),
    "reciprocal": ({}, "pos", False),
    "square": ({}, "any", False),
    "softplus": ({}, "any", False),
    "softsign": ({}, "any", False),
    "sin": ({}, "any", False),
    "cos": ({}, "any", False),
    "tanh_shrink": ({}, "any", False),
    "softshrink": ({"lambda": 0.5}, "any", True),
    "hard_shrink": ({"threshold": 0.5}, "any", True),
    "brelu": ({"t_min": 0.5, "t_max": 2.0}, "any", True),
    "relu6": ({"threshold": 2.0}, "any", True),
    "leaky_relu": ({}, "any", True),
    "elu": ({"alpha": 1.5}, "any", False),
    "pow": ({"factor": 1.5}, "pos", False),
    "stanh": ({}, "any", False),
    "hard_sigmoid": ({}, "any", True),
    "thresholded_relu": ({"threshold": 1.0}, "any", True),
    "swish": ({"beta": 1.3}, "any", False),
    "log_softmax": ({}, "any", False),
    "maxout": ({"groups": 2}, "any", True),
    "prelu": ({}, "any", True),
}
# the tie points of each op (besides 0, which every input holds)
TIES = {"softshrink": [0.5, -0.5], "hard_shrink": [0.5, -0.5],
        "brelu": [0.5, 2.0], "relu6": [2.0], "hard_sigmoid": [-2.5, 2.5],
        "thresholded_relu": [1.0, -1.0], "ceil": [1.5, -2.5],
        "floor": [1.5, -2.5], "round": [0.5, 1.5, 2.5, -0.5, -1.5]}


def _inputs(op, seed):
    attrs, domain, _ = CASES[op]
    rng = np.random.RandomState(seed)
    x = (rng.randn(*SHAPE) * 2).astype(np.float32)
    if domain == "pos":
        x = np.abs(x) + np.float32(0.05)
    else:
        flat = x.reshape(-1)
        ties = [0.0] + TIES.get(op, [])
        for i, t in enumerate(ties * 4):
            flat[(7 * i + 3) % flat.size] = t
    if op == "maxout":
        x[:, 1::2] = x[:, 0::2]  # every group of two a tie
        x[0, :4] = 0.0
    return x


def _ulps(got, want, dtype, at_max=False):
    """The largest gap in ulps of ``dtype``, each ulp at the reference
    magnitude but at no less than 1/256 of its largest |value| (or at
    its largest |value|, ``at_max``)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    both_nan = np.isnan(got) & np.isnan(want)
    same_inf = np.isinf(want) & (got == want)
    ok = both_nan | same_inf
    mag = np.abs(np.where(ok, 0.0, want))
    floor = mag.max(initial=0.0) / (1.0 if at_max else 256.0)
    mag = np.maximum(mag, floor)
    mant = 23 if dtype == "float32" else 7
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38))) - mant)
    gap = np.where(ok, 0.0, np.abs(got - want))
    return float(np.max(gap / ulp, initial=0.0))


def _to_dtype(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _run(op, dtype, attrs, xs, g):
    """(JAX out, JAX grads, port out, port grads) as f32 numpy."""
    names = sorted(xs)

    def fwd(*arrays):
        return jax_op(op).fn(attrs, {n: [a] for n, a in zip(names, arrays)}
                             )["Out"][0]

    jx = [_to_dtype(xs[n], dtype) for n in names]
    jout, vjp = jax.vjp(jax.jit(fwd), *jx)
    jgrads = vjp(jnp.asarray(g).astype(jout.dtype))
    tdt = getattr(torch, dtype)
    leaves = {n: torch.tensor(xs[n]).to(tdt).requires_grad_(True)
              for n in names}
    tout = torch_op(op).fn(attrs, {n: [leaves[n]] for n in names})["Out"][0]
    assert str(tout.dtype).replace("torch.", "") == str(jout.dtype)
    assert tuple(tout.shape) == tuple(jout.shape)
    tout.backward(torch.tensor(g).to(tout.dtype))
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa
    return (f(jout), [f(a) for a in jgrads], tout.detach().float().numpy(),
            [leaves[n].grad.float().numpy() for n in names])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", sorted(CASES))
def test_activation_op_matches_jax(op, dtype):
    attrs, _, exact = CASES[op]
    x = _inputs(op, seed=sorted(CASES).index(op))
    xs = {"X": x}
    if op == "prelu":
        xs["Alpha"] = np.float32([[0.25]])
    out_shape = (SHAPE[0], SHAPE[1] // 2) if op == "maxout" else SHAPE
    g = np.random.RandomState(99).randn(*out_shape).astype(np.float32)
    jout, jgrads, tout, tgrads = _run(op, dtype, attrs, xs, g)
    limit = F32_ULPS if dtype == "float32" else BF16_ULPS
    if op == "prelu":  # Alpha's gradient, a sum over X
        a = _ulps(tgrads[0], jgrads[0], dtype)
        assert a <= limit, a
        tgrads, jgrads = tgrads[1:], jgrads[1:]
    if exact:
        np.testing.assert_array_equal(tout, jout)
        for t, j in zip(tgrads, jgrads):
            np.testing.assert_array_equal(t, j)
        return
    at_max = op in MAX
    gaps = [_ulps(tout, jout, dtype, at_max)] + [
        _ulps(t, j, dtype, at_max) for t, j in zip(tgrads, jgrads)]
    assert max(gaps) <= limit, gaps
    if dtype == "float32" and op in ROOT_ULPS:
        assert gaps[0] <= ROOT_ULPS[op], gaps
