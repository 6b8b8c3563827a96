"""The image zoo's new ops against the JAX package's: ``concat``, ``lrn``
and ``depthwise_conv2d``, each run through both registries on the same
numpy inputs from a seed, forward and gradient (JAX's ``jax.vjp`` of its
jitted op, the port's autograd).

- ``concat``: along every axis of a 4-D input, negative axes too, and
  over a bf16/f32 mix, which promotes to f32 as ``jnp.concatenate``
  does; outputs and gradients bit for bit (a concat and its slices
  round nothing).
- ``lrn``: NHWC and NCHW, the default window (5) and an even one (4). In
  f32, XLA's ``pow`` and its contraction of k + alpha * acc round
  differently from torch's (measured on the CPU: ~35% of Out differs in
  the last bits, at most 9.5e-7 absolute), so Out and MidOut are held at
  rtol ``LRN_RTOL`` (about 4 f32 ulps) and the gradient at rtol
  ``LRN_GRAD_RTOL`` with an atol of 1e-6 of its largest |value|. In bf16
  the forward equals XLA's bit for bit; autograd's gradient differs from
  JAX's vjp on 0.4-0.6% of its elements, each by at most one bf16 ulp of
  its magnitude, the magnitude taken at no less than 1/256 of the
  gradient's largest |value| (``chip_smoke.py``'s rule): 33 of the 67,600
  elements of the NHWC case are sums that nearly cancel, 64 ulps of
  their own magnitude apart but 1/4000 of an ulp of the largest.
- ``depthwise_conv2d``: ``conv2d`` with one group a channel, NHWC and
  NCHW, strides 1 and 2; outputs and gradients at rtol 1e-5 / atol 1e-6
  of the largest |value|, and equal to the port's own grouped ``conv2d``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.registry import get_op as jax_op
from paddle_tpu_torch.core.registry import get_op as torch_op

torch.set_num_threads(1)
LRN_RTOL = 2e-6
LRN_GRAD_RTOL = 1e-5
CONV_RTOL, CONV_ATOL = 1e-5, 1e-6


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run_jax(op, attrs, ins, slot, grad):
    """The JAX op's output ``slot`` (jitted, as the executor runs it) and
    the vjp of ``grad`` on it for every input of ``ins``."""
    names = sorted(ins)

    def fwd(*arrays):
        split, i = {}, 0
        for n in names:
            split[n] = list(arrays[i:i + len(ins[n])])
            i += len(ins[n])
        return jax_op(op).fn(attrs, split)[slot][0]

    flat = [jnp.asarray(a) for n in names for a in ins[n]]
    out, vjp = jax.vjp(jax.jit(fwd), *flat)
    return out, vjp(jnp.asarray(grad).astype(out.dtype))


def _run_torch(op, attrs, ins, slot, grad):
    names = sorted(ins)
    leaves = {n: [torch.tensor(np.asarray(a)).requires_grad_(True)
                  for a in ins[n]] for n in names}
    out = torch_op(op).fn(attrs, leaves)[slot][0]
    out.backward(torch.tensor(np.asarray(grad)).to(out.dtype))
    return out.detach(), [t.grad for n in names for t in leaves[n]]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


# --- concat -------------------------------------------------------------------
@pytest.mark.parametrize("axis", [0, 1, 2, 3, -1, -3])
def test_concat_along_each_axis_equals_jax(axis):
    shapes = []
    for i, extra in enumerate((1, 3, 2)):
        shape = [2, 3, 4, 5]
        shape[axis] = extra
        shapes.append(tuple(shape))
    xs = [_rand(*s, seed=i) for i, s in enumerate(shapes)]
    out_shape = list(shapes[0])
    out_shape[axis] = 6
    g = _rand(*out_shape, seed=9)
    attrs = {"axis": axis}
    jo, jg = _run_jax("concat", attrs, {"X": xs}, "Out", g)
    to, tg = _run_torch("concat", attrs, {"X": xs}, "Out", g)
    assert tuple(to.shape) == tuple(out_shape)
    np.testing.assert_array_equal(_np(to), _np(jo))
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_concat_of_bf16_and_f32_promotes_as_jax():
    xs = [_bf16(_rand(2, 3, 4)), _rand(2, 5, 4, seed=1),
          _bf16(_rand(2, 1, 4, seed=2))]
    g = _rand(2, 9, 4, seed=3)
    attrs = {"axis": 1}
    jo, jg = _run_jax("concat", attrs, {"X": xs}, "Out", g)
    tins = {"X": [torch.tensor(_np(x)).to(torch.bfloat16) if i != 1 else
                  torch.tensor(np.asarray(x)) for i, x in enumerate(xs)]}
    to = torch_op("concat").fn(attrs, tins)["Out"][0]
    assert str(jo.dtype) == "float32" and to.dtype == torch.float32
    np.testing.assert_array_equal(_np(to), _np(jo))
    # the gradient reaches each input in its own dtype
    leaves = [t.clone().requires_grad_(True) for t in tins["X"]]
    torch_op("concat").fn(attrs, {"X": leaves})["Out"][0].backward(
        torch.tensor(g))
    for leaf, want in zip(leaves, jg):
        assert str(leaf.grad.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_array_equal(_np(leaf.grad), _np(want))


# --- lrn ----------------------------------------------------------------------
LRN_CASES = [("NHWC", 5, (4, 13, 13, 96)), ("NCHW", 5, (2, 24, 7, 6)),
             ("NHWC", 4, (2, 5, 5, 17))]
LRN_IDS = ["nhwc", "nchw", "nhwc_n4"]


def _lrn_inputs(shape, fmt, n):
    x = _rand(*shape, seed=4) * 3.0
    g = _rand(*shape, seed=5)
    return x, g, {"n": n, "k": 2.0, "alpha": 1e-4, "beta": 0.75,
                  "data_format": fmt}


@pytest.mark.parametrize("fmt,n,shape", LRN_CASES, ids=LRN_IDS)
def test_lrn_f32_equals_jax(fmt, n, shape):
    x, g, attrs = _lrn_inputs(shape, fmt, n)
    jmid = jax.jit(lambda a: jax_op("lrn").fn(attrs, {"X": [a]})["MidOut"][0])(
        jnp.asarray(x))
    jo, (jg,) = _run_jax("lrn", attrs, {"X": [x]}, "Out", g)
    outs = torch_op("lrn").fn(attrs, {"X": [torch.tensor(x)]})
    to, (tg,) = _run_torch("lrn", attrs, {"X": [x]}, "Out", g)
    assert outs["Out"][0].dtype == outs["MidOut"][0].dtype == torch.float32
    np.testing.assert_allclose(_np(outs["MidOut"][0]), _np(jmid),
                               rtol=LRN_RTOL, atol=0)
    np.testing.assert_allclose(_np(to), _np(jo), rtol=LRN_RTOL, atol=0)
    want = _np(jg)
    np.testing.assert_allclose(_np(tg), want, rtol=LRN_GRAD_RTOL,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("fmt,n,shape", LRN_CASES, ids=LRN_IDS)
def test_lrn_bf16_equals_jax(fmt, n, shape):
    x, g, attrs = _lrn_inputs(shape, fmt, n)
    xb = _bf16(x)
    jo, (jg,) = _run_jax("lrn", attrs, {"X": [xb]}, "Out", g)
    jmid = jax.jit(lambda a: jax_op("lrn").fn(attrs, {"X": [a]})["MidOut"][0])(
        xb)
    xt = torch.tensor(_np(xb)).to(torch.bfloat16).requires_grad_(True)
    outs = torch_op("lrn").fn(attrs, {"X": [xt]})
    outs["Out"][0].backward(torch.tensor(g).to(torch.bfloat16))
    assert outs["Out"][0].dtype == outs["MidOut"][0].dtype == torch.bfloat16
    assert str(jo.dtype) == "bfloat16"
    np.testing.assert_array_equal(_np(outs["Out"][0].detach()), _np(jo))
    np.testing.assert_array_equal(_np(outs["MidOut"][0].detach()),
                                  _np(jmid))
    got, want = _np(xt.grad), _np(jg)
    mag = np.maximum(np.abs(got), np.abs(want))
    mag = np.maximum(mag, np.abs(want).max() / 2 ** 8)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(got - want) <= ulp).all()
    assert (got != want).mean() < 0.01


# --- depthwise_conv2d ---------------------------------------------------------
@pytest.mark.parametrize("fmt,stride", [("NHWC", 1), ("NHWC", 2),
                                        ("NCHW", 1), ("NCHW", 2)])
def test_depthwise_conv2d_equals_jax(fmt, stride):
    C = 6
    if fmt == "NHWC":
        x, w = _rand(2, 9, 9, C), _rand(3, 3, 1, C, seed=1)
    else:
        x, w = _rand(2, C, 9, 9), _rand(C, 1, 3, 3, seed=1)
    attrs = {"strides": stride, "paddings": 1, "dilations": 1,
             "data_format": fmt}
    hw = 9 if stride == 1 else 5
    g = _rand(*((2, hw, hw, C) if fmt == "NHWC" else (2, C, hw, hw)), seed=2)
    ins = {"Input": [x], "Filter": [w]}
    jo, jg = _run_jax("depthwise_conv2d", attrs, ins, "Output", g)
    to, tg = _run_torch("depthwise_conv2d", attrs, ins, "Output", g)
    for got, want in zip([to] + tg, [jo] + list(jg)):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, rtol=CONV_RTOL,
                                   atol=CONV_ATOL * np.abs(want).max())
    grouped = torch_op("conv2d").fn(
        dict(attrs, groups=C),
        {"Input": [torch.tensor(x)], "Filter": [torch.tensor(w)]})
    assert torch.equal(grouped["Output"][0], to)
