"""Activation ops. Counterpart of ``paddle_tpu/ops/activation_ops.py``:
every op of the reference's activation zoo.

Each op computes what its JAX twin computes, op by op in X's dtype (bf16
under AMP), with its attrs' constants rounded to that dtype first as JAX's
weak typing rounds them (``common.weak``), and differentiates as JAX does
(``common.unary`` carries the transpose of the JAX primitive's jvp):
``abs`` passes +g at 0, ``leaky_relu`` the whole gradient at 0, and the
clipping ops (``brelu``, ``relu6``, ``hard_sigmoid``) half of it at each
bound, as ``jnp.clip``'s maximum and minimum split a tie. Composite ops
(``swish``, ``stanh``, ``softshrink``, ``log_softmax``) are written step
by step rather than as torch's fused ops, which round once where XLA
rounds at every step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import prng
from ..core.registry import register_op
from . import common as C
from .common import out, single, weak


def _unary(op):
    def fn(attrs, ins):
        return out(Out=op(single(ins, "X")))

    return fn


register_op("relu", _unary(torch.relu))
register_op("sigmoid", _unary(C.sigmoid))
register_op("logsigmoid", _unary(lambda x: -C.softplus(-x)))
register_op("tanh", _unary(C.tanh))
register_op("exp", _unary(C.exp))
register_op("log", _unary(C.log))
register_op("sqrt", _unary(C.sqrt))
register_op("rsqrt", _unary(C.rsqrt))
register_op("abs", _unary(C.abs_))
register_op("ceil", _unary(torch.ceil))
register_op("floor", _unary(torch.floor))
register_op("round", _unary(torch.round))  # half to even, as jnp.round
# jnp.reciprocal is integer_pow(x, -1): its gradient -g / (x * x) as
# g * (-1 * (1 / (x * x)))
register_op("reciprocal", _unary(C.unary(
    torch.reciprocal, lambda g, ans, x: g * -(1 / (x * x)))))
register_op("square", _unary(C.unary(
    lambda x: x * x, lambda g, ans, x: g * (2 * x))))
register_op("softplus", _unary(C.softplus))
# jax.nn.soft_sign: x / (|x| + 1)
register_op("softsign", _unary(lambda x: C.div(x, C.abs_(x) + 1)))
register_op("sin", _unary(C.unary(
    torch.sin, lambda g, ans, x: g * torch.cos(x))))
register_op("cos", _unary(C.unary(
    torch.cos, lambda g, ans, x: -(g * torch.sin(x)))))


@register_op("gelu")
def gelu(attrs, ins):
    """``jax.nn.gelu``'s default, the tanh approximation, in X's dtype
    (bf16 under AMP: the FFN's first product and bias are bf16)."""
    return out(Out=F.gelu(single(ins, "X"), approximate="tanh"))


@register_op("tanh_shrink")
def tanh_shrink(attrs, ins):
    x = single(ins, "X")
    return out(Out=x - C.tanh(x))


@register_op("softshrink")
def softshrink(attrs, ins):
    x = single(ins, "X")
    lam = weak(x, attrs.get("lambda", 0.5))
    return out(Out=torch.where(x > lam, x - lam, torch.where(
        x < -lam, x + lam, x.new_zeros(()))))


@register_op("hard_shrink")
def hard_shrink(attrs, ins):
    x = single(ins, "X")
    t = weak(x, attrs.get("threshold", 0.5))
    return out(Out=torch.where(C.abs_(x) > t, x, x.new_zeros(())))


@register_op("brelu")
def brelu(attrs, ins):
    x = single(ins, "X")
    return out(Out=C.clip(x, attrs.get("t_min", 0.0),
                          attrs.get("t_max", 24.0)))


@register_op("relu6")
def relu6(attrs, ins):
    return out(Out=C.clip(single(ins, "X"), 0.0,
                          attrs.get("threshold", 6.0)))


@register_op("leaky_relu")
def leaky_relu(attrs, ins):
    """``jax.nn.leaky_relu``: x where x >= 0 (so the gradient at 0 is 1),
    else alpha * x."""
    x = single(ins, "X")
    return out(Out=torch.where(x >= 0, x, weak(x, attrs.get("alpha", 0.02))
                               * x))


@register_op("elu")
def elu(attrs, ins):
    """``jax.nn.elu``: x where x > 0, else alpha * expm1(x)."""
    x = single(ins, "X")
    pos = x > 0
    neg = C.expm1(torch.where(pos, x.new_zeros(()), x))
    return out(Out=torch.where(pos, x, weak(x, attrs.get("alpha", 1.0))
                               * neg))


@register_op("pow")
def pow_op(attrs, ins):
    x = single(ins, "X")
    return out(Out=C.pow_(x, x.new_full((), attrs.get("factor", 1.0))))


@register_op("stanh")
def stanh(attrs, ins):
    x = single(ins, "X")
    a = weak(x, attrs.get("scale_a", 2.0 / 3.0))
    b = weak(x, attrs.get("scale_b", 1.7159))
    return out(Out=b * C.tanh(a * x))


@register_op("hard_sigmoid")
def hard_sigmoid(attrs, ins):
    """clip(slope * x + offset, 0, 1). In f32 XLA fuses the product and
    the sum into one multiply-add, rounded once; in bf16 it rounds each."""
    x = single(ins, "X")
    slope, offset = attrs.get("slope", 0.2), attrs.get("offset", 0.5)
    if x.dtype == torch.float32:
        lin = prng.fma(x, prng.f32(slope), prng.f32(offset))
    else:
        lin = weak(x, slope) * x + weak(x, offset)
    return out(Out=C.clip(lin, 0.0, 1.0))


@register_op("thresholded_relu")
def thresholded_relu(attrs, ins):
    x = single(ins, "X")
    t = weak(x, attrs.get("threshold", 1.0))
    return out(Out=torch.where(x > t, x, x.new_zeros(())))


@register_op("swish")
def swish(attrs, ins):
    x = single(ins, "X")
    return out(Out=x * C.sigmoid(weak(x, attrs.get("beta", 1.0)) * x))


@register_op("softmax")
def softmax(attrs, ins):
    return out(Out=torch.softmax(single(ins, "X"), dim=attrs.get("axis", -1)))


@register_op("log_softmax")
def log_softmax(attrs, ins):
    """``jax.nn.log_softmax``: shifted = x - stop_gradient(max), then
    shifted - log(sum(exp(shifted))), exp and sum in f32 for a bf16 x
    as XLA takes ``jnp.sum``'s (``common.sum_f32``)."""
    x = single(ins, "X")
    axis = attrs.get("axis", -1)
    shifted = x - x.amax(dim=axis, keepdim=True).detach()
    total = C.sum_f32(C.exp, shifted, dim=axis, keepdim=True)
    return out(Out=shifted - C.log(total))


@register_op("maxout")
def maxout(attrs, ins):
    """NCHW image form and the 2-D feature form: channels in ``groups``
    consecutive chunks, the elementwise max across each chunk (``amax``
    splits a tie's gradient evenly, as ``jnp.max`` does)."""
    x = single(ins, "X")
    groups = attrs["groups"]
    if x.ndim == 2:
        n, d = x.shape
        return out(Out=x.reshape(n, d // groups, groups).amax(dim=2))
    n, c, h, w = x.shape
    return out(Out=x.reshape(n, c // groups, groups, h, w).amax(dim=2))


@register_op("prelu")
def prelu(attrs, ins):
    """x where x > 0, else alpha * x, in the promoted dtype of the two
    (a bf16 X against an f32 Alpha gives f32, as jnp promotes)."""
    x = single(ins, "X")
    alpha = single(ins, "Alpha")
    dtype = torch.promote_types(x.dtype, alpha.dtype)
    return out(Out=torch.where(x > 0, x.to(dtype), alpha.to(dtype)
                               * x.to(dtype)))
