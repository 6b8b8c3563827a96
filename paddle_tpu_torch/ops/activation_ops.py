"""Activation ops. Counterpart of ``paddle_tpu/ops/activation_ops.py``,
cut to ``relu``, the activation ResNet builds, ``gelu``, the per-layer
transformer's FFN activation, and ``softmax``, which primitive attention
programs build. Their gradients are the generic vjp (relu's zero at 0,
as ``jax.nn.relu``'s)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import out, single


def _unary(op):
    def fn(attrs, ins):
        return out(Out=op(single(ins, "X")))

    return fn


register_op("relu", _unary(torch.relu))


@register_op("gelu")
def gelu(attrs, ins):
    """``jax.nn.gelu``'s default, the tanh approximation, in X's dtype
    (bf16 under AMP: the FFN's first product and bias are bf16)."""
    return out(Out=F.gelu(single(ins, "X"), approximate="tanh"))


@register_op("softmax")
def softmax(attrs, ins):
    return out(Out=torch.softmax(single(ins, "X"), dim=attrs.get("axis", -1)))
