"""Activation ops. Counterpart of ``paddle_tpu/ops/activation_ops.py``,
cut to ``relu``, the activation ResNet builds, and ``softmax``, which
primitive attention programs build. Their gradients are the generic vjp
(relu's zero at 0, as ``jax.nn.relu``'s)."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import out, single


def _unary(op):
    def fn(attrs, ins):
        return out(Out=op(single(ins, "X")))

    return fn


register_op("relu", _unary(torch.relu))


@register_op("softmax")
def softmax(attrs, ins):
    return out(Out=torch.softmax(single(ins, "X"), dim=attrs.get("axis", -1)))
