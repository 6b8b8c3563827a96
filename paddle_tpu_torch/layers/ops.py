"""Generated thin layer wrappers for elementwise/unary ops.

Counterpart of ``paddle_tpu/layers/ops.py``, with its lists: every
simple X -> Out op gets a layer function of the same name (those with
attrs keep only their own attrs' keywords), every binary op one taking
X, Y and ``axis``.
"""
from __future__ import annotations

import sys

from .layer_helper import LayerHelper

_UNARY = [
    "relu", "sigmoid", "logsigmoid", "tanh", "exp", "log", "sqrt", "rsqrt",
    "abs", "ceil", "floor", "round", "reciprocal", "square", "softplus",
    "softsign", "gelu", "sin", "cos", "tanh_shrink", "softmax", "log_softmax",
]

_UNARY_ATTRS = {
    "softshrink": ("lambda",),
    "hard_shrink": ("threshold",),
    "brelu": ("t_min", "t_max"),
    "relu6": ("threshold",),
    "leaky_relu": ("alpha",),
    "elu": ("alpha",),
    "pow": ("factor",),
    "stanh": ("scale_a", "scale_b"),
    "hard_sigmoid": ("slope", "offset"),
    "thresholded_relu": ("threshold",),
    "swish": ("beta",),
}

_BINARY = [
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow",
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_xor",
]

_module = sys.modules[__name__]


def _make_unary(op_type, attr_names=()):
    def layer(x, main_program=None, startup_program=None, **kwargs):
        h = LayerHelper(op_type, main_program=main_program,
                        startup_program=startup_program)
        attrs = {k: v for k, v in kwargs.items()
                 if k in attr_names or not attr_names}
        return h.simple_op(op_type, {"X": [x]}, attrs)

    layer.__name__ = op_type
    return layer


def _make_binary(op_type):
    def layer(x, y, axis=-1, main_program=None, startup_program=None):
        h = LayerHelper(op_type, main_program=main_program,
                        startup_program=startup_program)
        return h.simple_op(op_type, {"X": [x], "Y": [y]}, {"axis": axis})

    layer.__name__ = op_type
    return layer


for _op in _UNARY:
    setattr(_module, _op, _make_unary(_op))
for _op, _attrs in _UNARY_ATTRS.items():
    setattr(_module, _op, _make_unary(_op, _attrs))
for _op in _BINARY:
    setattr(_module, _op, _make_binary(_op))

__all__ = _UNARY + list(_UNARY_ATTRS) + _BINARY
