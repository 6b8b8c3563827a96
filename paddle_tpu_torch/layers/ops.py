"""Generated thin layer wrappers for elementwise/unary ops.

Counterpart of ``paddle_tpu/layers/ops.py``, cut to the ops the port
registers: every simple X -> Out op gets a layer function of the same
name, every binary op one taking X, Y and ``axis``.
"""
from __future__ import annotations

import sys

from .layer_helper import LayerHelper

_UNARY = ["gelu", "relu", "softmax"]

_BINARY = ["elementwise_add", "elementwise_sub", "elementwise_mul", "equal"]

_module = sys.modules[__name__]


def _make_unary(op_type):
    def layer(x, main_program=None, startup_program=None, **kwargs):
        h = LayerHelper(op_type, main_program=main_program,
                        startup_program=startup_program)
        return h.simple_op(op_type, {"X": [x]}, kwargs)

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
for _op in _BINARY:
    setattr(_module, _op, _make_binary(_op))

__all__ = _UNARY + _BINARY
