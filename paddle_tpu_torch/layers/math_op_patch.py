"""Arithmetic operators on build-time Variables.

Counterpart of ``paddle_tpu/layers/math_op_patch.py``: ``pred - label``
builds ops. A scalar operand lowers to one ``scale`` op, a Variable
operand to the matching ``elementwise_*`` op. Only arithmetic is
patched: comparisons stay Python's, so Variables stay hashable and
usable as dict keys (``layers.equal``/``less_than`` build the graph's
predicates).
"""
from __future__ import annotations

import numbers

from ..core.program import Variable


def _scale(x, k=1.0, b=0.0):
    from .tensor import scale

    return scale(x, scale=float(k), bias=float(b))


def _elementwise(op_name, x, y):
    from . import ops

    return getattr(ops, op_name)(x, y)


def _add(self, other):
    if isinstance(other, numbers.Number):
        return _scale(self, 1.0, other)
    return _elementwise("elementwise_add", self, other)


def _sub(self, other):
    if isinstance(other, numbers.Number):
        return _scale(self, 1.0, -other)
    return _elementwise("elementwise_sub", self, other)


def _rsub(self, other):
    if isinstance(other, numbers.Number):
        return _scale(self, -1.0, other)
    return _elementwise("elementwise_sub", other, self)


def _mul(self, other):
    if isinstance(other, numbers.Number):
        return _scale(self, other)
    return _elementwise("elementwise_mul", self, other)


def _truediv(self, other):
    if isinstance(other, numbers.Number):
        return _scale(self, 1.0 / other)
    return _elementwise("elementwise_div", self, other)


def _rtruediv(self, other):
    if isinstance(other, numbers.Number):
        from . import ops

        return _scale(ops.reciprocal(self), other)
    return _elementwise("elementwise_div", other, self)


def _neg(self):
    return _scale(self, -1.0)


def monkey_patch_variable():
    Variable.__add__ = _add
    Variable.__radd__ = _add
    Variable.__sub__ = _sub
    Variable.__rsub__ = _rsub
    Variable.__mul__ = _mul
    Variable.__rmul__ = _mul
    Variable.__truediv__ = _truediv
    Variable.__rtruediv__ = _rtruediv
    Variable.__neg__ = _neg


monkey_patch_variable()
