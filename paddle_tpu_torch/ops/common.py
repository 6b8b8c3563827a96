"""Shared helpers for the port's op functions.

Counterpart of ``paddle_tpu/ops/common.py``, cut to what the serving
and training paths use. An op takes ``ins``, a dict of slot name -> [tensor], and
returns the same shape of dict, so it is called exactly like its JAX
twin.

Precision: the JAX package's default (``--use_amp`` off, default MXU
precision) is f32 compute, and so is the port's. Matrix products run in
full f32: PyTorch leaves ``torch.backends.cuda.matmul.allow_tf32`` off
unless a caller turns it on. Convolutions would not: PyTorch runs f32
convolutions through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), so ``conv2d``
(``ops/nn_ops.py``) turns it off around its forward and its backward
(``full_f32_convolutions``), whatever the caller has set. bf16 serving
is a later slice.
"""
from __future__ import annotations

import contextlib
import numbers

import torch


@contextlib.contextmanager
def full_f32_convolutions():
    """cuDNN with TF32 off inside the block, the caller's setting after
    it."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def normalize_pair(v):
    """int -> [v, v]; a sequence passes through as a list of ints."""
    if isinstance(v, numbers.Integral):
        return [int(v)] * 2
    return [int(x) for x in v]


def single(ins, slot):
    """The single tensor bound to ``slot`` (KeyError if absent)."""
    return ins[slot][0]


def maybe(ins, slot):
    vals = ins.get(slot)
    return vals[0] if vals else None


def out(**kw):
    """Build an output dict: out(Out=x) -> {"Out": [x]}; lists pass
    through."""
    return {k: (v if isinstance(v, list) else [v]) for k, v in kw.items()}


def broadcast_to_x(x, y, axis: int = -1):
    """Reference elementwise broadcast semantics (elementwise_op.h):
    ``y``'s shape must match a contiguous run of ``x``'s dims starting at
    ``axis`` (axis=-1 means trailing-aligned, i.e. standard numpy rules).
    Returns y reshaped so broadcasting against x is valid."""
    if x.ndim == y.ndim or y.ndim == 0:
        return y
    if axis == -1:
        axis = x.ndim - y.ndim
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (x.ndim - axis - y.ndim)
    return y.reshape(new_shape)
