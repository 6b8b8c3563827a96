"""Shared helpers for the port's op functions.

Counterpart of ``paddle_tpu/ops/common.py``, cut to what the serving
and training paths use. An op takes ``ins``, a dict of slot name -> [tensor], and
returns the same shape of dict, so it is called exactly like its JAX
twin.

Precision: with ``--use_amp`` off (the default) every op computes in f32.
Matrix products run in full f32: PyTorch leaves
``torch.backends.cuda.matmul.allow_tf32`` off unless a caller turns it
on. Convolutions would not: PyTorch runs f32 convolutions through cuDNN
in TF32 by default (``torch.backends.cudnn.allow_tf32`` is True), so
``conv2d`` (``ops/nn_ops.py``) turns it off around its forward and its
backward (``full_f32_convolutions``), whatever the caller has set.

Mixed precision (AMP), the JAX package's policy: bf16 operands for the
products, f32 master weights. With AMP on (``set_amp(True)``, or
``--use_amp`` while ``set_amp`` has not been called), each product casts
its f32 operands to bf16 (``amp_cast``) and returns bf16; the sums inside
it stay f32 (``matmul``). Parameters stay f32 in the scope, and their
gradients come back f32 through the casts. The norms and the loss reduce
in f32.
"""
from __future__ import annotations

import contextlib
import numbers

import torch


# Tri-state: _UNSET defers to --use_amp (flags.py), so a flag flip takes
# effect; an explicit set_amp() wins over the flag.
_UNSET = object()
_AMP = _UNSET


def set_amp(enabled: bool):
    global _AMP
    _AMP = bool(enabled)


def amp_enabled() -> bool:
    if _AMP is _UNSET:
        from ..flags import FLAGS

        return FLAGS.use_amp
    return _AMP


def amp_cast(*tensors):
    """Under AMP, cast f32 tensors to bf16 (others pass through)."""
    if not amp_enabled():
        return tensors if len(tensors) > 1 else tensors[0]
    cast = tuple(t.to(torch.bfloat16) if t.dtype == torch.float32 else t
                 for t in tensors)
    return cast if len(cast) > 1 else cast[0]


@contextlib.contextmanager
def f32_accumulation():
    """cuBLAS with its bf16 reduced-precision reductions off inside the
    block, the caller's setting after it. PyTorch allows them by default
    (``allow_bf16_reduced_precision_reduction``): a split-K product then
    adds its partial sums in bf16, where XLA's bf16 products accumulate
    in f32."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev


class _Bf16Matmul(torch.autograd.Function):
    """``torch.matmul`` of 16-bit operands whose forward and backward both
    run under ``f32_accumulation``: the generic grad op differentiates
    the op after the forward's context has closed, so the backward sets
    it again itself. A 2-D ``w`` folds x's leading dims into one product
    for dW, as a single ``dot_general`` contracts them."""

    @staticmethod
    def forward(x, w):
        with f32_accumulation():
            return torch.matmul(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        with f32_accumulation():
            if ctx.needs_input_grad[0]:
                gx = torch.matmul(g, w.mT).sum_to_size(x.shape)
            if ctx.needs_input_grad[1]:
                if w.ndim == 2:
                    gw = (x.reshape(-1, x.shape[-1]).mT
                          @ g.reshape(-1, g.shape[-1]))
                else:
                    gw = torch.matmul(x.mT, g).sum_to_size(w.shape)
        return gx, gw


def matmul(x, w):
    """``torch.matmul(x, w)``; bf16 operands (AMP) of at least 2 dims are
    multiplied with f32 accumulation and give bf16."""
    if torch.bfloat16 in (x.dtype, w.dtype) and min(x.ndim, w.ndim) >= 2:
        return _Bf16Matmul.apply(x, w)
    return torch.matmul(x, w)


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
