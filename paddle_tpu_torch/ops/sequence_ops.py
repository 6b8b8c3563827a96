"""Sequence ops over padded [batch, time, ...] tensors and per-row lengths.

Counterpart of ``paddle_tpu/ops/sequence_ops.py``, cut to the mask
helpers, ``sequence_pool``, ``sequence_conv`` and ``context_project``. A sequence tensor is dense-padded to the
batch's longest row and travels with an int32 ``Length`` companion
([batch]); positions t >= Length[b] are padding, which the ops ignore
and where they produce zeros. The mask is built on the tensors' device
from ``Length``: no value comes back to the host.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import matmul, maybe, out, single


def time_mask(lengths, T, dtype=torch.float32):
    """[batch, T] mask: 1 where t < length, else 0."""
    t = torch.arange(T, dtype=lengths.dtype, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def _expand_mask(mask, x):
    """Broadcast a [b, T] mask over x's trailing feature dims."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.ndim - 2))


def _lowest(dtype):
    return (torch.finfo(dtype).min if dtype.is_floating_point
            else torch.iinfo(dtype).min)


@register_op("sequence_pool", optional_inputs=("Length",))
def sequence_pool(attrs, ins):
    """Pool each row's valid prefix: ``sum``, ``average``, ``sqrt`` (sum
    over sqrt(length)), ``max``, ``last`` or ``first``. Empty rows pool
    to 0, except under ``first`` and ``last``, which read position 0
    there, as in JAX. ``max`` fills the padding with the dtype's lowest
    value and reduces with ``amax``, whose gradient splits among tied
    maxima as XLA's ``reduce_max`` does."""
    x = single(ins, "X")  # [b, T, ...]
    lengths = maybe(ins, "Length")
    ptype = attrs.get("pool_type", "average").lower()
    T = x.shape[1]
    if lengths is None:
        lengths = torch.full((x.shape[0],), T, dtype=torch.int32,
                             device=x.device)
    m = _expand_mask(time_mask(lengths, T, x.dtype), x)
    denom = torch.clamp(lengths, min=1).to(x.dtype)
    denom = denom.reshape((-1,) + (1,) * (x.ndim - 2))
    if ptype == "sum":
        y = torch.sum(x * m, dim=1)
    elif ptype == "average":
        y = torch.sum(x * m, dim=1) / denom
    elif ptype == "sqrt":
        y = torch.sum(x * m, dim=1) / torch.sqrt(denom)
    elif ptype == "max":
        # a Python scalar: no host-to-device copy (which would wait)
        y = torch.amax(torch.where(m > 0, x, _lowest(x.dtype)), dim=1)
        y = torch.where(lengths.reshape(denom.shape) > 0, y,
                        torch.zeros_like(y))
    elif ptype == "last":
        idx = torch.clamp(lengths - 1, min=0).to(torch.int64)
        idx = idx.reshape((-1, 1) + (1,) * (x.ndim - 2))
        y = torch.take_along_dim(x, idx, dim=1).squeeze(1)
    elif ptype == "first":
        y = x[:, 0]
    else:
        raise ValueError(f"unknown pool_type {ptype!r}")
    return out(Out=y)


def _context_columns(x, lengths, k, start):
    """The context window of every step: x with its padding zeroed,
    shifted along time by each offset in [start, start + k) (zeros where
    the window leaves the padded axis) and concatenated on the feature
    axis -> ([b, T, k*d], the [b, T, 1] mask)."""
    b, T = x.shape[:2]
    mask = (time_mask(lengths, T, x.dtype)[..., None]
            if lengths is not None
            else torch.ones((b, T, 1), dtype=x.dtype, device=x.device))
    xm = x * mask
    cols = []
    for off in range(start, start + k):
        if off < 0:
            shifted = torch.nn.functional.pad(xm, (0, 0, -off, 0))[:, :T]
        elif off > 0:
            shifted = torch.nn.functional.pad(xm, (0, 0, 0, off))[:, off:]
        else:
            shifted = xm
        cols.append(shifted)
    return torch.cat(cols, dim=-1), mask


@register_op("sequence_conv", optional_inputs=("Length", "PaddingData"))
def sequence_conv(attrs, ins):
    """Context-window projection + filter product (the reference's
    sequence_conv_op.cc / context_project.h): each step's row becomes the
    concat of its [contextStart, contextStart + contextLength) neighbours,
    zeros outside the sequence, times ``Filter`` [k*d, out], one
    [b*T, k*d] x [k*d, out] product. ``PaddingData`` is accepted and
    ignored, as in JAX: context rows past either end are zeros."""
    x = single(ins, "X")  # [b, T, d]
    filt = single(ins, "Filter")  # [k*d, out]
    k = int(attrs.get("contextLength", attrs.get("context_length", 3)))
    start = int(attrs.get("contextStart",
                          attrs.get("context_start", -(k // 2))))
    ctx, mask = _context_columns(x, maybe(ins, "Length"), k, start)
    return out(Out=matmul(ctx, filt) * mask)


@register_op("context_project", optional_inputs=("Length",))
def context_project(attrs, ins):
    """``sequence_conv`` without the filter product (the v1
    context_projection): [b, T, d] -> [b, T, k*d]."""
    k = int(attrs["context_length"])
    start = int(attrs.get("context_start", -(k // 2)))
    ctx, mask = _context_columns(single(ins, "X"), maybe(ins, "Length"),
                                 k, start)
    return out(Out=ctx * mask)
