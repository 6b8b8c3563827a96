"""Tensor creation / manipulation / elementwise / reduction ops.

Counterpart of ``paddle_tpu/ops/tensor_ops.py``, cut to the ops the
training slice runs. Ops return new tensors and never write into their
inputs (the executor relies on it: ``assign`` hands on the same tensor).
Ops without inputs create their outputs on torch's default device, which
the executor sets to the run's device (and shape inference to ``meta``).
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.types import to_dtype
from .common import broadcast_to_x, out, single


# --- creation ---------------------------------------------------------------
@register_op("fill_constant")
def fill_constant(attrs, ins):
    dtype = to_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs.get("shape", ()))
    return out(Out=torch.full(shape, attrs.get("value", 0.0), dtype=dtype))


@register_op("uniform_random", needs_rng=True)
def uniform_random(attrs, ins, rng):
    """U[min, max) drawn from ``rng`` (a torch.Generator on the output's
    device). Not JAX's threefry bits: the RNG plane is a later slice."""
    dtype = to_dtype(attrs.get("dtype", "float32"))
    t = torch.empty(tuple(attrs["shape"]), dtype=dtype)
    if t.device.type == "meta":  # shape inference: nothing to draw
        return out(Out=t)
    return out(Out=t.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                              generator=rng))


@register_op("gaussian_random", needs_rng=True)
def gaussian_random(attrs, ins, rng):
    """N(mean, std) drawn from ``rng``, as ``uniform_random`` draws: not
    JAX's threefry bits."""
    dtype = to_dtype(attrs.get("dtype", "float32"))
    t = torch.empty(tuple(attrs["shape"]), dtype=dtype)
    if t.device.type == "meta":  # shape inference: nothing to draw
        return out(Out=t)
    return out(Out=t.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                             generator=rng))


@register_op("assign")
def assign(attrs, ins):
    return out(Out=single(ins, "X"))


# --- shape manipulation -----------------------------------------------------
@register_op("reshape")
def reshape(attrs, ins):
    x = single(ins, "X")
    # reference semantics (reshape_op.cc): 0 means copy the input dim
    shape = [x.shape[i] if d == 0 else d for i, d in enumerate(attrs["shape"])]
    return out(Out=x.reshape(tuple(shape)))


@register_op("slice")
def slice_op(attrs, ins):
    x = single(ins, "X")
    idx = [slice(None)] * x.ndim
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(st, en)
    return out(Out=x[tuple(idx)])


# --- elementwise binary (broadcast semantics per elementwise_op.h) ----------
def _elementwise(op):
    def fn(attrs, ins):
        x = single(ins, "X")
        y = broadcast_to_x(x, single(ins, "Y"), attrs.get("axis", -1))
        return out(Out=op(x, y))

    return fn


register_op("elementwise_add", _elementwise(torch.add))


@register_op("sum")
def sum_op(attrs, ins):
    acc = ins["X"][0]
    for x in ins["X"][1:]:
        acc = acc + x
    return out(Out=acc)


# --- reductions -------------------------------------------------------------
@register_op("mean")
def mean(attrs, ins):
    return out(Out=single(ins, "X").mean())


# --- indexing ---------------------------------------------------------------
def _normalize_ids(ids, n):
    """Negative ids wrap once, as JAX's indexing normalizes them."""
    return torch.where(ids < 0, ids + n, ids)


def _lookup_table_grad(attrs, ins, outs, ogs):
    """Dense embedding gradient: a scatter-add of the output gradient
    into a zero [V, D] table, dropping out-of-range ids (JAX's
    ``.at[ids].add(mode="drop")``) and the padding row (its forward
    output is zero). ``is_sparse`` (SelectedRows) grads are a later
    slice."""
    if attrs.get("is_sparse", False):
        raise NotImplementedError(
            "sparse (SelectedRows) embedding gradients are not ported to "
            "paddle_tpu_torch yet: they land with the sparse-grad slice")
    w = single(ins, "W")
    V = w.shape[0]
    raw = single(ins, "Ids").reshape(-1)
    ids = _normalize_ids(raw, V)
    og = ogs["Out"][0].reshape(ids.shape[0], w.shape[-1]).to(w.dtype)
    keep = (ids >= 0) & (ids < V)
    pad = attrs.get("padding_idx")
    if pad is not None and pad >= 0:
        keep = keep & (raw != pad)
    rows = torch.where(keep, ids, torch.zeros_like(ids))
    og = og * keep[:, None].to(og.dtype)
    dw = torch.zeros_like(w).index_add_(0, rows, og)
    return {"W": [dw], "Ids": [None]}


@register_op("lookup_table", grad_fn=_lookup_table_grad)
def lookup_table(attrs, ins):
    """W[ids] with XLA gather semantics: negative ids wrap once and
    out-of-range ids clamp to the table; the padding row reads as 0."""
    if attrs.get("is_sparse", False):
        raise NotImplementedError(
            "embedding(is_sparse=True) is not ported to paddle_tpu_torch "
            "yet: it lands with the sparse-grad (SelectedRows) slice")
    w = single(ins, "W")
    ids = single(ins, "Ids")
    squeeze_last = ids.ndim > 1 and ids.shape[-1] == 1
    flat = ids.reshape(-1)
    rows = w[_normalize_ids(flat, w.shape[0]).clamp(0, w.shape[0] - 1)]
    pad = attrs.get("padding_idx")
    if pad is not None and pad >= 0:
        rows = torch.where((flat == pad)[:, None],
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device), rows)
    shape = (ids.shape[:-1] if squeeze_last else ids.shape) + (w.shape[-1],)
    return out(Out=rows.reshape(shape))
