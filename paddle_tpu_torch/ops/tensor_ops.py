"""Tensor creation / manipulation / elementwise / reduction ops.

Counterpart of ``paddle_tpu/ops/tensor_ops.py``, cut to the ops the
training, image and inference slices run (``transpose`` and ``split``
for the per-layer transformer's heads, ``concat`` for GoogLeNet's
inception blocks, ``top_k`` and ``accuracy`` for the trainer's
metrics, ``increment``, ``equal``, ``cast``, ``elementwise_sub`` and
``elementwise_mul`` for gradient accumulation's counter and gate). The random init ops draw from
their split of the executor's scope key (``core/prng.py``), bit-exact with
the JAX executor's draws. Ops return new tensors and never write into their
inputs (the executor relies on it: ``assign`` hands on the same tensor).
Ops without inputs create their outputs on torch's default device, which
the executor sets to the run's device (and shape inference to ``meta``).
"""
from __future__ import annotations

import torch

from ..core import prng
from ..core.registry import register_op
from ..core.types import to_dtype
from .common import broadcast_to_x, out, single


# --- creation ---------------------------------------------------------------
@register_op("fill_constant")
def fill_constant(attrs, ins):
    dtype = to_dtype(attrs.get("dtype", "float32"))
    shape = tuple(attrs.get("shape", ()))
    return out(Out=torch.full(shape, attrs.get("value", 0.0), dtype=dtype))


def _batch_size_like_shape(attrs, ref):
    """Declared shape with the output batch dim copied from ``ref``'s
    (the *_batch_size_like op family contract)."""
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = ref.shape[
        attrs.get("input_dim_idx", 0)]
    return tuple(shape)


def _dtype(attrs):
    """The op's draw dtype: float32, or bfloat16 (a parameter declared
    bf16 under AMP); jax draws in it, so the port does too."""
    dtype = to_dtype(attrs.get("dtype", "float32"))
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"random init ops draw float32 or bfloat16, not "
                        f"{dtype}")
    return dtype


def _affine(x, attrs):
    """mean + std * x as the JAX op computes it on a draw x. f32: XLA
    fuses the two into one fused multiply-add. bf16: two bf16 ops, each
    rounded (mean and std rounded to bf16 first)."""
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    if x.dtype == torch.bfloat16:
        r = prng._bf16
        return r(r(r(std) * x.float()) + r(mean)).to(torch.bfloat16)
    return prng._fma(x, prng._f32(std), prng._f32(mean))


def _gaussian(shape, attrs, rng):
    """mean + std * normal(rng) in the op's dtype. In f32 as the JAX
    executor's jitted block computes it: XLA folds sqrt(2) * std into one
    constant and fuses the add, so erf_inv(u) * f32(sqrt(2) * std) + mean
    in one rounding."""
    dtype = _dtype(attrs)
    if dtype == torch.bfloat16:
        return _affine(prng.normal(rng, shape, dtype), attrs)
    u = prng.uniform(rng, shape, minval=prng._f32(-0.99999994), maxval=1.0)
    k = prng._f32(prng._SQRT2 * prng._f32(attrs.get("std", 1.0)))
    return prng._fma(prng.erf_inv(u), k, prng._f32(attrs.get("mean", 0.0)))


@register_op("uniform_random", needs_rng=True)
def uniform_random(attrs, ins, rng):
    """U[min, max) from the op's split of the scope key, bit-exact with
    ``jax.random.uniform`` in the op's dtype (``core/prng.py``)."""
    shape = tuple(attrs["shape"])
    return out(Out=prng.uniform(rng, shape, attrs.get("min", -1.0),
                                attrs.get("max", 1.0), dtype=_dtype(attrs)))


@register_op("gaussian_random", needs_rng=True)
def gaussian_random(attrs, ins, rng):
    """N(mean, std) from the op's split of the scope key."""
    return out(Out=_gaussian(tuple(attrs["shape"]), attrs, rng))


@register_op("gaussian_random_batch_size_like", needs_rng=True)
def gaussian_random_batch_size_like(attrs, ins, rng):
    """Gaussian noise whose batch dim copies Input's: an rng leaf, so
    gradients flow only through whatever it is combined with."""
    shape = _batch_size_like_shape(attrs, single(ins, "Input"))
    return out(Out=_gaussian(shape, attrs, rng))


@register_op("truncated_gaussian_random", needs_rng=True)
def truncated_gaussian_random(attrs, ins, rng):
    """mean + std * a normal truncated to [-2, 2], in the op's dtype."""
    x = prng.truncated_normal(rng, -2.0, 2.0, tuple(attrs["shape"]),
                              dtype=_dtype(attrs))
    return out(Out=_affine(x, attrs))


@register_op("assign")
def assign(attrs, ins):
    return out(Out=single(ins, "X"))


@register_op("cast")
def cast(attrs, ins):
    dtype = to_dtype(attrs.get("out_dtype", attrs.get("dtype", "float32")))
    return out(Out=single(ins, "X").to(dtype))


@register_op("increment")
def increment(attrs, ins):
    """x + step in x's dtype."""
    x = single(ins, "X")
    return out(Out=x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype,
                                    device=x.device))


# --- shape manipulation -----------------------------------------------------
@register_op("reshape")
def reshape(attrs, ins):
    x = single(ins, "X")
    # reference semantics (reshape_op.cc): 0 means copy the input dim
    shape = [x.shape[i] if d == 0 else d for i, d in enumerate(attrs["shape"])]
    return out(Out=x.reshape(tuple(shape)))


@register_op("transpose")
def transpose(attrs, ins):
    """X with its dims permuted by ``axis`` (a view: ops never write into
    their inputs)."""
    return out(Out=single(ins, "X").permute(tuple(attrs["axis"])))


@register_op("split")
def split(attrs, ins):
    """X cut along ``axis`` into ``sections`` (their sizes) or ``num``
    equal parts: a list ``Out``. Its gradient is the generic vjp, which
    takes the parts that receive a gradient and zeros elsewhere."""
    x = single(ins, "X")
    axis = attrs.get("axis", 0)
    if attrs.get("sections"):
        sections = list(attrs["sections"])
        if sum(sections) != x.shape[axis]:
            raise ValueError(f"split sections {sections} do not sum to dim "
                             f"{axis} of {tuple(x.shape)}")
        return {"Out": list(torch.split(x, sections, dim=axis))}
    num = attrs["num"]
    if x.shape[axis] % num:
        raise ValueError(f"split: dim {axis} of {tuple(x.shape)} does not "
                         f"divide into {num} equal parts")
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register_op("concat")
def concat(attrs, ins):
    """The X tensors joined along ``axis``, in their promoted dtype, as
    ``jnp.concatenate`` promotes a mix (bf16 and f32 give f32). Its
    gradient is the generic vjp: each input's slice of Out's gradient."""
    xs = ins["X"]
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return out(Out=torch.cat([x.to(dtype) for x in xs],
                             dim=attrs.get("axis", 0)))


@register_op("slice")
def slice_op(attrs, ins):
    x = single(ins, "X")
    idx = [slice(None)] * x.ndim
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(st, en)
    return out(Out=x[tuple(idx)])


# --- elementwise binary (broadcast semantics per elementwise_op.h) ----------
def _elementwise(op):
    """Both operands in their promoted dtype first, as jnp promotes them:
    torch would keep a bf16 x's dtype against a 0-dim f32 y (under AMP,
    bf16 activations meet f32 biases and scalars), where JAX widens."""
    def fn(attrs, ins):
        x = single(ins, "X")
        y = broadcast_to_x(x, single(ins, "Y"), attrs.get("axis", -1))
        dtype = torch.promote_types(x.dtype, y.dtype)
        return out(Out=op(x.to(dtype), y.to(dtype)))

    return fn


register_op("elementwise_add", _elementwise(torch.add))
register_op("elementwise_sub", _elementwise(torch.sub))
register_op("elementwise_mul", _elementwise(torch.mul))


@register_op("equal")
def equal(attrs, ins):
    """x == y (bool), y broadcast as the elementwise ops broadcast it."""
    x = single(ins, "X")
    y = broadcast_to_x(x, single(ins, "Y"), attrs.get("axis", -1))
    return out(Out=torch.eq(x, y))


@register_op("scale")
def scale(attrs, ins):
    """x * scale + bias (``bias_after_scale``, the default) or (x + bias)
    * scale, in x's dtype: what ``DropoutToScale`` emits."""
    x = single(ins, "X")
    s = torch.tensor(attrs.get("scale", 1.0), dtype=x.dtype)
    b = torch.tensor(attrs.get("bias", 0.0), dtype=x.dtype)
    if attrs.get("bias_after_scale", True):
        return out(Out=x * s + b)
    return out(Out=(x + b) * s)


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
    # an accumulating index_put_ sums each row's gradients in a fixed
    # order (on CUDA it sorts the ids; index_add_ there adds with atomics
    # in whatever order they land), so the same step gives the same bits
    # and a resumed or pipelined run equals an uninterrupted one
    dw = torch.zeros_like(w).index_put_((rows,), og, accumulate=True)
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


# --- top-k and metrics -------------------------------------------------------
@register_op("top_k")
def top_k(attrs, ins):
    """The ``k`` largest values along the last axis and their indices
    (int64), largest first; ties in the order of their indices, as
    ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    x = single(ins, "X")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    k = attrs["k"]
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


@register_op("accuracy")
def accuracy(attrs, ins):
    """Inputs: Out (top-k values), Indices (top-k indices), Label [N, 1].
    The share of rows whose label is among their top-k indices (f32),
    and the int32 counts behind it."""
    idx = single(ins, "Indices")
    label = single(ins, "Label").reshape(-1, 1)
    correct = (idx == label).any(dim=1).sum()
    total = idx.shape[0]
    return {
        "Accuracy": [correct.to(torch.float32) / total],
        "Correct": [correct.to(torch.int32)],
        "Total": [torch.tensor(total, dtype=torch.int32,
                               device=idx.device)],
    }
