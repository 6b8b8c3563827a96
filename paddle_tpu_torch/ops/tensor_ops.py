"""Tensor creation / manipulation / elementwise / reduction ops.

Counterpart of ``paddle_tpu/ops/tensor_ops.py``: every op of it but
``feed``/``fetch`` (the executor's own). ``sum``, ``scale``, ``clip``,
``clip_by_norm`` and ``clip_by_global_norm`` keep a SelectedRows
operand (a sparse embedding's gradient) sparse, as the JAX ops do; the
elementwise ops take its dense view. Comparisons and logic give bool and
``argmax`` int64; their ops pass no gradient (``NON_DIFFERENTIABLE`` in
``core/backward.py``). The random init ops draw from
their split of the executor's scope key (``core/prng.py``), bit-exact with
the JAX executor's draws. Ops return new tensors and never write into their
inputs (the executor relies on it: ``assign`` hands on the same tensor).
Ops without inputs create their outputs on torch's default device, which
the executor sets to the run's device (and shape inference to ``meta``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import prng
from ..core.registry import register_op
from ..core.selected_rows import SelectedRows, densify
from ..core.types import to_dtype
from . import common
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


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(attrs, ins):
    """A constant whose batch dim copies Input's, on Input's device."""
    ref = single(ins, "Input")
    return out(Out=torch.full(_batch_size_like_shape(attrs, ref),
                              attrs.get("value", 0.0),
                              dtype=to_dtype(attrs.get("dtype", "float32")),
                              device=ref.device))


@register_op("assign_value")
def assign_value(attrs, ins):
    """The attr ``values`` as a tensor of ``shape`` and ``dtype`` (each
    value rounded to the dtype, as ``np.asarray`` rounds it)."""
    dtype = to_dtype(attrs.get("dtype", "float32"))
    return out(Out=torch.tensor(list(attrs["values"]), dtype=dtype)
               .reshape(tuple(attrs["shape"])))


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
    return prng.fma(x, prng.f32(std), prng.f32(mean))


def _gaussian(shape, attrs, rng):
    """mean + std * normal(rng) in the op's dtype. In f32 as the JAX
    executor's jitted block computes it: XLA folds sqrt(2) * std into one
    constant and fuses the add, so erf_inv(u) * f32(sqrt(2) * std) + mean
    in one rounding."""
    dtype = _dtype(attrs)
    if dtype == torch.bfloat16:
        return _affine(prng.normal(rng, shape, dtype), attrs)
    u = prng.uniform(rng, shape, minval=prng.f32(-0.99999994), maxval=1.0)
    k = prng.f32(prng._SQRT2 * prng.f32(attrs.get("std", 1.0)))
    return prng.fma(prng.erf_inv(u), k, prng.f32(attrs.get("mean", 0.0)))


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
    """x + step in x's dtype (an int32 step counter stays int32). The
    step enters as a Python scalar: a tensor made from it on the card
    would be a host-to-device copy, and a stream sync, every run."""
    x = single(ins, "X")
    return out(Out=x + common.weak(x, attrs.get("step", 1.0)))


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


@register_op("squeeze")
def squeeze(attrs, ins):
    """X without the dims ``axes``, or without every dim of size 1 when
    ``axes`` is empty."""
    x = single(ins, "X")
    axes = attrs.get("axes") or [i for i, d in enumerate(x.shape) if d == 1]
    return out(Out=torch.squeeze(x, dim=tuple(axes)) if axes else x)


@register_op("unsqueeze")
def unsqueeze(attrs, ins):
    """``jnp.expand_dims``: ``axes`` name dims of the output."""
    x = single(ins, "X")
    n = x.ndim + len(attrs["axes"])
    for a in sorted(a % n for a in attrs["axes"]):
        x = x.unsqueeze(a)
    return out(Out=x)


@register_op("expand")
def expand(attrs, ins):
    """``jnp.tile`` by ``expand_times``."""
    return out(Out=torch.tile(single(ins, "X"),
                              tuple(attrs["expand_times"])))


@register_op("stack")
def stack(attrs, ins):
    """The X tensors stacked on a new dim ``axis``, in their promoted
    dtype as ``jnp.stack`` promotes a mix; output slot Y."""
    xs = ins["X"]
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return out(Y=torch.stack([x.to(dtype) for x in xs],
                             dim=attrs.get("axis", 0)))


@register_op("pad")
def pad(attrs, ins):
    """Constant padding; ``paddings`` is [before0, after0, before1, ...]."""
    x = single(ins, "X")
    p = attrs["paddings"]
    widths = []
    for i in reversed(range(x.ndim)):  # F.pad takes the last dim first
        widths += [p[2 * i], p[2 * i + 1]]
    return out(Out=F.pad(x, widths, value=attrs.get("pad_value", 0.0)))


@register_op("crop")
def crop(attrs, ins):
    """X[offsets : offsets + shape]; a -1 in ``shape`` keeps the rest of
    that dim (the batch dim in particular)."""
    x = single(ins, "X")
    idx = tuple(slice(o, None if s == -1 else o + s)
                for o, s in zip(attrs["offsets"], attrs["shape"]))
    return out(Out=x[idx])


# --- elementwise binary (broadcast semantics per elementwise_op.h) ----------
def _elementwise(op):
    """Both operands in their promoted dtype first, as jnp promotes them:
    torch would keep a bf16 x's dtype against a 0-dim f32 y (under AMP,
    bf16 activations meet f32 biases and scalars), where JAX widens."""
    def fn(attrs, ins):
        # a SelectedRows operand (a sparse gradient meeting a dense
        # consumer, the gradient accumulation's ``acc += grad``) takes
        # its dense view: only the optimizer ops keep rows sparse
        x = densify(single(ins, "X"))
        y = broadcast_to_x(x, densify(single(ins, "Y")),
                           attrs.get("axis", -1))
        dtype = torch.promote_types(x.dtype, y.dtype)
        return out(Out=op(x.to(dtype), y.to(dtype)))

    return fn


register_op("elementwise_add", _elementwise(torch.add))
register_op("elementwise_sub", _elementwise(torch.sub))
register_op("elementwise_mul", _elementwise(torch.mul))
register_op("elementwise_div", _elementwise(common.div))
# a tie splits its gradient evenly, in torch as in jnp
register_op("elementwise_max", _elementwise(torch.maximum))
register_op("elementwise_min", _elementwise(torch.minimum))
register_op("elementwise_pow", _elementwise(common.pow_))


@register_op("clip")
def clip(attrs, ins):
    """``jnp.clip`` to [min, max]: a value at a bound gets half the
    gradient. A SelectedRows merges its duplicate rows first, so the
    bound applies to each row's summed gradient."""
    x = single(ins, "X")
    if isinstance(x, SelectedRows):
        m = x.merged()
        return out(Out=SelectedRows(
            m.rows, common.clip(m.values, attrs["min"], attrs["max"]),
            m.height))
    return out(Out=common.clip(x, attrs["min"], attrs["max"]))


def _sq_l2(g):
    """The squared L2 norm of a gradient, summed in f32; a SelectedRows
    is merged first, so a repeated row counts with its summed value."""
    if isinstance(g, SelectedRows):
        g = g.merged().values
    g = g.float()
    return (g * g).sum()


def _rescale(g, factor):
    """g times the 0-dim factor, cast to g's dtype; rows stay rows."""
    if isinstance(g, SelectedRows):
        return SelectedRows(g.rows, g.values * factor.to(g.dtype), g.height)
    return g * factor.to(g.dtype)


def _clip_factor(sq, max_norm):
    """min(1, max_norm / sqrt(max(sq, 1e-12))), a 0-dim f32 tensor (the
    numerator a tensor: float / tensor would take the reciprocal)."""
    norm = torch.sqrt(torch.clamp_min(sq, 1e-12))
    return torch.clamp_max(norm.new_full((), max_norm) / norm, 1.0)


@register_op("clip_by_norm")
def clip_by_norm(attrs, ins):
    """X rescaled so that its L2 norm is at most max_norm; the factor is
    cast to X's dtype before the product."""
    x = single(ins, "X")
    return out(Out=_rescale(x, _clip_factor(_sq_l2(x), attrs["max_norm"])))


@register_op("clip_by_global_norm")
def clip_by_global_norm(attrs, ins):
    """Every gradient of X rescaled by one factor, so that the L2 norm of
    the whole set is at most max_norm: one op over all of them."""
    xs = ins["X"]
    factor = _clip_factor(sum(_sq_l2(g) for g in xs), attrs["max_norm"])
    return {"Out": [_rescale(g, factor) for g in xs]}


@register_op("l1_decay_sign")
def l1_decay_sign(attrs, ins):
    """sign(X) * coeff, the L1 regularizer's gradient term."""
    x = single(ins, "X")
    return out(Out=torch.sign(x) * common.weak(x, attrs["coeff"]))


@register_op("scale")
def scale(attrs, ins):
    """x * scale + bias (``bias_after_scale``, the default) or (x + bias)
    * scale, in x's dtype: what ``DropoutToScale`` emits. A SelectedRows
    scales its values (a bias is not defined on rows)."""
    x = single(ins, "X")
    if isinstance(x, SelectedRows):
        if attrs.get("bias", 0.0):
            raise ValueError("scale with bias is not defined on SelectedRows")
        return out(Out=x.scale(common.weak(x.values,
                                           attrs.get("scale", 1.0))))
    s = common.weak(x, attrs.get("scale", 1.0))
    b = common.weak(x, attrs.get("bias", 0.0))
    if attrs.get("bias_after_scale", True):
        return out(Out=x * s + b)
    return out(Out=(x + b) * s)


@register_op("sum")
def sum_op(attrs, ins):
    """The sum of X. SelectedRows operands (a sparse embedding's gradient
    fanning out) stay rows when all are rows (their rows concatenated);
    a dense operand densifies them."""
    xs = ins["X"]
    sparse = [x for x in xs if isinstance(x, SelectedRows)]
    dense = [x for x in xs if not isinstance(x, SelectedRows)]
    acc = None
    if sparse:
        acc = sparse[0]
        for x in sparse[1:]:
            acc = acc + x
        if dense:
            acc = acc.to_dense()
    for x in dense:
        acc = x if acc is None else acc + x
    return out(Out=acc)


# --- reductions -------------------------------------------------------------
@register_op("mean")
def mean(attrs, ins):
    return out(Out=single(ins, "X").mean())


def _reduce(op):
    """Over ``dim`` (an int or a list), or every dim when ``reduce_all``
    (the default when ``dim`` is None), keeping them when ``keep_dim``."""
    def fn(attrs, ins):
        x = single(ins, "X")
        dim = attrs.get("dim")
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", dim is None):
            dims = tuple(range(x.ndim))
        else:
            dims = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        return out(Out=op(x, dims, keep))

    return fn


def _prod(x, dims, keep):
    for d in sorted((d % x.ndim for d in dims), reverse=True):
        x = x.prod(dim=d, keepdim=keep)
    return x


# jnp.sum, mean and prod reduce a bf16 X in f32 and round the result
# (XLA keeps an op that feeds such a sum in f32, ``common.sum_f32``: a
# program-wide fusion the port's ops cannot see across op boundaries);
# amax/amin split a tied maximum's gradient evenly, as jnp.max does
# (torch.max(dim) would send it all to one element)
register_op("reduce_sum", _reduce(lambda x, d, k: x.sum(
    dim=d, keepdim=k, dtype=_acc(x)).to(x.dtype)))
register_op("reduce_mean", _reduce(lambda x, d, k: x.mean(
    dim=d, keepdim=k, dtype=_acc(x)).to(x.dtype)))
register_op("reduce_max", _reduce(lambda x, d, k: x.amax(dim=d, keepdim=k)))
register_op("reduce_min", _reduce(lambda x, d, k: x.amin(dim=d, keepdim=k)))
register_op("reduce_prod", _reduce(lambda x, d, k: _prod(
    x.to(_acc(x)), d, k).to(x.dtype)))


def _acc(x):
    """The dtype jnp reduces x in: f32 for a 16-bit float, else x's."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return x.dtype


@register_op("argmax")
def argmax(attrs, ins):
    """The index of the first maximum along ``axis``, int64."""
    return out(Out=torch.argmax(single(ins, "X"), dim=attrs.get("axis", -1)))


# --- comparison / logical ---------------------------------------------------
def _compare(op):
    """op(x, y) as bool, y broadcast as the elementwise ops broadcast it."""
    def fn(attrs, ins):
        x = single(ins, "X")
        y = broadcast_to_x(x, single(ins, "Y"), attrs.get("axis", -1))
        return out(Out=op(x, y))

    return fn


register_op("equal", _compare(torch.eq))
register_op("not_equal", _compare(torch.ne))
register_op("less_than", _compare(torch.lt))
register_op("less_equal", _compare(torch.le))
register_op("greater_than", _compare(torch.gt))
register_op("greater_equal", _compare(torch.ge))
register_op("logical_and", _compare(torch.logical_and))
register_op("logical_or", _compare(torch.logical_or))
register_op("logical_xor", _compare(torch.logical_xor))


@register_op("logical_not")
def logical_not(attrs, ins):
    return out(Out=torch.logical_not(single(ins, "X")))


# --- indexing ---------------------------------------------------------------
def _normalize_ids(ids, n):
    """Negative ids wrap once, as JAX's indexing normalizes them."""
    return torch.where(ids < 0, ids + n, ids)


def _lookup_table_grad(attrs, ins, outs, ogs):
    """Embedding gradient, sparse or dense.

    With ``is_sparse`` it is a SelectedRows: the (normalised) ids and the
    output gradient's rows, no [V, D] buffer, the padding lookups pointed
    at the ``V`` sentinel that every consumer drops. Without it, a
    scatter-add of the output gradient into a zero [V, D] table, dropping
    out-of-range ids (JAX's ``.at[ids].add(mode="drop")``) and the
    padding row (its forward output is zero)."""
    w = single(ins, "W")
    V = w.shape[0]
    raw = single(ins, "Ids").reshape(-1)
    ids = _normalize_ids(raw, V)
    og = ogs["Out"][0].reshape(ids.shape[0], w.shape[-1]).to(w.dtype)
    pad = attrs.get("padding_idx")
    if attrs.get("is_sparse", False):
        drop = (ids < 0) | (ids >= V)
        if pad is not None and pad >= 0:
            drop = drop | (raw == pad)
        ids = torch.where(drop, torch.full_like(ids, V), ids)
        return {"W": [SelectedRows(ids, og, V)], "Ids": [None]}
    keep = (ids >= 0) & (ids < V)
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
    out-of-range ids clamp to the table; the padding row reads as 0.
    ``is_sparse`` changes only the gradient (a SelectedRows); the
    ``vocab_axis`` of a sharded table is ignored on one device, as the
    JAX op ignores it without a mesh."""
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


@register_op("gather")
def gather(attrs, ins):
    """Rows of X at the flattened Index (``jnp.take`` on axis 0): a
    negative index wraps once, an index out of range reads the fill
    value (NaN for floats), and its gradient is dropped."""
    x = single(ins, "X")
    n = x.shape[0]
    idx = _normalize_ids(single(ins, "Index").reshape(-1), n)
    valid = (idx >= 0) & (idx < n)
    rows = x[idx.clamp(0, max(n - 1, 0))]
    if x.is_floating_point():
        fill = float("nan")
    elif x.dtype == torch.bool:
        fill = True
    else:
        fill = torch.iinfo(x.dtype).min
    mask = valid.reshape((-1,) + (1,) * (x.ndim - 1))
    return out(Out=torch.where(mask, rows, torch.full(
        (), fill, dtype=x.dtype, device=x.device)))


@register_op("one_hot")
def one_hot(attrs, ins):
    """f32 rows of ``depth`` with a 1 at each id (zeros for an id out of
    [0, depth)); a trailing dim of 1 is dropped first."""
    x = single(ins, "X")
    flat = x.reshape(x.shape[:-1] if (x.ndim > 1 and x.shape[-1] == 1)
                     else x.shape)
    depth = attrs["depth"]
    return out(Out=(flat[..., None] == torch.arange(
        depth, device=x.device)).to(torch.float32))


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
