"""Shared helpers for the port's op functions.

Counterpart of ``paddle_tpu/ops/common.py``, cut to what the serving
and training paths use. An op takes ``ins``, a dict of slot name -> [tensor], and
returns the same shape of dict, so it is called exactly like its JAX
twin.

Contraction precision, the JAX package's ``mxu_precision`` policy: a
tri-state that follows ``--mxu_precision`` (flags.py) until
``set_mxu_precision`` is called, and then what that call set. Every
product of f32 operands on the card takes it (``matmul``,
``product_precision``: ``mul``, ``matmul``, the convolutions, the LM's
blocks and head, the recurrent steps, the fused conv's gradients), and
the conv GEMM kernels choose their instance by it
(``kernels/conv_epilogue.py``):

- ``default`` (``None``): the backend's fast path, as XLA's ``DEFAULT``
  on this card: cuBLAS and cuDNN may run f32 products in TF32, and the
  conv GEMM kernels run their 1xTF32 instance;
- ``high``: f32-accurate: full f32 library products, the 3xTF32 kernels
  (the analogue of the TPU's bf16_3x). torch offers no 3xTF32 GEMM, so
  ``high`` and ``highest`` coincide for library products on the card;
- ``highest``: full f32 (IEEE) library products, the 3xTF32 kernels.

The backend switches are set around each product and given back after
it (``library_precision``), never for the process. On the CPU every
policy computes in full f32, as XLA's CPU backend does, so the CPU runs
match the JAX package's f32 results under any policy. The flash kernels
take no policy (the Pallas kernels pass none to their dots): the f32
trio is 3xTF32 under all three.

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


# Tri-state: _UNSET defers to --use_amp and --mxu_precision (flags.py),
# so a flag flip takes effect; an explicit set_amp() or
# set_mxu_precision() wins over the flag.
_UNSET = object()
_AMP = _UNSET
_MXU_PRECISION = _UNSET
_PRECISIONS = {None: None, "default": None, "high": "high",
               "highest": "highest"}


def _precision(p):
    try:
        return _PRECISIONS[p]
    except (KeyError, TypeError):
        raise ValueError(f"mxu precision must be one of None, 'default', "
                         f"'high', 'highest'; got {p!r}") from None


def set_mxu_precision(p):
    """Set contraction precision globally: None/'default' | 'high' |
    'highest'."""
    global _MXU_PRECISION
    _MXU_PRECISION = _precision(p)


def mxu_precision(*_tensors):
    """The policy in force: None (default), 'high' or 'highest'."""
    if _MXU_PRECISION is _UNSET:
        from ..flags import FLAGS

        return _precision(FLAGS.mxu_precision)
    return _MXU_PRECISION


def set_amp(enabled: bool):
    global _AMP
    _AMP = bool(enabled)


def amp_enabled() -> bool:
    if _AMP is _UNSET:
        from ..flags import FLAGS

        return FLAGS.use_amp
    return _AMP


def policy_key() -> tuple:
    """The policies a captured CUDA graph depends on: it replays the
    casts and the library math modes it recorded."""
    return (("amp", amp_enabled()), ("mxu_precision", mxu_precision()))


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


@contextlib.contextmanager
def library_precision(tf32: bool):
    """cuBLAS and cuDNN f32 products in TF32 (``tf32``) or in full f32
    inside the block, the caller's settings after it."""
    mm = torch.backends.cuda.matmul
    prev = mm.allow_tf32, torch.backends.cudnn.allow_tf32
    mm.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        mm.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def precision_mode(*tensors):
    """How a product of these operands runs: "bf16" (f32 accumulation),
    "tf32" or "f32" (an f32 product on the card, by the policy), or None
    (the CPU computes every policy in f32)."""
    dtypes = {t.dtype for t in tensors}
    if torch.bfloat16 in dtypes:
        return "bf16"
    if torch.float32 in dtypes and any(t.is_cuda for t in tensors):
        return "tf32" if mxu_precision() is None else "f32"
    return None


@contextlib.contextmanager
def _in_mode(mode):
    if mode == "bf16":
        with f32_accumulation():
            yield
    elif mode is not None:
        with library_precision(mode == "tf32"):
            yield
    else:
        yield


def product_precision(*tensors):
    """The context a product of these operands runs in: bf16 operands
    with f32 accumulation, f32 ones on the card in TF32 or full f32 by
    the policy (``library_precision``), nothing on the CPU. A hand-written
    backward sets it again itself."""
    return _in_mode(precision_mode(*tensors))


class _Matmul(torch.autograd.Function):
    """``torch.matmul`` whose forward and backward both run in the
    precision ``mode`` the forward was called under (``_in_mode``): the
    generic grad op differentiates the op after the forward's context
    has closed, so the backward sets it again itself. A 2-D ``w`` folds
    x's leading dims into one product for dW, as a single
    ``dot_general`` contracts them."""

    @staticmethod
    def forward(x, w, mode):
        with _in_mode(mode):
            return torch.matmul(x, w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:2])
        ctx.mode = inputs[2]

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        with _in_mode(ctx.mode):
            if ctx.needs_input_grad[0]:
                gx = torch.matmul(g, w.mT).sum_to_size(x.shape)
            if ctx.needs_input_grad[1]:
                if w.ndim == 2:
                    gw = torch.matmul(x.reshape(-1, x.shape[-1]).mT,
                                      g.reshape(-1, g.shape[-1]))
                else:
                    gw = torch.matmul(x.mT, g).sum_to_size(w.shape)
        return gx, gw, None


def matmul(x, w):
    """``torch.matmul(x, w)`` in the precision of its operands: bf16
    operands (AMP) of at least 2 dims are multiplied with f32
    accumulation and give bf16; f32 operands on the card follow the
    policy (``product_precision``)."""
    mode = precision_mode(x, w)
    if mode is not None and min(x.ndim, w.ndim) >= 2:
        return _Matmul.apply(x, w, mode)
    with _in_mode(mode):
        return torch.matmul(x, w)


@contextlib.contextmanager
def full_f32_convolutions():
    """cuDNN with TF32 off inside the block, the caller's setting after
    it (``conv2d`` under ``high`` and ``highest``, and on the CPU)."""
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


# --- elementwise arithmetic that rounds and differentiates as JAX's -------
def weak(x, v):
    """The Python scalar ``v`` in ``x``'s dtype, as JAX rounds it against
    x: a floating x rounds its constants to its own dtype first (a bf16
    operand to bf16), an integral x truncates them as ``jnp.asarray(v,
    x.dtype)`` does. Kept a Python number so that torch's op takes it as
    a scalar, on any device and under a CUDA graph."""
    if x.dtype == torch.bool:
        return v
    return torch.tensor(v, dtype=x.dtype, device="cpu").item()


class _Unary(torch.autograd.Function):
    """``fwd(x)`` whose gradient is ``grad(g, out, x)``: the transpose of
    the JAX primitive's jvp written op by op in x's dtype, so that both
    packages round the gradient alike (torch's own derivative of
    ``tanh``, ``sigmoid`` or ``abs`` rounds, or decides at 0, otherwise)."""

    @staticmethod
    def forward(x, fwd, grad):
        return fwd(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.grad = inputs[2]
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, g):
        x, ans = ctx.saved_tensors
        return ctx.grad(g, ans, x), None, None


def unary(fwd, grad):
    """The op x -> ``fwd(x)`` with JAX's gradient ``grad(g, out, x)``."""
    return lambda x: _Unary.apply(x, fwd, grad)


# jnp.abs: the gradient at 0 is +g (``select(x >= 0, g, -g)``)
abs_ = unary(torch.abs, lambda g, ans, x: torch.where(x >= 0, g, -g))
sqrt = unary(torch.sqrt, lambda g, ans, x: g * (weak(x, 0.5) / ans))
rsqrt = unary(torch.rsqrt, lambda g, ans, x: g * (weak(x, -0.5) * (ans / x)))
exp = unary(torch.exp, lambda g, ans, x: g * ans)
log = unary(torch.log, lambda g, ans, x: g / x)
log1p = unary(torch.log1p, lambda g, ans, x: g / (x + 1))
expm1 = unary(torch.expm1, lambda g, ans, x: g * (ans + 1))
tanh = unary(torch.tanh, lambda g, ans, x: _tanh_grad(g, ans))
# XLA lowers logistic as 1 / (1 + exp(-x)), each step in x's dtype
sigmoid = unary(lambda x: 1 / (1 + torch.exp(-x)),
                lambda g, ans, x: g * (ans * (1 - ans)))


def _tanh_grad(g, ans):
    c = g * (1 - ans)  # the transpose of (g + g * ans) * (1 - ans)
    return c + c * ans


def _replace_inf(t):
    return torch.where(torch.isinf(t), torch.zeros_like(t), t)


def _softplus_fwd(x):
    """``jnp.logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|)), x + 0
    where x is NaN."""
    body = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x + 0, body)


softplus = unary(_softplus_fwd, lambda g, ans, x: g * torch.exp(
    _replace_inf(x) - _replace_inf(ans)))


class _Div(torch.autograd.Function):
    """x / y with ``lax.div``'s gradient: g / y and -((g * (1 / (y*y)))
    * x), each summed back to its operand's shape."""

    @staticmethod
    def forward(x, y):
        return x / y

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = (g / y).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            gy = (-((g * (1 / (y * y))) * x)).sum_to_size(y.shape)
        return gx, gy


class _Pow(torch.autograd.Function):
    """x ** y (float y) with ``lax.pow``'s gradient: g * (y * x ** (y -
    1)) and g * (log(x, 1 where x == 0) * out)."""

    @staticmethod
    def forward(x, y):
        return torch.pow(x, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, g):
        x, y, ans = ctx.saved_tensors
        gx = gy = None
        if ctx.needs_input_grad[0]:
            gx = (g * (y * torch.pow(x, y - 1))).sum_to_size(x.shape)
        if ctx.needs_input_grad[1]:
            safe = torch.where(x == 0, torch.ones_like(x), x)
            gy = (g * (torch.log(safe) * ans)).sum_to_size(y.shape)
        return gx, gy


def div(x, y):
    """``jnp.divide`` of two tensors of one dtype (ints divide to f32)."""
    if not x.is_floating_point():
        return x / y
    return _Div.apply(x, y)


def pow_(x, y):
    """``jnp.power`` of two float tensors of one dtype."""
    if not x.is_floating_point():
        return torch.pow(x, y)
    return _Pow.apply(x, y)


def clip(x, lo, hi):
    """``jnp.clip``: minimum(hi, maximum(lo, x)) with the bounds in x's
    dtype (0-dim tensors: torch.maximum takes no scalar), so a value at a
    bound gets half the gradient, as jnp's maximum and minimum split a
    tie (``torch.clamp`` passes all of it)."""
    return torch.minimum(x.new_full((), hi),
                         torch.maximum(x.new_full((), lo), x))


def sum_f32(op, *xs, dim=None, keepdim=False):
    """``jnp.sum(op(*xs), ...)`` as XLA computes it: a sum of 16-bit
    floats reduces in f32, and XLA then keeps the op that feeds the sum
    in f32 too (it drops the rounding of op's result to bf16 and back),
    so a bf16 ``op`` runs here on f32 copies of its inputs. The result
    is rounded to the inputs' dtype. ``dim`` None sums everything."""
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    if dtype in (torch.bfloat16, torch.float16):
        xs = [x.float() for x in xs]
    v = op(*xs)
    total = v.sum() if dim is None else v.sum(dim=dim, keepdim=keepdim)
    return total.to(dtype)


def row_sum(op, *xs):
    """``jnp.sum(op(*xs), axis=-1, keepdims=True)`` (``sum_f32``)."""
    return sum_f32(op, *xs, dim=-1, keepdim=True)
