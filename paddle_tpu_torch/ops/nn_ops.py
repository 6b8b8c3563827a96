"""Neural-net structural ops. Counterpart of ``paddle_tpu/ops/nn_ops.py``,
cut to ``conv2d``, ``depthwise_conv2d``, ``pool2d``, ``batch_norm``,
``layer_norm``, ``rms_norm``, ``lrn`` and ``dropout``, the first three
norms with their hand-written backwards
(the JAX package's grad_fns: they read the forward's saved statistics instead of keeping an x-hat of
every activation alive for a generic vjp).

Layout: the ops take the JAX package's ``data_format`` attr, NCHW (OIHW
filters) or NHWC (HWIO filters), and keep that layout at their boundary;
inside, an NHWC tensor is handed to torch's NCHW kernels as a permuted
view (``channels_last`` in memory), so no layout copy is made.

Under AMP (``ops/common.py``) ``conv2d`` casts its input and filter to
bf16 and returns bf16; ``pool2d`` keeps its input's dtype; the norms
reduce in f32 and return their input's dtype, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core import prng
from ..core.registry import register_op
from .common import (amp_cast, full_f32_convolutions, library_precision,
                     matmul, maybe, normalize_pair, out, precision_mode,
                     single)


# --- conv2d -------------------------------------------------------------------
def _conv_precision(tf32):
    """cuDNN's math for an f32 convolution: TF32 under the ``default``
    policy on the card, full f32 otherwise."""
    return library_precision(True) if tf32 else full_f32_convolutions()


class _Conv2dF32(torch.autograd.Function):
    """``F.conv2d`` over NCHW tensors (no bias) whose forward and backward
    both run in the precision the policy gave the forward (``tf32``):
    the generic grad op differentiates the op after the forward's
    context has closed, so the backward sets it again itself. (bf16
    operands under AMP are not affected: cuDNN accumulates them in
    f32.)"""

    @staticmethod
    def forward(x, w, stride, padding, dilation, groups, tf32):
        with _conv_precision(tf32):
            return F.conv2d(x, w, None, stride, padding, dilation, groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, *conf, tf32 = inputs
        ctx.save_for_backward(x, w)
        ctx.conf, ctx.tf32 = conf, tf32

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        with _conv_precision(ctx.tf32):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, stride, padding, dilation, False, [0, 0],
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                         False])
        return gx, gw, None, None, None, None, None


@register_op("conv2d")
def conv2d(attrs, ins):
    """2-D convolution in f32 by the precision policy (``ops/common.py``;
    bf16 operands and output under AMP). A 1x1/stride-1 conv is a matmul
    over [B*H*W, I], as the JAX op lowers it (``dot_general``); every
    other shape is ``F.conv2d`` (cuDNN on the card), TF32 under
    ``default`` and full f32 under ``high`` and ``highest``."""
    x, w = amp_cast(single(ins, "Input"), single(ins, "Filter"))
    fmt = attrs.get("data_format", "NCHW")
    strides = normalize_pair(attrs.get("strides", [1, 1]))
    pads = normalize_pair(attrs.get("paddings", [0, 0]))
    dilations = normalize_pair(attrs.get("dilations", [1, 1]))
    groups = attrs.get("groups", 1)
    k_hw = tuple(w.shape[:2]) if fmt == "NHWC" else tuple(w.shape[2:])
    if k_hw == (1, 1) and strides == [1, 1] and pads == [0, 0] \
            and groups == 1:
        if fmt == "NHWC":
            B, H, W_, I = x.shape
            wm = w.reshape(w.shape[2], w.shape[3])  # HWIO -> [I, O]
            y = matmul(x.reshape(B * H * W_, I), wm)
            return out(Output=y.reshape(B, H, W_, -1))
        wm = w.reshape(w.shape[0], w.shape[1])  # OIHW -> [O, I]
        y = matmul(x.movedim(1, -1), wm.t())  # [B, H, W, O]
        return out(Output=y.movedim(-1, 1))
    tf32 = precision_mode(x, w) == "tf32"
    if fmt == "NHWC":
        y = _Conv2dF32.apply(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                             strides, pads, dilations, groups, tf32)
        return out(Output=y.permute(0, 2, 3, 1))
    return out(Output=_Conv2dF32.apply(x, w, strides, pads, dilations,
                                       groups, tf32))


@register_op("depthwise_conv2d")
def depthwise_conv2d(attrs, ins):
    """``conv2d`` with one group a channel of the input."""
    fmt = attrs.get("data_format", "NCHW")
    x = single(ins, "Input")
    return conv2d(dict(attrs, groups=x.shape[1 if fmt == "NCHW" else -1]),
                  ins)


# --- pool2d -------------------------------------------------------------------
def _ceil_pads(x_hw, ksize, strides, pads):
    """(lo, hi) padding per spatial dim that realises the legacy ceil_mode
    output size ceil((I + 2p - F) / S) + 1, clamped so the last window
    starts inside the (user-padded) input, as the JAX op computes it."""
    result = []
    for i_dim, f, s, p in zip(x_hw, ksize, strides, pads):
        out_dim = -(-(i_dim + 2 * p - f) // s) + 1
        if (out_dim - 1) * s >= i_dim + p:
            out_dim -= 1
        need = (out_dim - 1) * s + f - (i_dim + 2 * p)
        result.append((p, p + max(0, need)))
    return result


def _pool_nchw(x, ptype, ksize, strides, pads, ceil_mode, exclusive):
    """Max (-inf padding) or average pooling over an NCHW tensor with the
    JAX op's semantics: an exclusive average divides by the window's
    cells inside the input, a non-exclusive one by the window's size."""
    area = ksize[0] * ksize[1]
    if all(p <= k // 2 for p, k in zip(pads, ksize)):
        # torch's implicit padding is -inf for max and its ceil_mode
        # output size and clamp are the legacy rule the JAX op applies
        if ptype == "max":
            return F.max_pool2d(x, ksize, strides, pads, ceil_mode=ceil_mode)
        if exclusive:
            return F.avg_pool2d(x, ksize, strides, pads, ceil_mode=ceil_mode,
                                count_include_pad=False)
        return F.avg_pool2d(x, ksize, strides, pads, ceil_mode=ceil_mode,
                            divisor_override=area)
    # padding wider than half the window: pad explicitly
    hw = tuple(x.shape[2:])
    lohi = (_ceil_pads(hw, ksize, strides, pads) if ceil_mode
            else [(p, p) for p in pads])
    spec = (lohi[1][0], lohi[1][1], lohi[0][0], lohi[0][1])
    if ptype == "max":
        return F.max_pool2d(F.pad(x, spec, value=-math.inf), ksize, strides)
    s = F.avg_pool2d(F.pad(x, spec), ksize, strides, divisor_override=1)
    if not exclusive:
        return s / area
    ones = torch.ones((1, 1) + hw, dtype=x.dtype, device=x.device)
    cnt = F.avg_pool2d(F.pad(ones, spec), ksize, strides, divisor_override=1)
    return s / cnt


@register_op("pool2d")
def pool2d(attrs, ins):
    x = single(ins, "X")
    fmt = attrs.get("data_format", "NCHW")
    ptype = attrs.get("pooling_type", "max")
    xc = x.permute(0, 3, 1, 2) if fmt == "NHWC" else x  # NCHW view
    if attrs.get("global_pooling", False):
        if ptype == "max":
            # one window over the whole plane: its gradient goes to the
            # first maximum, as JAX's reduce_window max sends it (amax
            # would split it among tied maxima)
            y = F.max_pool2d(xc, tuple(xc.shape[2:]))
        else:
            y = xc.sum(dim=(2, 3), keepdim=True) / (xc.shape[2]
                                                     * xc.shape[3])
    else:
        y = _pool_nchw(xc, ptype,
                       normalize_pair(attrs.get("ksize", [2, 2])),
                       normalize_pair(attrs.get("strides", [1, 1])),
                       normalize_pair(attrs.get("paddings", [0, 0])),
                       attrs.get("ceil_mode", False),
                       attrs.get("exclusive", True))
    y = y.to(x.dtype)
    return out(Out=y.permute(0, 2, 3, 1) if fmt == "NHWC" else y)


# --- batch_norm -----------------------------------------------------------------
def _bn_axes(fmt, ndim):
    """(reduce axes, per-channel broadcast shape) for a BN input layout."""
    if fmt == "NCHW" and ndim == 4:
        return (0, 2, 3), (1, -1, 1, 1)
    if ndim == 4:  # NHWC
        return (0, 1, 2), (1, 1, 1, -1)
    return (0,), (1, -1)  # 2-D [N, C]


def _batch_norm_grad(attrs, ins, outs, ogs):
    """Hand-written BN backward (the reference's batch_norm_grad
    formulas): x-hat is rebuilt from the saved per-channel statistics
    (``x*inv - mean*inv``), every reduction in f32. Every stat output is
    a differentiable function of the inputs too (MeanOut/VarianceOut the
    running-stat update or, in test mode, aliases of the running stats;
    SavedMean the batch mean, SavedVariance the batch inverse std), and
    their cotangents flow."""
    x = single(ins, "X")
    scale = single(ins, "Scale")
    gm = ogs.get("MeanOut", [None])[0]
    gv = ogs.get("VarianceOut", [None])[0]
    gsm = ogs.get("SavedMean", [None])[0]
    gsv = ogs.get("SavedVariance", [None])[0]
    dy = ogs.get("Y", [None])[0]
    if all(g is None for g in (dy, gm, gv, gsm, gsv)):
        raise NotImplementedError("batch_norm grad with no output grads")
    momentum = attrs.get("momentum", 0.9)
    fmt = attrs.get("data_layout", attrs.get("data_format", "NCHW"))
    axes, bshape = _bn_axes(fmt, x.ndim)
    eps = attrs.get("epsilon", 1e-5)
    sm = outs.get("SavedMean", [None])[0]
    sv = outs.get("SavedVariance", [None])[0]
    is_test = attrs.get("is_test", False)
    if is_test:
        mean = single(ins, "Mean").float()
        inv = torch.rsqrt(single(ins, "Variance").float() + eps)
    elif sm is not None and sv is not None:
        mean = sm.float()
        inv = sv.float()  # the forward saves 1/sqrt(var+eps)
    else:
        xf = x.float()
        mean = xf.mean(dim=axes)
        bvar = (xf * xf).mean(dim=axes) - mean * mean
        inv = torch.rsqrt(bvar + eps)
    xhat = x.float() * inv.reshape(bshape) - (mean * inv).reshape(bshape)
    if dy is not None:
        dyf = dy.float()
        dbias = dyf.sum(dim=axes)
        dscale = (dyf * xhat).sum(dim=axes)
    else:
        dyf = None
        dbias = dscale = torch.zeros(scale.shape, dtype=torch.float32,
                                     device=x.device)
    k = (scale.float() * inv).reshape(bshape)
    grads = {"Scale": [dscale.to(scale.dtype)],
             "Bias": [dbias.to(single(ins, "Bias").dtype)]}
    sc = scale.float()
    dmean_in = dvar_in = None
    if is_test:
        # the running stats are inputs here, and Y depends on them:
        # dY/dMean = -scale*inv, dY/dVar = -(x-mean)*scale*inv^3/2
        dx = dyf * k if dyf is not None else torch.zeros_like(x)
        dmean_in = -sc * inv * dbias
        dvar_in = -0.5 * sc * inv * inv * dscale
        if gm is not None:
            dmean_in = dmean_in + gm.float()
        if gv is not None:
            dvar_in = dvar_in + gv.float()
        if gsm is not None:
            dmean_in = dmean_in + gsm.float()
        if gsv is not None:
            dvar_in = dvar_in - 0.5 * (inv ** 3) * gsv.float()
    else:
        n = x.numel() // scale.numel()
        if dyf is not None:
            dx = k * (dyf - (dbias.reshape(bshape)
                             + xhat * dscale.reshape(bshape)) / n)
        else:
            dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        # mean_out/var_out = momentum*old + (1-momentum)*batch_stat
        if gm is not None:
            gmf = gm.float()
            dx = dx + ((1.0 - momentum) / n) * gmf.reshape(bshape)
            dmean_in = momentum * gmf
        if gv is not None:
            gvf = gv.float()
            dx = dx + ((1.0 - momentum) * 2.0 / n) * gvf.reshape(bshape) \
                * (xhat / inv.reshape(bshape))
            dvar_in = momentum * gvf
        if gsm is not None:
            dx = dx + gsm.float().reshape(bshape) / n
        if gsv is not None:
            dx = dx - ((inv ** 3).reshape(bshape) / n) \
                * gsv.float().reshape(bshape) * (xhat / inv.reshape(bshape))
    if dmean_in is not None:
        grads["Mean"] = [dmean_in.to(single(ins, "Mean").dtype)]
    if dvar_in is not None:
        grads["Variance"] = [dvar_in.to(single(ins, "Variance").dtype)]
    grads["X"] = [dx.to(x.dtype)]
    return grads


@register_op("batch_norm", grad_fn=_batch_norm_grad,
             grad_fn_is_optimization=True)
def batch_norm(attrs, ins):
    """Training: normalise with the batch statistics (variance as
    E[x^2] - mean^2) and return the running Mean/Variance updated with
    ``momentum``; test: normalise with the running statistics. The layer
    names MeanOut/VarianceOut after Mean/Variance, so the executor's
    write-back performs the reference's in-place update."""
    x = single(ins, "X")
    scale = single(ins, "Scale")
    bias = single(ins, "Bias")
    mean = single(ins, "Mean")
    var = single(ins, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    fmt = attrs.get("data_layout", attrs.get("data_format", "NCHW"))
    axes, bshape = _bn_axes(fmt, x.ndim)
    xf = x.float()
    if attrs.get("is_test", False):
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
        saved_mean = mean
        saved_inv_std = torch.rsqrt(var + eps)
    else:
        bmean = xf.mean(dim=axes)
        bvar = (xf * xf).mean(dim=axes) - bmean * bmean
        use_mean, use_var = bmean, bvar
        mean_out = momentum * mean + (1 - momentum) * bmean
        var_out = momentum * var + (1 - momentum) * bvar
        saved_mean = bmean
        saved_inv_std = torch.rsqrt(bvar + eps)
    inv = torch.rsqrt(use_var + eps)
    y = (xf - use_mean.reshape(bshape)) * (inv * scale).reshape(bshape) \
        + bias.reshape(bshape)
    return out(Y=y.to(x.dtype), MeanOut=mean_out, VarianceOut=var_out,
               SavedMean=saved_mean, SavedVariance=saved_inv_std)


# --- layer_norm -----------------------------------------------------------------


def _layer_norm_grad(attrs, ins, outs, ogs):
    x = single(ins, "X")
    scale = maybe(ins, "Scale")
    bias = maybe(ins, "Bias")
    gmean = ogs.get("Mean", [None])[0]
    gvar = ogs.get("Variance", [None])[0]
    dy = ogs.get("Y", [None])[0]
    if dy is None and gmean is None and gvar is None:
        raise NotImplementedError("layer_norm grad with no output grads")
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    kshape = tuple(x.shape[:begin]) + (1,) * (x.ndim - begin)
    m = outs.get("Mean", [None])[0]
    v = outs.get("Variance", [None])[0]
    xf = x.float()
    if m is not None and v is not None:
        meanb = m.float().reshape(kshape)
        varb = v.float().reshape(kshape)
    else:
        meanb = xf.mean(dim=axes, keepdim=True)
        varb = (xf - meanb).square().mean(dim=axes, keepdim=True)
    inv = torch.rsqrt(varb + eps)
    xhat = xf * inv - meanb * inv
    norm_shape = tuple(x.shape[begin:])
    nn = math.prod(norm_shape)
    grads = {}
    if dy is not None:
        dyf = dy.float()
        if scale is not None:
            dxhat = dyf * scale.float().reshape((1,) * begin + norm_shape)
        else:
            dxhat = dyf
        m1 = dxhat.mean(dim=axes, keepdim=True)
        m2 = (dxhat * xhat).mean(dim=axes, keepdim=True)
        dx = inv * (dxhat - m1 - xhat * m2)
        batch_axes = tuple(range(begin))
        if scale is not None:
            grads["Scale"] = [(dyf * xhat).sum(dim=batch_axes)
                              .reshape(scale.shape).to(scale.dtype)]
        if bias is not None:
            grads["Bias"] = [dyf.sum(dim=batch_axes)
                             .reshape(bias.shape).to(bias.dtype)]
    else:
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    # Mean/Variance outputs are plain differentiable functions of X
    if gmean is not None:
        dx = dx + gmean.float().reshape(kshape) / nn
    if gvar is not None:
        dx = dx + gvar.float().reshape(kshape) * (2.0 / nn) * (xhat / inv)
    grads["X"] = [dx.to(x.dtype)]
    return grads


@register_op("layer_norm", grad_fn=_layer_norm_grad,
             grad_fn_is_optimization=True)
def layer_norm(attrs, ins):
    x = single(ins, "X")
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    scale = maybe(ins, "Scale")
    bias = maybe(ins, "Bias")
    norm_shape = tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape((1,) * begin + norm_shape)
    if bias is not None:
        y = y + bias.reshape((1,) * begin + norm_shape)
    return {
        "Y": [y.to(x.dtype)],
        "Mean": [mean.reshape(x.shape[:begin])],
        "Variance": [var.reshape(x.shape[:begin])],
    }


# --- rms_norm -------------------------------------------------------------------
def _rms_norm_grad(attrs, ins, outs, ogs):
    """RMSNorm's backward, as the JAX package's: f32 reductions over the
    saved InvRms, dx = inv * (dxhat - xhat * mean(dxhat * xhat))."""
    x = single(ins, "X")
    scale = maybe(ins, "Scale")
    bias = maybe(ins, "Bias")
    ginv = ogs.get("InvRms", [None])[0]
    dy = ogs.get("Y", [None])[0]
    if dy is None and ginv is None:
        raise NotImplementedError("rms_norm grad with no output grads")
    eps = attrs.get("epsilon", 1e-6)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    kshape = tuple(x.shape[:begin]) + (1,) * (x.ndim - begin)
    xf = x.float()
    iv = outs.get("InvRms", [None])[0]
    if iv is not None:
        inv = iv.float().reshape(kshape)
    else:
        inv = torch.rsqrt(xf.square().mean(dim=axes, keepdim=True) + eps)
    xhat = xf * inv
    norm_shape = tuple(x.shape[begin:])
    grads = {}
    if dy is not None:
        dyf = dy.float()
        if scale is not None:
            dxhat = dyf * scale.float().reshape((1,) * begin + norm_shape)
        else:
            dxhat = dyf
        m = (dxhat * xhat).mean(dim=axes, keepdim=True)
        dx = inv * (dxhat - xhat * m)
        batch_axes = tuple(range(begin))
        if scale is not None:
            grads["Scale"] = [(dyf * xhat).sum(dim=batch_axes)
                              .reshape(scale.shape).to(scale.dtype)]
        if bias is not None:
            grads["Bias"] = [dyf.sum(dim=batch_axes)
                             .reshape(bias.shape).to(bias.dtype)]
    else:
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    # InvRms is differentiable too: d inv/dx = -inv^3 * x / n
    if ginv is not None:
        dx = dx + (ginv.float().reshape(kshape) * (-(inv ** 3)) * xf
                   / math.prod(norm_shape))
    grads["X"] = [dx.to(x.dtype)]
    return grads


@register_op("rms_norm", grad_fn=_rms_norm_grad,
             grad_fn_is_optimization=True,
             optional_inputs=("Scale", "Bias"))
def rms_norm(attrs, ins):
    """Root-mean-square normalization, reduced in f32: y = x *
    rsqrt(mean(x^2) + eps) * scale (+ bias), in x's dtype; InvRms f32."""
    x = single(ins, "X")
    eps = attrs.get("epsilon", 1e-6)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.ndim))
    xf = x.float()
    inv = torch.rsqrt(xf.square().mean(dim=axes, keepdim=True) + eps)
    y = xf * inv
    scale = maybe(ins, "Scale")
    bias = maybe(ins, "Bias")
    norm_shape = tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape((1,) * begin + norm_shape)
    if bias is not None:
        y = y + bias.reshape((1,) * begin + norm_shape)
    return {"Y": [y.to(x.dtype)], "InvRms": [inv.reshape(x.shape[:begin])]}


# --- lrn ----------------------------------------------------------------------
@register_op("lrn")
def lrn(attrs, ins):
    """Local response normalisation across channels: Out = x / MidOut **
    beta with MidOut = k + alpha * (the sum of x^2 over the n channels
    centred on each, zero past the edges), the n shifted slices added in
    the JAX op's order, in x's dtype. The channel axis follows
    ``data_format``. No grad_fn: the backward is autograd's, as the JAX
    op's is the vjp of its forward."""
    x = single(ins, "X")
    n = attrs.get("n", 5)
    k = attrs.get("k", 2.0)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    axis = 3 if attrs.get("data_format", "NCHW") == "NHWC" else 1
    nch = x.shape[axis]
    half = n // 2
    pad = [0, 0] * (x.ndim - 1 - axis) + [half, half]
    sq = F.pad(x.square(), pad)
    acc = sq.narrow(axis, 0, nch)
    for i in range(1, n):
        acc = acc + sq.narrow(axis, i, nch)
    mid = k + alpha * acc
    return out(Out=x / torch.pow(mid, beta), MidOut=mid)


# --- dropout ------------------------------------------------------------------
def _dropout_grad(attrs, ins, outs, ogs):
    mask = outs["Mask"][0]
    og = ogs["Out"][0]
    return {"X": [og * mask.to(og.dtype)]}


@register_op("dropout", needs_rng=True, grad_fn=_dropout_grad)
def dropout(attrs, ins, rng):
    """Training: keep each element with probability 1 - p (a
    ``bernoulli`` mask from the op's split of the scope key, equal to
    JAX's), no rescale. ``is_test``: downscale-in-infer, x * (1 - p)."""
    x = single(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("is_test", False):
        keep = torch.tensor(1.0 - p, dtype=x.dtype)
        return {"Out": [x * keep], "Mask": [torch.ones_like(x)]}
    keep = prng.bernoulli(rng, 1.0 - p, tuple(x.shape))
    return {"Out": [torch.where(keep, x, torch.zeros_like(x))],
            "Mask": [keep.to(x.dtype)]}
