"""Fused epilogue ops: 1x1-conv + BN + activation (+ residual) as one op.

Counterpart of ``paddle_tpu/ops/fusion_ops.py``. Only the NHWC
1x1/stride-1/pad-0 form exists; the model layer (``models/resnet.py``
``_conv_bn``) builds it under ``--fused_conv_epilogue`` and the separate
conv2d/batch_norm/elementwise_add ops otherwise. The forward runs the
kernels of ``kernels/conv_epilogue.py`` (sm_90a CUDA on the card, their
plain versions on the CPU); the backward is plain torch, as the JAX
package leaves it to XLA. Under AMP (``ops/common.py``) x and W enter the
kernels in bf16 and Y leaves in X's dtype; the gradient products take
bf16 operands too, as the JAX op casts them.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..kernels import conv_epilogue as ke
from .common import amp_cast, matmul, maybe, out, single


def _affine_from_stats(scale, bias, mean, var, eps):
    """Fold (gamma, beta, mean, var) into the elementwise (k, b):
    y = xhat*gamma + beta = x*k + b with k = gamma*rsqrt(var+eps)."""
    inv = torch.rsqrt(var.float() + eps)
    k = scale.float() * inv
    b = bias.float() - mean.float() * k
    return k, b, inv


def conv1x1_bn_act(attrs, ins):
    """Fused y = act(BN(x @ W) [+ residual]) for NHWC 1x1 convs.

    Training: ``conv1x1_stats`` computes the conv output and the BN batch
    statistics in one pass, then ``scale_shift_act`` applies the folded
    affine, residual and activation. ConvOut (the raw conv output) is a
    real output, so the backward reads it instead of recomputing the
    product. Inference: ``conv1x1_epilogue`` alone; the raw conv output
    never reaches device memory. The outputs mirror batch_norm's
    (MeanOut/VarianceOut alias the running stats; SavedMean/SavedVariance
    are the batch mean and inverse std)."""
    x = single(ins, "X")            # [B, H, W, I]
    w = single(ins, "Filter")       # [1, 1, I, O] (HWIO) or [I, O]
    scale = single(ins, "Scale")
    bias = single(ins, "Bias")
    mean = single(ins, "Mean")
    var = single(ins, "Variance")
    res = maybe(ins, "Residual")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    act = attrs.get("act") or None

    B, H, W_, I = x.shape
    wm = w.reshape(w.shape[-2], w.shape[-1])
    O = wm.shape[-1]
    x2, wm = amp_cast(x.reshape(B * H * W_, I), wm)
    res2 = None if res is None else res.reshape(B * H * W_, O)

    if attrs.get("is_test", False):
        k, b, inv = _affine_from_stats(scale, bias, mean, var, eps)
        y2 = ke.conv1x1_epilogue(x2, wm, k, b, residual=res2, act=act)
        return out(Y=y2.reshape(B, H, W_, O).to(x.dtype),
                   MeanOut=mean, VarianceOut=var, SavedMean=mean,
                   SavedVariance=torch.rsqrt(var.float() + eps)
                   .to(var.dtype),
                   ConvOut=torch.zeros((1, 1), dtype=x.dtype,
                                       device=x.device))

    y_raw2, stats = ke.conv1x1_stats(x2, wm)
    n = x2.shape[0]
    bmean = stats[0] / n
    bvar = torch.clamp_min(stats[1] / n - bmean * bmean, 0.0)
    k, b, inv = _affine_from_stats(scale, bias, bmean, bvar, eps)
    y2 = ke.scale_shift_act(y_raw2, k, b, residual=res2, act=act)
    mean_out = momentum * mean.float() + (1 - momentum) * bmean
    var_out = momentum * var.float() + (1 - momentum) * bvar
    return out(Y=y2.reshape(B, H, W_, O).to(x.dtype),
               MeanOut=mean_out.to(mean.dtype),
               VarianceOut=var_out.to(var.dtype),
               SavedMean=bmean.to(mean.dtype),
               SavedVariance=inv.to(var.dtype),
               ConvOut=y_raw2.reshape(B, H, W_, O))


def _conv1x1_bn_act_grad(attrs, ins, outs, ogs):
    """Plain backward of the fused op: relu mask -> BN backward over the
    saved raw conv output -> the two gradient products (``matmul``, in
    the precision policy's math, outside any kernel, as the JAX package
    leaves them to XLA)."""
    x = single(ins, "X")
    w = single(ins, "Filter")
    scale = single(ins, "Scale")
    res = maybe(ins, "Residual")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    act = attrs.get("act") or None
    is_test = attrs.get("is_test", False)

    dy = ogs.get("Y", [None])[0]
    gm = ogs.get("MeanOut", [None])[0]
    gv = ogs.get("VarianceOut", [None])[0]
    y = outs.get("Y", [None])[0]
    if dy is None:
        raise NotImplementedError("conv1x1_bn_act grad needs dY")

    B, H, W_, I = x.shape
    wm = w.reshape(w.shape[-2], w.shape[-1])
    O = wm.shape[-1]
    n = B * H * W_
    x2 = x.reshape(n, I)
    dy2 = dy.reshape(n, O).float()
    if act == "relu":
        dy2 = dy2 * (y.reshape(n, O) > 0)
    dres = None if res is None else dy2.to(res.dtype).reshape(res.shape)

    sm = outs["SavedMean"][0].float()
    inv = outs["SavedVariance"][0].float()
    sc = scale.float()
    if is_test:
        # the inference forward never materialised the raw conv output
        # (that is its point): recompute it for the scale/bias grads, as
        # the kernel computes it (f32 product of the cast operands)
        x2c, wmc = amp_cast(x2, wm)
        y_raw2 = matmul(x2c.float(), wmc.float())
        dz = dy2 * (sc * inv)
        xhat = (y_raw2 - sm) * inv
        dscale = (dy2 * xhat).sum(0)
        dbias = dy2.sum(0)
    else:
        y_raw2 = outs["ConvOut"][0].reshape(n, O).float()
        xhat = (y_raw2 - sm) * inv
        dbias = dy2.sum(0)
        dscale = (dy2 * xhat).sum(0)
        dz = (sc * inv) * (dy2 - (dbias + xhat * dscale) / n)
        # running-stat update cotangents flow into y_raw through the
        # batch statistics, and into the Mean/Variance state inputs
        if gm is not None:
            dz = dz + ((1.0 - momentum) / n) * gm.float()
        if gv is not None:
            dz = dz + ((1.0 - momentum) * 2.0 / n) * gv.float() \
                * (y_raw2 - sm)
    x2c, dzc = amp_cast(x2, dz.to(x.dtype))
    wmc = amp_cast(wm)
    dx2 = matmul(dzc, wmc.t())
    dw2 = matmul(x2c.t(), dzc)
    grads = {"X": [dx2.reshape(x.shape).to(x.dtype)],
             "Filter": [dw2.reshape(w.shape).to(w.dtype)],
             "Scale": [dscale.to(scale.dtype)],
             "Bias": [dbias.to(scale.dtype)]}
    if dres is not None:
        grads["Residual"] = [dres]
    if not is_test:
        mean_in = single(ins, "Mean")
        var_in = single(ins, "Variance")
        if gm is not None:
            grads["Mean"] = [(momentum * gm.float()).to(mean_in.dtype)]
        if gv is not None:
            grads["Variance"] = [(momentum * gv.float()).to(var_in.dtype)]
    return grads


register_op("conv1x1_bn_act", conv1x1_bn_act,
            grad_fn=_conv1x1_bn_act_grad,
            optional_inputs=("Residual",))
