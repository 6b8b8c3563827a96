"""Normalisation ops. Counterpart of ``paddle_tpu/ops/nn_ops.py``, cut to
``layer_norm`` and its hand-written backward (the JAX package's grad_fn:
it reads the forward's Mean/Variance rows instead of keeping an x-hat of
every activation alive for a generic vjp)."""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from .common import maybe, single


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


@register_op("layer_norm", grad_fn=_layer_norm_grad)
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
