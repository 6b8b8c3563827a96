"""Optimizers as ops. Counterpart of ``paddle_tpu/ops/optimizer_ops.py``,
cut to dense ``sgd``, ``momentum`` and ``adam``. Each returns new tensors for its
outputs (ParamOut, moments, beta powers); the executor writes them back
to the scope over the old ones, which are freed then."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import out, single


@register_op("sgd")
def sgd(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad")
    lr = single(ins, "LearningRate").to(p.dtype).reshape(())
    return out(ParamOut=p - lr * g.to(p.dtype))


@register_op("momentum")
def momentum(attrs, ins):
    """v' = mu * v + g; p' = p - lr * v', or with ``use_nesterov``
    p' = p - lr * (g + mu * v')."""
    p = single(ins, "Param")
    g = single(ins, "Grad").to(p.dtype)
    v = single(ins, "Velocity")
    lr = single(ins, "LearningRate").to(p.dtype).reshape(())
    mu = attrs.get("mu", 0.9)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return out(ParamOut=p_out, VelocityOut=v_out)


@register_op("adam")
def adam(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad")
    m1 = single(ins, "Moment1")
    m2 = single(ins, "Moment2")
    b1p_acc = single(ins, "Beta1Pow")
    b2p_acc = single(ins, "Beta2Pow")
    b1p = b1p_acc.reshape(())
    b2p = b2p_acc.reshape(())
    lr = single(ins, "LearningRate").reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    wd = attrs.get("weight_decay", 0.0)  # decoupled (AdamW), outside moments
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    g = g.float()
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g.square()
    p_out = p - (lr_t * m1_out / (torch.sqrt(m2_out) + eps)).to(p.dtype)
    if wd:
        p_out = p_out - (lr * wd * p).to(p.dtype)
    return {
        "ParamOut": [p_out],
        "Moment1Out": [m1_out],
        "Moment2Out": [m2_out],
        "Beta1PowOut": [b1p_acc * b1],
        "Beta2PowOut": [b2p_acc * b2],
    }
