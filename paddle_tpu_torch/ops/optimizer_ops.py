"""Optimizers as ops. Counterpart of ``paddle_tpu/ops/optimizer_ops.py``,
cut to dense gradients: ``sgd``, ``momentum``, ``adam``, ``adamax``,
``adagrad``, ``decayed_adagrad``, ``adadelta``, ``rmsprop``, ``ftrl``,
``proximal_gd`` and ``proximal_adagrad`` (row-sparse ``SelectedRows``
gradients are a later slice). Each returns new tensors for its outputs
(ParamOut, moments, beta powers); the executor writes them back to the
scope over the old ones, which are freed then. Moments update in f32
from an f32 copy of the gradient, as the JAX ops compute them."""
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


def _lr(ins):
    return single(ins, "LearningRate").reshape(())


@register_op("adamax")
def adamax(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad").float()
    m = single(ins, "Moment")
    inf_norm = single(ins, "InfNorm")
    b1p_acc = single(ins, "Beta1Pow")  # keep its stored shape
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf_norm, g.abs())
    lr_t = _lr(ins) / (1 - b1p_acc.reshape(()))
    p_out = p - (lr_t * m_out / (inf_out + eps)).to(p.dtype)
    return {"ParamOut": [p_out], "MomentOut": [m_out],
            "InfNormOut": [inf_out], "Beta1PowOut": [b1p_acc * b1]}


@register_op("adagrad")
def adagrad(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad").float()
    mom_out = single(ins, "Moment") + g.square()
    eps = attrs.get("epsilon", 1e-6)
    p_out = p - (_lr(ins) * g / (torch.sqrt(mom_out) + eps)).to(p.dtype)
    return {"ParamOut": [p_out], "MomentOut": [mom_out]}


@register_op("decayed_adagrad")
def decayed_adagrad(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad").float()
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom_out = decay * single(ins, "Moment") + (1 - decay) * g.square()
    p_out = p - (_lr(ins) * g / (torch.sqrt(mom_out) + eps)).to(p.dtype)
    return {"ParamOut": [p_out], "MomentOut": [mom_out]}


@register_op("adadelta")
def adadelta(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad").float()
    avg_sq_upd = single(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asg_out = rho * single(ins, "AvgSquaredGrad") + (1 - rho) * g.square()
    update = -torch.sqrt((avg_sq_upd + eps) / (asg_out + eps)) * g
    asu_out = rho * avg_sq_upd + (1 - rho) * update.square()
    return {"ParamOut": [p + update.to(p.dtype)],
            "AvgSquaredGradOut": [asg_out],
            "AvgSquaredUpdateOut": [asu_out]}


@register_op("rmsprop")
def rmsprop(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad").float()
    rho = attrs.get("decay", 0.9)
    eps = attrs.get("epsilon", 1e-10)
    ms_out = rho * single(ins, "MeanSquare") + (1 - rho) * g.square()
    mom_out = (attrs.get("momentum", 0.0) * single(ins, "Moment")
               + _lr(ins) * g / torch.sqrt(ms_out + eps))
    return {"ParamOut": [p - mom_out.to(p.dtype)],
            "MomentOut": [mom_out], "MeanSquareOut": [ms_out]}


@register_op("ftrl")
def ftrl(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad").float()
    sq_acc = single(ins, "SquaredAccumulator")
    lr = _lr(ins)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq_acc + g.square()
    sigma = (torch.pow(new_sq, -power) - torch.pow(sq_acc, -power)) / lr
    new_lin = single(ins, "LinearAccumulator") + g - sigma * p
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    denom = torch.pow(new_sq, -power) / lr + 2 * l2
    return {"ParamOut": [(pre / denom).to(p.dtype)],
            "SquaredAccumOut": [new_sq], "LinearAccumOut": [new_lin]}


def _proximal(prox, lr, l1, l2):
    """The proximal step's soft threshold and shrink."""
    return (torch.sign(prox) * torch.clamp(prox.abs() - lr * l1, min=0.0)
            / (1.0 + lr * l2))


@register_op("proximal_gd")
def proximal_gd(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad").float()
    lr = _lr(ins)
    p_out = _proximal(p - lr * g, lr, attrs.get("l1", 0.0),
                      attrs.get("l2", 0.0))
    return out(ParamOut=p_out.to(p.dtype))


@register_op("proximal_adagrad")
def proximal_adagrad(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad").float()
    mom_out = single(ins, "Moment") + g.square()
    lr_t = _lr(ins) / torch.sqrt(mom_out)
    p_out = _proximal(p - lr_t * g, lr_t, attrs.get("l1", 0.0),
                      attrs.get("l2", 0.0))
    return {"ParamOut": [p_out.to(p.dtype)], "MomentOut": [mom_out]}
