"""Optimizers as ops. Counterpart of ``paddle_tpu/ops/optimizer_ops.py``:
``sgd``, ``momentum``, ``adam``, ``adamax``, ``adagrad``,
``decayed_adagrad``, ``adadelta``, ``rmsprop``, ``ftrl``,
``proximal_gd`` and ``proximal_adagrad``, the learning-rate schedules
``lr_schedule`` and ``lr_warmup``, ``model_average_update`` and
``static_prune_mask``. Each returns new tensors for its outputs
(ParamOut, moments, beta powers); the executor writes them back to the
scope over the old ones, which are freed then. Moments update in f32
from an f32 copy of the gradient, as the JAX ops compute them.

A row-sparse gradient (``SelectedRows``, a sparse embedding's) takes
the row rule of ``sgd``, ``momentum``, ``adam`` and ``adagrad``, as in
the JAX package: only the looked-up rows of the parameter and of its
moments are read and written (lazy momentum and Adam: an untouched
row's moments do not decay), through ``core/selected_rows.py``'s
sync-free gathers and scatters. A row rule writes those rows into the
Param and moment tensors in place, where the JAX executor donates them:
the one exception to the ops' rule of returning new tensors, as a new
[V, D] table a step is what the sparse path exists to avoid. Every
reader of the old values runs before the update op in the block, and a
gradient-accumulating program never meets a row rule (its accumulated
gradient is dense). The other update ops densify the gradient
(``_dense_grad``), as the reference has no row kernel for them."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.registry import register_op
from ..core.selected_rows import (SelectedRows, densify, gather_rows,
                                  scatter_rows_, set_rows_)
from .common import out, single, weak


def _dense_grad(ins):
    """The gradient, densified for an update op with no row rule."""
    return densify(single(ins, "Grad"))


@register_op("sgd")
def sgd(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad")
    lr = single(ins, "LearningRate").to(p.dtype).reshape(())
    if isinstance(g, SelectedRows):
        # duplicates add one after the other: no merge needed
        return out(ParamOut=scatter_rows_(p, g, -lr * g.values.to(p.dtype)))
    return out(ParamOut=p - lr * g.to(p.dtype))


@register_op("momentum")
def momentum(attrs, ins):
    """v' = mu * v + g; p' = p - lr * v', or with ``use_nesterov``
    p' = p - lr * (g + mu * v'). Rows: lazy momentum, only the touched
    rows' velocity decays."""
    p = single(ins, "Param")
    g = single(ins, "Grad")
    v = single(ins, "Velocity")
    lr = single(ins, "LearningRate").to(p.dtype).reshape(())
    mu = attrs.get("mu", 0.9)
    nesterov = attrs.get("use_nesterov", False)
    if isinstance(g, SelectedRows):
        m = g.merged()
        gv = m.values.to(p.dtype)
        v_rows = mu * gather_rows(v, m) + gv
        step = (gv + mu * v_rows) * lr if nesterov else lr * v_rows
        return out(ParamOut=scatter_rows_(p, m, -step),
                   VelocityOut=set_rows_(v, m, v_rows))
    g = g.to(p.dtype)
    v_out = mu * v + g
    if nesterov:
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
    if isinstance(g, SelectedRows):
        # lazy Adam: the moments of untouched rows stay as they are
        m = g.merged()
        gv = m.values.float()
        m1_rows = b1 * gather_rows(m1, m) + (1 - b1) * gv
        m2_rows = b2 * gather_rows(m2, m) + (1 - b2) * gv.square()
        step = (lr_t * m1_rows / (torch.sqrt(m2_rows) + eps)).to(p.dtype)
        if wd:  # decays only the touched rows
            step = step + (lr * wd * gather_rows(p, m)).to(p.dtype)
        return {
            "ParamOut": [scatter_rows_(p, m, -step)],
            "Moment1Out": [set_rows_(m1, m, m1_rows)],
            "Moment2Out": [set_rows_(m2, m, m2_rows)],
            "Beta1PowOut": [b1p_acc * b1],
            "Beta2PowOut": [b2p_acc * b2],
        }
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
    g = _dense_grad(ins).float()
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


def _adagrad_rows(p, m, mom, lr, eps):
    """The row rule of adagrad on a merged SelectedRows ``m``: the moment
    accumulates and the parameter steps on the touched rows only."""
    gv = m.values.float()
    mom_rows = gather_rows(mom, m) + gv.square()
    step = (lr * gv / (torch.sqrt(mom_rows) + eps)).to(p.dtype)
    return {"ParamOut": [scatter_rows_(p, m, -step)],
            "MomentOut": [set_rows_(mom, m, mom_rows)]}


def _adagrad_dense(p, g, mom, lr, eps):
    g = g.float()
    mom_out = mom + g.square()
    p_out = p - (lr * g / (torch.sqrt(mom_out) + eps)).to(p.dtype)
    return {"ParamOut": [p_out], "MomentOut": [mom_out]}


@register_op("adagrad")
def adagrad(attrs, ins):
    p = single(ins, "Param")
    g = single(ins, "Grad")
    mom = single(ins, "Moment")
    eps = attrs.get("epsilon", 1e-6)
    if isinstance(g, SelectedRows):
        return _adagrad_rows(p, g.merged(), mom, _lr(ins), eps)
    return _adagrad_dense(p, g, mom, _lr(ins), eps)


@register_op("decayed_adagrad")
def decayed_adagrad(attrs, ins):
    p = single(ins, "Param")
    g = _dense_grad(ins).float()
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom_out = decay * single(ins, "Moment") + (1 - decay) * g.square()
    p_out = p - (_lr(ins) * g / (torch.sqrt(mom_out) + eps)).to(p.dtype)
    return {"ParamOut": [p_out], "MomentOut": [mom_out]}


@register_op("adadelta")
def adadelta(attrs, ins):
    p = single(ins, "Param")
    g = _dense_grad(ins).float()
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
    g = _dense_grad(ins).float()
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
    g = _dense_grad(ins).float()
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
    g = _dense_grad(ins).float()
    lr = _lr(ins)
    p_out = _proximal(p - lr * g, lr, attrs.get("l1", 0.0),
                      attrs.get("l2", 0.0))
    return out(ParamOut=p_out.to(p.dtype))


@register_op("proximal_adagrad")
def proximal_adagrad(attrs, ins):
    p = single(ins, "Param")
    g = _dense_grad(ins).float()
    mom_out = single(ins, "Moment") + g.square()
    lr_t = _lr(ins) / torch.sqrt(mom_out)
    p_out = _proximal(p - lr_t * g, lr_t, attrs.get("l1", 0.0),
                      attrs.get("l2", 0.0))
    return {"ParamOut": [p_out.to(p.dtype)], "MomentOut": [mom_out]}


# ---------------------------------------------------------------------------
# Learning-rate schedules as ops
# ---------------------------------------------------------------------------
# The JAX executor jits the whole block, and XLA rewrites the schedule's
# arithmetic before it runs: a division by a constant becomes a product
# with the constant's f32 reciprocal, a chain of constant factors folds
# into one f32 constant, pow(x, 1) is x and pow(x, 2) is x * x, and on
# the CPU each a * b + c whose product feeds only the sum is one FMA. The
# schedules below compute that form (``_fold``, ``_fma``), which is the
# closed form rounded once less, so that both packages agree to an ulp.
# Nothing leaves the device: the step stays a tensor.
def _fold(*cs):
    """The product of Python constants as XLA folds it: each rounded to
    f32, multiplied in f32 from the left."""
    acc = np.float32(cs[0])
    for c in cs[1:]:
        acc = np.float32(acc * np.float32(c))
    return float(acc)


def _rcp(c):
    """1 / c rounded to f32: XLA's rewrite of a division by c."""
    return float(np.float32(1.0) / np.float32(c))


def _fma(a, b, c):
    """a * b + c rounded once, as one FMA: the f64 product of two f32
    values is exact, and its f64 sum with c is rounded to f32."""
    return (a.double() * b + c).float()


def _pow(x, p):
    """``jnp.power(x, p)`` after XLA's rewrites of pow(x, 1) and
    pow(x, 2)."""
    if p == 1.0:
        return x
    if p == 2.0:
        return x * x
    return torch.pow(x, x.new_full((), p))


@register_op("lr_schedule")
def lr_schedule(attrs, ins):
    """The step's learning rate from GlobalStep, one policy an op:
    ``exponential``, ``natural_exp``, ``inverse_time`` (each with
    ``staircase``), ``polynomial`` (with ``cycle``), ``piecewise``,
    ``noam`` and ``cosine``. Out is [1] f32."""
    step = single(ins, "GlobalStep").reshape(()).float()
    policy = attrs["policy"]
    lr0 = attrs.get("learning_rate", 0.1)
    decay_steps = attrs.get("decay_steps", 1)
    decay_rate = attrs.get("decay_rate", 0.1)
    rcp = _rcp(decay_steps)
    stair = attrs.get("staircase", False)
    t = torch.floor(step * rcp) if stair else None
    if policy == "exponential":
        t = step * rcp if t is None else t
        lr = torch.pow(step.new_full((), decay_rate), t) * weak(step, lr0)
    elif policy == "natural_exp":
        # -rate * (step * rcp) folds to step * (rcp * -rate)
        x = step * _fold(rcp, -decay_rate) if t is None \
            else t * weak(t, -decay_rate)
        lr = torch.exp(x) * weak(step, lr0)
    elif policy == "inverse_time":
        den = _fma(step, _fold(rcp, decay_rate), 1.0) if t is None \
            else _fma(t, weak(t, decay_rate), 1.0)
        lr = step.new_full((), lr0) / den
    elif policy == "polynomial":
        end_lr = attrs.get("end_learning_rate", 1e-4)
        power = attrs.get("power", 1.0)
        if attrs.get("cycle", False):
            ds = torch.clamp_min(torch.ceil(step * rcp), 1.0)
            ds = ds * weak(ds, decay_steps)
            base = 1.0 - torch.minimum(step, ds) / ds
        else:
            # 1 - min(step, ds) * rcp: the product feeds the difference.
            # From step ds on the FMA leaves -2^-25 or so, not 0, and a
            # negative base to a non-integer power is NaN: the JAX package
            # returns NaN there; the port clamps at the closed form's 0
            base = _fma(torch.clamp_max(step, float(decay_steps)), -rcp,
                        1.0)
            if power != int(power):
                base = torch.clamp_min(base, 0.0)
        lr = _fma(_pow(base, power), weak(step, lr0 - end_lr),
                  weak(step, end_lr))
    elif policy == "piecewise":
        # values[i] for i = the count of boundaries at or below the step
        idx = sum((step >= b).int() for b in attrs["boundaries"])
        values = attrs["values"]
        lr = step.new_full((), values[-1])
        for i in range(len(values) - 2, -1, -1):
            lr = torch.where(idx == i, weak(step, values[i]), lr)
    elif policy == "noam":
        warmup = attrs.get("warmup_steps", 4000)
        s = torch.clamp_min(step, 1.0)
        lr = torch.minimum(_pow(s, -0.5), s * weak(s, warmup ** -1.5)) \
            * weak(s, attrs.get("d_model", 512) ** -0.5)
    elif policy == "cosine":
        # lr * ((1 - alpha) * 0.5 * (1 + cos(pi * frac)) + alpha)
        alpha = attrs.get("alpha", 0.0)
        x = torch.clamp_max(step, float(decay_steps)) * _fold(math.pi, rcp)
        c1 = torch.cos(x) + 1.0
        if alpha:
            lr = _fma(c1, _fold(0.5, 1.0 - alpha), weak(c1, alpha)) \
                * weak(c1, lr0)
        else:
            lr = c1 * _fold(0.5, lr0)
    else:
        raise ValueError(f"unknown lr_schedule policy {policy!r}")
    return out(Out=lr.reshape(1))


@register_op("lr_warmup")
def lr_warmup(attrs, ins):
    """A linear warmup over another LR variable: start_lr -> end_lr over
    warmup_steps, then the wrapped schedule's value."""
    lr = single(ins, "LearningRate").reshape(())
    step = single(ins, "GlobalStep").reshape(()).float()
    warmup = float(attrs["warmup_steps"])
    start = attrs.get("start_lr", 0.0)
    end = attrs.get("end_lr", 1.0)
    # start + (end - start) * (step / warmup), its constants folded
    ramp = _fma(step, _fold(end - start, _rcp(warmup)), weak(step, start))
    return out(Out=torch.where(step < warmup, ramp, lr).reshape(1))


@register_op("model_average_update")
def model_average_update(attrs, ins):
    """The windowed parameter average's accumulation (``ModelAverage``):
    Sum1 adds the live parameter each step; when the window fills
    (Num1 >= max_average_window) Sum2/Num2 take the window over and
    Sum1/Num1 restart, by selects (no host branch)."""
    p = single(ins, "Param")
    s1n = single(ins, "Sum1") + p
    n1n = single(ins, "Num1").reshape(()) + 1.0
    n2 = single(ins, "Num2").reshape(())
    roll = n1n >= float(attrs.get("max_average_window", 10000))
    return {
        "Sum1Out": [torch.where(roll, torch.zeros_like(s1n), s1n)],
        "Sum2Out": [torch.where(roll, s1n, single(ins, "Sum2"))],
        "Num1Out": [torch.where(roll, torch.zeros_like(n1n),
                                n1n).reshape(1)],
        "Num2Out": [torch.where(roll, n1n, n2).reshape(1)],
    }


@register_op("static_prune_mask")
def static_prune_mask(attrs, ins):
    """The fixed pruning mask of ``StaticPruningHook``: 1 at the largest
    |w| (1 - sparsity_ratio) share of the weights, by index, so that ties
    (constant-initialised weights) still keep the exact count, the lower
    index first as ``jax.lax.top_k`` keeps them (a stable descending
    sort, where ``torch.topk`` promises no order among ties)."""
    w = single(ins, "Param")
    ratio = float(attrs.get("sparsity_ratio", 0.6))
    flat = w.abs().reshape(-1)
    n = flat.shape[0]
    keep = max(1, int(round(n * (1.0 - ratio))))
    idx = torch.sort(flat, descending=True, stable=True).indices[:keep]
    mask = torch.zeros(n, dtype=w.dtype, device=w.device)
    mask[idx] = 1.0
    return out(Mask=mask.reshape(w.shape))
