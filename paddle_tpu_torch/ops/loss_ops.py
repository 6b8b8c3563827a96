"""Loss ops. Counterpart of ``paddle_tpu/ops/loss_ops.py``: every loss
but ``fused_head_cross_entropy``, which comes with the chunked LM head.
``softmax_with_cross_entropy`` has its fused gradient (softmax - onehot)
* dLoss. The others are written op by op as the JAX package writes them,
with each Python constant rounded to the operand's dtype
(``common.weak``), a bf16 operand against an f32 one promoted to f32 as
jnp promotes, and the gradient of ``abs`` and ``maximum`` at a tie as
JAX's (``common.abs_``; ``torch.maximum`` splits a tie as ``jnp.maximum``
does), so ``sigmoid_cross_entropy_with_logits`` at x = 0 differentiates
to -label in both packages."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from . import common as C
from .common import maybe, out, single, weak


def _take_label_prob(x, label):
    """Per-row value at the integer label along the last (class) axis."""
    lab = label.reshape(x.shape[:-1])[..., None].long()
    return torch.gather(x, -1, lab)


def _softmax_with_ce_grad(attrs, ins, outs, ogs):
    """d_logits = (softmax - target) * dLoss, in the logits dtype."""
    logits = single(ins, "Logits")
    label = single(ins, "Label")
    sm = torch.softmax(logits.float(), dim=-1)
    if attrs.get("soft_label", False):
        grad = sm - label.float()
    else:
        eps = attrs.get("label_smoothing", 0.0)
        lab = label.reshape(logits.shape[:-1])[..., None].long()
        if eps:
            # smoothed target: (1-eps)*onehot + eps/V uniform mass
            onehot = torch.zeros_like(sm).scatter_(-1, lab, 1.0)
            grad = sm - ((1.0 - eps) * onehot + eps / logits.shape[-1])
        else:
            grad = sm.scatter_add(-1, lab, torch.full_like(lab, -1.0,
                                                           dtype=sm.dtype))
    dy = ogs["Loss"][0].float()
    return {"Logits": [(grad * dy).to(logits.dtype)], "Label": [None]}


@register_op("softmax_with_cross_entropy", grad_fn=_softmax_with_ce_grad)
def softmax_with_cross_entropy(attrs, ins):
    """Loss rows in f32 through the logsumexp form; Softmax = exp(x - lse)."""
    logits = single(ins, "Logits")
    label = single(ins, "Label")
    x = logits.float()
    mx = x.amax(dim=-1, keepdim=True).detach()
    lse = mx + torch.log(torch.exp(x - mx).sum(dim=-1, keepdim=True))
    if attrs.get("soft_label", False):
        loss = -(label * (x - lse)).sum(dim=-1, keepdim=True)
    else:
        loss = lse - _take_label_prob(x, label)
        eps = attrs.get("label_smoothing", 0.0)
        if eps:
            loss = (1.0 - eps) * loss + eps * (
                lse - x.mean(dim=-1, keepdim=True))
    return {"Softmax": [torch.exp(x - lse)], "Loss": [loss]}



# Mixed operands promote at each binary op, as in jnp: torch's tensor
# promotion agrees (bf16 with f32 gives f32) for operands of equal rank.
@register_op("cross_entropy")
def cross_entropy(attrs, ins):
    """-log(p[label] + 1e-12) over probabilities X (hard labels), or
    -sum(label * log(X + 1e-12)) (soft); output slot Y."""
    x = single(ins, "X")
    label = single(ins, "Label")
    eps = weak(x, 1e-12)
    if attrs.get("soft_label", False):
        return out(Y=-C.row_sum(torch.mul, label, C.log(x + eps)))
    lab = label.reshape(x.shape[:-1])[..., None].long()
    return out(Y=-C.log(torch.gather(x, -1, lab) + eps))


@register_op("square_error_cost")
def square_error_cost(attrs, ins):
    d = single(ins, "X") - single(ins, "Y")
    return out(Out=d * d)


@register_op("squared_l2_distance")
def squared_l2_distance(attrs, ins):
    diff = single(ins, "X") - single(ins, "Y")
    return {"sub_result": [diff], "Out": [C.row_sum(torch.mul, diff, diff)]}


@register_op("squared_l2_norm")
def squared_l2_norm(attrs, ins):
    x = single(ins, "X")
    return out(Out=C.sum_f32(torch.mul, x, x).reshape(1))


@register_op("hinge_loss")
def hinge_loss(attrs, ins):
    logits = single(ins, "Logits")
    labels = single(ins, "Labels").to(logits.dtype)
    signs = weak(labels, 2.0) * labels - 1
    return out(Loss=torch.maximum(logits.new_zeros(()),
                                  1 - signs * logits))


@register_op("huber_loss")
def huber_loss(attrs, ins):
    r = single(ins, "Y") - single(ins, "X")
    delta = attrs.get("delta", 1.0)
    ar = C.abs_(r)
    loss = torch.where(ar <= weak(r, delta), weak(r, 0.5) * r * r,
                       weak(r, delta) * (ar - weak(r, 0.5 * delta)))
    return {"Residual": [r], "Out": [loss]}


@register_op("log_loss")
def log_loss(attrs, ins):
    p = single(ins, "Predicted")
    y = single(ins, "Labels")
    eps = weak(p, attrs.get("epsilon", 1e-4))
    return out(Loss=-y * C.log(p + eps) - (1 - y) * C.log(1 - p + eps))


@register_op("rank_loss")
def rank_loss(attrs, ins):
    d = single(ins, "Left") - single(ins, "Right")
    return out(Out=C.log1p(C.exp(d)) - single(ins, "Label") * d)


@register_op("margin_rank_loss")
def margin_rank_loss(attrs, ins):
    x1 = single(ins, "X1")
    v = -single(ins, "Label") * (x1 - single(ins, "X2"))
    o = torch.maximum(v.new_zeros(()),
                      v + weak(v, attrs.get("margin", 0.0)))
    return {"Out": [o], "Activated": [(o > 0).to(x1.dtype)]}


@register_op("smooth_l1_loss",
             optional_inputs=("InsideWeight", "OutsideWeight"))
def smooth_l1_loss(attrs, ins):
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    diff = single(ins, "X") - single(ins, "Y")
    in_w = maybe(ins, "InsideWeight")
    out_w = maybe(ins, "OutsideWeight")
    if in_w is not None:
        diff = diff * in_w
    ad = C.abs_(diff)
    elem = torch.where(ad < weak(ad, 1.0 / s2),
                       weak(diff, 0.5 * s2) * diff * diff,
                       ad - weak(ad, 0.5 / s2))
    if out_w is None:
        return {"Diff": [diff], "Out": [C.row_sum(lambda e: e, elem)]}
    return {"Diff": [diff], "Out": [C.row_sum(torch.mul, elem, out_w)]}


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(attrs, ins):
    """max(x, 0) - x * z + log1p(exp(-|x|)), elementwise."""
    x = single(ins, "X")
    loss = torch.maximum(x, x.new_zeros(())) - x * single(ins, "Label")
    return out(Out=loss + C.log1p(C.exp(-C.abs_(x))))


@register_op("bce_loss")
def bce_loss(attrs, ins):
    x = single(ins, "X")
    label = single(ins, "Label")
    eps = weak(x, 1e-12)
    return out(Out=-(label * C.log(x + eps)
                     + (1 - label) * C.log(1 - x + eps)))
