"""Loss ops. Counterpart of ``paddle_tpu/ops/loss_ops.py``, cut to
``softmax_with_cross_entropy`` and its fused gradient
(softmax - onehot) * dLoss."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import single


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
