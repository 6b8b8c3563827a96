"""Metric ops of the CTR and ranking evaluators.

Counterpart of ``paddle_tpu/ops/metric_ops.py``'s ``confusion_counts``,
``auc_histogram``, ``rank_auc`` and ``pnpair_counts`` and of
``paddle_tpu/ops/extra_ops.py``'s ``precision_recall``, ``auc`` and
``positive_negative_pair``. Each is a batched, loop-free formulation
that stays on the device: a histogram is a scatter-add of ones into a
zeroed [k] tensor (an index out of range adds nothing, as
``jax.ops.segment_sum`` drops it), a per-query statistic one [b, L, L]
comparison. Counts are int32 and the rest f32, as the JAX ops give
them without x64; ``auc`` asks for f64 histograms, which JAX computes in
f32 there, and so does the port.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import maybe, out, single


def _segment_sum(values, seg, n):
    """``jax.ops.segment_sum(values, seg, num_segments=n)`` for 1-D
    values: a segment id outside [0, n) adds nothing."""
    keep = (seg >= 0) & (seg < n)
    idx = torch.where(keep, seg, torch.zeros_like(seg)).long()
    vals = torch.where(keep, values, torch.zeros_like(values))
    return torch.zeros(n, dtype=values.dtype,
                       device=values.device).index_add_(0, idx, vals)


@register_op("confusion_counts")
def confusion_counts(attrs, ins):
    """Per-class TP/FP/FN of the predictions (the argmax of 2-D scores, a
    single score column thresholded at 0.5, else int predictions)
    against the int labels."""
    pred = single(ins, "Pred")
    label = single(ins, "Label").reshape(-1).to(torch.int32)
    n = int(attrs["num_classes"])
    if pred.ndim == 2 and pred.shape[-1] > 1:
        pred = torch.argmax(pred, dim=-1)
    elif pred.is_floating_point():
        pred = pred.reshape(-1) > 0.5
    pred = pred.reshape(-1).to(torch.int32)
    ones = torch.ones_like(label)
    tp = _segment_sum((pred == label).to(torch.int32), label, n)
    pred_cnt = _segment_sum(ones, pred, n)
    label_cnt = _segment_sum(ones, label, n)
    return {"TP": [tp], "FP": [pred_cnt - tp], "FN": [label_cnt - tp]}


def _buckets(score, k):
    """P(class 1) of 2-D scores (a single column is itself), in k
    buckets: trunc(score * k) clipped to [0, k)."""
    if score.ndim == 2:
        score = score[:, -1]
    return torch.clamp((score.reshape(-1) * k).to(torch.int32), 0, k - 1)


@register_op("auc_histogram")
def auc_histogram(attrs, ins):
    """The positive-class scores in ``num_thresholds`` buckets, split by
    the binary label: the streaming AUC's state update."""
    k = int(attrs.get("num_thresholds", 200))
    bucket = _buckets(single(ins, "Score"), k)
    is_pos = single(ins, "Label").reshape(-1).to(torch.int32) > 0
    ones = torch.ones_like(bucket)
    pos = _segment_sum(torch.where(is_pos, ones, 0), bucket, k)
    neg = _segment_sum(torch.where(is_pos, 0, ones), bucket, k)
    return {"Pos": [pos], "Neg": [neg]}


def _length_mask(lengths, b, L, device):
    if lengths is None:
        return torch.ones((b, L), dtype=torch.float32, device=device)
    lengths = lengths.reshape(-1).to(torch.int32)
    return (torch.arange(L, dtype=torch.int32, device=device)[None, :]
            < lengths[:, None]).float()


def _query_rows(score, other):
    """Score and its companion as [b, L] query rows (a 3-D score takes
    its last column, a 1-D pair is one query)."""
    if score.ndim == 3:
        score = score[..., -1]
    if score.ndim == 1:
        score, other = score[None, :], other[None, :]
    return score, other.reshape(score.shape).float()


@register_op("rank_auc", optional_inputs=("Pv", "Length"))
def rank_auc(attrs, ins):
    """Per-query click-through AUC over padded [b, L] query rows in its
    pairwise form: auc = sum_ij pos_i * neg_j * (1[s_i > s_j] + .5 *
    1[s_i == s_j]) / (sum pos * sum neg), 0 for a query with no positive
    or no negative events. Outputs AucSum and QueryCount."""
    score, click = _query_rows(single(ins, "Score"), single(ins, "Click"))
    pv = maybe(ins, "Pv")
    pv = (torch.ones_like(click) if pv is None
          else pv.reshape(score.shape).float())
    b, L = score.shape
    m = _length_mask(maybe(ins, "Length"), b, L, score.device)
    pos = click * m
    neg = (pv - click) * m
    s = score.float()
    gt = (s[:, :, None] > s[:, None, :]).float()
    eq = (s[:, :, None] == s[:, None, :]).float()
    num = torch.einsum("bi,bij,bj->b", pos, gt + 0.5 * eq, neg)
    denom = pos.sum(-1) * neg.sum(-1)
    auc = torch.where(denom > 0, num / torch.clamp_min(denom, 1e-30),
                      torch.zeros_like(num))
    return out(AucSum=auc.sum(),
               QueryCount=torch.tensor(float(b), device=score.device))


@register_op("pnpair_counts", optional_inputs=("Weight", "Length"))
def pnpair_counts(attrs, ins):
    """Positive/negative/special pair counts within each padded [b, L]
    query row: over unordered pairs with different labels, concordant
    scores count to Pos, discordant to Neg, ties to Spe, each pair
    weighted by the mean of its two weights."""
    score, label = _query_rows(single(ins, "Score"), single(ins, "Label"))
    w = maybe(ins, "Weight")
    w = (torch.ones_like(label) if w is None
         else w.reshape(score.shape).float())
    b, L = score.shape
    m = _length_mask(maybe(ins, "Length"), b, L, score.device)
    s = score.float()
    pair_m = m[:, :, None] * m[:, None, :]
    iu = torch.triu(torch.ones((L, L), device=s.device), diagonal=1)[None]
    valid = pair_m * iu * (label[:, :, None] != label[:, None, :]).float()
    pw = 0.5 * (w[:, :, None] + w[:, None, :])
    s_gt = s[:, :, None] > s[:, None, :]
    s_lt = s[:, :, None] < s[:, None, :]
    l_gt = label[:, :, None] > label[:, None, :]
    l_lt = label[:, :, None] < label[:, None, :]
    conc = ((s_gt & l_gt) | (s_lt & l_lt)).float()
    disc = ((s_gt & l_lt) | (s_lt & l_gt)).float()
    tie = (~(s_gt | s_lt)).float()
    return out(Pos=(valid * pw * conc).sum(), Neg=(valid * pw * disc).sum(),
               Spe=(valid * pw * tie).sum())


@register_op("precision_recall")
def precision_recall(attrs, ins):
    """A batch's per-class precision and recall and its macro averages
    of precision, recall and F1."""
    counts = confusion_counts({"num_classes": attrs["num_classes"]},
                              {"Pred": ins["Pred"], "Label": ins["Label"]})
    tp, fp, fn = (counts[k][0].float() for k in ("TP", "FP", "FN"))
    p = tp / torch.clamp_min(tp + fp, 1.0)
    r = tp / torch.clamp_min(tp + fn, 1.0)
    f1 = 2 * p * r / torch.clamp_min(p + r, 1e-10)
    macro = torch.stack([p.mean(), r.mean(), f1.mean()])
    return out(BatchMetrics=macro, ClassPrecision=p, ClassRecall=r)


@register_op("auc")
def auc(attrs, ins):
    """A batch's AUC from its score histograms, by the trapezoid rule."""
    k = int(attrs.get("num_thresholds", 200))
    bucket = _buckets(single(ins, "Out"), k)
    label = single(ins, "Label").reshape(-1)
    pos_h = _segment_sum((label > 0).float(), bucket, k)
    neg_h = _segment_sum((label <= 0).float(), bucket, k)
    tp = torch.cumsum(pos_h.flip(0), 0)
    fp = torch.cumsum(neg_h.flip(0), 0)
    zero = tp.new_zeros(1)
    tpr = torch.cat([zero, tp / torch.clamp_min(tp[-1], 1)])
    fpr = torch.cat([zero, fp / torch.clamp_min(fp[-1], 1)])
    a = torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2)
    return out(AUC=a.reshape(()))


@register_op("positive_negative_pair")
def positive_negative_pair(attrs, ins):
    """Among same-query pairs with different labels, how many the scores
    order as the labels do (PositivePair), against them (NegativePair)
    and tie (NeutralPair), each as a [1] f32."""
    score = single(ins, "Score").reshape(-1)
    label = single(ins, "Label").reshape(-1)
    query = single(ins, "QueryID").reshape(-1)
    valid = (query[:, None] == query[None, :]) \
        & (label[:, None] > label[None, :])
    s_diff = score[:, None] - score[None, :]

    def count(mask):
        return (valid & mask).sum().float().reshape(1)

    return {"PositivePair": [count(s_diff > 0)],
            "NegativePair": [count(s_diff < 0)],
            "NeutralPair": [count(s_diff == 0)]}
