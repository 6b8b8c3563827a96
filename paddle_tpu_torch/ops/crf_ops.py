"""Linear-chain CRF ops: log-likelihood, Viterbi decode, chunk evaluation.

Counterpart of ``paddle_tpu/ops/crf_ops.py``. The recursions run over
the padded time axis for the whole batch at once, a Python loop of
[b, n, n] steps where JAX runs one ``lax.scan``; finished rows carry
their state through unchanged. The gradient of ``linear_chain_crf`` is
autograd through that loop (the generic backward), in JAX's order of
operations. ``chunk_eval`` stays on the tensors' device: its matching
is a segment-min (``scatter_reduce("amin")``) and a segment count
(``scatter_add``) over the label chunks, with exact integer counts.

Transition layout, as the reference's (linear_chain_crf_op.h):
``Transition`` is [n + 2, n]; row 0 the start weights, row 1 the end
weights, rows 2.. the weight from tag i to tag j.

On meta tensors (build-time shape inference, whose time axis may be the
batch sentinel) the ops give their outputs' shapes without looping.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import maybe, out, single
from .sequence_ops import time_mask


def _split_transition(trans):
    return trans[0], trans[1], trans[2:]  # start [n], end [n], w [n, n]


def _full_lengths(lengths, b, T, device):
    if lengths is None:
        return torch.full((b,), T, dtype=torch.int32, device=device)
    return lengths


def _logsumexp(x, dim):
    """``jax.nn.logsumexp``: log(sum(exp(x - max))) + max, the max held
    constant (0 where it is not finite), so autograd gives JAX's
    gradient formula."""
    m = x.amax(dim=dim, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.exp(x - m).sum(dim=dim)) + m.squeeze(dim)


def _labels_2d(label):
    return (label[..., 0] if label.ndim == 3 else label).long()


@register_op("linear_chain_crf", optional_inputs=("Length",))
def linear_chain_crf(attrs, ins):
    """Negative log-likelihood of the label paths under a linear-chain
    CRF. Inputs: Emission [b, T, n], Transition [n+2, n], Label [b, T]
    (or [b, T, 1]) int, Length [b]. Outputs LogLikelihood [b, 1] (the
    NEGATIVE log-likelihood, the reference's sign) and Alpha [b, T, n],
    the forward log-scores."""
    emission = single(ins, "Emission")
    trans = single(ins, "Transition")
    label = _labels_2d(single(ins, "Label"))
    b, T, n = emission.shape
    dtype = torch.promote_types(emission.dtype, trans.dtype)
    if emission.is_meta:
        return out(LogLikelihood=emission.new_empty((b, 1), dtype=dtype),
                   Alpha=emission.new_empty((b, T, n), dtype=dtype))
    lengths = _full_lengths(maybe(ins, "Length"), b, T, emission.device)
    start_w, end_w, w = _split_transition(trans)
    mask = time_mask(lengths, T, emission.dtype)  # [b, T]

    # partition function: the alpha recursion in log space
    alpha = start_w[None, :] + emission[:, 0]  # [b, n]
    alphas = [alpha]
    for t in range(1, T):
        # logsumexp_i(alpha_i + w_ij) + em_j
        scores = alpha[:, :, None] + w[None, :, :]  # [b, n, n]
        new_alpha = _logsumexp(scores, 1) + emission[:, t]
        alpha = torch.where(mask[:, t, None] > 0, new_alpha, alpha)
        alphas.append(alpha)
    log_z = _logsumexp(alpha + end_w[None, :], -1)  # [b]

    # the gold path's score
    path_em = torch.take_along_dim(emission, label[..., None],
                                   dim=2)[..., 0]  # [b, T]
    em_score = torch.sum(path_em * mask, dim=1)
    trans_pairs = w[label[:, :-1], label[:, 1:]]  # [b, T-1]
    em_score = em_score + torch.sum(trans_pairs * mask[:, 1:], dim=1)
    last_idx = torch.clamp(lengths - 1, min=0).long()
    last_tag = torch.take_along_dim(label, last_idx[:, None], dim=1)[:, 0]
    path_score = em_score + start_w[label[:, 0]] + end_w[last_tag]

    nll = (log_z - path_score)[:, None]  # [b, 1]
    return out(LogLikelihood=nll, Alpha=torch.stack(alphas, dim=1))


@register_op("crf_decoding", optional_inputs=("Length", "Label"))
def crf_decoding(attrs, ins):
    """Viterbi decode (crf_decoding_op.h): the best tag path per row.

    Without Label: ViterbiPath [b, T] int64, the best tags, 0 at the
    padding. With Label: the per-position 0/1 correctness instead. Ties
    go to the lowest tag, as ``jnp.argmax`` breaks them."""
    emission = single(ins, "Emission")
    trans = single(ins, "Transition")
    label = maybe(ins, "Label")
    b, T, n = emission.shape
    if emission.is_meta:
        return out(ViterbiPath=emission.new_empty((b, T),
                                                  dtype=torch.int64))
    lengths = _full_lengths(maybe(ins, "Length"), b, T, emission.device)
    start_w, end_w, w = _split_transition(trans)
    mask = time_mask(lengths, T, emission.dtype)
    live = mask > 0
    stay = torch.arange(n, device=emission.device)[None, :]

    v = start_w[None, :] + emission[:, 0]  # [b, n]
    back = []  # back[t][b, j]: the best tag at t for tag j at t + 1
    for t in range(1, T):
        scores = v[:, :, None] + w[None, :, :]  # [b, from, to]
        best_prev = torch.argmax(scores, dim=1)  # [b, n]
        new_v = torch.amax(scores, dim=1) + emission[:, t]
        m_t = live[:, t, None]
        v = torch.where(m_t, new_v, v)
        # frozen rows backtrack to "stay", so padding is harmless
        back.append(torch.where(m_t, best_prev, stay))
    tag = torch.argmax(v + end_w[None, :], dim=-1)  # [b]
    path = [tag]
    for bp in reversed(back):
        tag = torch.take_along_dim(bp, tag[:, None], dim=1)[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1) * live.long()  # 0 at the padding
    if label is not None:
        correct = (path == _labels_2d(label)).long() * live.long()
        return out(ViterbiPath=correct)
    return out(ViterbiPath=path)


def _shift_right(x, fill):
    """x[:, t - 1] at t, ``fill`` at t = 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _shift_left(x, fill):
    """x[:, t + 1] at t, ``fill`` at the last step."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


@register_op("chunk_eval", optional_inputs=("Length",))
def chunk_eval(attrs, ins):
    """Chunk-level precision/recall/F1 (chunk_eval_op.cc), IOB scheme
    with ``num_chunk_types`` k: tag 2c = B-c, 2c + 1 = I-c, any tag
    >= 2k is Outside. Outputs Precision/Recall/F1-Score [1] (f32) and the
    counts NumInferChunks/NumLabelChunks/NumCorrectChunks [1] (int64)."""
    inference = single(ins, "Inference")
    label = single(ins, "Label")
    if inference.ndim == 3:
        inference = inference[..., 0]
    if label.ndim == 3:
        label = label[..., 0]
    b, T = label.shape[:2]
    dev = label.device
    lengths = _full_lengths(maybe(ins, "Length"), b, T, dev)
    num_types = int(attrs.get("num_chunk_types", 1))
    valid = time_mask(lengths, T, torch.int32) > 0

    def chunk_info(tags):
        """IOB starts and membership. A chunk starts at B-c, or at I-c
        where the previous position is not in a chunk of type c."""
        tags = tags.to(torch.int32)
        ctype = tags // 2
        in_chunk = (ctype < num_types) & valid
        is_b = (tags % 2) == 0
        cont = _shift_right(in_chunk, False) & (_shift_right(ctype, -1)
                                                == ctype)
        return in_chunk & (is_b | ~cont), in_chunk

    inf_starts, inf_in = chunk_info(inference)
    lab_starts, lab_in = chunk_info(label)
    n_inf = inf_starts.sum()
    n_lab = lab_starts.sum()

    # A label chunk [s, e] matches an inference chunk iff the chunk types
    # agree on every position of [s, e] (matching is by begin, end and
    # TYPE: chunk_eval_op.h Segment::operator==), the chunk starts
    # coincide throughout, and the inference chunk does not run on past
    # e; that last check applies at label-chunk ends only.
    sagree = inf_starts == lab_starts
    tag_eq = ((inference.to(torch.int32) // 2 == label.to(torch.int32) // 2)
              & inf_in)
    next_within = (torch.arange(T, device=dev)[None, :] + 1
                   < lengths[:, None])
    cont_inf_next = _shift_left(inf_in & ~inf_starts, False) & next_within
    cont_lab_next = _shift_left(lab_in & ~lab_starts, False) & next_within
    lab_end = lab_in & ~cont_lab_next  # the last position of its chunk
    end_ok = torch.where(lab_end, ~cont_inf_next,
                         torch.ones_like(lab_end))
    agree = tag_eq & sagree & end_ok & valid

    # per label chunk, the min of agreement over its positions: segment
    # ids from the running count of label starts; positions outside any
    # label chunk go to a dump segment
    max_chunks = T + 1
    seg = (torch.cumsum(lab_starts.to(torch.int64), dim=1)
           + torch.arange(b, device=dev)[:, None] * max_chunks)
    dump = b * max_chunks
    seg = torch.where(lab_in, seg, torch.full_like(seg, dump)).reshape(-1)
    seg_min = torch.ones(dump + 1, dtype=torch.int32, device=dev
                         ).scatter_reduce(0, seg,
                                          agree.to(torch.int32).reshape(-1),
                                          "amin", include_self=True)
    seg_cnt = torch.zeros(dump + 1, dtype=torch.int32, device=dev
                          ).scatter_add(0, seg,
                                        lab_in.to(torch.int32).reshape(-1))
    matched = ((seg_min[:dump] > 0) & (seg_cnt[:dump] > 0)).sum()

    precision = matched / torch.clamp(n_inf, min=1)
    recall = matched / torch.clamp(n_lab, min=1)
    f1 = 2 * precision * recall / torch.clamp(precision + recall,
                                              min=1e-10)
    one = lambda x: x.to(torch.float32).reshape(1)  # noqa: E731
    count = lambda x: x.to(torch.int64).reshape(1)  # noqa: E731
    return {
        "Precision": [one(precision)],
        "Recall": [one(recall)],
        "F1-Score": [one(f1)],
        "NumInferChunks": [count(n_inf)],
        "NumLabelChunks": [count(n_lab)],
        "NumCorrectChunks": [count(matched)],
    }
