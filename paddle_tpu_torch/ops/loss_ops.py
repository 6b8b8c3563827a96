"""Loss ops. Counterpart of ``paddle_tpu/ops/loss_ops.py``: every loss.
``softmax_with_cross_entropy`` has its fused gradient (softmax - onehot)
* dLoss, and ``fused_head_cross_entropy`` its chunked backward. The others are written op by op as the JAX package writes them,
with each Python constant rounded to the operand's dtype
(``common.weak``), a bf16 operand against an f32 one promoted to f32 as
jnp promotes, and the gradient of ``abs`` and ``maximum`` at a tie as
JAX's (``common.abs_``; ``torch.maximum`` splits a tie as ``jnp.maximum``
does), so ``sigmoid_cross_entropy_with_logits`` at x = 0 differentiates
to -label in both packages."""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from . import common as C
from .common import amp_cast, maybe, out, single, weak


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



# --- the chunked LM head -----------------------------------------------------
# fused_head_cross_entropy projects X [.., d] onto W [d, vocab] and takes
# the softmax cross-entropy without the [tokens, vocab] logits: the vocab
# is scanned in chunks with an online logsumexp, and the backward
# recomputes each chunk's logits and contracts (softmax - target) * dLoss
# into dX and that chunk's dW at once. A chunk's logits, p - target and
# the accumulators stay f32 whatever the operands' dtype (bf16 under
# AMP): the products run on f32 copies of the operands, which for bf16
# values is exact, as XLA's bf16 dot with an f32 result is.
def _fhce_chunks(vocab, chunk):
    """(chunk, n_chunks), n_chunks = ceil(vocab / chunk): the last chunk
    is padded, never shrunk, so an awkward vocab does not lengthen the
    loop."""
    c = min(chunk, vocab)
    return c, -(-vocab // c)


def _fhce_w3(wc, chunk, n_chunks, vocab):
    """W [d, vocab] -> [d, n_chunks, chunk], the tail chunk zero-padded
    (its padded columns are masked to -inf logits)."""
    pad = n_chunks * chunk - vocab
    if pad:
        wc = torch.nn.functional.pad(wc, (0, pad))
    return wc.reshape(wc.shape[0], n_chunks, chunk)


def _fhce_gather(logits_c, lab, c0, cols):
    """Each row's logit at ``lab`` where the label falls inside this
    chunk, else 0."""
    local = lab - c0
    inside = (local >= 0) & (local < cols)
    safe = local.clamp(0, cols - 1)
    picked = torch.gather(logits_c, 1, safe[:, None])[:, 0]
    return torch.where(inside, picked, picked.new_zeros(()))


def _fhce_chunk_logits(x2, w3, i, chunk, vocab):
    """Chunk ``i``'s logits in f32, its padded columns -inf; the one
    recompute shared by the forward's logsumexp and the backward's
    softmax (the saved LSE is valid for the backward only so)."""
    wck = w3[:, i]
    logits = C.matmul(x2.float(), wck.float())
    valid = (i * chunk + torch.arange(chunk, device=x2.device)) < vocab
    return torch.where(valid[None, :], logits,
                       logits.new_full((), -math.inf)), wck


def _fhce_lse_chunk(x2, w3, i, chunk, vocab, lab, carry):
    """One online-logsumexp step over chunk ``i``; carry = (m, s, ll,
    rs), rs each row's sum of valid logits (label smoothing's term).
    A label outside [0, vocab) never gathers."""
    m, s, ll, rs = carry
    logits, _ = _fhce_chunk_logits(x2, w3, i, chunk, vocab)
    m_new = torch.maximum(m, logits.amax(dim=1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(1)
    ll = ll + _fhce_gather(logits, lab, i * chunk, chunk)
    rs = rs + torch.where(torch.isneginf(logits), logits.new_zeros(()),
                          logits).sum(1)
    return m_new, s, ll, rs


def _fhce_lse(x2, wc, lab, chunk, n_chunks):
    """(lse, label logit, row sum of logits) over the vocab chunks."""
    vocab = wc.shape[-1]
    w3 = _fhce_w3(wc, chunk, n_chunks, vocab)
    n = x2.shape[0]
    zeros = x2.new_zeros((n,), dtype=torch.float32)
    carry = (torch.full_like(zeros, -math.inf), zeros, zeros, zeros)
    for i in range(n_chunks):
        carry = _fhce_lse_chunk(x2, w3, i, chunk, vocab, lab, carry)
    m, s, ll, rs = carry
    return m + torch.log(s), ll, rs


def _fhce_grad_chunk(x2, w3, i, chunk, vocab, lab, lse2, dl2,
                     smoothing=0.0):
    """One backward step over chunk ``i``: (its dX term [n, d] f32, its
    dW columns [d, chunk] f32) from g = (softmax - target) * dLoss, the
    target one-hot or label-smoothed; g is cast to X's dtype before the
    two products."""
    logits, wck = _fhce_chunk_logits(x2, w3, i, chunk, vocab)
    p = torch.exp(logits - lse2)
    # one-hot by comparison (a label outside the chunk matches no
    # column), with no data-dependent indexing and so no host sync
    target = (torch.arange(i * chunk, (i + 1) * chunk, device=p.device)
              == lab[:, None]).float()
    if smoothing:
        valid = (~torch.isneginf(logits)).float()
        target = ((1.0 - smoothing) * target
                  + (smoothing / vocab) * valid)
    g = ((p - target) * dl2).to(x2.dtype).float()
    return C.matmul(g, wck.float().T), C.matmul(x2.float().T, g)


def _fused_head_ce_grad(attrs, ins, outs, ogs):
    """The chunked backward: each chunk's logits recomputed, (softmax -
    target) * dLoss formed and contracted at once into dX and that
    chunk's dW; the [tokens, vocab] gradient never materializes. LSE is
    the forward's saved row (or recomputed chunk by chunk)."""
    x = single(ins, "X")
    w = single(ins, "W")
    label = single(ins, "Label")
    dloss = ogs.get("Loss", [None])[0]
    if dloss is None:
        raise NotImplementedError("fused_head_cross_entropy grad needs "
                                  "Loss@GRAD (LSE is not differentiable)")
    if any(g is not None for g in ogs.get("LSE", [])):
        raise NotImplementedError(
            "fused_head_cross_entropy LSE output is an auxiliary "
            "residual, not a differentiable head")
    xc, wc = amp_cast(x, w)
    lead = tuple(x.shape[:-1])
    d = x.shape[-1]
    vocab = w.shape[-1]
    n = math.prod(lead)
    x2 = xc.reshape(n, d)
    lab = label.reshape(n).long()
    dl2 = dloss.reshape(n, 1).float()
    # vocab_parallel=True without a mesh runs this serial path, as the
    # JAX program does on one device (the mesh path is the parallel
    # plane's, ROADMAP.md Queue 1 item 10)
    chunk, n_chunks = _fhce_chunks(vocab, attrs.get("chunk", 8192))
    lse = outs.get("LSE", [None])[0]
    if lse is None:
        lse = _fhce_lse(x2, wc, lab, chunk, n_chunks)[0]
    lse2 = lse.reshape(n, 1).float()
    eps = attrs.get("label_smoothing", 0.0)
    w3 = _fhce_w3(wc, chunk, n_chunks, vocab)
    dx = x2.new_zeros((n, d), dtype=torch.float32)
    dw = []
    for i in range(n_chunks):
        dx_c, dw_c = _fhce_grad_chunk(x2, w3, i, chunk, vocab, lab, lse2,
                                      dl2, smoothing=eps)
        dx = dx + dx_c
        dw.append(dw_c)
    dw = torch.cat(dw, dim=1)[:, :vocab]
    return {"X": [dx.reshape(x.shape).to(x.dtype)],
            "W": [dw.to(w.dtype)], "Label": [None]}


@register_op("fused_head_cross_entropy", grad_fn=_fused_head_ce_grad,
             grad_fn_is_optimization=True)
def fused_head_cross_entropy(attrs, ins):
    """The LM head's projection and softmax cross-entropy without the
    [tokens, vocab] logits: an online logsumexp over vocab chunks, so
    the head holds O(tokens * chunk). Hard labels only. X [.., d] x W
    [d, vocab] with Label [.., 1] -> Loss [.., 1], and LSE [..] (a
    residual for the backward)."""
    x = single(ins, "X")
    w = single(ins, "W")
    label = single(ins, "Label")
    if attrs.get("soft_label", False):
        raise NotImplementedError(
            "fused_head_cross_entropy supports hard labels only")
    xc, wc = amp_cast(x, w)
    lead = tuple(x.shape[:-1])
    d = x.shape[-1]
    vocab = w.shape[-1]
    n = math.prod(lead)
    chunk, n_chunks = _fhce_chunks(vocab, attrs.get("chunk", 8192))
    lse, ll, rs = _fhce_lse(xc.reshape(n, d), wc, label.reshape(n).long(),
                            chunk, n_chunks)
    eps = attrs.get("label_smoothing", 0.0)
    if eps:
        # the target (1-eps)*onehot + eps/V: loss = (1-eps)*(lse - x_label)
        #   + eps*(lse - sum(x)/V)
        loss = (1.0 - eps) * (lse - ll) + eps * (lse - rs / vocab)
    else:
        loss = lse - ll
    return {"Loss": [loss.reshape(lead + (1,))], "LSE": [lse.reshape(lead)]}


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
