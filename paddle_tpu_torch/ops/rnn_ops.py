"""Recurrent ops: the LSTM, GRU and plain-RNN scans.

Counterpart of ``paddle_tpu/ops/rnn_ops.py``: the three scans and the
two single-step ops (``lstm_unit``, ``gru_unit``) that a user-defined
recurrence (``static_rnn``) runs once a step. Inputs are padded
[batch, T, ...] with an optional int32 ``Length`` (``sequence_ops``);
the input projection happens outside, as one time-parallel product, and
only the h-recurrence is sequential. Where the JAX package runs a
``lax.scan`` (one XLA while-loop), the port runs a Python loop over the
time steps, eagerly: one [b, h] x [h, gates*h] product and the gate
arithmetic per step, in JAX's order of operations and with its casts,
so that the two agree step by step. The backward is torch autograd over
the loop (``core/backward.forward_with_vjp``). Finished rows carry their
state through unchanged and emit zeros.

Gate layouts follow the reference:
- LSTM Weight [h, 4h] ordered (candidate, input, forget, output);
  optional peephole weights (W_ic, W_fc, W_oc) in Bias columns 4h:7h.
- GRU Weight [h, 3h]: columns [0:2h] the (update, reset) gates, [2h:3h]
  the candidate; h' = (1-u)*h + u*candidate.

At build time (``core/registry.infer_outputs``, meta tensors whose time
axis may be the 1297 sentinel) a scan runs one step, for the dtypes, and
gives its outputs the full shape without looping over T.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from . import common
from .common import maybe, out, single
from .sequence_ops import time_mask

_ACT = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _lstm_step(h, c, gates, bias, peep, act_g, act_cand, act_cell):
    """One LSTM step. gates: [b, 4h] = x_proj + h @ W (pre-activation),
    columns ordered (candidate, input, forget, output). ``act_cand``
    acts on the candidate gate, ``act_cell`` on the cell state in
    h = o * act_cell(c)."""
    hdim = h.shape[-1]
    if bias is not None:
        gates = gates + bias[..., : 4 * hdim]
    gc, gi, gf, go = torch.chunk(gates, 4, dim=-1)
    if peep is not None:
        wic, wfc, woc = torch.chunk(peep, 3, dim=-1)
        gi = gi + wic * c
        gf = gf + wfc * c
    i = act_g(gi)
    f = act_g(gf)
    c_new = f * c + i * act_cand(gc)
    if peep is not None:
        go = go + woc * c_new
    o = act_g(go)
    h_new = o * act_cell(c_new)
    return h_new, c_new


def _scan(step, carry, seqs, reverse):
    """``lax.scan`` over the time axis (1) of each tensor in ``seqs``
    ([b, T, ...]), reversed with ``reverse``: ``carry, ys = step(carry,
    [s_t, ...])`` per step. Returns the last carry and each of ``ys``
    stacked back to [b, T, ...], once, after the loop. On meta tensors
    one step stands for all T."""
    T = seqs[0].shape[1]
    n = 1 if seqs[0].is_meta else T
    # time-major views: unbind's backward is one stack, where indexing
    # x[:, t] would give each step a full-size zero gradient
    cols = [s[:, :n].transpose(0, 1).unbind(0) for s in seqs]
    ys = [None] * n
    for t in (range(n - 1, -1, -1) if reverse else range(n)):
        carry, ys[t] = step(carry, [col[t] for col in cols])
    stacked = [torch.stack(col, 1) for col in zip(*ys)]
    if n != T:
        stacked = [s.expand((s.shape[0], T) + tuple(s.shape[2:]))
                   for s in stacked]
    return carry, stacked


def _seqs(xs, lengths, dtype):
    """The scanned inputs: ``xs``, and with ``lengths`` the [b, T, 1] mask
    in ``dtype`` (the op's input's, before any cast, as in JAX)."""
    if lengths is None:
        return [xs]
    return [xs, time_mask(lengths, xs.shape[1], dtype)[..., None]]


def _masked(m, new, old):
    """A finished row (m = 0) keeps its state; the carry and the emitted
    value, which is 0 there."""
    kept = m * new + (1 - m) * old
    return kept, kept * m


@register_op("lstm", optional_inputs=("Bias", "H0", "C0", "Length"))
def lstm(attrs, ins):
    """Full LSTM scan (reference lstm_op.cc ``dynamic_lstm``). Input:
    [b, T, 4h], the pre-projected x."""
    x = single(ins, "Input")  # [b, T, 4h]
    w = single(ins, "Weight")  # [h, 4h]
    bias = maybe(ins, "Bias")  # [1, 4h] or [1, 7h] with peepholes
    lengths = maybe(ins, "Length")
    h0 = maybe(ins, "H0")
    c0 = maybe(ins, "C0")
    b, T, four_h = x.shape
    hdim = four_h // 4
    use_peep = attrs.get("use_peepholes", False)
    reverse = attrs.get("is_reverse", False)
    act_g = _ACT[attrs.get("gate_activation", "sigmoid")]
    act_cand = _ACT[attrs.get("candidate_activation", "tanh")]
    act_cell = _ACT[attrs.get("cell_activation", "tanh")]

    peep = None
    if bias is not None and use_peep:
        peep = bias[..., 4 * hdim: 7 * hdim]
    zeros = torch.zeros((b, hdim), dtype=x.dtype, device=x.device)
    h = h0 if h0 is not None else zeros
    c = c0 if c0 is not None else zeros

    x_cast, w_cast = common.amp_cast(x, w)
    seqs = _seqs(x_cast, lengths, x.dtype)

    def step(carry, inp):
        h, c = carry
        gates = inp[0] + common.matmul(common.amp_cast(h),
                                       w_cast).to(h.dtype)
        h_new, c_new = _lstm_step(h, c, gates, bias, peep, act_g, act_cand,
                                  act_cell)
        if len(inp) == 1:
            return (h_new, c_new), (h_new, c_new)
        h_new, y = _masked(inp[1], h_new, h)
        c_new, cy = _masked(inp[1], c_new, c)
        return (h_new, c_new), (y, cy)

    (h, c), (hidden, cell) = _scan(step, (h, c), seqs, reverse)
    return out(Hidden=hidden, Cell=cell, LastH=h, LastC=c)


@register_op("gru", optional_inputs=("Bias", "H0", "Length"))
def gru(attrs, ins):
    """Full GRU scan (reference gru_op.cc ``dynamic_gru``). Input:
    [b, T, 3h], the pre-projected x; m = act(x_m + (r . h) @ W_m),
    h' = (1-u)*h + u*m. The bias joins x before the loop."""
    x = single(ins, "Input")  # [b, T, 3h]
    w = single(ins, "Weight")  # [h, 3h]: [:, :2h] gates, [:, 2h:] candidate
    bias = maybe(ins, "Bias")
    lengths = maybe(ins, "Length")
    h0 = maybe(ins, "H0")
    b, T, three_h = x.shape
    hdim = three_h // 3
    reverse = attrs.get("is_reverse", False)
    act_g = _ACT[attrs.get("gate_activation", "sigmoid")]
    act_c = _ACT[attrs.get("activation", "tanh")]

    h = h0 if h0 is not None else torch.zeros((b, hdim), dtype=x.dtype,
                                              device=x.device)
    xs = x + bias if bias is not None else x
    xs, wg, wc = common.amp_cast(xs, w[:, : 2 * hdim], w[:, 2 * hdim:])
    seqs = _seqs(xs, lengths, x.dtype)

    def step(h, inp):
        xt = inp[0]
        xg, xc = xt[..., : 2 * hdim], xt[..., 2 * hdim:]
        g = act_g(xg + common.matmul(common.amp_cast(h), wg).to(h.dtype))
        u, r = g[..., :hdim], g[..., hdim:]
        cand = act_c(xc + common.matmul(common.amp_cast(r * h),
                                        wc).to(h.dtype))
        h_new = (1.0 - u) * h + u * cand
        if len(inp) == 1:
            return h_new, (h_new,)
        h_new, y = _masked(inp[1], h_new, h)
        return h_new, (y,)

    h, (hidden,) = _scan(step, h, seqs, reverse)
    return out(Hidden=hidden, LastH=h)


@register_op("simple_rnn", optional_inputs=("Bias", "H0", "Length"))
def simple_rnn(attrs, ins):
    """Plain recurrent layer (the v1 ``recurrent_layer``):
    out_t = act(in_t + out_{t-1} @ W + b). Input: [b, T, h], already at
    the hidden width; the bias joins x before the loop."""
    x = single(ins, "Input")  # [b, T, h]
    w = single(ins, "Weight")  # [h, h]
    bias = maybe(ins, "Bias")
    lengths = maybe(ins, "Length")
    h0 = maybe(ins, "H0")
    b, T, hdim = x.shape
    reverse = attrs.get("is_reverse", False)
    act = _ACT[attrs.get("activation", "tanh")]

    h = h0 if h0 is not None else torch.zeros((b, hdim), dtype=x.dtype,
                                              device=x.device)
    xs = x + bias if bias is not None else x
    xs, w_cast = common.amp_cast(xs, w)
    seqs = _seqs(xs, lengths, x.dtype)

    def step(h, inp):
        h_new = act(inp[0] + common.matmul(common.amp_cast(h),
                                           w_cast).to(h.dtype))
        if len(inp) == 1:
            return h_new, (h_new,)
        h_new, y = _masked(inp[1], h_new, h)
        return h_new, (y,)

    h, (hidden,) = _scan(step, h, seqs, reverse)
    return out(Hidden=hidden, LastH=h)


# the step ops' activations: the JAX primitives' gradients (common.unary)
_STEP_ACT = {
    "sigmoid": common.sigmoid,
    "tanh": common.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


@register_op("lstm_unit", optional_inputs=("Bias",))
def lstm_unit(attrs, ins):
    """Single LSTM step (lstm_unit_op.cc): X [b, 4h] the projected gates,
    in the (i, f, o, g) layout of lstm_unit_op.h:63-66; C_prev [b, h].
    Returns C and H."""
    gates = single(ins, "X")
    c_prev = single(ins, "C_prev")
    bias = maybe(ins, "Bias")
    forget_bias = attrs.get("forget_bias", 0.0)
    if bias is not None:
        gates = gates + bias
    gi, gf, go, gc = torch.chunk(gates, 4, dim=-1)
    i = common.sigmoid(gi)
    f = common.sigmoid(gf + common.weak(gf, forget_bias))
    c = f * c_prev + i * common.tanh(gc)
    h = common.sigmoid(go) * common.tanh(c)
    return out(C=c, H=h)


@register_op("gru_unit", optional_inputs=("Bias",))
def gru_unit(attrs, ins):
    """Single GRU step (gru_unit_op.cc): Input [b, 3h] pre-projected,
    HiddenPrev [b, h], Weight [h, 3h] (update and reset columns first,
    then the candidate's); the two products take the precision policy.
    Returns Hidden, Gate ([b, 2h], after the gate activation) and
    ResetHiddenPrev."""
    xt = single(ins, "Input")
    h_prev = single(ins, "HiddenPrev")
    w = single(ins, "Weight")
    bias = maybe(ins, "Bias")
    act_g = _STEP_ACT[attrs.get("gate_activation", "sigmoid")]
    act_c = _STEP_ACT[attrs.get("activation", "tanh")]
    hdim = h_prev.shape[-1]
    if bias is not None:
        xt = xt + bias
    xg, xc = xt[..., : 2 * hdim], xt[..., 2 * hdim:]
    g = act_g(xg + common.matmul(h_prev, w[:, : 2 * hdim]))
    u, r = g[..., :hdim], g[..., hdim:]
    cand = act_c(xc + common.matmul(r * h_prev, w[:, 2 * hdim:]))
    h = (1.0 - u) * h_prev + u * cand  # gru_unit_op.cc:122
    return out(Hidden=h, Gate=g, ResetHiddenPrev=r * h_prev)
