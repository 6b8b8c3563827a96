"""Sequence and recurrent layer functions.

Counterpart of ``paddle_tpu/layers/sequence.py``, cut to the pools,
``sequence_conv`` and the three recurrent layers. Sequence-ness is a build-time property: a
Variable carries a ``seq_len`` pointer to its companion int32 [batch]
lengths Variable (made by ``layers.data(..., lod_level>0)``), and these
layers pass it to their op as ``Length`` and on to their outputs.
"""
from __future__ import annotations

from ..initializer import XavierInitializer
from .layer_helper import LayerHelper


def get_seq_len(var):
    """The lengths Variable travelling with ``var`` (or None)."""
    return getattr(var, "seq_len", None)


def _len_input(var):
    sl = get_seq_len(var)
    return {"Length": [sl]} if sl is not None else {}


def sequence_pool(input, pool_type="average", main_program=None,
                  startup_program=None):
    """Pool each sequence over its valid steps: ``sum``, ``average``,
    ``sqrt``, ``max``, ``last`` or ``first`` -> [b, ...]."""
    helper = LayerHelper("sequence_pool", main_program=main_program,
                         startup_program=startup_program)
    return helper.simple_op(
        "sequence_pool", {"X": [input], **_len_input(input)},
        {"pool_type": pool_type})


def sequence_first_step(input, **kw):
    return sequence_pool(input, "first", **kw)


def sequence_last_step(input, **kw):
    return sequence_pool(input, "last", **kw)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  main_program=None, startup_program=None):
    """Context-window conv over a sequence (reference nn.py
    sequence_conv): the ``filter_size`` rows centred on each step,
    concatenated, times a [filter_size*d, num_filters] filter, + bias,
    then ``act``."""
    if filter_stride != 1:
        # the reference op enforces contextStride == 1 too
        # (sequence_conv_op.cc PADDLE_ENFORCE)
        raise ValueError("sequence_conv only supports filter_stride=1")
    if padding is not None:
        raise NotImplementedError(
            "trainable context padding (PaddingData) is not supported; "
            "out-of-range context rows are zero-padded")
    helper = LayerHelper("sequence_conv", main_program=main_program,
                         startup_program=startup_program)
    d = input.shape[-1]
    filt = helper.create_parameter(
        param_attr, shape=[filter_size * d, num_filters], dtype=input.dtype,
        default_initializer=XavierInitializer())
    pre_bias = helper.simple_op(
        "sequence_conv",
        {"X": [input], "Filter": [filt], **_len_input(input)},
        {"contextLength": filter_size, "contextStart": -int(filter_size // 2),
         "contextStride": filter_stride})
    pre_act = helper.append_bias_op(pre_bias, bias_attr, num_filters,
                                    dim_start=2)
    o = helper.append_activation(pre_act, act)
    o.seq_len = get_seq_len(input)
    return o


def _recurrent(helper, op_type, input, w, bias, init, out_slots, attrs):
    """Append a scan op over ``input`` (with its ``Length``) and return
    its outputs, each sequence output carrying the input's lengths."""
    ins = {"Input": [input], "Weight": [w], **_len_input(input)}
    if bias is not None:
        ins["Bias"] = [bias]
    for slot, var in init.items():
        if var is not None:
            ins[slot] = [var]
    outs, _ = helper.append_op(op_type, ins, out_slots, attrs)
    return outs


def dynamic_lstm(input, size, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", param_attr=None, bias_attr=None,
                 h0=None, c0=None, main_program=None, startup_program=None):
    """LSTM over a pre-projected sequence (reference nn.py dynamic_lstm):
    ``input`` is [b, T, size] with size = 4*hidden; returns (hidden
    sequence, cell sequence). Weight and bias take the input's dtype
    (bf16 under AMP, behind a bf16 ``fc``)."""
    helper = LayerHelper("lstm", main_program=main_program,
                         startup_program=startup_program)
    hidden = size // 4
    w = helper.create_parameter(
        param_attr, shape=[hidden, 4 * hidden], dtype=input.dtype,
        default_initializer=XavierInitializer())
    bias_cols = 7 * hidden if use_peepholes else 4 * hidden
    bias = None if bias_attr is False else helper.create_parameter(
        bias_attr, shape=[1, bias_cols], dtype=input.dtype, is_bias=True)
    outs = _recurrent(
        helper, "lstm", input, w, bias, {"H0": h0, "C0": c0},
        ["Hidden", "Cell", "LastH", "LastC"],
        {"use_peepholes": use_peepholes, "is_reverse": is_reverse,
         "gate_activation": gate_activation,
         "cell_activation": cell_activation,
         "candidate_activation": candidate_activation})
    h_seq, c_seq = outs["Hidden"][0], outs["Cell"][0]
    h_seq.seq_len = get_seq_len(input)
    c_seq.seq_len = get_seq_len(input)
    return h_seq, c_seq


def dynamic_gru(input, size, is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", param_attr=None, bias_attr=None,
                h0=None, main_program=None, startup_program=None):
    """GRU over a pre-projected sequence (reference gru_op.cc): ``input``
    is [b, T, 3*size]; returns the hidden sequence [b, T, size]."""
    helper = LayerHelper("gru", main_program=main_program,
                         startup_program=startup_program)
    w = helper.create_parameter(
        param_attr, shape=[size, 3 * size], dtype=input.dtype,
        default_initializer=XavierInitializer())
    bias = None if bias_attr is False else helper.create_parameter(
        bias_attr, shape=[1, 3 * size], dtype=input.dtype, is_bias=True)
    outs = _recurrent(
        helper, "gru", input, w, bias, {"H0": h0}, ["Hidden", "LastH"],
        {"is_reverse": is_reverse, "gate_activation": gate_activation,
         "activation": candidate_activation})
    h_seq = outs["Hidden"][0]
    h_seq.seq_len = get_seq_len(input)
    return h_seq


def simple_rnn(input, size=None, is_reverse=False, activation="tanh",
               param_attr=None, bias_attr=None, h0=None,
               main_program=None, startup_program=None):
    """Plain RNN over a sequence already at hidden width (the v1
    ``recurrent_layer``): out_t = act(in_t + out_{t-1} @ W + b).
    ``input`` is [b, T, h]."""
    helper = LayerHelper("simple_rnn", main_program=main_program,
                         startup_program=startup_program)
    hdim = int(size or input.shape[-1])
    w = helper.create_parameter(
        param_attr, shape=[hdim, hdim], dtype=input.dtype,
        default_initializer=XavierInitializer())
    bias = None if bias_attr is False else helper.create_parameter(
        bias_attr, shape=[1, hdim], dtype=input.dtype, is_bias=True)
    outs = _recurrent(
        helper, "simple_rnn", input, w, bias, {"H0": h0},
        ["Hidden", "LastH"],
        {"is_reverse": is_reverse, "activation": activation})
    h_seq = outs["Hidden"][0]
    h_seq.seq_len = get_seq_len(input)
    return h_seq
