"""Core NN layers. Counterpart of ``paddle_tpu/layers/nn.py``, cut to
what the training slice builds: ``fc``, ``embedding`` (dense),
``layer_norm`` and ``softmax_with_cross_entropy``."""
from __future__ import annotations

import math

from ..initializer import ConstantInitializer, XavierInitializer
from .layer_helper import LayerHelper


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None, main_program=None, startup_program=None):
    """Fully-connected layer: mul per input + sum + bias + activation.
    Multiple inputs each get their own weight; ``num_flatten_dims`` may be
    a list (one value per input) whose outputs share one rank."""
    helper = LayerHelper("fc", main_program=main_program,
                         startup_program=startup_program)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    nfds = (list(num_flatten_dims)
            if isinstance(num_flatten_dims, (list, tuple))
            else [num_flatten_dims] * len(inputs))
    if len(nfds) != len(inputs):
        raise ValueError(
            f"fc: num_flatten_dims list has {len(nfds)} entries for "
            f"{len(inputs)} inputs")
    if len({nfd + 1 for nfd in nfds}) > 1:
        raise ValueError(
            "fc: per-input num_flatten_dims produce MIXED partial-sum "
            f"ranks {sorted(nfd + 1 for nfd in nfds)}; use values whose "
            "outputs share one rank, or reshape the lower-rank inputs first")
    mul_results = []
    for inp, nfd in zip(inputs, nfds):
        fan_in = math.prod(inp.shape[nfd:])
        w = helper.create_parameter(
            param_attr, shape=[fan_in, size], dtype=inp.dtype,
            default_initializer=XavierInitializer())
        mul_results.append(
            helper.simple_op("mul", {"X": [inp], "Y": [w]},
                             {"x_num_col_dims": nfd, "y_num_col_dims": 1}))
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.simple_op("sum", {"X": mul_results})
    if bias_attr is False:
        pre_act = pre_bias
    else:
        pre_act = helper.append_bias_op(pre_bias, bias_attr, size,
                                        dim_start=nfds[0])
    return helper.append_activation(pre_act, act)


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32", main_program=None,
              startup_program=None):
    """Embedding lookup (lookup_table) with a dense gradient. Sparse
    (SelectedRows) gradients are a later slice of the port."""
    if is_sparse:
        raise NotImplementedError(
            "embedding(is_sparse=True) is not ported to paddle_tpu_torch "
            "yet: it lands with the sparse-grad (SelectedRows) slice")
    helper = LayerHelper("embedding", main_program=main_program,
                         startup_program=startup_program)
    w = helper.create_parameter(
        param_attr, shape=list(size), dtype=dtype,
        default_initializer=XavierInitializer())
    if padding_idx is not None and padding_idx < 0:
        # fluid semantics: negative padding_idx counts from the vocab end
        padding_idx = int(size[0]) + int(padding_idx)
    return helper.simple_op(
        "lookup_table", {"W": [w], "Ids": [input]},
        {"padding_idx": padding_idx, "is_sparse": bool(is_sparse)})


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               main_program=None, startup_program=None):
    helper = LayerHelper("layer_norm", main_program=main_program,
                         startup_program=startup_program)
    norm_shape = [math.prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            param_attr, shape=norm_shape, dtype="float32",
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, shape=norm_shape,
                                    dtype="float32", is_bias=True)
        inputs["Bias"] = [b]
    outs, _ = helper.append_op("layer_norm", inputs,
                               ["Y", "Mean", "Variance"],
                               {"epsilon": epsilon,
                                "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(outs["Y"][0], act)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               label_smoothing=0.0, main_program=None,
                               startup_program=None):
    """``label_smoothing`` (hard labels only): train against the target
    (1-eps)*onehot + eps/V."""
    helper = LayerHelper("softmax_with_cross_entropy",
                         main_program=main_program,
                         startup_program=startup_program)
    if soft_label and label_smoothing:
        raise ValueError("label_smoothing applies to hard labels only")
    if not 0.0 <= float(label_smoothing) < 1.0:
        raise ValueError(
            f"label_smoothing must be in [0, 1), got {label_smoothing}")
    outs, _ = helper.append_op(
        "softmax_with_cross_entropy", {"Logits": [logits], "Label": [label]},
        ["Softmax", "Loss"], {"soft_label": soft_label,
                              "label_smoothing": float(label_smoothing)})
    return outs["Loss"][0]
